"""Planned transforms: one ``PlannedNufft`` built in set-up on the
configuration's points, applied to values taken in turn from a pool of
seeded arrays, dispatched ahead (a closed loop of one caller that does
not wait for each answer).

Traffic keys: ``transform_type``, ``fft_direction``, ``batch``, ``pool``,
``check_size`` (modes of a type-1 answer, or points of a type-2 answer,
compared against the exact NUDFT), ``kept`` (answers sampled).

Judged: ``rel_err``, max |answer - exact| / max |exact| over the sampled
entries of the kept answers.
"""

from __future__ import annotations

import math

from benchmark import roofline
from benchmark import traffic as gen
from benchmark.entries.common import complex_of, rel_err
from benchmark.reference import nudft
from benchmark.reference.precision import FLOAT64, TF32, strict_fp32


class Planned:
    waited = False

    def __init__(self, ctx):
        import tensorflow_nufft_tpu_torch as tnt
        cfg, tr = ctx.config, ctx.traffic
        self.grid = tuple(cfg["modes"])
        self.tol = cfg["tol"]
        self.type1 = tr["transform_type"] == "type_1"
        self.sign = -1.0 if tr["fft_direction"] == "forward" else 1.0
        self.points = gen.points(cfg, ctx.inputs)
        m, batch = self.points.shape[0], tr["batch"]
        self.op = tnt.PlannedNufft(
            self.points, self.grid, transform_type=tr["transform_type"],
            fft_direction=tr["fft_direction"], tol=self.tol)
        shape = (batch, m, 2) if self.type1 else (batch,) + self.grid + (2,)
        self.pool = [ctx.inputs.normal(shape) for _ in range(tr["pool"])]
        self.work = {"points": m * batch}
        stage = roofline.Stage("spread" if self.type1 else "interp", m,
                               self.grid, 2 * batch, self.tol)
        self.stages = {stage.kind: [stage]}
        self.idx = ctx.inputs.sample(
            math.prod(self.grid) if self.type1 else m, tr["check_size"])
        self._refs = {}

    def warmup(self):
        for values in self.pool:
            self.op(values)

    def call(self, i):
        return self.op(self.pool[i % len(self.pool)])

    def release(self):
        self.op = None

    def answers(self, kept):
        out = []
        for i, answer in kept:
            flat = answer.reshape(answer.shape[0], -1, 2)
            out.append((i % len(self.pool),
                        {"values": complex_of(flat[:, self.idx])}))
        return out

    def _exact(self, p, prec):
        values = complex_of(self.pool[p])
        if self.type1:
            return nudft.exact_type1_subset(self.points, values, self.idx,
                                            self.grid, self.sign, prec)
        return nudft.exact_type2_subset(self.points, values, self.idx,
                                        self.sign, prec)

    def control(self, count):
        strict_fp32()
        return [(p, {"values": self._exact(p, TF32)})
                for p in range(min(count, len(self.pool)))]

    def judge(self, p, entries):
        strict_fp32()
        if p not in self._refs:
            self._refs[p] = self._exact(p, FLOAT64)
        return {"rel_err": rel_err(entries["values"], self._refs[p])}


def build(ctx):
    return Planned(ctx)
