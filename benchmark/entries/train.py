"""A training step through the unplanned transform: the type-2 loss
L = 1/2 ||A(x; k) - y||^2 by ``planar.nufft``, backward to the image x
[1, *modes, 2] and the points k [M, d]. x and k come in turn from a pool
of seeded pairs, k a seeded perturbation of the configuration's points,
so the points change from step to step as under an optimiser; y is
seeded data of the answers' scale. No optimiser step: each step's
answers are its output, loss and two gradients, dispatched ahead.

Traffic keys: ``fft_direction``, ``pool``, ``perturb`` (radians, the
standard deviation of k about the configuration's points),
``check_size`` (points and modes sampled), ``kept``.

Judged against the exact float64 loss and gradients, whose residual
r = A(x; k) - y is the reference's own (a type-2 NUDFT at every point):
``out_err`` (the output at sampled points), ``loss_err`` (relative),
``xgrad_err`` (x's gradient A^H r at sampled modes), ``kgrad_err`` (k's
gradient -s Im(conj(r) sum_k k_a f_k e^{s i k.x}) at sampled points,
s the transform's sign), each a max |answer - exact| / max |exact|.
"""

from __future__ import annotations

import math

import torch

from benchmark import roofline
from benchmark import traffic as gen
from benchmark.entries.common import complex_of, rel_err
from benchmark.reference import nudft
from benchmark.reference.precision import FLOAT64, TF32, strict_fp32


class Train:
    waited = False

    def __init__(self, ctx):
        from tensorflow_nufft_tpu_torch import planar
        cfg, tr = ctx.config, ctx.traffic
        self.nufft = planar.nufft
        self.grid = tuple(cfg["modes"])
        self.tol = cfg["tol"]
        self.direction = tr["fft_direction"]
        self.sign = -1.0 if self.direction == "forward" else 1.0
        base = gen.points(cfg, ctx.inputs)
        m, rank, n = base.shape[0], base.shape[1], math.prod(self.grid)
        self.pool = []
        for _ in range(tr["pool"]):
            x = ctx.inputs.normal((1,) + self.grid + (2,))
            k = gen.wrap(base + ctx.inputs.normal(base.shape, tr["perturb"]))
            self.pool.append((x.requires_grad_(), k.requires_grad_()))
        self.y = ctx.inputs.normal((1, m, 2), std=math.sqrt(n))
        self.work = {"steps": 1}
        self.stages = {
            "spread": [roofline.Stage("spread", m, self.grid, 2, self.tol)],
            "interp": [roofline.Stage("interp", m, self.grid, 2, self.tol),
                       roofline.Stage("interp", m, self.grid, 2 * rank,
                                      self.tol)]}
        self.idx_pts = ctx.inputs.sample(m, tr["check_size"])
        self.idx_modes = ctx.inputs.sample(n, tr["check_size"])
        self._refs = {}

    def warmup(self):
        for i in range(len(self.pool)):
            self.call(i)

    def call(self, i):
        x, k = self.pool[i % len(self.pool)]
        x.grad = k.grad = None
        out = self.nufft(x, k, tol=self.tol, fft_direction=self.direction)
        loss = 0.5 * (out - self.y).square().sum()
        loss.backward()
        return out.detach(), loss.detach(), x.grad, k.grad

    def release(self):
        self.nufft = None
        for x, k in self.pool:
            x.grad = k.grad = None

    def answers(self, kept):
        out = []
        for i, (values, loss, gx, gk) in kept:
            out.append((i % len(self.pool), {
                "out": complex_of(values[0, self.idx_pts]),
                "loss": loss.double(),
                "xgrad": complex_of(gx.reshape(-1, 2)[self.idx_modes]),
                "kgrad": gk.detach().double()[self.idx_pts]}))
        return out

    def _exact(self, p, prec):
        x, k = (t.detach() for t in self.pool[p])
        f = complex_of(x[0])
        full = nudft.type2_separable(k, f[None], self.sign, prec)[0]
        r = full - complex_of(self.y[0]).to(full.dtype)
        xgrad = nudft.exact_type1_subset(k, r[None], self.idx_modes,
                                         self.grid, -self.sign, prec)[0]
        kgrad = []
        for ax, n in enumerate(self.grid):
            shape = [1] * len(self.grid)
            shape[ax] = n
            freqs = (torch.arange(n, device=f.device, dtype=torch.float64)
                     - n // 2).reshape(shape)
            g = nudft.type2_separable(k[self.idx_pts], (f * freqs)[None],
                                      self.sign, prec)[0]
            kgrad.append(-self.sign * torch.imag(r[self.idx_pts].conj() * g))
        return {"out": full[self.idx_pts],
                "loss": 0.5 * torch.sum(torch.abs(r.to(torch.complex128))
                                        ** 2),
                "xgrad": xgrad, "kgrad": torch.stack(kgrad, dim=-1)}

    def control(self, count):
        strict_fp32()
        return [(p, self._exact(p, TF32))
                for p in range(min(count, len(self.pool)))]

    def judge(self, p, entries):
        strict_fp32()
        if p not in self._refs:
            self._refs[p] = self._exact(p, FLOAT64)
        ref = self._refs[p]
        return {f"{name}_err": rel_err(entries[name], ref[name])
                for name in ("out", "loss", "xgrad", "kgrad")}


def build(ctx):
    return Train(ctx)
