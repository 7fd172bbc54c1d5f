"""CG-SENSE reconstructions: ``models.mri.cg_sense`` over one planned
``SenseNufft`` built in set-up, on k-spaces taken in turn from a pool of
seeded noisy k-spaces; the caller waits for each image, as a scanner
console does.

The data is the benchmark's own (``reference.mri_data``): the
configuration's radial trajectory and ramp density, birdcage-like coil
maps and a phantom, whose k-space the float64 reference model makes,
with seeded complex Gaussian noise of ``traffic["noise"]`` times its root
mean square. Both sides get the same float32 points, maps, density and
k-spaces.

Traffic keys: ``pool``, ``noise``, ``kept``.

Judged: ``image_err``, max |image - reference| / max |reference|, the
reference being float64 CG-SENSE on exact NUDFTs.
"""

from __future__ import annotations

import torch

from benchmark import roofline
from benchmark import traffic as gen
from benchmark.entries.common import complex_of, planar_of, rel_err
from benchmark.reference import mri_data, sense
from benchmark.reference.precision import FLOAT64, TF32, strict_fp32


class CgSense:
    waited = True

    def __init__(self, ctx):
        from tensorflow_nufft_tpu_torch.models import mri
        cfg, tr = ctx.config, ctx.traffic
        strict_fp32()
        dev = ctx.inputs.device
        self.grid = tuple(cfg["modes"])
        self.iters = cfg["cg_iterations"]
        tol, coils = cfg["tol"], cfg["coils"]
        spokes, samples = cfg["points"]["spokes"], cfg["points"]["samples"]
        self.points = gen.points(cfg, ctx.inputs)
        self.density = mri_data.ramp_density(spokes, samples, dev).float()
        self.maps = mri_data.coil_maps(coils, self.grid, dev).to(
            torch.complex64)
        clean = sense.Sense(self.points, self.maps).forward(
            mri_data.phantom(self.grid, dev))
        std = tr["noise"] * float(torch.sqrt(torch.mean(clean.abs() ** 2)))
        self.pool = []
        for _ in range(tr["pool"]):
            noise = ctx.inputs.normal(clean.shape + (2,), std / 2 ** 0.5,
                                      torch.float64)
            self.pool.append(planar_of(clean + torch.view_as_complex(noise)))
        self.cg_sense = mri.cg_sense
        self.op = mri.SenseNufft(self.points, planar_of(self.maps),
                                 self.grid, density=self.density, tol=tol,
                                 planned=True, toeplitz=False)
        m = self.points.shape[0]
        self.work = {"recons": 1}
        self.stages = {
            "spread": [roofline.Stage("spread", m, self.grid, 2 * coils,
                                      tol)] * (self.iters + 1),
            "interp": [roofline.Stage("interp", m, self.grid, 2 * coils,
                                      tol)] * self.iters}
        self._refs = {}

    def warmup(self):
        for i in range(len(self.pool)):
            self.call(i)

    def call(self, i):
        return self.cg_sense(self.pool[i % len(self.pool)], self.op,
                             num_iters=self.iters)

    def release(self):
        self.op = self.cg_sense = None

    def answers(self, kept):
        return [(i % len(self.pool), {"image": complex_of(image)})
                for i, image in kept]

    def _recon(self, p, prec):
        op = sense.Sense(self.points, self.maps, self.density, prec)
        return sense.cg_sense(complex_of(self.pool[p]), op, self.iters)

    def control(self, count):
        strict_fp32()
        return [(p, {"image": self._recon(p, TF32)})
                for p in range(min(count, len(self.pool)))]

    def judge(self, p, entries):
        strict_fp32()
        if p not in self._refs:
            self._refs[p] = self._recon(p, FLOAT64)
        return {"image_err": rel_err(entries["image"], self._refs[p])}


def build(ctx):
    return CgSense(ctx)
