"""Plain multicoil SENSE and CG-SENSE (Pruessmann et al., MRM 46:638,
2001), on exact NUDFTs.

A = F S: S multiplies the image by each coil map, F is the type-2 NUDFT
(sign -1) at the k-space points. The adjoint applies the density weights
W, the type-1 NUDFT (sign +1) and the conjugate-map coil sum, so
``normal`` is A^H W A and CG solves A^H W A x = A^H W y from x = 0.
"""

from __future__ import annotations

import torch

from benchmark.reference import nudft
from benchmark.reference.precision import FLOAT64, Precision


class Sense:
    """A^H W A on complex tensors: points [M, 2] (float), maps [C, n0,
    n1] and density [M] (or None), computed in ``prec``."""

    def __init__(self, points, maps, density=None,
                 prec: Precision = FLOAT64):
        self.points = points.to(prec.real)
        self.maps = maps.to(prec.complex)
        self.density = None if density is None else density.to(prec.real)
        self.prec = prec
        self.grid = tuple(maps.shape[1:])

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        """[n0, n1] -> [C, M]."""
        coil = self.maps * image.to(self.prec.complex)[None]
        return nudft.type2_separable(self.points, coil, -1.0, self.prec)

    def adjoint(self, kspace: torch.Tensor) -> torch.Tensor:
        """[C, M] -> [n0, n1]: the density-weighted A^H."""
        kspace = kspace.to(self.prec.complex)
        if self.density is not None:
            kspace = kspace * self.density[None]
        coil = nudft.type1_full_2d(self.points, kspace, self.grid, 1.0,
                                   self.prec)
        return torch.sum(self.maps.conj() * coil, dim=0)

    def normal(self, image: torch.Tensor) -> torch.Tensor:
        return self.adjoint(self.forward(image))


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The real inner product Re(a^H b)."""
    return torch.sum(a.real * b.real + a.imag * b.imag)


def cg_sense(kspace: torch.Tensor, op: Sense, num_iters: int
             ) -> torch.Tensor:
    """``num_iters`` conjugate-gradient iterations on A^H W A x = A^H W y
    from x = 0."""
    rhs = op.adjoint(kspace)
    x = torch.zeros_like(rhs)
    r = p = rhs
    rs = _dot(r, r)
    for _ in range(num_iters):
        ap = op.normal(p)
        alpha = rs / torch.clamp(_dot(p, ap), min=1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = _dot(r, r)
        p = r + rs_new / torch.clamp(rs, min=1e-30) * p
        rs = rs_new
    return x
