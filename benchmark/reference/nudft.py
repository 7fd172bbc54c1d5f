"""Exact nonuniform DFTs (the definitions, summed term by term).

Modes are in CMCL order: flat index i of an axis of n modes is the
frequency k = i - n // 2. Type-1 at modes k: ``sum_j c_j exp(sign i k.x_j)``;
type-2 at point x: ``sum_k f_k exp(sign i k.x)``. ``exact_type1_subset``
and ``exact_type2_subset`` are frozen copies of ``chip_smoke.py``'s
(batched, with a precision); ``type2_separable`` and ``type1_full_2d``
sum the same terms axis by axis (exp(i k.x) is a product over axes).
"""

from __future__ import annotations

from typing import Sequence

import torch

from benchmark.reference.precision import FLOAT64, Precision


def mode_freqs(flat: torch.Tensor, grid: Sequence[int]) -> torch.Tensor:
    """[S, rank] float64 frequencies k = i - n // 2 of flat mode
    indices."""
    half = torch.tensor([n // 2 for n in grid], device=flat.device)
    return (torch.stack(torch.unravel_index(flat, tuple(grid)), dim=-1)
            - half).double()


def _axis_freqs(n: int, device) -> torch.Tensor:
    return torch.arange(n, device=device, dtype=torch.float64) - n // 2


def _phases(x: torch.Tensor, k: torch.Tensor, sign: float,
            prec: Precision) -> torch.Tensor:
    """exp(sign i x k^T) for x [C, r] and k [S, r], in ``prec``: the
    phase is a contraction too."""
    phase = sign * (prec.operand(x) @ prec.operand(k).T)
    return prec.operand(torch.polar(torch.ones_like(phase), phase))


def exact_type1_subset(points: torch.Tensor, values: torch.Tensor,
                       idx: torch.Tensor, grid: Sequence[int],
                       sign: float = -1.0, prec: Precision = FLOAT64,
                       chunk: int = 8192) -> torch.Tensor:
    """Type-1 NUDFT of ``values`` [B, M] (complex) at the flat mode
    indices ``idx`` [S] of ``grid``, summed over all points [M, rank] in
    chunks. Returns [B, S]."""
    k = mode_freqs(idx, grid)
    c = prec.operand(values)
    out = torch.zeros(c.shape[0], len(idx), dtype=prec.complex,
                      device=points.device)
    for lo in range(0, points.shape[0], chunk):
        out += c[:, lo:lo + chunk] @ _phases(points[lo:lo + chunk].double(),
                                             k, sign, prec)
    return out


def exact_type2_subset(points: torch.Tensor, modes: torch.Tensor,
                       idx: torch.Tensor, sign: float,
                       prec: Precision = FLOAT64,
                       chunk: int = 16384) -> torch.Tensor:
    """Type-2 NUDFT of ``modes`` [B, *grid] (complex) at the points
    ``points[idx]``, summed over all modes in chunks. Returns [B, S]."""
    grid = tuple(modes.shape[1:])
    x = points[idx].double()
    f = prec.operand(modes.reshape(modes.shape[0], -1))
    out = torch.zeros(f.shape[0], len(idx), dtype=prec.complex,
                      device=points.device)
    for lo in range(0, f.shape[1], chunk):
        k = mode_freqs(torch.arange(lo, min(lo + chunk, f.shape[1]),
                                    device=points.device), grid)
        out += f[:, lo:lo + chunk] @ _phases(x, k, sign, prec).T
    return out


def _axis_phases(x: torch.Tensor, n: int, sign: float,
                 prec: Precision) -> torch.Tensor:
    """[C, n]: exp(sign i k x) for one axis' coordinates x [C]."""
    k = _axis_freqs(n, x.device)
    return _phases(x.double()[:, None], k[:, None], sign, prec)


def type2_separable(points: torch.Tensor, modes: torch.Tensor, sign: float,
                    prec: Precision = FLOAT64,
                    chunk: int = 8192) -> torch.Tensor:
    """Type-2 NUDFT of ``modes`` [B, *grid] at every point [M, rank]:
    the sum over the last axis first (a matmul), then over each
    remaining axis. Returns [B, M]."""
    batch, grid = modes.shape[0], tuple(modes.shape[1:])
    rank = len(grid)
    f = prec.operand(modes).reshape(-1, grid[-1])
    out = []
    for lo in range(0, points.shape[0], chunk):
        x = points[lo:lo + chunk]
        n = x.shape[0]
        t = f @ _axis_phases(x[:, -1], grid[-1], sign, prec).T
        for ax in range(rank - 2, -1, -1):
            t = t.reshape(batch, -1, grid[ax], n)
            e = _axis_phases(x[:, ax], grid[ax], sign, prec)
            t = torch.einsum("brnc,cn->brc", prec.operand(t), e)
        out.append(t.reshape(batch, n))
    return torch.cat(out, dim=1)


def type1_full_2d(points: torch.Tensor, values: torch.Tensor,
                  grid: Sequence[int], sign: float,
                  prec: Precision = FLOAT64,
                  chunk: int = 8192) -> torch.Tensor:
    """Type-1 NUDFT of ``values`` [B, M] at every mode of the 2D ``grid``:
    sum_j c_j e0_j e1_j^T over points in chunks. Returns [B, n0, n1]."""
    n0, n1 = grid
    c = prec.operand(values)
    out = torch.zeros(c.shape[0], n0, n1, dtype=prec.complex,
                      device=points.device)
    for lo in range(0, points.shape[0], chunk):
        x = points[lo:lo + chunk]
        e0 = _axis_phases(x[:, 0], n0, sign, prec)           # [C, n0]
        e1 = _axis_phases(x[:, 1], n1, sign, prec)           # [C, n1]
        left = prec.operand(c[:, lo:lo + chunk, None] * e0[None])
        out += left.transpose(1, 2) @ e1
    return out
