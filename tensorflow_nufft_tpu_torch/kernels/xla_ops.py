"""The spread and interp stages of the JAX package's XLA path, in torch
ops.

Counterpart of ``spread_geometry``, ``spread_xla`` and ``interp_xla`` of
``tensorflow_nufft_tpu.kernels.xla_ops``. That is XLA code, not a Pallas
kernel: the JAX package runs it for float64 and complex-dtype data,
where its Pallas kernels (float32, planar) do not serve. The port runs
it on the same terms (``kernels.dispatch.route``): float64 tensors on
the card, and ``Options(backend='xla')`` on any device. Values may be
complex or real (``models.mri.pipe_menon_density`` spreads one real
channel).

The hot loops run over the width^(rank - 1) combinations of the leading
axes' window offsets, one at a time, as the JAX ``lax.scan`` does, so a
step holds [B, M, width] values (a 3D transform at 800,000 points and
tol 1e-12, width 14, holds 11.2M values a step, not 2.2e9).

Determinism: ``spread_xla`` accumulates with ``index_add_``, which on a
CUDA tensor adds with atomics in no fixed order, so on the card two
calls may differ in the last bits (on the CPU it adds in order and
repeats bit for bit). ``interp_xla`` is a gather and a sum in a fixed
order and repeats bit for bit on either device.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from tensorflow_nufft_tpu_torch.kernels.torch_ops import es_kernel_for


def spread_geometry(points_resc, plan, deriv_axis=None
                    ) -> Tuple[Tuple[torch.Tensor, ...],
                               Tuple[torch.Tensor, ...]]:
    """Per-axis spreading indices and kernel values.

    Args:
        points_resc: coordinates in fine-grid units in [0, nf): a
            [M, rank] tensor or a two-float (hi, lo) pair of them
            (``torch_ops.fold_and_rescale_split``).
        plan: the static plan.
        deriv_axis: if set, that axis's kernel values are the derivative
            phi'(z) (the spread-only ops' points gradients).

    Returns:
        (indices, kernels): per axis, int64 [M, width] periodically
        wrapped fine-grid indices and the matching [M, width] kernel
        values. The leftmost covered index is ceil(s - width/2).
    """
    if isinstance(points_resc, tuple):
        points_hi, points_lo = points_resc
    else:
        points_hi, points_lo = points_resc, None
    offsets = torch.arange(plan.width, dtype=points_hi.dtype,
                           device=points_hi.device)
    indices, kernels = [], []
    for d in range(plan.rank):
        s = points_hi[:, d]
        i0 = torch.ceil(s - plan.half_width)
        # (i0 + j) - s is exact (nearby magnitudes); the low word restores
        # the coordinate's full precision.
        z = (i0[:, None] + offsets[None, :]) - s[:, None]
        if points_lo is not None:
            z = z - points_lo[:, d][:, None]
        kernels.append(es_kernel_for(z, plan, deriv=deriv_axis == d))
        idx = i0.to(torch.int64)[:, None] + torch.arange(
            plan.width, device=s.device)[None, :]
        indices.append(torch.remainder(idx, plan.fine_shape[d]))
    return tuple(indices), tuple(kernels)


def _flat_strides(fine_shape: Sequence[int]) -> Tuple[int, ...]:
    strides = [1] * len(fine_shape)
    for d in range(len(fine_shape) - 2, -1, -1):
        strides[d] = strides[d + 1] * fine_shape[d + 1]
    return tuple(strides)


def _combos(indices, kernels, plan):
    """Yields (flat [M, width] indices, [M, width] weights) per combination
    of the leading axes' offsets, the last axis vectorized."""
    rank, width = plan.rank, plan.width
    strides = _flat_strides(plan.fine_shape)
    if rank == 1:
        yield indices[0], kernels[0]
        return
    for combo in range(width ** (rank - 1)):
        j = (combo,) if rank == 2 else (combo // width, combo % width)
        lead_idx = indices[0][:, j[0]] * strides[0]
        lead_ker = kernels[0][:, j[0]]
        if rank == 3:
            lead_idx = lead_idx + indices[1][:, j[1]] * strides[1]
            lead_ker = lead_ker * kernels[1][:, j[1]]
        yield (lead_idx[:, None] + indices[-1],
               lead_ker[:, None] * kernels[-1])


def _channels(x: torch.Tensor) -> torch.Tensor:
    """Real view of ``x`` with a trailing channel axis: (re, im) for a
    complex tensor, one channel for a real one."""
    return torch.view_as_real(x) if x.is_complex() else x[..., None]


def spread_xla(strengths: torch.Tensor, indices, kernels, plan
               ) -> torch.Tensor:
    """Spreads point strengths [B, M] (complex or real) onto the fine
    grid [B, *fine_shape] of their dtype: a scatter-add of each offset
    combination's [B, M, width] products."""
    batch = strengths.shape[0]
    out = strengths.new_zeros((batch, plan.fine_size))
    acc = _channels(out)
    src = _channels(strengths)
    for flat, wts in _combos(indices, kernels, plan):
        vals = src[:, :, None] * wts.to(src.dtype)[None, :, :, None]
        acc.index_add_(1, flat.reshape(-1),
                       vals.reshape(batch, -1, src.shape[-1]))
    return out.reshape((batch,) + tuple(plan.fine_shape))


def interp_xla(fine: torch.Tensor, indices, kernels, plan) -> torch.Tensor:
    """Interpolates a fine grid [B, *fine_shape] (complex or real) at the
    points: [B, M], a gather and a weighted sum per offset combination."""
    batch = fine.shape[0]
    fine_flat = fine.reshape(batch, -1)
    acc = None
    for flat, wts in _combos(indices, kernels, plan):
        term = torch.sum(fine_flat[:, flat] * wts.to(fine.dtype)[None],
                         dim=-1)
        acc = term if acc is None else acc + term
    return acc
