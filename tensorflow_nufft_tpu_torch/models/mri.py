"""Non-Cartesian MRI reconstruction built on the NUFFT.

Counterpart of ``tensorflow_nufft_tpu.models.mri``: a radial k-space
trajectory and its density compensation, simulated coil maps and
phantom, the multicoil SENSE forward model on the planned planar NUFFT
(``planar.PlannedNufft``: the hand-written 2D kernels on the card) and
CG-SENSE reconstruction, differentiable through autograd.

Complex images and k-space are planar: real tensors with a trailing
(re, im) channel (see ``tensorflow_nufft_tpu_torch.planar``). The
generators return numpy arrays; the operators take tensors or arrays
and run where ``planar.PlannedNufft`` would (``device=``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tensorflow_nufft_tpu_torch import planar
from tensorflow_nufft_tpu_torch.kernels import xla_ops
from tensorflow_nufft_tpu_torch.kernels.torch_ops import (
    fold_and_rescale_split)
from tensorflow_nufft_tpu_torch.options.options import Options
from tensorflow_nufft_tpu_torch.plan.plan import PlanSpec, make_plan
from tensorflow_nufft_tpu_torch.utils import profiling as prof
from tensorflow_nufft_tpu_torch.utils.dtypes import (
    as_tensor, dtype_name, entry_tensors)
from tensorflow_nufft_tpu_torch.utils.smooth import next_smooth_integer

# ---------------------------------------------------------------------------
# Planar complex helpers.

pmul = planar.pmul


def pconj(a: torch.Tensor) -> torch.Tensor:
    """Planar complex conjugate."""
    return torch.stack([a[..., 0], -a[..., 1]], dim=-1)


def pabs2(a: torch.Tensor) -> torch.Tensor:
    """|a|^2 (real tensor, channel axis reduced)."""
    return torch.sum(a * a, dim=-1)


# ---------------------------------------------------------------------------
# Trajectories and density compensation.


def radial_trajectory(num_spokes: int, num_samples: int,
                      golden_angle: bool = False,
                      dtype=np.float32) -> np.ndarray:
    """Radial k-space trajectory in radians/pixel: [num_spokes *
    num_samples, 2] coordinates in [-pi, pi)."""
    if golden_angle:
        angles = np.arange(num_spokes) * np.pi * (3 - np.sqrt(5.0))
    else:
        angles = np.linspace(0, np.pi, num_spokes, endpoint=False)
    radii = (np.arange(num_samples) - num_samples / 2) \
        / (num_samples / 2) * np.pi
    kx = radii[None, :] * np.cos(angles[:, None])
    ky = radii[None, :] * np.sin(angles[:, None])
    return np.stack([kx.ravel(), ky.ravel()], axis=-1).astype(dtype)


def radial_density(num_spokes: int, num_samples: int,
                   dtype=np.float32) -> np.ndarray:
    """Ramp (|k|) density-compensation weights of a radial trajectory,
    normalized so a unit disk integrates to ~1: [num_spokes *
    num_samples]."""
    radii = np.abs(np.arange(num_samples) - num_samples / 2) \
        / (num_samples / 2)
    radii = np.maximum(radii, 1.0 / num_samples)  # DC gets smallest cell
    w = np.tile(radii, num_spokes)
    w = w / (w.sum() * np.pi / num_spokes)
    return w.astype(dtype)


def pipe_menon_density(points, grid_shape: Tuple[int, ...],
                       num_iters: int = 30, tol: float = 1e-3,
                       options: Optional[Options] = None,
                       device=None) -> torch.Tensor:
    """Iterative density-compensation weights for any trajectory (Pipe &
    Menon 1999): the fixed point of ``w <- w / |C C^H w|``, ``C C^H`` the
    gridding kernel's k-space convolution (a spread and an interp on a 2x
    oversampled grid, no FFT stage).

    As in the JAX package, the points-side geometry is computed once and
    the loop runs the XLA-path spread and interp (``kernels.xla_ops``) on
    one real channel. Returns [M] weights with ``sum(w) == 1``, on the
    points' device.
    """
    points, = entry_tensors(points, device=device)
    if points.ndim != 2:
        raise ValueError(
            f"points must have shape [M, rank], got {tuple(points.shape)}")
    rank = int(points.shape[-1])
    if len(grid_shape) != rank:
        raise ValueError(
            f"grid_shape must have rank {rank}, got {grid_shape}")
    fine = tuple(next_smooth_integer(2 * int(n)) for n in grid_shape)
    options = options or Options()
    plan = make_plan(PlanSpec(
        transform_type="type_1", fft_direction="forward", rank=rank,
        grid_shape=fine, dtype_name=dtype_name(points.dtype),
        tol=float(tol), points_range=int(options.points_range),
        spread_only=True,
        kernel_evaluation_method=options.kernel_evaluation_method))
    resc = fold_and_rescale_split(points, fine, int(options.points_range))
    indices, kernels = xla_ops.spread_geometry(resc, plan)
    w = torch.ones(points.shape[0], dtype=points.dtype,
                   device=points.device)
    for _ in range(num_iters):
        g = xla_ops.spread_xla(w[None], indices, kernels, plan)
        v = xla_ops.interp_xla(g, indices, kernels, plan)[0]
        w = w / torch.clamp(torch.abs(v), min=1e-12)
    return w / torch.sum(w)


def birdcage_maps(num_coils: int, grid_shape: Tuple[int, int],
                  dtype=np.float32) -> np.ndarray:
    """Simulated birdcage coil sensitivity maps (planar),
    [num_coils, *grid_shape, 2]."""
    ny, nx = grid_shape
    y, x = np.mgrid[0:ny, 0:nx]
    maps = np.empty((num_coils, ny, nx), np.complex64)
    for c in range(num_coils):
        ang = 2 * np.pi * c / num_coils
        cy = ny * (0.5 + 0.45 * np.sin(ang))
        cx = nx * (0.5 + 0.45 * np.cos(ang))
        r2 = ((y - cy) / ny) ** 2 + ((x - cx) / nx) ** 2
        maps[c] = np.exp(-4.0 * r2) * np.exp(1j * ang)
    # Normalize sum-of-squares to 1 where meaningful.
    sos = np.sqrt(np.sum(np.abs(maps) ** 2, axis=0))
    maps /= np.maximum(sos, 1e-3)
    out = np.stack([maps.real, maps.imag], axis=-1)
    return out.astype(dtype)


# ---------------------------------------------------------------------------
# SENSE forward model.


class SenseNufft:
    """Multicoil non-Cartesian MRI forward operator A = F_nu S.

    forward: image [*grid, 2] -> kspace [C, M, 2]
    adjoint: kspace [C, M, 2] -> image [*grid, 2]

    ``F_nu`` is the type-2 NUFFT at ``points``, ``S`` the multiplication
    by the coil maps. The adjoint applies the optional density
    compensation, the type-1 backward NUFFT and the conjugate-map coil
    combination.

    With ``planned=True`` (default) and one [M, rank] trajectory, the pair
    runs on one ``planar.PlannedNufft``, its points-side work done once;
    where the plan takes level "none" (float64 points, ``backend='xla'``)
    its applies run the unplanned transform, and ``normal`` the composed
    pair. With ``toeplitz=True``, ``normal`` is a
    ``planar.ToeplitzNormal``: no spread or interp per CG iteration.
    ``forward``, ``adjoint`` and ``normal`` run under the ``mri.forward``,
    ``mri.adjoint`` and ``mri.normal`` spans (``utils.profiling``).
    """

    def __init__(self, points, maps, grid_shape: Tuple[int, ...],
                 density=None, tol: float = 1e-6,
                 options: Optional[Options] = None,
                 planned: bool = True, toeplitz: bool = False,
                 device=None):
        self.points, self.maps = entry_tensors(points, maps, device=device)
        self.grid_shape = tuple(grid_shape)
        self.density = None if density is None else as_tensor(
            density, device=self.points.device)
        self.tol = tol
        self.options = options or Options()
        self._t2 = None
        self._slot_density = None
        self._toeplitz = None
        if planned and self.points.ndim == 2:
            self._t2 = planar.PlannedNufft(
                self.points, self.grid_shape, transform_type="type_2",
                fft_direction="forward", tol=tol, options=self.options)
            if self._t2.level != "none" and self.density is not None:
                # Slot-order density for the planned normal operator.
                self._slot_density = self._t2.slot_weights(self.density)
        if toeplitz and self.points.ndim == 2:
            self._toeplitz = planar.ToeplitzNormal(
                self.points, self.grid_shape, weights=self.density,
                fft_direction="forward", tol=tol, options=self.options)

    def forward(self, image) -> torch.Tensor:
        """[*grid, 2] -> [C, M, 2]."""
        with prof.scope("mri.forward"):
            coil_images = pmul(self.maps, as_tensor(
                image, device=self.points.device)[None])
            if self._t2 is not None:
                return self._t2(coil_images)
            return planar.nufft(coil_images, self.points,
                                transform_type="type_2",
                                fft_direction="forward", tol=self.tol,
                                options=self.options)

    def adjoint(self, kspace) -> torch.Tensor:
        """[C, M, 2] -> [*grid, 2] (density-compensated A^H)."""
        with prof.scope("mri.adjoint"):
            kspace = as_tensor(kspace, device=self.points.device)
            if self.density is not None:
                kspace = kspace * self.density[None, :, None]
            if self._t2 is not None:
                coil_images = self._t2.adjoint()(kspace)
            else:
                coil_images = planar.nufft(kspace, self.points,
                                           grid_shape=self.grid_shape,
                                           transform_type="type_1",
                                           fft_direction="backward",
                                           tol=self.tol,
                                           options=self.options)
            return torch.sum(pmul(pconj(self.maps), coil_images), dim=0)

    def normal(self, image) -> torch.Tensor:
        """A^H W A applied to an image (the CG system operator): the
        Toeplitz embedding with ``toeplitz=True``; the plan's ``normal``
        (point values kept in slot order) where the plan has a level;
        else the composed pair."""
        with prof.scope("mri.normal"):
            image = as_tensor(image, device=self.points.device)
            if self._toeplitz is not None:
                coil_normal = self._toeplitz(pmul(self.maps, image[None]))
            elif self._t2 is not None and self._t2.level != "none":
                coil_normal = self._t2.normal(pmul(self.maps, image[None]),
                                              self._slot_density)
            else:
                return self.adjoint(self.forward(image))
            return torch.sum(pmul(pconj(self.maps), coil_normal), dim=0)


def _pdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Real inner product <a, b> over planar tensors."""
    return torch.sum(a * b)


def cg_sense(kspace, op: SenseNufft, num_iters: int = 10,
             lamda: float = 0.0) -> torch.Tensor:
    """CG-SENSE reconstruction: solves (A^H W A + lamda I) x = A^H W y,
    W = diag(op.density) (identity without one), by ``num_iters``
    conjugate-gradient iterations from x = 0. A Python loop of torch
    ops, differentiable through autograd; each iteration runs under the
    ``cg.iter`` span (``utils.profiling``), the operator's applies under
    ``SenseNufft``'s ``mri.*`` spans.

    Args:
        kspace: [C, M, 2] measured data.
        op: the SENSE operator.
        num_iters: CG iterations.
        lamda: Tikhonov regularization.

    Returns:
        [*grid, 2] reconstructed image.
    """
    rhs = op.adjoint(kspace)

    def system(x):
        out = op.normal(x)
        if lamda:
            out = out + lamda * x
        return out

    x = torch.zeros_like(rhs)
    r = p = rhs
    rs = _pdot(r, r)
    for _ in range(num_iters):
        with prof.scope("cg.iter"):
            ap = system(p)
            alpha = rs / torch.clamp(_pdot(p, ap), min=1e-30)
            x = x + alpha * p
            r = r - alpha * ap
            rs_new = _pdot(r, r)
            beta = rs_new / torch.clamp(rs, min=1e-30)
            p = r + beta * p
            rs = rs_new
    return x


def shepp_logan(grid_shape: Tuple[int, int],
                dtype=np.float32) -> np.ndarray:
    """Simple Shepp-Logan-like phantom (planar, zero imaginary part)."""
    ny, nx = grid_shape
    y, x = np.mgrid[0:ny, 0:nx]
    y = (y - ny / 2) / (ny / 2)
    x = (x - nx / 2) / (nx / 2)
    img = np.zeros((ny, nx), np.float64)
    for (cy, cx, ry, rx, val) in [
            (0.0, 0.0, 0.85, 0.65, 1.0),
            (0.0, 0.0, 0.78, 0.58, -0.6),
            (-0.2, 0.2, 0.3, 0.15, 0.4),
            (-0.2, -0.2, 0.25, 0.12, 0.35),
            (0.35, 0.0, 0.15, 0.2, 0.3)]:
        img += val * (((y - cy) / ry) ** 2 + ((x - cx) / rx) ** 2 < 1)
    out = np.stack([img, np.zeros_like(img)], axis=-1)
    return out.astype(dtype)
