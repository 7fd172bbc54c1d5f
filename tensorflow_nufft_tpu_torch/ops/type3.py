"""Type-3 NUFFT: nonuniform points -> nonuniform frequencies.

Counterpart of ``tensorflow_nufft_tpu.ops.type3``. Computes
f_k = sum_j c_j exp(s i t_k . x_j) for arbitrary real point sets x_j
("points") and t_k ("target_points"), s = -1 (forward) / +1 (backward),
by the standard two-step t3 factorization (Lee & Greengard 2005;
Barnett-Magland-af Klinteberg 2019, section 4):

  1. Center both point sets (x_c, t_c midpoints; half-widths X, S) and pick
     a fine grid nf >= 2*sigma*S*X/pi + w + 1 per dim, with rescale
     factor gamma = nf / (2 sigma S) and step h = 2 pi / nf. The "+w+1"
     margin guarantees that no kernel mass wraps around the grid.
  2. Spread the prephased strengths c_j * exp(s i t_c (x_j - x_c)) at
     xi_j = (x_j - x_c)/gamma in (-pi, pi) onto the nf grid with the ES
     kernel (a plain spread; no FFT).
  3. Evaluate the spread grid's semidiscrete Fourier transform at the
     continuous frequencies by an inner type-2 NUFFT of the grid (read as
     CMCL modes) at theta_k = gamma (t_k - t_c) h in [-pi/sigma, pi/sigma].
  4. Divide by the kernel's continuous Fourier transform
     psi_hat(gamma (t_k - t_c) h) per dim (Gauss-Legendre quadrature) and
     apply the decentering postphase exp(s i t_k . x_c).

The statics (geometry, spread coordinates, inner type-2 points, phases and
deconvolution weights) are float64 numpy, computed by the same code as the
JAX package's and cast once to the transform's precision; only the
strengths run through torch. Gradients with respect to the strengths flow
through the spread (whose transpose is the interp at the same points) and
the inner type-2 core; the point sets are plan data.

Complex64 on the card runs the hand-written unplanned spread and interp
kernels (and at rank 3 the mode-stage kernels); complex128 on the card
takes the float64 route of ``kernels.dispatch.route`` and launches no
kernel; CPU tensors run the plain versions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from tensorflow_nufft_tpu_torch.kernels import dispatch
from tensorflow_nufft_tpu_torch.kernels.torch_ops import (
    fold_and_rescale_split)
from tensorflow_nufft_tpu_torch.ops.core import nufft_core
from tensorflow_nufft_tpu_torch.ops.nufft_ops import _full_precision_matmul
from tensorflow_nufft_tpu_torch.ops.planar_core import (
    FULL_GRID_ROUTES, _fold, _unfold, bin_for_plan, full_grid_windows,
    interp_full, spread_full)
from tensorflow_nufft_tpu_torch.options.options import Options
from tensorflow_nufft_tpu_torch.plan.plan import (
    EPSILON, MAX_ARRAY_SIZE, PlanSpec, auto_max_batch_size, es_kernel_np,
    kernel_beta, make_plan, select_kernel_width)
from tensorflow_nufft_tpu_torch.utils import profiling as prof
from tensorflow_nufft_tpu_torch.utils.batching import chunked_map
from tensorflow_nufft_tpu_torch.utils.dtypes import (
    as_tensor, entry_tensors, real_dtype)
from tensorflow_nufft_tpu_torch.utils.smooth import next_smooth_integer

_VALID_FFT_DIRECTIONS = ("forward", "backward")


def kernel_ft(omega: np.ndarray, width: int, beta: float) -> np.ndarray:
    """Continuous Fourier transform of the ES kernel at frequencies omega.

    psi_hat(omega) = 2 * int_0^{w/2} psi(u) cos(omega u) du, evaluated by
    the same Gauss-Legendre rule as the uniform-mode Fourier series
    (``plan.kernel_fseries_1d``) but at arbitrary real frequencies.
    Float64.
    """
    half_width = width / 2.0
    c = 4.0 / (width * width)
    q = int(2 + 3.0 * half_width)
    nodes, weights = np.polynomial.legendre.leggauss(2 * q)
    z = nodes[q:] * half_width
    f = half_width * weights[q:] * es_kernel_np(z, beta, c, half_width)
    return 2.0 * (np.cos(np.outer(np.asarray(omega, np.float64), z)) @ f)


@dataclasses.dataclass(frozen=True)
class Type3Statics:
    """Point-dependent statics of a type-3 transform, float64.

    Shared between the complex (``Type3Plan``) and planar
    (``planar.Type3Plan``) pipelines: the geometry and phases are
    identical; only the strength pipeline differs.
    """
    rank: int
    num_points: int
    num_targets: int
    fine_shape: Tuple[int, ...]
    width: int
    beta: float
    xi: np.ndarray          # [M, rank] spread coordinates in (-pi, pi)
    theta: np.ndarray       # [K, rank] inner type-2 points
    prephase: np.ndarray    # [M] complex128
    postphase: np.ndarray   # [K] complex128 (incl. kernel-FT deconv)


def _next_tile_friendly(n: int, rank: int) -> int:
    """Smallest even 5-smooth size >= n with a tile divisor from the
    binning preference lists.

    Any nf >= the minimum is mathematically valid (``gamma`` rescales
    with it). What matters is that nf has a tile divisor: a plain
    5-smooth size such as 270 (no 32/64 divisor) degenerates the inner
    type-2 to one large tile. Rank <= 2 rounds to a multiple of 32 (the
    inner type-2's own fine grid 2n is then a 5-smooth multiple of 64);
    rank 3 rounds to a multiple of 8 (volume-sensitive, and multiples of
    8 that are 5-smooth always carry an axis preference). 5-smoothness is
    kept because the spread-only plan validates it."""
    step = 32 if rank <= 2 else 8
    m = -(-n // step) * step
    while next_smooth_integer(m) != m:      # 5-smooth multiples only
        m += step
    return m


def compute_type3_statics(x64: np.ndarray, t64: np.ndarray,
                          fft_direction: str, tol: float,
                          real_dt=np.float64) -> Type3Statics:
    """Computes fine-grid geometry, rescaled coordinates and phases.

    See the module docstring for the derivation (sigma fixed at 2.0).
    ``real_dt`` is the transform's real dtype: the tolerance is clamped to
    its precision floor with the same rule as ``make_plan``, so the
    statics' kernel width always matches the spread and inner type-2
    plans' (a mismatch would deconvolve with the wrong kernel)."""
    rank = int(x64.shape[1])
    sigma = 2.0
    tol = max(float(tol), EPSILON[np.dtype(real_dt)])
    width = select_kernel_width(tol, sigma)
    beta = kernel_beta(width, sigma)

    x_c = (x64.max(0) + x64.min(0)) / 2.0
    t_c = (t64.max(0) + t64.min(0)) / 2.0
    half_x = np.abs(x64 - x_c).max(0)
    half_t = np.abs(t64 - t_c).max(0)
    # Degenerate (zero-extent) dimensions: substitute safe widths so
    # nf stays small and gamma finite; values are still exact because
    # the centered coordinate is identically zero along such dims.
    tiny = 1e-30
    x_safe = np.where(
        half_x <= tiny,
        np.where(half_t <= tiny, 1.0, 1.0 / np.maximum(half_t, tiny)),
        half_x)
    t_safe = np.where(half_x <= tiny,
                      np.where(half_t <= tiny, 1.0, half_t),
                      np.maximum(half_t, 1.0 / x_safe))

    fine_shape = []
    gamma = np.empty(rank, np.float64)
    for d in range(rank):
        n = int(2.0 * sigma * t_safe[d] * x_safe[d] / math.pi + width + 1)
        n = max(n, 2 * width)
        n = _next_tile_friendly(n, rank)
        fine_shape.append(n)
        gamma[d] = n / (2.0 * sigma * t_safe[d])
    fine_shape = tuple(fine_shape)
    # The inner type-2 oversamples this grid by sigma per dim; guard the
    # larger allocation here so the tailored message fires.
    inner_fine = int(np.prod([next_smooth_integer(int(n * sigma))
                              for n in fine_shape]))
    if inner_fine > MAX_ARRAY_SIZE:
        raise ValueError(
            f"type-3 fine grid is too big: {fine_shape} "
            f"(inner type-2 fine grid {inner_fine} elements > "
            f"{MAX_ARRAY_SIZE}). The grid scales with the product of the "
            "point and frequency extents per dimension.")
    h = 2.0 * math.pi / np.asarray(fine_shape, np.float64)
    sign = -1.0 if fft_direction == "forward" else 1.0

    xi = (x64 - x_c) / gamma                       # [M, rank]
    theta = (t64 - t_c) * gamma * h                # [K, rank]
    prephase = np.exp(sign * 1j * ((x64 - x_c) @ t_c))
    postphase = np.exp(sign * 1j * (t64 @ x_c))
    for d in range(rank):
        postphase = postphase / kernel_ft(theta[:, d], width, beta)
    return Type3Statics(
        rank=rank, num_points=int(x64.shape[0]),
        num_targets=int(t64.shape[0]), fine_shape=fine_shape,
        width=width, beta=beta, xi=xi, theta=theta,
        prephase=prephase, postphase=postphase)


def validate_type3_point_sets(points, target_points,
                              allowed_dtypes=(np.float32, np.float64)):
    """Shared validation: returns (x, t) as numpy arrays."""
    x = _concrete(points, "points")
    t = _concrete(target_points, "target_points")
    if x.ndim != 2 or t.ndim != 2:
        raise ValueError(
            "type-3 points and target_points must have shape "
            f"[M, rank] / [K, rank]; got {x.shape} and {t.shape}. "
            "(Batch dims are supported on the strengths only.)")
    if x.shape[1] != t.shape[1]:
        raise ValueError(
            f"points and target_points disagree on rank: "
            f"{x.shape[1]} vs {t.shape[1]}.")
    if x.shape[1] not in (1, 2, 3):
        raise ValueError(f"rank must be 1, 2 or 3, got {x.shape[1]}.")
    if x.shape[0] == 0 or t.shape[0] == 0:
        raise ValueError(
            "type-3 point sets must be non-empty, got "
            f"{x.shape[0]} points and {t.shape[0]} target_points.")
    if x.dtype != t.dtype:
        raise TypeError(
            f"points and target_points must share a dtype, got "
            f"{x.dtype} vs {t.dtype}.")
    if x.dtype not in [np.dtype(d) for d in allowed_dtypes]:
        raise TypeError(
            f"points must be one of {[np.dtype(d).name for d in allowed_dtypes]}, "
            f"got {x.dtype}.")
    return x, t


def _concrete(arr, name: str) -> np.ndarray:
    """``arr`` as a numpy array; a tensor that requires grad raises (the
    JAX package raises the same for a traced array)."""
    if isinstance(arr, torch.Tensor):
        if arr.requires_grad:
            raise ValueError(
                f"{name} must be concrete (no gradient) for a type-3 "
                "transform: the fine-grid geometry depends on the point "
                "values, so the point sets are plan-time statics. Pass "
                f"{name}.detach(); the resulting strength->values map is "
                "itself differentiable.")
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def _dtype_str(dtype) -> str:
    """A dtype's name as numpy prints it (``complex64``)."""
    return str(dtype).replace("torch.", "")


class FineSpread:
    """The raw ES-kernel spread of a type-3 plan onto its fine grid (no
    ``kernel_scale``: the exact kernel-FT deconvolution is in the
    postphase) and its transpose, the interp at the same points.

    The route is ``dispatch.route``'s: the unplanned tiled kernels (or
    their plain versions), binned once here; or a full-grid route: the
    XLA-path ops, whose window indices and values are computed once
    here, or the native engine, whose float64 points are.
    """

    def __init__(self, xi: torch.Tensor, plan):
        self.plan = plan
        self.route = dispatch.route(plan.spec, xi.device)
        if self.route in FULL_GRID_ROUTES:
            self.windows = full_grid_windows(
                fold_and_rescale_split(xi, plan.fine_shape, 0), plan,
                self.route)
        else:
            self.geom, self.binned = bin_for_plan(xi, plan)

    def spread(self, values_cm: torch.Tensor) -> torch.Tensor:
        """Channel-major values [2B, M] -> planar fine grid
        [B, *fine, 2]."""
        if self.route in FULL_GRID_ROUTES:
            batch = values_cm.shape[0] // 2
            z = torch.view_as_complex(
                _unfold(values_cm, batch).contiguous())
            return torch.view_as_real(
                spread_full(z, self.windows, self.plan, self.route))
        return dispatch.spread(values_cm, self.binned, self.geom, self.plan)

    def interp(self, grid: torch.Tensor) -> torch.Tensor:
        """Planar fine grid [B, *fine, 2] -> channel-major values
        [2B, M]."""
        if self.route in FULL_GRID_ROUTES:
            vals = interp_full(torch.view_as_complex(grid.contiguous()),
                               self.windows, self.plan, self.route)
            return _fold(torch.view_as_real(vals))
        return dispatch.interp(grid.contiguous(), self.binned, self.geom,
                               self.plan)


class _FineSpreadCall(torch.autograd.Function):
    """Planar values [B, M, 2] -> planar fine grid [B, *fine, 2]; the
    real kernel weights make its transpose the interp (``_FineInterpCall``)
    at the same points."""

    @staticmethod
    def forward(ctx, values, op):
        ctx.op = op
        return op.spread(_fold(values.contiguous()))

    @staticmethod
    def backward(ctx, cotangent):
        return _FineInterpCall.apply(cotangent, ctx.op), None


class _FineInterpCall(torch.autograd.Function):
    """The transpose of ``_FineSpreadCall``."""

    @staticmethod
    def forward(ctx, grid, op):
        ctx.op = op
        return _unfold(op.interp(grid), grid.shape[0])

    @staticmethod
    def backward(ctx, cotangent):
        return _FineSpreadCall.apply(cotangent, ctx.op), None


class Type3Plan:
    """Planned type-3 NUFFT for fixed point sets.

    Precomputes all point-dependent statics (fine-grid geometry, spread
    coordinates and their binning, inner type-2 points, phases,
    deconvolution weights) from ``points`` / ``target_points``;
    ``__call__`` maps strengths ``[..., M] -> [..., K]`` and is
    differentiable in the strengths (PyTorch's complex gradient: the
    conjugate of ``jax.grad``'s).

    Args:
        points: [M, rank] float32 (complex64 transforms) or float64
            (complex128) coordinates, any range; no gradient.
        target_points: [K, rank] frequencies, same dtype.
        device: where the plan lives. By default a tensor's own device,
            and the CUDA card for numpy/list points (raises without one).
    """

    def __init__(self, points, target_points,
                 fft_direction: str = "forward", tol: float = 1e-6,
                 options: Optional[Options] = None, device=None):
        if fft_direction not in _VALID_FFT_DIRECTIONS:
            raise ValueError(
                f"Invalid fft_direction: {fft_direction!r}. Must be one of "
                f"{sorted(_VALID_FFT_DIRECTIONS)}.")
        options = options or Options()
        if options.upsampling_factor not in (None, 0.0, 2.0):
            raise ValueError(
                "type-3 transforms support only upsampling_factor=2.0 "
                f"(got {options.upsampling_factor}).")
        points, target_points = entry_tensors(points, target_points,
                                              device=device)
        x, t = validate_type3_point_sets(points, target_points)
        dtype_name = ("complex64" if x.dtype == np.float32
                      else "complex128")
        st = compute_type3_statics(
            np.asarray(x, np.float64), np.asarray(t, np.float64),
            fft_direction, tol, real_dt=x.dtype)

        self.device = points.device
        self.rank = st.rank
        self.num_points = st.num_points
        self.num_targets = st.num_targets
        self.fft_direction = fft_direction
        self.dtype = getattr(torch, dtype_name)
        self._options = options
        self.fine_shape = st.fine_shape
        self.tol = float(tol)

        cplx = np.dtype(dtype_name)
        self._xi = torch.as_tensor(st.xi.astype(x.dtype), device=self.device)
        self._theta = torch.as_tensor(st.theta.astype(x.dtype),
                                      device=self.device)
        self._prephase = torch.as_tensor(st.prephase.astype(cplx),
                                         device=self.device)
        self._postphase = torch.as_tensor(st.postphase.astype(cplx),
                                          device=self.device)

        # Outer spread: the nf grid IS the spread grid (spread-only
        # geometry: fine == grid; nf is even, >= 2w, 5-smooth by
        # construction). kernel_scale is not applied: deconvolution by
        # the exact kernel FT happens in the postphase instead.
        self._spread_spec = PlanSpec(
            transform_type="type_1", fft_direction=fft_direction,
            rank=self.rank, grid_shape=self.fine_shape,
            dtype_name=dtype_name, tol=self.tol, points_range=0,
            spread_only=True, backend=options.backend,
            kernel_evaluation_method=options.kernel_evaluation_method)
        self._spread_plan = make_plan(self._spread_spec)
        if (self._spread_plan.width != st.width
                or self._spread_plan.fine_shape != self.fine_shape):
            raise AssertionError("type-3 spread plan geometry mismatch")
        self._spread = FineSpread(self._xi, self._spread_plan)
        # Inner type-2 on the nf grid at the rescaled target frequencies.
        self._t2_spec = PlanSpec(
            transform_type="type_2", fft_direction=fft_direction,
            rank=self.rank, grid_shape=self.fine_shape,
            dtype_name=dtype_name, tol=self.tol, points_range=0,
            backend=options.backend,
            kernel_evaluation_method=options.kernel_evaluation_method)

    def __call__(self, source) -> torch.Tensor:
        """Applies the transform: strengths [..., M] -> values [..., K]."""
        source = as_tensor(source, device=self.device)
        if source.dtype != self.dtype:
            raise TypeError(
                f"source must be {_dtype_str(self.dtype)} (from the points "
                f"dtype), got {_dtype_str(source.dtype)}.")
        if source.ndim < 1 or source.shape[-1] != self.num_points:
            raise ValueError(
                f"source must have shape [..., {self.num_points}], got "
                f"{tuple(source.shape)}.")
        batch_shape = tuple(source.shape[:-1])
        src = source.reshape((-1, self.num_points))
        # Bound fine-grid memory like the main API: the inner type-2's
        # oversampled grid dominates, and the planar core's size guard
        # counts each complex transform as two real channels.
        max_bs = self._options.max_batch_size
        if max_bs is None:
            max_bs = auto_max_batch_size(self._t2_spec, channels_per_batch=2)
        out = chunked_map(self._apply_inner, src, max_bs)
        return out.reshape(batch_shape + (self.num_targets,))

    def _apply_inner(self, src: torch.Tensor) -> torch.Tensor:
        """One inner batch: [B, M] -> [B, K]."""
        src = src * self._prephase
        with prof.scope("nufft3.spread"):
            grid = torch.view_as_complex(_FineSpreadCall.apply(
                torch.view_as_real(src), self._spread))
        with prof.scope("nufft3.inner_t2"):
            vals = nufft_core(grid, self._theta, self._t2_spec)
        return vals * self._postphase


def nufft_type3(source, points, target_points,
                fft_direction: str = "forward", tol: float = 1e-6,
                options: Optional[Options] = None, device=None):
    """Computes the type-3 NUFFT (nonuniform -> nonuniform).

    Evaluates f_k = sum_j source_j exp(s i target_points_k . points_j)
    with s = -1 for ``fft_direction='forward'``, +1 for ``'backward'``,
    to relative precision ~``tol``. Both point sets are arbitrary real
    coordinates (any range: the transform rescales internally).

    Args:
        source: ``[..., M]`` complex strengths (batch dims allowed).
        points: ``[M, rank]`` real coordinates, rank in {1, 2, 3}; no
            gradient (the plan geometry depends on the values).
        target_points: ``[K, rank]`` real target frequencies.
        fft_direction: "forward" (negative exponent) or "backward".
        tol: requested relative precision.
        options: optional ``Options`` (backend / kernel eval method).
        device: where to run (as ``nufft``'s).

    Returns:
        ``[..., K]`` complex values at the target frequencies.
    """
    source, points, target_points = entry_tensors(
        source, points, target_points, device=device)
    plan = Type3Plan(points, target_points, fft_direction, tol, options)
    return plan(source)


def nudft_type3(source, points, target_points,
                fft_direction: str = "forward", device=None):
    """Dense type-3 NUDFT oracle: O(M*K) work and memory; testing only.
    The phase and the sum in full precision (no TF32)."""
    if fft_direction not in _VALID_FFT_DIRECTIONS:
        raise ValueError(
            f"Invalid fft_direction: {fft_direction!r}. Must be one of "
            f"{sorted(_VALID_FFT_DIRECTIONS)}.")
    source, points, target_points = entry_tensors(
        source, points, target_points, device=device)
    sign = -1.0 if fft_direction == "forward" else 1.0
    with _full_precision_matmul():
        phase = target_points @ points.T                    # [K, M]
        phase = phase.to(real_dtype(source.dtype))
        mat = torch.polar(torch.ones_like(phase), sign * phase)
        return source @ mat.T.to(source.dtype)
