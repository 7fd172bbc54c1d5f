"""Point fold/rescale and ES kernel evaluation in plain torch.

Counterpart of ``tensorflow_nufft_tpu.kernels.xla_ops`` (the parts the
planar 2D path uses). Every operation is a separate eager torch op, so
nothing is fused or contracted: the compensated (two-float) arithmetic
of ``fold_and_rescale_split`` keeps its error terms exactly as the JAX
version computes them. The scalar and per-axis constants are built on
the host once and cached on their device (``_const``), so a call after
the first copies nothing from the host and never waits for the device.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

# PointsRange enum values (STRICT=0, EXTENDED=1, INFINITE=2).
STRICT = 0
EXTENDED = 1
INFINITE = 2


def _const(value, like: torch.Tensor) -> torch.Tensor:
    """``value`` (a numpy scalar or array) in ``like``'s dtype on its
    device, cast there from the value's own numpy dtype. Cached, since a
    pageable host-to-device copy waits for all the work queued before
    it. The cached tensors are read only."""
    a = np.asarray(value)
    return _const_tensor(a.tobytes(), a.shape, a.dtype.str, like.dtype,
                         like.device)


@functools.lru_cache(maxsize=256)
def _const_tensor(raw: bytes, shape, np_dtype: str, dtype,
                  device) -> torch.Tensor:
    a = np.frombuffer(raw, dtype=np_dtype).reshape(shape).copy()
    # Made outside inference mode, so autograd may save it later.
    with torch.inference_mode(False):
        return torch.as_tensor(a, device=device).to(dtype)


def fold_and_rescale(points: torch.Tensor, fine_shape: Sequence[int],
                     points_range: int) -> torch.Tensor:
    """Maps point coordinates from radians to fine-grid units in [0, nf).

    ``points`` has shape [..., rank]; coordinate d is scaled by
    ``fine_shape[d]``. STRICT assumes [-pi, pi] and only shifts,
    EXTENDED folds once from [-3pi, 3pi], INFINITE folds any value.
    """
    x = points
    n = _const(np.array(fine_shape, dtype=np.float64), x)
    pi = _const(np.pi, x)
    two_pi = _const(2.0 * np.pi, x)
    if points_range == STRICT:
        s = x + pi
    elif points_range == EXTENDED:
        s = torch.where(x > pi, x - pi,
                        torch.where(x < -pi, x + 3 * pi, x + pi))
    elif points_range == INFINITE:
        # jnp.mod's floored remainder is fmod plus one shift of negative
        # remainders; the JAX version then applies the same shift again.
        s = torch.fmod(x + pi, two_pi)
        s = torch.where(s < 0, s + two_pi, s)
        s = torch.where(s < 0, s + two_pi, s)
    else:
        raise ValueError(f"Invalid points_range: {points_range}")
    return s * (n / two_pi)


def fold_and_rescale_split(points: torch.Tensor, fine_shape: Sequence[int],
                           points_range: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-float (hi, lo) fold/rescale for float32 points.

    A rescaled coordinate s in [0, nf) stored in one float32 carries an
    absolute error of ~nf * 2^-25 grid units, a phase error of
    ~k_max * 2pi * 2^-25 at the largest modes. This returns s as an
    exact-compensated pair (s_hi + s_lo within ~1e-12 grid units) using
    Dekker/Veltkamp arithmetic, op for op as the JAX version does it.
    pi * (nf / 2pi) == nf/2 exactly, so the +pi shift is the exact
    integer nf/2 and only the product x * c needs compensation.

    float64 points take the plain fold and a zero low word.
    """
    if points.dtype == torch.float64:
        s = fold_and_rescale(points, fine_shape, points_range)
        return s, torch.zeros_like(s)
    if points.dtype != torch.float32:
        raise TypeError(f"points must be float32 or float64, got "
                        f"{points.dtype}")

    n64 = np.array(fine_shape, dtype=np.float64)
    c64 = n64 / (2.0 * np.pi)
    c_hi = c64.astype(np.float32)
    c_lo = (c64 - c_hi.astype(np.float64)).astype(np.float32)
    # Exact Veltkamp split of the per-dim c_hi constants (host, f32).
    w = c_hi * np.float32(4097.0)
    b1 = (w - (w - c_hi)).astype(np.float32)
    b2 = (c_hi - b1).astype(np.float32)

    x = points
    split = _const(np.float32(4097.0), x)
    n_f = _const(n64.astype(np.float32), x)
    c_hi, c_lo, b1, b2 = (_const(v, x) for v in (c_hi, c_lo, b1, b2))
    xw = x * split
    a_hi = xw - (xw - x)
    a_lo = x - a_hi
    p = x * c_hi
    err = (((a_hi * b1 - p) + a_hi * b2) + a_lo * b1) + a_lo * b2
    err = err + x * c_lo

    pi = _const(np.float32(np.pi), x)
    half_n = _const((n64 / 2.0).astype(np.float32), x)
    if points_range in (STRICT, INFINITE):
        offset = half_n.expand_as(x)
    elif points_range == EXTENDED:
        offset = (half_n - n_f * (x > pi).to(x.dtype)) \
            + n_f * (x < -pi).to(x.dtype)
    else:
        raise ValueError(f"Invalid points_range: {points_range}")

    s_hi = p + offset
    err = err + (p - (s_hi - offset))
    if points_range == INFINITE:
        # Compensated wrap: q*n_f can round (n_f is 5-smooth, not a power
        # of two) and so can the subtraction; both residuals feed err so
        # far-out-of-range points keep two-float coordinate precision.
        q = torch.floor(s_hi / n_f)
        t0 = s_hi - q * n_f
        q = (q + (t0 >= n_f).to(x.dtype)) - (t0 < 0).to(x.dtype)
        qw = q * split
        q_hi = qw - (qw - q)
        q_lo = q - q_hi
        prod = q * n_f
        prod_err = (q_hi * n_f - prod) + q_lo * n_f
        # Knuth TwoSum (branch-free; no magnitude precondition).
        b_ = -prod
        t = s_hi + b_
        bb = t - s_hi
        sub_err = (s_hi - (t - bb)) + (b_ - bb)
        s_hi = t
        err = (err + sub_err) - prod_err
        s_hi = torch.where(s_hi < 0, s_hi + n_f, s_hi)
        s_hi = torch.where(s_hi >= n_f, s_hi - n_f, s_hi)
    return s_hi, err


def es_kernel(z: torch.Tensor, beta: float, c: float,
              half_width: float) -> torch.Tensor:
    """"Exponential of semicircle" kernel phi(z) = exp(beta sqrt(1 - c z^2)),
    zero outside |z| < half_width."""
    beta, c, half_width = (_const(v, z) for v in (beta, c, half_width))
    inside = torch.abs(z) < half_width
    arg = 1.0 - c * torch.square(z)
    arg_safe = torch.where(inside, torch.clamp(arg, min=0.0),
                           torch.ones_like(z))
    val = torch.exp(beta * torch.sqrt(arg_safe))
    return torch.where(inside, val, torch.zeros_like(z))


def es_kernel_deriv(z: torch.Tensor, beta: float, c: float,
                    half_width: float) -> torch.Tensor:
    """The kernel's derivative phi'(z) = -beta c z exp(beta r) / r with
    r = sqrt(max(1 - c z^2, 1e-12)), zero outside |z| < half_width, in
    the JAX package's operation order (``es_kernel_matrix_deriv``).
    Always direct: the Horner fit approximates phi, not phi'."""
    beta, c, half_width = (_const(v, z) for v in (beta, c, half_width))
    inside = torch.abs(z) < half_width
    arg = torch.where(inside, torch.clamp(1.0 - c * z * z, min=1e-12),
                      torch.ones_like(z))
    r = torch.sqrt(arg)
    val = (-beta * c) * z * torch.exp(beta * r) / r
    return torch.where(inside, val, torch.zeros_like(z))


def es_kernel_horner(z: torch.Tensor, horner, half_width: float
                     ) -> torch.Tensor:
    """Horner evaluation of the plan's fitted kernel polynomial
    (ascending power-basis coefficients in t = 2 (z/half_width)^2 - 1,
    see plan.fit_horner_coeffs). More accurate than ``es_kernel`` in
    float32 and transcendental-free."""
    np_dt = np.float32 if z.dtype == torch.float32 else np.float64
    u = torch.square(z) * _const(np_dt(2.0 / (half_width * half_width)), z)
    t = u - 1.0
    inside = t < 1.0
    one = torch.ones_like(t)
    # Clamp masked lanes so far-out sentinels don't overflow to inf.
    t = torch.where(inside, t, one)
    acc = one * _const(np_dt(horner[-1]), z)
    for a in horner[-2::-1]:
        acc = acc * t + _const(np_dt(a), z)
    return torch.where(inside, acc, torch.zeros_like(acc))


def es_kernel_for(z: torch.Tensor, plan, deriv: bool = False
                  ) -> torch.Tensor:
    """Fitted Horner polynomial when the plan has one and ``z`` is
    float32, direct exp/sqrt otherwise; with ``deriv``, the direct
    derivative phi'."""
    np_dt = np.float32 if z.dtype == torch.float32 else np.float64
    consts = (np_dt(plan.beta), np_dt(plan.c), np_dt(plan.half_width))
    if deriv:
        return es_kernel_deriv(z, *consts)
    if plan.horner is not None and z.dtype == torch.float32:
        return es_kernel_horner(z, plan.horner, plan.half_width)
    return es_kernel(z, *consts)
