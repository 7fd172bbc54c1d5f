"""Helpers shared by the entries."""

from __future__ import annotations

import torch


def complex_of(planar: torch.Tensor) -> torch.Tensor:
    """A planar (re, im) tensor as complex128."""
    return torch.view_as_complex(planar.detach().double().contiguous())


def planar_of(z: torch.Tensor) -> torch.Tensor:
    """A complex tensor as a contiguous planar float32 tensor."""
    return torch.view_as_real(z.to(torch.complex64)).contiguous()


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| / max |ref|, in float64."""
    got = got.to(torch.complex128 if got.is_complex() else torch.float64)
    ref = ref.to(got.dtype)
    return float((got - ref).abs().max() / ref.abs().max())

