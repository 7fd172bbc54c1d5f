"""The precision a reference computation runs in.

``FLOAT64`` is the reference. ``TF32`` is the control: the same
computation in float32 with the operands of every contraction (matmul,
einsum) rounded to TF32's 10-bit mantissa, as tensor cores would take
them with ``allow_tf32`` on. The products of two TF32 numbers are exact
in float32, so float32 arithmetic on rounded operands is what the tensor
cores compute.
"""

from __future__ import annotations

import dataclasses

import torch


def strict_fp32() -> None:
    """Keeps float32 matmuls at full float32 (no TF32 on the card)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Rounds float32 ``x`` to the nearest TF32 value (ties to even)."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & -8192).view(torch.float32)


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str
    real: torch.dtype
    complex: torch.dtype
    tf32: bool

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as an operand of a contraction in this precision."""
        x = x.to(self.complex if x.is_complex() else self.real)
        if not self.tf32:
            return x
        if x.is_complex():
            return torch.view_as_complex(round_tf32(torch.view_as_real(x)))
        return round_tf32(x)


FLOAT64 = Precision("float64", torch.float64, torch.complex128, False)
TF32 = Precision("tf32", torch.float32, torch.complex64, True)
