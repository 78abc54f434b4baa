"""The arithmetic the plain reference runs in.

``"float64"`` is the judge: every comparison holds the program's float32
outputs against it. ``"tf32"`` is the control, the reference computed one
step below the precision the configurations state (float32 with TF32
off): every matmul operand rounded to TF32 (10 mantissa bits, to nearest
even), the products summed in float32, the rest of the arithmetic float32.
The rounding is done here, bit by bit, so the control does not depend on
which kernel cuBLAS picks for a shape.
"""

from __future__ import annotations

import torch

PRECISIONS = ("float64", "float32", "tf32")


def dtype_of(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"precision is one of {PRECISIONS}, got "
                         f"{precision!r}")
    return torch.float64 if precision == "float64" else torch.float32


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to TF32's 10 mantissa bits, ties to even."""
    bits = t.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


class _Tf32Matmul(torch.autograd.Function):
    """a @ b with both operands rounded to TF32; both backward products
    round their operands too, as a TF32 tensor core would."""

    @staticmethod
    def forward(ctx, a, b):
        ra, rb = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(ra, rb)
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = round_tf32(g)
        ga = rg @ rb.transpose(-1, -2) if ctx.needs_input_grad[0] else None
        gb = ra.transpose(-1, -2) @ rg if ctx.needs_input_grad[1] else None
        return ga, gb


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        return _Tf32Matmul.apply(a, b)
    return a @ b

