"""Operand rounding for the control runs of the comparison: the reference's
products computed in the precision below the one a configuration states
(fp8 e4m3 with a per-tensor scale below bfloat16, TF32 below float32)."""
from __future__ import annotations

import torch


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the whole tensor (its
    largest magnitude maps to 448), and back to float32."""
    s = torch.clamp(x.detach().abs().amax(), min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest even), as float32."""
    i = x.detach().contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


BELOW = {"bfloat16": fp8, "float32": tf32}
