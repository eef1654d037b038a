"""Rounding helpers shared by the plain kernel twins and the models."""
from __future__ import annotations

import torch

LN_EPS = 1e-6  # flax.linen.LayerNorm's default (torch's is 1e-5)


def round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round a float32 tensor to ``dtype`` and back (a no-op for float32)."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def matmul_f32acc(x: torch.Tensor, w: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """``x @ w`` with both operands rounded to ``compute_dtype`` and the sum
    kept in float32 (a matrix unit's "bf16 operands, f32 accumulate").
    ``w`` is [in, out]."""
    return round_to(x.float(), compute_dtype) @ round_to(w.float(), compute_dtype)
