"""Building blocks: dense layers at the reference's cast points, MLP,
LayerNorm with flax's numerics, and the sinusoidal time embedding.

Parameter names follow the reference checkpoints (``W_in``, ``W_inter.N``,
``W_out``; LayerNorm ``weight``/``bias``), so a reference state dict loads
with ``load_state_dict(strict=True)``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from packppi_torch.ops.activations import activation
from packppi_torch.ops.precision import LN_EPS


def dense(x: torch.Tensor, lin: nn.Linear, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """A Linear evaluated like flax ``nn.Dense(dtype=dtype)``: with a dtype,
    input, weight and bias are cast to it and the output stays in it;
    without one, everything runs in float32."""
    if dtype is None or dtype == torch.float32:
        return F.linear(x.float(), lin.weight, lin.bias)
    return F.linear(x.to(dtype), lin.weight.to(dtype)) + lin.bias.to(dtype)


class LayerNorm(nn.Module):
    """flax LayerNorm numerics: statistics in float32 with the fast variance
    ``mean(x^2) - mean(x)^2`` clamped at 0, eps 1e-6, and
    ``(x - mean) * (rsqrt(var + eps) * weight) + bias``. Output in float32,
    or in ``dtype`` when given."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
        y = (x - mean) * (torch.rsqrt(var + LN_EPS) * self.weight) + self.bias
        return y if dtype is None else y.to(dtype)


class MLP(nn.Module):
    """``num_layers`` linear maps with the activation ``act``
    (``ops.activations.ACTS``) between them (reference layout: ``W_in``,
    ``W_inter.0..``, ``W_out``)."""

    def __init__(self, num_in: int, num_inter: int, num_out: int, num_layers: int,
                 act: str = "relu"):
        super().__init__()
        self.act = act
        self.act_fn = activation(act)
        self.W_in = nn.Linear(num_in, num_inter)
        self.W_inter = nn.ModuleList(nn.Linear(num_inter, num_inter)
                                     for _ in range(num_layers - 2))
        self.W_out = nn.Linear(num_inter, num_out)

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        x = self.act_fn(dense(x, self.W_in, dtype))
        for lin in self.W_inter:
            x = self.act_fn(dense(x, lin, dtype))
        return dense(x, self.W_out, dtype)


def sinusoidal_time_embedding(t: torch.Tensor, dim: int = 16,
                              max_positions: int = 10000,
                              scale: float = 10000.0) -> torch.Tensor:
    """Transformer-style sin/cos embedding of diffusion time ``t`` in [0, 1],
    pre-scaled by ``scale`` so the frequency bands are exercised."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_positions) / (half - 1)
                      * torch.arange(half, dtype=torch.float32, device=t.device))
    ang = (t.float() * scale)[..., None] * freqs
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], -1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb
