"""The activation table of the message and chain MLPs (``NetworkConfig.act``).

The functions of ``jax.nn`` / flax with jax's constants: gelu in its tanh
form (jax's default; torch's default is the erf form), elu and celu with
alpha 1, selu with jax's scale and alpha, leaky_relu with slope 0.01. The
kernels apply the same functions in float32 (``csrc/tile.cuh`` ``act``, one
library per activation: ``ops._build.ACTS``); these are their plain
versions and the unfused path's.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from packppi_torch.ops import _build

ACTS = {
    "relu": F.relu,
    "gelu": functools.partial(F.gelu, approximate="tanh"),
    "elu": F.elu,
    "selu": F.selu,
    "celu": F.celu,
    "leaky_relu": functools.partial(F.leaky_relu, negative_slope=0.01),
    "silu": F.silu,
    "sigmoid": torch.sigmoid,
}
assert tuple(ACTS) == _build.ACTS


def activation(name: str):
    """The function of activation ``name``; raises for a name not in the
    table."""
    try:
        return ACTS[name]
    except KeyError:
        raise ValueError(f"activation {name!r} is not one of {tuple(ACTS)}") from None
