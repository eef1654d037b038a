"""Network weights: reference-named state dicts in and out.

The port's parameter names are the reference checkpoint's (``encoder.*``,
``mpnn.mpnn_layers.N.*``, ``decoder_score.{0,2}.*``), so a reference state
dict loads with ``load_state_dict(strict=True)``. ``from_flax_params`` maps
the JAX package's flax parameter tree onto those names (the inverse of
``tools/convert_checkpoint.py::convert_diffusion_state_dict``).
"""
from __future__ import annotations

from pathlib import Path
from typing import Mapping, Union

import numpy as np
import torch
from torch import nn

SD_PREFIX = "sd::"


def read_state_dict(path: Union[str, Path]) -> dict[str, torch.Tensor]:
    """A state dict from ``torch.save`` (``.pt``/``.pth``; optionally under a
    ``state_dict`` key, or the ``params`` of a full train state with its
    ``step``) or an ``.npz`` of reference-named arrays. In an
    ``.npz`` holding any ``sd::``-prefixed key, only those keys are read
    (prefix stripped); other arrays in such files are activations."""
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as z:
            keys = list(z.files)
            if any(k.startswith(SD_PREFIX) for k in keys):
                return {k[len(SD_PREFIX):]: torch.tensor(z[k]) for k in keys
                        if k.startswith(SD_PREFIX)}
            return {k: torch.tensor(z[k]) for k in keys}
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if "params" in blob and "step" in blob:      # a full train state
        return dict(blob["params"])
    return dict(blob.get("state_dict", blob))


def load_weights(module: nn.Module, state: Union[str, Path, Mapping]) -> None:
    """Load a reference-named state dict (or a file holding one) into
    ``module`` strictly: every parameter must be present, no key left over."""
    if not isinstance(state, Mapping):
        state = read_state_dict(state)
    module.load_state_dict({k: torch.as_tensor(np.array(v, np.float32)) for k, v in state.items()},
                           strict=True)


def init_weights(module: nn.Module, seed: int) -> None:
    """Random weights from ``seed``: Xavier-uniform Linear kernels, zero
    biases, unit LayerNorm scales (the reference's initialisation)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.ndim == 2:
                fan_out, fan_in = p.shape
                a = (6.0 / (fan_in + fan_out)) ** 0.5
                p.copy_((torch.rand(p.shape, generator=g) * 2 - 1) * a)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.fill_(1.0)


def _linear(d, prefix, out):
    out[f"{prefix}.weight"] = np.ascontiguousarray(np.asarray(d["kernel"]).T)
    out[f"{prefix}.bias"] = np.asarray(d["bias"])


def _layernorm(d, prefix, out):
    out[f"{prefix}.weight"] = np.asarray(d["scale"])
    out[f"{prefix}.bias"] = np.asarray(d["bias"])


def _mlp(d, prefix, out):
    n = len(d)
    _linear(d["Dense_0"], f"{prefix}.W_in", out)
    for i in range(n - 2):
        _linear(d[f"Dense_{i + 1}"], f"{prefix}.W_inter.{i}", out)
    _linear(d[f"Dense_{n - 1}"], f"{prefix}.W_out", out)


def _message_mlp(d, prefix, out, geom_dim):
    """Factored message MLP -> reference ``W_in`` over [h_i | h_E | h_j |
    geometry]: ``Dense_e`` holds the [h_E | geometry] rows and the bias."""
    wi = np.asarray(d["Dense_i"]["kernel"])
    wj = np.asarray(d["Dense_j"]["kernel"])
    we = np.asarray(d["Dense_e"]["kernel"])
    he = we.shape[0] - geom_dim
    w = np.concatenate([wi, we[:he], wj, we[he:]], 0)
    out[f"{prefix}.W_in.weight"] = np.ascontiguousarray(w.T)
    out[f"{prefix}.W_in.bias"] = np.asarray(d["Dense_e"]["bias"])
    _linear(d["Dense_1"], f"{prefix}.W_inter.0", out)
    _linear(d["Dense_2"], f"{prefix}.W_out", out)


def from_flax_params(tree: Mapping) -> dict[str, np.ndarray]:
    """The JAX package's ``ChiScoreNetwork`` parameter tree (``{'params':
    ...}`` or the inner dict, leaves as numpy arrays) -> a reference-named
    state dict of numpy arrays."""
    p = tree.get("params", tree)
    out: dict[str, np.ndarray] = {}
    enc = p["ProteinEncoder_0"]
    _linear(enc["Dense_0"], "encoder.node_embedding", out)
    _layernorm(enc["LayerNorm_0"], "encoder.norm_nodes", out)
    _linear(enc["Dense_1"], "encoder.edge_embedding", out)
    _layernorm(enc["LayerNorm_1"], "encoder.norm_edges", out)

    stack = p["MessagePassingStack_0"]
    for i in range(len(stack)):
        layer = stack[f"InvariantPointLayer_{i}"]
        pre = f"mpnn.mpnn_layers.{i}"
        _linear(layer["Dense_0"], f"{pre}.points_fn_node", out)
        _linear(layer["Dense_1"], f"{pre}.points_fn_edge", out)
        geom_dim = 3 * np.asarray(layer["Dense_0"]["kernel"]).shape[1]  # 9P from 3P
        _message_mlp(layer["MLP_0"], f"{pre}.node_message_fn", out, geom_dim)
        _message_mlp(layer["MLP_2"], f"{pre}.edge_message_fn", out, geom_dim)
        for n in range(4):
            _layernorm(layer[f"LayerNorm_{n}"], f"{pre}.norm.{n}", out)
        _mlp(layer["MLP_1"], f"{pre}.node_dense", out)
        _mlp(layer["MLP_3"], f"{pre}.edge_dense", out)

    _mlp(p["MLP_0"], "decoder_score.0", out)
    _mlp(p["MLP_1"], "decoder_score.2", out)
    return out
