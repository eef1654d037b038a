"""Network weights: reference-named state dicts in and out.

The port's parameter names are the reference checkpoint's (``encoder.*``,
``mpnn.mpnn_layers.N.*``, ``decoder_score.{0,2}.*``), so a reference state
dict loads with ``load_state_dict(strict=True)``. ``from_flax_params`` maps
the JAX package's flax parameter tree onto those names (the inverse of
``tools/convert_checkpoint.py::convert_diffusion_state_dict``), and
``affinity_from_flax_params`` does the same for the affinity network. A
vanilla stack (``use_ipmp=False``) has no reference checkpoint in the
repository; its layers take the names of ``models.ipmp.VanillaMPNNLayer``
(``mpnn_layers.N.node_message_fn``, ``.node_dense``, ``.edge_message_fn``,
each ``W_in``, ``W_inter.N``, ``W_out``, and ``.norm.0-2``).
ESM-2's weights keep HuggingFace ``EsmModel``'s names
(``esm_from_jax_params``, ``load_esm_state_dict``).
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


def network_widths(state: Mapping) -> dict:
    """The ``NetworkConfig`` widths that a reference-named state dict of the
    score network was made at: ``hidden_dim`` (= ``node_features``),
    ``edge_features``, ``n_points`` and ``num_mpnn_layers``, read from its
    parameters' shapes; empty for a stack without points (the vanilla
    MPNN). ``top_k`` leaves no trace in the weights."""
    points = state.get("mpnn.mpnn_layers.0.points_fn_node.weight")
    if points is None:
        return {}
    layers = {k.split(".")[2] for k in state if k.startswith("mpnn.mpnn_layers.")}
    H = int(points.shape[1])
    return dict(hidden_dim=H, node_features=H,
                edge_features=int(state["encoder.norm_edges.weight"].shape[0]),
                n_points=int(points.shape[0]) // 3, num_mpnn_layers=len(layers))


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


def _factored_message(d, prefix, out, geom_dim):
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


def _vanilla_layer(layer: Mapping, pre: str, out) -> None:
    """A flax ``VanillaMPNNLayer_N`` (``MLP_0`` node message, ``MLP_1`` FFN,
    ``MLP_2`` edge message, ``LayerNorm_0-2``) -> the port's
    ``models.ipmp.VanillaMPNNLayer`` names: ``{pre}.node_message_fn``,
    ``.node_dense``, ``.edge_message_fn``, ``.norm.0-2``."""
    for flax_name, name in (("MLP_0", "node_message_fn"), ("MLP_1", "node_dense"),
                            ("MLP_2", "edge_message_fn")):
        _mlp(layer[flax_name], f"{pre}.{name}", out)
    for n in range(3):
        _layernorm(layer[f"LayerNorm_{n}"], f"{pre}.norm.{n}", out)


def _ipmp_stack(stack: Mapping, prefix: str, out) -> None:
    """A flax ``MessagePassingStack`` -> ``{prefix}.mpnn_layers.N.*`` (its
    ``InvariantPointLayer_N`` or, with ``use_ipmp=False``, its
    ``VanillaMPNNLayer_N``)."""
    for i in range(len(stack)):
        if f"VanillaMPNNLayer_{i}" in stack:
            _vanilla_layer(stack[f"VanillaMPNNLayer_{i}"], f"{prefix}.mpnn_layers.{i}", out)
            continue
        layer = stack[f"InvariantPointLayer_{i}"]
        pre = f"{prefix}.mpnn_layers.{i}"
        _linear(layer["Dense_0"], f"{pre}.points_fn_node", out)
        _linear(layer["Dense_1"], f"{pre}.points_fn_edge", out)
        geom_dim = 3 * np.asarray(layer["Dense_0"]["kernel"]).shape[1]  # 9P from 3P
        _factored_message(layer["MLP_0"], f"{pre}.node_message_fn", out, geom_dim)
        _factored_message(layer["MLP_2"], f"{pre}.edge_message_fn", out, geom_dim)
        for n in range(4):
            _layernorm(layer[f"LayerNorm_{n}"], f"{pre}.norm.{n}", out)
        _mlp(layer["MLP_1"], f"{pre}.node_dense", out)
        _mlp(layer["MLP_3"], f"{pre}.edge_dense", out)


def _encoder(enc: Mapping, prefix: str, out) -> None:
    _linear(enc["Dense_0"], f"{prefix}.node_embedding", out)
    _layernorm(enc["LayerNorm_0"], f"{prefix}.norm_nodes", out)
    _linear(enc["Dense_1"], f"{prefix}.edge_embedding", out)
    _layernorm(enc["LayerNorm_1"], f"{prefix}.norm_edges", out)


def from_flax_params(tree: Mapping) -> dict[str, np.ndarray]:
    """The JAX package's ``ChiScoreNetwork`` parameter tree (``{'params':
    ...}`` or the inner dict, leaves as numpy arrays) -> a reference-named
    state dict of numpy arrays."""
    p = tree.get("params", tree)
    out: dict[str, np.ndarray] = {}
    _encoder(p["ProteinEncoder_0"], "encoder", out)
    _ipmp_stack(p["MessagePassingStack_0"], "mpnn", out)
    _mlp(p["MLP_0"], "decoder_score.0", out)
    _mlp(p["MLP_1"], "decoder_score.2", out)
    return out


def affinity_from_flax_params(tree: Mapping) -> dict[str, np.ndarray]:
    """The JAX package's ``AffinityNet`` parameter tree -> the reference
    ``AffinityPrediction`` names (``mutation_encoder.*``, ``mutation_mpnn.*``,
    ``mutation_fusion.{0,2}.*``, ``seq_embedding.weight``, ``mut_bias.weight``,
    ``ddg_predictor.{0,2,4}.*``): the inverse of
    ``tools/convert_checkpoint.py::convert_affinity_state_dict``. In
    ``linear`` and ``esm`` mode the tree holds the head alone."""
    p = tree.get("params", tree)
    out: dict[str, np.ndarray] = {}
    if "mutation_encoder" in p:
        _encoder(p["mutation_encoder"], "mutation_encoder", out)
        _ipmp_stack(p["mutation_mpnn"], "mutation_mpnn", out)
        for name in ("mut_bias", "seq_embedding"):
            out[f"{name}.weight"] = np.asarray(p[name]["embedding"])
        _linear(p["Dense_0"], "mutation_fusion.0", out)
        _linear(p["Dense_1"], "mutation_fusion.2", out)
    head = p["DdgHead_0"]
    for i in range(3):
        _linear(head[f"Dense_{i}"], f"ddg_predictor.{2 * i}", out)
    return out


# keys of a HuggingFace EsmModel state dict that the port's ESM2 has no use
# for: the pooler and contact head (not run by extraction), the position-id
# buffer (no absolute positions in ESM-2) and each layer's rotary frequency
# buffer (the port builds its rotary tables from the head width)
_ESM_UNUSED_PREFIXES = ("pooler.", "contact_head.")
_ESM_UNUSED_KEYS = ("embeddings.position_ids",)
_ESM_UNUSED_SUFFIXES = (".rotary_embeddings.inv_freq",)

_ESM_LAYER_KEYS = (
    ("wq", "bq", "attention.self.query"), ("wk", "bk", "attention.self.key"),
    ("wv", "bv", "attention.self.value"), ("wo", "bo", "attention.output.dense"),
    ("w1", "b1", "intermediate.dense"), ("w2", "b2", "output.dense"),
    ("ln1_scale", "ln1_bias", "attention.LayerNorm"), ("ln2_scale", "ln2_bias", "LayerNorm"),
)


def esm_from_jax_params(params: Mapping) -> dict[str, np.ndarray]:
    """The JAX package's stacked ESM-2 parameters (``convert_hf_esm``: linear
    kernels [L, in, out], everything else [L, ...]) -> HuggingFace
    ``EsmModel`` names with Linear weights [out, in]."""
    out = {"embeddings.word_embeddings.weight": np.asarray(params["embedding"]),
           "encoder.emb_layer_norm_after.weight": np.asarray(params["final_ln_scale"]),
           "encoder.emb_layer_norm_after.bias": np.asarray(params["final_ln_bias"])}
    layers = {k: np.asarray(v) for k, v in params["layers"].items()}
    for i in range(layers["wq"].shape[0]):
        for w, b, stem in _ESM_LAYER_KEYS:
            weight = layers[w][i]
            out[f"encoder.layer.{i}.{stem}.weight"] = (
                np.ascontiguousarray(weight.T) if weight.ndim == 2 else weight)
            out[f"encoder.layer.{i}.{stem}.bias"] = layers[b][i]
    return out


def load_esm_state_dict(module: nn.Module, sd: Mapping, assign: bool = False) -> None:
    """Load a HuggingFace ``EsmModel`` state dict into the port's ``ESM2``
    strictly: every parameter present, and no key left over but the unused
    ones named above. ``assign`` makes the given float32 tensors the
    module's parameters (a module built on the meta device)."""
    used = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in sd.items()
            if not (k.startswith(_ESM_UNUSED_PREFIXES) or k in _ESM_UNUSED_KEYS
                    or k.endswith(_ESM_UNUSED_SUFFIXES))}
    module.load_state_dict(used, strict=True, assign=assign)
