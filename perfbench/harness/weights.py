"""Seeded weights, made by the benchmark and handed to the program and to the
reference alike: every parameter of one state dict drawn by one
``torch.rand`` call on the device from a generator seeded with the run's
seed, then cut and scaled (linear and embedding matrices Xavier-uniform,
biases uniform in +-0.1, LayerNorm scales 1 +- 0.1 and offsets +-0.1).
Non-trivial biases and norms keep a fault in either from hiding behind a
zero or a one.

Names and shapes are those of the PackPPI reference checkpoints, so the
program loads the dict with ``load_state_dict(strict=True)``.
"""
from __future__ import annotations

import math

import torch


def _linear(out: dict, name: str, n_out: int, n_in: int) -> None:
    out[f"{name}.weight"] = (n_out, n_in)
    out[f"{name}.bias"] = (n_out,)


def _norm(out: dict, name: str, n: int) -> None:
    out[f"{name}.weight"] = (n,)
    out[f"{name}.bias"] = (n,)


def _mlp(out: dict, name: str, n_in: int, n_mid: int, n_out: int, n_inter: int = 0) -> None:
    _linear(out, f"{name}.W_in", n_mid, n_in)
    for i in range(n_inter):
        _linear(out, f"{name}.W_inter.{i}", n_mid, n_mid)
    _linear(out, f"{name}.W_out", n_out, n_mid)


def _encoder(out: dict, name: str, H: int, He: int, time_dim: int) -> None:
    _linear(out, f"{name}.node_embedding", H, 21 + 6 + 8 + time_dim)
    _norm(out, f"{name}.norm_nodes", H)
    _linear(out, f"{name}.edge_embedding", He, 65 + 25 * 16 + 1 + 2)
    _norm(out, f"{name}.norm_edges", He)


def _stack(out: dict, name: str, H: int, He: int, P: int, layers: int) -> None:
    for i in range(layers):
        pre = f"{name}.mpnn_layers.{i}"
        _linear(out, f"{pre}.points_fn_node", 3 * P, H)
        _linear(out, f"{pre}.points_fn_edge", 3 * P, H)
        for fn in ("node_message_fn", "edge_message_fn"):
            _mlp(out, f"{pre}.{fn}", 2 * H + He + 9 * P, H, H, 1)
        for n in range(4):
            _norm(out, f"{pre}.norm.{n}", H)
        _mlp(out, f"{pre}.node_dense", H, 4 * H, H)
        _mlp(out, f"{pre}.edge_dense", H, 4 * H, H)


def score_net_shapes(cfg: dict) -> dict:
    """The chi score network (``ChiScoreNetwork``)."""
    H, He, P = cfg["hidden_dim"], cfg["edge_features"], cfg["n_points"]
    out: dict = {}
    _encoder(out, "encoder", H, He, cfg["time_embedding_dim"])
    _stack(out, "mpnn", H, He, P, cfg["num_mpnn_layers"])
    _mlp(out, "decoder_score.0", H, H // 2, H // 4)
    _mlp(out, "decoder_score.2", H // 4, H // 8, 4)
    return out


def affinity_net_shapes(cfg: dict) -> dict:
    """PackPPI-AP's own network in network mode (``AffinityNet``)."""
    H, He, P = cfg["hidden_dim"], cfg["edge_features"], cfg["n_points"]
    out: dict = {}
    _encoder(out, "mutation_encoder", H, He, 0)
    _stack(out, "mutation_mpnn", H, He, P, cfg["num_mpnn_layers"])
    out["seq_embedding.weight"] = (21, H)
    out["mut_bias.weight"] = (2, H)
    _linear(out, "mutation_fusion.0", H, 3 * H)
    _linear(out, "mutation_fusion.2", H, H)
    for i in (0, 2):
        _linear(out, f"ddg_predictor.{i}", H, H)
    _linear(out, "ddg_predictor.4", 1, H)
    return out


def make(shapes: dict, generator: torch.Generator, device) -> dict:
    """A float32 state dict of ``shapes`` from one draw of ``generator``."""
    total = sum(math.prod(s) for s in shapes.values())
    u = torch.rand(total, generator=generator, device=device) * 2 - 1     # U(-1, 1)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        v = u[at:at + n].view(shape)
        at += n
        if len(shape) == 2:
            v = v * math.sqrt(6.0 / (shape[0] + shape[1]))
        elif ".norm" in name and name.endswith(".weight"):
            v = 1.0 + 0.1 * v
        else:
            v = 0.1 * v
        out[name] = v.contiguous()
    return out
