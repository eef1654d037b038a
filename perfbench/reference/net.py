"""The PackPPI-MSC chi score network and the PackPPI-AP mutation network in
plain float32 PyTorch, written from the model's description.

Encoder: a masked kNN graph over CA (``top_k`` neighbours, self included),
edge features [relative-position one-hot (65) | RBFs of the 25 distances
between {N, CA, C, O, virtual CB} of the two residues (16 each) | same-chain
flag + 1 | inter-residue phi, psi] -> linear -> LayerNorm; node features
[sequence one-hot (21) | backbone dihedral sin/cos (6) | chi sin/cos (8) |
sinusoidal time embedding] -> linear -> LayerNorm.

Each invariant-point layer: every node predicts ``P`` points in its backbone
frame; an edge's geometry is [its points | their norms | the neighbour's
points in its frame | their norms | point-pair distances]; the message MLP
(3 linear maps, relu) reads [h_i | h_E | h_j | geometry]. Node pass: the
message summed over the K edges divided by K, then h = LN(h + m), h = LN(h
+ FFN(h)) masked. Edge pass, on the updated nodes: h_E = LN(h_E + m mask),
h_E = LN(h_E + FFN(h_E)) masked. The decoder maps h_V to four chi scores.

LayerNorm is flax's: variance ``E[x^2] - E[x]^2`` clamped at 0, eps 1e-6.
Every linear map goes through ``Params.lin``, whose ``quant`` rounds both
operands first: ``None`` for the reference, a lower precision for the
rounding floor and the control (``precision.py``).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

LN_EPS = 1e-6


class Params:
    """Named float32 parameters and the rounding applied to products."""

    def __init__(self, state: dict, quant: Optional[Callable] = None):
        self.state, self.quant = state, quant

    def lin(self, prefix: str, x: torch.Tensor) -> torch.Tensor:
        w, b = self.state[f"{prefix}.weight"], self.state.get(f"{prefix}.bias")
        if self.quant is not None:
            x, w = self.quant(x), self.quant(w)
        y = x @ w.t()
        return y if b is None else y + b

    def ln(self, prefix: str, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
        return ((x - mean) * torch.rsqrt(var + LN_EPS) * self.state[f"{prefix}.weight"]
                + self.state[f"{prefix}.bias"])

    def mlp(self, prefix: str, x: torch.Tensor, n_inter: int = 0) -> torch.Tensor:
        x = F.relu(self.lin(f"{prefix}.W_in", x))
        for i in range(n_inter):
            x = F.relu(self.lin(f"{prefix}.W_inter.{i}", x))
        return self.lin(f"{prefix}.W_out", x)


def gather(nodes: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """nodes [B, L, *F] at idx [B, L, K] -> [B, L, K, *F]."""
    B, L, K = idx.shape
    flat = nodes.reshape(B, L, -1)
    out = torch.gather(flat, 1, idx.reshape(B, L * K, 1).expand(-1, -1, flat.shape[-1]))
    return out.reshape(B, L, K, *nodes.shape[2:])


def knn(ca: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """[B, L, K] neighbour indices by CA distance among valid residues;
    invalid pairs sort last, ties in column order."""
    m2 = mask[:, :, None] * mask[:, None, :]
    d = m2 * torch.sqrt(((ca[:, :, None] - ca[:, None]) ** 2).sum(-1) + 1e-6)
    d = d + 2.0 * (1.0 - m2) * d.amax(-1, keepdim=True)
    return torch.sort(d, dim=-1, stable=True)[1][..., :min(k, ca.shape[1])]


def _unit(v):
    n = torch.sqrt((v * v).sum(-1, keepdim=True))
    return torch.where(n > 1e-20, v, torch.zeros_like(v)) / torch.clamp(n, min=1e-20)


def dihedral(p0, p1, p2, p3):
    """The dihedral p0-p1-p2-p3, 0 where the normals degenerate."""
    axis, v1, v2 = torch.broadcast_tensors(p2 - p1, p0 - p1, p3 - p2)
    n1 = _unit(torch.linalg.cross(axis, v1, dim=-1))
    n2 = _unit(torch.linalg.cross(axis, v2, dim=-1))
    sign = torch.sign((torch.linalg.cross(v1, v2, dim=-1) * axis).sum(-1))
    dot = (n1 * n2).sum(-1)
    d = sign * torch.arccos(torch.clamp(dot, -1.0, 1.0))
    return torch.where(dot.abs() > 1.0, torch.zeros_like(d), torch.nan_to_num(d))


def backbone_frames(X: torch.Tensor):
    """(R [.., 3, 3] with the basis in its columns, t [.., 3]): x along
    CA->C, y the part of CA->N orthogonal to it, origin CA."""
    N, CA, C = X[..., 0, :], X[..., 1, :], X[..., 2, :]
    e0 = C - CA
    e0 = e0 / torch.sqrt((e0 * e0).sum(-1, keepdim=True) + 1e-8)
    e1 = N - CA
    e1 = e1 - e0 * (e0 * e1).sum(-1, keepdim=True)
    e1 = e1 / torch.sqrt((e1 * e1).sum(-1, keepdim=True) + 1e-8)
    return torch.stack([e0, e1, torch.linalg.cross(e0, e1, dim=-1)], -1), CA


def encode_edges(p: Params, prefix: str, b: dict, mask: torch.Tensor, top_k: int = 32):
    """(h_E [B, L, K, He], idx [B, L, K]) over the graph of ``mask``."""
    X = b["X"]
    N, CA, C, O = X[:, :, 0], X[:, :, 1], X[:, :, 2], X[:, :, 3]
    idx = knn(CA, mask, top_k)
    off = b["ridx"][:, :, None] - gather(b["ridx"], idx)
    relpos = F.one_hot(torch.clamp(off + 32, 0, 64), 65).float()
    cb = -0.58273431 * torch.linalg.cross(CA - N, C - CA, dim=-1) \
        + 0.56802827 * (CA - N) - 0.54067466 * (C - CA) + CA
    atoms = torch.stack([N, CA, C, O, cb], -2)
    nbr = gather(atoms, idx)
    d = torch.sqrt(((atoms[:, :, None, :, None] - nbr[:, :, :, None]) ** 2).sum(-1) + 1e-6)
    mu = torch.linspace(0.0, 20.0, 16, device=X.device)
    rbf = torch.exp(-(((d[..., None] - mu) / 1.25) ** 2)).reshape(*idx.shape, 400)
    same = (b["chain"][:, :, None] == gather(b["chain"], idx)).float()[..., None] + 1.0
    Nj, CAj, Cj = gather(N, idx), gather(CA, idx), gather(C, idx)
    phi = dihedral(C[:, :, None], Nj, CAj, Cj)
    psi = dihedral(N[:, :, None], CA[:, :, None], C[:, :, None], Nj)
    h = torch.cat([relpos, rbf, same, torch.stack([phi, psi], -1)], -1)
    return p.ln(f"{prefix}.norm_edges", p.lin(f"{prefix}.edge_embedding", h)), idx


def time_embedding(t: torch.Tensor, dim: int = 16) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) / (half - 1)
                      * torch.arange(half, dtype=torch.float32, device=t.device))
    ang = (t * 10000.0)[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def encode_nodes(p: Params, prefix: str, b: dict, sc_sincos: torch.Tensor, t=None):
    parts = [F.one_hot(b["aatype"], 21).float(), b["bb_sincos"].flatten(-2),
             sc_sincos.flatten(-2)]
    if t is not None:
        parts.append(time_embedding(t))
    return p.ln(f"{prefix}.norm_nodes", p.lin(f"{prefix}.node_embedding", torch.cat(parts, -1)))


def edge_geometry(p_local, idx, R, t):
    """[B, L, K, 9P] invariant point features of every edge."""
    B, L, P = p_local.shape[:3]
    K = idx.shape[-1]
    pg = torch.einsum("blrc,blpc->blpr", R, p_local) + t[:, :, None]      # [B, L, P, 3]
    pg_j = gather(pg, idx)                                                  # [B, L, K, P, 3]
    nl = torch.einsum("blrc,blkpr->blkpc", R, pg_j - t[:, :, None, None])   # R^T (pg_j - t_i)
    eps = 1e-8
    return torch.cat([
        p_local.reshape(B, L, 1, 3 * P).expand(B, L, K, 3 * P),
        torch.sqrt((p_local ** 2).sum(-1) + eps)[:, :, None].expand(B, L, K, P),
        nl.reshape(B, L, K, 3 * P),
        torch.sqrt((nl ** 2).sum(-1) + eps),
        torch.sqrt(((pg[:, :, None] - pg_j) ** 2).sum(-1) + eps)], -1)


def ipmp_layer(p: Params, pre: str, h_V, h_E, idx, frames, mask_V, mask_E, edge: bool,
               n_points: int = 8):
    R, t = frames
    B, L, H = h_V.shape

    def message(fn, points_fn, h):
        pl = p.lin(f"{pre}.{points_fn}", h).reshape(B, L, n_points, 3)
        hj = gather(h, idx)
        x = torch.cat([h[:, :, None].expand_as(hj), h_E, hj, edge_geometry(pl, idx, R, t)], -1)
        return p.mlp(f"{pre}.{fn}", x, 1)

    m = (message("node_message_fn", "points_fn_node", h_V) * mask_E[..., None]).mean(-2)
    h_V = p.ln(f"{pre}.norm.0", h_V + m)
    h_V = p.ln(f"{pre}.norm.1", h_V + p.mlp(f"{pre}.node_dense", h_V)) * mask_V[..., None]
    if edge:
        m = message("edge_message_fn", "points_fn_edge", h_V) * mask_E[..., None]
        h_E = p.ln(f"{pre}.norm.2", h_E + m)
        h_E = p.ln(f"{pre}.norm.3", h_E + p.mlp(f"{pre}.edge_dense", h_E)) * mask_E[..., None]
    return h_V, h_E


def stack(p: Params, prefix: str, h_V, h_E, idx, X, mask_V, mask_E, n_layers: int = 3):
    """The IPMP stack; the last layer's edge pass feeds nothing and is not
    run. Returns h_V."""
    frames = backbone_frames(X)
    for i in range(n_layers):
        h_V, h_E = ipmp_layer(p, f"{prefix}.mpnn_layers.{i}", h_V, h_E, idx, frames, mask_V,
                              mask_E, i < n_layers - 1)
    return h_V


def static_graph(p: Params, b: dict):
    """What the score network reads of the backbone alone: (h_E, idx, edge
    mask)."""
    h_E, idx = encode_edges(p, "encoder", b, b["rmask"])
    return h_E, idx, b["rmask"][:, :, None] * gather(b["rmask"], idx)


def score(p: Params, b: dict, sc: torch.Tensor, t: torch.Tensor, graph=None):
    """(chi scores [B, L, 4], h_V [B, L, H]) at chis ``sc`` and time ``t``
    [B, L]."""
    h_E, idx, mask_E = graph if graph is not None else static_graph(p, b)
    sincos = torch.stack([torch.sin(sc), torch.cos(sc)], -1) * b["sc_mask"][..., None]
    h_V = encode_nodes(p, "encoder", b, sincos, t)
    h_V = stack(p, "mpnn", h_V, h_E, idx, b["X"], b["rmask"], mask_E)
    s = p.mlp("decoder_score.2", F.relu(p.mlp("decoder_score.0", h_V)))
    return s, h_V
