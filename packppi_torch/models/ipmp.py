"""Invariant point message passing (IPMP), inference path.

Each node predicts ``n_points`` 3D points in its backbone frame; messages
mix neighbour hidden states with frame-invariant point geometry (local
points, the neighbour's points in the node's frame, point-pair distances).
Every layer runs a node pass (message pooled over the K neighbours, then
the residual chain) and an edge pass (per-edge messages, then the residual
chain). The message and chain steps are ``ops.message`` and ``ops.chain``:
CUDA kernels on the card, their plain versions on the CPU.

Parameter names follow the reference checkpoints (``points_fn_node``,
``node_message_fn.W_in`` over ``[h_i | h_E | h_j | geometry]``, ``norm.N``,
``node_dense``, ...).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from packppi_torch.geometry.rigid import bb_frames_from_atom14, scale_translation
from packppi_torch.models.layers import MLP, LayerNorm
from packppi_torch.ops.chain import chain
from packppi_torch.ops.graph import gather_nodes
from packppi_torch.ops.message import (geometry_edge_features,  # noqa: F401
                                       geometry_global_points, message)
from packppi_torch.ops.precision import matmul_f32acc


class FactoredMessageMLP(nn.Module):
    """The reference's message MLP (``W_in`` over ``[h_i | h_E | h_j |
    geometry]``, ``W_inter.0``, ``W_out``), evaluated factored by input
    origin: the h_i and h_j blocks of ``W_in`` run once per node and the
    rest per edge, inside the message kernel."""

    def __init__(self, hidden_dim: int = 128, edge_dim: int = 128, geom_dim: int = 72):
        super().__init__()
        self.hidden_dim, self.edge_dim = hidden_dim, edge_dim
        self.W_in = nn.Linear(2 * hidden_dim + edge_dim + geom_dim, hidden_dim)
        self.W_inter = nn.ModuleList([nn.Linear(hidden_dim, hidden_dim)])
        self.W_out = nn.Linear(hidden_dim, hidden_dim)

    def operands(self, h_V, h_E, idx, p_local, frames, mask_attend):
        """The arguments of ``ops.message.message`` (before ``pool``): h_V
        [B, L, H] and h_E [B, L, K, He] in the stream dtype (also the
        compute dtype); p_local [B, L, P, 3] float32."""
        H, He = self.hidden_dim, self.edge_dim
        cd = h_E.dtype
        w = self.W_in.weight
        per_i = matmul_f32acc(h_V, w[:, :H].t(), cd)
        per_j = matmul_f32acc(h_V, w[:, H + He:2 * H + He].t(), cd).to(cd)
        rot, trans = frames.rot.contiguous(), frames.trans.contiguous()
        pg = geometry_global_points(p_local, rot, trans)
        return (per_i, per_j, h_E, idx, p_local.contiguous(), rot, trans, pg, mask_attend,
                w, self.W_in.bias, self.W_inter[0].weight, self.W_inter[0].bias,
                self.W_out.weight, self.W_out.bias)

    def forward(self, h_V, h_E, idx, p_local, frames, mask_attend, pool: bool):
        """[B, L, H] float32 (pool) or [B, L, K, H] in the stream dtype."""
        return message(*self.operands(h_V, h_E, idx, p_local, frames, mask_attend), pool)


def chain_operands(x, msg, mask, norm_a: LayerNorm, ffn: MLP, norm_b: LayerNorm):
    """The arguments of ``ops.chain.chain`` (before ``pre_mask``) over the
    flattened rows of a [..., H] stream."""
    H = x.shape[-1]
    return (x.reshape(-1, H), msg.reshape(-1, H),
            None if mask is None else mask.reshape(-1).float(),
            norm_a.weight, norm_a.bias, ffn.W_in.weight, ffn.W_in.bias,
            ffn.W_out.weight, ffn.W_out.bias, norm_b.weight, norm_b.bias)


def _residual_chain(x, msg, mask, norm_a, ffn, norm_b, pre_mask: bool):
    return chain(*chain_operands(x, msg, mask, norm_a, ffn, norm_b), pre_mask).reshape(x.shape)


class InvariantPointLayer(nn.Module):
    def __init__(self, hidden_dim: int = 128, n_points: int = 8, edge_dim: int = 128,
                 position_scale: float = 1.0):
        super().__init__()
        self.n_points = n_points
        self.position_scale = position_scale
        geom = 9 * n_points
        self.points_fn_node = nn.Linear(hidden_dim, 3 * n_points)
        self.points_fn_edge = nn.Linear(hidden_dim, 3 * n_points)
        self.node_message_fn = FactoredMessageMLP(hidden_dim, edge_dim, geom)
        self.edge_message_fn = FactoredMessageMLP(hidden_dim, edge_dim, geom)
        self.norm = nn.ModuleList(LayerNorm(hidden_dim) for _ in range(4))
        self.node_dense = MLP(hidden_dim, 4 * hidden_dim, hidden_dim, 2)
        self.edge_dense = MLP(hidden_dim, 4 * hidden_dim, hidden_dim, 2)

    def _points(self, lin: nn.Linear, h_V):
        # the point projection runs in float32 whatever the stream dtype
        B, L = h_V.shape[:2]
        return torch.nn.functional.linear(h_V.float(), lin.weight, lin.bias).reshape(
            B, L, self.n_points, 3)

    def forward(self, h_V, h_E, idx, X, mask_V, mask_attend, do_edge_update: bool = True):
        frames = scale_translation(bb_frames_from_atom14(X), 1.0 / self.position_scale)

        msg = self.node_message_fn(h_V, h_E, idx, self._points(self.points_fn_node, h_V),
                                   frames, mask_attend, pool=True)
        h_V = _residual_chain(h_V, msg, mask_V, self.norm[0], self.node_dense,
                              self.norm[1], pre_mask=False)
        if do_edge_update:
            e_msg = self.edge_message_fn(h_V, h_E, idx,
                                         self._points(self.points_fn_edge, h_V),
                                         frames, mask_attend, pool=False)
            h_E = _residual_chain(h_E, e_msg, mask_attend, self.norm[2],
                                  self.edge_dense, self.norm[3], pre_mask=True)
        return h_V, h_E


class MessagePassingStack(nn.Module):
    def __init__(self, hidden_dim: int = 128, num_layers: int = 3, n_points: int = 8,
                 edge_dim: int = 128, position_scale: float = 1.0):
        super().__init__()
        self.mpnn_layers = nn.ModuleList(
            InvariantPointLayer(hidden_dim, n_points, edge_dim, position_scale)
            for _ in range(num_layers))

    @staticmethod
    def attend_mask(mask: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """[B, L, K] edge validity mask_i * mask_j (static during sampling)."""
        return mask[..., None] * gather_nodes(mask, idx)

    def forward(self, h_V, h_E, idx, X, mask, skip_last_edge_update: bool = False,
                mask_attend: Optional[torch.Tensor] = None):
        """Returns h_V. With ``skip_last_edge_update`` the last layer's edge
        pass, whose output feeds nothing, is not run."""
        if mask_attend is None:
            mask_attend = self.attend_mask(mask, idx)
        n = len(self.mpnn_layers)
        for i, layer in enumerate(self.mpnn_layers):
            last = i == n - 1
            h_V, h_E = layer(h_V, h_E, idx, X, mask, mask_attend,
                             do_edge_update=not (last and skip_last_edge_update))
        return h_V
