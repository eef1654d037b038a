"""Invariant point message passing (IPMP), inference and training.

Each node predicts ``n_points`` 3D points in its backbone frame; messages
mix neighbour hidden states with frame-invariant point geometry (local
points, the neighbour's points in the node's frame, point-pair distances).
Every layer runs a node pass (message pooled over the K neighbours, then
the residual chain) and an edge pass (per-edge messages, then the residual
chain).

Which code runs a pass is chosen by the configuration and the module's
mode, never by a failure:

* message pass, ``eval()``: ``fused_messages="geom_lanes"`` -> ``ops.message``
  (geometry inside the kernel); ``fused_messages=True`` ->
  ``ops.message_feat`` over geometry features computed here.
* message pass, ``train()``: ``fused_messages is True and
  fused_messages_train`` -> ``ops.message_feat`` (differentiable); otherwise
  the unfused path, plain differentiable tensor operations.
* chain, ``eval()``: ``ops.chain``. ``train()``: ``fused_chain_train and
  dropout == 0`` -> ``ops.chain`` (differentiable); otherwise the unfused
  chain with dropout on the message and on the FFN output.

``ops.message``, ``ops.message_feat`` and ``ops.chain`` are CUDA kernels on
the card and their plain versions on CPU tensors.

Parameter names follow the reference checkpoints (``points_fn_node``,
``node_message_fn.W_in`` over ``[h_i | h_E | h_j | geometry]``, ``norm.N``,
``node_dense``, ...).
"""
from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from packppi_torch.geometry.rigid import bb_frames_from_atom14, scale_translation
from packppi_torch.models.layers import MLP, LayerNorm
from packppi_torch.ops.chain import chain
from packppi_torch.ops.graph import gather_nodes
from packppi_torch.ops.message import (geometry_edge_features,  # noqa: F401
                                       geometry_global_points, message)
from packppi_torch.ops.message_feat import message_feat
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

    def feat_operands(self, h_V, h_E, idx, p_local, frames, mask_attend):
        """The arguments of ``ops.message_feat.message_feat`` (before
        ``pool``): the neighbour term gathered in the stream dtype and the
        geometry features computed here, both differentiable."""
        (per_i, per_j, h_E, idx, p_local, rot, trans, pg, mask_attend,
         *weights) = self.operands(h_V, h_E, idx, p_local, frames, mask_attend)
        geom = geometry_edge_features(p_local, gather_nodes(pg, idx), rot, trans)
        return (per_i, gather_nodes(per_j, idx), h_E, geom.to(h_E.dtype), mask_attend, *weights)

    def unfused(self, h_V, h_E, idx, p_local, frames, mask_attend, pool: bool):
        """The message pass as plain tensor operations, float32 out: the
        [h_E | geometry] block as one product, the neighbour term gathered
        in float32."""
        H, He = self.hidden_dim, self.edge_dim
        cd = h_E.dtype
        w = self.W_in.weight
        rot, trans = frames.rot, frames.trans
        geom = geometry_edge_features(
            p_local, gather_nodes(geometry_global_points(p_local, rot, trans), idx), rot, trans)
        per_i = matmul_f32acc(h_V, w[:, :H].t(), cd)
        per_j = matmul_f32acc(h_V, w[:, H + He:2 * H + He].t(), cd)
        w_e = torch.cat([w[:, H:H + He], w[:, 2 * H + He:]], 1)
        per_e = matmul_f32acc(torch.cat([h_E, geom.to(cd)], -1), w_e.t(), cd) + self.W_in.bias
        x = F.relu(per_i[:, :, None] + gather_nodes(per_j, idx) + per_e)
        x = F.relu(matmul_f32acc(x, self.W_inter[0].weight.t(), cd) + self.W_inter[0].bias)
        x = matmul_f32acc(x, self.W_out.weight.t(), cd) + self.W_out.bias
        if pool:
            x = (x * mask_attend[..., None]).mean(-2)
        return x

    def forward(self, h_V, h_E, idx, p_local, frames, mask_attend, pool: bool,
                fused: Union[bool, str] = "geom_lanes"):
        """[B, L, H] float32 (pool) or [B, L, K, H] (stream dtype from a
        kernel pass, float32 from the unfused one). ``fused``: "geom_lanes"
        (geometry in the kernel), True (kernel over features computed here),
        False (no kernel)."""
        args = (h_V, h_E, idx, p_local, frames, mask_attend)
        if fused == "geom_lanes":
            return message(*self.operands(*args), pool)
        if fused is True:
            return message_feat(*self.feat_operands(*args), pool)
        return self.unfused(*args, pool)


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
                 position_scale: float = 1.0, dropout: float = 0.1,
                 fused_messages: Union[bool, str] = "geom_lanes",
                 fused_messages_train: bool = False, fused_chain_train: bool = False):
        super().__init__()
        self.n_points = n_points
        self.position_scale = position_scale
        self.fused_messages = fused_messages
        self.fused_messages_train = fused_messages_train
        self.fused_chain_train = fused_chain_train
        self.dropout = dropout
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

    def _unfused_chain(self, x, msg, mask, norm_a, ffn, norm_b, pre_mask: bool):
        """The chain as plain tensor operations, with dropout on the message
        and on the FFN output (training with the chain knob off)."""
        sd = x.dtype
        drop = lambda v: F.dropout(v, self.dropout, training=True)
        if pre_mask:
            msg = msg * mask[..., None].to(msg.dtype)
        x = norm_a(x + drop(msg.to(sd)), sd)
        x = norm_b(x + drop(ffn(x, sd).to(sd)), sd)
        return x * mask[..., None].to(sd)

    def forward(self, h_V, h_E, idx, X, mask_V, mask_attend, do_edge_update: bool = True,
                training: Optional[bool] = None):
        """``training`` overrides the module's mode: a checkpointed layer is
        run again in the backward, when the module may have left train()."""
        frames = scale_translation(bb_frames_from_atom14(X), 1.0 / self.position_scale)
        if self.training if training is None else training:
            fused = self.fused_messages is True and self.fused_messages_train
            chain_fn = (_residual_chain if self.fused_chain_train and self.dropout == 0.0
                        else self._unfused_chain)
        else:
            fused, chain_fn = self.fused_messages, _residual_chain

        msg = self.node_message_fn(h_V, h_E, idx, self._points(self.points_fn_node, h_V),
                                   frames, mask_attend, pool=True, fused=fused)
        h_V = chain_fn(h_V, msg, mask_V, self.norm[0], self.node_dense, self.norm[1],
                       pre_mask=False)
        if do_edge_update:
            e_msg = self.edge_message_fn(h_V, h_E, idx,
                                         self._points(self.points_fn_edge, h_V),
                                         frames, mask_attend, pool=False, fused=fused)
            h_E = chain_fn(h_E, e_msg, mask_attend, self.norm[2], self.edge_dense,
                           self.norm[3], pre_mask=True)
        return h_V, h_E


class MessagePassingStack(nn.Module):
    def __init__(self, hidden_dim: int = 128, num_layers: int = 3, n_points: int = 8,
                 edge_dim: int = 128, position_scale: float = 1.0, remat: bool = False,
                 **layer_kw):
        super().__init__()
        self.remat = remat   # training: recompute each layer in the backward
        self.mpnn_layers = nn.ModuleList(
            InvariantPointLayer(hidden_dim, n_points, edge_dim, position_scale, **layer_kw)
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
            do_edge = not (last and skip_last_edge_update)
            if self.remat and self.training and torch.is_grad_enabled():
                h_V, h_E = checkpoint(layer, h_V, h_E, idx, X, mask, mask_attend, do_edge, True,
                                      use_reentrant=False)
            else:
                h_V, h_E = layer(h_V, h_E, idx, X, mask, mask_attend, do_edge_update=do_edge)
        return h_V
