"""Invariant point message passing (IPMP), inference and training.

Each node predicts ``n_points`` 3D points in its backbone frame; messages
mix neighbour hidden states with frame-invariant point geometry (local
points, the neighbour's points in the node's frame, point-pair distances).
Every layer runs a node pass (message pooled over the K neighbours, then
the residual chain) and an edge pass (per-edge messages, then the residual
chain).

Which code runs a pass is chosen by the configuration and the module's
mode, never by a failure:

* ``eval()`` with ``fused_layers``: the whole layer in two passes,
  ``ops.layer.layer_node`` then ``ops.layer.layer_edge``, over geometry
  features computed here. It supersedes ``fused_messages`` in ``eval()``
  only.
* message pass, ``eval()``: ``fused_messages="geom_lanes"`` -> ``ops.message``
  (geometry inside the kernel, neighbour rows loaded by index);
  ``"geom_gather"`` -> ``ops.message_gather`` (the same, through the kernel
  that replaces the in-kernel-gather TPU kernel); ``"geom"`` ->
  ``ops.message_geom`` (neighbour streams gathered here);
  ``fused_messages=True`` -> ``ops.message_feat`` over geometry features
  computed here. With ``FOLD_EDGE_CHAIN`` set and ``"geom_lanes"``, the
  edge pass and its chain are one kernel, ``ops.message_chain``.
  ``fused_messages=False`` -> the unfused path, plain tensor operations at
  the JAX unfused path's rounding points.
* message pass, ``train()``: ``fused_messages is True and
  fused_messages_train`` -> ``ops.message_feat`` (differentiable); otherwise
  the unfused path, plain differentiable tensor operations.
* chain, ``eval()``: ``fused_chain`` -> ``ops.chain``; otherwise the unfused
  chain without dropout. ``train()``: ``fused_chain_train and dropout == 0``
  -> ``ops.chain`` (differentiable); otherwise the unfused chain with
  dropout on the message and on the FFN output.
* ``geometry_mode="local"`` (``rel`` given): the geometry features come from
  the neighbours' local points and the static relative transforms
  (``relative_frame_transforms``), and the message runs through
  ``ops.message_feat`` (``fused_messages=True``) or the unfused path; the
  global-point kernels are refused by ``NetworkConfig``.

The ``ops`` passes are CUDA kernels on the card and their plain versions on
CPU tensors. ``fused_messages=False, fused_chain=False`` (``cli.pack
--no_fused``) is the route that launches no kernel in ``eval()``. Every
message MLP and chain FFN applies the configuration's activation ``act``
(``ops.activations.ACTS``): the kernels take it as their library's
activation, the unfused path at the JAX unfused path's points.

``use_ipmp=False`` swaps each layer for ``VanillaMPNNLayer``: sum-pooled
message passing without geometry, plain tensor operations in float32 in
every mode and routing (as in the JAX package, it launches no kernel).

Parameter names follow the reference checkpoints (``points_fn_node``,
``node_message_fn.W_in`` over ``[h_i | h_E | h_j | geometry]``, ``norm.N``,
``node_dense``, ...).
"""
from __future__ import annotations

import functools
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from packppi_torch.geometry.rigid import bb_frames_from_atom14, scale_translation
from packppi_torch.models.layers import MLP, LayerNorm
from packppi_torch.ops.activations import activation
from packppi_torch.ops.chain import chain
from packppi_torch.ops.graph import gather_nodes
from packppi_torch.ops.layer import layer_edge, layer_node
from packppi_torch.ops.message import (geometry_edge_features, geometry_global_points,
                                       message, message_chain, message_gather, message_geom)
from packppi_torch.ops.message_feat import message_feat
from packppi_torch.ops.precision import matmul_f32acc

# With fused_messages="geom_lanes", fold each edge pass's chain into its
# message kernel (ops.message_chain) in eval(). Read at forward time, as the
# JAX package reads its ipmp.FOLD_EDGE_CHAIN at trace time; off by default
# there too. Not a NetworkConfig field, as it is none in the JAX package.
FOLD_EDGE_CHAIN = False


def relative_frame_transforms(frames, idx):
    """Static per-edge relative transforms of the backbone frames:
    ``R_rel = R_i^T R_j`` [B, L, K, 9] (row-major) and ``t_rel = R_i^T (t_j -
    t_i)`` [B, L, K, 3]. The backbone does not move while sampling, so
    ``encode_static`` caches them once per structure in local mode."""
    B, L = idx.shape[:2]
    R, t = frames.rot, frames.trans
    Rj = gather_nodes(R.reshape(B, L, 9), idx).reshape(*idx.shape, 3, 3)
    tj = gather_nodes(t, idx)
    # (R_i^T R_j)[a, d] = sum_c R_i[c, a] R_j[c, d]
    rel_rot = torch.einsum("xlca,xlkcd->xlkad", R, Rj)
    rel_t = torch.einsum("xlca,xlkc->xlka", R, tj - t[:, :, None])
    return rel_rot.reshape(*idx.shape, 9), rel_t


def geometry_edge_features_local(p_local, nbr_pl, rel):
    """The 9P features of ``geometry_edge_features``, in node i's local
    frame, from the gathered neighbour local-point planes ``nbr_pl`` [B, L,
    K, 3P] (any float dtype) and ``rel`` (``relative_frame_transforms``):
    ``nl = R_rel p_j + t_rel`` and ``|pg_i - pg_j| = |p_i - nl|``. Feature
    math in float32."""
    B, L, P = p_local.shape[:3]
    K = nbr_pl.shape[2]
    f32 = torch.float32
    plx, ply, plz = (p_local[..., c].to(f32) for c in range(3))
    pjx = nbr_pl[..., :P].to(f32)
    pjy = nbr_pl[..., P:2 * P].to(f32)
    pjz = nbr_pl[..., 2 * P:].to(f32)
    rot9, t3 = rel
    r = lambda a: rot9[..., a, None].to(f32)
    nlx = r(0) * pjx + r(1) * pjy + r(2) * pjz + t3[..., 0, None].to(f32)
    nly = r(3) * pjx + r(4) * pjy + r(5) * pjz + t3[..., 1, None].to(f32)
    nlz = r(6) * pjx + r(7) * pjy + r(8) * pjz + t3[..., 2, None].to(f32)

    eps = 1e-8
    norm_pl = torch.sqrt(plx * plx + ply * ply + plz * plz + eps)
    norm_nl = torch.sqrt(nlx * nlx + nly * nly + nlz * nlz + eps)
    dx = plx[:, :, None] - nlx
    dy = ply[:, :, None] - nly
    dz = plz[:, :, None] - nlz
    norm_pair = torch.sqrt(dx * dx + dy * dy + dz * dz + eps)

    flat_pl = p_local.to(f32).reshape(B, L, 1, P * 3).expand(B, L, K, P * 3)
    flat_nl = torch.stack([nlx, nly, nlz], -1).reshape(B, L, K, P * 3)
    return torch.cat([flat_pl, norm_pl[:, :, None].expand(B, L, K, P),
                      flat_nl, norm_nl, norm_pair], -1)


def geometry_features_local(p_local, idx, rel, stream_dtype=None):
    """Gather-then-features in the local frame: the gathered operand is the
    plane-stacked local points, in ``stream_dtype`` when given (O(1-10 A):
    bf16 is safe there, where global coordinates are not)."""
    pl_planes = torch.cat([p_local[..., 0], p_local[..., 1], p_local[..., 2]], -1)
    if stream_dtype is not None:
        pl_planes = pl_planes.to(stream_dtype)
    return geometry_edge_features_local(p_local, gather_nodes(pl_planes, idx), rel)


class FactoredMessageMLP(nn.Module):
    """The reference's message MLP (``W_in`` over ``[h_i | h_E | h_j |
    geometry]``, ``W_inter.0``, ``W_out``), evaluated factored by input
    origin: the h_i and h_j blocks of ``W_in`` run once per node and the
    rest per edge, inside the message kernel."""

    def __init__(self, hidden_dim: int = 128, edge_dim: int = 128, geom_dim: int = 72,
                 act: str = "relu"):
        super().__init__()
        self.hidden_dim, self.edge_dim, self.act = hidden_dim, edge_dim, act
        self.W_in = nn.Linear(2 * hidden_dim + edge_dim + geom_dim, hidden_dim)
        self.W_inter = nn.ModuleList([nn.Linear(hidden_dim, hidden_dim)])
        self.W_out = nn.Linear(hidden_dim, hidden_dim)

    def _node_terms(self, h_V, cd):
        """(per_i, per_j) [B, L, H] float32: the h_i and h_j column blocks of
        ``W_in`` applied once per node, operands rounded to ``cd``."""
        H, He = self.hidden_dim, self.edge_dim
        w = self.W_in.weight
        return (matmul_f32acc(h_V, w[:, :H].t(), cd),
                matmul_f32acc(h_V, w[:, H + He:2 * H + He].t(), cd))

    def _weights(self):
        return (self.W_in.weight, self.W_in.bias, self.W_inter[0].weight, self.W_inter[0].bias,
                self.W_out.weight, self.W_out.bias)

    def operands(self, h_V, h_E, idx, p_local, frames, mask_attend):
        """The arguments of ``ops.message.message`` (before ``pool``): h_V
        [B, L, H] and h_E [B, L, K, He] in the stream dtype (also the
        compute dtype); p_local [B, L, P, 3] float32."""
        cd = h_E.dtype
        per_i, per_j = self._node_terms(h_V, cd)
        rot, trans = frames.rot.contiguous(), frames.trans.contiguous()
        pg = geometry_global_points(p_local, rot, trans)
        return (per_i, per_j.to(cd), h_E, idx, p_local.contiguous(), rot, trans, pg, mask_attend,
                *self._weights())

    def geom_operands(self, h_V, h_E, idx, p_local, frames, mask_attend):
        """The arguments of ``ops.message.message_geom`` (before ``pool``):
        the neighbour term gathered in the stream dtype, the neighbour
        global-point planes gathered in float32 (global coordinates),
        node i's local planes, rotation rows and translation."""
        (per_i, per_j, h_E, idx, p_local, rot, trans, pg, mask_attend,
         *weights) = self.operands(h_V, h_E, idx, p_local, frames, mask_attend)
        B, L = idx.shape[:2]
        pl = torch.cat([p_local[..., 0], p_local[..., 1], p_local[..., 2]], -1)
        return (per_i, gather_nodes(per_j, idx), h_E, pl, gather_nodes(pg, idx),
                rot.reshape(B, L, 9), trans, mask_attend, *weights)

    def _geometry(self, p_local, idx, frames, rel, stream_dtype):
        """[B, L, K, 9P] features: from global points, or from local points
        and the static relative transforms ``rel`` (local mode)."""
        if rel is not None:
            return geometry_features_local(p_local, idx, rel, stream_dtype)
        return geometry_edge_features(p_local, gather_nodes(
            geometry_global_points(p_local, frames.rot, frames.trans), idx), frames.rot,
            frames.trans)

    def feat_operands(self, h_V, h_E, idx, p_local, frames, mask_attend, rel=None):
        """The arguments of ``ops.message_feat.message_feat`` and of the
        whole-layer passes (before ``pool``): the neighbour term gathered in
        the stream dtype and the geometry features computed here, both
        differentiable."""
        cd = h_E.dtype
        per_i, per_j = self._node_terms(h_V, cd)
        geom = self._geometry(p_local, idx, frames, rel, cd)
        return (per_i, gather_nodes(per_j.to(cd), idx), h_E, geom.to(cd), mask_attend,
                *self._weights())

    def unfused(self, h_V, h_E, idx, p_local, frames, mask_attend, pool: bool, rel=None):
        """The message pass as plain tensor operations, float32 out: the
        [h_E | geometry] block as one product, the neighbour term gathered
        in float32."""
        H, He = self.hidden_dim, self.edge_dim
        cd = h_E.dtype
        w = self.W_in.weight
        geom = self._geometry(p_local, idx, frames, rel, cd)
        per_i, per_j = self._node_terms(h_V, cd)
        w_e = torch.cat([w[:, H:H + He], w[:, 2 * H + He:]], 1)
        per_e = matmul_f32acc(torch.cat([h_E, geom.to(cd)], -1), w_e.t(), cd) + self.W_in.bias
        act = activation(self.act)
        x = act(per_i[:, :, None] + gather_nodes(per_j, idx) + per_e)
        x = act(matmul_f32acc(x, self.W_inter[0].weight.t(), cd) + self.W_inter[0].bias)
        x = matmul_f32acc(x, self.W_out.weight.t(), cd) + self.W_out.bias
        if pool:
            x = (x * mask_attend[..., None]).mean(-2)
        return x

    def forward(self, h_V, h_E, idx, p_local, frames, mask_attend, pool: bool,
                fused: Union[bool, str] = "geom_lanes", rel=None):
        """[B, L, H] float32 (pool) or [B, L, K, H] (stream dtype from a
        kernel pass, float32 from the unfused one). ``fused``: "geom_lanes",
        "geom_gather" or "geom" (geometry in the kernel), True (kernel over
        features computed here), False (no kernel). ``rel``: local mode."""
        args = (h_V, h_E, idx, p_local, frames, mask_attend)
        if fused == "geom_lanes":
            return message(*self.operands(*args), pool, self.act)
        if fused == "geom_gather":
            return message_gather(*self.operands(*args), pool, self.act)
        if fused == "geom":
            return message_geom(*self.geom_operands(*args), pool, self.act)
        if fused is True:
            return message_feat(*self.feat_operands(*args, rel), pool, self.act)
        return self.unfused(*args, pool, rel)


def chain_weights(norm_a: LayerNorm, ffn: MLP, norm_b: LayerNorm):
    """The chain's eight weights, in the order every chain kernel takes them."""
    return (norm_a.weight, norm_a.bias, ffn.W_in.weight, ffn.W_in.bias,
            ffn.W_out.weight, ffn.W_out.bias, norm_b.weight, norm_b.bias)


def chain_operands(x, msg, mask, norm_a: LayerNorm, ffn: MLP, norm_b: LayerNorm):
    """The arguments of ``ops.chain.chain`` (before ``pre_mask``) over the
    flattened rows of a [..., H] stream."""
    H = x.shape[-1]
    return (x.reshape(-1, H), msg.reshape(-1, H),
            None if mask is None else mask.reshape(-1).float(),
            *chain_weights(norm_a, ffn, norm_b))


def _residual_chain(x, msg, mask, norm_a, ffn, norm_b, pre_mask: bool):
    return chain(*chain_operands(x, msg, mask, norm_a, ffn, norm_b), pre_mask,
                 ffn.act).reshape(x.shape)


class InvariantPointLayer(nn.Module):
    def __init__(self, hidden_dim: int = 128, n_points: int = 8, edge_dim: int = 128,
                 position_scale: float = 1.0, dropout: float = 0.1,
                 fused_messages: Union[bool, str] = "geom_lanes",
                 fused_messages_train: bool = False, fused_chain: bool = True,
                 fused_chain_train: bool = False, fused_layers: bool = False,
                 act: str = "relu"):
        super().__init__()
        self.act = act
        self.n_points = n_points
        self.position_scale = position_scale
        self.fused_messages = fused_messages
        self.fused_layers = fused_layers
        self.fused_messages_train = fused_messages_train
        self.fused_chain = fused_chain
        self.fused_chain_train = fused_chain_train
        self.dropout = dropout
        geom = 9 * n_points
        self.points_fn_node = nn.Linear(hidden_dim, 3 * n_points)
        self.points_fn_edge = nn.Linear(hidden_dim, 3 * n_points)
        self.node_message_fn = FactoredMessageMLP(hidden_dim, edge_dim, geom, act)
        self.edge_message_fn = FactoredMessageMLP(hidden_dim, edge_dim, geom, act)
        self.norm = nn.ModuleList(LayerNorm(hidden_dim) for _ in range(4))
        self.node_dense = MLP(hidden_dim, 4 * hidden_dim, hidden_dim, 2, act)
        self.edge_dense = MLP(hidden_dim, 4 * hidden_dim, hidden_dim, 2, act)

    def _points(self, lin: nn.Linear, h_V):
        # the point projection runs in float32 whatever the stream dtype
        B, L = h_V.shape[:2]
        return torch.nn.functional.linear(h_V.float(), lin.weight, lin.bias).reshape(
            B, L, self.n_points, 3)

    def _unfused_chain(self, x, msg, mask, norm_a, ffn, norm_b, pre_mask: bool,
                       train: bool = True):
        """The chain as plain tensor operations, with dropout on the message
        and on the FFN output in training (the chain knob off), without it in
        ``eval()`` (``fused_chain=False``)."""
        sd = x.dtype
        drop = lambda v: F.dropout(v, self.dropout, training=train)
        if pre_mask:
            msg = msg * mask[..., None].to(msg.dtype)
        x = norm_a(x + drop(msg.to(sd)), sd)
        x = norm_b(x + drop(ffn(x, sd).to(sd)), sd)
        return x * mask[..., None].to(sd)

    def _fused_layer(self, h_V, h_E, idx, frames, mask_V, mask_attend, do_edge_update: bool):
        """``eval()`` with ``fused_layers``: the node pass, then the edge pass
        on the updated nodes, each one kernel (``ops.layer``)."""
        ops = self.node_message_fn.feat_operands(
            h_V, h_E, idx, self._points(self.points_fn_node, h_V), frames, mask_attend)
        per_i, pjg, _, geom, _, *msg_w = ops
        h_V = layer_node(h_V, per_i, pjg, h_E, geom, mask_attend, mask_V.float(), *msg_w,
                         *chain_weights(self.norm[0], self.node_dense, self.norm[1]),
                         act=self.act)
        if do_edge_update:
            ops = self.edge_message_fn.feat_operands(
                h_V, h_E, idx, self._points(self.points_fn_edge, h_V), frames, mask_attend)
            per_i, pjg, _, geom, _, *msg_w = ops
            h_E = layer_edge(h_E, per_i, pjg, geom, mask_attend, *msg_w,
                             *chain_weights(self.norm[2], self.edge_dense, self.norm[3]),
                             act=self.act)
        return h_V, h_E

    def forward(self, h_V, h_E, idx, X, mask_V, mask_attend, do_edge_update: bool = True,
                training: Optional[bool] = None, rel=None):
        """``training`` overrides the module's mode: a checkpointed layer is
        run again in the backward, when the module may have left train().
        ``rel``: the static relative transforms of local mode."""
        frames = scale_translation(bb_frames_from_atom14(X), 1.0 / self.position_scale)
        if self.training if training is None else training:
            fused = self.fused_messages is True and self.fused_messages_train
            chain_fn = (_residual_chain if self.fused_chain_train and self.dropout == 0.0
                        else self._unfused_chain)
        elif self.fused_layers:
            return self._fused_layer(h_V, h_E, idx, frames, mask_V, mask_attend,
                                     do_edge_update)
        else:
            fused = self.fused_messages
            chain_fn = (_residual_chain if self.fused_chain
                        else functools.partial(self._unfused_chain, train=False))

        msg = self.node_message_fn(h_V, h_E, idx, self._points(self.points_fn_node, h_V),
                                   frames, mask_attend, pool=True, fused=fused, rel=rel)
        h_V = chain_fn(h_V, msg, mask_V, self.norm[0], self.node_dense, self.norm[1],
                       pre_mask=False)
        if do_edge_update:
            edge_args = (h_V, h_E, idx, self._points(self.points_fn_edge, h_V), frames,
                         mask_attend)
            if fused == "geom_lanes" and FOLD_EDGE_CHAIN and chain_fn is _residual_chain:
                return h_V, message_chain(
                    *self.edge_message_fn.operands(*edge_args),
                    *chain_weights(self.norm[2], self.edge_dense, self.norm[3]), self.act)
            e_msg = self.edge_message_fn(*edge_args, pool=False, fused=fused, rel=rel)
            h_E = chain_fn(h_E, e_msg, mask_attend, self.norm[2], self.edge_dense,
                           self.norm[3], pre_mask=True)
        return h_V, h_E


class VanillaMPNNLayer(nn.Module):
    """Sum-pooled message passing without geometry (``use_ipmp=False``), as
    the JAX package's ``VanillaMPNNLayer``:

        msg  = MLP_msg([h_i | h_E | h_j]) * mask_attend       (3 linear maps)
        h_V  = LN_0(h_V + sum_k msg / scale)                  (scale: k_neighbors)
        h_V  = LN_1(h_V + FFN(h_V)) * mask_V
        h_E  = LN_2(h_E + MLP_edge([h_i | h_E | h_j]))        (new h_V; no mask)

    The JAX layer's MLPs and LayerNorms take no dtype, so flax runs them in
    float32 whatever the compute dtype: here too, every operand is cast to
    float32 and the outputs stay float32. No pass runs a kernel. Dropout
    (training only) falls on ``dh``, the FFN output and the edge message.
    Parameter names (chosen here; the reference's ``MPNNLayer`` is not in
    the repository): ``node_message_fn``, ``node_dense``, ``edge_message_fn``
    (each ``W_in``, ``W_inter.N``, ``W_out``) and ``norm.0-2``."""

    def __init__(self, hidden_dim: int = 128, edge_dim: int = 128, dropout: float = 0.1,
                 act: str = "relu", scale: float = 32.0):
        super().__init__()
        self.dropout, self.scale = dropout, scale
        h_in = 2 * hidden_dim + edge_dim
        self.node_message_fn = MLP(h_in, hidden_dim, hidden_dim, 3, act)
        self.node_dense = MLP(hidden_dim, 4 * hidden_dim, hidden_dim, 2, act)
        self.edge_message_fn = MLP(h_in, hidden_dim, hidden_dim, 3, act)
        self.norm = nn.ModuleList(LayerNorm(hidden_dim) for _ in range(3))

    @staticmethod
    def _inputs(h_V, h_E, idx):
        h_j = gather_nodes(h_V, idx)
        return torch.cat([h_V[:, :, None].expand_as(h_j), h_E, h_j], -1)

    def forward(self, h_V, h_E, idx, X, mask_V, mask_attend, do_edge_update: bool = True,
                training: Optional[bool] = None, rel=None):
        """The arguments of ``InvariantPointLayer.forward`` (``X`` and ``rel``
        unused); returns float32 (h_V, h_E)."""
        train = self.training if training is None else training
        drop = lambda v: F.dropout(v, self.dropout, training=train)
        h_V, h_E = h_V.float(), h_E.float()
        msg = self.node_message_fn(self._inputs(h_V, h_E, idx)) * mask_attend[..., None]
        h_V = self.norm[0](h_V + drop(msg.sum(-2) / self.scale))
        h_V = self.norm[1](h_V + drop(self.node_dense(h_V)))
        h_V = h_V * mask_V[..., None]
        if do_edge_update:
            h_E = self.norm[2](h_E + drop(self.edge_message_fn(self._inputs(h_V, h_E, idx))))
        return h_V, h_E


class MessagePassingStack(nn.Module):
    def __init__(self, hidden_dim: int = 128, num_layers: int = 3, n_points: int = 8,
                 edge_dim: int = 128, position_scale: float = 1.0, remat: bool = False,
                 geometry_local: bool = False, use_ipmp: bool = True, k_neighbors: int = 32,
                 **layer_kw):
        """``use_ipmp=False``: ``VanillaMPNNLayer`` layers, their sums
        divided by ``k_neighbors`` (the routing options of ``layer_kw`` do
        not apply to them)."""
        super().__init__()
        self.remat = remat   # training: recompute each layer in the backward
        self.position_scale = position_scale
        self.geometry_local = geometry_local
        if use_ipmp:
            layers = (InvariantPointLayer(hidden_dim, n_points, edge_dim, position_scale,
                                          **layer_kw) for _ in range(num_layers))
        else:
            layers = (VanillaMPNNLayer(hidden_dim, edge_dim, layer_kw.get("dropout", 0.1),
                                       layer_kw.get("act", "relu"), float(k_neighbors))
                      for _ in range(num_layers))
        self.mpnn_layers = nn.ModuleList(layers)

    @staticmethod
    def attend_mask(mask: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """[B, L, K] edge validity mask_i * mask_j (static during sampling)."""
        return mask[..., None] * gather_nodes(mask, idx)

    def forward(self, h_V, h_E, idx, X, mask, skip_last_edge_update: bool = False,
                mask_attend: Optional[torch.Tensor] = None, rel=None):
        """Returns h_V. With ``skip_last_edge_update`` the last layer's edge
        pass, whose output feeds nothing, is not run. In local mode ``rel``
        is the cached relative transforms, computed here when not given
        (training, an uncached evaluation)."""
        if mask_attend is None:
            mask_attend = self.attend_mask(mask, idx)
        if self.geometry_local and rel is None:
            frames = scale_translation(bb_frames_from_atom14(X), 1.0 / self.position_scale)
            rel = relative_frame_transforms(frames, idx)
        n = len(self.mpnn_layers)
        for i, layer in enumerate(self.mpnn_layers):
            last = i == n - 1
            do_edge = not (last and skip_last_edge_update)
            if self.remat and self.training and torch.is_grad_enabled():
                h_V, h_E = checkpoint(layer, h_V, h_E, idx, X, mask, mask_attend, do_edge, True,
                                      rel, use_reentrant=False)
            else:
                h_V, h_E = layer(h_V, h_E, idx, X, mask, mask_attend, do_edge_update=do_edge,
                                 rel=rel)
        return h_V
