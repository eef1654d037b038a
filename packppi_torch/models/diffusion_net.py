"""The chi-angle score network: encoder -> IPMP stack -> score decoder.

Module and parameter names are the reference checkpoint's (``encoder.*``,
``mpnn.mpnn_layers.N.*``, ``decoder_score.{0,2}.*``), so a reference state
dict loads with ``load_state_dict(strict=True)``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from packppi_torch.data.batch import ProteinBatch
from packppi_torch.geometry.rigid import bb_frames_from_atom14, scale_translation
from packppi_torch.models.encoder import ProteinEncoder
from packppi_torch.models.ipmp import MessagePassingStack, relative_frame_transforms
from packppi_torch.models.layers import MLP
from packppi_torch.ops._build import width_refusals
from packppi_torch.ops.activations import ACTS

GLOBAL_POINT_KERNELS = ("geom", "geom_lanes", "geom_gather")
STATIC_EDGE_DTYPES = ("float32", "bfloat16", "int8")


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    """The network's widths, numerics and kernel routing (see
    ``models.ipmp`` for which pass runs where). Parameters, gradients and
    optimizer state stay float32 whatever ``compute_dtype`` says. The
    fields are the JAX package's, and every value it accepts is accepted;
    values outside them raise ``ValueError`` when the network is built."""

    node_features: int = 128
    edge_features: int = 128
    hidden_dim: int = 128
    num_mpnn_layers: int = 3
    n_points: int = 8
    dropout: float = 0.1     # train() only; eval() never applies it
    # the message MLPs' and chain FFNs' activation (ops.activations.ACTS),
    # in the kernels too; the encoder and the score decoder stay relu
    act: str = "relu"
    position_scale: float = 1.0
    # False: the vanilla MPNN layer (models.ipmp.VanillaMPNNLayer), float32
    # tensor operations in every routing, no kernel
    use_ipmp: bool = True
    # the vanilla layer divides its message sums by this (not by top_k)
    k_neighbors: int = 32
    time_embedding_dim: int = 16
    num_rbf: int = 16
    top_k: int = 32
    compute_dtype: str = "float32"  # "bfloat16" for the fast inference path
    # storage of the static edge embeddings that encode_static caches for a
    # sampling run: "float32", "bfloat16" or "int8" (per-channel symmetric,
    # one scale over the whole batch), cast back to the compute dtype on
    # every read
    static_edge_dtype: str = "float32"
    # "global": geometry features from gathered global neighbour points
    # (float32); "local": from gathered local points (in the stream dtype)
    # and static relative frame transforms cached by encode_static. Local is
    # incompatible with the global-point kernels ("geom", "geom_lanes",
    # "geom_gather", fused_layers), as in the JAX package
    geometry_mode: str = "global"
    # message kernel: "geom_lanes" (point geometry inside the kernel,
    # neighbour rows loaded by index), "geom_gather" (the same through the
    # kernel that replaces the in-kernel-gather TPU kernel), "geom" (the
    # neighbour streams gathered outside the kernel) or True (the kernel over
    # geometry features computed outside, ops.message_feat) or False (no
    # kernel: the message as plain tensor operations, the JAX package's
    # unfused path)
    fused_messages: Union[bool, str] = "geom_lanes"
    # eval(): each residual chain through ops.chain; False runs it as plain
    # tensor operations (the JAX unfused path). On by default, where the
    # JAX package's default is off: the port routes through its kernels
    # unless asked not to, as the JAX CLIs do on the TPU
    fused_chain: bool = True
    # eval(): each IPMP layer as two kernels (ops.layer), superseding
    # fused_messages; train() routing is unchanged
    fused_layers: bool = False
    # train() too runs the message passes through the (differentiable)
    # feature-message kernel; needs fused_messages=True
    fused_messages_train: bool = False
    # train() too runs the chains through the (differentiable) chain kernel;
    # needs dropout=0.0, because the kernel applies none
    fused_chain_train: bool = False
    # train(): recompute each message-passing layer in the backward
    remat_layers: bool = False
    # accepted for the reference's configuration files and ignored: a
    # gather's backward is index_add_ here whatever this says
    mxu_gather_grad: Union[bool, str] = False
    # accepted and value-neutral: the JAX package's lane-major geometry
    # assembly and its coalesced local-mode gathers are other layouts of the
    # same values (one-hot MXU gathers, one wide gather), which a GPU has no
    # use for; the port computes the default layout whatever these say
    geometry_lanes: bool = False
    coalesce_gathers: bool = False

    def validate(self) -> None:
        if self.act not in ACTS:
            raise ValueError(f"NetworkConfig.act={self.act!r} (one of {tuple(ACTS)})")
        if self.static_edge_dtype not in STATIC_EDGE_DTYPES:
            raise ValueError(f"NetworkConfig.static_edge_dtype={self.static_edge_dtype!r} "
                             f"(one of {STATIC_EDGE_DTYPES})")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"NetworkConfig.compute_dtype={self.compute_dtype!r} "
                             "(float32 or bfloat16)")
        if self.node_features != self.hidden_dim:
            raise ValueError("node_features must equal hidden_dim")
        if self.geometry_mode not in ("global", "local"):
            raise ValueError(f"NetworkConfig.geometry_mode={self.geometry_mode!r} "
                             "('global' or 'local')")
        if not (isinstance(self.fused_messages, bool)
                or self.fused_messages in GLOBAL_POINT_KERNELS):
            raise ValueError(f"NetworkConfig.fused_messages={self.fused_messages!r} "
                             "(False, True, 'geom', 'geom_lanes' or 'geom_gather')")
        if self.geometry_mode == "local" and (
                self.fused_messages in GLOBAL_POINT_KERNELS or self.fused_layers):
            raise ValueError(
                "geometry_mode='local' is incompatible with the global-point kernels "
                "(fused_messages='geom'/'geom_lanes'/'geom_gather' / fused_layers)")
        if not isinstance(self.mxu_gather_grad, bool) and self.mxu_gather_grad != "auto":
            raise ValueError(f"NetworkConfig.mxu_gather_grad={self.mxu_gather_grad!r} "
                             "(False, True or 'auto')")
        if self.fused_chain_train and self.dropout != 0.0:
            raise ValueError(
                "fused_chain_train requires dropout=0.0: the chain kernel applies no "
                "dropout, so with dropout active the kernel and the unfused training "
                "paths would compute different functions")

    def runs_kernels(self) -> bool:
        """Whether a network of this configuration launches a kernel (the
        vanilla layer launches none, whatever the routing says)."""
        return bool(self.use_ipmp and (
            self.fused_messages is not False or self.fused_chain or self.fused_layers
            or self.fused_messages_train or self.fused_chain_train))

    def check_device(self, device) -> None:
        """Refuse, before any data is read, a configuration whose kernels
        cannot run on ``device``: the CUDA kernels are built for hidden_dim
        and edge_features every multiple of 32 from 32 to 256 and n_points
        1 to 16 (a library per width and activation, ``ops._build``), any
        top_k. The CPU runs the plain versions at any width."""
        if torch.device(device).type != "cuda" or not self.runs_kernels():
            return
        bad = width_refusals(self.hidden_dim, self.edge_features, self.n_points)
        if bad:
            raise ValueError(
                f"NetworkConfig({', '.join(bad)}) cannot run on {device}: the CUDA kernels "
                "are built for hidden_dim and edge_features a multiple of 32 from 32 to 256 "
                "and n_points 1 to 16; use such widths, --device cpu, or "
                "fused_messages=False with fused_chain=False")

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32


class StaticGraph(NamedTuple):
    """Backbone-only encoder outputs, constant through a sampling run."""

    # [B, L, K, F] at static_edge_dtype: float32 / bfloat16 as stored, or
    # int8 as (q [B, L, K, F] int8, scale [1, 1, 1, F]); ``edges(dtype)``
    # reads it back
    h_E: Union[torch.Tensor, tuple]
    idx: torch.Tensor          # [B, L, K] int64
    mask_attend: torch.Tensor  # [B, L, K] float32
    # local mode: the relative frame transforms (R_rel [B, L, K, 9], t_rel
    # [B, L, K, 3]); None in global mode
    rel: Optional[tuple] = None

    def edges(self, dtype: torch.dtype) -> torch.Tensor:
        """h_E in the compute ``dtype``: a stored cache cast back, an int8
        one dequantized as ``q.to(dtype) * scale.to(dtype)``."""
        if isinstance(self.h_E, tuple):
            q, scale = self.h_E
            return q.to(dtype) * scale.to(dtype)
        return self.h_E.to(dtype)

    def nbytes(self) -> int:
        """Bytes of the stored edge cache (the int8 scale included)."""
        parts = self.h_E if isinstance(self.h_E, tuple) else (self.h_E,)
        return sum(t.numel() * t.element_size() for t in parts)


def quantize_edges(h_E: torch.Tensor, static_edge_dtype: str):
    """The edge cache at ``static_edge_dtype``, from h_E as the encoder gives
    it (in the compute dtype). int8: a scale per channel over all of (B, L,
    K), ``max|h_E| / 127`` floored at 1e-8 and ``round`` (half to even),
    computed in h_E's dtype as the JAX package computes it; so in a batch of
    several structures a row's codes depend on its batch mates."""
    if static_edge_dtype == "bfloat16":
        return h_E.to(torch.bfloat16)
    if static_edge_dtype == "int8":
        scale = h_E.abs().amax(dim=(0, 1, 2), keepdim=True) / 127.0
        scale = torch.clamp(scale, min=1e-8)
        # in bf16 h_E / scale can round to 128: saturate, as XLA's convert does
        return torch.clamp(torch.round(h_E / scale), -128, 127).to(torch.int8), scale
    return h_E


class ChiScoreNetwork(nn.Module):
    def __init__(self, cfg: NetworkConfig = NetworkConfig()):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        self.encoder = ProteinEncoder(cfg.node_features, cfg.edge_features,
                                      cfg.time_embedding_dim, cfg.num_rbf, cfg.top_k)
        self.mpnn = MessagePassingStack(
            cfg.hidden_dim, cfg.num_mpnn_layers, cfg.n_points, cfg.edge_features,
            cfg.position_scale, remat=cfg.remat_layers,
            geometry_local=cfg.geometry_mode == "local", use_ipmp=cfg.use_ipmp,
            k_neighbors=cfg.k_neighbors, act=cfg.act, dropout=cfg.dropout,
            fused_messages=cfg.fused_messages, fused_messages_train=cfg.fused_messages_train,
            fused_chain=cfg.fused_chain, fused_chain_train=cfg.fused_chain_train,
            fused_layers=cfg.fused_layers)
        h = cfg.hidden_dim
        self.decoder_score = nn.Sequential(MLP(h, h // 2, h // 4, 2), nn.ReLU(),
                                           MLP(h // 4, h // 8, 4, 2))

    def encode_static(self, batch: ProteinBatch) -> StaticGraph:
        """kNN graph, edge features and edge mask: computed once per structure
        and reused by every denoising step; the edges stored at
        ``static_edge_dtype`` (``quantize_edges``)."""
        h_E, idx = self.encoder.encode_edges(batch.X, batch.chain_indices,
                                             batch.residue_mask, batch.residue_index,
                                             self.cfg.dtype)
        mask_attend = MessagePassingStack.attend_mask(batch.residue_mask, idx)
        rel = None
        if self.cfg.geometry_mode == "local":
            # the backbone does not move while sampling: the per-edge
            # relative frame transforms are static too
            frames = scale_translation(bb_frames_from_atom14(batch.X),
                                       1.0 / self.cfg.position_scale)
            rel = relative_frame_transforms(frames, idx)
        return StaticGraph(quantize_edges(h_E, self.cfg.static_edge_dtype), idx, mask_attend,
                           rel)

    def forward(self, batch: ProteinBatch, SC_D_noised: torch.Tensor, t: torch.Tensor,
                static: Optional[StaticGraph] = None,
                skip_last_edge_update: bool = False):
        """SC_D_noised [B, L, 4] noised chis, t [B, L] diffusion time.
        Returns (score [B, L, 4], h_V [B, L, hidden]), both float32."""
        dtype = self.cfg.dtype
        sc_sincos = torch.stack([torch.sin(SC_D_noised), torch.cos(SC_D_noised)], -1)
        sc_sincos = sc_sincos * batch.SC_D_mask[..., None]
        if static is None:
            h_E, idx = self.encoder.encode_edges(batch.X, batch.chain_indices,
                                                 batch.residue_mask, batch.residue_index, dtype)
            static = StaticGraph(h_E, idx, MessagePassingStack.attend_mask(
                batch.residue_mask, idx))
        h_V = self.encoder.encode_nodes(batch.residue_type, batch.BB_D_sincos,
                                        sc_sincos, t, dtype)
        h_V = self.mpnn(h_V, static.edges(dtype), static.idx, batch.X, batch.residue_mask,
                        skip_last_edge_update, static.mask_attend, static.rel)

        dec1, _, dec2 = self.decoder_score
        score = dec2(F.relu(dec1(h_V, dtype)), dtype)
        return score.float(), h_V.float()
