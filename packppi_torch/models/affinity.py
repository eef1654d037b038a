"""PackPPI-AP: the change of binding free energy (ddG) under mutations.

A frozen pretrained diffusion backbone gives per-residue features at t = 0;
a mutation encoder and IPMP stack of their own run on the mutation's local
subgraph (residues whose CA lies within 10 A of a mutated CA); per residue,
[pretrained | mutation | sequence] features are fused and a learned
mutation-flag bias added; the ddG head reads the max over residues of
(mutant - wild type), and its antisymmetric twin (wild type - mutant).

Modes: "network" (all of it), "linear" (the frozen backbone's features and
the head), "esm" (ESM-2 embeddings and the head; ``EsmAffinityModel`` runs
ESM-2 and the head on a dataset batch). Parameter names are the
reference ``AffinityPrediction``'s (``mutation_encoder.*``,
``mutation_mpnn.*``, ``mutation_fusion.{0,2}.*``, ``seq_embedding.weight``,
``mut_bias.weight``, ``ddg_predictor.{0,2,4}.*``); the backbone keeps the
diffusion network's names.

A prediction is three passes of two functions: the backbone's
(``AffinityModel._backbone_pass``) on the wild type, then on the mutant,
and the mutation stack's (``_mutation_pass``). On the CPU, with grad
enabled or with ``deterministic=False``, they run eagerly. Otherwise, on
the card, each is captured once a (B, L) shape into a CUDA graph
(``_GraphedPass``, kept in a ``device.GraphCache`` on the model) and
replayed, so a prediction costs the host three replays rather than the
operations of four network evaluations.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from packppi_torch.data.batch import ProteinBatch
from packppi_torch.data.esm import ESM_DIM
from packppi_torch.data.skempi import AffinityBatch, EsmBatch
from packppi_torch.device import GraphCache, Replay, static_copies, weight_versions
from packppi_torch.models import ipmp
from packppi_torch.models.diffusion_net import NetworkConfig
from packppi_torch.models.encoder import ProteinEncoder
from packppi_torch.models.esm2 import ESM2, embed_rows
from packppi_torch.models.ipmp import MessagePassingStack
from packppi_torch.models.torsional_diffusion import TorsionalDiffusion
from packppi_torch.utils.trace import span, tally

MODES = ("network", "linear", "esm")


def local_subgraph_mask(X_ca: torch.Tensor, mut_mask: torch.Tensor, radius: float = 10.0,
                        residue_mask: Optional[torch.Tensor] = None,
                        max_mutations: int = 32) -> torch.Tensor:
    """[B, L] 1.0 where a residue's CA lies within ``radius`` of a mutated
    residue's CA. ``residue_mask`` excludes padding rows (their CA sits at
    the origin). Distances are taken to at most ``max_mutations`` mutated
    CAs, the first ones in residue order, as ``lax.top_k`` picks them;
    ``+1e-12`` under the root as in the JAX package."""
    M = min(max_mutations, mut_mask.shape[-1])
    # a stable descending sort puts the lowest indices first among equals
    w, midx = torch.sort(mut_mask.float(), dim=-1, descending=True, stable=True)
    w, midx = w[..., :M], midx[..., :M]
    mut_ca = torch.gather(X_ca, 1, midx[..., None].expand(-1, -1, 3))      # [B, M, 3]
    d = torch.sqrt(torch.sum((X_ca[:, :, None, :] - mut_ca[:, None, :, :]) ** 2, -1) + 1e-12)
    local = ((d < radius) & (w[:, None, :] > 0)).any(-1).float()
    if residue_mask is not None:
        local = local * residue_mask
    return local


def ddg_head(dim: int) -> nn.Sequential:
    """The ddG head: two ReLU layers of ``dim`` and a scalar output."""
    return nn.Sequential(nn.Linear(dim, dim), nn.ReLU(), nn.Linear(dim, dim), nn.ReLU(),
                         nn.Linear(dim, 1))


class AffinityNet(nn.Module):
    """The trainable part of PackPPI-AP; the backbone's per-residue features
    (or ESM-2 embeddings) come in as ``h_pret_wt``/``h_pret_mt``.

    ``strict_parity`` pools over every row, padding included, as the
    reference does (a prediction then depends on the padding length); off,
    the pool takes real rows only (``pool_mask``)."""

    def __init__(self, cfg: NetworkConfig = NetworkConfig(), mode: str = "network",
                 strict_parity: bool = True, esm_dim: int = ESM_DIM):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"AffinityNet mode {mode!r} (one of {MODES})")
        cfg.validate()
        self.cfg, self.mode, self.strict_parity = cfg, mode, strict_parity
        H = cfg.hidden_dim
        if mode == "network":
            # the mutation encoder has no time channel
            self.mutation_encoder = ProteinEncoder(cfg.node_features, cfg.edge_features, 0,
                                                   cfg.num_rbf, cfg.top_k)
            self.mutation_mpnn = MessagePassingStack(
                H, cfg.num_mpnn_layers, cfg.n_points, cfg.edge_features, cfg.position_scale,
                use_ipmp=cfg.use_ipmp, k_neighbors=cfg.k_neighbors, act=cfg.act,
                dropout=cfg.dropout, fused_messages=cfg.fused_messages,
                fused_messages_train=cfg.fused_messages_train, fused_chain=cfg.fused_chain,
                fused_chain_train=cfg.fused_chain_train)
            self.seq_embedding = nn.Embedding(21, H)
            self.mut_bias = nn.Embedding(2, H)
            self.mutation_fusion = nn.Sequential(nn.Linear(3 * H, H), nn.ReLU(), nn.Linear(H, H))
        self.ddg_predictor = ddg_head(esm_dim if mode == "esm" else H)

    def _encode(self, batch: ProteinBatch, h_pret, local, bias):
        dtype = self.cfg.dtype
        sc_sincos = batch.SC_D_sincos * batch.SC_D_mask[..., None]
        enc = self.mutation_encoder
        # the local subgraph is the kNN mask: only its residues connect
        h_E, idx = enc.encode_edges(batch.X, batch.chain_indices, local, batch.residue_index,
                                    dtype)
        h_mut = enc.encode_nodes(batch.residue_type, batch.BB_D_sincos, sc_sincos, None, dtype)
        seq = self.seq_embedding(batch.residue_type)
        h = self.mutation_fusion(torch.cat([h_pret.float(), h_mut.float(), seq], -1)) + bias
        mask_attend = MessagePassingStack.attend_mask(local, idx)
        # the stack returns h_V only, so its last edge pass is not run
        return self.mutation_mpnn(h.to(dtype), h_E, idx, batch.X, local,
                                  skip_last_edge_update=True, mask_attend=mask_attend).float()

    def features(self, wild: Optional[ProteinBatch], mut: Optional[ProteinBatch],
                 h_pret_wt, h_pret_mt, mut_mask):
        """The per-residue features (h_wt, h_mt) [B, L, H] the head pools:
        the mutation stack's in "network" mode, the inputs otherwise."""
        if self.mode != "network":
            return h_pret_wt.float(), h_pret_mt.float()
        local = local_subgraph_mask(wild.X[:, :, 1, :], mut_mask, residue_mask=wild.residue_mask)
        flag = torch.clamp(mut_mask.long(), 0, 1)
        bias = self.mut_bias(flag) * (flag > 0)[..., None]           # padding_idx 0
        return (self._encode(wild, h_pret_wt, local, bias),
                self._encode(mut, h_pret_mt, local, bias))

    def forward(self, wild: Optional[ProteinBatch], mut: Optional[ProteinBatch],
                h_pret_wt, h_pret_mt, mut_mask, pool_mask=None):
        """(ddg [B], ddg_inv [B]); ``wild``, ``mut`` and ``mut_mask`` are
        read in "network" mode only."""
        h_wt, h_mt = self.features(wild, mut, h_pret_wt, h_pret_mt, mut_mask)
        if self.strict_parity or pool_mask is None:
            pool = lambda d: torch.amax(d, dim=1)
        else:
            valid = (pool_mask > 0)[..., None]
            pool = lambda d: torch.amax(torch.where(valid, d, torch.full_like(d, -1e9)), dim=1)
        ddg = self.ddg_predictor(pool(h_mt - h_wt)).squeeze(-1)
        ddg_inv = self.ddg_predictor(pool(h_wt - h_mt)).squeeze(-1)
        return ddg, ddg_inv


class AffinityModel(nn.Module):
    """The frozen diffusion backbone (``backbone``, a ``TorsionalDiffusion``
    whose ``net`` carries the diffusion checkpoint) and the affinity network
    (``net``)."""

    def __init__(self, cfg: NetworkConfig = NetworkConfig(), mode: str = "network",
                 strict_parity: bool = True, esm_dim: int = ESM_DIM):
        super().__init__()
        self.mode = mode
        self.backbone = TorsionalDiffusion(cfg)
        self.net = AffinityNet(cfg, mode, strict_parity, esm_dim)
        # the captured passes of each shape (``predict``), one cache a pass
        self._backbone_graphs, self._mutation_graphs = GraphCache(), GraphCache()

    @staticmethod
    def create(cfg: NetworkConfig = NetworkConfig(), mode: str = "network",
               strict_parity: bool = True, esm_dim: int = ESM_DIM) -> "AffinityModel":
        return AffinityModel(cfg, mode, strict_parity, esm_dim)

    @torch.no_grad()
    def pret(self, batch: ProteinBatch) -> torch.Tensor:
        """The frozen backbone's per-residue features [B, L, H] at t = 0."""
        self.backbone.net.eval()
        return self._backbone_pass(batch)

    def _backbone_pass(self, batch: ProteinBatch) -> torch.Tensor:
        """h_V [B, L, H] of the backbone at t = 0 (``encode_edges`` and the
        network, its last edge pass skipped), in the network's current mode."""
        t = torch.zeros(batch.residue_mask.shape, device=batch.X.device)
        _, h_V = self.backbone.net(batch, batch.SC_D, t, skip_last_edge_update=True)
        return h_V

    def _mutation_pass(self, batch: AffinityBatch, h_wt: torch.Tensor, h_mt: torch.Tensor):
        """(ddg [B], ddg_inv [B]) of the net on the backbone's features of
        the wild type and the mutant, in the net's current mode."""
        wild = batch.wild()
        return self.net(wild, batch.mutant(), h_wt, h_mt, batch.mut_mask, wild.residue_mask)

    def predict(self, batch: AffinityBatch, deterministic: bool = True):
        """(ddg [B], ddg_inv [B]) in "network" or "linear" mode; dropout is
        applied only with ``deterministic=False``.

        On the card, with grad disabled and ``deterministic``, each pass
        replays the CUDA graph of its shape (``_GraphedPass``), with the
        same bits as the eager passes; what it returns is its own."""
        if batch.X.is_cuda and deterministic and not torch.is_grad_enabled():
            return self._graphed(batch)
        wild, mut = batch.wild(), batch.mutant()
        with span("affinity.backbone"):
            tally("affinity_eager_passes")
            h_wt = self.pret(wild)
        with span("affinity.backbone"):
            tally("affinity_eager_passes")
            h_mt = self.pret(mut)
        self.net.train(not deterministic)
        try:
            with span("affinity.mutation"):
                tally("affinity_eager_passes")
                return self._mutation_pass(batch, h_wt, h_mt)
        finally:
            self.net.eval()

    def _graphed(self, batch: AffinityBatch):
        """``predict`` as three replays: the backbone's graph on the wild
        type and on the mutant, then the mutation stack's."""
        self.backbone.net.eval()
        self.net.eval()
        device = batch.X.device
        key = (device, *batch.mut_mask.shape, self.mode, ipmp.FOLD_EDGE_CHAIN)
        wild, mut = batch.wild(), batch.mutant()
        backbone = self._backbone_graphs.get(key, lambda: _GraphedPass(
            self._backbone_pass, self.backbone.net, device,
            (static_copies(wild, _BACKBONE_READ),), "affinity.backbone"), _GraphedPass.current)
        h_wt, h_mt = backbone.run((wild,)), backbone.run((mut,))
        mutation = self._mutation_graphs.get(key, lambda: _GraphedPass(
            self._mutation_pass, self.net, device,
            (static_copies(batch, _MUTATION_READ), h_wt.clone(), h_mt.clone()),
            "affinity.mutation"), _GraphedPass.current)
        return mutation.run((batch, h_wt, h_mt))

    def predict_esm(self, esm_wt, esm_mt, residue_mask=None):
        """(ddg, ddg_inv) over ESM-2 embeddings [B, L, E]; ``residue_mask``
        marks real rows, read only with ``strict_parity`` off."""
        return self.net(None, None, esm_wt, esm_mt, None, residue_mask)

    def loss(self, batch: AffinityBatch, deterministic: bool = False):
        """Antisymmetric MSE: f(wt, mt) ~ ddG and f(mt, wt) ~ -ddG."""
        ddg, ddg_inv = self.predict(batch, deterministic)
        y = batch.ddg
        return 0.5 * (torch.mean((ddg - y) ** 2) + torch.mean((ddg_inv + y) ** 2))

    def loss_esm(self, esm_wt, esm_mt, ddg, weights=None, residue_mask=None):
        """The antisymmetric MSE over ESM-2 embeddings; ``weights`` [B] turns
        the batch mean into a weighted mean (zero-weight rows pad a batch)."""
        pred, pred_inv = self.predict_esm(esm_wt, esm_mt, residue_mask)
        if weights is None:
            return 0.5 * (torch.mean((pred - ddg) ** 2) + torch.mean((pred_inv + ddg) ** 2))
        w = weights / torch.clamp(weights.sum(), min=1e-9)
        return 0.5 * (torch.sum(w * (pred - ddg) ** 2) + torch.sum(w * (pred_inv + ddg) ** 2))


# the fields the backbone's pass reads of a ProteinBatch, and the mutation
# stack's of an AffinityBatch (the wild type's and the mutant's)
_BACKBONE_READ = ("X", "residue_type", "residue_mask", "residue_index", "chain_indices",
                  "BB_D_sincos", "SC_D", "SC_D_mask")
_MUTATION_READ = ("X", "residue_type", "residue_mask", "residue_index", "chain_indices",
                  "BB_D_sincos", "SC_D_sincos", "SC_D_mask", "residue_type_mut",
                  "SC_D_sincos_mut", "SC_D_mask_mut", "mut_mask")


class _GraphedPass:
    """One pass of ``AffinityModel`` captured on ``device`` for one shape:
    the ``Replay`` of ``fn(*copies)``, whose result stays in the graph's own
    memory and is cloned out for each request. Captured under the weights
    of ``module`` as they read then (``device.weight_versions``)."""

    def __init__(self, fn, module: nn.Module, device, copies: tuple, span_name: str):
        self.module, self.weights, self.out = module, weight_versions(module), None

        def step():
            self.out = fn(*copies)

        self.replay = Replay(step, device, copies, span_name, "affinity_")

    def current(self) -> bool:
        """Whether ``module``'s parameters are still the tensors and
        versions the graph was captured under."""
        return self.weights == weight_versions(self.module)

    def run(self, request: tuple):
        """``fn`` on ``request`` (of the copies' structure): one replay."""
        return self.replay.run(request, 1, lambda: static_copies(self.out))


class EsmAffinityModel(nn.Module):
    """PackPPI-AP in esm mode end to end: ESM-2 (``esm``) embeds every
    distinct sequence of an ``EsmBatch`` in one forward, and the esm-mode
    ``AffinityNet`` (``net``) reads the wild type's and the mutants'
    residue rows."""

    def __init__(self, esm: ESM2, net: AffinityNet):
        super().__init__()
        if net.mode != "esm":
            raise ValueError(f"EsmAffinityModel needs an esm-mode AffinityNet, not {net.mode!r}")
        self.esm, self.net = esm, net

    def embed(self, batch: EsmBatch):
        """The wild type's and the mutants' residue rows [B, L, hidden],
        zeros at padding."""
        return embed_rows(self.esm, batch.input_ids, batch.attention_mask, batch.rows).unbind(0)

    @torch.no_grad()
    def predict(self, batch: EsmBatch):
        """(ddg [B], ddg_inv [B])."""
        wt, mt = self.embed(batch)
        with span("affinity.esm_head"):
            return self.net(None, None, wt, mt, None, batch.row_mask)
