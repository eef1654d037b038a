"""Protein graph encoder: kNN graph + geometric node/edge features.

Edge features (468 wide): AF2 clipped relative-position one-hots (65
bins), 16-bin RBFs of the 25 pairwise {N, CA, C, O, Cb} distances, a
same-chain flag and the inter-residue phi/psi dihedrals. Node features (51
wide): sequence one-hot, backbone and side-chain dihedral sin/cos and a
sinusoidal time embedding.

The encoder is split into a static part (``encode_edges``: graph and edge
embeddings, fixed by the backbone) and a dynamic part (``encode_nodes``:
depends on the noised chis and the diffusion time), so the sampler builds
the graph once per structure instead of once per step.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from packppi_torch.geometry.dihedrals import dihedral_from_four_points
from packppi_torch.models.layers import LayerNorm, dense, sinusoidal_time_embedding
from packppi_torch.ops.graph import gather_nodes, masked_knn


def impute_cb(N, CA, C):
    """Virtual C-beta from backbone geometry (ideal tetrahedral)."""
    b = CA - N
    c = C - CA
    a = torch.linalg.cross(b, c, dim=-1)
    return -0.58273431 * a + 0.56802827 * b - 0.54067466 * c + CA


class ProteinEncoder(nn.Module):
    def __init__(self, node_features: int = 128, edge_features: int = 128,
                 time_embedding_dim: int = 16, num_rbf: int = 16, top_k: int = 32,
                 max_relative_feature: int = 32):
        super().__init__()
        self.time_embedding_dim = time_embedding_dim
        self.num_rbf = num_rbf
        self.top_k = top_k
        self.max_relative_feature = max_relative_feature
        n_rel = 2 * max_relative_feature + 1
        self.node_embedding = nn.Linear(21 + 6 + 8 + time_embedding_dim, node_features)
        self.norm_nodes = LayerNorm(node_features)
        self.edge_embedding = nn.Linear(n_rel + 25 * num_rbf + 1 + 2, edge_features)
        self.norm_edges = LayerNorm(edge_features)

    def _rbf(self, D):
        mu = torch.linspace(0.0, 20.0, self.num_rbf, device=D.device)
        sigma = 20.0 / self.num_rbf
        return torch.exp(-(((D[..., None] - mu) / sigma) ** 2))

    def _relpos(self, residue_index, idx):
        nbr_index = gather_nodes(residue_index, idx)
        offset = residue_index[..., :, None] - nbr_index
        m = self.max_relative_feature
        clipped = torch.clamp(offset + m, 0, 2 * m)
        return F.one_hot(clipped, 2 * m + 1).float()

    def _atomic_rbfs(self, N, CA, C, O, idx):
        """[B, L, K, 25 * num_rbf] distances between the 5 key atoms of each
        residue pair, computed after the neighbour gather."""
        Cb = impute_cb(N, CA, C)
        atoms = torch.stack([N, CA, C, O, Cb], dim=-2)          # [B, L, 5, 3]
        nbr = gather_nodes(atoms, idx)                          # [B, L, K, 5, 3]
        # centre's atom a x neighbour's atom b, row-major over (a, b)
        d = torch.sqrt(torch.sum(
            (atoms[:, :, None, :, None, :] - nbr[:, :, :, None, :, :]) ** 2, -1) + 1e-6)
        return self._rbf(d).reshape(*idx.shape, 25 * self.num_rbf)

    def _pairwise_dihedrals(self, N, CA, C, idx):
        N_j = gather_nodes(N, idx)
        CA_j = gather_nodes(CA, idx)
        C_j = gather_nodes(C, idx)
        phi = dihedral_from_four_points(C[:, :, None], N_j, CA_j, C_j)
        psi = dihedral_from_four_points(N[:, :, None], CA[:, :, None], C[:, :, None], N_j)
        return torch.stack([phi, psi], -1)

    def encode_edges(self, X, chain_indices, mask, residue_index,
                     dtype: Optional[torch.dtype] = None):
        """STATIC part: kNN graph + embedded edge features [B, L, K, F] in
        ``dtype`` (float32 when None), and idx [B, L, K] int64."""
        N, CA, C, O = X[:, :, 0], X[:, :, 1], X[:, :, 2], X[:, :, 3]
        _, idx = masked_knn(CA, mask, self.top_k)

        relpos = self._relpos(residue_index, idx)
        rbfs = self._atomic_rbfs(N, CA, C, O, idx)
        nbr_chain = gather_nodes(chain_indices, idx)
        same_chain = (chain_indices[:, :, None] == nbr_chain).float()
        dihed = self._pairwise_dihedrals(N, CA, C, idx)
        h_E = torch.cat([relpos, rbfs, same_chain[..., None] + 1.0, dihed], -1)
        return self.norm_edges(dense(h_E, self.edge_embedding, dtype), dtype), idx

    def encode_nodes(self, S, BB_D_sincos, SC_D_sincos, t=None,
                     dtype: Optional[torch.dtype] = None):
        """DYNAMIC part: node features from sequence + dihedrals (+ time)."""
        parts = [F.one_hot(S, 21).float(),
                 BB_D_sincos.reshape(*S.shape, -1).float(),
                 SC_D_sincos.reshape(*S.shape, -1).float()]
        if self.time_embedding_dim > 0 and t is not None:
            parts.append(sinusoidal_time_embedding(t, self.time_embedding_dim))
        h_V = torch.cat(parts, -1)
        return self.norm_nodes(dense(h_V, self.node_embedding, dtype), dtype)
