"""Dense masked kNN graph and neighbour gathers over padded [B, L, K] tables."""
from __future__ import annotations

from typing import Optional

import torch

# above this many residues masked_knn switches to row blocks
# (peak memory O(B * block * L) instead of the dense [B, L, L] matrix)
KNN_DENSE_MAX_L = 2048


def _knn_rows(coords_rows, mask_rows, coords, mask, k, eps):
    """kNN of a slab of query rows against all L columns. The push-beyond
    adjustment is per query row, so slab results equal the dense ones."""
    mask2d = mask_rows[..., :, None] * mask[..., None, :]
    diff = coords_rows[..., :, None, :] - coords[..., None, :, :]
    D = mask2d * torch.sqrt(torch.sum(diff * diff, -1) + eps)
    D_max = torch.amax(D, -1, keepdim=True)
    D_adjusted = D + 2.0 * (1.0 - mask2d) * D_max
    # a stable sort: equal distances keep their column order, as lax.top_k
    # orders them. A padded query row is all ties, so it takes columns
    # 0..k-1, and its (masked) edge features equal the JAX package's; they
    # enter the batch-wide int8 edge scale (static_edge_dtype)
    D_sorted, idx = torch.sort(D_adjusted, dim=-1, stable=True)
    return D_sorted[..., :k].contiguous(), idx[..., :k].contiguous()


def masked_knn(coords: torch.Tensor, mask: torch.Tensor, k: int, eps: float = 1e-6,
               block: Optional[int] = None):
    """k nearest neighbours (self included) under a validity mask.

    Args:
        coords: [B, L, 3] CA positions; mask: [B, L] 1.0 for real residues;
        k: neighbour count (clamped to L); block: query-row block size
        (None: dense up to ``KNN_DENSE_MAX_L`` residues, 512 beyond).

    Returns:
        (D_neighbors [B, L, K], idx [B, L, K] int64); invalid pairs are
        pushed beyond the row's max distance so they sort last, and equal
        distances come in column order (as ``lax.top_k`` gives them).
    """
    L = coords.shape[-2]
    k = min(k, L)
    if block is None and L > KNN_DENSE_MAX_L:
        block = 512
    if block is None or block >= L:
        D, idx = _knn_rows(coords, mask, coords, mask, k, eps)
        return D, idx
    parts = [_knn_rows(coords[:, s:s + block], mask[:, s:s + block], coords, mask, k, eps)
             for s in range(0, L, block)]
    return torch.cat([p[0] for p in parts], 1), torch.cat([p[1] for p in parts], 1)


def gather_nodes(nodes: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """nodes [B, L, *F] at idx [B, L, K] -> [B, L, K, *F]."""
    B, L = nodes.shape[:2]
    feat = nodes.shape[2:]
    flat = nodes.reshape(B, L, -1)
    out = torch.gather(flat, 1, idx.reshape(B, -1, 1).expand(-1, -1, flat.shape[-1]))
    return out.reshape(*idx.shape, *feat)
