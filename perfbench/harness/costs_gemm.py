"""The yardstick's arithmetic for ESM-2's linear maps: the bytes and
operations each map of a forward needs (from shapes, whatever computes it).
Peaks and the bound are ``costs.py``'s: the maps are float32 products, whose
least time on the card is the tensor cores' 3xTF32 rate (165 TFLOP/s).
"""
from __future__ import annotations

from perfbench.harness import costs


def block_maps(cfg: dict) -> list:
    """(N, K) of each linear map of one ESM-2 block, ``nn.Linear``'s [N, K]
    weight: query, key, value and the attention output (d x d), the FFN's
    two maps (f x d, d x f)."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    return [(d, d)] * 4 + [(f, d), (d, f)]


def map_pass(M: int, N: int, K: int):
    """(bytes, operations) of one float32 map over M rows: x [M, K], the
    weight [N, K] and the bias read once, y [M, N] written once; M N K
    multiply-adds."""
    return 4 * (M * K + N * K + N + M * N), 2 * M * N * K


def gemm_bound_s(work: list) -> float:
    """Summed least time of the linear maps of the traced work: a list of
    (forwards, rows, T, cfg, dtype), every map of every block of each
    forward over rows x T rows (padded tokens included, as they are run)."""
    total = 0.0
    for n, B, T, cfg, _ in work:
        per_block = sum(costs.bound_s(*map_pass(B * T, N, K), "float32")
                        for N, K in block_maps(cfg))
        total += n * cfg["num_hidden_layers"] * per_block
    return total
