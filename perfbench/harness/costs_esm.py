"""The yardstick's arithmetic for ESM-2 in esm mode: the bytes and operations
an attention pass needs (from shapes, whatever computes it), and the model's
operations on true tokens for ``mfu``. Peaks and the bound are
``costs.py``'s.
"""
from __future__ import annotations

from perfbench.harness import costs


def attention_pass(B: int, H: int, T: int, D: int, dtype: str):
    """(bytes, operations) of one attention pass over B rows of T tokens
    padded (padded keys included, as the kernel runs them): q, k and v
    (``dtype``) and the key bias (float32) read once, the float32 output
    written once; q k^T and p v, 2 T^2 D multiply-adds a head each."""
    e = costs.ESIZE[dtype]
    nbytes = 3 * B * H * T * D * e + B * T * 4 + B * H * T * D * 4
    return nbytes, 4 * B * H * T * T * D


def attention_bound_s(work: list) -> float:
    """Summed least time of the attention passes of the traced work: a list
    of (forwards, rows, T, cfg, dtype), a pass a block of each forward."""
    total = 0.0
    for n, B, T, cfg, dtype in work:
        H = cfg["num_attention_heads"]
        nb, no = attention_pass(B, H, T, cfg["hidden_size"] // H, dtype)
        total += n * cfg["num_hidden_layers"] * costs.bound_s(nb, no, dtype)
    return total


def esm_flops(n: int, cfg: dict) -> float:
    """The operations of ESM-2's forward over one sequence of n true tokens
    (2 per multiply-add): in each block, per token, the four d x d maps and
    the two d x f ones of the FFN (24 d^2 at f = 4d) and the attention over
    n keys (4 n d). Embedding, norms, rotary and softmax left out."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    return float(cfg["num_hidden_layers"] * n * (8 * d * d + 4 * d * f + 4 * n * d))


def head_flops(dim: int) -> float:
    """One mutation's head, both directions: two dim x dim maps and one
    dim x 1 map each."""
    return 2 * 2.0 * (2 * dim * dim + dim)
