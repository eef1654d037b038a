"""The yardstick's arithmetic: the card's published peaks, the bytes and
operations a message or chain pass needs (from shapes, whatever kernel
computes them), and the model's operations on true rows for ``mfu``.

Peaks: NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit.
bfloat16 on the tensor cores 989 TFLOP/s; float32 at 165 TFLOP/s, the
tensor cores' TF32 rate (495) over the three TF32 products of one
float32-accurate product (3xTF32), the least time the card needs for a
float32 product whatever computes it (the FMA units' 67 TFLOP/s is slower).
HBM 3.35 TB/s.
"""
from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 495e12 / 3}
ESIZE = {"bfloat16": 2, "float32": 4}


def bound_s(nbytes: float, nops: float, dtype: str) -> float:
    """The least time: bytes over the bandwidth or operations over the
    dtype's peak, whichever is larger."""
    return max(nbytes / PEAK_BYTES_PER_S, nops / PEAK_OPS_PER_S[dtype])


def message_pass(B, L, K, H, He, P, dtype, pool: bool):
    """(bytes, operations) of one message pass over B x L nodes with K
    neighbours: per_i (f32), per_j and h_E (stream dtype), idx (int64),
    p_local, rot, trans, global points and the edge mask (f32) and the
    float32 weights read once, the output written once; the three products'
    multiply-adds over every edge row: [h_E | 9P geometry] W_e, then two
    H x H maps, with the node terms counted as their H x H each."""
    e = ESIZE[dtype]
    G = 9 * P
    inputs = (B * L * H * 4 + B * L * H * e + B * L * K * He * e + B * L * K * 8
              + B * L * (3 * P + 9 + 3 + 3 * P) * 4 + B * L * K * 4
              + (H * (2 * H + He + G) + 3 * H + 2 * H * H) * 4)
    out = B * L * H * 4 if pool else B * L * K * H * e
    return inputs + out, 2 * B * L * K * (He + G + 2 * H) * H


def chain_pass(N, H, dtype, node: bool):
    """(bytes, operations) of one residual chain over N rows: x (stream
    dtype), the message (f32 pooled for a node pass, the stream dtype for an
    edge pass), the edge mask and the float32 weights read once, x written
    once; two H x 4H products per row."""
    e = ESIZE[dtype]
    msg = 4 if node else e
    weights = (2 * H + 4 * H * H + 4 * H + 4 * H * H + H + 2 * H) * 4
    nbytes = N * H * e + N * H * msg + (0 if node else N * 4) + weights + N * H * e
    return nbytes, 16 * N * H * H


def evaluation_passes(B, L, cfg: dict, dtype: str, edge_passes: int):
    """[(kind, bytes, operations)] of one network evaluation at B x L rows
    (padded, as the kernels run them): a node message and chain pass in
    every layer, an edge pair in ``edge_passes`` of them."""
    H, He, P, K = cfg["hidden_dim"], cfg["edge_features"], cfg["n_points"], min(cfg["top_k"], L)
    out = []
    for _ in range(cfg["num_mpnn_layers"]):
        out.append(("message", *message_pass(B, L, K, H, He, P, dtype, True)))
        out.append(("chain", *chain_pass(B * L, H, dtype, True)))
    for _ in range(edge_passes):
        out.append(("message", *message_pass(B, L, K, H, He, P, dtype, False)))
        out.append(("chain", *chain_pass(B * L * K, H, dtype, False)))
    return out


def pass_bound_s(work: list, kind: str) -> float:
    """Summed least time of the ``kind`` passes of the traced work: ``work``
    is a list of (evaluations, B, L, cfg, dtype, edge passes)."""
    total = 0.0
    for n, B, L, cfg, dtype, edge_passes in work:
        total += n * sum(bound_s(nb, no, dtype)
                         for k, nb, no in evaluation_passes(B, L, cfg, dtype, edge_passes) if k == kind)
    return total


def score_net_flops(L: int, cfg: dict, time_channel: bool = True, edge_passes=None) -> float:
    """The operations of one evaluation of the chi score network on one
    structure of L true residues (2 per multiply-add): the encoder's edge
    and node embeddings, per layer the point projections, the node message
    MLP over every edge (its input [h_i | h_E | h_j | 9P]) and the node FFN,
    in ``edge_passes`` layers the edge message MLP and the edge FFN, and the
    score decoder. Gathers, norms and the geometry are left out."""
    H, He, P, K = cfg["hidden_dim"], cfg["edge_features"], cfg["n_points"], min(cfg["top_k"], L)
    layers = cfg["num_mpnn_layers"]
    edge_passes = layers - 1 if edge_passes is None else edge_passes
    E = L * K
    msg = E * ((2 * H + He + 9 * P) * H + 2 * H * H)
    ffn = 8 * H * H
    macs = E * 468 * He + L * (35 + (cfg["time_embedding_dim"] if time_channel else 0)) * H
    macs += layers * (L * H * 3 * P + msg + L * ffn)
    macs += edge_passes * (L * H * 3 * P + msg + E * ffn)
    macs += L * (H * H // 2 + H // 2 * H // 4 + H // 4 * H // 8 + H // 8 * 4)
    return 2.0 * macs


def affinity_flops(L: int, cfg: dict) -> float:
    """One PackPPI-AP prediction of one mutation: the backbone and the
    mutation stack on the wild type and on the mutant, the fusion and the
    head."""
    H = cfg["hidden_dim"]
    side = score_net_flops(L, cfg) + score_net_flops(L, cfg, time_channel=False) \
        - 2.0 * L * (H * H // 2 + H // 2 * H // 4 + H // 4 * H // 8 + H // 8 * 4) \
        + 2.0 * L * (3 * H * H + H * H)
    return 2 * side + 2 * 2.0 * (2 * H * H + H)
