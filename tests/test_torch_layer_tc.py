"""The float32 tensor-core arithmetic of the kernels that run a message tile
and then the residual chain in one block (``ops.message.message_chain``,
``ops.layer.layer_node`` and ``layer_edge``), modelled on the CPU and held
to the JAX package's float32 kernels before any card runs them.

The kernels compute the message MLP as ``csrc/message_tc.cuh`` does (3xTF32
on mma.sync, each 16-k weight chunk's partial summed from zero and added to
the running sum) and the chain as ``csrc/chain_mma.cuh`` does (the same, in
32-k chunks), with each kernel's own residual: the fold (row 1b) x0 = h_E +
m * mask, the whole layer (row 6) x0 = h_E + m * mask per edge and x0 = h_V
+ sum_k(m * mask) * (1/K) per node (in float32 every rounding point is the
identity). Here that model runs on the JAX package's own test cases (40
residues of 1BRS, as ``tests/test_torch_message_variants.py`` and
``tests/test_torch_layer.py`` feed them) against
``fused_message_geom_lanes(chain_weights=...)`` and ``fused_ipmp_layer``'s
node and edge passes in interpret mode, within 2e-5 (``chip_smoke.py``'s
float32 limit for these kernels). The control: plain TF32 (the operands of
every product rounded to TF32) must exceed it. The ``_at_width`` test holds
the same model, with the kernels' chunking at each width (the chain's
weight chunks of 16 k from H = 224 on), at (H, P) in {(64, 4), (128, 4),
(256, 8)} on ``tests/test_torch_widths.py``'s cases (K = 16, He = H).
"""

import numpy as np
import pytest
import torch

from packppi_torch.ops.activations import ACTS
from packppi_torch.ops.chain import _ln
from packppi_torch.ops.graph import gather_nodes
from packppi_torch.ops.message import geometry_edge_features
from packppi_torch.ops.message_feat import message_depth, message_weight_matrix, tf32_split

from test_torch_layer import _jax as _jax_layer
from test_torch_layer import _operands as _layer_operands
from test_torch_message_variants import H, K, _inputs, case, port_chain_weights, port_mlp  # noqa: F401
from test_torch_message_variants import _jax as _jax_route
from test_torch_tf32x3 import tf32
from torch_threads import _threads  # noqa: F401 (autouse fixture)

F32_TOL = 2e-5


def mm_3xtf32(chunk):
    """a [R, k] . w [k, n] as the float32 tensor-core bodies sum it: chunks
    of ``chunk`` k, each a partial from zero over its k-steps of 8 (hi.hi,
    lo.hi, hi.lo in that order), added to the running sum."""
    def mm(a, w):
        ah, al = tf32_split(a.contiguous())
        wh, wl = tf32_split(w.contiguous())
        acc = torch.zeros(a.shape[0], w.shape[1])
        for k0 in range(0, a.shape[1], chunk):
            p = torch.zeros_like(acc)
            for s in range(k0, min(k0 + chunk, a.shape[1]), 8):
                ks = slice(s, s + 8)
                p = p + ah[:, ks] @ wh[ks]
                p = p + al[:, ks] @ wh[ks]
                p = p + ah[:, ks] @ wl[ks]
            acc = acc + p
        return acc
    return mm


def mm_tf32(a, w):
    """The control: both operands rounded to TF32, one product."""
    return tf32(a) @ tf32(w)


def tensor_cores(H):
    """The float32 kernels' products at width H: the message in 16-k chunks,
    the chain in 32-k chunks (16 from H = 224 on, csrc/chain_mma.cuh kWk)."""
    return dict(message=mm_3xtf32(16), chain=mm_3xtf32(32 if H <= 192 else 16))


TC = tensor_cores(H)
PLAIN_TF32 = dict(message=mm_tf32, chain=mm_tf32)


def message_rows(per_i, pj, h_E, geom, w_in, b_in, w_mid, b_mid, w_out, b_out, mm,
                 act="relu"):
    """The message of every edge row [B, L, K, H]: [h_E | geom | zero
    columns to the padded depth] against the packed weight matrix's W_e,
    W_1 and W_2, at the widths of the operands."""
    B, L, Kn, He = h_E.shape
    H_, G = per_i.shape[-1], geom.shape[-1]
    k1 = message_depth(He, G)
    w = message_weight_matrix(w_in, w_mid, w_out, He).t()        # [464, H] (in, out)
    rows = lambda t: t.reshape(B * L * Kn, -1).float()
    a = torch.cat([rows(h_E), rows(geom), torch.zeros(B * L * Kn, k1 - He - G)], 1)
    per_row = per_i.float()[:, :, None].expand(B, L, Kn, H_)
    x = ACTS[act](mm(a, w[:k1]) + b_in + rows(per_row) + rows(pj))
    x = ACTS[act](mm(x, w[k1:k1 + H_]) + b_mid)
    return (mm(x, w[k1 + H_:]) + b_out).reshape(B, L, Kn, H_)


def chain_rows(x0, lna_w, lna_b, w1, b1, w2, b2, lnb_w, lnb_b, mm, act="relu"):
    """LN_b(xx + FFN(xx)), xx = LN_a(x0), over rows [N, H]."""
    xx = _ln(x0, lna_w, lna_b)
    h = ACTS[act](mm(xx, w1.t()) + b1)
    return _ln(xx + mm(h, w2.t()) + b2, lnb_w, lnb_b)


def edge_pass(h_E, per_i, pj, geom, mask, *weights, mm, act="relu"):
    """The edge passes of the fold and of the whole layer (in float32 the
    two residuals are one): x0 = h_E + m * mask, out = chain(x0) * mask."""
    m = message_rows(per_i, pj, h_E, geom, *weights[:6], mm["message"], act)
    x0 = h_E + m * mask[..., None]
    y = chain_rows(x0.reshape(-1, h_E.shape[-1]), *weights[6:], mm["chain"],
                   act).reshape(h_E.shape)
    return y * mask[..., None]


def node_pass(h_V, per_i, pj, h_E, geom, mask, mask_V, *weights, mm):
    """The whole layer's node pass: x0 = h_V + sum_k(m * mask) * (1/K)."""
    m = message_rows(per_i, pj, h_E, geom, *weights[:6], mm["message"])
    x0 = h_V + (m * mask[..., None]).sum(-2) * (1.0 / h_E.shape[-2])
    y = chain_rows(x0.reshape(-1, h_V.shape[-1]), *weights[6:], mm["chain"]).reshape(h_V.shape)
    return y * mask_V[..., None]


@pytest.fixture(scope="module")
def kernels(case):
    """kernel -> (the model of its float32 arithmetic with products ``mm``,
    the JAX kernel's output on the same operands)."""
    out = {}
    with torch.no_grad():
        ops = port_mlp(case["params"]).operands(*_inputs(case, torch.float32))
        per_i, per_j, h_E, idx, p_local, rot, trans, pg, mask, *msg_w = ops
        geom = geometry_edge_features(p_local, gather_nodes(pg, idx), rot, trans)
        fold = (h_E, per_i, gather_nodes(per_j, idx), geom, mask, *msg_w,
                *port_chain_weights(case["chain"]))
    out["message_chain"] = (lambda mm: edge_pass(*fold, mm=mm),
                            _jax_route(case, "fold", "float32", False))
    for name, pool, fn in (("layer_node", True, node_pass), ("layer_edge", False, edge_pass)):
        lops = _layer_operands(case, torch.float32, pool)
        out[name] = ((lambda mm, fn=fn, lops=lops: fn(*lops, mm=mm)),
                     _jax_layer(case, lops, "float32", pool))
    # gelu between the products of the message MLP and of the chain's FFN
    out["layer_edge_gelu"] = ((lambda mm: edge_pass(*lops, mm=mm, act="gelu")),
                              _jax_layer(case, lops, "float32", False, "gelu"))
    return out


@pytest.mark.parametrize("kernel", ["message_chain", "layer_node", "layer_edge",
                                    "layer_edge_gelu"])
def test_message_chain_and_layer_3xtf32_hold_the_float32_limit(kernels, kernel):
    model, ref = kernels[kernel]
    with torch.no_grad():
        got = model(TC).numpy()
        control = model(PLAIN_TF32).numpy()
    assert got.shape == ref.shape
    err, cerr = np.abs(got - ref).max(), np.abs(control - ref).max()
    assert err <= F32_TOL, err
    assert cerr > F32_TOL, cerr


@pytest.mark.parametrize("kernel", ["message_chain", "layer_node", "layer_edge"])
@pytest.mark.parametrize("H_,P_", [(64, 4), (128, 4), (256, 8)], ids=["H64-P4", "H128-P4",
                                                                      "H256-P8"])
def test_message_chain_and_layer_3xtf32_hold_the_float32_limit_at_width(width_graph, H_, P_,
                                                                         kernel):
    from test_torch_widths import (_inputs as width_inputs, _jax, _jax_layer, make_case,
                                   port_chain_weights as width_chain, port_mlp as width_mlp)

    c = make_case(width_graph, H_, H_, P_, 16)
    mlp = width_mlp(c)
    with torch.no_grad():
        cw = width_chain(c)
        if kernel == "message_chain":
            ops = mlp.operands(*width_inputs(c, torch.float32))
            per_i, per_j, h_E, idx, p_local, rot, trans, pg, mask, *msg_w = ops
            geom = geometry_edge_features(p_local, gather_nodes(pg, idx), rot, trans)
            args = (h_E, per_i, gather_nodes(per_j, idx), geom, mask, *msg_w, *cw)
            model, ref = edge_pass, _jax(c, "fold", "float32", False)
        else:
            per_i, pjg, h_E, geom, mask, *msg_w = mlp.feat_operands(
                *width_inputs(c, torch.float32))
            if kernel == "layer_node":
                mask_V = torch.ones(1, h_E.shape[1])
                mask_V[0, -3:] = 0.0
                args = (torch.from_numpy(c["h_V"]), per_i, pjg, h_E, geom, mask, mask_V,
                        *msg_w, *cw)
                model, ref = node_pass, _jax_layer(c, args, True)
            else:
                args = (h_E, per_i, pjg, geom, mask, *msg_w, *cw)
                model, ref = edge_pass, _jax_layer(c, args, False)
        got = model(*args, mm=tensor_cores(H_)).numpy()
        control = model(*args, mm=PLAIN_TF32).numpy()
    assert got.shape == ref.shape
    err, cerr = np.abs(got - ref).max(), np.abs(control - ref).max()
    assert err <= F32_TOL, err
    assert cerr > F32_TOL, cerr


@pytest.fixture(scope="module")
def width_graph():
    from test_torch_widths import graph

    return graph.__wrapped__()
