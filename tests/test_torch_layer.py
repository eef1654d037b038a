"""The port's whole-layer passes (kernel row 6: ``ops.layer.layer_node`` and
``layer_edge``, as their wrappers run them on CPU tensors) against the JAX
package's ``pallas_layer`` kernels on the same operands: float32 through
``_fused_pass`` in interpret mode (3e-5, the JAX package's fused-layer
bound); bf16 through the kernel bodies ``_node_kernel`` / ``_edge_kernel``
run eagerly (XLA:CPU drops bf16 round trips in a jitted call), max |d| <=
2^-6 and mean |d| <= 2^-16 of max|ref|.

Two controls must read worse: the port's version without its rounding
points (more than 4x the mean limit), and the port's message-then-chain
path, whose chain rounds the residual sum where the whole-layer kernels do
not (``x0 = rnd(h + rnd(m))`` against ``h + rnd(m)``): it reads several
times the sound version's mean difference, which shows that the test sees
that rounding point.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from packppi_tpu.ops.pallas_layer import _edge_kernel, _fused_pass, _node_kernel
from packppi_torch.models.ipmp import chain_weights
from packppi_torch.ops.chain import chain_plain
from packppi_torch.ops.layer import layer_edge, layer_edge_plain, layer_node, layer_node_plain
from packppi_torch.ops.message_feat import message_feat_plain

from test_torch_message_variants import (BF16_MAX_REL, BF16_MEAN_REL, H, K, L, P, _inputs,
                                         _Out, _readings, case, port_chain_weights,  # noqa: F401
                                         port_mlp)
from torch_threads import _threads  # noqa: F401 (autouse fixture)


def _operands(case, tdt, pool):
    """The port's pass operands: the message operands of ``feat_operands``
    in the stream dtype, the chain weights, and (node pass) h_V, mask_V."""
    mlp = port_mlp(case["params"])
    args = _inputs(case, tdt)
    with torch.no_grad():
        per_i, pjg, h_E, geom, mask, *msg_w = mlp.feat_operands(*args)
    cw = port_chain_weights(case["chain"])
    if pool:
        mask_V = torch.ones(1, L)
        mask_V[0, -3:] = 0.0                      # a few masked nodes
        return (args[0], per_i, pjg, h_E, geom, mask, mask_V, *msg_w, *cw)
    return (h_E, per_i, pjg, geom, mask, *msg_w, *cw)


def _jax_weights(case):
    """The pass's weights in ``fused_ipmp_layer``'s layout."""
    p, c = case["params"], case["chain"]
    w_e = p["Dense_e"]["kernel"]
    msg = (w_e[:H], w_e[H:], _row(p["Dense_e"]["bias"]), p["Dense_1"]["kernel"],
           _row(p["Dense_1"]["bias"]), p["Dense_2"]["kernel"], _row(p["Dense_2"]["bias"]))
    ln_a_s, ln_a_b, f1, f1b, f2, f2b, ln_b_s, ln_b_b = c
    chain = (_row(ln_a_s), _row(ln_a_b), f1, _row(f1b), f2, _row(f2b), _row(ln_b_s),
             _row(ln_b_b))
    return tuple(jnp.asarray(a, jnp.float32) for a in msg + chain)


def _row(a):
    return np.asarray(a, np.float32).reshape(1, -1)


def _j(t, dtype):
    return jnp.asarray(t.float().numpy()).astype(dtype)


def _jax(case, ops, dtype, pool, act="relu"):
    """The JAX pass on the port's operands: ``_fused_pass`` in interpret
    mode (float32) or the kernel body run eagerly (bf16)."""
    sd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    f32 = jnp.float32
    weights = _jax_weights(case)
    if pool:
        h_V, per_i, pjg, h_E, geom, mask, mask_V = ops[:7]
        x = _j(h_V[0], sd)
        he = _j(h_E[0], sd).reshape(L * K, H)
    else:
        h_E, per_i, pjg, geom, mask = ops[:5]
        x = he = _j(h_E[0], sd).reshape(L * K, H)
    pi = _j(per_i[0], f32)
    pj = _j(pjg[0], sd).reshape(L * K, H)
    gm = _j(geom[0], sd).reshape(L * K, 9 * P)
    ma = _j(mask[0], f32)
    mv = _j(mask_V[0], f32)[:, None] if pool else None
    kw = dict(K=K, act_name=act, compute_dtype=sd, stream_dtype=sd)
    if dtype == "float32":
        out = _fused_pass(x, pi, pj, he, gm, ma, mv, weights, pool=pool, blk=64,
                          interpret=True, **kw)
    else:
        out_ref = _Out((L, H) if pool else (L * K, H), sd)
        if pool:
            _node_kernel(x, pi, pj, he, gm, ma, mv, *weights, out_ref, **kw)
        else:
            _edge_kernel(he, pi, pj, gm, ma, *weights, out_ref, **kw)
        out = out_ref.value
    out = np.asarray(out.astype(f32))
    return out[None] if pool else out.reshape(1, L, K, H)


def _port(ops, pool):
    with torch.no_grad():
        return (layer_node if pool else layer_edge)(*ops)


def _two_kernel(ops, pool):
    """The message-then-chain path on the same operands: the chain rounds
    the residual sum."""
    with torch.no_grad():
        if pool:
            h_V, per_i, pjg, h_E, geom, mask, mask_V, *w = ops
            msg = message_feat_plain(per_i, pjg, h_E, geom, mask, *w[:6], True)
            return chain_plain(h_V.reshape(-1, H), msg.reshape(-1, H), mask_V.reshape(-1),
                               *w[6:], False).reshape(h_V.shape)
        h_E, per_i, pjg, geom, mask, *w = ops
        msg = message_feat_plain(per_i, pjg, h_E, geom, mask, *w[:6], False)
        return chain_plain(h_E.reshape(-1, H), msg.reshape(-1, H), mask.reshape(-1).float(),
                           *w[6:], True).reshape(h_E.shape)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("pool", [True, False], ids=["node", "edge"])
def test_layer_gelu_matches_pallas_kernel(case, pool, dtype):
    """Row 6 with ``act="gelu"`` in the message MLP and the chain's FFN, at
    the limits of the relu tests."""
    ops = _operands(case, {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype], pool)
    with torch.no_grad():
        ours = (layer_node if pool else layer_edge)(*ops, act="gelu")
    ref = _jax(case, ops, dtype, pool, "gelu")
    if dtype == "float32":
        np.testing.assert_allclose(ours.numpy(), ref, atol=3e-5, rtol=0)
    else:
        dmax, dmean = _readings(ours.float().numpy(), ref)
        assert dmax <= BF16_MAX_REL and dmean <= BF16_MEAN_REL, (dmax, dmean)
    assert np.abs(ref - _jax(case, ops, dtype, pool)).max() > 1e-2


@pytest.mark.parametrize("pool", [True, False], ids=["node", "edge"])
def test_layer_f32_matches_pallas_kernel(case, pool):
    ops = _operands(case, torch.float32, pool)
    ours = _port(ops, pool)
    assert ours.dtype == torch.float32
    assert ours.shape == ((1, L, H) if pool else (1, L, K, H))
    np.testing.assert_allclose(ours.numpy(), _jax(case, ops, "float32", pool), atol=3e-5, rtol=0)


@pytest.mark.parametrize("pool", [True, False], ids=["node", "edge"])
def test_layer_bf16_matches_pallas_kernel_body(case, pool):
    ops = _operands(case, torch.bfloat16, pool)
    ours = _port(ops, pool)
    assert ours.dtype == torch.bfloat16
    dmax, dmean = _readings(ours.float().numpy(), _jax(case, ops, "bfloat16", pool))
    assert dmax <= BF16_MAX_REL and dmean <= BF16_MEAN_REL, (dmax, dmean)


@pytest.mark.parametrize("pool", [True, False], ids=["node", "edge"])
def test_layer_bf16_tolerance_rejects_unrounded(case, pool):
    """The control: the plain version with no bf16 rounding point (float32
    operands, the output written in bf16)."""
    ops = _operands(case, torch.bfloat16, pool)
    up = tuple(t.float() if t.dtype == torch.bfloat16 else t for t in ops)
    with torch.no_grad():
        control = (layer_node_plain if pool else layer_edge_plain)(*up).bfloat16()
    _, dmean = _readings(control.float().numpy(), _jax(case, ops, "bfloat16", pool))
    assert dmean > 4 * BF16_MEAN_REL, dmean


@pytest.mark.parametrize("pool", [True, False], ids=["node", "edge"])
def test_layer_bf16_sees_the_unrounded_residual(case, pool):
    """The second control: the message-then-chain path (its chain rounds
    the residual sum) reads measurably worse against the whole-layer kernel
    body than the port's whole-layer pass does."""
    ops = _operands(case, torch.bfloat16, pool)
    ref = _jax(case, ops, "bfloat16", pool)
    _, sound = _readings(_port(ops, pool).float().numpy(), ref)
    _, rounded = _readings(_two_kernel(ops, pool).float().numpy(), ref)
    assert rounded > 4 * sound and rounded > 2.0 ** -24, (rounded, sound)


def test_wrappers_take_plain_versions_on_cpu(case):
    before = (layer_node.launches, layer_edge.launches)
    for pool, plain in ((True, layer_node_plain), (False, layer_edge_plain)):
        ops = _operands(case, torch.float32, pool)
        with torch.no_grad():
            torch.testing.assert_close(_port(ops, pool), plain(*ops), rtol=0, atol=0)
    assert (layer_node.launches, layer_edge.launches) == before


def test_chain_weights_order_matches_chain_operands():
    """``chain_weights`` gives the eight weights in the order the chain,
    folded-edge and whole-layer kernels take them."""
    from packppi_torch.models.ipmp import InvariantPointLayer, chain_operands

    layer = InvariantPointLayer()
    x = torch.zeros(2, H)
    ops = chain_operands(x, x, None, layer.norm[2], layer.edge_dense, layer.norm[3])
    assert all(a is b for a, b in zip(ops[3:], chain_weights(layer.norm[2], layer.edge_dense,
                                                               layer.norm[3])))
