"""The CUDA kernels against their plain versions on the card (marker
``gpu``; skipped without a CUDA device). This file imports neither JAX nor
``conftest``, so on a machine without JAX it runs as

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""
import os

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

H, P = 128, 8


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _message_operands(device, dtype, B=2, L=37, K=20, seed=0, H=H, He=H, P=P):
    """Random operands of odd sizes (partial last block, K not dividing 64)
    at widths H, He and P."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    rot, _ = torch.linalg.qr(r(B, L, 3, 3))
    idx = torch.randint(0, L, (B, L, K), generator=g)
    mask = (torch.rand(B, L, K, generator=g) > 0.1).float()
    p_local, trans = 3 * r(B, L, P, 3), 20 * r(B, L, 3)
    pg = torch.cat([(rot[..., i, None, :] * p_local).sum(-1) + trans[..., i, None]
                    for i in range(3)], -1)
    w = lambda o, i: r(o, i) / np.sqrt(i)
    ops = (r(B, L, H), r(B, L, H).to(dtype), r(B, L, K, He).to(dtype), idx, p_local,
           rot.contiguous(), trans, pg, mask, w(H, 2 * H + He + 9 * P), 0.1 * r(H),
           w(H, H), 0.1 * r(H), w(H, H), 0.1 * r(H))
    return tuple(t.to(device).contiguous() for t in ops)


def _chain_operands(device, dtype, msg_dtype, N=1000, seed=1, H=H):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    ops = (r(N, H).to(dtype), r(N, H).to(msg_dtype), (torch.rand(N, generator=g) > 0.2).float(),
           1 + 0.1 * r(H), 0.1 * r(H), r(4 * H, H) / np.sqrt(H), 0.1 * r(4 * H),
           r(H, 4 * H) / np.sqrt(4 * H), 0.1 * r(H), 1 + 0.1 * r(H), 0.1 * r(H))
    return tuple(t.to(device).contiguous() for t in ops)


def _close(got, want, dtype, mean_rel=2.0 ** -16):
    """float32: max |d| <= 1e-4. bf16, relative to max|ref| (chip_smoke.py's
    limits): max |d| <= 2^-6 rejects a dropped block's rows, mean |d| <=
    2^-16 rejects a kernel without the plain version's rounding points
    (``mean_rel``: 2^-15 at other widths, WIDTH_MEAN_REL)."""
    d = (got.float() - want.float()).abs()
    scale = want.float().abs().max().item()
    assert torch.isfinite(got.float()).all()
    if dtype == torch.float32:
        assert d.max().item() <= 1e-4
    else:
        assert d.max().item() <= 2.0 ** -6 * scale and d.mean().item() <= mean_rel * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("pool", [True, False], ids=["pool", "edge"])
def test_message_kernel_matches_plain(cuda, dtype, pool):
    from packppi_torch.ops.message import message, message_plain

    ops = _message_operands(cuda, dtype)
    before = message.launches
    got = message(*ops, pool)
    torch.cuda.synchronize()
    assert message.launches == before + 1
    assert got.dtype == (torch.float32 if pool else dtype)
    _close(got, message_plain(*ops, pool), dtype)


@pytest.mark.parametrize("dtype,msg_dtype", [(torch.float32, torch.float32),
                                             (torch.bfloat16, torch.float32),
                                             (torch.bfloat16, torch.bfloat16)],
                         ids=["f32", "bf16-f32msg", "bf16"])
@pytest.mark.parametrize("pre_mask", [False, True], ids=["node", "edge"])
def test_chain_kernel_matches_plain(cuda, dtype, msg_dtype, pre_mask):
    from packppi_torch.ops.chain import chain, chain_plain

    ops = _chain_operands(cuda, dtype, msg_dtype)
    before = chain.launches
    got = chain(*ops, pre_mask)
    torch.cuda.synchronize()
    assert chain.launches == before + 1
    _close(got, chain_plain(*ops, pre_mask), dtype)


@pytest.mark.parametrize("dtype,msg_dtype", [(torch.float32, torch.float32),
                                             (torch.bfloat16, torch.float32),
                                             (torch.bfloat16, torch.bfloat16)],
                         ids=["f32", "bf16-f32msg", "bf16"])
@pytest.mark.parametrize("pre_mask", [False, True], ids=["node", "edge"])
@pytest.mark.parametrize("N", [1, 127, 128, 129, 768, 8384, 8385, 8447, 8448, 8449, 9000,
                               23712, 24576])
def test_chain_kernel_at_tile_edges(cuda, N, dtype, msg_dtype, pre_mask):
    """Row counts at the edges of the kernel's row tiles and of the choices
    made from N (on 132 SMs: bf16 splits a tile's hidden between four
    warpgroups up to 8,384 rows, float32 takes 64-row tiles from 8,448),
    ragged last tiles (9,000; 23,712, T1124's 741 x 32 edges unpadded) and
    T1124's padded node and edge passes; two launches give the same bits."""
    from packppi_torch.ops.chain import chain, chain_plain

    ops = _chain_operands(cuda, dtype, msg_dtype, N=N, seed=N)
    got = chain(*ops, pre_mask)
    torch.cuda.synchronize()
    _close(got, chain_plain(*ops, pre_mask), dtype)
    assert torch.equal(got, chain(*ops, pre_mask))


def test_chain_bf16_follows_weights_written_in_place(cuda):
    """The bf16 kernel reads a packed copy of W1 and W2, made again when
    either is written in place (as an optimizer step writes it)."""
    from packppi_torch.ops.chain import chain, chain_plain

    ops = _chain_operands(cuda, torch.bfloat16, torch.bfloat16, N=300)
    first = chain(*ops, True)
    with torch.no_grad():
        ops[5].mul_(-1.0)                                   # W1
    got = chain(*ops, True)
    _close(got, chain_plain(*ops, True), torch.bfloat16)
    assert not torch.equal(got, first)


def _message_feat_operands(device, dtype, B=2, L=37, K=20, seed=3, H=H, He=H, P=P):
    """Random operands of odd sizes (partial last block, K not dividing 64)
    at widths H, He and P."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    w = lambda o, i: r(o, i) / np.sqrt(i)
    mask = (torch.rand(B, L, K, generator=g) > 0.1).float()
    ops = (r(B, L, H), r(B, L, K, H).to(dtype), r(B, L, K, He).to(dtype),
           (3 * r(B, L, K, 9 * P)).to(dtype), mask, w(H, 2 * H + He + 9 * P), 0.1 * r(H),
           w(H, H), 0.1 * r(H), w(H, H), 0.1 * r(H))
    return tuple(t.to(device).contiguous() for t in ops)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("pool", [True, False], ids=["pool", "edge"])
def test_message_feat_kernel_matches_plain(cuda, dtype, pool):
    from packppi_torch.ops.message_feat import message_feat, message_feat_plain

    ops = _message_feat_operands(cuda, dtype)
    before = message_feat.launches
    got = message_feat(*ops, pool)
    torch.cuda.synchronize()
    assert message_feat.launches == before + 1
    assert got.dtype == (torch.float32 if pool else dtype)
    _close(got, message_feat_plain(*ops, pool), dtype)


def _function_grads(fn, ops, diff):
    """Gradients of 0.5 * sum(fn(ops)^2) with respect to ``ops[i]``, i in diff."""
    leaves = [t.detach().clone().requires_grad_(True) if i in diff else t
              for i, t in enumerate(ops)]
    out = fn(*leaves)
    return torch.autograd.grad(0.5 * out.float().pow(2).sum(), [leaves[i] for i in diff])


def _grads_close(got, want):
    """Each gradient within 5e-4 of its max (the limit of the JAX package's
    fused-vs-unfused gradient tests)."""
    for g, w in zip(got, want):
        assert torch.isfinite(g).all() and g.dtype == w.dtype
        assert (g.float() - w.float()).abs().max().item() <= 5e-4 * w.float().abs().max().item()


@pytest.mark.parametrize("pool", [True, False], ids=["pool", "edge"])
def test_message_feat_gradients_match_autograd_through_plain(cuda, pool):
    """Kernel forward, recomputed plain backward, against autograd through
    the plain version: every operand but the mask."""
    from packppi_torch.ops.message_feat import message_feat, message_feat_plain

    ops = _message_feat_operands(cuda, torch.float32)
    diff = [i for i in range(len(ops)) if i != 4]
    before = message_feat.launches
    got = _function_grads(lambda *a: message_feat(*a, pool), ops, diff)
    assert message_feat.launches == before + 1               # the forward, once; no more
    _grads_close(got, _function_grads(lambda *a: message_feat_plain(*a, pool), ops, diff))


@pytest.mark.parametrize("pre_mask", [False, True], ids=["node", "edge"])
def test_chain_gradients_match_autograd_through_plain(cuda, pre_mask):
    from packppi_torch.ops.chain import chain, chain_plain

    ops = _chain_operands(cuda, torch.float32, torch.float32)
    diff = [i for i in range(len(ops)) if i != 2]
    before = chain.launches
    got = _function_grads(lambda *a: chain(*a, pre_mask), ops, diff)
    assert chain.launches == before + 1
    _grads_close(got, _function_grads(lambda *a: chain_plain(*a, pre_mask), ops, diff))
    assert not got[0][ops[2] == 0].any()                     # masked rows: no gradient into x


def test_kernels_pass_a_nan_on_as_their_plain_versions_do(cuda):
    """A non-finite input must reach the loss (the training step skips such a
    batch): the kernels' relu may not turn a NaN into 0."""
    from packppi_torch.ops.chain import chain
    from packppi_torch.ops.message import message
    from packppi_torch.ops.message_feat import message_feat

    ops = list(_message_feat_operands(cuda, torch.float32))
    ops[2][1, 5, 3, 7] = float("nan")                       # one h_E entry of edge (1, 5, 3)
    edge, node = message_feat(*ops, False), message_feat(*ops, True)
    assert edge[1, 5, 3].isnan().all() and node[1, 5].isnan().all()
    assert edge.isnan().sum().item() == H and node.isnan().sum().item() == H
    mops = list(_message_operands(cuda, torch.float32))
    mops[2][0, 2, 1, 0] = float("nan")
    assert message(*mops, False)[0, 2, 1].isnan().all()
    cops = list(_chain_operands(cuda, torch.float32, torch.float32))
    cops[1][4, 9] = float("nan")                            # one message entry of row 4
    cops[2][4] = 1.0
    out = chain(*cops, False)
    assert out[4].isnan().all() and out.isnan().sum().item() == H


def test_message_feat_kernel_refuses_what_it_does_not_take(cuda):
    from packppi_torch.ops.message_feat import message_feat

    ops = list(_message_feat_operands(cuda, torch.float32))
    ops[3] = ops[3][..., :64].contiguous()                  # 9 features a point
    with pytest.raises(ValueError, match="geometry features"):
        message_feat(*ops, True)
    ops = list(_message_feat_operands(cuda, torch.float32))
    ops[0] = ops[0].double()                                # per_i must be float32
    with pytest.raises(TypeError, match="per_i"):
        message_feat(*ops, True)


def _tc_message_case(kernel, device, dtype, **shape):
    """(wrapper, plain version, operands) of one of the four kernels on
    the tensor-core message body."""
    from packppi_torch.ops.message import (message, message_gather, message_geom,
                                           message_geom_plain, message_plain)
    from packppi_torch.ops.message_feat import message_feat, message_feat_plain

    if kernel == "message_feat":
        return message_feat, message_feat_plain, _message_feat_operands(device, dtype, **shape)
    if kernel == "message_geom":
        return (message_geom, message_geom_plain,
                _geom_operands(_message_operands(device, dtype, **shape)))
    fn = message if kernel == "message" else message_gather
    return fn, message_plain, _message_operands(device, dtype, **shape)


TC_KERNELS = ["message", "message_gather", "message_feat", "message_geom"]


@pytest.mark.parametrize("K", [16, 20, 24, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("pool", [True, False], ids=["pool", "edge"])
@pytest.mark.parametrize("kernel", TC_KERNELS)
def test_tensor_core_message_kernels_match_plain(cuda, kernel, pool, dtype, K):
    """B = 2, L = 37: every K leaves a partial last tile (or, at K = 64,
    one node a tile); K = 20 and 24 leave rows of each tile unused."""
    fn, plain, ops = _tc_message_case(kernel, cuda, dtype, K=K)
    before = fn.launches
    got = fn(*ops, pool)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert got.dtype == (torch.float32 if pool else dtype)
    assert got.shape == ((2, 37, H) if pool else (2, 37, K, H))
    _close(got, plain(*ops, pool), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("pool", [True, False], ids=["pool", "edge"])
def test_message_gather_kernel_at_eleven_copies_of_t1124_length(cuda, pool, dtype):
    """L = 8,151 (11 x T1124), K = 32, B = 1."""
    fn, plain, ops = _tc_message_case("message_gather", cuda, dtype, B=1, L=8151, K=32)
    got = fn(*ops, pool)
    torch.cuda.synchronize()
    _close(got, plain(*ops, pool), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("pool", [True, False], ids=["pool", "edge"])
@pytest.mark.parametrize("kernel", TC_KERNELS)
def test_tensor_core_message_kernels_repeat_their_bits(cuda, kernel, pool, dtype):
    fn, _, ops = _tc_message_case(kernel, cuda, dtype)
    assert torch.equal(fn(*ops, pool), fn(*ops, pool))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel", TC_KERNELS)
def test_tensor_core_message_kernels_pass_a_nan_on(cuda, kernel, dtype):
    """One NaN h_E entry of edge (1, 5, 3): that edge's message and its
    node's pooled message are NaN, nothing else is."""
    fn, _, ops = _tc_message_case(kernel, cuda, dtype)
    ops = list(ops)
    ops[2][1, 5, 3, 7] = float("nan")
    edge, node = fn(*ops, False), fn(*ops, True)
    assert edge[1, 5, 3].isnan().all() and node[1, 5].isnan().all()
    assert edge.isnan().sum().item() == H and node.isnan().sum().item() == H


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel", TC_KERNELS)
def test_tensor_core_message_kernels_follow_weights_written_in_place(cuda, kernel, dtype):
    """The kernels read a packed copy of W_in, W_1 and W_2, made again when
    any of them is written in place (as an optimizer step writes it)."""
    fn, plain, ops = _tc_message_case(kernel, cuda, dtype)
    at = {"message_feat": 7, "message_geom": 10}.get(kernel, 11)       # w_mid
    first = fn(*ops, False)
    with torch.no_grad():
        ops[at].mul_(-1.0)
    got = fn(*ops, False)
    _close(got, plain(*ops, False), dtype)
    assert not torch.equal(got, first)


def test_kernels_refuse_what_they_do_not_take(cuda):
    from packppi_torch.ops.chain import chain
    from packppi_torch.ops.message import message

    ops = list(_message_operands(cuda, torch.float32))
    ops[3] = ops[3].int()                                   # idx must be int64
    with pytest.raises(TypeError, match="idx"):
        message(*ops, True)
    cops = _chain_operands(cuda, torch.float32, torch.float32, H=48)
    with pytest.raises(ValueError, match="hidden_dim=48"):   # H: a multiple of 32
        chain(*cops, False)


def _chain_weights(device, seed=4, H=H):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    w = (1 + 0.1 * r(H), 0.1 * r(H), r(4 * H, H) / np.sqrt(H), 0.1 * r(4 * H),
         r(H, 4 * H) / np.sqrt(4 * H), 0.1 * r(H), 1 + 0.1 * r(H), 0.1 * r(H))
    return tuple(t.to(device).contiguous() for t in w)


def _geom_operands(ops):
    """``message``'s operands gathered for ``message_geom``: the neighbour
    term and global-point planes per edge, the local planes, R row-major."""
    from packppi_torch.ops.graph import gather_nodes

    per_i, per_j, h_E, idx, p_local, rot, trans, pg, mask, *w = ops
    B, L = idx.shape[:2]
    pl = torch.cat([p_local[..., 0], p_local[..., 1], p_local[..., 2]], -1).contiguous()
    return (per_i, gather_nodes(per_j, idx).contiguous(), h_E, pl,
            gather_nodes(pg, idx).contiguous(), rot.reshape(B, L, 9).contiguous(), trans, mask,
            *w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("pool", [True, False], ids=["pool", "edge"])
def test_message_geom_and_gather_kernels_match_plain(cuda, dtype, pool):
    """B = 2, L = 37, K = 20: a partial last block, K no divisor of 64."""
    from packppi_torch.ops.message import (message, message_gather, message_geom,
                                           message_geom_plain, message_plain)

    ops = _message_operands(cuda, dtype)
    gops = _geom_operands(ops)
    before = (message_geom.launches, message_gather.launches)
    geom, gather = message_geom(*gops, pool), message_gather(*ops, pool)
    torch.cuda.synchronize()
    assert (message_geom.launches, message_gather.launches) == (before[0] + 1, before[1] + 1)
    assert geom.dtype == gather.dtype == (torch.float32 if pool else dtype)
    _close(geom, message_geom_plain(*gops, pool), dtype)
    _close(gather, message_plain(*ops, pool), dtype)
    _close(geom, message(*ops, pool), dtype)            # one function, three routes
    assert torch.equal(gather, message(*ops, pool))     # one body, two instantiations


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("K", [20, 24])
def test_message_chain_kernel_matches_plain_and_two_kernels(cuda, dtype, K):
    from packppi_torch.ops.chain import chain
    from packppi_torch.ops.message import message, message_chain, message_chain_plain

    ops = _message_operands(cuda, dtype, K=K)
    cw = _chain_weights(cuda)
    before = message_chain.launches
    got = message_chain(*ops, *cw)
    torch.cuda.synchronize()
    assert message_chain.launches == before + 1 and got.dtype == dtype
    _close(got, message_chain_plain(*ops, *cw), dtype)
    msg = message(*ops, False)
    two = chain(ops[2].reshape(-1, H), msg.reshape(-1, H), ops[8].reshape(-1), *cw, True)
    # the two-kernel path: at this shape (24 tiles, fewer than the card's
    # SMs) the chain kernel takes four warpgroups a bf16 tile and 16-row
    # float32 tiles, another form of the chain than the fold's, so the two
    # agree within the kernels' limits; test_fold_equals_message_then_chain
    # holds their bits where both run the same form
    _close(got.reshape(-1, H), two, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fold_equals_message_then_chain_bit_for_bit(cuda, dtype):
    """B = 1, L = 768, K = 32 (T1124's edge pass: 384 tiles of 64 rows):
    the chain kernel runs one warpgroup a bf16 tile and 64-row float32
    tiles, the fold's own form of the one chain body, so message then chain
    gives the fold's bits."""
    from packppi_torch.ops.chain import chain
    from packppi_torch.ops.message import message, message_chain

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    ops = _message_operands(cuda, dtype, B=1, L=768, K=32)
    assert 768 * 32 // 64 >= sms and 768 * 32 >= 64 * sms     # chain.cu's KS = 1 and R = 64
    cw = _chain_weights(cuda)
    got = message_chain(*ops, *cw)
    msg = message(*ops, False)
    two = chain(ops[2].reshape(-1, H), msg.reshape(-1, H), ops[8].reshape(-1), *cw, True)
    torch.cuda.synchronize()
    assert torch.equal(got.reshape(-1, H), two)


def _layer_operands(device, dtype, pool):
    ops = _message_feat_operands(device, dtype)
    per_i, pj, h_E, geom, mask, *w = ops
    cw = _chain_weights(device)
    if not pool:
        return (h_E, per_i, pj, geom, mask, *w, *cw)
    g = torch.Generator().manual_seed(6)
    B, L = per_i.shape[:2]
    h_V = torch.randn(B, L, H, generator=g).to(device, dtype)
    mask_V = (torch.rand(B, L, generator=g) > 0.1).float().to(device)
    return (h_V, per_i, pj, h_E, geom, mask, mask_V, *w, *cw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("pool", [True, False], ids=["node", "edge"])
def test_layer_kernels_match_plain(cuda, dtype, pool):
    """B = 2, L = 37, K = 20; the node pass at three blockings, bit for bit."""
    from packppi_torch.ops.layer import layer_edge, layer_edge_plain, layer_node, layer_node_plain

    ops = _layer_operands(cuda, dtype, pool)
    fn, plain = (layer_node, layer_node_plain) if pool else (layer_edge, layer_edge_plain)
    before = fn.launches
    got = fn(*ops)
    torch.cuda.synchronize()
    assert fn.launches == before + 1 and got.dtype == dtype
    _close(got, plain(*ops), dtype)
    if pool:
        for npb in (1, 3, 16):
            assert torch.equal(layer_node(*ops, nodes_per_block=npb), got)
        with pytest.raises(ValueError, match="nodes_per_block"):
            layer_node(*ops, nodes_per_block=17)


def _fused_case(kernel, device, dtype):
    """(wrapper, plain version, operands, index of h_E, of W_1 (w_mid), of
    the chain's W1) of one of the three kernels that run a message tile and
    then the chain."""
    from packppi_torch.ops.layer import layer_edge, layer_edge_plain, layer_node, layer_node_plain
    from packppi_torch.ops.message import message_chain, message_chain_plain

    if kernel == "message_chain":
        ops = (*_message_operands(device, dtype), *_chain_weights(device))
        return message_chain, message_chain_plain, ops, 2, 11, 17
    pool = kernel == "layer_node"
    ops = _layer_operands(device, dtype, pool)
    if pool:
        return layer_node, layer_node_plain, ops, 3, 9, 15
    return layer_edge, layer_edge_plain, ops, 0, 7, 13


FUSED_KERNELS = ["message_chain", "layer_node", "layer_edge"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel", FUSED_KERNELS)
def test_message_chain_and_layer_kernels_repeat_their_bits(cuda, kernel, dtype):
    fn, _, ops, *_ = _fused_case(kernel, cuda, dtype)
    assert torch.equal(fn(*ops), fn(*ops))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel", FUSED_KERNELS)
def test_message_chain_and_layer_kernels_pass_a_nan_on(cuda, kernel, dtype):
    """One NaN h_E entry of edge (1, 5, 3): that edge's new h_E row (the
    edge passes) or its node's new h_V row (the node pass) is NaN, nothing
    else is."""
    fn, _, ops, at_he, *_ = _fused_case(kernel, cuda, dtype)
    ops = list(ops)
    ops[at_he][1, 5, 3, 7] = float("nan")
    got = fn(*ops)
    row = got[1, 5] if kernel == "layer_node" else got[1, 5, 3]
    assert row.isnan().all() and got.isnan().sum().item() == H


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel", FUSED_KERNELS)
def test_message_chain_and_layer_kernels_follow_weights_written_in_place(cuda, kernel, dtype):
    """The kernels read packed copies of the message weights and (bf16) of
    the chain's W1 and W2, made again when one of them is written in place
    (as an optimizer step writes it)."""
    fn, plain, ops, _, at_w_mid, at_w1 = _fused_case(kernel, cuda, dtype)
    for at in (at_w_mid, at_w1):
        first = fn(*ops)
        with torch.no_grad():
            ops[at].mul_(-1.0)
        got = fn(*ops)
        _close(got, plain(*ops), dtype)
        assert not torch.equal(got, first)


ACTS = ["relu", "gelu", "elu", "selu", "celu", "leaky_relu", "silu", "sigmoid"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("pool", [True, False], ids=["pool", "edge"])
@pytest.mark.parametrize("act", ACTS)
def test_message_kernel_takes_every_activation(cuda, act, pool, dtype):
    """Each activation's message library against its plain version; a
    non-relu library gives other values than relu's."""
    from packppi_torch.ops.message import message, message_plain

    ops = _message_operands(cuda, dtype)
    before = message.launches
    got = message(*ops, pool, act)
    torch.cuda.synchronize()
    assert message.launches == before + 1
    _close(got, message_plain(*ops, pool, act), dtype)
    if act != "relu":
        assert not torch.equal(got, message(*ops, pool))


@pytest.mark.parametrize("dtype,msg_dtype", [(torch.float32, torch.float32),
                                             (torch.bfloat16, torch.bfloat16)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("pre_mask", [False, True], ids=["node", "edge"])
@pytest.mark.parametrize("act", ACTS)
def test_chain_kernel_takes_every_activation(cuda, act, pre_mask, dtype, msg_dtype):
    from packppi_torch.ops.chain import chain, chain_plain

    ops = _chain_operands(cuda, dtype, msg_dtype)
    got = chain(*ops, pre_mask, act)
    torch.cuda.synchronize()
    _close(got, chain_plain(*ops, pre_mask, act), dtype)
    if act != "relu":
        assert not torch.equal(got, chain(*ops, pre_mask))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel", TC_KERNELS + FUSED_KERNELS)
def test_every_message_kernel_takes_gelu(cuda, kernel, dtype):
    """Rows 1, 5, 3, 4 (pool and edge) and 1b, 6 with gelu."""
    if kernel in FUSED_KERNELS:
        fn, plain, ops, *_ = _fused_case(kernel, cuda, dtype)
        _close(fn(*ops, act="gelu"), plain(*ops, act="gelu"), dtype)
        return
    fn, plain, ops = _tc_message_case(kernel, cuda, dtype)
    for pool in (True, False):
        _close(fn(*ops, pool, "gelu"), plain(*ops, pool, "gelu"), dtype)


@pytest.mark.parametrize("act", ["gelu", "elu", "selu", "celu", "leaky_relu", "silu"])
def test_activation_kernels_pass_a_nan_on(cuda, act):
    """As relu's: one NaN h_E entry makes that edge's message NaN."""
    from packppi_torch.ops.chain import chain
    from packppi_torch.ops.message import message

    ops = list(_message_operands(cuda, torch.bfloat16))
    ops[2][1, 5, 3, 7] = float("nan")
    edge = message(*ops, False, act)
    assert edge[1, 5, 3].isnan().all() and edge.isnan().sum().item() == H
    cops = list(_chain_operands(cuda, torch.float32, torch.float32))
    cops[1][3, 7] = float("nan")
    got = chain(*cops, False, act)
    assert got[3].isnan().all() and got.isnan().sum().item() == H


def test_relu_build_is_the_flagless_build(cuda):
    """relu is the library built with no activation flag: "chain@relu"
    (built with -DPACKPPI_ACT=0) gives the same bits, and an unknown
    activation is refused before any build."""
    import ctypes

    from packppi_torch.ops import _build
    from packppi_torch.ops.chain import _lib, chain, packed_chain_weights

    assert _build.lib_name("chain", "relu") == "chain"
    with pytest.raises(ValueError, match="activation"):
        chain(*_chain_operands(cuda, torch.float32, torch.float32), False, "tanh")
    with pytest.raises(ValueError, match="takes no activation"):
        _build.lib_name("clash", "gelu")
    for dtype in (torch.float32, torch.bfloat16):
        ops = _chain_operands(cuda, dtype, dtype)
        want = chain(*ops, True)
        flagged = _build.load_library("chain@relu")
        flagged.packppi_chain.argtypes = _lib().packppi_chain.argtypes
        x, msg, mask, *w = ops
        out = torch.empty_like(x)
        err = flagged.packppi_chain(
            *(_build.ptr(t) for t in (x, msg, mask, *w, packed_chain_weights(w[2], w[4], dtype),
                                      out)),
            x.shape[0], int(dtype == torch.bfloat16), int(dtype == torch.bfloat16), 1,
            _build.stream_ptr(x.device))
        assert err == 0
        torch.cuda.synchronize()
        assert torch.equal(out, want)
        assert isinstance(flagged, ctypes.CDLL)


def _clash_operands(device, B=2, L=23, seed=2):
    """A random crowded cloud: B complexes of L residues in a small box (so
    many pairs overlap), some atoms absent, residue indices with a chain
    break, a length that is no multiple of the kernel's tiles."""
    g = torch.Generator().manual_seed(seed)
    pos = 9.0 * torch.rand(B, L, 14, 3, generator=g)
    exists = (torch.rand(B, L, 14, generator=g) > 0.25).float()
    exists[:, :, :4] = 1.0
    radius = (1.5 + 0.3 * torch.rand(B, L, 14, generator=g)) * exists
    ridx = torch.arange(L)[None].repeat(B, 1)
    ridx[:, L // 2:] += 200
    return tuple(t.to(device).contiguous() for t in (pos, exists, radius, ridx))


def test_clash_kernels_match_plain(cuda):
    from packppi_torch.ops.clash import between_residue_clash, between_residue_clash_plain

    ops = _clash_operands(cuda)
    w = torch.rand(ops[1].shape, generator=torch.Generator().manual_seed(3)).to(cuda) * ops[1]
    before = (between_residue_clash.launches_fwd, between_residue_clash.launches_bwd)
    pos = ops[0].clone().requires_grad_(True)
    got = between_residue_clash(pos, *ops[1:], 0.5)
    (got * w).sum().backward()
    torch.cuda.synchronize()
    assert (between_residue_clash.launches_fwd, between_residue_clash.launches_bwd) == (
        before[0] + 1, before[1] + 1)
    ref_pos = ops[0].clone().requires_grad_(True)
    want = between_residue_clash_plain(ref_pos, *ops[1:], 0.5)["per_atom_loss_sum"]
    (want * w).sum().backward()
    assert want.sum().item() > 1.0 and ref_pos.grad.abs().sum().item() > 1e-3
    assert (got - want).abs().max().item() <= 1e-5
    assert (pos.grad - ref_pos.grad).abs().max().item() <= 2e-5


def _strung_clash_operands(device, L=300):
    """The crowded cloud with its residues strung along x, 4 A apart, as a
    chain is: tiles far apart in sequence are far apart in space."""
    pos, exists, radius, ridx = _clash_operands(device, B=1, L=L)
    pos = pos + 4.0 * torch.arange(L, device=device)[None, :, None, None] * torch.tensor(
        [1.0, 0.0, 0.0], device=device)
    return pos.contiguous(), exists, radius, ridx


def test_clash_kernels_are_deterministic_and_culling_is_exact(cuda):
    from packppi_torch.ops.clash import clash_backward_cuda, clash_forward_cuda

    pos, exists, radius, ridx = _strung_clash_operands(cuda)
    w = torch.rand(exists.shape, generator=torch.Generator().manual_seed(4)).to(cuda)
    a, culling = clash_forward_cuda(pos, exists, radius, ridx, 0.5)
    b, _ = clash_forward_cuda(pos, exists, radius, ridx, 0.5, cull=False)
    c, _ = clash_forward_cuda(pos, exists, radius, ridx, 0.5)
    ga = clash_backward_cuda(pos, exists, radius, ridx, w, 0.5, culling=culling)
    gb = clash_backward_cuda(pos, exists, radius, ridx, w, 0.5, cull=False)
    gc = clash_backward_cuda(pos, exists, radius, ridx, w, 0.5)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(a, c) and torch.equal(ga, gb) and torch.equal(ga, gc)
    assert a.sum().item() > 0
    T = -(-14 * 300 // 32)
    assert 0 < culling.counts.sum().item() < T * T                # some tiles culled, not all


@pytest.mark.parametrize("case", ["strung", "crowded"])
def test_clash_kernel_lists_equal_the_plain_culling(cuda, case):
    """The packing kernel's boxes and the forward's lists, bit for bit, as
    ``clash_tiles_plain`` makes them on the same tensors; culling off lists
    every tile."""
    from packppi_torch.ops.clash import clash_forward_cuda, clash_tiles_plain

    ops = _strung_clash_operands(cuda) if case == "strung" else _clash_operands(cuda)
    for cull in (True, False):
        _, culling = clash_forward_cuda(*ops, 0.5, cull=cull)
        boxes, tiles, counts = clash_tiles_plain(*ops[:3], 0.5, cull=cull)
        torch.cuda.synchronize()
        assert torch.equal(culling.boxes, boxes) and torch.equal(culling.counts, counts)
        n = torch.arange(tiles.shape[-1], device=cuda) < counts[..., None]
        assert torch.equal(culling.tiles[n], tiles[n])
        rec = culling.records.reshape(*ops[1].shape, 4)
        ex = ops[1][..., None] != 0
        assert torch.equal(torch.where(ex, rec, 0.0),
                           torch.where(ex, torch.cat([ops[0], ops[2][..., None]], -1), 0.0))
        keys = culling.keys.reshape(*ops[1].shape, 2)
        assert torch.equal(keys[..., 0], ops[3][..., None].int().expand_as(ops[1]))
        assert torch.equal(keys[..., 1].view(torch.float32), ops[1])


def test_clash_kernel_lists_cover_every_overlapping_pair(cuda):
    """Every tile pair holding an overlapping pair is listed, and the kernel's
    sums equal the plain sums over the listed tile pairs alone."""
    from packppi_torch.ops.clash import clash_forward_cuda, listed_tile_pairs, tiled_clash_plain

    ops = _strung_clash_operands(cuda)
    got, culling = clash_forward_cuda(*ops, 0.5)
    listed = listed_tile_pairs(culling.tiles, culling.counts)
    full, overlap = tiled_clash_plain(*ops, 0.5)
    over_listed, _ = tiled_clash_plain(*ops, 0.5, culling.tiles, culling.counts)
    assert overlap.sum().item() > 10 and not (overlap & ~listed).any()
    assert torch.equal(over_listed, full)
    assert (got - full).abs().max().item() <= 1e-5


def test_clash_gradient_matches_finite_differences(cuda):
    """The gradient kernel against central differences of the forward kernel
    on a tiny input. The loss is piecewise smooth: a pair whose overlap
    begins or ends within the step puts a kink into the difference, so three
    quarters of the sampled coordinates must agree (float32 forward, step
    1e-3: differences resolve about 1e-2) and none may be off by more than
    one pair's whole weight."""
    from packppi_torch.ops.clash import clash_backward_cuda, clash_forward_cuda

    pos, exists, radius, ridx = _clash_operands(cuda, B=1, L=5, seed=5)
    pos = pos * 0.6
    w = torch.rand(exists.shape, generator=torch.Generator().manual_seed(6)).to(cuda)
    grad = clash_backward_cuda(pos, exists, radius, ridx, w, 0.5)
    loss = lambda p: (clash_forward_cuda(p, exists, radius, ridx, 0.5)[0].double() * w).sum()
    h, errs = 1e-3, []
    flat = pos.reshape(-1)
    for i in torch.randperm(flat.numel(), generator=torch.Generator().manual_seed(7))[:60]:
        if exists.reshape(-1)[i // 3] == 0:
            continue
        up, down = flat.clone(), flat.clone()
        up[i] += h
        down[i] -= h
        fd = (loss(up.reshape(pos.shape)) - loss(down.reshape(pos.shape))).item() / (2 * h)
        errs.append(abs(fd - grad.reshape(-1)[i].item()))
    errs = np.sort(errs)
    assert len(errs) > 20 and grad.abs().sum().item() > 1.0
    assert errs[int(0.75 * len(errs))] <= 2e-2 and errs[-1] <= 2.0, errs


def test_clash_kernel_refuses_what_it_does_not_take(cuda):
    from packppi_torch.ops.clash import between_residue_clash

    ops = list(_clash_operands(cuda))
    with pytest.raises(TypeError, match="residue_index"):
        between_residue_clash(ops[0], ops[1], ops[2], ops[3].int(), 0.5)
    with pytest.raises(TypeError, match="float32"):
        between_residue_clash(ops[0].double(), *ops[1:], 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        between_residue_clash(ops[0].transpose(0, 1).contiguous().transpose(0, 1), *ops[1:], 0.5)


def _mha_operands(device, dtype, B, H, T, D, pad=5, seed=8):
    """q scaled by D^-0.5 as ESM-2 scales it; the last ``pad`` keys padded."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, H, T, D, generator=g) for _ in range(3))
    bias = torch.zeros(B, T)
    bias[:, T - pad:] = -1e9
    return (*(t.to(dtype).to(device).contiguous() for t in (q * D ** -0.5, k, v)),
            bias.to(device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(1, 3, 763, 64), (2, 2, 100, 16), (1, 2, 37, 32),
                                   (1, 1, 200, 128)], ids=["ragged", "d16", "short", "d128"])
def test_mha_kernel_matches_plain(cuda, dtype, shape):
    """float32: max |d| <= 1e-5; bf16: the limits of the other kernels,
    relative to max|ref|."""
    from packppi_torch.ops.attention import mha, mha_plain

    ops = _mha_operands(cuda, dtype, *shape)
    before = mha.launches
    got = mha(*ops)
    torch.cuda.synchronize()
    assert mha.launches == before + 1 and got.dtype == torch.float32
    want = mha_plain(*ops)
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 1e-5
    else:
        _close(got, want, dtype)
    assert torch.equal(got, mha(*ops))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("T", [1, 63, 64, 65, 896])
def test_mha_kernel_at_tile_edges(cuda, T, D, dtype):
    """Lengths at the edges of the 64-row query and key tiles, and ESM-2's
    T1124 length, at every head width; two launches give the same bits."""
    from packppi_torch.ops.attention import mha, mha_plain

    ops = _mha_operands(cuda, dtype, 1, 2, T, D, pad=T // 8, seed=T + D)
    got = mha(*ops)
    torch.cuda.synchronize()
    want = mha_plain(*ops)
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 1e-5
    else:
        _close(got, want, dtype)
    assert torch.equal(got, mha(*ops))


def test_mha_kernel_refuses_what_it_does_not_take(cuda):
    from packppi_torch.ops.attention import mha

    q, k, v, bias = _mha_operands(cuda, torch.float32, 1, 2, 40, 48)
    with pytest.raises(ValueError, match="head width"):
        mha(q, k, v, bias)
    q, k, v, bias = _mha_operands(cuda, torch.float32, 1, 2, 40, 64)
    with pytest.raises(TypeError, match="bfloat16"):
        mha(q.half(), k.half(), v.half(), bias)
    with pytest.raises(TypeError, match="key_bias"):
        mha(q, k, v, bias.double())
    with pytest.raises(ValueError, match="contiguous"):
        mha(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, bias)


FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _mixed_bucket(device, copies_of=None):
    """Directory mode's mixed-length chunk at a small size: crops of 1BRS and
    2FTL of 72 and 96 residues padded to bucket 96, the tail row a repeat of
    the last member, and each member alone at B = 1 padded to the same
    bucket; with ``copies_of=r`` the chunk's rows all hold row r's
    complex."""
    from packppi_torch.data import stack_batch
    from packppi_torch.data.crops import spatial_crops, take_residues
    from packppi_torch.structure import featurize, from_pdb_file

    feats = []
    for name, size in (("1brs", 72), ("2ftl", 96), ("2ftl", 72)):
        prot = from_pdb_file(f"{FIXTURES}/{name}.pdb", mse_to_met=True)
        feats.append(featurize(take_residues(prot, next(iter(spatial_crops(prot, size, 10)))[1])))
    rows = feats + [feats[-1]]
    if copies_of is not None:
        rows = [rows[copies_of]] * len(rows)
    alone = [stack_batch([f], device, target_len=96) for f in rows]
    return stack_batch(rows, device, target_len=96), alone, [len(f["residue_type"]) for f in rows]


def _unmask_padding(batch, r, L):
    """Row r with its padding made real: the first residues' copy, shifted
    0.5 A, in the padded slots and residue_mask 1 there."""
    n = batch.X.shape[1] - L
    X, rm = batch.X.clone(), batch.residue_mask.clone()
    X[r, L:] = X[r, :n] + 0.5
    rm[r, L:] = 1.0
    return batch._replace(X=X, residue_mask=rm)


def _close_mixed(got, want, dtype):
    """bf16: ``_close``'s limits; float32: max |d| <= 2e-5 (the kernels'
    float32 limit in chip_smoke.py)."""
    if dtype == torch.bfloat16:
        return _close(got, want, dtype)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 2e-5


@pytest.mark.parametrize("msg_dtype", [torch.float32, torch.bfloat16], ids=["f32msg", "bf16msg"])
@pytest.mark.parametrize("pre_mask", [False, True], ids=["node", "edge"])
def test_chain_bf16_rows_keep_their_bits_at_any_launch_size(cuda, msg_dtype, pre_mask):
    """A row's bf16 chain does not depend on how many rows share the launch:
    600 rows (10 tiles: four warpgroups a tile on 132 SMs) give the same
    bits inside 12,800 (200 tiles: one warpgroup a tile)."""
    from packppi_torch.ops.chain import chain

    big = _chain_operands(cuda, torch.bfloat16, msg_dtype, N=12800, seed=7)
    small = tuple(t[:600] if t.dim() and t.shape[0] == 12800 else t for t in big)
    assert torch.equal(chain(*big, pre_mask)[:600], chain(*small, pre_mask))


def _mixed_net(device, dtype):
    from packppi_torch.models import ChiScoreNetwork, NetworkConfig
    from packppi_torch.weights import init_weights

    net = ChiScoreNetwork(NetworkConfig(compute_dtype=str(dtype).split(".")[1],
                                        fused_messages="geom_lanes"))
    init_weights(net, 0)
    return net.to(device).eval()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mixed_bucket_rows_equal_each_complex_alone(cuda, dtype):
    """One network evaluation of a chunk whose rows differ in true length:
    every message and chain kernel call, row by row, equals the same kernel
    on that row alone (the same inputs; the message kernel and the bf16
    chain bit for bit); each row equals, bit for bit, that row of a batch
    of copies of its complex; and each row equals its complex evaluated
    alone (float32 within 2e-5; bf16, whose single roundings move with the
    row count of the GEMMs outside the kernels, within twice the bf16
    evaluation's own distance from float32). A row with its padding
    unmasked does not."""
    from packppi_torch.models import ipmp
    from packppi_torch.ops.chain import chain
    from packppi_torch.ops.message import message

    batch, alone, lengths = _mixed_bucket(cuda)
    B = len(alone)
    net = _mixed_net(cuda, dtype)
    g = torch.Generator().manual_seed(0)
    sc = (torch.rand(batch.SC_D.shape, generator=g) * 6 - 3).to(cuda) * batch.SC_D_mask
    sc[-1] = sc[-2]
    t = torch.full(batch.residue_mask.shape, 0.4, device=cuda)
    ev = lambda n, b, r: n(b, sc[r], t[r], skip_last_edge_update=True)[0]
    calls = []
    record = lambda fn, name: lambda *a: calls.append((name, a, fn(*a))) or calls[-1][2]
    ipmp.message, ipmp.chain = record(message, "message"), record(chain, "chain")
    try:
        with torch.no_grad():
            out = ev(net, batch, slice(None))
    finally:
        ipmp.message, ipmp.chain = message, chain
    assert [name for name, _, _ in calls] == ["message", "chain"] * 5
    with torch.no_grad():
        for name, a, got in calls:
            for r in range(B):
                if name == "message":
                    one = message(*(x[r:r + 1] for x in a[:9]), *a[9:])
                    row = got[r:r + 1]
                else:
                    s = slice(r * (len(a[0]) // B), (r + 1) * (len(a[0]) // B))
                    one = chain(a[0][s], a[1][s], None if a[2] is None else a[2][s], *a[3:])
                    row = got[s]
                if name == "message" or dtype == torch.bfloat16:
                    assert torch.equal(row, one), (name, r)
                else:
                    _close_mixed(row, one, dtype)
        want = [ev(net, a, slice(r, r + 1))[0] for r, a in enumerate(alone)]
        ref = [ev(_mixed_net(cuda, torch.float32), a, slice(r, r + 1))[0]
               for r, a in enumerate(alone)]
        bad = ev(net, _unmask_padding(batch, 0, lengths[0]), slice(None))
        for r in range(B):
            copies = _mixed_bucket(cuda, copies_of=r)[0]
            rep = net(copies, sc[r:r + 1].expand(B, -1, -1).contiguous(),
                      t[r:r + 1].expand(B, -1).contiguous(), skip_last_edge_update=True)[0]
            assert torch.equal(out[r], rep[0])

    def check(r, got):
        if dtype == torch.float32:
            return _close_mixed(got, want[r], dtype)
        d, e = (got - want[r]).float().abs(), (want[r] - ref[r]).float().abs()
        assert torch.isfinite(got.float()).all()
        assert d.max() <= 2 * e.max() and d.mean() <= 2 * e.mean()

    for r in range(B):
        check(r, out[r])
    with pytest.raises(AssertionError):
        check(0, bad[0])


def test_clash_kernels_on_rows_of_different_lengths(cuda):
    """The batched clash forward and gradient on a chunk whose rows differ
    in true length (padding absent) equal each row alone, bit for bit, and
    the plain version."""
    from packppi_torch.geometry import atom14_coords_from_torsions
    from packppi_torch.geometry.frames import chem_table
    from packppi_torch.ops.clash import between_residue_clash, between_residue_clash_plain

    b, _, _ = _mixed_bucket(cuda)
    g = torch.Generator().manual_seed(1)
    sc = b.SC_D + (0.8 * torch.randn(b.SC_D.shape, generator=g)).to(cuda) * b.SC_D_mask
    pos = atom14_coords_from_torsions(b.X, b.residue_type, b.BB_D, sc)
    ex, ridx = b.atom_mask, b.residue_index
    rad = chem_table("vdw_radius_atom14", cuda)[b.residue_type] * ex
    w = torch.rand(ex.shape, generator=g).to(cuda) * ex

    x = pos.clone().requires_grad_(True)
    got = between_residue_clash(x, ex, rad, ridx, 0.5)
    (got * w).sum().backward()
    for r in range(pos.shape[0]):
        xr = pos[r:r + 1].clone().requires_grad_(True)
        one = between_residue_clash(xr, ex[r:r + 1], rad[r:r + 1], ridx[r:r + 1], 0.5)
        (one * w[r:r + 1]).sum().backward()
        assert torch.equal(got[r], one[0]) and torch.equal(x.grad[r], xr.grad[0])
    ref = pos.clone().requires_grad_(True)
    want = between_residue_clash_plain(ref, ex, rad, ridx, 0.5)["per_atom_loss_sum"]
    (want * w).sum().backward()
    assert want.sum().item() > 1.0
    assert (got - want).abs().max().item() <= 1e-5
    assert (x.grad - ref.grad).abs().max().item() <= 2e-5
    # padded slots hold no atom and get neither loss nor gradient
    assert got[0, 72:].abs().max().item() == 0 and x.grad[0, 72:].abs().max().item() == 0


def _kernel_launches():
    from packppi_torch.ops.chain import chain
    from packppi_torch.ops.layer import layer_edge, layer_node
    from packppi_torch.ops.message import message, message_chain, message_gather, message_geom
    from packppi_torch.ops.message_feat import message_feat

    return (message, message_chain, message_gather, message_geom, message_feat, chain,
            layer_node, layer_edge)


def test_unfused_route_launches_no_kernel(cuda):
    """``fused_messages=False, fused_chain=False`` in eval(): no kernel
    launch on the card, while the default configuration launches the
    message and chain kernels (3 node and 3 edge passes each)."""
    from packppi_torch.data import stack_batch
    from packppi_torch.models import ChiScoreNetwork, NetworkConfig
    from packppi_torch.structure import featurize, from_pdb_file
    from packppi_torch.weights import init_weights

    feats = featurize(from_pdb_file(f"{FIXTURES}/1brs.pdb", mse_to_met=True))
    batch = stack_batch([feats], cuda)
    t = torch.full(batch.residue_mask.shape, 0.5, device=cuda)
    counts = {}
    for name, kw in (("unfused", dict(fused_messages=False, fused_chain=False)), ("default", {})):
        net = ChiScoreNetwork(NetworkConfig(compute_dtype="bfloat16", **kw))
        init_weights(net, 0)
        net.to(cuda).eval()
        for fn in _kernel_launches():
            fn.launches = 0
        with torch.no_grad():
            score, _ = net(batch, batch.SC_D, t)
        assert torch.isfinite(score).all()
        counts[name] = [fn.launches for fn in _kernel_launches()]
    assert counts["unfused"] == [0] * 8
    assert counts["default"] == [6, 0, 0, 0, 0, 6, 0, 0]


def test_server_lock_serializes_concurrent_requests(cuda, tmp_path):
    """Two seeded /pack requests at once on the card: their samplings never
    overlap, and each answer equals the same request made alone."""
    import http.client
    import json
    import threading
    import time
    from concurrent.futures import ThreadPoolExecutor

    from packppi_torch.cli.serve import build_parser, make_server

    sessions = {}
    args = build_parser().parse_args(["--port", "0", "--n_steps", "3",
                                      "--tmp_dir", str(tmp_path / "tmp")])
    srv = make_server(args, sessions)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    model = sessions["pack"].model
    sample, active, overlaps = model.sample, [0], []

    def watched(*a, **k):
        active[0] += 1
        overlaps.append(active[0] > 1)
        time.sleep(0.2)
        try:
            return sample(*a, **k)
        finally:
            active[0] -= 1

    def post(body):
        conn = http.client.HTTPConnection(*srv.server_address, timeout=600)
        conn.request("POST", "/pack", body=body)
        resp = conn.getresponse()
        out = (resp.status, json.loads(resp.read()))
        conn.close()
        return out

    try:
        pdb = open(f"{FIXTURES}/1brs.pdb").read()
        bodies = [json.dumps({"pdb": pdb, "seed": s, "metrics": False}) for s in (3, 4)]
        alone = [post(b)[1]["pdb"] for b in bodies]
        model.sample = watched
        with ThreadPoolExecutor(2) as pool:
            both = list(pool.map(post, bodies))
    finally:
        srv.shutdown()
    assert [s for s, _ in both] == [200, 200]
    assert [p["pdb"] for _, p in both] == alone and overlaps == [False, False]


# ---- ranks on the card ---------------------------------------------------------

def test_kernel_wrappers_launch_on_the_operands_device(cuda):
    """Every wrapper launches through the device-guarded helper: the
    attention kernel on cuda:0 while another card is current, where there
    is one, and on cuda:0 here."""
    from packppi_torch.ops.attention import mha, mha_plain

    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(1, 2, 64, 64, generator=g).to(cuda) for _ in range(3))
    bias = torch.zeros(1, 64, device=cuda)
    other = torch.cuda.device_count() - 1
    with torch.cuda.device(other):
        got = mha(q, k, v, bias)
    assert got.device == q.device
    np.testing.assert_allclose(got.cpu().numpy(), mha_plain(q, k, v, bias).cpu().numpy(),
                               atol=1e-5)


def test_nccl_world_of_one_runs_the_dry_run(cuda):
    from packppi_torch.parallel.dryrun import dryrun_multichip

    report = dryrun_multichip(1, "cuda")
    assert len(report["lines"]) == 3 and report["launches"][0]["message"] > 0


def test_ranks_sharing_the_card_run_the_dry_run(cuda):
    """Four ranks (2 x 2) on one card over gloo: every stage, every rank
    through the kernels."""
    from packppi_torch.parallel.dryrun import dryrun_multichip

    report = dryrun_multichip(4, "cuda", share_device=True)
    assert len(report["lines"]) == 8
    assert all(r["message"] > 0 and r["attention"] > 0 for r in report["launches"])


def test_more_ranks_than_cards_needs_share_device(cuda):
    from packppi_torch.parallel.launch import launch

    n = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match="share_device=True"):
        launch(print, n, "cuda")


# (H, He, P, K): each width away from 128 / 128 / 8 / 32 in some entry, He !=
# H in two, K past the 64-row tile in two (130: three tiles a node)
GPU_WIDTHS = [(64, 64, 4, 16), (256, 256, 8, 32), (128, 64, 16, 48), (128, 128, 8, 96),
              (96, 160, 3, 24), (32, 32, 1, 130)]
GPU_WIDTH_IDS = [f"H{h}-He{e}-P{p}-K{k}" for h, e, p, k in GPU_WIDTHS]
CHAIN_WIDTHS = [32, 64, 96, 160, 192, 224, 256]
# bf16 mean limit at other widths (chip_smoke.py's WIDTH_BF16_MEAN_REL):
# rounding flips grow with the width; at H = 256 the node pass reads about
# twice the distance between the plain version summing in float32 and in
# float64 (both sound), past 2^-16, and the plain version without its
# rounding points still reads more than 4x 2^-15
WIDTH_MEAN_REL = 2.0 ** -15


@pytest.fixture(scope="module")
def width_libs(cuda):
    """Every library the width tests launch, built in parallel (one nvcc
    each) before the first of them runs."""
    from packppi_torch.ops import _build

    names = [_build.lib_name("chain", "relu", h) for h in CHAIN_WIDTHS]
    for h, he, p, _ in GPU_WIDTHS:
        for widths in {(h, he, p), (h, h, p)}:
            names += [_build.lib_name(src, "relu", *widths)
                      for src in ("message", "message_feat", "layer")]
    _build.build_all(list(dict.fromkeys(names)))
    return names


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("pool", [True, False], ids=["pool", "edge"])
@pytest.mark.parametrize("kernel", TC_KERNELS)
@pytest.mark.parametrize("widths", GPU_WIDTHS, ids=GPU_WIDTH_IDS)
def test_tensor_core_message_kernels_match_plain_at_width(cuda, width_libs, widths, kernel, pool,
                                                          dtype):
    """B = 2, L = 37 at widths the kernels are built for one library each."""
    H_, He, P_, K = widths
    fn, plain, ops = _tc_message_case(kernel, cuda, dtype, K=K, H=H_, He=He, P=P_)
    before = fn.launches
    got = fn(*ops, pool)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert got.shape == ((2, 37, H_) if pool else (2, 37, K, H_))
    _close(got, plain(*ops, pool), dtype, WIDTH_MEAN_REL)


@pytest.mark.parametrize("dtype,msg_dtype", [(torch.float32, torch.float32),
                                             (torch.bfloat16, torch.bfloat16),
                                             (torch.bfloat16, torch.float32)],
                         ids=["f32", "bf16", "bf16-f32msg"])
@pytest.mark.parametrize("pre_mask", [False, True], ids=["node", "edge"])
@pytest.mark.parametrize("N", [700, 20000])
@pytest.mark.parametrize("H_", CHAIN_WIDTHS)
def test_chain_kernel_matches_plain_at_width(cuda, width_libs, H_, N, pre_mask, dtype,
                                             msg_dtype):
    """N = 700: fewer tiles than SMs (four warpgroups a bf16 tile up to H =
    128, 16-row float32 tiles); N = 20,000: one warpgroup, 64-row tiles."""
    from packppi_torch.ops.chain import chain, chain_plain

    ops = _chain_operands(cuda, dtype, msg_dtype, N=N, H=H_)
    got = chain(*ops, pre_mask)
    torch.cuda.synchronize()
    _close(got, chain_plain(*ops, pre_mask), dtype, WIDTH_MEAN_REL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel", FUSED_KERNELS)
@pytest.mark.parametrize("widths", GPU_WIDTHS, ids=GPU_WIDTH_IDS)
def test_message_chain_and_layer_kernels_match_plain_at_width(cuda, width_libs, widths, kernel,
                                                              dtype):
    """The fold and the whole layer's passes; the edge passes add the
    message to h_E, so they run at He = H."""
    from packppi_torch.ops.layer import layer_edge, layer_edge_plain, layer_node, layer_node_plain
    from packppi_torch.ops.message import message_chain, message_chain_plain

    H_, He, P_, K = widths
    He = He if kernel == "layer_node" else H_
    cw = _chain_weights(cuda, H=H_)
    if kernel == "message_chain":
        fn, plain = message_chain, message_chain_plain
        ops = (*_message_operands(cuda, dtype, K=K, H=H_, He=He, P=P_), *cw)
    else:
        per_i, pj, h_E, geom, mask, *w = _message_feat_operands(cuda, dtype, K=K, H=H_, He=He,
                                                                P=P_)
        if kernel == "layer_edge":
            fn, plain = layer_edge, layer_edge_plain
            ops = (h_E, per_i, pj, geom, mask, *w, *cw)
        else:
            fn, plain = layer_node, layer_node_plain
            g = torch.Generator().manual_seed(6)
            h_V = torch.randn(2, 37, H_, generator=g).to(cuda, dtype)
            mask_V = (torch.rand(2, 37, generator=g) > 0.1).float().to(cuda)
            ops = (h_V, per_i, pj, h_E, geom, mask, mask_V, *w, *cw)
    got = fn(*ops)
    torch.cuda.synchronize()
    _close(got, plain(*ops), dtype, WIDTH_MEAN_REL)
    if kernel == "layer_node":
        for npb in (1, 5, 16):
            assert torch.equal(layer_node(*ops, nodes_per_block=npb), got)


@pytest.mark.parametrize("pool", [True, False], ids=["pool", "edge"])
@pytest.mark.parametrize("widths", GPU_WIDTHS, ids=GPU_WIDTH_IDS)
def test_message_feat_gradients_match_autograd_through_plain_at_width(cuda, width_libs, widths,
                                                                     pool):
    from packppi_torch.ops.message_feat import message_feat, message_feat_plain

    H_, He, P_, K = widths
    ops = _message_feat_operands(cuda, torch.float32, K=K, H=H_, He=He, P=P_)
    diff = [i for i in range(len(ops)) if i != 4]              # operand 4 is the mask
    _grads_close(_function_grads(lambda *a: message_feat(*a, pool), ops, diff),
                 _function_grads(lambda *a: message_feat_plain(*a, pool), ops, diff))


def test_message_chain_and_layer_edge_refuse_he_other_than_h(cuda):
    from packppi_torch.ops.layer import layer_edge
    from packppi_torch.ops.message import message_chain

    ops = _message_operands(cuda, torch.float32, H=64, He=96, P=4)
    with pytest.raises(ValueError, match="edge_features=96"):
        message_chain(*ops, *_chain_weights(cuda, H=64))
    per_i, pj, h_E, geom, mask, *w = _message_feat_operands(cuda, torch.float32, H=64, He=96,
                                                            P=4)
    with pytest.raises(ValueError, match="edge_features=96"):
        layer_edge(h_E, per_i, pj, geom, mask, *w, *_chain_weights(cuda, H=64))
