"""The message kernels' tensor-core arithmetic and their packed weights,
on the CPU, before any card runs them.

The message kernels (``ops.message.message``, ``message_gather`` and
``message_geom``, ``ops.message_feat.message_feat``) run the message MLP's three products on
tensor cores (``csrc/message_tc.cuh``). In float32 they compute them as
3xTF32 on mma.sync: each operand x split into hi (x rounded to 11
significant bits, Veltkamp's split) and lo (x - hi rounded to the nearest
TF32), a . b summed as hi.hi + lo.hi + hi.lo for each k-step of 8, each
16-k weight chunk's partial summed from zero and added to the running sum.
``message_tc_model`` does exactly that in plain torch, and is held to the
JAX package's float32 kernels within 2e-5 (the limit of
``tests/test_torch_message.py`` and ``tests/test_torch_message_feat.py``):
``fused_message_geom_lanes`` (interpret mode, fed as
``test_torch_message.py`` feeds it) and ``fused_message`` (interpret mode).
``fused_message_geom`` (row 4, interpret mode, its tile filled from the
gathered operands as ``message_geom``'s kernel fills it). The control:
plain TF32 (the products of the operands rounded to TF32) must exceed that
limit.

The packed weights: the bf16 copy, its swizzled panel index undone, gives
W_e, W_1 and W_2 rounded to bf16 exactly, and zeros in the pad; the
float32 copy gives each weight back from its TF32 high and low parts
within 2^-22 of it.

The ``_at_width`` tests hold the same arithmetic (against ``fused_message``
in interpret mode, on random operands) and the same packing at H in {64,
128, 256} and P in {4, 8}, where each width changes the packed layout: the
first product's depth He + 9P padded to a multiple of 16, the panels and
chunks of H columns, the n-tiles of a float32 chunk.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from packppi_tpu.ops.pallas_ipmp import fused_message
from packppi_torch.ops.activations import ACTS
from packppi_torch.ops.graph import gather_nodes
from packppi_torch.ops.message import geometry_edge_features
from packppi_torch.ops.message_feat import (_DEPTH, _K1, _fragment_index, _panel_index,
                                            message_depth, message_weight_matrix,
                                            pack_message_weights, pack_message_weights_bf16,
                                            pack_message_weights_f32, tf32_split)

from test_torch_message import _jax_message, _port_mlp, case  # noqa: F401 (fixture)
from test_torch_message_feat import _jax_operands, _port_operands
from test_torch_message_feat import case as feat_case_fixture
from test_torch_message_variants import _jax as _jax_route
from test_torch_message_variants import case as geom_case_fixture
from test_torch_message_variants import port_mlp
from test_torch_tf32x3 import tf32
from torch_threads import _threads  # noqa: F401 (autouse fixture)

H, G = 128, 72
F32_TOL = 2e-5

feat_case = pytest.fixture(scope="module", name="feat_case")(feat_case_fixture.__wrapped__)
geom_case = pytest.fixture(scope="module", name="geom_case")(geom_case_fixture.__wrapped__)


def mm_3xtf32_chunks(a, w):
    """a [R, k] . w [k, n] as the float32 kernel sums it: 16-k chunks, each
    a partial from zero over its two k-steps of 8 (hi.hi, lo.hi, hi.lo in
    that order), added to the running sum."""
    ah, al = tf32_split(a.contiguous())
    wh, wl = tf32_split(w.contiguous())
    acc = torch.zeros(a.shape[0], w.shape[1])
    for k0 in range(0, a.shape[1], 16):
        p = torch.zeros_like(acc)
        for s in range(k0, min(k0 + 16, a.shape[1]), 8):
            ks = slice(s, s + 8)
            p = p + ah[:, ks] @ wh[ks]
            p = p + al[:, ks] @ wh[ks]
            p = p + ah[:, ks] @ wl[ks]
        acc = acc + p
    return acc


def mm_tf32(a, w):
    """The control: both operands rounded to TF32, one product."""
    return tf32(a) @ tf32(w)


def message_tc_model(per_i, pj, h_E, geom, mask, w_in, b_in, w_mid, b_mid, w_out, b_out,
                     pool, mm, act="relu"):
    """The message MLP of the float32 kernels with the products ``mm``:
    [h_E | geom | zero columns to the padded depth] (8 at the default
    widths) against the packed weight matrix's W_e, W_1 and W_2
    (``message_weight_matrix``), at the widths of the operands."""
    B, L, K, He = h_E.shape
    H, G = per_i.shape[-1], geom.shape[-1]
    k1 = message_depth(He, G)
    w = message_weight_matrix(w_in, w_mid, w_out, He).t()        # [464, H] (in, out)
    rows = lambda t: t.reshape(B * L * K, -1).float()
    a = torch.cat([rows(h_E), rows(geom), torch.zeros(B * L * K, k1 - He - G)], 1)
    per_row = per_i.float()[:, :, None].expand(B, L, K, H)
    x = ACTS[act](mm(a, w[:k1]) + b_in + rows(per_row) + rows(pj))
    x = ACTS[act](mm(x, w[k1:k1 + H]) + b_mid)
    x = (mm(x, w[k1 + H:]) + b_out).reshape(B, L, K, H)
    return (x * mask[..., None]).sum(-2) / float(K) if pool else x


def _lanes_case(case, pool, act="relu"):
    """(port operands as ``message_feat`` takes them, the JAX kernel's
    output) for ``fused_message_geom_lanes`` on 40 residues of 1BRS."""
    mlp = _port_mlp(case["params"])
    ops = mlp.operands(torch.from_numpy(case["h_V"]), torch.from_numpy(case["h_E"]), case["idx"],
                       torch.from_numpy(case["p_local"]), case["frames"], case["mask"])
    per_i, per_j, h_E, idx, p_local, rot, trans, pg, mask, *weights = ops
    geom = geometry_edge_features(p_local, gather_nodes(pg, idx), rot, trans)
    fr = case["frames"]
    ref = _jax_message(case["params"], jnp.asarray(case["h_V"]), jnp.asarray(case["h_E"]),
                       jnp.asarray(case["idx"].numpy()), jnp.asarray(case["p_local"]),
                       jnp.asarray(fr.rot.numpy()), jnp.asarray(fr.trans.numpy()),
                       jnp.asarray(case["mask"].numpy()), pool, jnp.float32, act)
    feat_ops = (per_i, gather_nodes(per_j, idx), h_E, geom, mask, *weights)
    return [t.detach() for t in feat_ops], np.asarray(ref)[None]


def _feat_case(c, pool):
    ops = _port_operands(c, torch.float32)
    K = ops[2].shape[2]
    ref = fused_message(*_jax_operands(c, jnp.float32), K=K, act_name="relu", pool=pool,
                        compute_dtype=jnp.float32, blk=64, interpret=True)
    return ops, np.asarray(ref)[None]


def _geom_case(c, pool):
    """Row 4: the tile filled from ``message_geom``'s operands (h_E, and the
    geometry from the local planes, the frame and the gathered neighbour
    planes), the JAX ``fused_message_geom`` through the JAX
    ``FactoredMessageMLP.geom_fused`` in interpret mode, on 40 residues of
    1BRS."""
    args = (torch.from_numpy(c["h_V"]), torch.from_numpy(c["h_E"]), c["idx"],
            torch.from_numpy(c["p_local"]), c["frames"], c["mask"])
    with torch.no_grad():
        per_i, pjg, h_E, pl, ng, rot9, trans, mask, *weights = \
            port_mlp(c["params"]).geom_operands(*args)
    B, L, P3 = pl.shape
    p_local = pl.reshape(B, L, 3, P3 // 3).transpose(-1, -2)
    geom = geometry_edge_features(p_local, ng, rot9.reshape(B, L, 3, 3), trans)
    ops = (per_i, pjg, h_E, geom, mask, *weights)
    return [t.detach() for t in ops], _jax_route(c, "geom", "float32", pool)


@pytest.mark.parametrize("pool", [True, False], ids=["node", "edge"])
@pytest.mark.parametrize("kernel", ["lanes", "feat", "geom", "lanes_gelu"])
def test_message_3xtf32_holds_the_float32_limit(case, feat_case, geom_case, kernel, pool):
    """``lanes_gelu``: the JAX kernel with ``act_name="gelu"``, the model
    applying gelu to the same float32 sums."""
    ops, ref = {"lanes": lambda: _lanes_case(case, pool),
                "feat": lambda: _feat_case(feat_case, pool),
                "geom": lambda: _geom_case(geom_case, pool),
                "lanes_gelu": lambda: _lanes_case(case, pool, "gelu")}[kernel]()
    act = "gelu" if kernel.endswith("gelu") else "relu"
    got = message_tc_model(*ops, pool, mm_3xtf32_chunks, act).numpy()
    control = message_tc_model(*ops, pool, mm_tf32, act).numpy()
    assert got.shape == ref.shape
    err, cerr = np.abs(got - ref).max(), np.abs(control - ref).max()
    assert err <= F32_TOL, err
    assert cerr > F32_TOL, cerr


def _weights(seed=5):
    rng = np.random.default_rng(seed)
    w = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32) / np.sqrt(s[1]))
    return w(H, 3 * H + G), w(H, H), w(H, H)


def test_bf16_packed_weights_are_the_rounded_weights_in_swizzled_panels():
    w_in, w_mid, w_out = _weights()
    packed = pack_message_weights_bf16(w_in, w_mid, w_out)
    assert packed.dtype == torch.bfloat16 and packed.numel() == 8 * H * 64
    unpacked = torch.empty(H * 512, dtype=torch.bfloat16)
    unpacked[_panel_index("cpu")] = packed                 # undo the swizzled panels
    unpacked = unpacked.reshape(H, 512)
    bf = lambda t: t.to(torch.bfloat16)
    assert torch.equal(unpacked[:, :H], bf(w_in[:, H:2 * H]))           # W_e, h_E block
    assert torch.equal(unpacked[:, H:H + G], bf(w_in[:, 3 * H:]))       # W_e, geometry block
    assert not unpacked[:, H + G:256].float().any()                      # the pad
    assert torch.equal(unpacked[:, 256:256 + H], bf(w_mid))
    assert torch.equal(unpacked[:, 256 + H:], bf(w_out))


def test_bf16_panels_follow_the_128_byte_swizzle():
    """Element (n, k) of panel p lies in row n's 16-byte piece (k // 8) ^
    (n % 8), as ``csrc/mma.cuh`` ``sw128_offset`` places it."""
    index = _panel_index("cpu").numpy()
    for p, n, k in [(0, 0, 0), (0, 1, 0), (1, 9, 17), (3, 127, 63), (7, 5, 40)]:
        src = n * 512 + 64 * p + k
        at = int(np.nonzero(index == src)[0][0])
        assert at == p * H * 64 + n * 64 + (((k // 8) ^ (n % 8)) * 8) + k % 8


def test_f32_packed_weights_hold_each_weight_to_22_bits():
    w_in, w_mid, w_out = _weights()
    packed = pack_message_weights_f32(w_in, w_mid, w_out)
    assert packed.dtype == torch.float32 and packed.numel() == 2 * H * _DEPTH
    parts = torch.empty(2 * H * _DEPTH)
    parts[_fragment_index("cpu")] = packed
    hi, lo = parts.reshape(2, H, _DEPTH)
    want = message_weight_matrix(w_in, w_mid, w_out)
    assert not (hi.view(torch.int32) & 0x1FFF).any() and not (lo.view(torch.int32) & 0x1FFF).any()
    assert ((hi + lo - want).abs() <= 2.0 ** -22 * want.abs()).all()
    assert (hi != want).any()                                          # the split is not trivial
    assert not want[:, H + G:_K1].any()                                # W_e's pad columns


def test_f32_fragment_order_gives_each_lane_its_mma_operands():
    """Word e of lane l, n-tile j, k-step s of chunk c holds the B fragment
    register b0 (e even) or b1 (e odd): k = 16 c + 8 s + l % 4 (+ 4), n =
    8 j + l // 4; words 0-1 the high parts, 2-3 the low."""
    index = _fragment_index("cpu").numpy().reshape(_DEPTH // 16, 2, 16, 32, 4)
    for c, s, j, lane, e in [(0, 0, 0, 0, 0), (12, 1, 15, 31, 3), (20, 0, 3, 6, 1),
                             (28, 1, 7, 17, 2)]:
        k = 16 * c + 8 * s + lane % 4 + 4 * (e % 2)
        n = 8 * j + lane // 4
        assert index[c, s, j, lane, e] == (e // 2) * H * _DEPTH + n * _DEPTH + k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_message_weights_are_packed_again_only_after_a_write(dtype):
    w_in, w_mid, w_out = _weights()
    first = pack_message_weights(w_in, w_mid, w_out, dtype)
    assert pack_message_weights(w_in, w_mid, w_out, dtype) is first
    w_mid.mul_(-1.0)                                       # an optimizer step writes in place
    again = pack_message_weights(w_in, w_mid, w_out, dtype)
    assert again is not first and not torch.equal(again, first)
    assert pack_message_weights(w_in, w_mid.clone(), w_out, dtype) is not again


WIDTHS = [(64, 4), (64, 8), (128, 4), (256, 4), (256, 8)]
WIDTH_IDS = [f"H{h}-P{p}" for h, p in WIDTHS]


def _width_operands(H, P, L=24, K=16, seed=9):
    """Random message_feat operands at hidden width H = He and P points:
    (port operands, fused_message's operands of the batch's one row)."""
    rng = np.random.default_rng(seed)
    f32, G = np.float32, 9 * P
    xavier = lambda i, o: (rng.uniform(-1, 1, (i, o)) * np.sqrt(6 / (i + o))).astype(f32)
    mask = (rng.uniform(size=(L, K)) > 0.2).astype(f32)
    c = dict(per_i=rng.normal(size=(L, H)), pj=rng.normal(size=(L, K, H)),
             h_E=rng.normal(size=(L, K, H)), geom=3 * rng.normal(size=(L, K, G)), mask=mask,
             w_he=xavier(H, H), w_g=xavier(G, H), b_e=rng.normal(0, .1, H), w1=xavier(H, H),
             b1=rng.normal(0, .1, H), w2=xavier(H, H), b2=rng.normal(0, .1, H))
    c = {k: np.ascontiguousarray(v, f32) for k, v in c.items()}
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    w_in = np.concatenate([xavier(H, H), c["w_he"], xavier(H, H), c["w_g"]], 0).T
    ops = (t(c["per_i"])[None], t(c["pj"])[None], t(c["h_E"])[None], t(c["geom"])[None],
           t(c["mask"])[None], t(w_in), t(c["b_e"]), t(c["w1"].T), t(c["b1"]), t(c["w2"].T),
           t(c["b2"]))
    jops = tuple(jnp.asarray(c[k]) for k in ("per_i", "pj", "h_E", "geom", "mask", "w_he",
                                             "w_g", "b_e", "w1", "b1", "w2", "b2"))
    return ops, jops


@pytest.mark.parametrize("pool", [True, False], ids=["node", "edge"])
@pytest.mark.parametrize("H,P", WIDTHS, ids=WIDTH_IDS)
def test_message_3xtf32_holds_the_float32_limit_at_width(H, P, pool):
    ops, jops = _width_operands(H, P)
    ref = np.asarray(fused_message(*jops, K=16, act_name="relu", pool=pool,
                                   compute_dtype=jnp.float32, blk=64, interpret=True))[None]
    got = message_tc_model(*ops, pool, mm_3xtf32_chunks).numpy()
    control = message_tc_model(*ops, pool, mm_tf32).numpy()
    assert got.shape == ref.shape
    err, cerr = np.abs(got - ref).max(), np.abs(control - ref).max()
    assert err <= F32_TOL, err
    assert cerr > F32_TOL, cerr


def _width_weights(H, P, seed=5):
    rng = np.random.default_rng(seed)
    w = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32) / np.sqrt(s[1]))
    return w(H, 3 * H + 9 * P), w(H, H), w(H, H)


@pytest.mark.parametrize("H,P", WIDTHS, ids=WIDTH_IDS)
def test_bf16_packed_weights_are_the_rounded_weights_at_width(H, P):
    """Each weight's k padded to whole 64-k panels of H rows, the panels in
    the order W_e, W_1, W_2."""
    G = 9 * P
    w_in, w_mid, w_out = _width_weights(H, P)
    k1 = message_depth(H, G)
    we, hp = 64 * -(-k1 // 64), 64 * -(-H // 64)
    packed = pack_message_weights_bf16(w_in, w_mid, w_out, H)
    assert packed.dtype == torch.bfloat16 and packed.numel() == H * (we + 2 * hp)
    unpacked = torch.empty(packed.numel(), dtype=torch.bfloat16)
    unpacked[_panel_index("cpu", H, k1)] = packed
    unpacked = unpacked.reshape(H, we + 2 * hp)
    bf = lambda t: t.to(torch.bfloat16)
    assert torch.equal(unpacked[:, :H], bf(w_in[:, H:2 * H]))              # W_e, h_E block
    assert torch.equal(unpacked[:, H:H + G], bf(w_in[:, 3 * H:]))          # W_e, geometry
    assert not unpacked[:, H + G:we].float().any()                           # W_e's pad
    assert torch.equal(unpacked[:, we:we + H], bf(w_mid))
    assert not unpacked[:, we + H:we + hp].float().any()
    assert torch.equal(unpacked[:, we + hp:we + hp + H], bf(w_out))
    assert not unpacked[:, we + hp + H:].float().any()


@pytest.mark.parametrize("H,P", WIDTHS, ids=WIDTH_IDS)
def test_bf16_panels_follow_the_128_byte_swizzle_at_width(H, P):
    """Element (n, k) of panel p lies in row n's 16-byte piece (k // 8) ^
    (n % 8) of that panel's H rows of 128 bytes."""
    k1 = message_depth(H, 9 * P)
    panels = -(-k1 // 64) + 2 * -(-H // 64)
    index = _panel_index("cpu", H, k1).numpy()
    assert sorted(index) == list(range(H * 64 * panels))
    for p, n, k in [(0, 0, 0), (0, 1, 0), (1, 9, 17), (panels - 1, H - 1, 63),
                    (panels // 2, 5, 40)]:
        src = n * 64 * panels + 64 * p + k
        at = int(np.nonzero(index == src)[0][0])
        assert at == p * H * 64 + n * 64 + (((k // 8) ^ (n % 8)) * 8) + k % 8


@pytest.mark.parametrize("H,P", WIDTHS, ids=WIDTH_IDS)
def test_f32_packed_weights_hold_each_weight_to_22_bits_at_width(H, P):
    G = 9 * P
    w_in, w_mid, w_out = _width_weights(H, P)
    depth = message_depth(H, G) + 2 * H
    packed = pack_message_weights_f32(w_in, w_mid, w_out, H)
    assert packed.dtype == torch.float32 and packed.numel() == 2 * H * depth
    parts = torch.empty(2 * H * depth)
    parts[_fragment_index("cpu", H, depth)] = packed
    hi, lo = parts.reshape(2, H, depth)
    want = message_weight_matrix(w_in, w_mid, w_out, H)
    assert want.shape == (H, depth)
    assert not (hi.view(torch.int32) & 0x1FFF).any() and not (lo.view(torch.int32) & 0x1FFF).any()
    assert ((hi + lo - want).abs() <= 2.0 ** -22 * want.abs()).all()
    assert not want[:, H + G:message_depth(H, G)].any()                  # W_e's pad columns


@pytest.mark.parametrize("H,P", WIDTHS, ids=WIDTH_IDS)
def test_f32_fragment_order_gives_each_lane_its_mma_operands_at_width(H, P):
    """H / 8 n-tiles a k-step; word e of lane l, n-tile j, k-step s of chunk
    c holds k = 16 c + 8 s + l % 4 (+ 4), n = 8 j + l // 4."""
    depth = message_depth(H, 9 * P) + 2 * H
    index = _fragment_index("cpu", H, depth).numpy()
    assert sorted(index) == list(range(2 * H * depth))
    index = index.reshape(depth // 16, 2, H // 8, 32, 4)
    for c, s, j, lane, e in [(0, 0, 0, 0, 0), (depth // 16 - 1, 1, H // 8 - 1, 31, 3),
                             (3, 0, H // 16, 6, 1), (depth // 32, 1, 1, 17, 2)]:
        k = 16 * c + 8 * s + lane % 4 + 4 * (e % 2)
        n = 8 * j + lane // 4
        assert index[c, s, j, lane, e] == (e // 2) * H * depth + n * depth + k
