"""The port's residual chain (plain version, as the wrapper runs it on CPU
tensors) against the JAX package's Pallas ``fused_chain`` in interpret
mode: node chain (float32 message, post-mask) and edge chain (message in the
stream dtype, pre-mask), float32 and bf16; the edge chain under each
activation of the table.

Tolerances: float32 <= 3e-5 (the JAX package's own fused-vs-unfused bound).
bf16: the same values are rounded at the same points, but the float32 sums
feeding each rounding run in another order, so an element can land one
bf16 ulp away and carry through the FFN; allowed: max |d| <= 2^-6 *
max|ref| (4 ulps at the largest output), mean |d| <= 2^-16 * max|ref|.
The mean limit lies between the two readings it must tell apart: the
sound chain reads 2.7e-7 * max|ref|, the same chain without its rounding
points 2.7e-4 to 2.9e-4 (``test_chain_bf16_tolerance_rejects_unrounded``).

Gradients: ``chain`` is differentiable (plain forward on the CPU,
recomputed plain backward); every operand's gradient is held to ``jax.grad``
through ``fused_chain_diff`` (interpreted) within 5e-4 of that gradient's
max, the JAX package's own fused-vs-unfused limit.

The JAX kernel is compiled with ``xla_allow_excess_precision`` off: by
default XLA:CPU drops a float32 -> bf16 -> float32 round trip, so the
interpreted kernel would skip the very rounding points under test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import packppi_tpu.ops.pallas_layer as pallas_layer
from packppi_tpu.ops.pallas_layer import fused_chain, fused_chain_diff
from packppi_torch.ops.chain import chain, chain_plain

from torch_threads import _threads  # noqa: F401 (autouse fixture)

H, N = 128, 300
BF16_MAX_REL, BF16_MEAN_REL = 2.0 ** -6, 2.0 ** -16


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    f32 = np.float32
    xavier = lambda i, o: (rng.uniform(-1, 1, (i, o)) * np.sqrt(6 / (i + o))).astype(f32)
    mask = (rng.uniform(size=N) > 0.2).astype(f32)
    return dict(
        x=rng.normal(size=(N, H)).astype(f32), msg=rng.normal(size=(N, H)).astype(f32),
        mask=mask,
        # flax layout: kernels [in, out]
        lna_s=rng.uniform(0.5, 1.5, H).astype(f32), lna_b=rng.normal(0, .1, H).astype(f32),
        f1=xavier(H, 4 * H), f1b=rng.normal(0, .1, 4 * H).astype(f32),
        f2=xavier(4 * H, H), f2b=rng.normal(0, .1, H).astype(f32),
        lnb_s=rng.uniform(0.5, 1.5, H).astype(f32), lnb_b=rng.normal(0, .1, H).astype(f32))


def _run_both(c, dtype, edge, use_mask=True, act="relu"):
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    t = lambda k: torch.from_numpy(c[k])
    x = t("x").to(tdt)
    msg = t("msg").to(tdt) if edge else t("msg")
    mask = t("mask") if use_mask else None
    ours = chain(x, msg, mask, t("lna_s"), t("lna_b"), t("f1").T.contiguous(), t("f1b"),
                 t("f2").T.contiguous(), t("f2b"), t("lnb_s"), t("lnb_b"), pre_mask=edge, act=act)
    j = lambda k: jnp.asarray(c[k])
    args = (jnp.asarray(c["x"], jdt), jnp.asarray(c["msg"], jdt if edge else jnp.float32),
            j("mask")[:, None] if use_mask else None,
            j("lna_s"), j("lna_b"), j("f1"), j("f1b"), j("f2"), j("f2b"), j("lnb_s"), j("lnb_b"))
    run = jax.jit(lambda *a: fused_chain(*a, act_name=act, compute_dtype=jdt, pre_mask=edge,
                                         interpret=True))
    ref = run.lower(*args).compile(compiler_options={"xla_allow_excess_precision": False})(*args)
    return ours, np.asarray(ref.astype(jnp.float32))


def _bf16_readings(got, ref):
    """(max |d|, mean |d|) relative to max|ref|."""
    d = np.abs(got - ref)
    scale = np.abs(ref).max()
    return d.max() / scale, d.mean() / scale


@pytest.mark.parametrize("edge", [False, True], ids=["node", "edge"])
def test_chain_f32_matches_pallas_kernel(case, edge):
    ours, ref = _run_both(case, "float32", edge)
    assert ours.dtype == torch.float32 and ours.shape == (N, H)
    np.testing.assert_allclose(ours.numpy(), ref, atol=3e-5, rtol=0)


@pytest.mark.parametrize("edge", [False, True], ids=["node", "edge"])
def test_chain_bf16_matches_pallas_kernel(case, edge):
    ours, ref = _run_both(case, "bfloat16", edge)
    assert ours.dtype == torch.bfloat16
    dmax, dmean = _bf16_readings(ours.float().numpy(), ref)
    assert dmax <= BF16_MAX_REL and dmean <= BF16_MEAN_REL, (dmax, dmean)


ACTS = ["relu", "gelu", "elu", "selu", "celu", "leaky_relu", "silu", "sigmoid"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("act", ACTS)
def test_chain_activation_matches_pallas_kernel(case, act, dtype):
    """Every activation of the table (``act_name`` of ``fused_chain``), on
    the edge chain, at the limits above; the activations differ enough to
    be told apart."""
    ours, ref = _run_both(case, dtype, True, act=act)
    if dtype == "float32":
        np.testing.assert_allclose(ours.numpy(), ref, atol=3e-5, rtol=0)
    else:
        dmax, dmean = _bf16_readings(ours.float().numpy(), ref)
        assert dmax <= BF16_MAX_REL and dmean <= BF16_MEAN_REL, (dmax, dmean)
    if act != "relu":
        relu = _run_both(case, dtype, True)[1]
        assert np.abs(ref - relu).max() > 1e-2


@pytest.mark.parametrize("edge", [False, True], ids=["node", "edge"])
def test_chain_bf16_tolerance_rejects_unrounded(case, edge):
    """The control: the same chain with no bf16 rounding point (run in
    float32 on the bf16 inputs, written in bf16) must fail the mean limit."""
    _, ref = _run_both(case, "bfloat16", edge)
    t = lambda k: torch.from_numpy(case[k])
    x = t("x").bfloat16().float()
    msg = t("msg").bfloat16().float() if edge else t("msg")
    control = chain_plain(x, msg, t("mask"), t("lna_s"), t("lna_b"), t("f1").T.contiguous(),
                          t("f1b"), t("f2").T.contiguous(), t("f2b"), t("lnb_s"), t("lnb_b"),
                          pre_mask=edge).bfloat16()
    _, dmean = _bf16_readings(control.float().numpy(), ref)
    assert dmean > 4 * BF16_MEAN_REL, dmean


def test_chain_without_mask_matches_pallas_kernel(case):
    ours, ref = _run_both(case, "float32", edge=False, use_mask=False)
    np.testing.assert_allclose(ours.numpy(), ref, atol=3e-5, rtol=0)


def test_wrapper_takes_plain_version_on_cpu(case):
    t = lambda k: torch.from_numpy(case[k])
    args = (t("x"), t("msg"), t("mask"), t("lna_s"), t("lna_b"), t("f1").T.contiguous(),
            t("f1b"), t("f2").T.contiguous(), t("f2b"), t("lnb_s"), t("lnb_b"))
    before = chain.launches
    np.testing.assert_array_equal(chain(*args, pre_mask=True).numpy(),
                                  chain_plain(*args, pre_mask=True).numpy())
    assert chain.launches == before      # only kernel launches count


@pytest.mark.parametrize("edge", [False, True], ids=["node", "edge"])
def test_chain_gradients_match_jax_custom_vjp(case, edge):
    rng = np.random.default_rng(5)
    cot = rng.uniform(0.5, 1.5, (N, H)).astype(np.float32)
    names = ("x", "msg", "lna_s", "lna_b", "f1", "f1b", "f2", "f2b", "lnb_s", "lnb_b")
    t = lambda k: torch.from_numpy(case[k])
    ops = [t("x"), t("msg"), t("lna_s"), t("lna_b"), t("f1").T.contiguous(), t("f1b"),
           t("f2").T.contiguous(), t("f2b"), t("lnb_s"), t("lnb_b")]
    ops = [o.clone().requires_grad_(True) for o in ops]
    before = chain.launches
    out = chain(ops[0], ops[1], t("mask"), *ops[2:], pre_mask=edge)
    grads = torch.autograd.grad(0.5 * (torch.from_numpy(cot) * out ** 2).sum(), ops)
    assert chain.launches == before

    def jloss(*a):
        out = fused_chain_diff(a[0], a[1], jnp.asarray(case["mask"])[:, None], *a[2:],
                               compute_dtype=jnp.float32, pre_mask=edge)
        return 0.5 * (jnp.asarray(cot) * out ** 2).sum()

    prev, pallas_layer.INTERPRET = pallas_layer.INTERPRET, True
    try:
        want = jax.grad(jloss, argnums=tuple(range(len(names))))(
            *[jnp.asarray(case[k]) for k in names])
    finally:
        pallas_layer.INTERPRET = prev
    for name, g, w in zip(names, grads, want):
        g, w = g.numpy(), np.asarray(w)
        g = g.T if name in ("f1", "f2") else g           # Linear layout -> [in, out]
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, atol=5e-4 * np.abs(w).max(), rtol=0, err_msg=name)
    # masked rows pass no gradient into x (the output there is 0 whatever x is)
    assert not grads[0].numpy()[case["mask"] == 0].any()


def test_chain_gradients_are_finite_at_rows_of_zeros():
    """Padding: a row of zeros has zero variance in both LayerNorms, where
    the gradient of rsqrt is finite only through eps = 1e-6."""
    rng = np.random.default_rng(2)
    f32 = np.float32
    x = torch.zeros(6, H, requires_grad=True)
    msg = torch.zeros(6, H, requires_grad=True)
    w1 = torch.from_numpy((rng.normal(size=(4 * H, H)) * 0.05).astype(f32)).requires_grad_(True)
    w2 = torch.from_numpy((rng.normal(size=(H, 4 * H)) * 0.05).astype(f32)).requires_grad_(True)
    ones, zeros = torch.ones(H), torch.zeros(H)
    mask = torch.tensor([1., 1., 0., 0., 1., 0.])
    for dtype in (torch.float32, torch.bfloat16):
        out = chain(x.to(dtype), msg, mask, ones, zeros, w1, torch.zeros(4 * H), w2, zeros,
                    ones, zeros, pre_mask=False)
        grads = torch.autograd.grad(out.float().sum() + out.float().pow(2).sum(),
                                    [x, msg, w1, w2])
        assert all(bool(g.isfinite().all()) for g in grads), dtype
        assert not grads[0][mask == 0].any()


def test_pack_chain_weights_lays_out_the_wgmma_panels():
    """The bf16 kernel's copy of W1 and W2: 16 panels of [128 n][64 k],
    slice by slice W1 then W2, each row's 16-byte pieces swizzled by n % 8."""
    from packppi_torch.ops.chain import pack_chain_weights

    g = torch.Generator().manual_seed(0)
    w1, w2 = torch.randn(512, 128, generator=g), torch.randn(128, 512, generator=g)
    packed = pack_chain_weights(w1, w2)
    assert packed.dtype == torch.bfloat16 and packed.shape == (16 * 128 * 64,)
    n, p = torch.arange(128)[:, None], torch.arange(8)[None, :]
    panels = packed.reshape(16, 128, 8, 8)[:, n, p ^ (n % 8)].reshape(16, 128, 64)
    for hc in range(4):
        for kp in range(2):
            k = slice(64 * kp, 64 * kp + 64)
            assert torch.equal(panels[4 * hc + kp], w1[128 * hc:128 * hc + 128, k].bfloat16())
            k = slice(128 * hc + 64 * kp, 128 * hc + 64 * kp + 64)
            assert torch.equal(panels[4 * hc + 2 + kp], w2[:, k].bfloat16())


def test_packed_weights_are_made_again_only_after_a_write():
    from packppi_torch.ops.chain import pack_chain_weights, packed_chain_weights

    g = torch.Generator().manual_seed(1)
    w1, w2 = torch.randn(512, 128, generator=g), torch.randn(128, 512, generator=g)
    first = packed_chain_weights(w1, w2, torch.bfloat16)
    assert packed_chain_weights(w1, w2, torch.bfloat16) is first
    with torch.no_grad():
        w2.mul_(-1.0)                                   # an optimizer step writes in place
    again = packed_chain_weights(w1, w2, torch.bfloat16)
    assert again is not first and torch.equal(again, pack_chain_weights(w1, w2))
    # another tensor, the same values
    assert packed_chain_weights(w1.clone(), w2, torch.bfloat16) is not again
    assert packed_chain_weights(w1, w2, torch.float32) is None   # float32 reads them as they are


@pytest.mark.parametrize("H_", [32, 96, 160, 256])
def test_pack_chain_weights_lays_out_the_wgmma_panels_at_width(H_):
    """At width H the hidden is made S = min(H, 128) columns at a time: each
    of the 4H / S slices holds ceil(H / 64) W1 panels of [S n][64 k] over
    k < H, then ceil(S / 64) W2 panels of [H n][64 k] over the slice's
    columns, k past the product's depth zeros, rows swizzled by n % 8."""
    from packppi_torch.ops.chain import pack_chain_weights

    g = torch.Generator().manual_seed(0)
    w1, w2 = torch.randn(4 * H_, H_, generator=g), torch.randn(H_, 4 * H_, generator=g)
    S = min(H_, 128)
    p1, p2 = -(-H_ // 64), -(-S // 64)
    packed = pack_chain_weights(w1, w2)
    assert packed.dtype == torch.bfloat16
    assert packed.numel() == (4 * H_ // S) * 64 * (p1 * S + p2 * H_)

    def panel(at, rows):
        n, p = torch.arange(rows)[:, None], torch.arange(8)[None, :]
        block = packed[at:at + rows * 64].reshape(rows, 8, 8)
        return block[n, p ^ (n % 8)].reshape(rows, 64)

    def padded(w, k0, depth):
        out = torch.zeros(w.shape[0], 64, dtype=torch.bfloat16)
        k1 = min(k0 + 64, depth)
        out[:, :k1 - k0] = w[:, k0:k1].bfloat16()
        return out

    at = 0
    for hc in range(4 * H_ // S):
        for j in range(p1):
            assert torch.equal(panel(at, S), padded(w1[S * hc:S * hc + S], 64 * j, H_))
            at += S * 64
        for j in range(p2):
            assert torch.equal(panel(at, H_), padded(w2[:, S * hc:S * hc + S], 64 * j, S))
            at += H_ * 64
