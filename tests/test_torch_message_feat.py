"""The port's feature-message pass on the CPU against the JAX package's
Pallas kernel ``fused_message`` (interpret mode), its plain twin
``_reference_message`` and its differentiable wrapper ``fused_message_diff``.

Tolerances: float32 <= 2e-5 (the JAX package's own kernel-vs-unfused
bound). bf16 against ``_reference_message``, which rounds the activation to
bf16 before both hidden products as the port does: the same values rounded
at the same points, so max |d| <= 2^-6 * max|ref| and mean |d| <= 2^-16 *
max|ref| (a control without rounding points must fail the mean limit).
bf16 against the kernel body ``_fused_kernel`` (called eagerly, because
XLA:CPU cannot compile the interpreted bf16 product): its second hidden
product takes the float32 activation, which XLA:CPU multiplies exactly
where a matrix unit would round it, so that comparison cannot see the
rounding point and is held to mean |d| <= 2^-10 * max|ref| only, as in
``test_torch_message.py``.
Gradients: every operand within 5e-4 of that gradient's max, the limit of
the JAX package's own fused-vs-unfused gradient tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from packppi_tpu.ops.pallas_ipmp import (_fused_kernel, _reference_message, fused_message,
                                         fused_message_diff)
from packppi_torch.ops.message_feat import message_feat, message_feat_plain

from torch_threads import _threads  # noqa: F401 (autouse fixture)

H, G, K, L = 128, 72, 16, 40
BF16_MAX_REL, BF16_MEAN_REL = 2.0 ** -6, 2.0 ** -16
GRAD_REL = 5e-4


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    f32 = np.float32
    xavier = lambda i, o: (rng.uniform(-1, 1, (i, o)) * np.sqrt(6 / (i + o))).astype(f32)
    mask = (rng.uniform(size=(L, K)) > 0.2).astype(f32)
    mask[3] = 0.0                                  # a padded node
    c = dict(per_i=rng.normal(size=(L, H)).astype(f32), pj=rng.normal(size=(L, K, H)).astype(f32),
             h_E=rng.normal(size=(L, K, H)).astype(f32),
             geom=(3 * rng.normal(size=(L, K, G))).astype(f32), mask=mask,
             # flax layout: kernels [in, out]
             w_he=xavier(H, H), w_g=xavier(G, H), b_e=rng.normal(0, .1, H).astype(f32),
             w1=xavier(H, H), b1=rng.normal(0, .1, H).astype(f32),
             w2=xavier(H, H), b2=rng.normal(0, .1, H).astype(f32),
             w_i=xavier(H, H), w_j=xavier(H, H))
    return c


def _port_operands(c, tdt):
    """(per_i, pj, h_E, geom, mask, w_in, b_in, w_mid, b_mid, w_out, b_out)
    with a batch axis of 1 and the weights in Linear layout; ``w_in`` is the
    reference's first layer over [h_i | h_E | h_j | geometry]."""
    t = lambda k: torch.from_numpy(np.ascontiguousarray(c[k]))
    w_in = np.concatenate([c["w_i"], c["w_he"], c["w_j"], c["w_g"]], 0).T
    return (t("per_i")[None], t("pj")[None].to(tdt), t("h_E")[None].to(tdt),
            t("geom")[None].to(tdt), t("mask")[None],
            torch.from_numpy(np.ascontiguousarray(w_in)), t("b_e"),
            torch.from_numpy(np.ascontiguousarray(c["w1"].T)), t("b1"),
            torch.from_numpy(np.ascontiguousarray(c["w2"].T)), t("b2"))


def _jax_operands(c, jdt):
    j = lambda k: jnp.asarray(c[k])
    return (j("per_i"), jnp.asarray(c["pj"], jdt), jnp.asarray(c["h_E"], jdt),
            jnp.asarray(c["geom"], jdt), j("mask"), j("w_he"), j("w_g"), j("b_e"),
            j("w1"), j("b1"), j("w2"), j("b2"))


def _kernel_body_eager(ops, pool, cd, act="relu"):
    """``_fused_kernel`` called eagerly on one block of all L nodes."""
    per_i, pj, he, geom, mask, w_he, w_g, b_e, w1, b1, w2, b2 = ops

    class Out:
        dtype = jnp.float32 if pool else he.dtype

        def __setitem__(self, key, value):
            self.value = value

    row = lambda a: jnp.asarray(a, jnp.float32).reshape(1, -1)
    out = Out()
    _fused_kernel(per_i, pj.reshape(L * K, H), he.reshape(L * K, H), geom.reshape(L * K, G),
                  mask, w_he, w_g, row(b_e), w1, row(b1), w2, row(b2), out,
                  K=K, act_name=act, pool=pool, compute_dtype=cd)
    return out.value if pool else out.value.reshape(L, K, H)


@pytest.mark.parametrize("pool", [True, False], ids=["node", "edge"])
def test_plain_f32_matches_pallas_kernel_and_reference(case, pool):
    ours = message_feat_plain(*_port_operands(case, torch.float32), pool)
    assert ours.dtype == torch.float32
    assert ours.shape == ((1, L, H) if pool else (1, L, K, H))
    ops = _jax_operands(case, jnp.float32)
    kw = dict(K=K, act_name="relu", pool=pool, compute_dtype=jnp.float32)
    kernel = fused_message(*ops, blk=64, interpret=True, **kw)
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(kernel), atol=2e-5, rtol=0)
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(_reference_message(*ops, **kw)),
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("pool", [True, False], ids=["node", "edge"])
def test_plain_bf16_matches_pallas_kernel_body_and_reference(case, pool):
    ours = message_feat_plain(*_port_operands(case, torch.bfloat16), pool)
    assert ours.dtype == (torch.float32 if pool else torch.bfloat16)
    ops = _jax_operands(case, jnp.bfloat16)
    refs = {"kernel body": _kernel_body_eager(ops, pool, jnp.bfloat16),
            "reference": _reference_message(*ops, K=K, act_name="relu", pool=pool,
                                            compute_dtype=jnp.bfloat16)}
    for name, ref in refs.items():
        ref = np.asarray(ref.astype(jnp.float32))
        d = np.abs(ours[0].float().numpy() - ref)
        scale = np.abs(ref).max()
        mean_rel = BF16_MEAN_REL if name == "reference" else 2.0 ** -10
        assert d.max() <= BF16_MAX_REL * scale and d.mean() <= mean_rel * scale, \
            (name, d.max() / scale, d.mean() / scale)
    # the control: no rounding point (float32 on the bf16 inputs) must fail the mean limit
    up = tuple(t.float() for t in _port_operands(case, torch.bfloat16))
    control = message_feat_plain(*up, pool)
    control = control if pool else control.bfloat16()
    ref = np.asarray(refs["reference"].astype(jnp.float32))
    assert np.abs(control[0].float().numpy() - ref).mean() > 4 * BF16_MEAN_REL * np.abs(ref).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("pool", [True, False], ids=["node", "edge"])
def test_plain_gelu_matches_pallas_kernel(case, pool, dtype):
    """Row 3 with ``act="gelu"``: float32 against the interpreted kernel
    (2e-5), bf16 against its body run eagerly (the limits above)."""
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    ours = message_feat_plain(*_port_operands(case, tdt), pool, "gelu")
    ops = _jax_operands(case, jdt)
    if dtype == "float32":
        ref = np.asarray(fused_message(*ops, K=K, act_name="gelu", pool=pool, compute_dtype=jdt,
                                       blk=64, interpret=True))
        np.testing.assert_allclose(ours[0].numpy(), ref, atol=2e-5, rtol=0)
    else:
        ref = np.asarray(_kernel_body_eager(ops, pool, jdt, "gelu").astype(jnp.float32))
        d = np.abs(ours[0].float().numpy() - ref)
        scale = np.abs(ref).max()
        assert d.max() <= BF16_MAX_REL * scale and d.mean() <= 2.0 ** -10 * scale


def test_node_variant_divides_by_k_not_by_valid_neighbours(case):
    ops = _port_operands(case, torch.float32)
    edge = message_feat_plain(*ops, False)
    node = message_feat_plain(*ops, True)
    want = (edge * ops[4][..., None]).sum(-2) / K
    np.testing.assert_allclose(node.numpy(), want.numpy(), atol=1e-6, rtol=0)
    assert float(node[0, 3].abs().max()) == 0.0        # the padded node


@pytest.mark.parametrize("pool", [True, False], ids=["node", "edge"])
def test_function_gradients_match_jax_custom_vjp(case, pool):
    """``message_feat`` (plain forward on the CPU, recomputed backward)
    against ``jax.grad`` through ``fused_message_diff(interpret=True)``, for
    every differentiable operand."""
    _check_function_gradients(case, pool, "relu")


@pytest.mark.parametrize("pool", [True, False], ids=["node", "edge"])
def test_function_gelu_gradients_match_jax_custom_vjp(case, pool):
    """The same with ``act="gelu"``: the recomputed backward differentiates
    the gelu plain version."""
    _check_function_gradients(case, pool, "gelu")


def _check_function_gradients(case, pool, act):
    rng = np.random.default_rng(5)
    cot = rng.uniform(0.5, 1.5, (L, H) if pool else (L, K, H)).astype(np.float32)

    ops = list(_port_operands(case, torch.float32))
    diff = [i for i in range(len(ops)) if i != 4]           # operand 4 is the mask
    for i in diff:
        ops[i] = ops[i].clone().requires_grad_(True)
    before = message_feat.launches
    out = message_feat(*ops, pool, act)
    loss = 0.5 * (torch.from_numpy(cot) * out[0] ** 2).sum()
    grads = dict(zip(diff, torch.autograd.grad(loss, [ops[i] for i in diff])))
    assert message_feat.launches == before                  # only kernel launches count

    jops = _jax_operands(case, jnp.float32)
    jdiff = (0, 1, 2, 3, 5, 6, 7, 8, 9, 10, 11)

    def jloss(*a):
        full = list(jops)
        for i, v in zip(jdiff, a):
            full[i] = v
        out = fused_message_diff(*full, K=K, act_name=act, pool=pool, blk=64,
                                 compute_dtype=jnp.float32, interpret=True)
        return 0.5 * (jnp.asarray(cot) * out ** 2).sum()

    jg = dict(zip(jdiff, jax.grad(jloss, argnums=tuple(range(len(jdiff))))(
        *[jops[i] for i in jdiff])))
    gw_in = grads[5].numpy()
    pairs = {
        "per_i": (grads[0][0].numpy(), jg[0]), "pj": (grads[1][0].numpy(), jg[1]),
        "h_E": (grads[2][0].numpy(), jg[2]), "geom": (grads[3][0].numpy(), jg[3]),
        "w_he": (gw_in[:, H:2 * H].T, jg[5]), "w_g": (gw_in[:, 3 * H:].T, jg[6]),
        "b_e": (grads[6].numpy(), jg[7]), "w1": (grads[7].numpy().T, jg[8]),
        "b1": (grads[8].numpy(), jg[9]), "w2": (grads[9].numpy().T, jg[10]),
        "b2": (grads[10].numpy(), jg[11]),
    }
    for name, (got, want) in pairs.items():
        want = np.asarray(want)
        assert np.isfinite(got).all(), name
        np.testing.assert_allclose(got, want, atol=GRAD_REL * np.abs(want).max(), rtol=0,
                                   err_msg=name)
    # the h_i and h_j column blocks of W_in are not this pass's operands
    assert not gw_in[:, :H].any() and not gw_in[:, 2 * H:3 * H].any()


def test_function_bf16_gradients_are_finite_and_typed(case):
    ops = list(_port_operands(case, torch.bfloat16))
    for i in (0, 1, 2, 3, 5):
        ops[i] = ops[i].clone().requires_grad_(True)
    out = message_feat(*ops, False)
    assert out.dtype == torch.bfloat16
    grads = torch.autograd.grad(out.float().pow(2).sum(), [ops[i] for i in (0, 1, 2, 3, 5)])
    assert [g.dtype for g in grads] == [torch.float32, torch.bfloat16, torch.bfloat16,
                                        torch.bfloat16, torch.float32]
    assert all(bool(g.isfinite().all()) for g in grads)


def test_wrapper_takes_plain_version_on_cpu_and_makes_operands_contiguous(case):
    ops = list(_port_operands(case, torch.float32))
    ops[3] = ops[3].transpose(1, 2).contiguous().transpose(1, 2)   # same values, strided
    assert not ops[3].is_contiguous()
    before = message_feat.launches
    with torch.no_grad():
        np.testing.assert_array_equal(message_feat(*ops, True).numpy(),
                                      message_feat_plain(*ops, True).numpy())
    assert message_feat.launches == before
