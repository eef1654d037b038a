"""The port's attention (``ops.attention``) against the JAX package's, on
the CPU: ``mha_plain`` (what ``mha`` runs for CPU tensors) against the Pallas
kernel ``flash_mha`` in interpret mode, and in bf16 against the kernel body
``_mha_kernel`` called eagerly on whole arrays (XLA:CPU cannot compile the
interpreted kernel's bf16 dot) and the JAX dense path.

Tolerances: float32 max |d| <= 1e-5 (both sides sum in float32 and take a
float32 softmax; only the order of the sums differs). bf16, relative to
max|ref|: max |d| <= 2^-6 and mean |d| <= 2^-16, the limits of the port's
other bf16 kernels; the weights left unrounded (a control that must fail)
read mean |d| far above the mean limit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from packppi_tpu.ops.pallas_attention import _mha_kernel, flash_mha
from packppi_torch.ops.attention import mha, mha_plain

from torch_threads import _threads  # noqa: F401 (autouse fixture)


def _operands(B, H, T, D, pad=5, seed=17):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, T, D)).astype(np.float32) for _ in range(3))
    bias = np.zeros((B, T), np.float32)
    bias[:, T - pad:] = -1e9                                   # padded keys
    return q * D ** -0.5, k, v, bias


# the shapes of tests/test_esm2_jax.py's kernel oracle: a ragged query tail
# (T % blk_q != 0) and blk_q > T; padded keys in both
SHAPES = [((2, 3, 48, 16), 32), ((1, 2, 24, 8), 256)]


@pytest.mark.parametrize("shape,blk_q", SHAPES, ids=["ragged_tail", "blk_q_over_T"])
def test_mha_plain_matches_flash_mha_float32(shape, blk_q):
    q, k, v, bias = _operands(*shape)
    want = np.asarray(flash_mha(*(jnp.asarray(a) for a in (q, k, v, bias)), blk_q=blk_q,
                                interpret=True, highest=True))
    got = mha(*(torch.from_numpy(a) for a in (q, k, v, bias)))
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def _kernel_body(q, k, v, bias):
    """``_mha_kernel`` run eagerly per (batch, head) over the whole length."""
    B, H, T, D = q.shape
    out = np.zeros((B, H, T, D), np.float32)

    class Ref:
        def __init__(self, a):
            self.a = a

        def __getitem__(self, i):
            return self.a[i]

        def __setitem__(self, i, val):
            self.val = val

    for b in range(B):
        for h in range(H):
            o = Ref(None)
            _mha_kernel(Ref(q[b:b + 1, h:h + 1]), Ref(k[b:b + 1, h:h + 1]),
                        Ref(v[b:b + 1, h:h + 1]), Ref(bias[b:b + 1, None]), o,
                        precision=None)
            out[b, h] = np.asarray(o.val, np.float32)
    return out


def _dense_jax(q, k, v, bias):
    """The JAX dense attention path (``models/esm2.py``), bf16 operands."""
    f32 = jnp.float32
    logits = jnp.einsum("bhqd,bhkd->bhqk", q, k, preferred_element_type=f32)
    w = jax.nn.softmax(logits + bias[:, None, None, :], axis=-1)
    return np.asarray(jnp.einsum("bhqk,bhkd->bhqd", w.astype(v.dtype), v,
                                 preferred_element_type=f32))


def _rel(got, want):
    d = np.abs(got - want)
    scale = np.abs(want).max()
    return d.max() / scale, d.mean() / scale


@pytest.mark.parametrize("shape", [(2, 3, 48, 16), (1, 2, 130, 64)], ids=["small", "d64"])
def test_mha_plain_matches_jax_bfloat16(shape):
    q, k, v, bias = _operands(*shape, seed=23)
    bf = jnp.bfloat16
    jq, jk, jv = (jnp.asarray(a).astype(bf) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = mha(tq, tk, tv, torch.from_numpy(bias)).numpy()
    for want in (_kernel_body(jq, jk, jv, jnp.asarray(bias)), _dense_jax(jq, jk, jv, bias)):
        dmax, dmean = _rel(got, want)
        assert dmax <= 2.0 ** -6 and dmean <= 2.0 ** -16, (dmax, dmean)
    # control: the weights left in float32 before the second product
    logits = (torch.matmul(tq.float(), tk.float().transpose(-1, -2))
              + torch.from_numpy(bias)[:, None, None])
    unrounded = torch.matmul(torch.softmax(logits, -1), tv.float()).numpy()
    assert _rel(unrounded, want)[1] > 4 * 2.0 ** -16


def test_mha_routes_cpu_tensors_to_the_plain_version():
    q, k, v, bias = (torch.from_numpy(a) for a in _operands(1, 2, 40, 16))
    before = mha.launches
    assert torch.equal(mha(q, k, v, bias), mha_plain(q, k, v, bias))
    assert mha.launches == before
