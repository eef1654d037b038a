"""The float32 arithmetic of the tensor-core kernels (``csrc/mma.cuh``),
modelled in plain torch on the CPU and held to the JAX package's float32
kernels before any card runs it.

The attention and chain kernels compute float32 products as 3xTF32: each
operand x is split into hi = x rounded to the nearest TF32 (11 significant
bits, by Veltkamp's split) and lo = x - hi (exact in float32) rounded to
the nearest TF32 on its bits; a . b is summed as hi_a . hi_b + lo_a . hi_b
+ hi_a . lo_b in float32. Here that model replaces the plain versions'
float32 products, and the result is held to the limits the port's float32
kernels answer to:

- the chain against ``fused_chain`` (interpreted), max |d| <= 3e-5, as
  ``tests/test_torch_chain.py`` holds the plain chain;
- attention against ``flash_mha(interpret=True, highest=True)``, max |d| <=
  1e-5, as ``tests/test_torch_attention.py`` holds ``mha_plain``.

The control: plain TF32 (hi . hi alone) must fail the same limits, so the
limits can tell the two schemes apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from packppi_tpu.ops.pallas_attention import flash_mha
from packppi_tpu.ops.pallas_layer import fused_chain
from packppi_torch.ops.activations import ACTS
from packppi_torch.ops.chain import _ln

from torch_threads import _threads  # noqa: F401 (autouse fixture)

CHAIN_TOL, ATTN_TOL = 3e-5, 1e-5


def veltkamp(x):
    """x rounded to 11 significant bits (TF32) as the kernels round hi:
    t = (2^13 + 1) x, hi = t - (t - x), each step rounded in float32."""
    t = x * 8193.0
    return t - (t - x)


def tf32(x):
    """x rounded to the nearest TF32 on its bits, as the kernels round lo:
    half of the 13 dropped bits' range added to the magnitude, then the
    bits cleared."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_cut(x):
    """x cut to TF32 (the 13 low mantissa bits cleared): the split the
    kernels do not use, for the bias check."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def mm_3xtf32(a, b):
    ah, bh = veltkamp(a), veltkamp(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return torch.matmul(ah, bh) + torch.matmul(al, bh) + torch.matmul(ah, bl)


def mm_tf32(a, b):
    return torch.matmul(tf32(a), tf32(b))


def test_tf32_rounding_and_split():
    one = torch.tensor([1.0, -1.0])
    assert torch.equal(tf32(one + one * 2.0 ** -10), one + one * 2.0 ** -10)   # kept
    assert torch.equal(tf32(one + one * (2.0 ** -11 + 2.0 ** -12)),
                       one + one * 2.0 ** -10)                                 # rounded up
    assert torch.equal(tf32(one + one * 2.0 ** -12), one)                      # rounded down
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi = veltkamp(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert ((x - hi).abs() <= 2.0 ** -11 * x.abs()).all()
    lo = tf32(x - hi)
    assert ((x - hi - lo).abs() <= 2.0 ** -22 * x.abs()).all()
    # cut instead of rounded, the split shrinks every operand on average;
    # rounded, its signed relative error averages less than half of that
    bias = lambda e: (e * x.sign() / x.abs()).double().mean().item()
    hc = tf32_cut(x)
    assert abs(bias(x - hi - lo)) < 0.5 * bias(x - hc - tf32_cut(x - hc))


def _chain_model(c, edge, mm, act="relu"):
    t = lambda k: torch.from_numpy(c[k])
    mask = t("mask")[:, None]
    msg = t("msg") * mask if edge else t("msg")
    xx = _ln(t("x") + msg, t("lna_s"), t("lna_b"))
    h = ACTS[act](mm(xx, t("f1")) + t("f1b"))
    h = mm(h, t("f2")) + t("f2b")
    return (_ln(xx + h, t("lnb_s"), t("lnb_b")) * mask).numpy()


def _chain_case(H, N=300):
    rng = np.random.default_rng(0)
    f32 = np.float32
    xavier = lambda i, o: (rng.uniform(-1, 1, (i, o)) * np.sqrt(6 / (i + o))).astype(f32)
    return dict(
        x=rng.normal(size=(N, H)).astype(f32), msg=rng.normal(size=(N, H)).astype(f32),
        mask=(rng.uniform(size=N) > 0.2).astype(f32),
        lna_s=rng.uniform(0.5, 1.5, H).astype(f32), lna_b=rng.normal(0, .1, H).astype(f32),
        f1=xavier(H, 4 * H), f1b=rng.normal(0, .1, 4 * H).astype(f32),
        f2=xavier(4 * H, H), f2b=rng.normal(0, .1, H).astype(f32),
        lnb_s=rng.uniform(0.5, 1.5, H).astype(f32), lnb_b=rng.normal(0, .1, H).astype(f32))


@pytest.mark.parametrize("edge,act", [(False, "relu"), (True, "relu"), (True, "gelu")],
                         ids=["node", "edge", "edge-gelu"])
def test_chain_3xtf32_holds_the_float32_limit(edge, act):
    """The activation sits between the two products, on the float32 sum,
    where the JAX kernel applies its ``act_name``."""
    _check_chain_3xtf32(_chain_case(128), edge, act)


@pytest.mark.parametrize("edge", [False, True], ids=["node", "edge"])
@pytest.mark.parametrize("H", [64, 256])
def test_chain_3xtf32_holds_the_float32_limit_at_width(H, edge):
    """The same at hidden width H (the FFN 4H wide), where the JAX kernel
    takes its widths from the weights."""
    _check_chain_3xtf32(_chain_case(H), edge, "relu")


def _check_chain_3xtf32(c, edge, act):
    j = lambda k: jnp.asarray(c[k])
    want = np.asarray(fused_chain(
        j("x"), j("msg"), j("mask")[:, None], j("lna_s"), j("lna_b"), j("f1"), j("f1b"),
        j("f2"), j("f2b"), j("lnb_s"), j("lnb_b"), act_name=act, compute_dtype=jnp.float32,
        pre_mask=edge, interpret=True))
    got = np.abs(_chain_model(c, edge, mm_3xtf32, act) - want).max()
    control = np.abs(_chain_model(c, edge, mm_tf32, act) - want).max()
    assert got <= CHAIN_TOL, got
    assert control > CHAIN_TOL, control


def test_attention_3xtf32_holds_the_float32_limit():
    B, H, T, D = 1, 2, 96, 64
    rng = np.random.default_rng(17)
    q, k, v = (rng.standard_normal((B, H, T, D)).astype(np.float32) for _ in range(3))
    q *= D ** -0.5
    bias = np.zeros((B, T), np.float32)
    bias[:, T - 5:] = -1e9
    want = np.asarray(flash_mha(*(jnp.asarray(a) for a in (q, k, v, bias)), blk_q=32,
                                interpret=True, highest=True))
    tq, tk, tv, tb = (torch.from_numpy(a) for a in (q, k, v, bias))

    def model(mm):
        w = torch.softmax(mm(tq, tk.transpose(-1, -2)) + tb[:, None, None], dim=-1)
        return mm(w, tv).numpy()

    got = np.abs(model(mm_3xtf32) - want).max()
    control = np.abs(model(mm_tf32) - want).max()
    assert got <= ATTN_TOL, got
    assert control > ATTN_TOL, control
