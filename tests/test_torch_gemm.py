"""The 3xTF32 GEMM of ESM-2's linear maps (``ops.gemm``, ``csrc/gemm.cu``)
on the CPU: its arithmetic modelled in plain torch, the wrapper's refusals,
the plain route that every call off the card takes, and ESM-2 unchanged on
the CPU. ``tests/test_torch_gemm_gpu.py`` runs the kernel on the card.

The limit: the largest gap to the float64 product over the largest
magnitude of that product, 2e-6. At ESM-2 650M's widths (M = 16 rows) the
kernel's arithmetic reads 2.5e-7 to 4.7e-7 and a float32 ``F.linear``
4.5e-7 to 5.7e-7; plain TF32 (hi . hi alone, the control) reads 2.7e-4 to
3.6e-4 and must fail.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from packppi_torch.models.esm2 import ESM2, ESM2Config, apply_rope, init_esm_weights
from packppi_torch.ops import gemm
from packppi_torch.ops.message_feat import tf32_split

from torch_threads import _threads  # noqa: F401 (autouse fixture)

LIMIT = 2e-6
D, FF = 1280, 5120
# (N, K) of ESM-2 650M's products: q/k/v stacked, the attention output, the FFN's two
MAPS = [(3 * D, D), (D, D), (FF, D), (D, FF)]


def kernel_model(x, w, tile=32):
    """The kernel's sum: each k-tile of 32 summed from zero as hi_x hi_W +
    lo_x hi_W + hi_x lo_W (the stacked depth [hi_x | lo_x | hi_x] against
    [hi_W | hi_W | lo_W]), the tiles' partials added in float32 in order;
    hi_W is W as the tensor core reads it, lo_W the cached low part."""
    hx, lx = tf32_split(x)
    hw, lw = gemm.tf32_high(w), gemm.low_part(w)
    a = torch.cat([hx, lx, hx], 1).view(x.shape[0], 3, -1)
    b = torch.cat([hw, hw, lw], 1).view(w.shape[0], 3, -1)
    y = torch.zeros(x.shape[0], w.shape[0])
    for k0 in range(0, x.shape[1], tile):
        sl = slice(k0, k0 + tile)
        y = y + torch.einsum("mpk,npk->mn", a[..., sl], b[..., sl])
    return y


def tf32_model(x, w):
    return tf32_split(x)[0] @ tf32_split(w)[0].T


def _operands(N, K, M=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.uniform(-1, 1, (N, K)) * np.sqrt(6 / (N + K))).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(w)


def gap(y, ref):
    return ((y.double() - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("N,K", MAPS, ids=["qkv", "out", "ffn_in", "ffn_out"])
def test_arithmetic_holds_float32_and_tf32_fails(N, K):
    x, w = _operands(N, K)
    ref = x.double() @ w.double().T
    assert gap(kernel_model(x, w), ref) <= LIMIT
    assert gap(tf32_model(x, w), ref) > 50 * LIMIT


def test_low_part_completes_the_weight_as_the_tensor_core_reads_it():
    w1, w2 = (torch.randn(8, 12, generator=torch.Generator().manual_seed(s)) for s in (0, 1))
    w = torch.cat([w1, w2])
    lo = gemm.low_part(w1, w2)
    assert lo.shape == (16, 12) and lo.is_contiguous() and torch.equal(lo, gemm.low_part(w))
    hi = gemm.tf32_high(w)
    assert not (hi.view(torch.int32) & 0x1FFF).any()         # TF32 values, both parts
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    assert ((hi.view(torch.int32) ^ w.view(torch.int32)) & ~0x1FFF).eq(0).all()
    assert ((hi + lo - w).abs() <= 2.0 ** -22 * w.abs()).all()


def _case(M=6, N=8, K=12):
    g = torch.Generator().manual_seed(0)
    w = torch.randn(N, K, generator=g)
    return (torch.randn(M, K, generator=g), w, gemm.low_part(w), torch.randn(N, generator=g),
            torch.randn(M, N, generator=g))


@pytest.mark.parametrize("what", ["x_dtype", "weight_dtype", "lo_dtype", "bias_dtype",
                                  "residual_dtype"])
def test_kernel_refuses_a_dtype(what):
    x, w, lo, bias, res = _case()
    args = dict(x=x, weight=w, lo=lo, bias=bias, residual=res)
    args[what.split("_")[0]] = args[what.split("_")[0]].double()
    with pytest.raises(TypeError, match="gemm kernel"):
        gemm.tf32x3(args["x"], args["weight"], args["lo"], args["bias"],
                    residual=args["residual"])


def test_kernel_refuses_the_cpu_and_a_device_apart():
    x, w, lo, bias, res = _case()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        gemm.tf32x3(x, w, lo, bias, residual=res)
    with pytest.raises(ValueError, match="lo on meta"):
        gemm.tf32x3(x, w, lo.to("meta"))


@pytest.mark.parametrize("what", ["weight_rank", "lo_shape", "depth", "bias", "residual",
                                  "k_mult4", "n_mult4"])
def test_kernel_refuses_a_shape(what):
    x, w, lo, bias, res = _case()
    if what == "weight_rank":
        w = w[None]
    elif what == "lo_shape":
        lo = torch.cat([lo, lo[:1]])
    elif what == "depth":
        x = x[:, :8].contiguous()
    elif what == "bias":
        bias = bias[:4]
    elif what == "residual":
        res = res[:, :4].contiguous()
    elif what == "k_mult4":
        x, w, lo = (t[:, :10].contiguous() for t in (x, w, lo))
    else:
        w, lo, bias, res = w[:6], lo[:6], bias[:6], res[:, :6].contiguous()
    with pytest.raises(ValueError, match="gemm kernel"):
        gemm.tf32x3(x, w, lo, bias, residual=res)


@pytest.mark.parametrize("what", ["x", "weight", "lo", "residual"])
def test_kernel_refuses_a_strided_operand(what):
    x, w, lo, bias, res = _case(M=8, N=8, K=8)
    if what == "x":
        x = x.T
    elif what == "weight":
        w = w.T
    elif what == "lo":
        lo = lo.T
    else:
        res = res.T
    with pytest.raises(ValueError, match="contiguous"):
        gemm.tf32x3(x, w, lo, bias, residual=res)


def _heads_case(B=2, T=8, K=12, H=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    D = gemm.HEAD_DIM
    x = torch.randn(B, T, K, generator=g)
    w = torch.randn(3 * H * D, K, generator=g)
    return x, w, gemm.low_part(w), torch.randn(3 * H * D, generator=g), \
        torch.randn(T, D, generator=g), torch.randn(T, D, generator=g)


@pytest.mark.parametrize("what", ["x_rank", "head_width", "not_three", "heads_split",
                                  "bias", "cos", "sin_dtype", "cpu"])
def test_heads_kernel_refusals(what):
    x, w, lo, bias, cos, sin = _heads_case()
    err = ValueError
    if what == "x_rank":
        x = x[0]
    elif what == "head_width":
        cos, sin = cos[:, :32].contiguous(), sin[:, :32].contiguous()
    elif what == "not_three":
        w, lo, bias = w[:64], lo[:64], bias[:64]
    elif what == "heads_split":
        w, lo, bias = w[:168], lo[:168], bias[:168]           # 56 columns a map
    elif what == "bias":
        bias = bias[:48]
    elif what == "cos":
        cos = cos[:4].contiguous()
    elif what == "sin_dtype":
        sin, err = sin.double(), TypeError
    with pytest.raises(err, match="gemm kernel"):
        gemm.tf32x3_heads(x, w, lo, bias, cos, sin, 0.25)


def test_cpu_heads_route_is_the_model_s_operations():
    x, _, _, bias, cos, sin = _heads_case(B=3, T=8, K=12, H=2, seed=1)
    ws = list(torch.randn(3 * 128, 12, generator=torch.Generator().manual_seed(2)).split(128))
    bs = list(bias.split(128))
    before = gemm.linear.launches
    q, k, v = gemm.linear_heads(x, ws, bs, cos, sin, 0.25)
    to_heads = lambda y: y.reshape(3, 8, 2, 64).transpose(1, 2)
    want_q, want_k, want_v = (to_heads(F.linear(x, w, b)) for w, b in zip(ws, bs))
    assert torch.equal(q, gemm.apply_rope(want_q * 0.25, cos, sin))
    assert torch.equal(k, gemm.apply_rope(want_k, cos, sin)) and torch.equal(v, want_v)
    assert gemm.linear.launches == before


@pytest.mark.parametrize("gelu,with_res", [(False, False), (True, False), (False, True)],
                         ids=["plain", "gelu", "residual"])
def test_cpu_route_is_f_linear_bit_for_bit(gelu, with_res):
    x, w = _operands(64, 48, M=10, seed=1)
    b = torch.linspace(-1, 1, 64)
    res = torch.randn(10, 64) if with_res else None
    before = gemm.linear.launches
    y = gemm.linear(x, w, b, gelu=gelu, residual=res)
    want = F.linear(x, w, b)
    want = F.gelu(want, approximate="none") if gelu else want
    want = want if res is None else res + want
    assert torch.equal(y, want) and gemm.linear.launches == before


def test_autograd_route_is_f_linear_with_its_gradients():
    x, w = _operands(32, 16, M=5, seed=2)
    b = torch.zeros(32)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    twins = [t.clone().requires_grad_() for t in (x, w, b)]
    y = gemm.linear(*leaves, gelu=True)
    want = F.gelu(F.linear(*twins), approximate="none")
    assert torch.equal(y, want)
    y.square().sum().backward()
    want.square().sum().backward()
    assert all(torch.equal(a.grad, t.grad) for a, t in zip(leaves, twins))


def test_kernel_route_needs_a_cuda_tensor():
    x, w = _operands(8, 8, M=2)
    assert not gemm._kernel_takes(x, w)                     # the CPU
    meta = lambda t: t.to("meta")
    assert not gemm._kernel_takes(meta(x), meta(w))         # not a CUDA tensor either


def test_weight_split_is_kept_until_the_weight_changes():
    w = torch.randn(8, 12)
    first = gemm.packed(gemm.low_part, w)
    assert gemm.packed(gemm.low_part, w) is first
    with torch.no_grad():
        w.mul_(1.0 + 2.0 ** -20)                             # written in place
    again = gemm.packed(gemm.low_part, w)
    assert again is not first and torch.equal(again, gemm.low_part(w))


def _old_block(model, lp, x, kbias, cos, sin):
    """The block as it read before its products went through ``ops.gemm``:
    one ``F.linear`` (float32) or bf16 product a map, the GELU and the
    residual adds written out."""
    cfg = model.cfg
    B, T, _ = x.shape
    Dh = cfg.head_dim
    H = lp["attention.self.query.weight"].shape[0] // Dh
    cd = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32

    def mm(y, w, b):
        if cfg.compute_dtype == "float32":
            return F.linear(y.float(), w, b)
        bf = torch.bfloat16
        return F.linear(y.to(bf), w.to(bf)).float() + b

    def ln(y, name):
        return F.layer_norm(y.float(), (cfg.hidden_size,), lp[f"{name}.weight"],
                            lp[f"{name}.bias"], cfg.layer_norm_eps)

    def dot(y, name):
        return mm(y, lp[f"{name}.weight"], lp[f"{name}.bias"])

    h = ln(x, "attention.LayerNorm")
    to_heads = lambda y: y.reshape(B, T, H, Dh).transpose(1, 2)
    q = apply_rope(to_heads(dot(h, "attention.self.query")) * (Dh ** -0.5), cos, sin)
    k = apply_rope(to_heads(dot(h, "attention.self.key")), cos, sin)
    v = to_heads(dot(h, "attention.self.value"))
    ctx = model._attention(*(t.to(cd).contiguous() for t in (q, k, v)), kbias)
    x = x + dot(ctx.transpose(1, 2).reshape(B, T, H * Dh), "attention.output.dense")
    h = F.gelu(dot(ln(x, "LayerNorm"), "intermediate.dense"), approximate="none")
    return x + dot(h, "output.dense")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_esm2_on_the_cpu_is_unchanged(dtype, monkeypatch):
    cfg = ESM2Config(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
                     compute_dtype=dtype)
    model = ESM2(cfg).eval()
    init_esm_weights(model, 3)
    ids = torch.randint(4, 24, (3, 128), generator=torch.Generator().manual_seed(0))
    mask = torch.ones(3, 128)
    mask[1, 100:] = 0.0
    before = gemm.linear.launches
    with torch.no_grad():
        new = model(ids, mask)
        monkeypatch.setattr(ESM2, "layer_forward", lambda self, layer, *a: _old_block(
            self, dict(layer.named_parameters()), *a))
        old = model(ids, mask)
    assert torch.equal(new, old) and gemm.linear.launches == before

