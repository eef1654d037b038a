"""The 3xTF32 GEMM of ESM-2's linear maps on the card (marker ``gpu``;
skipped without a CUDA device): the kernel of ``csrc/gemm.cu`` against the
float64 product at every ESM-2 650M map shape, with plain TF32 as the
control that must fail; its epilogues; a full-width ESM-2 650M forward
through it against the same forward through ``F.linear``; the
tensor-parallel block on one card; a weight written in place. This file
imports neither JAX nor ``conftest``, so on a machine without JAX it runs as

    python -m pytest --noconftest -m gpu tests/test_torch_gemm_gpu.py

Limits: a product's largest gap to float64 over the product's largest
magnitude, 2e-6 (``tests/test_torch_gemm.py``: the kernel's arithmetic reads
2.5e-7 to 4.7e-7 there, plain TF32 2.7e-4 to 3.6e-4); a forward's largest
gap over its largest magnitude, 1e-4, the benchmark's ``embed_gap`` limit.
"""
import threading

import numpy as np
import pytest
import torch
import torch.nn.functional as F

pytestmark = pytest.mark.gpu

LIMIT = 2e-6
EMBED_LIMIT = 1e-4
D, FF = 1280, 5120
MAPS = {"qkv": (3 * D, D), "out": (D, D), "ffn_in": (FF, D), "ffn_out": (D, FF)}
ROWS = (1280, 1920, 4480, 1001)       # 5 rows at T = 256, 384, 896, and an odd count


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _operands(cuda, M, N, K, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(M, K, device=cuda, generator=g)
    w = (torch.rand(N, K, device=cuda, generator=g) * 2 - 1) * (6 / (N + K)) ** 0.5
    b = (torch.rand(N, device=cuda, generator=g) * 2 - 1) * 0.1
    return x, w, b


def _gap(y, ref):
    return ((y.double() - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("name", list(MAPS))
def test_kernel_holds_float64_and_tf32_fails(cuda, name, M):
    from packppi_torch.ops import gemm
    from packppi_torch.ops.message_feat import tf32_split

    N, K = MAPS[name]
    x, w, b = _operands(cuda, M, N, K)
    before = gemm.linear.launches
    with torch.no_grad():
        y = gemm.linear(x, w, b)
    assert gemm.linear.launches == before + 1
    ref = torch.addmm(b.double(), x.double(), w.double().T)
    control = torch.addmm(b, tf32_split(x)[0], tf32_split(w)[0].T)
    torch.cuda.synchronize()
    got, tf32 = _gap(y, ref), _gap(control, ref)
    print(f"{name} M = {M}: gap {got:.3e}, TF32 control {tf32:.3e}")
    assert y.shape == (M, N) and got <= LIMIT
    assert tf32 > 50 * LIMIT


@pytest.mark.parametrize("epilogue", ["none", "gelu", "residual", "no_bias"])
def test_epilogues(cuda, epilogue):
    from packppi_torch.ops import gemm

    x, w, b = _operands(cuda, 333, 5120, 1280, seed=1)
    res = torch.randn(333, 5120, device=cuda) if epilogue == "residual" else None
    bias = None if epilogue == "no_bias" else b
    with torch.no_grad():
        y = gemm.linear(x, w, bias, gelu=epilogue == "gelu", residual=res)
    ref = x.double() @ w.double().T + (0 if bias is None else bias.double())
    if epilogue == "gelu":
        ref = F.gelu(ref, approximate="none")
    if res is not None:
        ref = res.double() + ref
    assert _gap(y, ref) <= LIMIT


@pytest.mark.parametrize("D,width", [(64, 1280), (64, 640), (64, 320), (32, 640), (128, 1280)])
def test_heads_epilogue_is_the_model_s_operations_bit_for_bit(cuda, D, width):
    """q, k and v from one launch of the heads epilogue against three
    launches of the plain one followed by the model's own scale, rotary and
    transposes, at B = 3 rows of T = 200 tokens (600 rows: tiles straddle
    rows of the batch) and query widths whose tiles straddle q and k (320):
    equal bits, since the epilogue rounds as those operations do. Heads of
    another width than ``HEAD_DIM`` take ``linear_heads_plain``, with no
    launch."""
    from packppi_torch.models.esm2 import rope_tables
    from packppi_torch.ops import gemm

    B, T, K = 3, 200, 1280
    x = torch.randn(B, T, K, device=cuda)
    ws = [_operands(cuda, 1, width, K, seed=s)[1] for s in range(3)]
    bs = [_operands(cuda, 1, width, 8, seed=s)[2] for s in range(3)]
    cos, sin = rope_tables(T, D, cuda)
    scale = D ** -0.5
    before = gemm.linear.launches
    with torch.no_grad():
        got = gemm.linear_heads(x, ws, bs, cos, sin, scale)
        if D != gemm.HEAD_DIM:
            assert gemm.linear.launches == before
            want = gemm.linear_heads_plain(x, ws, bs, cos, sin, scale)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
            return
        assert gemm.linear.launches == before + 1
        q, k, v = (gemm.linear(x, w, b).reshape(B, T, -1, D).transpose(1, 2)
                   for w, b in zip(ws, bs))
        want = (gemm.apply_rope(q * scale, cos, sin), gemm.apply_rope(k, cos, sin), v)
    for g, w in zip(got, want):
        assert g.shape == (B, width // D, T, D) and g.is_contiguous() and torch.equal(g, w)


def test_autograd_keeps_f_linear_on_the_card(cuda):
    from packppi_torch.ops import gemm

    x, w, b = _operands(cuda, 64, 128, 256)
    w.requires_grad_()
    before = gemm.linear.launches
    y = gemm.linear(x, w, b)
    assert gemm.linear.launches == before and torch.equal(y, F.linear(x, w, b))
    y.sum().backward()
    assert w.grad is not None


def test_weight_written_in_place_is_split_again(cuda):
    from packppi_torch.ops import gemm

    x, w, b = _operands(cuda, 256, 1280, 1280, seed=3)
    with torch.no_grad():
        first = gemm.linear(x, w, b)
        w.mul_(-0.5)
        second = gemm.linear(x, w, b)
    assert _gap(first, x.double() @ (-2 * w.double()).T + b.double()) <= LIMIT
    assert _gap(second, x.double() @ w.double().T + b.double()) <= LIMIT


def _esm(cuda, seed=0):
    from packppi_torch.models.esm2 import ESM2, ESM2Config, init_esm_weights

    model = ESM2(ESM2Config(attention_impl="auto")).eval()
    init_esm_weights(model, seed)
    return model.to(cuda)


def _tokens(cuda, B=5, T=256, n=217, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.full((B, T), 1, np.int64)
    mask = np.zeros((B, T), np.float32)
    ids[:, 0], ids[:, n - 1] = 0, 2
    ids[:, 1:n - 1] = rng.integers(4, 24, (B, n - 2))
    mask[:, :n] = 1.0
    return torch.from_numpy(ids).to(cuda), torch.from_numpy(mask).to(cuda)


@pytest.fixture(scope="module")
def esm(cuda):
    return _esm(cuda)


def test_esm2_650m_forward_through_the_kernel_holds_embed_gap(cuda, esm, monkeypatch):
    """Five rows of 217 tokens at T = 256 (a 1BRS batch): 4 products a
    block, 132 launches, and the last hidden state within 1e-4 of the same
    forward through ``F.linear`` and the model's own rotary (cuBLAS on the
    FMA units)."""
    from packppi_torch.ops import gemm
    from packppi_torch.utils import trace

    ids, mask = _tokens(cuda)
    c0 = trace.counters()
    with torch.no_grad():
        got = esm(ids, mask)
    c1 = trace.counters()
    monkeypatch.setattr(gemm, "linear", gemm.linear_plain)
    monkeypatch.setattr(gemm, "linear_heads", gemm.linear_heads_plain)
    with torch.no_grad():
        want = esm(ids, mask)
    torch.cuda.synchronize()
    gap = _gap(got, want.double())
    print(f"ESM-2 650M, 5 x 256: gap to the F.linear forward {gap:.3e}")
    assert {k: c1[k] - c0[k] for k in c0} == {**{k: 0 for k in c0}, "attention": 33,
                                              "gemm": 132}
    assert gap <= EMBED_LIMIT


def test_tensor_parallel_blocks_on_one_card(cuda, esm):
    """Two ranks' shards (10 heads each, half the FFN) run on one card by
    two threads whose reduce sums their partial products: each rank's
    products go through the kernel on its own split shards, and its rows
    match the whole model's forward within 1e-4."""
    from packppi_torch.models.esm2 import TensorParallelESM2
    from packppi_torch.ops import gemm
    from packppi_torch.parallel.mesh import Mesh

    ids, mask = _tokens(cuda, B=2, T=384, n=322, seed=1)
    with torch.no_grad():
        want = esm(ids, mask)
    ranks = [TensorParallelESM2(esm, Mesh(data=1, model=2, rank=r), cuda) for r in range(2)]
    parts, out = [None, None], [None, None]
    meet = threading.Barrier(2)

    def reducer(r):
        def reduce(part):
            parts[r] = part
            meet.wait()
            total = parts[0] + parts[1]
            meet.wait()
            return total
        return reduce

    def run(r):
        ranks[r]._reduce = reducer(r)
        out[r] = ranks[r].forward(ids, mask)

    before = gemm.linear.launches
    threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    # two threads add to one counter: it shows that the kernel ran, not how often
    assert gemm.linear.launches > before
    for r in range(2):
        gap = _gap(out[r], want.double())
        print(f"tensor parallel rank {r}: gap {gap:.3e}")
        assert gap <= EMBED_LIMIT
