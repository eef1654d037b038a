"""The CUDA kernels against their plain versions on the card (marker
``gpu``; skipped without a CUDA device). This file imports neither JAX nor
``conftest``, so on a machine without JAX it runs as

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""
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


def _message_operands(device, dtype, B=2, L=37, K=20, seed=0):
    """Random operands of odd sizes (partial last block, K not dividing 64)."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    rot, _ = torch.linalg.qr(r(B, L, 3, 3))
    idx = torch.randint(0, L, (B, L, K), generator=g)
    mask = (torch.rand(B, L, K, generator=g) > 0.1).float()
    p_local, trans = 3 * r(B, L, P, 3), 20 * r(B, L, 3)
    pg = torch.cat([(rot[..., i, None, :] * p_local).sum(-1) + trans[..., i, None]
                    for i in range(3)], -1)
    w = lambda o, i: r(o, i) / np.sqrt(i)
    ops = (r(B, L, H), r(B, L, H).to(dtype), r(B, L, K, H).to(dtype), idx, p_local,
           rot.contiguous(), trans, pg, mask, w(H, 3 * H + 9 * P), 0.1 * r(H),
           w(H, H), 0.1 * r(H), w(H, H), 0.1 * r(H))
    return tuple(t.to(device).contiguous() for t in ops)


def _chain_operands(device, dtype, msg_dtype, N=1000, seed=1):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    ops = (r(N, H).to(dtype), r(N, H).to(msg_dtype), (torch.rand(N, generator=g) > 0.2).float(),
           1 + 0.1 * r(H), 0.1 * r(H), r(4 * H, H) / np.sqrt(H), 0.1 * r(4 * H),
           r(H, 4 * H) / np.sqrt(4 * H), 0.1 * r(H), 1 + 0.1 * r(H), 0.1 * r(H))
    return tuple(t.to(device).contiguous() for t in ops)


def _close(got, want, dtype):
    """float32: max |d| <= 1e-4. bf16, relative to max|ref| (chip_smoke.py's
    limits): max |d| <= 2^-6 rejects a dropped block's rows, mean |d| <=
    2^-16 rejects a kernel without the plain version's rounding points."""
    d = (got.float() - want.float()).abs()
    scale = want.float().abs().max().item()
    assert torch.isfinite(got.float()).all()
    if dtype == torch.float32:
        assert d.max().item() <= 1e-4
    else:
        assert d.max().item() <= 2.0 ** -6 * scale and d.mean().item() <= 2.0 ** -16 * scale


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


def test_kernels_refuse_what_they_do_not_take(cuda):
    from packppi_torch.ops.chain import chain
    from packppi_torch.ops.message import message

    ops = list(_message_operands(cuda, torch.float32))
    ops[3] = ops[3].int()                                   # idx must be int64
    with pytest.raises(TypeError, match="idx"):
        message(*ops, True)
    cops = list(_chain_operands(cuda, torch.float32, torch.float32))
    cops[0] = cops[0][:, :64]                               # H must be 128
    with pytest.raises(ValueError, match="H=128"):
        chain(*cops, False)
