"""Post-message chain of one IPMP residual block (CUDA kernel + plain twin).

Over flat rows [N, H] in the stream dtype ``sd = x.dtype`` (also the
compute dtype of the FFN products):

    [msg *= mask]                              (pre_mask: edge chains)
    xx = rnd(LN_a(x + msg))                    (residual add in sd, LN in f32)
    h  = rnd(act(rnd(xx @ W1 + b1)))           (W1: [4H, H] Linear layout)
    h  = rnd(h @ W2 + b2)                      (W2: [H, 4H])
    y  = LN_b(xx + h) [* mask]                 (written in sd)

``rnd`` rounds to sd and back, at the points the unfused flax chain rounds;
LayerNorm is flax's (eps 1e-6, clamped fast variance); ``act`` is one of
``ops.activations.ACTS`` (relu by default), a kernel library per activation
and per width H (``ops._build.lib_name``; H a multiple of 32 from 32 to 256).
``chain`` launches the CUDA kernel of ``csrc/chain.cu`` for CUDA tensors and
runs ``chain_plain`` for CPU tensors. The kernel replaces
``packppi_tpu/ops/pallas_layer.py::fused_chain``. In bf16 it reads W1 and
W2 as one bf16 copy in the layout of its shared-memory panels
(``pack_chain_weights``), made once for each version of the two weights.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from packppi_torch.ops import _build
from packppi_torch.ops.activations import activation
from packppi_torch.ops.packing import packed
from packppi_torch.ops.precision import LN_EPS, matmul_f32acc, round_to


def _ln(x, w, b):
    m = x.mean(-1, keepdim=True)
    v = (x * x).mean(-1, keepdim=True) - m * m
    return (x - m) * torch.rsqrt(torch.clamp(v, min=0.0) + LN_EPS) * w.float() + b.float()


def chain_tail_plain(x0, lna_w, lna_b, w1, b1, w2, b2, lnb_w, lnb_b, sd, act="relu"):
    """The chain from the float32 residual sum ``x0`` [N, H] to
    ``LN_b(xx + h)`` (float32, before any mask), rounding to the stream
    dtype ``sd`` at the kernel's points; shared by ``chain_plain`` and the
    whole-layer passes of ``ops.layer``."""
    xx = round_to(_ln(x0, lna_w, lna_b), sd)
    h = round_to(activation(act)(round_to(matmul_f32acc(xx, w1.t(), sd) + b1.float(), sd)), sd)
    h = round_to(matmul_f32acc(h, w2.t(), sd) + b2.float(), sd)
    return _ln(xx + h, lnb_w, lnb_b)


def chain_plain(x, msg, mask: Optional[torch.Tensor], lna_w, lna_b, w1, b1, w2, b2,
                lnb_w, lnb_b, pre_mask: bool, act: str = "relu"):
    """Plain PyTorch version of the kernel (see the module docstring);
    ``mask`` is [N] float 0/1 or None."""
    sd = x.dtype
    m = msg
    if mask is not None and pre_mask:
        m = m * mask[:, None].to(m.dtype)
    x0 = (x + m.to(sd)).float()
    y = chain_tail_plain(x0, lna_w, lna_b, w1, b1, w2, b2, lnb_w, lnb_b, sd, act)
    if mask is not None:
        y = y * mask[:, None].float()
    return y.to(sd)


class _Chain(torch.autograd.Function):
    """Kernel (or plain, on the CPU) forward; recompute-the-plain backward."""

    @staticmethod
    def forward(ctx, pre_mask, act, mask, *ops):
        ctx.pre_mask, ctx.act, ctx.has_mask = pre_mask, act, mask is not None
        ctx.save_for_backward(*ops, *(() if mask is None else (mask,)))
        if ops[0].device.type == "cpu":
            return chain_plain(*ops[:2], mask, *ops[2:], pre_mask, act)
        return _chain_cuda(*ops[:2], mask, *ops[2:], pre_mask, act)

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        ops, mask = (saved[:-1], saved[-1]) if ctx.has_mask else (saved, None)
        need = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(ops, need)]
            # the rounding points inside are dtype round trips that autograd
            # passes through, as the forward's reference implementation does
            out = chain_plain(*leaves[:2], mask, *leaves[2:], ctx.pre_mask, ctx.act)
            grads = iter(torch.autograd.grad(out, [t for t, n in zip(leaves, need) if n],
                                             grad_out.to(out.dtype)))
        return (None, None, None, *(next(grads) if n else None for n in need))


def chain(x, msg, mask: Optional[torch.Tensor], lna_w, lna_b, w1, b1, w2, b2,
          lnb_w, lnb_b, pre_mask: bool, act: str = "relu"):
    """The differentiable chain: the CUDA kernel for CUDA tensors,
    ``chain_plain`` for CPU tensors. It saves its inputs and no
    intermediate; its backward recomputes ``chain_plain`` on them and
    differentiates that (as ``fused_chain_diff`` of the JAX package does), so
    the [N, 4H] hidden activation is never kept. Gradients reach ``x``,
    ``msg`` and the eight weights, not ``mask``."""
    ops = (x, msg, lna_w, lna_b, w1, b1, w2, b2, lnb_w, lnb_b)
    # the kernel reads raw pointers: contiguous before the launch, so forward
    # and backward see the same memory
    activation(act)
    return _Chain.apply(pre_mask, act, None if mask is None else mask.contiguous(),
                        *(t.contiguous() for t in ops))


# kernel launches on the card; the plain path never touches it
chain.launches = 0


def _chain_cuda(x, msg, mask, lna_w, lna_b, w1, b1, w2, b2, lnb_w, lnb_b, pre_mask, act):
    N, H = x.shape
    sd = x.dtype
    if sd not in (torch.float32, torch.bfloat16):
        raise TypeError(f"chain kernel: stream dtype {sd} (float32 or bfloat16)")
    _build.check_widths("chain kernel", H)
    if msg.dtype not in (torch.float32, sd):
        raise TypeError(f"chain kernel: msg is {msg.dtype}, expected float32 or {sd}")
    expect = {"msg": (msg, (N, H), msg.dtype)}
    if mask is not None:
        expect["mask"] = (mask, (N,), torch.float32)
    _build.check_operands("chain", x, expect)
    check_chain_weights("chain", x, lna_w, lna_b, w1, b1, w2, b2, lnb_w, lnb_b)
    _build.check_aligned("chain", w1=w1, w2=w2)
    wpack = packed_chain_weights(w1, w2, sd)
    out = torch.empty_like(x)
    lib = _lib(act, H)
    _build.launch_kernel(
        lib, "packppi_chain", "chain kernel launch", x.device,
        *(_build.ptr(t) for t in (x, msg, mask, lna_w, lna_b, w1, b1, w2, b2,
                                  lnb_w, lnb_b, wpack, out)),
        N, int(sd == torch.bfloat16), int(msg.dtype == torch.bfloat16), int(pre_mask))
    chain.launches += 1
    return out


_PANEL_K = 64


def _swizzled(n, k):
    """Offset of element (n, k) in a [rows n][64 k] bf16 panel: row n is 128
    bytes, its 16-byte piece p stored at p ^ (n % 8), the 128-byte swizzle
    that the kernels' wgmma descriptors read."""
    return n * _PANEL_K + (((k >> 3) ^ (n & 7)) << 3) + (k & 7)


def _panel_index(device, H=128):
    """For each bf16 element of the packed weights, its index in
    ``cat(W1.flatten(), W2.flatten(), [0])`` (the last index: a zero of the
    pad). The hidden is made S = min(H, 128) columns at a time, in 4H / S
    slices; slice hc holds ceil(H / 64) W1 panels of [S n][64 k], W1[S hc +
    n, 64 j + k], then ceil(S / 64) W2 panels of [H n][64 k], W2[n, S hc +
    64 j + k], each panel's k past the product's depth zeros (``_swizzled``
    within a panel). At H = 128: 16 panels of [128 n][64 k], slice by slice
    W1 (k halves) then W2, no pad."""
    S = min(H, 128)
    zero = 8 * H * H
    parts = []
    for hc in range(4 * H // S):
        for j in range(-(-H // _PANEL_K)):
            n, k = np.meshgrid(np.arange(S), np.arange(_PANEL_K), indexing="ij")
            src = np.where(_PANEL_K * j + k < H, (S * hc + n) * H + _PANEL_K * j + k, zero)
            parts.append((src, _swizzled(n, k)))
        for j in range(-(-S // _PANEL_K)):
            n, k = np.meshgrid(np.arange(H), np.arange(_PANEL_K), indexing="ij")
            src = np.where(_PANEL_K * j + k < S, 4 * H * H + n * 4 * H + S * hc + _PANEL_K * j + k,
                           zero)
            parts.append((src, _swizzled(n, k)))
    index = []
    for src, dst in parts:
        panel = np.empty(src.size, np.int64)
        panel[dst.ravel()] = src.ravel()
        index.append(panel)
    return torch.from_numpy(np.concatenate(index)).to(device)


def pack_chain_weights(w1, w2):
    """W1 [4H, H] and W2 [H, 4H] (float32) as the bf16 panels that the
    bf16 chain kernel streams into shared memory as they are (see
    ``_panel_index``)."""
    H = w1.shape[1]
    key = (w1.device, H)
    index = _PANEL_INDEX.get(key)
    if index is None:
        index = _PANEL_INDEX[key] = _panel_index(w1.device, H)
    return torch.cat([w1.reshape(-1), w2.reshape(-1), w1.new_zeros(1)]).to(torch.bfloat16)[index]


_PANEL_INDEX: dict = {}


def packed_chain_weights(w1, w2, dtype):
    """For the bf16 chain body (``dtype`` bfloat16), ``pack_chain_weights``
    of the two tensors, made again only when either is another tensor or was
    written in place since (``ops.packing.packed``); None for float32, whose
    body reads W1 and W2 as they are. The chain, folded-edge and whole-layer
    kernels take it alike."""
    return packed(pack_chain_weights, w1, w2) if dtype == torch.bfloat16 else None


def check_chain_weights(name, ref, lna_w, lna_b, w1, b1, w2, b2, lnb_w, lnb_b, H=None):
    """Device, dtype, shape and contiguity of the chain's eight weights (the
    chain, folded-edge and whole-layer kernels take them alike) at width H
    (``ref``'s last dimension unless given)."""
    f32, H = torch.float32, ref.shape[-1] if H is None else H
    _build.check_operands(name, ref, {
        "lna_w": (lna_w, (H,), f32), "lna_b": (lna_b, (H,), f32),
        "w1": (w1, (4 * H, H), f32), "b1": (b1, (4 * H,), f32),
        "w2": (w2, (H, 4 * H), f32), "b2": (b2, (H,), f32),
        "lnb_w": (lnb_w, (H,), f32), "lnb_b": (lnb_b, (H,), f32),
    })


def _lib(act="relu", H=128):
    lib = _build.load_library(_build.lib_name("chain", act, H))
    if lib.packppi_chain.argtypes is None:
        lib.packppi_chain.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.packppi_chain.restype = ctypes.c_int
    return lib
