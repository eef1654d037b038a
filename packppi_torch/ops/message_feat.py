"""IPMP message MLP over precomputed edge features (CUDA kernel + plain twin),
differentiable.

For every edge row (node i, neighbour slot k) of the kNN graph:

    x = act(h_E @ W_he + geom @ W_g + b_e + per_i[i] + pj[i, k])
    x = act(x @ W_1 + b_1) @ W_2 + b_2

with ``W_he``/``W_g`` the ``[:, H:H+He]`` and ``[:, 2H+He:]`` column blocks of
the reference's first message layer ``W_in`` [H, H + He + H + 9P]. The
neighbour term ``pj`` arrives gathered and the point geometry ``geom``
arrives computed: both stay in PyTorch, where autograd has their backward.
``pool=True`` returns the masked sum over the K edges divided by K
([B, L, H] float32); ``pool=False`` returns the edge messages [B, L, K, H]
in the stream dtype (``h_E.dtype``, also the compute dtype: ``h_E``,
``geom`` and both hidden activations are rounded to it before their
products; sums, biases, ``per_i`` and the ``pj`` addition are float32).
``act`` (``ops.activations.ACTS``, relu by default) applies to the float32
sums, as in the TPU kernel; each activation has its own kernel library.

``message_feat`` is a ``torch.autograd.Function``: its forward launches the
CUDA kernel of ``csrc/message_feat.cu`` for CUDA tensors and runs
``message_feat_plain`` for CPU tensors, and saves its inputs and no
intermediate; its backward recomputes ``message_feat_plain`` on the saved
inputs and differentiates that, so a forward pass keeps no [B*L*K, H]
activation alive. Gradients reach ``per_i``, ``pj``, ``h_E``, ``geom`` and
the six weights, not ``mask``. The kernel replaces
``packppi_tpu/ops/pallas_ipmp.py::fused_message`` (under
``fused_message_diff``), whose backward replays its plain twin in the same
way.

The kernel (and ``ops.message``'s lanes and gather kernels) reads the three
weights as one copy packed for its products (``pack_message_weights``),
made once for each version of the weights (``ops.packing.packed``).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from packppi_torch.ops import _build
from packppi_torch.ops.activations import activation
from packppi_torch.ops.packing import packed
from packppi_torch.ops.precision import matmul_f32acc


def message_rows_plain(per_i, pj, h_E, geom, w_in, b_in, w_mid, b_mid, w_out, b_out,
                       act: str = "relu"):
    """The message of every edge row, float32 [B, L, K, H], before any pool
    or cast, at the kernel's cast points.

    ``per_i`` [B, L, H] float32; ``pj`` [B, L, K, H], ``h_E`` [B, L, K, He]
    and ``geom`` [B, L, K, 9P] (any float dtype; rounded to ``h_E.dtype``);
    ``w_in`` [H, H + He + H + 9P], ``w_mid``/``w_out`` [H, H] in Linear
    layout.
    """
    cd = h_E.dtype
    H, He = per_i.shape[-1], h_E.shape[-1]
    w = w_in.float()
    x = (matmul_f32acc(h_E, w[:, H:H + He].t(), cd)
         + matmul_f32acc(geom, w[:, 2 * H + He:].t(), cd) + b_in.float())
    x = x + per_i.float()[..., None, :]
    f = activation(act)
    x = f(x + pj.float())
    x = f(matmul_f32acc(x, w_mid.float().t(), cd) + b_mid.float())
    return matmul_f32acc(x, w_out.float().t(), cd) + b_out.float()


def message_feat_plain(per_i, pj, h_E, geom, mask, w_in, b_in, w_mid, b_mid, w_out, b_out,
                       pool: bool, act: str = "relu"):
    """Plain PyTorch version of the kernel, at the kernel's cast points
    (``message_rows_plain``; ``mask`` [B, L, K])."""
    x = message_rows_plain(per_i, pj, h_E, geom, w_in, b_in, w_mid, b_mid, w_out, b_out, act)
    if pool:
        return (x * mask[..., None]).sum(-2) / float(h_E.shape[-2])
    return x.to(h_E.dtype)


class _MessageFeat(torch.autograd.Function):
    """Kernel (or plain, on the CPU) forward; recompute-the-plain backward."""

    @staticmethod
    def forward(ctx, pool, act, mask, *ops):
        ctx.pool, ctx.act = pool, act
        ctx.save_for_backward(mask, *ops)
        per_i, pj, h_E, geom, *weights = ops
        if h_E.device.type == "cpu":
            return message_feat_plain(per_i, pj, h_E, geom, mask, *weights, pool, act)
        return _message_feat_cuda(per_i, pj, h_E, geom, mask, *weights, pool, act)

    @staticmethod
    def backward(ctx, grad_out):
        mask, *ops = ctx.saved_tensors
        need = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(ops, need)]
            out = message_feat_plain(*leaves[:4], mask, *leaves[4:], ctx.pool, ctx.act)
            grads = iter(torch.autograd.grad(out, [t for t, n in zip(leaves, need) if n],
                                             grad_out.to(out.dtype)))
        return (None, None, None, *(next(grads) if n else None for n in need))


def message_feat(per_i, pj, h_E, geom, mask, w_in, b_in, w_mid, b_mid, w_out, b_out,
                 pool: bool, act: str = "relu"):
    """The differentiable message pass over precomputed features: the CUDA
    kernel for CUDA tensors, ``message_feat_plain`` for CPU tensors (see the
    module docstring for shapes). ``geom`` is taken in the stream dtype."""
    sd = h_E.dtype
    ops = (per_i, pj.to(sd), h_E, geom.to(sd), w_in, b_in, w_mid, b_mid, w_out, b_out)
    # the kernel reads raw pointers: make every saved operand contiguous
    # before the launch, so forward and backward see the same memory
    activation(act)
    return _MessageFeat.apply(pool, act, mask.contiguous(), *(t.contiguous() for t in ops))


# kernel launches on the card; the plain path never touches it
message_feat.launches = 0

_H, _G, _MAX_K = 128, 72, 64
_K1 = 208            # the first product's depth: [h_E | geom] (200), padded to a k-step
_DEPTH = _K1 + 2 * _H  # k rows of the packed weights: [W_e | W_1 | W_2]


def message_weight_matrix(w_in, w_mid, w_out):
    """[H, 464] float32: the three products' weights side by side over k,
    in Linear layout (out, in): W_e (``w_in``'s h_E and geometry column
    blocks, then 8 zero columns), W_1 (``w_mid``), W_2 (``w_out``)."""
    H, G = _H, w_in.shape[1] - 3 * _H
    pad = w_in.new_zeros(H, _K1 - H - G)
    return torch.cat([w_in[:, H:2 * H], w_in[:, 3 * H:], pad, w_mid, w_out], 1).float()


def _panel_index(device):
    """For each bf16 element of the bf16 copy, its index in the [H, 512]
    matrix ``message_weight_matrix`` padded to four 64-k panels for W_e.
    Panel p (8 of [128 n][64 k]) holds k 64 p ..; row n is 128 bytes, its
    16-byte piece q stored at q ^ (n % 8): the 128-byte swizzle that the
    kernel's wgmma descriptors read (``csrc/message_tc.cuh``)."""
    p, n, k = np.meshgrid(np.arange(8), np.arange(_H), np.arange(64), indexing="ij")
    src = n * 512 + 64 * p + k
    dst = p * _H * 64 + n * 64 + (((k >> 3) ^ (n & 7)) << 3) + (k & 7)
    index = np.empty(src.size, np.int64)
    index[dst.ravel()] = src.ravel()
    return torch.from_numpy(index).to(device)


def _fragment_index(device):
    """For each 32-bit word of the float32 copy, its index in the stacked
    TF32 parts [2 (high, low), H, 464]. Chunk c (29 of 16 k), k-step s (2
    of 8), n-tile j (16 of 8 columns), lane l, word e: part e // 2 of W(n =
    8 j + l // 4, k = 16 c + 8 s + l % 4 + 4 (e % 2)), the mma.sync
    m16n8k8 B fragment (b0, b1) of lane l, high then low parts."""
    c, s, j, lane, e = np.meshgrid(np.arange(_DEPTH // 16), np.arange(2), np.arange(16),
                                   np.arange(32), np.arange(4), indexing="ij")
    k = 16 * c + 8 * s + lane % 4 + 4 * (e % 2)
    n = 8 * j + lane // 4
    return torch.from_numpy(((e // 2) * _H * _DEPTH + n * _DEPTH + k).ravel()).to(device)


def tf32_split(w):
    """(hi, lo) with w = hi + lo to about 22 bits, as ``csrc/mma.cuh``
    ``split_tf32`` splits: hi is w rounded to 11 significant bits by
    Veltkamp's split (each step rounded in float32), lo is w - hi (exact)
    rounded to the nearest TF32 on its bits."""
    t = w * 8193.0
    hi = t - (t - w)
    lo = (((w - hi).view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    return hi, lo


_INDEX: dict = {}


def _index(fn, device):
    key = (fn, device)
    if key not in _INDEX:
        _INDEX[key] = fn(device)
    return _INDEX[key]


def pack_message_weights_bf16(w_in, w_mid, w_out):
    """The bf16 copy the bf16 message kernels stream: eight swizzled
    [128 n][64 k] panels (``_panel_index``), 128 KB; the fourth W_e panel's
    k 208-255 are zeros that the kernel never reads."""
    w = message_weight_matrix(w_in, w_mid, w_out)
    w = torch.cat([w[:, :_K1], w.new_zeros(_H, 256 - _K1), w[:, _K1:]], 1)
    return w.to(torch.bfloat16).reshape(-1)[_index(_panel_index, w.device)]


def pack_message_weights_f32(w_in, w_mid, w_out):
    """The float32 copy the float32 message kernels stream: each weight's
    TF32 high and low parts (``tf32_split``) in the order of the mma.sync B
    fragments (``_fragment_index``), 464 KB, as float32 words."""
    w = message_weight_matrix(w_in, w_mid, w_out)
    return torch.stack(tf32_split(w)).reshape(-1)[_index(_fragment_index, w.device)]


def pack_message_weights(w_in, w_mid, w_out, dtype):
    """The packed copy for a kernel of compute dtype ``dtype``, made once
    for each version of the three weights."""
    pack = pack_message_weights_bf16 if dtype == torch.bfloat16 else pack_message_weights_f32
    return packed(pack, w_in, w_mid, w_out)


def _message_feat_cuda(per_i, pj, h_E, geom, mask, w_in, b_in, w_mid, b_mid, w_out, b_out,
                       pool, act):
    B, L, K, He = h_E.shape
    sd = h_E.dtype
    if sd not in (torch.float32, torch.bfloat16):
        raise TypeError(f"message_feat kernel: stream dtype {sd} (float32 or bfloat16)")
    if He != _H or per_i.shape[-1] != _H or geom.shape[-1] != _G:
        raise ValueError(f"message_feat kernel is built for H=He={_H}, 9P={_G}; got "
                         f"H={per_i.shape[-1]}, He={He}, 9P={geom.shape[-1]}")
    if K > _MAX_K:
        raise ValueError(f"message_feat kernel takes K <= {_MAX_K} neighbours, got {K}")
    f32 = torch.float32
    expect = {
        "per_i": (per_i, (B, L, _H), f32),
        "pj": (pj, (B, L, K, _H), sd),
        "geom": (geom, (B, L, K, _G), sd),
        "mask": (mask, (B, L, K), f32),
        "w_in": (w_in, (_H, 2 * _H + He + _G), f32),
        "b_in": (b_in, (_H,), f32),
        "w_mid": (w_mid, (_H, _H), f32),
        "b_mid": (b_mid, (_H,), f32),
        "w_out": (w_out, (_H, _H), f32),
        "b_out": (b_out, (_H,), f32),
    }
    _build.check_operands("message_feat", h_E, expect)
    _build.check_aligned("message_feat", per_i=per_i, pj=pj, h_E=h_E, geom=geom)
    wpack = pack_message_weights(w_in, w_mid, w_out, sd)
    out = (torch.empty(B, L, _H, device=h_E.device, dtype=f32) if pool
           else torch.empty(B, L, K, _H, device=h_E.device, dtype=sd))
    lib = _lib(act)
    _build.launch_kernel(
        lib, "packppi_message_feat", "message_feat kernel launch", h_E.device,
        *(_build.ptr(t) for t in (per_i, pj, h_E, geom, mask, wpack, b_in, b_mid, b_out, out)),
        B * L, K, int(sd == torch.bfloat16), int(pool))
    message_feat.launches += 1
    return out


def _lib(act="relu"):
    lib = _build.load_library(_build.lib_name("message_feat", act))
    if lib.packppi_message_feat.argtypes is None:
        lib.packppi_message_feat.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_longlong]
                                             + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.packppi_message_feat.restype = ctypes.c_int
    return lib
