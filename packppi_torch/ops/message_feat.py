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
made once for each version of the weights (``ops.packing.packed``). It
takes the widths of its operands: a library per (activation, H, He, P),
any K (``ops._build.lib_name``).
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

_H = 128
_K1 = 208            # the first product's depth: [h_E | geom] (200), padded to a k-step
_DEPTH = _K1 + 2 * _H  # k rows of the packed weights: [W_e | W_1 | W_2]


def message_depth(He, G):
    """The first product's depth He + 9P padded to a multiple of 16 (a bf16
    k-step, a float32 chunk): ``csrc/message_tc.cuh`` kIn1, 208 at the
    default widths."""
    return -(-(He + G) // 16) * 16


def message_weight_matrix(w_in, w_mid, w_out, He=None):
    """[H, kIn1 + 2H] float32 (464 at the default widths): the three
    products' weights side by side over k, in Linear layout (out, in): W_e
    (``w_in``'s h_E and geometry column blocks, then zero columns to
    ``message_depth``), W_1 (``w_mid``), W_2 (``w_out``). ``w_in`` is [H, H
    + He + H + 9P]; He defaults to H."""
    H = w_mid.shape[0]
    He = H if He is None else He
    G = w_in.shape[1] - 2 * H - He
    pad = w_in.new_zeros(H, message_depth(He, G) - He - G)
    return torch.cat([w_in[:, H:H + He], w_in[:, 2 * H + He:], pad, w_mid, w_out], 1).float()


def _panel_index(device, H=_H, k1=_K1):
    """For each bf16 element of the bf16 copy, its index in the [H, Kp]
    matrix ``message_weight_matrix`` with each weight's k padded to whole
    64-k panels (Kp = 512 at the default widths: W_e to 256). Panel p ([H
    n][64 k], 8 at the default widths) holds k 64 p ..; row n is 128 bytes,
    its 16-byte piece q stored at q ^ (n % 8): the 128-byte swizzle that
    the kernel's wgmma descriptors read (``csrc/message_tc.cuh``)."""
    panels = -(-k1 // 64) + 2 * -(-H // 64)
    p, n, k = np.meshgrid(np.arange(panels), np.arange(H), np.arange(64), indexing="ij")
    src = n * 64 * panels + 64 * p + k
    dst = p * H * 64 + n * 64 + (((k >> 3) ^ (n & 7)) << 3) + (k & 7)
    index = np.empty(src.size, np.int64)
    index[dst.ravel()] = src.ravel()
    return torch.from_numpy(index).to(device)


def _fragment_index(device, H=_H, depth=_DEPTH):
    """For each 32-bit word of the float32 copy, its index in the stacked
    TF32 parts [2 (high, low), H, depth]. Chunk c (depth / 16, 29 at the
    default widths, of 16 k), k-step s (2 of 8), n-tile j (H / 8 of 8
    columns), lane l, word e: part e // 2 of W(n = 8 j + l // 4, k = 16 c +
    8 s + l % 4 + 4 (e % 2)), the mma.sync m16n8k8 B fragment (b0, b1) of
    lane l, high then low parts."""
    c, s, j, lane, e = np.meshgrid(np.arange(depth // 16), np.arange(2), np.arange(H // 8),
                                   np.arange(32), np.arange(4), indexing="ij")
    k = 16 * c + 8 * s + lane % 4 + 4 * (e % 2)
    n = 8 * j + lane // 4
    return torch.from_numpy(((e // 2) * H * depth + n * depth + k).ravel()).to(device)


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


def _index(fn, device, *widths):
    key = (fn, device, *widths)
    if key not in _INDEX:
        _INDEX[key] = fn(device, *widths)
    return _INDEX[key]


def _pad_k(w, to):
    return torch.cat([w, w.new_zeros(w.shape[0], to - w.shape[1])], 1)


def pack_message_weights_bf16(w_in, w_mid, w_out, He=None):
    """The bf16 copy the bf16 message kernels stream: swizzled [H n][64 k]
    panels (``_panel_index``; eight, 128 KB, at the default widths), each
    weight's k padded with zeros to whole panels (the fourth W_e panel's k
    208-255 at the default widths), which the kernel never reads."""
    w = message_weight_matrix(w_in, w_mid, w_out, He)
    H = w.shape[0]
    k1 = w.shape[1] - 2 * H
    hp = 64 * -(-H // 64)
    w = torch.cat([_pad_k(w[:, :k1], 64 * -(-k1 // 64)), _pad_k(w[:, k1:k1 + H], hp),
                   _pad_k(w[:, k1 + H:], hp)], 1)
    return w.to(torch.bfloat16).reshape(-1)[_index(_panel_index, w.device, H, k1)]


def pack_message_weights_f32(w_in, w_mid, w_out, He=None):
    """The float32 copy the float32 message kernels stream: each weight's
    TF32 high and low parts (``tf32_split``) in the order of the mma.sync B
    fragments (``_fragment_index``), 464 KB at the default widths, as
    float32 words."""
    w = message_weight_matrix(w_in, w_mid, w_out, He)
    H, depth = w.shape
    return torch.stack(tf32_split(w)).reshape(-1)[_index(_fragment_index, w.device, H, depth)]


# the packing function of each (dtype, He): one object each, so that
# ops.packing.packed keeps one copy per weight version and width
_PACKERS: dict = {}


def _packer(dtype, He):
    key = (dtype == torch.bfloat16, He)
    if key not in _PACKERS:
        pack = pack_message_weights_bf16 if key[0] else pack_message_weights_f32
        _PACKERS[key] = lambda w_in, w_mid, w_out: pack(w_in, w_mid, w_out, He)
    return _PACKERS[key]


def pack_message_weights(w_in, w_mid, w_out, dtype, He=None):
    """The packed copy for a kernel of compute dtype ``dtype`` and edge
    width He (default H), made once for each version of the three
    weights."""
    He = w_mid.shape[0] if He is None else He
    return packed(_packer(dtype, He), w_in, w_mid, w_out)


def check_message_widths(name, H, He, G, K):
    """The kernels' widths from the operands (H, He, 9P and K): raise
    naming any the kernels are not built for. Returns P."""
    P, rest = divmod(G, 9)
    if rest:
        raise ValueError(f"{name} kernel: {G} geometry features are not 9 a point")
    _build.check_widths(f"{name} kernel", H, He, P)
    if K < 1:
        raise ValueError(f"{name} kernel: K={K} neighbours")
    return P


def message_weights_expect(w_in, b_in, w_mid, b_mid, w_out, b_out, H, He, G):
    """check_operands' expectations of the six message weights."""
    f32 = torch.float32
    return {
        "w_in": (w_in, (H, 2 * H + He + G), f32),
        "b_in": (b_in, (H,), f32),
        "w_mid": (w_mid, (H, H), f32),
        "b_mid": (b_mid, (H,), f32),
        "w_out": (w_out, (H, H), f32),
        "b_out": (b_out, (H,), f32),
    }


def _message_feat_cuda(per_i, pj, h_E, geom, mask, w_in, b_in, w_mid, b_mid, w_out, b_out,
                       pool, act):
    B, L, K, He = h_E.shape
    H, G = per_i.shape[-1], geom.shape[-1]
    sd = h_E.dtype
    if sd not in (torch.float32, torch.bfloat16):
        raise TypeError(f"message_feat kernel: stream dtype {sd} (float32 or bfloat16)")
    P = check_message_widths("message_feat", H, He, G, K)
    f32 = torch.float32
    expect = {
        "per_i": (per_i, (B, L, H), f32),
        "pj": (pj, (B, L, K, H), sd),
        "geom": (geom, (B, L, K, G), sd),
        "mask": (mask, (B, L, K), f32),
        **message_weights_expect(w_in, b_in, w_mid, b_mid, w_out, b_out, H, He, G),
    }
    _build.check_operands("message_feat", h_E, expect)
    _build.check_aligned("message_feat", per_i=per_i, pj=pj, h_E=h_E, geom=geom)
    wpack = pack_message_weights(w_in, w_mid, w_out, sd, He)
    out = (torch.empty(B, L, H, device=h_E.device, dtype=f32) if pool
           else torch.empty(B, L, K, H, device=h_E.device, dtype=sd))
    lib = _lib(act, H, He, P)
    _build.launch_kernel(
        lib, "packppi_message_feat", "message_feat kernel launch", h_E.device,
        *(_build.ptr(t) for t in (per_i, pj, h_E, geom, mask, wpack, b_in, b_mid, b_out, out)),
        B * L, K, int(sd == torch.bfloat16), int(pool))
    message_feat.launches += 1
    return out


def _lib(act="relu", H=128, He=128, P=8):
    lib = _build.load_library(_build.lib_name("message_feat", act, H, He, P))
    if lib.packppi_message_feat.argtypes is None:
        lib.packppi_message_feat.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_longlong]
                                             + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.packppi_message_feat.restype = ctypes.c_int
    return lib
