"""Float32-accurate linear maps on the tensor cores (CUDA kernel + plain twin).

    y = residual + gelu(x . W^T + b)        gelu and residual optional

x is [..., K] float32, W [N, K] (``nn.Linear``'s layout), b [N], the
residual [..., N], y [..., N] float32; gelu is the erf form
(``F.gelu(approximate="none")``). This is ESM-2's every linear map.

``linear`` launches the kernel of ``csrc/gemm.cu`` where the call allows it:
x on the card, float32 operands, and no operand that requires a gradient
under autograd. The kernel computes the product as 3xTF32 (three TF32
products of the split operands, summed in float32: ``csrc/mma.cuh``) at up
to the tensor cores' 165 TFLOP/s where cuBLAS's float32 GEMM runs on the
FMA units; TF32 itself stays off (``packppi_torch/__init__.py``). Every
other call, on the CPU, under bf16 operands or under autograd, runs
``linear_plain``: ``F.linear``, then ``F.gelu``, then the residual added, as
the model wrote them before the kernel.

``linear_heads`` gives ESM-2's attention inputs, the query (scaled, with
rotary), the key (with rotary) and the value in the attention's [B, H, T,
D] layout: on the card one launch over the three weights stacked, whose
epilogue scales, rotates and lays out the heads; elsewhere
``linear_heads_plain``, the model's own operations (``apply_rope``).

The kernel reads each weight twice: the weight itself, whose float32
values the tensor core reads as TF32 by dropping their low 13 bits, and its
low part (``low_part``: what those bits hold, rounded to the nearest TF32),
[N, K], made once per weight version (``ops.packing.packed``), so a forward
over unchanged weights splits nothing; a tensor-parallel rank's shards are
split under the same cache. The heads epilogue reads the three weights
stacked, a copy kept under the same cache. The kernel replaces no TPU
kernel: the JAX package leaves these products to XLA.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from packppi_torch.ops import _build
from packppi_torch.ops.packing import packed


def linear_plain(x, weight, bias=None, *, gelu=False, residual=None):
    """Plain PyTorch version of the kernel (see the module docstring)."""
    y = F.linear(x, weight, bias)
    if gelu:
        y = F.gelu(y, approximate="none")
    return y if residual is None else residual + y


def _kernel_takes(x, *tensors) -> bool:
    """Whether ``linear`` launches the kernel for these operands."""
    ts = [t for t in (x, *tensors) if t is not None]
    return (x.is_cuda and all(t.dtype == torch.float32 for t in ts)
            and not (torch.is_grad_enabled() and any(t.requires_grad for t in ts)))


def linear(x, weight, bias=None, *, gelu=False, residual=None):
    """The linear map: the kernel where the call allows it (module
    docstring), ``linear_plain`` everywhere else."""
    if not _kernel_takes(x, weight, bias, residual):
        return linear_plain(x, weight, bias, gelu=gelu, residual=residual)
    return tf32x3(x.contiguous(), weight.contiguous(), packed(low_part, weight), bias,
                  gelu=gelu, residual=None if residual is None else residual.contiguous())


# kernel launches on the card; the plain path never touches it
linear.launches = 0


HEAD_DIM = 64   # the heads epilogue's head width: ESM-2's, at every size


def apply_rope(x, cos, sin):
    """x [B, H, T, D]: x * cos + rotate_half(x) * sin, rotate_half = (-x2, x1)."""
    d = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., d:], x[..., :d]], -1) * sin


def linear_heads_plain(x, weights, biases, cos, sin, scale):
    """Plain PyTorch version of ``linear_heads``."""
    B, T, _ = x.shape
    D = cos.shape[-1]
    q, k, v = (linear_plain(x, w, b).reshape(B, T, -1, D).transpose(1, 2)
               for w, b in zip(weights, biases))
    return apply_rope(q * scale, cos, sin), apply_rope(k, cos, sin), v


def linear_heads(x, weights, biases, cos, sin, scale):
    """ESM-2's attention inputs from x [B, T, K] and the query, key and
    value maps (``weights`` and ``biases``, three each): q = rope(scale (x
    Wq^T + bq)), k = rope(x Wk^T + bk), v = x Wv^T + bv, each [B, H, T, D]
    with D = cos.shape[-1]; rope is ``apply_rope`` with cos, sin [T, D]. On
    the card (as ``linear``) one launch of the heads epilogue, whose
    float32 operations after the product are ``apply_rope``'s, and three
    contiguous outputs; elsewhere ``linear_heads_plain``."""
    D = cos.shape[-1]
    if not (_kernel_takes(x, *weights, *biases, cos, sin) and x.dim() == 3 and D == HEAD_DIM
            and all(b is not None for b in biases) and weights[0].shape[0] % D == 0
            and all(w.shape == weights[0].shape for w in weights)):
        return linear_heads_plain(x, weights, biases, cos, sin, scale)
    return tf32x3_heads(x.contiguous(), packed(_stacked, *weights), packed(low_part, *weights),
                        packed(_stacked, *biases), cos, sin, scale).unbind(0)


def tf32_high(w):
    """w as the tensor core reads a float32 operand: its low 13 bits
    dropped, a TF32 value cut toward zero."""
    return (w.view(torch.int32) & ~0x1FFF).view(torch.float32)


def low_part(*weights):
    """The kernel's low part of one or more [N_i, K] weights stacked along
    N, [sum N_i, K]: w - ``tf32_high(w)`` (exact) rounded to the nearest
    TF32 on its bits, as ``message_feat.tf32_split`` rounds its low part;
    ``tf32_high(w)`` plus it is w to 2^-22 of |w|."""
    w = (torch.cat(weights) if len(weights) > 1 else weights[0]).detach().float()
    lo = w - tf32_high(w)
    return ((lo.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _stacked(*tensors):
    """Weights or biases stacked along N, as ``low_part`` stacks weights."""
    return torch.cat([t.detach() for t in tensors])


def _check(x, weight, lo, expect):
    """x [..., K], the weight and its low part [N, K] float32 (N and K
    positive multiples of 4), and the operands ``expect``
    (``_build.check_operands``), all contiguous, 16-byte aligned and on one
    card; returns (M, N, K)."""
    f32 = torch.float32
    if x.dtype != f32:
        raise TypeError(f"gemm kernel: x is {x.dtype}, expected {f32}")
    if x.dim() < 1 or weight.dim() != 2:
        raise ValueError(f"gemm kernel: x {tuple(x.shape)} and weight {tuple(weight.shape)} "
                         "(x [..., K], weight [N, K])")
    N, K = weight.shape
    if K % 4 or N % 4 or not K or not N:
        raise ValueError(f"gemm kernel: K = {K} and N = {N} must be positive multiples of 4")
    if x.shape[-1] != K:
        raise ValueError(f"gemm kernel: x has depth {x.shape[-1]}, the weight {K}")
    expect = {"weight": (weight, (N, K), f32), "lo": (lo, (N, K), f32), **expect}
    _build.check_operands("gemm", x, expect)
    _build.check_aligned("gemm", x=x, **{k: t for k, (t, _, _) in expect.items()})
    if not x.is_cuda:
        raise ValueError(f"gemm kernel: needs CUDA tensors, x is on {x.device}")
    return x.numel() // K, N, K


def tf32x3(x, weight, lo, bias=None, *, gelu=False, residual=None):
    """The kernel: ``x`` [..., K] against ``weight`` [N, K] and its low part
    ``lo`` (``low_part``), plus ``bias`` [N], erf-GELU if ``gelu``, plus
    ``residual`` [..., N]; every operand float32, contiguous, 16-byte
    aligned and on one card, K and N multiples of 4. Raises on anything
    else, the CPU included."""
    f32, lead, N = torch.float32, x.shape[:-1], weight.shape[0] if weight.dim() == 2 else 0
    expect = {}
    if bias is not None:
        expect["bias"] = (bias, (N,), f32)
    if residual is not None:
        expect["residual"] = (residual, (*lead, N), f32)
    M, N, K = _check(x, weight, lo, expect)
    out = torch.empty(*lead, N, dtype=f32, device=x.device)
    if M == 0:
        return out
    _build.launch_kernel(
        _lib(), "packppi_gemm_tf32x3", "gemm kernel launch", x.device,
        *(_build.ptr(t) for t in (x, weight, lo, bias, residual, out)), M, N, K, int(gelu))
    linear.launches += 1
    return out


def tf32x3_heads(x, weight, lo, bias, cos, sin, scale):
    """The kernel with the heads epilogue (``linear_heads``): ``x`` [B, T,
    K] against ``weight`` [3 D', K] (query, key and value stacked) and its
    low part ``lo``, plus ``bias`` [3 D'], q scaled by ``scale``, q and k
    rotated by ``cos`` and ``sin`` [T, D] (D = ``HEAD_DIM``, dividing D').
    Returns [3, B, D' / D, T, D]. Raises as ``tf32x3``, and unless D and D'
    fit."""
    f32 = torch.float32
    if x.dim() != 3 or cos.dim() != 2:
        raise ValueError(f"gemm kernel: x {tuple(x.shape)} and cos {tuple(cos.shape)} "
                         "(x [B, T, K], cos and sin [T, D])")
    B, T = x.shape[:2]
    N, D = weight.shape[0] if weight.dim() == 2 else 0, cos.shape[1]
    if D != HEAD_DIM or N % 3 or (N // 3) % D:
        raise ValueError(f"gemm kernel: heads of {D} (the kernel's are {HEAD_DIM}) do not "
                         f"divide the query's {N / 3:g} columns")
    M, N, K = _check(x, weight, lo, {"bias": (bias, (N,), f32), "cos": (cos, (T, D), f32),
                                     "sin": (sin, (T, D), f32)})
    out = torch.empty(3, B, N // 3 // D, T, D, dtype=f32, device=x.device)
    if M == 0:
        return out
    _build.launch_kernel(
        _lib(), "packppi_gemm_tf32x3_heads", "gemm kernel launch", x.device,
        *(_build.ptr(t) for t in (x, weight, lo, bias, cos, sin, out)), M, N, K, T, D,
        ctypes.c_float(scale))
    linear.launches += 1
    return out


def _lib():
    lib = _build.load_library("gemm")
    if lib.packppi_gemm_tf32x3.argtypes is None:
        lib.packppi_gemm_tf32x3.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                                            + [ctypes.c_void_p])
        lib.packppi_gemm_tf32x3.restype = ctypes.c_int
        lib.packppi_gemm_tf32x3_heads.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                                                  + [ctypes.c_float, ctypes.c_void_p])
        lib.packppi_gemm_tf32x3_heads.restype = ctypes.c_int
    return lib
