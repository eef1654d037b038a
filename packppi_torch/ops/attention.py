"""Multi-head attention with an additive key bias (CUDA kernel + plain twin).

    out = softmax(q @ k^T + key_bias) @ v        per (batch, head)

q, k, v are [B, H, T, D] float32 or bf16 and key_bias [B, T] float32 (0 on
real keys, -1e9 on padded ones); the result is [B, H, T, D] float32. The
logits and the softmax are float32; the weights are rounded to the input
type before the second product; both products sum in float32 (bf16
operands: exact bf16 products, float32 sums). This is the dense attention
of ESM-2 and the JAX layout of its attention kernel.

``mha`` launches the CUDA kernel of ``csrc/attention.cu`` for CUDA tensors
and runs ``mha_plain`` for CPU tensors. The kernel replaces
``packppi_tpu/ops/pallas_attention.py::flash_mha``.
"""
from __future__ import annotations

import ctypes

import torch

from packppi_torch.ops import _build

HEAD_DIMS = (16, 32, 64, 128)   # the ESM-2 family's head widths


def mha_plain(q, k, v, key_bias):
    """Plain PyTorch version of the kernel (see the module docstring)."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) + key_bias.float()[:, None, None]
    w = torch.softmax(logits, dim=-1)
    return torch.matmul(w.to(v.dtype).float(), v.float())


def mha(q, k, v, key_bias):
    """The attention: the CUDA kernel for CUDA tensors, ``mha_plain`` for
    CPU tensors."""
    if q.device.type == "cpu":
        return mha_plain(q, k, v, key_bias)
    return _mha_cuda(q, k, v, key_bias)


# kernel launches on the card; the plain path never touches it
mha.launches = 0


def _mha_cuda(q, k, v, key_bias):
    B, H, T, D = q.shape
    dt = q.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attention kernel: q is {dt} (float32 or bfloat16)")
    if D not in HEAD_DIMS:
        raise ValueError(f"attention kernel: head width {D} (one of {HEAD_DIMS})")
    _build.check_operands("attention", q, {
        "k": (k, (B, H, T, D), dt), "v": (v, (B, H, T, D), dt),
        "key_bias": (key_bias, (B, T), torch.float32)})
    _build.check_aligned("attention", q=q, k=k, v=v)
    out = torch.empty(B, H, T, D, dtype=torch.float32, device=q.device)
    lib = _lib()
    _build.launch_kernel(
        lib, "packppi_mha", "attention kernel launch", q.device,
        *(_build.ptr(t) for t in (q, k, v, key_bias, out)),
        B, H, T, D, int(dt == torch.bfloat16))
    mha.launches += 1
    return out


def _lib():
    lib = _build.load_library("attention")
    if lib.packppi_mha.argtypes is None:
        lib.packppi_mha.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.packppi_mha.restype = ctypes.c_int
    return lib
