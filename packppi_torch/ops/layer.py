"""One whole IPMP layer in two passes (CUDA kernels + plain twins).

Over the message operands of ``ops.message_feat`` (``per_i`` float32, the
neighbour term ``pjg`` gathered and the geometry ``geom`` computed, both in
the stream dtype ``sd``) and the chain's weights, with ``sd`` also the
compute dtype:

* ``layer_node``: the message of every edge, masked, pooled as
  ``sum * (1/K)``; ``x0 = h_V + rnd(pooled)``; then the chain
  (``ops.chain.chain_tail_plain``) and ``* mask_V``. Out [B, L, H] in sd.
* ``layer_edge``: ``x0 = h_E + rnd(message * mask)``, the message masked in
  float32; then the chain and ``* mask``. Out [B, L, K, H] in sd.

``rnd`` rounds to sd. Unlike the message-then-chain path, the residual sum
``x0`` is not rounded before the first LayerNorm: these are the rounding
points of ``packppi_tpu/ops/pallas_layer.py::_node_kernel`` and
``_edge_kernel``, which the kernels of ``csrc/layer.cu`` replace (entry
``fused_ipmp_layer``). The kernels run the message kernels' tensor-core
body and the chain kernel's, over the packed copies of the message weights
(``ops.message_feat.pack_message_weights``) and, in bf16, of the chain's
(``ops.chain.packed_chain_weights``). Each wrapper launches its kernel for
CUDA tensors and runs its plain twin for CPU tensors, and counts its
launches. ``act`` (``ops.activations.ACTS``, relu by default; a kernel
library per activation) is the message MLP's and the chain FFN's
activation, as ``act_name`` is the TPU kernels'. The widths H, He and P
are the operands' (a library per width, ``ops._build.lib_name``; the edge
pass adds the message to h_E, so it needs He = H), K any count.
"""
from __future__ import annotations

import ctypes

import torch

from packppi_torch.ops import _build
from packppi_torch.ops.chain import chain_tail_plain, check_chain_weights, packed_chain_weights
from packppi_torch.ops.message_feat import (check_message_widths, message_rows_plain,
                                            message_weights_expect, pack_message_weights)
from packppi_torch.ops.precision import round_to

# nodes a block of the node kernel pools before it runs one chain on them
# (csrc/layer.cu, "Blocking"); at most 16, at any K (a node of K > 64 edges
# takes its ceil(K / 64) message tiles in turn, the pooled tile is the
# same). At T1124 in bf16 (L = 768, K = 32) a node pass took 0.0404 /
# 0.0444 / 0.0596 / 0.0925 ms with 2 / 4 / 8 / 16 nodes a block
# (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W)
NODES_PER_BLOCK = 2


def layer_node_plain(h_V, per_i, pjg, h_E, geom, mask, mask_V,
                     w_in, b_in, w_mid, b_mid, w_out, b_out,
                     lna_w, lna_b, w1, b1, w2, b2, lnb_w, lnb_b, act: str = "relu"):
    """Plain version of the node pass: ``h_V`` [B, L, H] in sd, ``mask``
    [B, L, K], ``mask_V`` [B, L] float 0/1."""
    sd = h_V.dtype
    H, K = h_V.shape[-1], h_E.shape[-2]
    x = message_rows_plain(per_i, pjg, h_E, geom, w_in, b_in, w_mid, b_mid, w_out, b_out, act)
    pooled = (x * mask[..., None]).sum(-2) * (1.0 / K)
    x0 = h_V.float() + round_to(pooled, sd)
    y = chain_tail_plain(x0.reshape(-1, H), lna_w, lna_b, w1, b1, w2, b2, lnb_w, lnb_b, sd,
                         act)
    return (y.reshape(h_V.shape) * mask_V[..., None].float()).to(sd)


def layer_edge_plain(h_E, per_i, pjg, geom, mask,
                     w_in, b_in, w_mid, b_mid, w_out, b_out,
                     lna_w, lna_b, w1, b1, w2, b2, lnb_w, lnb_b, act: str = "relu"):
    """Plain version of the edge pass: ``h_E`` [B, L, K, H] in sd (the
    message's input and the residual), ``mask`` [B, L, K]."""
    sd = h_E.dtype
    H = h_E.shape[-1]
    x = message_rows_plain(per_i, pjg, h_E, geom, w_in, b_in, w_mid, b_mid, w_out, b_out, act)
    x0 = h_E.float() + round_to(x * mask[..., None], sd)
    y = chain_tail_plain(x0.reshape(-1, H), lna_w, lna_b, w1, b1, w2, b2, lnb_w, lnb_b, sd,
                         act)
    return (y.reshape(h_E.shape) * mask[..., None].float()).to(sd)


def layer_node(h_V, per_i, pjg, h_E, geom, mask, mask_V,
               w_in, b_in, w_mid, b_mid, w_out, b_out,
               lna_w, lna_b, w1, b1, w2, b2, lnb_w, lnb_b, nodes_per_block=None,
               act: str = "relu"):
    """The node pass: the CUDA kernel for CUDA tensors, ``layer_node_plain``
    for CPU tensors. ``nodes_per_block`` (1-16) sets the kernel's blocking
    only (default ``NODES_PER_BLOCK``)."""
    ops = (h_V, per_i, pjg, h_E, geom, mask, mask_V, w_in, b_in, w_mid, b_mid, w_out, b_out,
           lna_w, lna_b, w1, b1, w2, b2, lnb_w, lnb_b)
    if h_E.device.type == "cpu":
        return layer_node_plain(*ops, act)
    return _layer_node_cuda(ops, NODES_PER_BLOCK if nodes_per_block is None else nodes_per_block,
                            act)


def layer_edge(h_E, per_i, pjg, geom, mask,
               w_in, b_in, w_mid, b_mid, w_out, b_out,
               lna_w, lna_b, w1, b1, w2, b2, lnb_w, lnb_b, act: str = "relu"):
    """The edge pass: the CUDA kernel for CUDA tensors, ``layer_edge_plain``
    for CPU tensors."""
    ops = (h_E, per_i, pjg, geom, mask, w_in, b_in, w_mid, b_mid, w_out, b_out,
           lna_w, lna_b, w1, b1, w2, b2, lnb_w, lnb_b)
    if h_E.device.type == "cpu":
        return layer_edge_plain(*ops, act)
    return _layer_edge_cuda(ops, act)


# kernel launches on the card; the plain path never touches them
layer_node.launches = 0
layer_edge.launches = 0

_MAX_NODES = 16
_F32 = torch.float32


def _message_expect(name, h_E, per_i, pjg, geom, mask, w_in, b_in, w_mid, b_mid, w_out, b_out):
    """Checks the message operands; returns (B, L, K, sd, (H, He, P))."""
    B, L, K, He = h_E.shape
    H, G = per_i.shape[-1], geom.shape[-1]
    sd = h_E.dtype
    if sd not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} kernel: stream dtype {sd} (float32 or bfloat16)")
    P = check_message_widths(name, H, He, G, K)
    _build.check_operands(name, h_E, {
        "per_i": (per_i, (B, L, H), _F32),
        "pjg": (pjg, (B, L, K, H), sd),
        "geom": (geom, (B, L, K, G), sd),
        "mask": (mask, (B, L, K), _F32),
        **message_weights_expect(w_in, b_in, w_mid, b_mid, w_out, b_out, H, He, G),
    })
    return B, L, K, sd, (H, He, P)


def _packed(name, sd, He, w_in, w_mid, w_out, w1, w2, **streams):
    """The packed message and chain weights, once the operands the kernel
    copies or reads 16 bytes at a time are checked for alignment."""
    _build.check_aligned(name, **streams, w1=w1, w2=w2)
    return (pack_message_weights(w_in, w_mid, w_out, sd, He),
            packed_chain_weights(w1, w2, sd))


def _layer_node_cuda(ops, nodes_per_block, act):
    h_V, per_i, pjg, h_E, geom, mask, mask_V, *weights = ops
    w_in, b_in, w_mid, b_mid, w_out, b_out, *chain_w = weights
    B, L, K, sd, (H, He, P) = _message_expect("layer_node", h_E, per_i, pjg, geom, mask,
                                              *weights[:6])
    check_chain_weights("layer_node", h_E, *chain_w, H=H)
    _build.check_operands("layer_node", h_E, {"h_V": (h_V, (B, L, H), sd),
                                              "mask_V": (mask_V, (B, L), _F32)})
    if not 1 <= nodes_per_block <= _MAX_NODES:
        raise ValueError(f"layer_node kernel: nodes_per_block {nodes_per_block} "
                         f"(1 to {_MAX_NODES})")
    wpack, cpack = _packed("layer_node", sd, He, w_in, w_mid, w_out, chain_w[2], chain_w[4],
                           per_i=per_i, pjg=pjg, h_E=h_E, geom=geom)
    out = torch.empty_like(h_V)
    lib = _lib(act, H, He, P)
    _build.launch_kernel(
        lib, "packppi_layer_node", "layer_node kernel launch", h_E.device,
        *(_build.ptr(t) for t in ops[:7] + (wpack, b_in, b_mid, b_out, *chain_w, cpack, out)),
        B * L, K, nodes_per_block, int(sd == torch.bfloat16))
    layer_node.launches += 1
    return out


def _layer_edge_cuda(ops, act):
    h_E, per_i, pjg, geom, mask, *weights = ops
    w_in, b_in, w_mid, b_mid, w_out, b_out, *chain_w = weights
    B, L, K, sd, (H, He, P) = _message_expect("layer_edge", h_E, per_i, pjg, geom, mask,
                                              *weights[:6])
    if He != H:
        raise ValueError(f"layer_edge kernel adds the message to h_E: edge_features={He} "
                         f"must equal hidden_dim={H}")
    check_chain_weights("layer_edge", h_E, *chain_w)
    wpack, cpack = _packed("layer_edge", sd, He, w_in, w_mid, w_out, chain_w[2], chain_w[4],
                           per_i=per_i, pjg=pjg, h_E=h_E, geom=geom)
    out = torch.empty_like(h_E)
    lib = _lib(act, H, He, P)
    _build.launch_kernel(
        lib, "packppi_layer_edge", "layer_edge kernel launch", h_E.device,
        *(_build.ptr(t) for t in ops[:5] + (wpack, b_in, b_mid, b_out, *chain_w, cpack, out)),
        B * L, K, int(sd == torch.bfloat16))
    layer_edge.launches += 1
    return out


def _lib(act="relu", H=128, He=128, P=8):
    lib = _build.load_library(_build.lib_name("layer", act, H, He, P))
    if lib.packppi_layer_node.argtypes is None:
        ptrs, ints, stream = [ctypes.c_void_p], [ctypes.c_int], [ctypes.c_void_p]
        lib.packppi_layer_node.argtypes = ptrs * 21 + [ctypes.c_longlong] + ints * 3 + stream
        lib.packppi_layer_edge.argtypes = ptrs * 19 + [ctypes.c_longlong] + ints * 2 + stream
        lib.packppi_layer_node.restype = lib.packppi_layer_edge.restype = ctypes.c_int
    return lib
