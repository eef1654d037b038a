"""IPMP message MLP with in-kernel point geometry (CUDA kernel + plain twin).

For every edge (i, j=idx[i, k]) of the kNN graph:

    geom = [p_i local (xyz interleaved) | |p_i| | R_i^T (pg_j - t_i) | |.| | |pg_i - pg_j|]
    x    = act([h_E | geom] @ W_e + b_e + per_i[i] + per_j[j])
    x    = act(x @ W_1 + b_1) @ W_2 + b_2

``pool=True`` returns the masked sum over the K edges divided by K
([B, L, H] float32); ``pool=False`` returns the edge messages
[B, L, K, H] in the stream dtype (``h_E.dtype``, also the compute dtype:
operands are rounded to it before each product, sums stay float32).
``act`` is one of ``ops.activations.ACTS`` (relu by default), applied to
the float32 sums; every entry point takes it last, and each activation has
its own kernel library (``ops._build.lib_name``), as each width H, He and P
has (read from the operands); K is any count of neighbours.

Four entry points, each launching its own kernel of ``csrc/message.cu``
for CUDA tensors and running its plain twin for CPU tensors (nothing else
picks the plain version), each with its own count of launches:

* ``message``: the per-node tables ``per_j`` and ``pg`` and ``idx``; the
  kernel loads neighbour rows by index and runs its products on tensor
  cores over the packed weights of ``ops.message_feat.pack_message_weights``.
  Replaces
  ``packppi_tpu/ops/pallas_ipmp.py::fused_message_geom_lanes``.
* ``message_gather``: the same function and operands in its own
  instantiation. Replaces ``::fused_message_geom_gather``, whose one-hot
  in-kernel gathers are an indexed load on a GPU.
* ``message_geom``: the neighbour term and the neighbour global-point
  planes arrive gathered (``pjg`` in the stream dtype, ``ng`` float32), node
  i's points as local planes with its frame; the kernel fills the same
  tensor-core body's tile from them. Replaces ``::fused_message_geom``.
* ``message_chain``: ``message``'s edge pass with the residual chain of
  ``ops.chain`` folded in (``pre_mask``); returns the new h_E. The kernel
  runs ``message``'s tensor-core body and then the chain kernel's (over the
  packed copies of both weights). Replaces ``_geom_lanes_kernel``'s
  ``with_chain`` branch.
"""
from __future__ import annotations

import ctypes

import torch

from packppi_torch.ops import _build
from packppi_torch.ops.chain import chain_plain, check_chain_weights, packed_chain_weights
from packppi_torch.ops.graph import gather_nodes
from packppi_torch.ops.message_feat import (check_message_widths, message_feat_plain,
                                            message_weights_expect, pack_message_weights)

GEOM_EPS = 1e-8


def geometry_global_points(p_local: torch.Tensor, rot: torch.Tensor,
                           trans: torch.Tensor) -> torch.Tensor:
    """[B, L, 3P] plane-stacked global points ``[pgx | pgy | pgz]`` with
    ``pg = R @ p_local + t``; ``p_local`` [B, L, P, 3], ``rot`` [B, L, 3, 3],
    ``trans`` [B, L, 3]."""
    x, y, z = p_local[..., 0], p_local[..., 1], p_local[..., 2]
    e = lambda a: a[..., None]
    planes = [e(rot[..., r, 0]) * x + e(rot[..., r, 1]) * y + e(rot[..., r, 2]) * z
              + e(trans[..., r]) for r in range(3)]
    return torch.cat(planes, -1)


def geometry_edge_features(p_local: torch.Tensor, nbr: torch.Tensor,
                           rot: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """[B, L, K, 9P] frame-invariant point features of every edge, from the
    gathered neighbour global-point planes ``nbr`` [B, L, K, 3P]. Feature
    order: [p_local xyz-interleaved (3P) | |p_local| (P) | neighbour points
    in i's frame, interleaved (3P) | their norms (P) | |pg_i - pg_j| (P)]."""
    B, L, P = p_local.shape[:3]
    K = nbr.shape[2]
    plx, ply, plz = p_local[..., 0], p_local[..., 1], p_local[..., 2]
    pg = geometry_global_points(p_local, rot, trans)
    pgx, pgy, pgz = pg[..., :P], pg[..., P:2 * P], pg[..., 2 * P:]
    ngx, ngy, ngz = nbr[..., :P], nbr[..., P:2 * P], nbr[..., 2 * P:]

    ee = lambda a: a[..., None, None]
    dx = ngx - ee(trans[..., 0])
    dy = ngy - ee(trans[..., 1])
    dz = ngz - ee(trans[..., 2])
    # neighbour points in i's frame: R_i^T (pg_j - t_i)
    nlx = ee(rot[..., 0, 0]) * dx + ee(rot[..., 1, 0]) * dy + ee(rot[..., 2, 0]) * dz
    nly = ee(rot[..., 0, 1]) * dx + ee(rot[..., 1, 1]) * dy + ee(rot[..., 2, 1]) * dz
    nlz = ee(rot[..., 0, 2]) * dx + ee(rot[..., 1, 2]) * dy + ee(rot[..., 2, 2]) * dz

    norm_pl = torch.sqrt(plx * plx + ply * ply + plz * plz + GEOM_EPS)
    norm_nl = torch.sqrt(nlx * nlx + nly * nly + nlz * nlz + GEOM_EPS)
    ddx = pgx[:, :, None] - ngx
    ddy = pgy[:, :, None] - ngy
    ddz = pgz[:, :, None] - ngz
    norm_pair = torch.sqrt(ddx * ddx + ddy * ddy + ddz * ddz + GEOM_EPS)

    flat_pl = p_local.reshape(B, L, 1, P * 3).expand(B, L, K, P * 3)
    flat_nl = torch.stack([nlx, nly, nlz], -1).reshape(B, L, K, P * 3)
    return torch.cat([flat_pl, norm_pl[:, :, None].expand(B, L, K, P),
                      flat_nl, norm_nl, norm_pair], -1)


def message_plain(per_i, per_j, h_E, idx, p_local, rot, trans, pg, mask,
                  w_in, b_in, w_mid, b_mid, w_out, b_out, pool: bool, act: str = "relu"):
    """Plain PyTorch version of the kernel, at the kernel's cast points:
    the geometry features and the gathered neighbour term through
    ``message_feat_plain``, which holds the chain of products.

    ``w_in`` is the reference's first message layer [H, H + He + H + 9P]
    over ``[h_i | h_E | h_j | geometry]``; its h_i and h_j column blocks
    were already applied per node (``per_i`` float32, ``per_j`` in the
    stream dtype). ``w_mid``/``w_out`` are [H, H] in Linear layout.
    """
    geom = geometry_edge_features(p_local, gather_nodes(pg, idx), rot, trans)
    return message_feat_plain(per_i, gather_nodes(per_j, idx), h_E, geom, mask,
                              w_in, b_in, w_mid, b_mid, w_out, b_out, pool, act)


def message_geom_plain(per_i, pjg, h_E, pl, ng, rot9, trans, mask,
                       w_in, b_in, w_mid, b_mid, w_out, b_out, pool: bool,
                       act: str = "relu"):
    """Plain version of the gathered-operand kernel: ``pjg`` [B, L, K, H] in
    the stream dtype, ``pl`` [B, L, 3P] local point planes ``[x | y | z]``,
    ``ng`` [B, L, K, 3P] gathered neighbour global-point planes, ``rot9``
    [B, L, 9] row-major, ``trans`` [B, L, 3], all float32."""
    B, L, G3 = pl.shape
    P = G3 // 3
    p_local = torch.stack([pl[..., :P], pl[..., P:2 * P], pl[..., 2 * P:]], -1)
    geom = geometry_edge_features(p_local, ng, rot9.reshape(B, L, 3, 3), trans)
    return message_feat_plain(per_i, pjg, h_E, geom, mask, w_in, b_in, w_mid, b_mid,
                              w_out, b_out, pool, act)


def message_chain_plain(per_i, per_j, h_E, idx, p_local, rot, trans, pg, mask,
                        w_in, b_in, w_mid, b_mid, w_out, b_out,
                        lna_w, lna_b, w1, b1, w2, b2, lnb_w, lnb_b, act: str = "relu"):
    """Plain version of the folded edge pass: ``message_plain`` (edge)
    followed by ``chain_plain(pre_mask=True)``; [B, L, K, H] in the stream
    dtype."""
    msg = message_plain(per_i, per_j, h_E, idx, p_local, rot, trans, pg, mask,
                        w_in, b_in, w_mid, b_mid, w_out, b_out, False, act)
    H = h_E.shape[-1]
    return chain_plain(h_E.reshape(-1, H), msg.reshape(-1, H), mask.reshape(-1).float(),
                       lna_w, lna_b, w1, b1, w2, b2, lnb_w, lnb_b, True,
                       act).reshape(h_E.shape)


def message(per_i, per_j, h_E, idx, p_local, rot, trans, pg, mask,
            w_in, b_in, w_mid, b_mid, w_out, b_out, pool: bool, act: str = "relu"):
    """The message pass: the CUDA kernel for CUDA tensors, ``message_plain``
    for CPU tensors (see the module docstring for shapes)."""
    if h_E.device.type == "cpu":
        return message_plain(per_i, per_j, h_E, idx, p_local, rot, trans, pg, mask,
                             w_in, b_in, w_mid, b_mid, w_out, b_out, pool, act)
    out = _indexed_cuda("packppi_message", per_i, per_j, h_E, idx, p_local, rot, trans, pg,
                        mask, w_in, b_in, w_mid, b_mid, w_out, b_out, pool, act)
    message.launches += 1
    return out


def message_gather(per_i, per_j, h_E, idx, p_local, rot, trans, pg, mask,
                   w_in, b_in, w_mid, b_mid, w_out, b_out, pool: bool, act: str = "relu"):
    """``message``'s function and operands through the kernel that replaces
    ``fused_message_geom_gather``; ``message_plain`` for CPU tensors."""
    if h_E.device.type == "cpu":
        return message_plain(per_i, per_j, h_E, idx, p_local, rot, trans, pg, mask,
                             w_in, b_in, w_mid, b_mid, w_out, b_out, pool, act)
    out = _indexed_cuda("packppi_message_gather", per_i, per_j, h_E, idx, p_local, rot, trans,
                        pg, mask, w_in, b_in, w_mid, b_mid, w_out, b_out, pool, act)
    message_gather.launches += 1
    return out


def message_geom(per_i, pjg, h_E, pl, ng, rot9, trans, mask,
                 w_in, b_in, w_mid, b_mid, w_out, b_out, pool: bool, act: str = "relu"):
    """The message pass over gathered neighbour streams: the CUDA kernel for
    CUDA tensors, ``message_geom_plain`` for CPU tensors."""
    if h_E.device.type == "cpu":
        return message_geom_plain(per_i, pjg, h_E, pl, ng, rot9, trans, mask,
                                  w_in, b_in, w_mid, b_mid, w_out, b_out, pool, act)
    return _message_geom_cuda(per_i, pjg, h_E, pl, ng, rot9, trans, mask,
                              w_in, b_in, w_mid, b_mid, w_out, b_out, pool, act)


def message_chain(per_i, per_j, h_E, idx, p_local, rot, trans, pg, mask,
                  w_in, b_in, w_mid, b_mid, w_out, b_out,
                  lna_w, lna_b, w1, b1, w2, b2, lnb_w, lnb_b, act: str = "relu"):
    """The edge pass with the chain folded in: the CUDA kernel for CUDA
    tensors, ``message_chain_plain`` for CPU tensors. Returns the new h_E."""
    ops = (per_i, per_j, h_E, idx, p_local, rot, trans, pg, mask, w_in, b_in, w_mid, b_mid,
           w_out, b_out)
    chain_w = (lna_w, lna_b, w1, b1, w2, b2, lnb_w, lnb_b)
    if h_E.device.type == "cpu":
        return message_chain_plain(*ops, *chain_w, act)
    return _message_chain_cuda(ops, chain_w, act)


# kernel launches on the card; the plain path never touches them
message.launches = 0
message_gather.launches = 0
message_geom.launches = 0
message_chain.launches = 0

_F32 = torch.float32


def _stream_dtype(name, h_E):
    sd = h_E.dtype
    if sd not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} kernel: stream dtype {sd} (float32 or bfloat16)")
    return sd


def _indexed_expect(name, per_i, per_j, h_E, idx, p_local, rot, trans, pg, mask,
                    w_in, b_in, w_mid, b_mid, w_out, b_out):
    """Checks the operands of the indexed-load routes; returns (B, L, K, sd,
    (H, He, P))."""
    B, L, K, He = h_E.shape
    H, P = per_i.shape[-1], p_local.shape[2]
    sd = _stream_dtype(name, h_E)
    check_message_widths(name, H, He, 9 * P, K)
    expect = {
        "per_i": (per_i, (B, L, H), _F32),
        "per_j": (per_j, (B, L, H), sd),
        "idx": (idx, (B, L, K), torch.int64),
        "p_local": (p_local, (B, L, P, 3), _F32),
        "rot": (rot, (B, L, 3, 3), _F32),
        "trans": (trans, (B, L, 3), _F32),
        "pg": (pg, (B, L, 3 * P), _F32),
        "mask": (mask, (B, L, K), _F32),
        **message_weights_expect(w_in, b_in, w_mid, b_mid, w_out, b_out, H, He, 9 * P),
    }
    _build.check_operands(name, h_E, expect)
    return B, L, K, sd, (H, He, P)


def _indexed_cuda(entry, per_i, per_j, h_E, idx, p_local, rot, trans, pg, mask,
                  w_in, b_in, w_mid, b_mid, w_out, b_out, pool, act):
    ops = (per_i, per_j, h_E, idx, p_local, rot, trans, pg, mask, w_in, b_in, w_mid, b_mid,
           w_out, b_out)
    name = entry[len("packppi_"):]
    B, L, K, sd, (H, He, P) = _indexed_expect(name, *ops)
    _build.check_aligned(name, per_i=per_i, per_j=per_j, h_E=h_E)
    wpack = pack_message_weights(w_in, w_mid, w_out, sd, He)
    out = (torch.empty(B, L, H, device=h_E.device, dtype=_F32) if pool
           else torch.empty(B, L, K, H, device=h_E.device, dtype=sd))
    lib = _lib(act, H, He, P)
    _build.launch_kernel(
        lib, entry, f"{name} kernel launch", h_E.device,
        *(_build.ptr(t) for t in ops[:9] + (wpack, b_in, b_mid, b_out, out)),
        B, L, K, int(sd == torch.bfloat16), int(pool))
    return out


def _message_geom_cuda(per_i, pjg, h_E, pl, ng, rot9, trans, mask,
                       w_in, b_in, w_mid, b_mid, w_out, b_out, pool, act):
    B, L, K, He = h_E.shape
    H, P = per_i.shape[-1], pl.shape[-1] // 3
    sd = _stream_dtype("message_geom", h_E)
    check_message_widths("message_geom", H, He, 9 * P, K)
    expect = {
        "per_i": (per_i, (B, L, H), _F32),
        "pjg": (pjg, (B, L, K, H), sd),
        "pl": (pl, (B, L, 3 * P), _F32),
        "ng": (ng, (B, L, K, 3 * P), _F32),
        "rot9": (rot9, (B, L, 9), _F32),
        "trans": (trans, (B, L, 3), _F32),
        "mask": (mask, (B, L, K), _F32),
        **message_weights_expect(w_in, b_in, w_mid, b_mid, w_out, b_out, H, He, 9 * P),
    }
    _build.check_operands("message_geom", h_E, expect)
    _build.check_aligned("message_geom", per_i=per_i, pjg=pjg, h_E=h_E)
    wpack = pack_message_weights(w_in, w_mid, w_out, sd, He)
    out = (torch.empty(B, L, H, device=h_E.device, dtype=_F32) if pool
           else torch.empty(B, L, K, H, device=h_E.device, dtype=sd))
    lib = _lib(act, H, He, P)
    _build.launch_kernel(
        lib, "packppi_message_geom", "message_geom kernel launch", h_E.device,
        *(_build.ptr(t) for t in (per_i, pjg, h_E, pl, ng, rot9, trans, mask, wpack, b_in,
                                  b_mid, b_out, out)),
        B * L, K, int(sd == torch.bfloat16), int(pool))
    message_geom.launches += 1
    return out


def _message_chain_cuda(ops, chain_w, act):
    per_i, per_j, h_E = ops[:3]
    w_in, b_in, w_mid, b_mid, w_out, b_out = ops[9:]
    w1, w2 = chain_w[2], chain_w[4]
    B, L, K, sd, (H, He, P) = _indexed_expect("message_chain", *ops)
    if He != H:
        raise ValueError(f"message_chain kernel adds the message to h_E: edge_features={He} "
                         f"must equal hidden_dim={H}")
    check_chain_weights("message_chain", h_E, *chain_w)
    _build.check_aligned("message_chain", per_i=per_i, per_j=per_j, h_E=h_E, w1=w1, w2=w2)
    wpack = pack_message_weights(w_in, w_mid, w_out, sd, He)
    cpack = packed_chain_weights(w1, w2, sd)
    out = torch.empty_like(h_E)
    lib = _lib(act, H, He, P)
    _build.launch_kernel(
        lib, "packppi_message_chain", "message_chain kernel launch", h_E.device,
        *(_build.ptr(t) for t in ops[:9] + (wpack, b_in, b_mid, b_out) + chain_w + (cpack, out)),
        B, L, K, int(sd == torch.bfloat16))
    message_chain.launches += 1
    return out


def _lib(act="relu", H=128, He=128, P=8):
    lib = _build.load_library(_build.lib_name("message", act, H, He, P))
    if lib.packppi_message.argtypes is None:
        ptrs, ints, stream = [ctypes.c_void_p], [ctypes.c_int], [ctypes.c_void_p]
        for entry in (lib.packppi_message, lib.packppi_message_gather):
            entry.argtypes = ptrs * 14 + ints * 5 + stream
        lib.packppi_message_geom.argtypes = ptrs * 13 + [ctypes.c_longlong] + ints * 3 + stream
        lib.packppi_message_chain.argtypes = ptrs * 23 + ints * 4 + stream
        for entry in (lib.packppi_message, lib.packppi_message_gather, lib.packppi_message_geom,
                      lib.packppi_message_chain):
            entry.restype = ctypes.c_int
    return lib
