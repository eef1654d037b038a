"""IPMP message MLP with in-kernel point geometry (CUDA kernel + plain twin).

For every edge (i, j=idx[i, k]) of the kNN graph:

    geom = [p_i local (xyz interleaved) | |p_i| | R_i^T (pg_j - t_i) | |.| | |pg_i - pg_j|]
    x    = relu([h_E | geom] @ W_e + b_e + per_i[i] + per_j[j])
    x    = relu(x @ W_1 + b_1) @ W_2 + b_2

``pool=True`` returns the masked sum over the K edges divided by K
([B, L, H] float32); ``pool=False`` returns the edge messages
[B, L, K, H] in the stream dtype (``h_E.dtype``, also the compute dtype:
operands are rounded to it before each product, sums stay float32).

``message`` launches the CUDA kernel of ``csrc/message.cu`` for CUDA
tensors and runs ``message_plain`` for CPU tensors; nothing else picks the
plain version. The kernel replaces
``packppi_tpu/ops/pallas_ipmp.py::fused_message_geom_lanes``.
"""
from __future__ import annotations

import ctypes

import torch

from packppi_torch.ops import _build
from packppi_torch.ops.graph import gather_nodes
from packppi_torch.ops.message_feat import message_feat_plain

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
                  w_in, b_in, w_mid, b_mid, w_out, b_out, pool: bool):
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
                              w_in, b_in, w_mid, b_mid, w_out, b_out, pool)


def message(per_i, per_j, h_E, idx, p_local, rot, trans, pg, mask,
            w_in, b_in, w_mid, b_mid, w_out, b_out, pool: bool):
    """The message pass: the CUDA kernel for CUDA tensors, ``message_plain``
    for CPU tensors (see the module docstring for shapes)."""
    if h_E.device.type == "cpu":
        return message_plain(per_i, per_j, h_E, idx, p_local, rot, trans, pg, mask,
                             w_in, b_in, w_mid, b_mid, w_out, b_out, pool)
    return _message_cuda(per_i, per_j, h_E, idx, p_local, rot, trans, pg, mask,
                         w_in, b_in, w_mid, b_mid, w_out, b_out, pool)


# kernel launches on the card; the plain path never touches it
message.launches = 0

_H, _P, _MAX_K = 128, 8, 64


def _message_cuda(per_i, per_j, h_E, idx, p_local, rot, trans, pg, mask,
                  w_in, b_in, w_mid, b_mid, w_out, b_out, pool):
    B, L, K, He = h_E.shape
    sd = h_E.dtype
    if sd not in (torch.float32, torch.bfloat16):
        raise TypeError(f"message kernel: stream dtype {sd} (float32 or bfloat16)")
    if He != _H or per_i.shape[-1] != _H or p_local.shape[2] != _P:
        raise ValueError(f"message kernel is built for H=He={_H}, P={_P}; got "
                         f"H={per_i.shape[-1]}, He={He}, P={p_local.shape[2]}")
    if K > _MAX_K:
        raise ValueError(f"message kernel takes K <= {_MAX_K} neighbours, got {K}")
    G = 9 * _P
    expect = {
        "per_i": (per_i, (B, L, _H), torch.float32),
        "per_j": (per_j, (B, L, _H), sd),
        "idx": (idx, (B, L, K), torch.int64),
        "p_local": (p_local, (B, L, _P, 3), torch.float32),
        "rot": (rot, (B, L, 3, 3), torch.float32),
        "trans": (trans, (B, L, 3), torch.float32),
        "pg": (pg, (B, L, 3 * _P), torch.float32),
        "mask": (mask, (B, L, K), torch.float32),
        "w_in": (w_in, (_H, 2 * _H + He + G), torch.float32),
        "b_in": (b_in, (_H,), torch.float32),
        "w_mid": (w_mid, (_H, _H), torch.float32),
        "b_mid": (b_mid, (_H,), torch.float32),
        "w_out": (w_out, (_H, _H), torch.float32),
        "b_out": (b_out, (_H,), torch.float32),
    }
    _build.check_operands("message", h_E, expect)
    out = (torch.empty(B, L, _H, device=h_E.device, dtype=torch.float32) if pool
           else torch.empty(B, L, K, _H, device=h_E.device, dtype=sd))
    lib = _lib()
    err = lib.packppi_message(
        *(_build.ptr(t) for t in (per_i, per_j, h_E, idx, p_local, rot, trans, pg, mask,
                                  w_in, b_in, w_mid, b_mid, w_out, b_out, out)),
        B, L, K, int(sd == torch.bfloat16), int(pool), _build.stream_ptr(h_E.device))
    _build.check(lib, err, "message kernel launch")
    message.launches += 1
    return out


def _lib():
    lib = _build.load_library("message")
    if lib.packppi_message.argtypes is None:
        lib.packppi_message.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.packppi_message.restype = ctypes.c_int
    return lib
