"""Steric clash and bond-violation losses (AF2 eq. 46 family) with the
between-residue pair sums in CUDA kernels (forward and gradient).

For flat atoms a, b of one complex (A = 14 L; slot = a % 14), with lo/hi
the pair ordered by residue index:

    d_ab   = sqrt(|x_a - x_b|^2 + 1e-10)
    S_ab   = exists_a exists_b [ridx_a != ridx_b]
             (1 - [slot_a < 4][slot_b < 4])                          backbone-backbone
             (1 - [ridx_hi = ridx_lo + 1][slot_lo = 2][slot_hi = 0]) C(i)-N(i+1)
             (1 - [slot_a = 5][slot_b = 5])                          SG-SG
    err_ab = S_ab relu(rad_a + rad_b - tol - d_ab)
    per_atom[a] = sum_b err_ab
    dL/dx_a     = sum_b -(w_a + w_b) S_ab [rad_a + rad_b - tol - d_ab > 0] (x_a - x_b) / d_ab

with w the cotangent of ``per_atom``. ``between_residue_clash`` launches the
kernels of ``csrc/clash.cu`` for CUDA tensors (forward in ``forward``, the
gradient kernel in ``backward``) and runs ``between_residue_clash_plain``,
differentiated by autograd, for CPU tensors. The kernels replace
``packppi_tpu/ops/pallas_clash.py::_clash_kernel`` and ``_clash_grad_kernel``.
Neither version ever holds an [L, L, 14, 14] tensor: the plain version walks
row blocks of residues and recomputes each block in the backward pass.

The kernels cull by tiles of 32 flat atoms: each row tile walks only the
column tiles whose bounding boxes come within reach of its own.
``clash_tiles_plain`` is the plain version of that culling (boxes and the
ascending lists of live tiles), ``tiled_clash_plain`` the sums over the
listed tile pairs alone; the tests and ``chip_smoke.py`` hold the kernels'
lists and sums to them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable
from torch.utils.checkpoint import checkpoint

from packppi_torch.chem import make_atom14_dists_bounds
from packppi_torch.geometry.frames import atom14_coords_from_torsions, chem_table
from packppi_torch.ops import _build

_CYS_SG_SLOT = 5  # atom14 slot of CYS SG (exempted globally, like AF2)
_C_SLOT, _N_SLOT = 2, 0
_EPS = 1e-10

# csrc/clash.cu: atoms a tile (a lane of a warp each), floats a tile box
TILE, _BOX = 32, 8
_MAX_TILES = 32767            # tile numbers are int16
_BIG = 1e30
# the tile test's slack over the pair test (csrc/clash.cu kCullSlack)
_CULL_SLACK = 1.0001


def within_residue_violations(positions, atom_exists, lower, upper):
    """Per-atom bound-violation loss within each residue.

    Args:
        positions: [B, L, 14, 3]; atom_exists: [B, L, 14];
        lower/upper: [B, L, 14, 14] distance bounds.

    Returns: per_atom_loss_sum [B, L, 14].
    """
    pair_mask = atom_exists[..., :, None] * atom_exists[..., None, :]
    keep = torch.ones(14, 14, dtype=positions.dtype, device=positions.device)
    keep.fill_diagonal_(0.0)
    keep[:4, :4] = 0.0
    pair_mask = pair_mask * keep
    d = torch.sqrt(_EPS + torch.sum(
        (positions[..., :, None, :] - positions[..., None, :, :]) ** 2, -1))
    err = torch.relu(lower - d) + torch.relu(d - upper)
    loss = pair_mask * err
    return loss.sum(-2) + loss.sum(-1)


@functools.lru_cache(maxsize=None)
def _slot_masks(device):
    """Constant [14, 14] pair tables by atom slot: 1 - backbone-backbone -
    SG-SG overlap, and the C(row)-N(column) peptide pair."""
    keep = np.ones((14, 14), np.float32)
    keep[:4, :4] = 0.0
    keep[_CYS_SG_SLOT, _CYS_SG_SLOT] = 0.0
    cn = np.zeros((14, 14), np.float32)
    cn[_C_SLOT, _N_SLOT] = 1.0
    return torch.as_tensor(keep, device=device), torch.as_tensor(cn, device=device)


def _pair_block(pos_i, ex_i, rad_i, ridx_i, pos, ex, rad, ridx, tol_soft):
    """Clash error of a row block of R residues against all L residues, in
    the symmetric form. ``*_i`` are [B, R, ...], the rest [B, L, ...].
    Returns (per-atom row sums [B, R, 14], sum of err, sum of mask)."""
    err, mask = pair_errors(pos_i, ex_i, rad_i, ridx_i, pos, ex, rad, ridx, tol_soft)
    return err.sum((3, 4)), err.sum(), mask.sum()


def pair_errors(pos_i, ex_i, rad_i, ridx_i, pos, ex, rad, ridx, tol_soft):
    """``_pair_block``'s per-pair terms: err and S, each [B, R, 14, L, 14].
    Every pair of distinct residues appears from both of its atoms."""
    keep, cn = _slot_masks(pos.device)
    d2 = _EPS
    for c in range(3):
        diff = pos_i[..., c][:, :, :, None, None] - pos[..., c][:, None, None, :, :]
        d2 = d2 + diff * diff                                   # [B, R, 14, L, 14]
    d = torch.sqrt(d2)

    ri, rj = ridx_i[:, :, None], ridx[:, None, :]               # [B, R, L]
    mask = ex_i[:, :, :, None, None] * ex[:, None, None, :, :]
    mask = mask * (ri != rj)[:, :, None, :, None] * keep[:, None, :]
    # the peptide bond C(i)-N(i+1) is bonded, not a clash: either atom may be
    # the row
    nxt = (rj == ri + 1)[:, :, None, :, None] * cn[:, None, :]
    prv = (ri == rj + 1)[:, :, None, :, None] * cn.t()[:, None, :]
    mask = mask * (1.0 - nxt) * (1.0 - prv)

    low = rad_i[:, :, :, None, None] + rad[:, None, None, :, :]
    return mask * torch.relu(low - tol_soft - d), mask


def between_residue_clash_plain(positions, atom_exists, atom_radius, residue_index,
                                tol_soft: float, block: int = 64):
    """Plain PyTorch version of the kernels, row-blocked: peak memory is
    O(block * L * 196) in both directions (each block is recomputed in the
    backward pass).

    Returns dict with ``per_atom_loss_sum`` [B, L, 14] and ``mean_loss``
    (over the pairs counted once).
    """
    L = positions.shape[1]
    remat = torch.is_grad_enabled() and positions.requires_grad
    rows, err_sum, mask_sum = [], 0.0, 0.0
    for s in range(0, L, block):
        blk = (positions[:, s:s + block], atom_exists[:, s:s + block],
               atom_radius[:, s:s + block], residue_index[:, s:s + block])
        args = (*blk, positions, atom_exists, atom_radius, residue_index, tol_soft)
        if remat:
            row, e, m = checkpoint(_pair_block, *args, use_reentrant=False)
        else:
            row, e, m = _pair_block(*args)
        rows.append(row)
        err_sum, mask_sum = err_sum + e, mask_sum + m
    # every pair was visited from both of its atoms
    return {"per_atom_loss_sum": torch.cat(rows, 1),
            "mean_loss": 0.5 * err_sum / (1e-6 + 0.5 * mask_sum)}


def tile_boxes_plain(positions, atom_exists, atom_radius):
    """[B, T, 8] per tile of TILE flat atoms (T = ceil(14 L / TILE)): the
    bounding box of the atoms that exist (exists > 0; lo xyz, hi xyz), their
    largest radius and whether any exists; what the kernels' first launch
    writes."""
    B, L = positions.shape[:2]
    A = 14 * L
    T = -(-A // TILE)
    pad = T * TILE - A
    pos = F.pad(positions.reshape(B, A, 3), (0, 0, 0, pad)).reshape(B, T, TILE, 3)
    ex = F.pad(atom_exists.reshape(B, A), (0, pad)).reshape(B, T, TILE) > 0
    rad = F.pad(atom_radius.reshape(B, A), (0, pad)).reshape(B, T, TILE)
    lo = torch.where(ex[..., None], pos, _BIG).amin(2)
    hi = torch.where(ex[..., None], pos, -_BIG).amax(2)
    rmax = torch.where(ex, rad, -_BIG).amax(2)
    return torch.cat([lo, hi, rmax[..., None], ex.any(2, keepdim=True).float()], -1)


def _within_reach(c, lo, hi, rad, tol_soft):
    """Whether boxes ``c`` [..., 8] come within reach of the boxes lo-hi
    [..., 3] of largest radius ``rad``: the gap between them, squared,
    within (rad + c's radius - tol_soft)^2 times a slack, in the kernel's
    float32 operations and order (``csrc/clash.cu::within_reach``)."""
    g = torch.clamp_min(torch.maximum(c[..., 0:3] - hi, lo - c[..., 3:6]), 0.0)
    gap2 = (g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1]) + g[..., 2] * g[..., 2]
    thr = (rad + c[..., 6]) - tol_soft
    return (thr > 0) & (gap2 <= thr * thr * _CULL_SLACK)


def live_tile_pairs(positions, atom_exists, atom_radius, boxes, tol_soft: float,
                    cull: bool = True, chunk: int = 32):
    """[B, T, T] bool: row tile r and column tile c may hold an overlapping
    pair. Both hold an atom that exists, their boxes come within reach of
    each other, and so does the column box and one of row tile r's atoms
    that exist. Every pair with ``rad_a + rad_b - tol_soft - d_ab > 0`` lies
    in a live tile pair: d_ab is no shorter than either gap. ``cull=False``:
    every pair."""
    B, T = boxes.shape[:2]
    if not cull:
        return torch.ones(B, T, T, dtype=torch.bool, device=boxes.device)
    A = positions.shape[1] * 14
    pad = T * TILE - A
    pos = F.pad(positions.reshape(B, A, 3), (0, 0, 0, pad)).reshape(B, T, TILE, 1, 3)
    ex = F.pad(atom_exists.reshape(B, A), (0, pad)).reshape(B, T, TILE, 1) > 0
    rad = F.pad(atom_radius.reshape(B, A), (0, pad)).reshape(B, T, TILE, 1)
    c = boxes[:, None]
    out = []
    for s in range(0, T, chunk):
        r = boxes[:, s:s + chunk, None]
        live = ((r[..., 7] > 0) & (c[..., 7] > 0)
                & _within_reach(c, r[..., 0:3], r[..., 3:6], r[..., 6], tol_soft))
        p = pos[:, s:s + chunk]
        atoms = ex[:, s:s + chunk] & _within_reach(c[:, None], p, p, rad[:, s:s + chunk],
                                                   tol_soft)
        out.append(live & atoms.any(2))
    return torch.cat(out, 1)


def clash_tiles_plain(positions, atom_exists, atom_radius, tol_soft: float, cull: bool = True):
    """Plain version of the kernels' culling: (boxes [B, T, 8], tiles
    [B, T, T] int16, counts [B, T] int32). Row r of ``tiles`` lists the live
    column tiles of row tile r in ascending order, its first ``counts[b, r]``
    entries, then -1 (the kernel leaves those entries unwritten)."""
    boxes = tile_boxes_plain(positions, atom_exists, atom_radius)
    live = live_tile_pairs(positions, atom_exists, atom_radius, boxes, tol_soft, cull)
    T = live.shape[-1]
    ar = torch.arange(T, device=live.device)
    order = torch.where(live, ar, ar + T).sort(-1).values          # live tiles first
    tiles = torch.where(order < T, order, -1).to(torch.int16)
    return boxes, tiles, live.sum(-1, dtype=torch.int32)


def listed_tile_pairs(tiles, counts):
    """[B, T, T] bool: column tile c is among the first ``counts[b, r]``
    entries of ``tiles[b, r]``."""
    B, T = counts.shape
    valid = torch.arange(T, device=tiles.device) < counts[..., None].long()
    listed = torch.zeros(B, T, T + 1, dtype=torch.bool, device=tiles.device)
    listed.scatter_(2, torch.where(valid, tiles.long(), T), True)
    return listed[..., :T]


def _tile_pair_errors(positions, atom_exists, atom_radius, residue_index, tol_soft, rows):
    """err [B, R, A] of the flat row atoms ``rows`` (a range) against every
    atom, in ``_pair_block``'s arithmetic and symmetric form."""
    B, L = positions.shape[:2]
    A = 14 * L
    pos = positions.reshape(B, A, 3)
    ex, rad = atom_exists.reshape(B, A), atom_radius.reshape(B, A)
    atom = torch.arange(A, device=positions.device)
    slot, ridx = atom % 14, residue_index[:, atom // 14]                  # [A], [B, A]
    keep, cn = _slot_masks(positions.device)
    d2 = _EPS
    for c in range(3):
        diff = pos[:, rows, None, c] - pos[:, None, :, c]
        d2 = d2 + diff * diff                                             # [B, R, A]
    d = torch.sqrt(d2)
    ri, rj = ridx[:, rows, None], ridx[:, None, :]
    si, sj = slot[rows, None], slot[None, :]
    mask = ex[:, rows, None] * ex[:, None, :] * (ri != rj) * keep[si, sj]
    mask = mask * (1.0 - (rj == ri + 1) * cn[si, sj]) * (1.0 - (ri == rj + 1) * cn[sj, si])
    return mask * torch.relu((rad[:, rows, None] + rad[:, None, :]) - tol_soft - d)


def tiled_clash_plain(positions, atom_exists, atom_radius, residue_index, tol_soft: float,
                      tiles=None, counts=None, chunk: int = 8):
    """(per-atom sums [B, L, 14], overlap [B, T, T] bool) over flat atoms, a
    few row tiles at a time: each row atom's sum over the column tiles that
    ``tiles`` / ``counts`` list for its row tile (every tile if None), and
    which tile pairs hold an overlapping pair (S > 0 and over > 0). Left-out
    pairs count as exact zeros, so the sum over the listed tiles equals the
    sum over all of them bit for bit exactly when no overlapping pair was
    left out."""
    B, L = positions.shape[:2]
    A = 14 * L
    T = -(-A // TILE)
    dev = positions.device
    listed = (torch.ones(B, T, T, dtype=torch.bool, device=dev) if tiles is None
              else listed_tile_pairs(tiles, counts))
    col_tile = torch.arange(A, device=dev) // TILE
    sums, overlap = [], []
    for s in range(0, T, chunk):
        rows = torch.arange(s * TILE, min((s + chunk) * TILE, A), device=dev)
        err = _tile_pair_errors(positions, atom_exists, atom_radius, residue_index, tol_soft,
                                rows)
        sums.append((err * listed[:, rows // TILE][..., col_tile]).sum(-1))
        hit = F.pad((err > 0).float(), (0, T * TILE - A)).reshape(B, len(rows), T, TILE).amax(-1)
        hit = F.pad(hit, (0, 0, 0, -len(rows) % TILE)).reshape(B, -1, TILE, T).amax(2)
        overlap.append(hit > 0)
    return torch.cat(sums, 1).reshape(B, L, 14), torch.cat(overlap, 1)


def between_residue_clash(positions, atom_exists, atom_radius, residue_index,
                          tol_soft: float = 0.5):
    """Per-atom between-residue clash loss [B, L, 14], differentiable in
    ``positions`` only: the CUDA kernels for CUDA tensors, the plain version
    for CPU tensors.

    positions [B, L, 14, 3], atom_exists and atom_radius [B, L, 14] float32;
    residue_index [B, L] int64.
    """
    if positions.device.type == "cpu":
        return between_residue_clash_plain(positions, atom_exists, atom_radius,
                                           residue_index, tol_soft)["per_atom_loss_sum"]
    return _ClashCuda.apply(positions, atom_exists, atom_radius, residue_index, float(tol_soft))


# kernel launches on the card; the plain path never touches them
between_residue_clash.launches_fwd = 0
between_residue_clash.launches_bwd = 0


class _ClashCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, positions, atom_exists, atom_radius, residue_index, tol_soft):
        per_atom, culling = clash_forward_cuda(positions, atom_exists, atom_radius,
                                               residue_index, tol_soft)
        ctx.save_for_backward(positions, atom_exists, atom_radius, residue_index, *culling)
        ctx.tol_soft = tol_soft
        return per_atom

    @staticmethod
    @once_differentiable
    def backward(ctx, w):
        positions, atom_exists, atom_radius, residue_index, *culling = ctx.saved_tensors
        dpos = clash_backward_cuda(positions, atom_exists, atom_radius, residue_index,
                                   w.contiguous(), ctx.tol_soft, culling=Culling(*culling))
        # exists, radius and index are chemistry constants along the only
        # differentiable path (torsions -> coordinates)
        return dpos, None, None, None, None


class Culling(NamedTuple):
    """What the forward kernel leaves for the gradient's: the atoms' records
    [B, A, 4] (x, y, z, radius; an absent atom's far away) and keys [B, A, 2]
    int32 (residue index, the bits of exists), the tile boxes [B, T, 8], and
    each row tile's list of live column tiles, ascending: ``tiles``
    [B, T, T] int16, of which the first ``counts`` [B, T] int32 entries are
    written."""
    records: torch.Tensor
    keys: torch.Tensor
    boxes: torch.Tensor
    tiles: torch.Tensor
    counts: torch.Tensor

    def pair_tests(self) -> int:
        """Distance tests a pair launch makes: 32 x 32 a listed tile pair."""
        return int(self.counts.sum()) * TILE * TILE


def _check(positions, atom_exists, atom_radius, residue_index, **more):
    if positions.dim() != 4 or positions.shape[2:] != (14, 3):
        raise ValueError(f"clash kernel: positions has shape {tuple(positions.shape)}, "
                         "expected [B, L, 14, 3]")
    if positions.dtype != torch.float32:
        raise TypeError(f"clash kernel: positions is {positions.dtype}, expected float32")
    B, L = positions.shape[:2]
    f32 = torch.float32
    expect = {"atom_exists": (atom_exists, (B, L, 14), f32),
              "atom_radius": (atom_radius, (B, L, 14), f32),
              "residue_index": (residue_index, (B, L), torch.int64)}
    expect.update({k: (t, shape, f32) for k, (t, shape) in more.items()})
    _build.check_operands("clash", positions, expect)
    if -(-14 * L // TILE) > _MAX_TILES:
        raise ValueError(f"clash kernel: {14 * L} atoms a complex, at most {_MAX_TILES * TILE}")
    return B, L


def _pack_cuda(positions, atom_exists, atom_radius, residue_index) -> Culling:
    """Launch the packing kernel: each atom's record and key and each tile's
    box; the lists allocated, to be written by a pair kernel."""
    B, L = positions.shape[:2]
    A, dev = 14 * L, positions.device
    T = -(-A // TILE)
    culling = Culling(torch.empty(B, A, 4, dtype=torch.float32, device=dev),
                      torch.empty(B, A, 2, dtype=torch.int32, device=dev),
                      torch.empty(B, T, _BOX, dtype=torch.float32, device=dev),
                      torch.empty(B, T, T, dtype=torch.int16, device=dev),
                      torch.empty(B, T, dtype=torch.int32, device=dev))
    lib = _lib()
    _build.launch_kernel(
        lib, "packppi_clash_pack", "clash packing kernel launch", dev,
        *(_build.ptr(t) for t in (positions, atom_exists, atom_radius, residue_index,
                                  *culling[:3])),
        B, L)
    return culling


def clash_forward_cuda(positions, atom_exists, atom_radius, residue_index, tol_soft,
                       cull: bool = True):
    """Launch the packing and forward kernels; returns (per_atom [B, L, 14],
    the ``Culling`` the gradient reuses). ``cull=False`` lists every tile
    (the sums are the same bits)."""
    B, L = _check(positions, atom_exists, atom_radius, residue_index)
    culling = _pack_cuda(positions, atom_exists, atom_radius, residue_index)
    out = torch.empty(B, L, 14, dtype=torch.float32, device=positions.device)
    lib = _lib()
    _build.launch_kernel(
        lib, "packppi_clash_forward", "clash forward kernel launch", positions.device,
        *(_build.ptr(t) for t in (*culling, out)),
        B, L, float(tol_soft), int(cull))
    between_residue_clash.launches_fwd += 1
    return out, culling


def clash_backward_cuda(positions, atom_exists, atom_radius, residue_index, w, tol_soft,
                        cull: bool = True, culling: Culling | None = None):
    """Launch the gradient kernel: d(sum(w * per_atom))/d positions,
    [B, L, 14, 3]. ``culling``: the forward's, whose lists it walks again;
    else packed and listed here (``cull`` as in the forward)."""
    B, L = _check(positions, atom_exists, atom_radius, residue_index,
                  w=(w, tuple(positions.shape[:3])))
    build = culling is None
    if build:
        culling = _pack_cuda(positions, atom_exists, atom_radius, residue_index)
    else:
        T = -(-14 * L // TILE)
        _build.check_operands("clash", positions, {
            "records": (culling.records, (B, 14 * L, 4), torch.float32),
            "keys": (culling.keys, (B, 14 * L, 2), torch.int32),
            "boxes": (culling.boxes, (B, T, _BOX), torch.float32),
            "tiles": (culling.tiles, (B, T, T), torch.int16),
            "counts": (culling.counts, (B, T), torch.int32)})
    out = torch.empty_like(positions)
    lib = _lib()
    _build.launch_kernel(
        lib, "packppi_clash_backward", "clash gradient kernel launch", positions.device,
        *(_build.ptr(t) for t in (culling.records, culling.keys, w, *culling[2:], out)),
        B, L, float(tol_soft), int(cull), int(build))
    between_residue_clash.launches_bwd += 1
    return out


def _lib():
    lib = _build.load_library("clash")
    if lib.packppi_clash_forward.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.packppi_clash_pack.argtypes = [p] * 7 + [i, i, p]
        lib.packppi_clash_forward.argtypes = [p] * 6 + [i, i, ctypes.c_float, i, p]
        lib.packppi_clash_backward.argtypes = [p] * 7 + [i, i, ctypes.c_float, i, i, p]
        for fn in (lib.packppi_clash_pack, lib.packppi_clash_forward,
                   lib.packppi_clash_backward):
            fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=8)
def _bounds(clash_overlap_tolerance: float, violation_tolerance_factor: float, device):
    b = make_atom14_dists_bounds(clash_overlap_tolerance, violation_tolerance_factor)
    return (torch.as_tensor(b["lower_bound"], device=device),
            torch.as_tensor(b["upper_bound"], device=device))


def sc_violation_loss(positions, atom_exists, residue_type, residue_index,
                      violation_tolerance_factor: float = 12.0,
                      clash_overlap_tolerance: float = 0.5):
    """Combined per-atom clash loss [B, L, 14]: between residues (the
    kernels on the card) plus within residues (plain PyTorch)."""
    radius = chem_table("vdw_radius_atom14", positions.device)[residue_type] * atom_exists
    between = between_residue_clash(positions, atom_exists, radius, residue_index,
                                    tol_soft=clash_overlap_tolerance)
    lower_t, upper_t = _bounds(clash_overlap_tolerance, violation_tolerance_factor,
                               positions.device)
    within = within_residue_violations(positions, atom_exists, lower_t[residue_type],
                                       upper_t[residue_type])
    return between + within


def compute_residue_clash(batch, SC_D,
                          violation_tolerance_factor: float = 12.0,
                          clash_overlap_tolerance: float = 0.5):
    """Per-residue clash scalar [B, L]: side-chain atoms only, normalized by
    the side-chain atom count. Differentiable in SC_D through the
    torsion -> coordinate chain."""
    side = torch.ones(14, dtype=batch.atom_mask.dtype, device=batch.atom_mask.device)
    side[:4] = 0.0
    per_residue_atoms = (batch.atom_mask * side).sum(-1)
    coords = atom14_coords_from_torsions(batch.X, batch.residue_type, batch.BB_D, SC_D)
    per_atom = sc_violation_loss(coords, batch.atom_mask, batch.residue_type,
                                 batch.residue_index, violation_tolerance_factor,
                                 clash_overlap_tolerance)
    return (per_atom * side).sum(-1) / (_EPS + per_residue_atoms)


def sc_clash_screen(coords, atom_mask, residue_type, residue_index,
                    clash_overlap_tolerance: float = 0.5):
    """Forward-only per-atom BETWEEN-residue clash for screening and scoring
    paths (no within-residue bound terms, no gradient)."""
    with torch.no_grad():
        radius = chem_table("vdw_radius_atom14", coords.device)[residue_type] * atom_mask
        return between_residue_clash(coords, atom_mask, radius, residue_index,
                                     tol_soft=clash_overlap_tolerance)
