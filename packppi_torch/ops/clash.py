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
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
from torch.autograd.function import once_differentiable
from torch.utils.checkpoint import checkpoint

from packppi_torch.chem import make_atom14_dists_bounds
from packppi_torch.geometry.frames import atom14_coords_from_torsions, chem_table
from packppi_torch.ops import _build

_CYS_SG_SLOT = 5  # atom14 slot of CYS SG (exempted globally, like AF2)
_C_SLOT, _N_SLOT = 2, 0
_EPS = 1e-10

# csrc/clash.cu: row atoms per block, column atoms per tile, floats per tile box
ROWS_PER_BLOCK, COLS_PER_TILE, _BOX = 32, 128, 8


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
    err = mask * torch.relu(low - tol_soft - d)
    return err.sum((3, 4)), err.sum(), mask.sum()


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
        per_atom, boxes = clash_forward_cuda(positions, atom_exists, atom_radius,
                                             residue_index, tol_soft)
        ctx.save_for_backward(positions, atom_exists, atom_radius, residue_index, boxes)
        ctx.tol_soft = tol_soft
        return per_atom

    @staticmethod
    @once_differentiable
    def backward(ctx, w):
        positions, atom_exists, atom_radius, residue_index, boxes = ctx.saved_tensors
        dpos = clash_backward_cuda(positions, atom_exists, atom_radius, residue_index,
                                   w.contiguous(), ctx.tol_soft, boxes=boxes)
        # exists, radius and index are chemistry constants along the only
        # differentiable path (torsions -> coordinates)
        return dpos, None, None, None, None


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
    return B, L


def tile_boxes_cuda(positions, atom_exists, atom_radius):
    """[B, ncol, 8] per column tile of 128 atoms: the existing atoms' bounding
    box (lo xyz, hi xyz), their largest radius, and whether any exists. A
    small kernel of its own; the pair kernels cull against it on the device."""
    B, L = positions.shape[:2]
    ncol = -(-14 * L // COLS_PER_TILE)
    boxes = torch.empty(B, ncol, _BOX, dtype=torch.float32, device=positions.device)
    lib = _lib()
    err = lib.packppi_clash_boxes(*(_build.ptr(t) for t in (positions, atom_exists, atom_radius,
                                                            boxes)),
                                  B, L, _build.stream_ptr(positions.device))
    _build.check(lib, err, "clash box kernel launch")
    return boxes


def clash_forward_cuda(positions, atom_exists, atom_radius, residue_index, tol_soft,
                       cull: bool = True, live_tiles=None):
    """Launch the forward kernel; returns (per_atom [B, L, 14], the tile
    boxes). ``cull=False`` visits every tile (the sums are the same bits);
    ``live_tiles``, an int32 [B, nrow] tensor, receives each row block's
    count of visited tiles."""
    B, L = _check(positions, atom_exists, atom_radius, residue_index)
    boxes = tile_boxes_cuda(positions, atom_exists, atom_radius)
    out = torch.empty(B, L, 14, dtype=torch.float32, device=positions.device)
    lib = _lib()
    err = lib.packppi_clash_forward(
        *(_build.ptr(t) for t in (positions, atom_exists, atom_radius, residue_index, boxes,
                                  out, _live(live_tiles, B, L))),
        B, L, float(tol_soft), int(cull), _build.stream_ptr(positions.device))
    _build.check(lib, err, "clash forward kernel launch")
    between_residue_clash.launches_fwd += 1
    return out, boxes


def clash_backward_cuda(positions, atom_exists, atom_radius, residue_index, w, tol_soft,
                        cull: bool = True, live_tiles=None, boxes=None):
    """Launch the gradient kernel: d(sum(w * per_atom))/d positions,
    [B, L, 14, 3]. ``boxes`` are the forward's tile boxes (computed here if
    not given)."""
    B, L = _check(positions, atom_exists, atom_radius, residue_index, w=(w, tuple(positions.shape[:3])))
    if boxes is None:
        boxes = tile_boxes_cuda(positions, atom_exists, atom_radius)
    out = torch.empty_like(positions)
    lib = _lib()
    err = lib.packppi_clash_backward(
        *(_build.ptr(t) for t in (positions, atom_exists, atom_radius, residue_index, w, boxes,
                                  out, _live(live_tiles, B, L))),
        B, L, float(tol_soft), int(cull), _build.stream_ptr(positions.device))
    _build.check(lib, err, "clash gradient kernel launch")
    between_residue_clash.launches_bwd += 1
    return out


def _live(live_tiles, B, L):
    if live_tiles is None:
        return None
    nrow = -(-14 * L // ROWS_PER_BLOCK)
    if (live_tiles.dtype != torch.int32 or tuple(live_tiles.shape) != (B, nrow)
            or not live_tiles.is_cuda or not live_tiles.is_contiguous()):
        raise ValueError(f"clash kernel: live_tiles must be a contiguous CUDA int32 [{B}, {nrow}]")
    return live_tiles


def _lib():
    lib = _build.load_library("clash")
    if lib.packppi_clash_forward.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.packppi_clash_boxes.argtypes = [p] * 4 + [i, i, p]
        lib.packppi_clash_forward.argtypes = [p] * 7 + [i, i, ctypes.c_float, i, p]
        lib.packppi_clash_backward.argtypes = [p] * 8 + [i, i, ctypes.c_float, i, p]
        for fn in (lib.packppi_clash_boxes, lib.packppi_clash_forward,
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
