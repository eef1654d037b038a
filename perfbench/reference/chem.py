"""Residue-type chemistry tables of the plain reference, from its own copy of
the chemistry data (``chem_data.json``: AlphaFold2's residue constants).

Rows 0..19 are the standard amino acids in ``RESTYPES`` order, row 20 the
unknown type with all-zero entries. Atom layout is atom14; rigid groups are
AF2's eight (backbone, pre-omega, phi, psi, chi1..4) with the frame
conventions of the PackPPI reference checkpoints.
"""
from __future__ import annotations

import functools
import json
from pathlib import Path

import numpy as np

RAW = json.loads((Path(__file__).parent / "chem_data.json").read_text())
RESTYPES: list = RAW["restypes"]
RESTYPE_1TO3: dict = RAW["restype_1to3"]
RESTYPE_3TO1 = {v: k for k, v in RESTYPE_1TO3.items()}
ATOM14_NAMES: dict = RAW["atom14_names"]
N_TYPES = len(RESTYPES) + 1


def _names():
    return [RESTYPE_1TO3[r] for r in RESTYPES]


def _axes_frame(ex, ey_hint, origin):
    ex = ex / np.linalg.norm(ex)
    ey = ey_hint - np.dot(ey_hint, ex) * ex
    ey = ey / np.linalg.norm(ey)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = ex, ey, np.cross(ex, ey), origin
    return m


def _rigid_groups():
    frames = np.zeros((N_TYPES, 8, 4, 4), np.float32)
    group = np.zeros((N_TYPES, 14), np.int64)
    mask = np.zeros((N_TYPES, 14), np.float32)
    local = np.zeros((N_TYPES, 14, 3), np.float32)
    chi_mask = np.asarray(RAW["chi_angles_mask"], np.float32)
    for ri, name in enumerate(_names()):
        entries = RAW["rigid_group_atom_positions"][name]
        pos = {a: np.array([x, y, z]) for a, g, x, y, z in entries}
        for a, g, x, y, z in entries:
            i = ATOM14_NAMES[name].index(a)
            group[ri, i], mask[ri, i], local[ri, i] = g, 1.0, (x, y, z)
        frames[ri, 0] = frames[ri, 1] = np.eye(4)
        frames[ri, 2] = _axes_frame(pos["N"] - pos["CA"], np.array([1.0, 0.0, 0.0]), pos["N"])
        frames[ri, 3] = _axes_frame(pos["C"] - pos["CA"], pos["CA"] - pos["N"], pos["C"])
        chis = RAW["chi_angles_atoms"][name]
        if chi_mask[ri, 0]:
            p0, p1, p2 = (pos[a] for a in chis[0][:3])
            frames[ri, 4] = _axes_frame(p2 - p1, p0 - p1, p2)
        for k in range(1, 4):
            if chi_mask[ri, k]:
                end = pos[chis[k][2]]
                frames[ri, 4 + k] = _axes_frame(end, np.array([-1.0, 0.0, 0.0]), end)
    return frames, group, mask, local


def _chi_tables():
    idx = np.zeros((N_TYPES, 7), np.int64)
    cmask = np.zeros((N_TYPES, 4), np.float32)
    for ri, name in enumerate(_names()):
        chis = RAW["chi_angles_atoms"][name]
        cmask[ri, :len(chis)] = 1.0
        seen: list = []
        for chi in chis:
            seen += [a for a in chi if a not in seen]
        for k, a in enumerate(seen):
            idx[ri, k] = ATOM14_NAMES[name].index(a)
    return idx, cmask


def _vdw():
    r = np.zeros((N_TYPES, 14), np.float32)
    for ri, name in enumerate(_names()):
        for i, a in enumerate(ATOM14_NAMES[name]):
            if a:
                r[ri, i] = RAW["van_der_waals_radius"][a[0]]
    return r


def _bonds(name):
    """Bonds and the 1-3 distances of bond angles (law of cosines, with the
    first-order spread), as (a1, a2, length, std)."""
    bonds = [tuple(b) for b in RAW["bonds"].get(name, [])]
    by = {frozenset(b[:2]): b[2:] for b in bonds}
    out = list(bonds)
    for a1, a2, a3, gamma, gstd in RAW["bond_angles"].get(name, []):
        l1, s1 = by[frozenset((a1, a2))]
        l2, s2 = by[frozenset((a2, a3))]
        length = np.sqrt(l1 * l1 + l2 * l2 - 2 * l1 * l2 * np.cos(gamma))
        dg = l1 * l2 * np.sin(gamma) / length
        d1 = (l1 - l2 * np.cos(gamma)) / length
        d2 = (l2 - l1 * np.cos(gamma)) / length
        out.append((a1, a3, float(length),
                    float(np.sqrt((dg * gstd) ** 2 + (d1 * s1) ** 2 + (d2 * s2) ** 2))))
    return out


@functools.lru_cache(maxsize=None)
def dist_bounds(overlap_tolerance: float, bond_factor: float):
    """[21, 14, 14] lower / upper distance bounds within a residue: van der
    Waals sums less ``overlap_tolerance`` for unbonded pairs, ``length +-
    bond_factor * std`` for bonds and 1-3 pairs."""
    lower = np.zeros((N_TYPES, 14, 14), np.float32)
    upper = np.zeros((N_TYPES, 14, 14), np.float32)
    for ri, name in enumerate(_names()):
        names = ATOM14_NAMES[name]
        rad = np.array([RAW["van_der_waals_radius"][a[0]] if a else 0.0 for a in names])
        ex = np.array([bool(a) for a in names])
        pair = ex[:, None] & ex[None, :] & ~np.eye(14, dtype=bool)
        lower[ri][pair] = (rad[:, None] + rad[None, :] - overlap_tolerance)[pair]
        upper[ri][pair] = 1e10
        for a1, a2, length, std in _bonds(name):
            i, j = names.index(a1), names.index(a2)
            lower[ri, i, j] = lower[ri, j, i] = length - bond_factor * std
            upper[ri, i, j] = upper[ri, j, i] = length + bond_factor * std
    return lower, upper


GROUP_FRAMES, ATOM14_GROUP, ATOM14_MASK, ATOM14_LOCAL = _rigid_groups()
CHI_ATOMS, CHI_MASK = _chi_tables()
CHI_PI_PERIODIC = np.concatenate(
    [np.asarray(RAW["chi_pi_periodic"][:len(RESTYPES)], np.float32), np.zeros((1, 4), np.float32)])
VDW = _vdw()
