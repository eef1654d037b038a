"""Dense residue-type-indexed chemistry tables.

Plain numpy constants built from ``chem_data.json`` (this package's own
copy). Row convention: 0..19 are the 20 standard amino acids in the order
of ``RESTYPES``; row 20 is the unknown type 'X' with all-zero entries.
Semantics follow AlphaFold2's atom14 encoding and 8-rigid-group frame
decomposition (backbone, pre-omega, phi, psi, chi1..4).
"""
from __future__ import annotations

import dataclasses
import functools
import json
from pathlib import Path

import numpy as np

_RAW = json.loads((Path(__file__).parent / "chem_data.json").read_text())

RESTYPES: list[str] = _RAW["restypes"]
NUM_RESTYPES = len(RESTYPES)  # 20 standard; tables have a 21st 'X' row
RESTYPE_ORDER = {r: i for i, r in enumerate(RESTYPES)}
RESTYPE_1TO3: dict[str, str] = _RAW["restype_1to3"]
RESTYPE_3TO1 = {three: one for one, three in RESTYPE_1TO3.items()}

ATOM37_TYPES: list[str] = _RAW["atom37_types"]
ATOM37_ORDER = {a: i for i, a in enumerate(ATOM37_TYPES)}
NUM_ATOM37 = len(ATOM37_TYPES)
ATOM14_NAMES: dict[str, list[str]] = _RAW["atom14_names"]
NUM_ATOM14 = 14
_VDW: dict[str, float] = _RAW["van_der_waals_radius"]


def _resnames():
    """3-letter names in restype order."""
    return [RESTYPE_1TO3[r] for r in RESTYPES]


def _rigid_transform_from_axes(ex, ey_hint, origin):
    """4x4 transform whose x-axis is ex and whose y-axis is the component of
    ey_hint orthogonal to ex (Gram-Schmidt), translated to ``origin``."""
    ex = ex / np.linalg.norm(ex)
    ey = ey_hint - np.dot(ey_hint, ex) * ex
    ey = ey / np.linalg.norm(ey)
    ez = np.cross(ex, ey)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = ex, ey, ez, origin
    return m


def _build_rigid_group_tables():
    """(default_frames [21,8,4,4], atom14_group [21,14], atom14_mask [21,14],
    atom14_local_pos [21,14,3])."""
    frames = np.zeros((NUM_RESTYPES + 1, 8, 4, 4), np.float32)
    group = np.zeros((NUM_RESTYPES + 1, NUM_ATOM14), np.int64)
    mask = np.zeros((NUM_RESTYPES + 1, NUM_ATOM14), np.float32)
    local = np.zeros((NUM_RESTYPES + 1, NUM_ATOM14, 3), np.float32)
    chi_mask = np.asarray(_RAW["chi_angles_mask"], np.float32)

    for ri, resname in enumerate(_resnames()):
        entries = _RAW["rigid_group_atom_positions"][resname]
        pos = {a: np.array([x, y, z]) for a, g, x, y, z in entries}
        a14 = ATOM14_NAMES[resname]
        for a, g, x, y, z in entries:
            i14 = a14.index(a)
            group[ri, i14] = g
            mask[ri, i14] = 1.0
            local[ri, i14] = (x, y, z)

        # group 0 (backbone) and group 1 (pre-omega) are identities
        frames[ri, 0] = np.eye(4)
        frames[ri, 1] = np.eye(4)
        # phi frame: x along CA->N, translated to N
        frames[ri, 2] = _rigid_transform_from_axes(
            pos["N"] - pos["CA"], np.array([1.0, 0.0, 0.0]), pos["N"])
        # psi frame: x along CA->C, y toward N
        frames[ri, 3] = _rigid_transform_from_axes(
            pos["C"] - pos["CA"], pos["CA"] - pos["N"], pos["C"])
        chis = _RAW["chi_angles_atoms"][resname]
        if chi_mask[ri, 0]:
            p0, p1, p2 = (pos[a] for a in chis[0][:3])
            frames[ri, 4] = _rigid_transform_from_axes(p2 - p1, p0 - p1, p2)
        # chi_{k+1} relative to chi_k: the rotation axis passes through the
        # axis-end atom, which sits at the previous group's origin
        for k in range(1, 4):
            if chi_mask[ri, k]:
                end = pos[chis[k][2]]
                frames[ri, 4 + k] = _rigid_transform_from_axes(
                    end, np.array([-1.0, 0.0, 0.0]), end)
    return frames, group, mask, local


def _build_atom14_atom37_maps():
    """Index maps between the compact atom14 and the fixed atom37 layouts,
    and atom37's existence mask."""
    a14_to_a37 = np.zeros((NUM_RESTYPES + 1, NUM_ATOM14), np.int64)
    a37_to_a14 = np.zeros((NUM_RESTYPES + 1, NUM_ATOM37), np.int64)
    a37_mask = np.zeros((NUM_RESTYPES + 1, NUM_ATOM37), np.float32)
    for ri, resname in enumerate(_resnames()):
        names = ATOM14_NAMES[resname]
        idx14 = {a: i for i, a in enumerate(names) if a}
        for i, a in enumerate(names):
            a14_to_a37[ri, i] = ATOM37_ORDER[a] if a else 0
        for j, a in enumerate(ATOM37_TYPES):
            a37_to_a14[ri, j] = idx14.get(a, 0)
        for a in _RAW["residue_atoms"][resname]:
            a37_mask[ri, ATOM37_ORDER[a]] = 1.0
    return a14_to_a37, a37_to_a14, a37_mask


def _build_chi_tables():
    """Chi-angle gather indices: the four chi dihedrals of a residue are read
    off a chain of at most 7 unique atoms, listed by atom14 slot."""
    idx = np.zeros((NUM_RESTYPES + 1, 7), np.int64)
    cmask = np.zeros((NUM_RESTYPES + 1, 4), np.float32)
    for ri, resname in enumerate(_resnames()):
        chis = _RAW["chi_angles_atoms"][resname]
        cmask[ri, : len(chis)] = 1.0
        seen: list[str] = []
        for chi in chis:
            for a in chi:
                if a not in seen:
                    seen.append(a)
        names = ATOM14_NAMES[resname]
        for k, a in enumerate(seen):
            idx[ri, k] = names.index(a)
    return idx, cmask


def _build_vdw_atom14():
    r = np.zeros((NUM_RESTYPES + 1, NUM_ATOM14), np.float32)
    for ri, resname in enumerate(_resnames()):
        for i, a in enumerate(ATOM14_NAMES[resname]):
            if a:
                r[ri, i] = _VDW[a[0]]
    return r


@functools.lru_cache(maxsize=None)
def _virtual_bonds():
    """Bond-angle records turned into 1-3 atom distances via the law of
    cosines, with first-order uncertainty propagation. Per residue, returns
    the union of real bonds and these virtual bonds as (a1, a2, len, std)."""
    out: dict[str, list[tuple[str, str, float, float]]] = {}
    for resname in list(_RAW["bonds"]) + ["UNK"]:
        bonds = [(a1, a2, l, s) for a1, a2, l, s in _RAW["bonds"].get(resname, [])]
        by_key = {frozenset((a1, a2)): (l, s) for a1, a2, l, s in bonds}
        virtual = []
        for a1, a2, a3, gamma, gstd in _RAW["bond_angles"].get(resname, []):
            l1, s1 = by_key[frozenset((a1, a2))]
            l2, s2 = by_key[frozenset((a2, a3))]
            length = np.sqrt(l1 * l1 + l2 * l2 - 2 * l1 * l2 * np.cos(gamma))
            half_inv = 0.5 / length
            dg = 2 * l1 * l2 * np.sin(gamma) * half_inv
            d1 = (2 * l1 - 2 * l2 * np.cos(gamma)) * half_inv
            d2 = (2 * l2 - 2 * l1 * np.cos(gamma)) * half_inv
            std = np.sqrt((dg * gstd) ** 2 + (d1 * s1) ** 2 + (d2 * s2) ** 2)
            virtual.append((a1, a3, float(length), float(std)))
        out[resname] = bonds + virtual
    return out


@functools.lru_cache(maxsize=None)
def make_atom14_dists_bounds(overlap_tolerance: float = 1.5,
                             bond_length_tolerance_factor: float = 15.0):
    """[21,14,14] lower/upper distance bounds within a residue.

    Non-bonded pairs get ``r_vdw(i)+r_vdw(j)-overlap`` as lower bound and
    1e10 as upper; bonded and angle-coupled (1-3) pairs get
    ``len +- factor*std``.
    """
    lower = np.zeros((NUM_RESTYPES + 1, NUM_ATOM14, NUM_ATOM14), np.float32)
    upper = np.zeros((NUM_RESTYPES + 1, NUM_ATOM14, NUM_ATOM14), np.float32)
    vb = _virtual_bonds()
    for ri, resname in enumerate(_resnames()):
        names = ATOM14_NAMES[resname]
        radius = np.array([_VDW[a[0]] if a else 0.0 for a in names])
        exists = np.array([bool(a) for a in names])
        pair = exists[:, None] & exists[None, :] & ~np.eye(NUM_ATOM14, dtype=bool)
        lower[ri][pair] = (radius[:, None] + radius[None, :] - overlap_tolerance)[pair]
        upper[ri][pair] = 1e10
        for a1, a2, length, std in vb[resname]:
            i, j = names.index(a1), names.index(a2)
            lower[ri, i, j] = lower[ri, j, i] = length - bond_length_tolerance_factor * std
            upper[ri, i, j] = upper[ri, j, i] = length + bond_length_tolerance_factor * std
    return {"lower_bound": lower, "upper_bound": upper}


def sc_atom14_mask(chi_id: int) -> np.ndarray:
    """[21, 14] mask of the atoms placed once chis 0..``chi_id`` are fixed
    (reference: src/utils/residue_constants.py:680-705); a residue with
    fewer chis than that gets its whole heavy-atom set."""
    rows = []
    for resname in _resnames():
        chis = _RAW["chi_angles_atoms"][resname]
        if chi_id >= len(chis):
            n = len(_RAW["residue_atoms"][resname])
            rows.append([1] * n + [0] * (NUM_ATOM14 - n))
            continue
        seen: list[str] = []
        for chi in chis[: chi_id + 1]:
            for a in chi:
                if a not in seen:
                    seen.append(a)
        n = ATOM14_NAMES[resname].index(seen[-1]) + 1 if seen else 0
        rows.append([1] * n + [0] * (NUM_ATOM14 - n))
    rows.append([0] * NUM_ATOM14)
    return np.asarray(rows, np.float32)


def _pad21(rows):
    """Stack 20 rows and append an all-zero 'X' row."""
    arr = np.asarray(rows, np.float32)
    return np.concatenate([arr, np.zeros((1,) + arr.shape[1:], np.float32)], 0)


@dataclasses.dataclass(frozen=True)
class ChemTables:
    """The dense tables the packing, proximal and layout code read."""

    rigid_group_default_frame: np.ndarray  # [21, 8, 4, 4]
    atom14_to_rigid_group: np.ndarray      # [21, 14] int64
    atom14_mask: np.ndarray                # [21, 14]
    atom14_local_positions: np.ndarray     # [21, 14, 3]
    atom14_to_atom37: np.ndarray           # [21, 14] int64
    atom37_to_atom14: np.ndarray           # [21, 37] int64
    atom37_mask: np.ndarray                # [21, 37]
    chi_atom14_indices: np.ndarray         # [21, 7] int64
    chi_mask: np.ndarray                   # [21, 4]
    chi_pi_periodic: np.ndarray            # [21, 4]
    vdw_radius_atom14: np.ndarray          # [21, 14]

    @staticmethod
    def build() -> "ChemTables":
        frames, group, mask, local = _build_rigid_group_tables()
        a14_to_a37, a37_to_a14, a37_mask = _build_atom14_atom37_maps()
        chi_idx, chi_mask = _build_chi_tables()
        return ChemTables(
            rigid_group_default_frame=frames,
            atom14_to_rigid_group=group,
            atom14_mask=mask,
            atom14_local_positions=local,
            atom14_to_atom37=a14_to_a37,
            atom37_to_atom14=a37_to_a14,
            atom37_mask=a37_mask,
            chi_atom14_indices=chi_idx,
            chi_mask=chi_mask,
            chi_pi_periodic=_pad21(_RAW["chi_pi_periodic"][:NUM_RESTYPES]),
            vdw_radius_atom14=_build_vdw_atom14(),
        )


CHEM = ChemTables.build()
