"""Ideal hydrogen placement on atom14 structures (mini-Reduce).

MolProbity's clashscore runs Probe over a hydrogenated model (the reference
shells out to ``molprobity.clashscore keep_hydrogens=True``, reference:
src/utils/protein_analysis.py:26-34). This module provides the offline
equivalent of the H-addition step: ideal-geometry hydrogens placed from the
heavy-atom coordinates with standard bond lengths and hybridization rules —
tetrahedral completion for sp3 CH/CH2, staggered rotors for methyls /
hydroxyls / NH3+, in-plane bisectors for sp2 CH/NH, and in-plane pairs for
amide/guanidinium NH2. The NE2-H tautomer is used for neutral histidine and
the N-terminus is protonated as NH3+ (Reduce's defaults).

Everything is plain numpy over [L, 14] arrays — this is metric-time host
code, not the training path.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from packppi_torch.chem import ATOM14_NAMES, RESTYPE_1TO3, RESTYPES

_RAW = json.loads((Path(__file__).parent.parent / "chem" / "chem_data.json").read_text())
BONDS = _RAW["bonds"]                      # resname -> [[a, b, length, stddev], ...]
# donor-ness is derived from PLACED polar hydrogens throughout this module
# (not from a donor-atom name set); only the acceptor set is name-keyed
HBOND_ACCEPTORS = set(_RAW["hbond_acceptor_atoms"]) | {"O"}


def residue_names(prot) -> list[str]:
    """Three-letter residue names from aaindex ('UNK' past the table) —
    the shared derivation for every host-side chemistry pass here and in
    hbond_networks.py."""
    return [RESTYPE_1TO3[RESTYPES[i]] if i < len(RESTYPES) else "UNK"
            for i in prot.aaindex]

# the name list alone marks GLN's amide NE2 (always a donor) and — in our
# NE2-H tautomer — HIS NE2 as acceptors; both carry hydrogens here
_NON_ACCEPTOR = {("GLN", "NE2"), ("HIS", "NE2")}


def is_hbond_acceptor(resname: str, atom_name: str) -> bool:
    """Residue-aware H-bond acceptor test."""
    return atom_name in HBOND_ACCEPTORS and (resname, atom_name) not in _NON_ACCEPTOR


def _cell_list(coords: np.ndarray, cell: float):
    """Spatial hash over points; returns (buckets, near) where near(p)
    yields the indices within the 27-cell neighborhood of p."""
    keys = np.floor(coords / cell).astype(np.int64)
    buckets: dict[tuple, list] = {}
    for k in range(len(coords)):
        buckets.setdefault(tuple(keys[k]), []).append(k)
    offsets = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
               for dz in (-1, 0, 1)]

    def near(point):
        key = tuple(np.floor(point / cell).astype(np.int64))
        out = []
        for off in offsets:
            out.extend(buckets.get((key[0] + off[0], key[1] + off[1],
                                    key[2] + off[2]), []))
        return np.asarray(out, np.int64)

    return buckets, near

# bond lengths to H by heavy element
H_BOND_LENGTH = {"C": 1.09, "N": 1.01, "O": 0.96, "S": 1.34}
_TETRA = np.deg2rad(109.471)

# Side-chain hydrogen spec per 3-letter residue name:
#   (heavy, nH, geom, refs)
# geom:
#   "t1"    1 H completing a tetrahedron; refs = 3 bonded heavy atoms
#   "t2"    2 H completing a tetrahedron; refs = 2 bonded heavy atoms
#   "rot"   nH staggered rotor H; refs = (bonded_parent, dihedral_ref)
#   "sp2b"  1 H on the external bisector; refs = 2 bonded heavy atoms
#   "sp2p"  2 H in-plane at 120 deg; refs = (bonded_parent, plane_ref)
H_SPEC: dict[str, list] = {
    "ALA": [("CB", 3, "rot", ("CA", "N"))],
    "ARG": [("CB", 2, "t2", ("CA", "CG")), ("CG", 2, "t2", ("CB", "CD")),
            ("CD", 2, "t2", ("CG", "NE")), ("NE", 1, "sp2b", ("CD", "CZ")),
            ("NH1", 2, "sp2p", ("CZ", "NE")), ("NH2", 2, "sp2p", ("CZ", "NE"))],
    "ASN": [("CB", 2, "t2", ("CA", "CG")), ("ND2", 2, "sp2p", ("CG", "CB"))],
    "ASP": [("CB", 2, "t2", ("CA", "CG"))],
    "CYS": [("CB", 2, "t2", ("CA", "SG")), ("SG", 1, "rot", ("CB", "CA"))],
    "GLN": [("CB", 2, "t2", ("CA", "CG")), ("CG", 2, "t2", ("CB", "CD")),
            ("NE2", 2, "sp2p", ("CD", "CG"))],
    "GLU": [("CB", 2, "t2", ("CA", "CG")), ("CG", 2, "t2", ("CB", "CD"))],
    "GLY": [],
    "HIS": [("CB", 2, "t2", ("CA", "CG")), ("CD2", 1, "sp2b", ("CG", "NE2")),
            ("CE1", 1, "sp2b", ("ND1", "NE2")), ("NE2", 1, "sp2b", ("CE1", "CD2"))],
    "ILE": [("CB", 1, "t1", ("CA", "CG1", "CG2")), ("CG1", 2, "t2", ("CB", "CD1")),
            ("CG2", 3, "rot", ("CB", "CA")), ("CD1", 3, "rot", ("CG1", "CB"))],
    "LEU": [("CB", 2, "t2", ("CA", "CG")), ("CG", 1, "t1", ("CB", "CD1", "CD2")),
            ("CD1", 3, "rot", ("CG", "CB")), ("CD2", 3, "rot", ("CG", "CB"))],
    "LYS": [("CB", 2, "t2", ("CA", "CG")), ("CG", 2, "t2", ("CB", "CD")),
            ("CD", 2, "t2", ("CG", "CE")), ("CE", 2, "t2", ("CD", "NZ")),
            ("NZ", 3, "rot", ("CE", "CD"))],
    "MET": [("CB", 2, "t2", ("CA", "CG")), ("CG", 2, "t2", ("CB", "SD")),
            ("CE", 3, "rot", ("SD", "CG"))],
    "PHE": [("CB", 2, "t2", ("CA", "CG")), ("CD1", 1, "sp2b", ("CG", "CE1")),
            ("CD2", 1, "sp2b", ("CG", "CE2")), ("CE1", 1, "sp2b", ("CD1", "CZ")),
            ("CE2", 1, "sp2b", ("CD2", "CZ")), ("CZ", 1, "sp2b", ("CE1", "CE2"))],
    "PRO": [("CB", 2, "t2", ("CA", "CG")), ("CG", 2, "t2", ("CB", "CD")),
            ("CD", 2, "t2", ("CG", "N"))],
    "SER": [("CB", 2, "t2", ("CA", "OG")), ("OG", 1, "rot", ("CB", "CA"))],
    "THR": [("CB", 1, "t1", ("CA", "OG1", "CG2")), ("OG1", 1, "rot", ("CB", "CA")),
            ("CG2", 3, "rot", ("CB", "CA"))],
    "TRP": [("CB", 2, "t2", ("CA", "CG")), ("CD1", 1, "sp2b", ("CG", "NE1")),
            ("NE1", 1, "sp2b", ("CD1", "CE2")), ("CE3", 1, "sp2b", ("CD2", "CZ3")),
            ("CZ2", 1, "sp2b", ("CE2", "CH2")), ("CZ3", 1, "sp2b", ("CE3", "CH2")),
            ("CH2", 1, "sp2b", ("CZ2", "CZ3"))],
    "TYR": [("CB", 2, "t2", ("CA", "CG")), ("CD1", 1, "sp2b", ("CG", "CE1")),
            ("CD2", 1, "sp2b", ("CG", "CE2")), ("CE1", 1, "sp2b", ("CD1", "CZ")),
            ("CE2", 1, "sp2b", ("CD2", "CZ")), ("OH", 1, "rot", ("CZ", "CE1"))],
    "VAL": [("CB", 1, "t1", ("CA", "CG1", "CG2")), ("CG1", 3, "rot", ("CB", "CA")),
            ("CG2", 3, "rot", ("CB", "CA"))],
}


def _unit(v):
    # scalar math beats np.linalg.norm by ~10x on single 3-vectors, and this
    # sits under every per-atom H-placement helper
    n = (v[0] * v[0] + v[1] * v[1] + v[2] * v[2]) ** 0.5
    return v / max(n, 1e-9)


def _cross3(a, b):
    return np.array([a[1] * b[2] - a[2] * b[1],
                     a[2] * b[0] - a[0] * b[2],
                     a[0] * b[1] - a[1] * b[0]])


def _tetra_one(x, n1, n2, n3, blen):
    d = -_unit(_unit(n1 - x) + _unit(n2 - x) + _unit(n3 - x))
    return [x + blen * d]


def _tetra_two(x, n1, n2, blen):
    ua, ub = _unit(n1 - x), _unit(n2 - x)
    bis = -_unit(ua + ub)
    perp = _unit(_cross3(ua, ub))
    half = _TETRA / 2
    return [x + blen * (np.cos(half) * bis + s * np.sin(half) * perp)
            for s in (+1, -1)]


def _sp2_bisector(x, n1, n2, blen):
    return [x + blen * -_unit(_unit(n1 - x) + _unit(n2 - x))]


def _sp2_pair(x, parent, plane_ref, blen):
    w = _unit(x - parent)
    r = plane_ref - parent
    p = _unit(r - np.dot(r, w) * w)
    c, s = np.cos(np.pi / 3), np.sin(np.pi / 3)
    return [x + blen * (c * w + s * p), x + blen * (c * w - s * p)]


def _rotor_frame(x, parent, dref):
    """Orthonormal (axis, p, q) frame of a rotor about parent->x."""
    axis = _unit(x - parent)
    r = dref - parent
    p = _unit(r - np.dot(r, axis) * axis)
    return axis, p, _cross3(axis, p)


def _rotor_phases(x, parent, dref, blen, n_h, phases, theta=_TETRA):
    """H positions [n_phases, n_h, 3] staggered about the parent->x axis:
    dihedral(dref, parent, x, H) = 180, 60, -60 deg (plus each phase)."""
    axis, p, q = _rotor_frame(x, parent, dref)
    phases = np.atleast_1d(np.asarray(phases, np.float64))
    phi = np.pi + phases[:, None] + np.arange(n_h) * (2 * np.pi / 3)  # [P, n_h]
    d = (np.cos(np.pi - theta) * axis
         + np.sin(np.pi - theta) * (np.cos(phi)[..., None] * p
                                    + np.sin(phi)[..., None] * q))
    return x + blen * d  # d is unit by construction (orthonormal frame)


def _rotor(x, parent, dref, blen, n_h, theta=_TETRA, phase=0.0):
    """n_h H staggered about the parent->x axis (single-phase convenience)."""
    return list(_rotor_phases(x, parent, dref, blen, n_h, [phase], theta)[0])


def heavy_graph(prot):
    """Flattened heavy atoms + bond graph of a parsed Protein.

    Returns (coords [n,3], names, res_of, flat_index [L,14], sep) where
    ``sep`` maps ordered index pairs (a<b) to their bond-path distance,
    present only when <= 3 (Probe's exclusion horizon). Covers
    within-residue bonds, peptide C-N links, and disulfide SG-SG pairs.
    """
    from packppi_torch.chem import ATOM14_NAMES, RESTYPE_1TO3, RESTYPES

    X = np.asarray(prot.atom_positions, np.float64)
    mask = np.asarray(prot.atom_mask).astype(bool)
    L = X.shape[0]
    resnames = residue_names(prot)

    coords, names, res_of = [], [], []
    flat_index = -np.ones((L, 14), np.int64)
    for i in range(L):
        rn = resnames[i]
        if rn == "UNK":
            continue
        for s, nm in enumerate(ATOM14_NAMES[rn]):
            if nm and mask[i, s]:
                flat_index[i, s] = len(coords)
                coords.append(X[i, s])
                names.append(nm)
                res_of.append(i)
    n = len(coords)

    adj: list[set] = [set() for _ in range(n)]

    def link(a, b):
        if a >= 0 and b >= 0:
            adj[a].add(b)
            adj[b].add(a)

    for i in range(L):
        rn = resnames[i]
        if rn == "UNK":
            continue
        name_to_slot = {nm: s for s, nm in enumerate(ATOM14_NAMES[rn]) if nm}
        for a, b, *_ in BONDS.get(rn, []):
            if a in name_to_slot and b in name_to_slot:
                link(flat_index[i, name_to_slot[a]], flat_index[i, name_to_slot[b]])
        if i + 1 < L and prot.chain_id[i] == prot.chain_id[i + 1] \
                and flat_index[i, 2] >= 0 and flat_index[i + 1, 0] >= 0 \
                and np.linalg.norm(X[i, 2] - X[i + 1, 0]) < 2.0:
            link(flat_index[i, 2], flat_index[i + 1, 0])
    sg = [k for k in range(n) if names[k] == "SG"]
    for ii, a in enumerate(sg):
        for b in sg[ii + 1:]:
            if np.linalg.norm(coords[a] - coords[b]) < 2.5:
                link(a, b)

    sep: dict[tuple, int] = {}
    for a in range(n):
        frontier = {a}
        seen = {a: 0}
        for d in (1, 2, 3):
            frontier = {m for f in frontier for m in adj[f] if m not in seen}
            for m in frontier:
                seen[m] = d
        for m, d in seen.items():
            if a < m:
                sep[(a, m)] = d

    return (np.asarray(coords, np.float64).reshape(-1, 3), names,
            np.asarray(res_of, np.int64), flat_index, sep)


# Reduce's amide/imidazole flips: terminal groups whose X-ray density is
# ambiguous. Swapping the two listed atom14 slots flips the group; the
# orientation with the better Reduce-style score is kept.
FLIP_GROUPS = {
    "ASN": [("OD1", "ND2")],
    "GLN": [("OE1", "NE2")],
    "HIS": [("ND1", "CD2"), ("CE1", "NE2")],  # chi2 ring flip: both pairs swap
}

# Reduce scores orientations with Probe dot weights: clash -10, H-bond +4
# (Word et al. 1999, J Mol Biol 285:1735, the program MolProbity runs
# internally). Our analog keeps serious clashes dominant (1000/count),
# scores mild overlap with the ANALYTIC PROBE SPIKE MEASURE
# (``probe_spike_measure`` below — the closed-form infinite-density limit
# of Probe's per-dot penetration sum, geometry-dependent rather than
# linear in overlap), and REWARDS polar-H vs acceptor contact at the same
# 4:10 ratio on the same measure — so among clash-equivalent orientations
# the H-bond-forming one wins. The reward (like the final count's waiver)
# applies only below HBOND_OVERLAP_CAP; deeper interpenetration at a
# donor/acceptor contact scores as a clash again.
HBOND_REWARD_WEIGHT = 0.4
HBOND_OVERLAP_CAP = 0.8   # probe_clashscore's waiver imports this (one source)
SERIOUS_OVERLAP = 0.4     # MolProbity clashscore threshold, Angstrom


def spike_integral(ra, rb, d):
    """One-sided Probe spike measure: the infinite-dot-density limit of
    Probe's per-dot penetration scoring (Word et al. 1999 — dots on atom A's
    vdW sphere, each scored by its penetration depth into atom B), per unit
    dot density.

    For surface dots ``p`` on sphere A (radius ``ra``) and sphere B (radius
    ``rb``) at center distance ``d``, the dot-sum ``sum_p max(0, rb - |p -
    c_B|)`` approaches ``density * I`` with the closed form (substituting
    ``u = cos(theta)`` along the A->B axis)::

        I = 2*pi*ra^2 * [ rb*(1-u0) - (1/(3*ra*d)) * (rb^3 - |d-ra|^3) ]
        u0 = (ra^2 + d^2 - rb^2) / (2*ra*d)

    which for shallow overlap ``o = ra + rb - d`` simplifies to
    ``pi*ra*o^2*(rb - 2o/3)/d`` — quadratic in the overlap and scaled by the
    intersection-cap geometry, unlike a linear overlap term. Vectorized;
    returns 0 where A's surface does not enter B (including B buried deep
    inside A), and handles full containment of A in B (every dot
    penetrates). Units: Angstrom^3 (depth integrated over area).
    """
    ra = np.asarray(ra, np.float64)
    rb = np.asarray(rb, np.float64)
    d = np.maximum(np.asarray(d, np.float64), 1e-9)
    smin = np.abs(d - ra)                      # closest A-surface point to c_B
    u0 = (ra * ra + d * d - rb * rb) / (2.0 * ra * d)
    ulo = np.clip(u0, -1.0, 1.0)               # ulo=-1: whole sphere penetrates
    c = ra * ra + d * d
    b = 2.0 * ra * d
    top = np.maximum(c - b * ulo, 0.0)          # rb^2, or (d+ra)^2 when clipped
    I = (2.0 * np.pi * ra * ra * rb * (1.0 - ulo)
         - (2.0 * np.pi * ra / (3.0 * d)) * (top ** 1.5 - smin ** 3))
    return np.where(rb > smin, np.maximum(I, 0.0), 0.0)


def probe_spike_measure(ra, rb, d):
    """Symmetric Probe spike measure for an atom pair: dots on BOTH spheres
    (Probe scores each atom's own dot cloud). Zero when the spheres do not
    overlap. Replaces the linear ``overlap`` term in orientation scoring —
    see the HBOND_REWARD_WEIGHT note (the clash:H-bond weight RATIO is
    unchanged; only the geometry measure both are applied to is)."""
    return spike_integral(ra, rb, d) + spike_integral(rb, ra, d)


def encode_bond_sep(sep: dict, n: int):
    """Bond-separation table as sorted encoded keys (``lo * n + hi``) plus
    values, for vectorized ``lookup_bond_sep`` queries."""
    if not sep:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    keys = np.fromiter((a * n + b for (a, b) in sep), np.int64, len(sep))
    vals = np.fromiter(sep.values(), np.int64, len(sep))
    order = np.argsort(keys)
    return keys[order], vals[order]


def lookup_bond_sep(enc_keys, enc_vals, lo, hi, n, default: int = 4):
    """Vectorized bond-path distances for (lo, hi) pairs (lo <= hi); pairs
    absent from the <=3-bond table get ``default`` ('far')."""
    out = np.full(len(lo), default, np.int64)
    if len(enc_keys):
        enc = np.asarray(lo, np.int64) * n + np.asarray(hi, np.int64)
        pos = np.clip(np.searchsorted(enc_keys, enc), 0, len(enc_keys) - 1)
        hit = enc_keys[pos] == enc
        out[hit] = enc_vals[pos[hit]]
    return out


def flip_group_hydrogens(rn, pos_of):
    """A flip group's own hydrogens for a candidate orientation, as
    (position, polar) pairs (Reduce scores flips WITH hydrogens; a
    heavy-only cost mispicks)."""
    hs = []
    if rn == "ASN" and all(k in pos_of for k in ("ND2", "CG", "CB")):
        hs += [(h, True) for h in _sp2_pair(pos_of["ND2"], pos_of["CG"],
                                            pos_of["CB"], H_BOND_LENGTH["N"])]
    if rn == "GLN" and all(k in pos_of for k in ("NE2", "CD", "CG")):
        hs += [(h, True) for h in _sp2_pair(pos_of["NE2"], pos_of["CD"],
                                            pos_of["CG"], H_BOND_LENGTH["N"])]
    if rn == "HIS":
        for heavy, (r1, r2) in (("CD2", ("CG", "NE2")),
                                ("CE1", ("ND1", "NE2")),
                                ("NE2", ("CE1", "CD2"))):
            if all(k in pos_of for k in (heavy, r1, r2)):
                hs += [(h, heavy[0] == "N") for h in _sp2_bisector(
                    pos_of[heavy], pos_of[r1], pos_of[r2],
                    H_BOND_LENGTH[heavy[0]])]
    return hs


def optimize_amide_flips(prot, cutoff: float = 4.0, graph=None,
                         static_h=None):
    """Reduce-style ASN/GLN/HIS flip decisions by steric cost.

    Returns ``(flipped_prot, n_flipped)``: a copy of ``prot`` in which each
    flippable terminal group keeps the orientation (original or 180-degree
    flipped) with fewer serious clashes against surrounding non-bonded
    heavy atoms — scored over the group's heavy atoms PLUS its own
    hydrogens, with polar-H/acceptor (H-bond) contacts exempt, as Reduce
    does before Probe counts (reference: src/utils/protein_analysis.py:26-34
    shells out to the MolProbity binary, which runs Reduce internally).

    Greedy in residue order, but the neighbor cloud is updated after every
    accepted flip so later decisions see earlier flips. ``graph`` takes a
    precomputed :func:`heavy_graph` to avoid re-flattening.
    """
    import dataclasses

    from packppi_torch.chem import ATOM14_NAMES, RESTYPE_1TO3, RESTYPES
    from packppi_torch.utils.metrics import (
        PROBE_H_POLAR_RADIUS, PROBE_H_RADIUS, PROBE_RADII)

    X = np.array(prot.atom_positions, np.float64)
    mask = np.asarray(prot.atom_mask).astype(bool)
    L = X.shape[0]
    resnames = residue_names(prot)

    graph = graph or heavy_graph(prot)
    _gc, g_names, g_res, flat_index, _sep = graph
    env = scoring_environment(prot, graph, static_h)
    coords = np.array(env["coords"])    # mutable copy, updated on flips
    radii, acc = env["radii"], env["acceptor"]
    env_polar_h, res_idx = env["polar_h"], env["res"]

    # _cell_list's closure reads the mutable buckets dict at call time, so
    # move_atom's bucket updates below stay visible through it
    cell = cutoff
    buckets, near = _cell_list(coords, cell)

    def move_atom(flat, new_pos):
        old_key = tuple(np.floor(coords[flat] / cell).astype(np.int64))
        new_key = tuple(np.floor(new_pos / cell).astype(np.int64))
        if old_key != new_key:
            buckets[old_key].remove(flat)
            buckets.setdefault(new_key, []).append(flat)
        coords[flat] = new_pos

    def cost(i, rn, group_slots, positions, pos_of):
        """Reduce-style score of the group's atoms + their hydrogens vs
        OTHER residues' heavy atoms AND static hydrogens: serious clashes
        dominate, the Probe spike measure (``probe_spike_measure``, the
        analytic dot-density limit) breaks ties, and H-bond contact below
        the waiver cap is REWARDED in BOTH directions — the group's polar H
        donating to an environment acceptor, and the group's acceptor
        (OD1/OE1/ND1...) receiving from a fixed donor's H (backbone NH,
        ARG/TRP NH — exactly the contacts flips exist to satisfy)."""
        probes = [(p, PROBE_RADII.get(ATOM14_NAMES[rn][s][0], 1.7), False,
                   is_hbond_acceptor(rn, ATOM14_NAMES[rn][s]))
                  for s, p in zip(group_slots, positions)]
        probes += [(h, PROBE_H_POLAR_RADIUS if polar_h else PROBE_H_RADIUS,
                    polar_h, False)
                   for h, polar_h in flip_group_hydrogens(rn, pos_of)]
        total = 0.0
        for p, r_self, polar_h, acceptor_self in probes:
            na = near(p)
            if not len(na):
                continue
            other = na[res_idx[na] != i]  # own residue is bonded context
            if not len(other):
                continue
            dist = np.linalg.norm(coords[other] - p, axis=-1)
            overlap = np.clip((radii[other] + r_self) - dist, 0, None)
            spike = probe_spike_measure(r_self, radii[other], dist)
            hb = np.zeros(len(other), bool)
            if polar_h:
                hb |= acc[other]
            if acceptor_self:
                hb |= env_polar_h[other]
            hb &= overlap < HBOND_OVERLAP_CAP
            if hb.any():
                total -= HBOND_REWARD_WEIGHT * float(spike[hb].sum())
                overlap = np.where(hb, 0.0, overlap)
                spike = np.where(hb, 0.0, spike)
            # primary objective = serious clashes (what the final count
            # thresholds at 0.4 A); the spike measure only breaks ties
            total += (1000.0 * float((overlap >= SERIOUS_OVERLAP).sum())
                      + float(spike.sum()))
        return total

    flipped = 0
    for i in range(L):
        rn = resnames[i]
        pairs = FLIP_GROUPS.get(rn)
        if not pairs:
            continue
        names = ATOM14_NAMES[rn]
        slot = {nm: s for s, nm in enumerate(names) if nm}
        group_slots = [slot[a] for p in pairs for a in p]
        if not all(mask[i, s] for s in group_slots):
            continue
        orig = [X[i, s].copy() for s in group_slots]
        # flipped: swap coordinates within each pair
        swap = []
        for a, b in pairs:
            swap.extend([X[i, slot[b]].copy(), X[i, slot[a]].copy()])

        pos_orig = {nm: X[i, s] for nm, s in slot.items() if mask[i, s]}
        pos_swap = dict(pos_orig)
        for (a, b) in pairs:
            pos_swap[a], pos_swap[b] = pos_orig[b], pos_orig[a]
        if (cost(i, rn, group_slots, swap, pos_swap) + 1e-9
                < cost(i, rn, group_slots, orig, pos_orig)):
            for s, pnew in zip(group_slots, swap):
                X[i, s] = pnew
                fi = int(flat_index[i, s])
                if fi >= 0:
                    move_atom(fi, pnew)   # later residues see this flip
            flipped += 1

    return dataclasses.replace(prot, atom_positions=X), flipped


def disulfide_cysteines(prot) -> set:
    """Residue indices of half-cystines: CYS whose SG lies within 2.5 A of
    another CYS SG. Reduce never protonates disulfide-bonded SG (the
    hydrogen is displaced by the S-S bond); placing a phantom HG there
    inflates the clashscore denominator and can register overlaps against
    the partner residue that MolProbity would never report."""
    X = np.asarray(prot.atom_positions, np.float64)
    mask = np.asarray(prot.atom_mask).astype(bool)
    sg_slot = ATOM14_NAMES["CYS"].index("SG")
    cys = [i for i, aa in enumerate(prot.aaindex)
           if aa < len(RESTYPES) and RESTYPES[aa] == "C" and mask[i, sg_slot]]
    out = set()
    for ii, a in enumerate(cys):
        for b in cys[ii + 1:]:
            if np.linalg.norm(X[a, sg_slot] - X[b, sg_slot]) < 2.5:
                out.add(a)
                out.add(b)
    return out


def _place_hydrogens(prot):
    """Ideal-H placement core (geometry only, no optimization): returns raw
    lists ``(pos, pres, pslot, polar, rotors)``; ``rotors`` holds every
    rotor-group emission ``(first_H_index, n_h, x, parent, dref, blen,
    symmetric)``. Shared by :func:`add_hydrogens` and
    :func:`static_hydrogen_probes` (which must NOT route through the public
    entry point — callers/tests may wrap it)."""
    X = np.asarray(prot.atom_positions, np.float64)
    mask = np.asarray(prot.atom_mask).astype(bool)
    L = X.shape[0]
    resnames = residue_names(prot)

    pos, pres, pslot, polar = [], [], [], []
    rotors = []  # (first_H_index, n_h, x, parent, dref, blen, symmetric)
    ss_cys = disulfide_cysteines(prot)  # no HG on half-cystines (Reduce)

    def emit(i, slot_names, heavy, hs):
        s = slot_names.index(heavy)
        for h in hs:
            pos.append(h)
            pres.append(i)
            pslot.append(s)
            polar.append(heavy[0] in "NOS")

    for i in range(L):
        rn = resnames[i]
        if rn == "UNK":
            continue
        names = ATOM14_NAMES[rn]
        coords = {}
        for s, nm in enumerate(names):
            if nm and mask[i, s]:
                coords[nm] = X[i, s]
        if "CA" not in coords or "N" not in coords or "C" not in coords:
            continue

        blen_c = H_BOND_LENGTH["C"]
        # backbone amide H / N-terminal NH3+
        first_in_chain = i == 0 or prot.chain_id[i] != prot.chain_id[i - 1] or (
            not mask[i - 1, 2]) or np.linalg.norm(X[i, 0] - X[i - 1, 2]) > 2.0
        if rn != "PRO":
            if first_in_chain:
                rotors.append((len(pos), 3, coords["N"], coords["CA"], coords["C"],
                               H_BOND_LENGTH["N"], True))
                emit(i, names, "N", _rotor(coords["N"], coords["CA"], coords["C"],
                                           H_BOND_LENGTH["N"], 3))
            else:
                emit(i, names, "N", _sp2_bisector(coords["N"], coords["CA"],
                                                  X[i - 1, 2], H_BOND_LENGTH["N"]))
        # CA hydrogens
        if rn == "GLY":
            emit(i, names, "CA", _tetra_two(coords["CA"], coords["N"], coords["C"], blen_c))
        elif "CB" in coords:
            emit(i, names, "CA",
                 _tetra_one(coords["CA"], coords["N"], coords["C"], coords["CB"], blen_c))

        for heavy, n_h, geom, refs in H_SPEC.get(rn, []):
            if heavy not in coords or any(r not in coords for r in refs):
                continue
            if heavy == "SG" and i in ss_cys:
                continue  # disulfide-bonded SG carries no hydrogen
            blen = H_BOND_LENGTH[heavy[0]]
            x = coords[heavy]
            if geom == "t1":
                hs = _tetra_one(x, *(coords[r] for r in refs), blen)
            elif geom == "t2":
                hs = _tetra_two(x, *(coords[r] for r in refs), blen)
            elif geom == "sp2b":
                hs = _sp2_bisector(x, *(coords[r] for r in refs), blen)
            elif geom == "sp2p":
                hs = _sp2_pair(x, *(coords[r] for r in refs), blen)
            else:  # rot
                rotors.append((len(pos), n_h, x, coords[refs[0]], coords[refs[1]],
                               blen, n_h == 3))
                hs = _rotor(x, coords[refs[0]], coords[refs[1]], blen, n_h)
            emit(i, names, heavy, hs)

    return pos, pres, pslot, polar, rotors


def add_hydrogens(prot, optimize_rotors: bool = False, graph=None,
                  rotor_phase_overrides=None, static_h=None) -> dict:
    """Place ideal hydrogens on a parsed Protein.

    Returns dict with:
      positions [n_H, 3], parent_res [n_H], parent_slot [n_H] (atom14 slot
      of the bonded heavy atom), polar [n_H] bool (bonded to N/O/S),
      rotor_h [n_H] bool (H an orientation search may move).
    Residues missing a geometric reference atom (disordered side chains)
    silently skip the affected hydrogens, as Reduce does.

    ``optimize_rotors=True`` reproduces Reduce's rotatable-hydrogen search:
    each rotor group (methyls, OH/SH, NH3+) is spun over candidate phases
    and the phase minimizing steric overlap against the environment
    (heavy atoms + static hydrogens; bonded/1-3/1-4 and H-bondable
    contacts excluded).

    ``rotor_phase_overrides`` maps ``(res_index, heavy_slot) -> phase`` for
    rotors whose phase was already decided jointly (see
    :mod:`packppi_torch.structure.hbond_networks`); those skip the greedy
    search and are placed at the given phase. ``static_h`` takes a
    precomputed :func:`static_hydrogen_probes` result (recomputed here
    otherwise when optimizing).
    """
    pos, pres, pslot, polar, rotors = _place_hydrogens(prot)

    # every rotor emission, BEFORE override pinning filters the list (the
    # returned rotor_h mask must cover pinned rotors too)
    rotor_spans = [(r[0], r[1]) for r in rotors]

    if rotor_phase_overrides:
        pinned = []
        for r in rotors:
            first, n_h, x, parent_xyz, dref, blen, symmetric = r
            k = (int(pres[first]), int(pslot[first]))
            if k in rotor_phase_overrides:
                hs = _rotor_phases(x, parent_xyz, dref, blen, n_h,
                                   [rotor_phase_overrides[k]])[0]
                for j in range(n_h):
                    pos[first + j] = hs[j]
            else:
                pinned.append(r)
        rotors = pinned

    if optimize_rotors and rotors:
        _optimize_rotor_phases(prot, pos, pres, pslot, polar, rotors,
                               graph=graph, static_h=static_h)

    rotor_h = np.zeros(len(pos), bool)
    for first, n_h in rotor_spans:
        rotor_h[first:first + n_h] = True
    return {
        "positions": np.asarray(pos, np.float64).reshape(-1, 3),
        "parent_res": np.asarray(pres, np.int64),
        "parent_slot": np.asarray(pslot, np.int64),
        "polar": np.asarray(polar, bool),
        "rotor_h": rotor_h,  # H whose position an orientation search may move
    }


def static_hydrogen_probes(prot, flat_index=None):
    """Hydrogens no orientation search can move: every ideal H except rotor
    hydrogens (OH/SH/NH3+/methyl phases) and hydrogens on flip-group atoms
    (ASN/GLN/HIS terminal groups — regenerated per flip state).

    These are Reduce's FIXED donors/contacts: backbone amide H, ARG/TRP NH,
    CH hydrogens. The orientation scorers (greedy flips, greedy rotors,
    joint networks) add them to their environments so, e.g., a flip whose
    two states are clash-equivalent resolves toward the one whose acceptor
    receives an H-bond from a fixed backbone NH — previously only the donor
    HEAVY atom was visible and the contact scored as a small penalty.

    Returns dict: positions [m,3], radius [m], polar [m], res [m],
    parent_flat [m] (flat heavy index from ``flat_index``, -1 if absent —
    used for Probe's bonded-contact exclusions).
    """
    from packppi_torch.utils.metrics import PROBE_H_POLAR_RADIUS, PROBE_H_RADIUS

    h_pos, h_res, h_slot, h_polar, rotors = _place_hydrogens(prot)
    rotor_h = np.zeros(len(h_pos), bool)
    for first, n_h, *_ in rotors:
        rotor_h[first:first + n_h] = True
    hyd = {"positions": np.asarray(h_pos, np.float64).reshape(-1, 3),
           "parent_res": np.asarray(h_res, np.int64),
           "parent_slot": np.asarray(h_slot, np.int64),
           "polar": np.asarray(h_polar, bool)}
    resnames = residue_names(prot)
    flip_atoms = {rn: {a for p in FLIP_GROUPS[rn] for a in p}
                  for rn in FLIP_GROUPS}
    # a residue's flip-group H only move if the flip is actually MOVABLE
    # (both atoms of every pair resolved — the same condition the flip
    # optimizers use); an ASN with OD1 unresolved still places its ND2 H,
    # nothing will ever move them, so they are static donors
    mask = np.asarray(prot.atom_mask).astype(bool)

    def _flip_movable(r, rn):
        names = ATOM14_NAMES[rn]
        slot = {nm: si for si, nm in enumerate(names) if nm}
        return all(a in slot and b in slot and mask[r, slot[a]] and mask[r, slot[b]]
                   for a, b in FLIP_GROUPS[rn])

    keep = ~rotor_h
    movable_cache: dict = {}
    for k, (r, s) in enumerate(zip(hyd["parent_res"], hyd["parent_slot"])):
        rn = resnames[r]
        if rn in flip_atoms and ATOM14_NAMES[rn][s] in flip_atoms[rn]:
            if r not in movable_cache:
                movable_cache[r] = _flip_movable(r, rn)
            if movable_cache[r]:
                keep[k] = False
    res = hyd["parent_res"][keep]
    slots = hyd["parent_slot"][keep]
    if flat_index is None:
        parent_flat = np.full(len(res), -1, np.int64)
    else:
        parent_flat = np.asarray([int(flat_index[r, s])
                                  for r, s in zip(res, slots)], np.int64)
    polar = hyd["polar"][keep]
    return {
        "positions": hyd["positions"][keep],
        "radius": np.where(polar, PROBE_H_POLAR_RADIUS, PROBE_H_RADIUS),
        "polar": polar,
        "res": res,
        "parent_flat": parent_flat,
    }


def scoring_environment(prot, graph, static_h=None):
    """Flat scoring-environment arrays shared by all three orientation
    scorers: heavy atoms first, then static hydrogens (see
    :func:`static_hydrogen_probes`). Returns a dict with ``coords``,
    ``radii``, ``acceptor``, ``polar_h``, ``res`` (owning residue),
    ``parent`` (flat heavy index: identity for heavies, bonded parent for
    H — Probe bond-distance exclusions route through it), ``is_h``, and
    ``n_heavy``. One definition — the per-scorer variation is only which
    columns each uses."""
    from packppi_torch.utils.metrics import PROBE_RADII

    g_coords, g_names, g_res, flat_index, _sep = graph
    resnames = residue_names(prot)
    sh = static_h if static_h is not None else \
        static_hydrogen_probes(prot, flat_index)
    n_heavy = len(g_names)
    coords = np.concatenate([np.asarray(g_coords, np.float64).reshape(-1, 3),
                             sh["positions"]], 0)
    return {
        "coords": coords,
        "radii": np.concatenate([
            [PROBE_RADII.get(nm[0], 1.7) for nm in g_names], sh["radius"]]),
        "acceptor": np.concatenate([
            np.asarray([is_hbond_acceptor(resnames[r], nm)
                        for nm, r in zip(g_names, g_res)], bool),
            np.zeros(len(sh["res"]), bool)]),
        "polar_h": np.concatenate([np.zeros(n_heavy, bool), sh["polar"]]),
        "res": np.concatenate([np.asarray(g_res), sh["res"]]),
        "parent": np.concatenate([np.arange(n_heavy, dtype=np.int64),
                                  sh["parent_flat"]]),
        "is_h": np.arange(len(coords)) >= n_heavy,
        "n_heavy": n_heavy,
    }


def _optimize_rotor_phases(prot, pos, pres, pslot, polar, rotors,
                           n_phases: int = 12, cutoff: float = 4.0,
                           graph=None, static_h=None):
    """Reduce-style rotatable-H search: spin each rotor group and keep the
    phase with the least vdW interpenetration against nearby heavy atoms.

    Exclusions mirror Probe's contact rules: heavy atoms <= 2 bonds from
    the rotor's parent (the H is then <= 3 bonds away) never count, and
    polar rotor H vs H-bond-acceptor contacts are neutral (they would be
    scored as H-bonds, not clashes).
    """
    from packppi_torch.utils.metrics import (
        PROBE_H_POLAR_RADIUS, PROBE_H_RADIUS, PROBE_RADII)

    graph = graph or heavy_graph(prot)
    _gc, names, res_of, flat_index, sep = graph
    # environment = heavy atoms + STATIC hydrogens: env H are clash targets
    # like any atom — a rotor must not be steered into an H...H collision
    # with a backbone amide H it previously could not see
    env = scoring_environment(prot, graph, static_h)
    coords, radii, acceptor = env["coords"], env["radii"], env["acceptor"]
    env_parent, env_is_h = env["parent"], env["is_h"]
    n_heavy = env["n_heavy"]

    # KD-tree over the environment, all rotor neighborhoods in one query
    from scipy.spatial import cKDTree

    tree = cKDTree(coords)
    rotor_x = np.asarray([r[2] for r in rotors], np.float64).reshape(-1, 3)
    # query radius covers the H's reach: the phase sweep places H up to
    # blen from the parent, so atoms at cutoff of any H position sit up to
    # cutoff + blen from the query center
    reach = cutoff + np.asarray([r[5] for r in rotors], np.float64)
    neighborhoods = tree.query_ball_point(rotor_x, reach)

    sep_keys, sep_vals = encode_bond_sep(sep, n_heavy)

    for (first, n_h, x, parent_xyz, dref, blen, symmetric), cand in zip(rotors, neighborhoods):
        i = pres[first]
        s = pslot[first]
        parent_flat = int(flat_index[i, s])
        if parent_flat < 0 or not cand:
            continue
        is_polar = polar[first]
        h_rad = PROBE_H_POLAR_RADIUS if is_polar else PROBE_H_RADIUS

        # bonded-contact exclusion via each env atom's PARENT heavy index:
        # rotor H is 1 bond from its parent, env H 1 bond from theirs, so a
        # heavy env atom within 2 parent-bonds (H-heavy distance <= 3) or an
        # env H within 1 (H-H distance <= 3) never scores — Probe's >=4 rule
        cand = np.asarray(cand, np.int64)
        cp = env_parent[cand]
        bsep = lookup_bond_sep(sep_keys, sep_vals,
                               np.minimum(cp, parent_flat),
                               np.maximum(cp, parent_flat), n_heavy)
        keep = cand[np.where(env_is_h[cand], bsep > 1, bsep > 2)
                    & (cp != parent_flat)]
        if len(keep) == 0:
            continue
        kc = coords[keep]
        kr = radii[keep]

        span = 2 * np.pi / 3 if symmetric else 2 * np.pi
        phases = np.linspace(0, span, n_phases, endpoint=False)
        hs = _rotor_phases(x, parent_xyz, dref, blen, n_h, phases)  # [P, n_h, 3]
        dist = np.linalg.norm(kc[None, None] - hs[:, :, None], axis=-1)
        overlap = np.clip((kr + h_rad) - dist, 0, None)             # [P, n_h, K]
        spike = probe_spike_measure(h_rad, kr, dist)
        reward = 0.0
        if is_polar:
            # polar-H/acceptor overlap below the waiver cap scores as an
            # H-bond: rewarded (so the OH/SH/NH3+ rotor points INTO
            # hydrogen bonds), zeroed from the clash terms; beyond the cap
            # it counts as a clash again (HBOND_REWARD_WEIGHT note above)
            hb = acceptor[keep][None, None] & (overlap < HBOND_OVERLAP_CAP)
            reward = (HBOND_REWARD_WEIGHT
                      * np.where(hb, spike, 0.0).sum(axis=(1, 2)))
            overlap = np.where(hb, 0.0, overlap)
            spike = np.where(hb, 0.0, spike)
        costs = (1000.0 * (overlap >= SERIOUS_OVERLAP).sum(axis=(1, 2))
                 + spike.sum(axis=(1, 2)) - reward)
        # first phase wins ties (improvement must exceed 1e-12, phase 0 default)
        best = 0
        for j in range(1, n_phases):
            if costs[j] < costs[best] - 1e-12:
                best = j
        if best != 0:
            for k in range(n_h):
                pos[first + k] = hs[best, k]
