"""Protein-protein interface detection (host-side numpy).

A residue is an interface residue if any of its heavy atoms lies within
``radius`` (default 10 A) of an atom from a different chain: the reference's
residue-level neighbour-search contract (reference: src/utils/interface.py:
11-55, via BioPython NeighborSearch), computed as chunked dense distance
checks on the atom14 arrays. The second definition, ``interface_by_delta_sasa``
(reference: src/utils/interface.py:58-189, via freesasa), marks residues
whose relative accessibility drops when the complex forms, from per-atom
Shrake-Rupley SASA (``packppi_torch.native``, with a numpy fallback).
Metric-time code: it never touches a device.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from packppi_torch.chem import CHEM, RESTYPE_1TO3, RESTYPES
from packppi_torch.structure.protein import Protein

# Theoretical maximum ASA per residue (Tien et al. 2013), for relative SASA.
_MAX_ASA = {
    "ALA": 129.0, "ARG": 274.0, "ASN": 195.0, "ASP": 193.0, "CYS": 167.0,
    "GLN": 225.0, "GLU": 223.0, "GLY": 104.0, "HIS": 224.0, "ILE": 197.0,
    "LEU": 201.0, "LYS": 236.0, "MET": 224.0, "PHE": 240.0, "PRO": 159.0,
    "SER": 155.0, "THR": 172.0, "TRP": 285.0, "TYR": 263.0, "VAL": 174.0,
}


def interface_residue_mask(protein: Protein, radius: float = 10.0,
                           chunk: int = 2048) -> np.ndarray:
    """[num_res] float mask of residues contacting another chain.

    Returns all-zeros for single-chain structures.
    """
    chains = np.asarray(protein.chain_id)
    if len(np.unique(chains)) == 1:
        return np.zeros(len(chains), np.float32)

    mask = protein.atom_mask.astype(bool)                      # [L, 14]
    pos = np.nan_to_num(protein.atom_positions).astype(np.float32)

    flat_pos = pos[mask]                                       # [A, 3]
    flat_res = np.repeat(np.arange(len(chains)), mask.sum(-1)) # [A]
    flat_chain = chains[flat_res]

    out = np.zeros(len(chains), bool)
    r2 = radius * radius
    for start in range(0, len(flat_pos), chunk):
        sl = slice(start, start + chunk)
        d2 = ((flat_pos[sl, None, :] - flat_pos[None, :, :]) ** 2).sum(-1)
        cross = flat_chain[sl, None] != flat_chain[None, :]
        hit = ((d2 < r2) & cross).any(-1)
        np.logical_or.at(out, flat_res[sl], hit)
    return out.astype(np.float32)


def _sasa_per_atom(pos: np.ndarray, radii: np.ndarray, n_points: int = 100,
                   probe: float = 1.4) -> np.ndarray:
    """Per-atom SASA: the native Shrake-Rupley kernel, else the same
    golden-spiral algorithm in numpy (slower; float64)."""
    from packppi_torch import native

    out = native.sasa_native(pos, radii, n_points=n_points, probe=probe)
    if out is not None:
        return out
    golden = (1 + 5 ** 0.5) / 2
    i = np.arange(n_points)
    theta = 2 * np.pi * i / golden
    cz = 1 - 2 * (i + 0.5) / n_points
    r = np.sqrt(np.clip(1 - cz ** 2, 0, None))
    sphere = np.stack([r * np.cos(theta), r * np.sin(theta), cz], -1)

    out = np.zeros(len(pos))
    ri = radii + probe
    for a in range(len(pos)):
        pts = pos[a] + ri[a] * sphere
        d2 = ((pts[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
        d2[:, a] = np.inf
        buried = (d2 < (ri[None, :] ** 2)).any(-1)
        out[a] = 4 * np.pi * ri[a] ** 2 * (~buried).sum() / n_points
    return out


def residue_relative_sasa(protein: Protein, residue_subset: np.ndarray | None = None
                          ) -> np.ndarray:
    """[num_res] per-residue SASA over the theoretical maximum ASA.
    ``residue_subset``: a boolean mask of the residues that form the
    structure (e.g. one chain); the others get 0."""
    n = len(protein.aaindex)
    sel = np.ones(n, bool) if residue_subset is None else residue_subset.astype(bool)
    mask = protein.atom_mask.astype(bool) & sel[:, None]
    pos = np.nan_to_num(protein.atom_positions)[mask]
    radii = CHEM.vdw_radius_atom14[protein.aaindex][mask]
    res_of_atom = np.repeat(np.arange(n), mask.sum(-1))

    per_atom = _sasa_per_atom(pos.astype(np.float32), radii.astype(np.float32))
    total = np.zeros(n)
    np.add.at(total, res_of_atom, per_atom)
    max_asa = np.array([_MAX_ASA[RESTYPE_1TO3[RESTYPES[i]]] if i < 20 else 129.0
                        for i in protein.aaindex])
    return np.where(sel, total / max_asa, 0.0)


def interface_by_delta_sasa(protein: Protein, threshold: float = 0.0) -> np.ndarray:
    """[num_res] float32 mask of residues whose relative SASA drops by more
    than ``threshold`` in the complex against their chain alone; all zeros
    for one chain."""
    chains = np.asarray(protein.chain_id)
    uniq = np.unique(chains)
    if len(uniq) == 1:
        return np.zeros(len(chains), np.float32)
    complex_sasa = residue_relative_sasa(protein)
    out = np.zeros(len(chains), np.float32)
    for c in uniq:
        sel = chains == c
        delta = residue_relative_sasa(protein, sel) - complex_sasa
        out[sel & (delta > threshold)] = 1.0
    return out


def write_interface_file(mask: np.ndarray, protein: Protein, path: str) -> None:
    """Tab-separated interface listing: chain resid resname label."""
    lines = ["#chain\t#resid\t#resname\t#label_value"]
    for i in np.flatnonzero(mask):
        resname = RESTYPE_1TO3.get(RESTYPES[protein.aaindex[i]] if protein.aaindex[i] < 20 else "X", "UNK")
        lines.append(f"{protein.chain_id[i]}\t{protein.residue_index[i]}\t{resname}\t1")
    Path(path).write_text("\n".join(lines) + "\n")


def parse_interface_file(path: str) -> dict[str, list[int]]:
    """Inverse of write_interface_file: chain -> residue numbers."""
    out: dict[str, list[int]] = {}
    for line in Path(path).read_text().splitlines():
        if line.startswith("#") or not line.strip():
            continue
        chain, resid, *_ = line.split()
        out.setdefault(chain, []).append(int(resid))
    return out
