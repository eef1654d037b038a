"""Protein-protein interface detection (host-side numpy).

A residue is an interface residue if any of its heavy atoms lies within
``radius`` (default 10 A) of an atom from a different chain: the reference's
residue-level neighbour-search contract (reference: src/utils/interface.py:
11-55, via BioPython NeighborSearch), computed as chunked dense distance
checks on the atom14 arrays. Metric-time code: it never touches a device.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from packppi_torch.chem import RESTYPE_1TO3, RESTYPES
from packppi_torch.structure.protein import Protein


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
