"""Protein structure container and PDB I/O.

A fixed-column PDB reader/writer producing the atom14 layout directly. The
reader runs the native C++ parser (``packppi_torch.native``, float32
coordinates, as the JAX package's CLIs parse them) where it is built, and
the pure-Python one below otherwise or with ``PACKPPI_NATIVE=0``; both keep
this behavioural contract:

* ``ATOM`` and ``HETATM`` records are read; waters dropped; optional
  MSE->MET; non-standard residues skipped;
* chains visited in sorted id order, residues in ascending residue-number
  order within each chain;
* a global insertion-code offset shifts residue numbering after any residue
  carrying an insertion code;
* duplicate residue numbers within a chain are bumped to the next free index;
* altLoc conformers resolved to the highest-occupancy atom (first wins ties).
"""
from __future__ import annotations

import dataclasses
import gzip
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np

from packppi_torch.chem import (ATOM14_NAMES, ATOM37_TYPES, NUM_ATOM14,
                                RESTYPE_1TO3, RESTYPE_3TO1, RESTYPE_ORDER,
                                RESTYPES)
from packppi_torch.utils.trace import span


@dataclasses.dataclass(frozen=True)
class Protein:
    """Atom14 protein structure."""

    atom_positions: np.ndarray  # [num_res, 14, 3]
    aaindex: np.ndarray         # [num_res] int, 0..20 (20 = unknown)
    atom_mask: np.ndarray       # [num_res, 14]
    residue_index: np.ndarray   # [num_res] PDB numbering (+ insertion offsets)
    chain_id: np.ndarray        # [num_res] chain id strings
    b_factors: np.ndarray       # [num_res, 14]


class _ResidueRecord:
    __slots__ = ("resname", "resseq", "icode", "atoms")

    def __init__(self, resname: str, resseq: int, icode: str):
        self.resname = resname
        self.resseq = resseq
        self.icode = icode
        self.atoms: dict[str, tuple[float, float, float, float, float]] = {}


def _parse_atom_records(pdb_str: str, model_idx: int = 0):
    """Group ATOM/HETATM records into per-chain residue records. HETATM is
    read because modified residues such as selenomethionine are deposited
    as HETATM; waters and ligands are dropped by the caller."""
    chains: dict[str, dict[tuple[int, str], _ResidueRecord]] = {}
    model = 0
    seen_model_record = False
    for line in pdb_str.splitlines():
        rec = line[:6]
        if rec.startswith("MODEL"):
            if seen_model_record:
                model += 1
            seen_model_record = True
            continue
        if rec.startswith("ENDMDL"):
            continue
        if model != model_idx or not (rec.startswith("ATOM") or rec == "HETATM"):
            continue
        name = line[12:16].strip()
        resname = line[17:20].strip()
        chain = line[21]
        try:
            resseq = int(line[22:26])
        except ValueError:
            continue
        icode = line[26]
        x = float(line[30:38]); y = float(line[38:46]); z = float(line[46:54])
        try:
            occ = float(line[54:60])
        except ValueError:
            occ = 1.0
        try:
            bfac = float(line[60:66])
        except ValueError:
            bfac = 0.0

        key = (resseq, icode)
        res = chains.setdefault(chain, {}).setdefault(key, _ResidueRecord(resname, resseq, icode))
        prev = res.atoms.get(name)
        if prev is None or occ > prev[4]:  # dominant altLoc conformer wins
            res.atoms[name] = (x, y, z, bfac, occ)
    return chains


def from_pdb_string(pdb_str: str, model_idx: int = 0,
                    chain_id: Optional[Union[str, Sequence[str]]] = None,
                    discard_water: bool = True, mse_to_met: bool = False,
                    ignore_non_std: bool = True) -> Protein:
    """Parse a PDB string into an atom14 ``Protein``: the native parser's
    arrays when its library is available, else ``from_pdb_string_python``'s.
    """
    from packppi_torch import native

    parsed = native.parse_pdb_native(pdb_str, model_idx, chain_id, discard_water, mse_to_met,
                                     ignore_non_std)
    if parsed is not None:
        return Protein(**parsed)
    return from_pdb_string_python(pdb_str, model_idx, chain_id, discard_water, mse_to_met,
                                  ignore_non_std)


def from_pdb_string_python(pdb_str: str, model_idx: int = 0,
                           chain_id: Optional[Union[str, Sequence[str]]] = None,
                           discard_water: bool = True, mse_to_met: bool = False,
                           ignore_non_std: bool = True) -> Protein:
    """The pure-Python parser (float64 coordinates as written in the file):
    the behavioural specification the native parser follows."""
    if isinstance(chain_id, str):
        chain_id = [chain_id]
    chains = _parse_atom_records(pdb_str, model_idx)

    positions, aaindex, mask, res_index, chain_ids, bfactors = [], [], [], [], [], []
    insertion_offset = 0
    for cid in sorted(chains):
        if chain_id is not None and cid not in chain_id:
            continue
        residues = sorted(chains[cid].values(), key=lambda r: r.resseq)
        for res in residues:
            resname = res.resname
            if discard_water and resname == "HOH":
                continue
            atoms = res.atoms
            if mse_to_met and resname == "MSE":
                resname = "MET"
                atoms = {("SD" if n == "SE" else n): v for n, v in atoms.items()}
            short = RESTYPE_3TO1.get(resname, "X")
            if ignore_non_std and short == "X":
                continue
            if res.icode != " ":
                insertion_offset += 1

            a14 = ATOM14_NAMES[RESTYPE_1TO3.get(short, "UNK")] if short != "X" else ATOM14_NAMES["UNK"]
            pos = np.full((NUM_ATOM14, 3), np.nan)
            m = np.zeros(NUM_ATOM14)
            b = np.zeros(NUM_ATOM14)
            for name, (x, y, z, bfac, _occ) in atoms.items():
                if name in a14:
                    i = a14.index(name)
                    pos[i] = (x, y, z)
                    m[i] = 1.0
                    b[i] = bfac
            if m.sum() < 0.5:
                continue

            positions.append(pos)
            aaindex.append(RESTYPE_ORDER.get(short, len(RESTYPES)))
            mask.append(m)
            res_index.append(res.resseq + insertion_offset)
            chain_ids.append(cid)
            bfactors.append(b)

    # bump duplicate residue numbers within a chain to the next free index
    used: dict[str, set[int]] = {}
    final_index = []
    for cid, idx in zip(chain_ids, res_index):
        taken = used.setdefault(cid, set())
        while idx in taken:
            idx += 1
        taken.add(idx)
        final_index.append(idx)

    return Protein(
        atom_positions=np.array(positions),
        aaindex=np.array(aaindex),
        atom_mask=np.array(mask),
        residue_index=np.array(final_index),
        chain_id=np.array(chain_ids),
        b_factors=np.array(bfactors),
    )


def from_pdb_file(pdb_file: Union[str, Path], **kwargs) -> Protein:
    pdb_file = str(pdb_file)
    opener = gzip.open if pdb_file.endswith(".pdb.gz") else open
    with opener(pdb_file, "rt") as f:
        return from_pdb_string(f.read(), **kwargs)


def _ter_line(serial: int, resname: str, chain: str, resseq) -> str:
    return f"{'TER':<6}{serial:>5}      {resname:>3} {chain:>1}{resseq:>4}"


def to_pdb(prot: Protein, keep_chains: Optional[list] = None) -> str:
    """Serialize to PDB text (atom14 or atom37 position layouts)."""
    with span("structure.to_pdb"):
        return _to_pdb(prot, keep_chains)


def _to_pdb(prot: Protein, keep_chains: Optional[list]) -> str:
    atom_mask, aaindex = prot.atom_mask, prot.aaindex
    positions, res_idx = prot.atom_positions, prot.residue_index
    chain_id, bfac = prot.chain_id, prot.b_factors

    if np.any(aaindex > len(RESTYPES)):
        raise ValueError("invalid residue types")

    if keep_chains is not None:
        sel = np.isin(chain_id, keep_chains)
        atom_mask, aaindex, positions = atom_mask[sel], aaindex[sel], positions[sel]
        res_idx, chain_id, bfac = res_idx[sel], chain_id[sel], bfac[sel]

    def res3(i):
        one = (RESTYPES + ["X"])[aaindex[i]]
        return RESTYPE_1TO3.get(one, "UNK")

    n_atoms = positions.shape[-2]
    lines = ["MODEL     1"]
    serial = 1
    prev_chain = chain_id[0]
    for i in range(len(aaindex)):
        if chain_id[i] != prev_chain:
            lines.append(_ter_line(serial, res3(i - 1), chain_id[i - 1], res_idx[i - 1]))
            serial += 1
            prev_chain = chain_id[i]

        if n_atoms == NUM_ATOM14:
            names = ATOM14_NAMES[res3(i)]
        elif n_atoms == len(ATOM37_TYPES):
            names = ATOM37_TYPES
        else:
            raise ValueError("positions must be atom14 or atom37")

        for name, pos, m, b in zip(names, positions[i], atom_mask[i], bfac[i]):
            if m < 0.5:
                continue
            pad_name = name if len(name) == 4 else f" {name}"
            lines.append(
                f"{'ATOM':<6}{serial:>5} {pad_name:<4}{'':>1}{res3(i):>3} "
                f"{chain_id[i]:>1}{res_idx[i]:>4}{'':>1}   "
                f"{pos[0]:>8.3f}{pos[1]:>8.3f}{pos[2]:>8.3f}"
                f"{1.0:>6.2f}{b:>6.2f}          {name[0]:>2}{'':>2}")
            serial += 1

    lines.append(_ter_line(serial, res3(len(aaindex) - 1), chain_id[-1], res_idx[-1]))
    lines.extend(["ENDMDL", "END"])
    return "\n".join(line.ljust(80) for line in lines) + "\n"
