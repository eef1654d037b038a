"""SKEMPI-v2 mutation data for PackPPI-AP.

Entry loading (ddG = RT ln(K_mut / K_wt) at 298.15 K), complex-grouped
cross-validation folds, mutation application with a wild-type check, the
wild-type + mutant feature twins and their padded batch, and esm mode's
items (ESM-2 tokens of the wild type and the mutant) and their batch, each
distinct sequence once. Semantics are the
reference's, quirks included: the mutant chi mask is measured on the
wild-type coordinates with the mutant's atom indexing, and the mutant chis
are zeroed at the mutated sites.
"""
from __future__ import annotations

import csv
import math
import random
from pathlib import Path
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from packppi_torch.chem import ATOM14_NAMES, CHEM, RESTYPE_1TO3, RESTYPES
from packppi_torch.data.batch import ProteinBatch, bucket_length, pad_features
from packppi_torch.structure.featurize import (chain_indices_of, featurize, residue_mask_of,
                                               sc_dihedrals)
from packppi_torch.structure.protein import Protein
from packppi_torch.utils.logging import get_logger

log = get_logger(__name__)

RT_KCAL = (8.314 / 4184) * (273.15 + 25.0)


def parse_mutation(name: str) -> dict:
    """'KI15G' -> wild type K, chain I, residue 15, mutant G."""
    return {"wt": name[0], "chain": name[1], "resseq": int(name[2:-1]), "mt": name[-1],
            "icode": " ", "name": name}


def _affinity(text: str) -> float:
    try:
        return float(text)
    except ValueError:
        return math.nan


def load_skempi_entries(data_dir: Union[str, Path], pdb_dirname: str,
                        meta_filename: str = "skempi_v2.csv",
                        block_list: Optional[list] = None) -> list[dict]:
    """Parse the ';'-separated ``skempi_v2.csv`` into one entry per row with
    its ddG in kcal/mol; rows whose affinities are missing or whose PDB file
    is absent are skipped. ``id`` is the row's position in the file."""
    block_list = block_list or []
    with open(Path(data_dir) / meta_filename, newline="") as f:
        rows = list(csv.DictReader(f, delimiter=";"))
    entries = []
    for i, row in enumerate(rows):
        with np.errstate(divide="ignore", invalid="ignore"):
            ddg = (RT_KCAL * np.log(_affinity(row["Affinity_mut_parsed"]))
                   - RT_KCAL * np.log(_affinity(row["Affinity_wt_parsed"])))
        pdbcode, group1, group2 = row["#Pdb"].split("_")
        if pdbcode in block_list or not np.isfinite(ddg):
            continue
        mutstr = row["Mutation(s)_cleaned"]
        muts = [parse_mutation(m) for m in mutstr.split(",")]
        ligand, receptor = (group1, group2) if muts[0]["chain"] in group1 else (group2, group1)
        pdb_path = Path(data_dir) / pdb_dirname / f"{pdbcode.upper()}.pdb"
        if not pdb_path.exists():
            continue
        entries.append({
            "id": i, "complex": row["#Pdb"], "mutstr": mutstr, "num_muts": len(muts),
            "pdb_id": pdbcode, "group_ligand": list(ligand), "group_receptor": list(receptor),
            "mutations": muts, "ddG": float(ddg), "pdb_path": str(pdb_path)})
    return entries


def cv_split(entries: list[dict], num_folds: int = 3, fold_index: int = 0,
             seed: int = 42) -> dict[str, list[dict]]:
    """Complex-grouped cross-validation split (no complex spans folds): the
    sorted complex names shuffled by ``random.Random(seed)``, as the
    reference does."""
    by_complex: dict[str, list[dict]] = {}
    for e in entries:
        by_complex.setdefault(e["complex"], []).append(e)
    names = sorted(by_complex)
    random.Random(seed).shuffle(names)
    fold_size = math.ceil(len(names) / num_folds)
    folds = [names[k * fold_size:(k + 1) * fold_size] for k in range(num_folds)]
    val_names = folds.pop(fold_index)
    train_names = [n for f in folds for n in f]
    return {"train": [e for n in train_names for e in by_complex[n]],
            "valid": [e for n in val_names for e in by_complex[n]]}


def apply_mutations(protein: Protein, mutations: list[dict], strict: bool = True):
    """Mutant residue types and atom masks on the wild-type structure.

    Residues are matched on the parser's insertion-offset numbering (the
    reference matches the same shifted index). A residue that is not found,
    or whose type is not the mutation's declared wild type, raises
    ``ValueError`` in strict mode (a silent drop would keep the entry's ddG
    with no mutated site) and is skipped with a logged warning otherwise.
    """
    residue_type_mut = protein.aaindex.copy()
    atom_mask_mut = protein.atom_mask.copy()
    chains = np.asarray(protein.chain_id)

    for mut in mutations:
        if mut["chain"] not in chains or mut["mt"] not in RESTYPES:
            log.warning(f"ignoring mutation {mut['name']}: chain or type not applicable")
            continue
        sel = (chains == mut["chain"]) & (protein.residue_index == mut["resseq"])
        if not sel.any():
            msg = (f"mutation {mut['name']}: residue not found (chain {mut['chain']} "
                   f"resseq {mut['resseq']} after insertion-code offsets)")
            if strict:
                raise ValueError(msg)
            log.warning(f"ignoring {msg}")
            continue
        wt_found = RESTYPES[int(protein.aaindex[sel][0])]
        if wt_found != mut["wt"]:
            msg = f"mutation {mut['name']} inconsistent with structure wild-type {wt_found}"
            if strict:
                raise ValueError(msg)
            log.warning(msg)
            continue
        residue_type_mut[sel] = RESTYPES.index(mut["mt"])
        names = ATOM14_NAMES[RESTYPE_1TO3[mut["mt"]]]
        atom_mask_mut[sel] = np.array([1.0 if a else 0.0 for a in names], np.float32)
    return residue_type_mut, atom_mask_mut


def skempi_features(protein: Protein, mutations: list[dict], ddg: float = 0.0,
                    strict: bool = True) -> dict[str, np.ndarray]:
    """Wild-type features, their mutant twins, ``mut_mask`` and ``ddg``."""
    feats = featurize(protein)
    residue_type_mut, atom_mask_mut = apply_mutations(protein, mutations, strict)

    rm = feats["residue_mask"]
    mut_mask = (protein.aaindex != residue_type_mut).astype(np.int64) * rm.astype(np.int64)

    sc_d_mut = feats["SC_D"].copy()
    sc_sincos_mut = feats["SC_D_sincos"].copy()
    sel = mut_mask.astype(bool)
    sc_d_mut[sel] = 0.0
    sc_sincos_mut[sel] = 0.0
    # measured on the wild-type coordinates with the mutant's atom indexing
    _, sc_mask_mut = sc_dihedrals(protein.atom_positions, residue_type_mut)
    sc_mask_mut = sc_mask_mut * rm[:, None]
    pi_mut = CHEM.chi_pi_periodic[residue_type_mut].astype(bool)

    feats.update({
        "ddg": np.float32(ddg),
        "mut_mask": mut_mask,
        "residue_type_mut": (residue_type_mut * rm).astype(np.int64),
        "atom_mask_mut": np.nan_to_num(atom_mask_mut * rm[:, None]).astype(np.float32),
        "SC_D_mut": np.nan_to_num(sc_d_mut),
        "SC_D_sincos_mut": np.nan_to_num(sc_sincos_mut),
        "SC_D_mask_mut": sc_mask_mut,
        "chi_1pi_periodic_mask_mut": sc_mask_mut.astype(bool) & pi_mut,
        "chi_2pi_periodic_mask_mut": sc_mask_mut.astype(bool) & ~pi_mut,
    })
    return feats


_MUTANT_FIELDS = ("residue_type", "atom_mask", "SC_D", "SC_D_sincos", "SC_D_mask",
                  "chi_1pi_periodic_mask", "chi_2pi_periodic_mask")


class AffinityBatch(NamedTuple):
    """``ProteinBatch``'s fields, their mutant twins and the labels, as
    tensors on one device (integers int64, floats float32, masks of chi
    periodicity bool)."""

    X: torch.Tensor
    atom_mask: torch.Tensor
    residue_type: torch.Tensor
    residue_mask: torch.Tensor
    residue_index: torch.Tensor
    chain_indices: torch.Tensor
    BB_D: torch.Tensor
    BB_D_sincos: torch.Tensor
    BB_D_mask: torch.Tensor
    SC_D: torch.Tensor
    SC_D_sincos: torch.Tensor
    SC_D_mask: torch.Tensor
    chi_1pi_periodic_mask: torch.Tensor
    chi_2pi_periodic_mask: torch.Tensor
    residue_type_mut: torch.Tensor
    atom_mask_mut: torch.Tensor
    SC_D_mut: torch.Tensor
    SC_D_sincos_mut: torch.Tensor
    SC_D_mask_mut: torch.Tensor
    chi_1pi_periodic_mask_mut: torch.Tensor
    chi_2pi_periodic_mask_mut: torch.Tensor
    ddg: torch.Tensor       # [B]
    mut_mask: torch.Tensor  # [B, L]

    def wild(self) -> ProteinBatch:
        return ProteinBatch(**{f: getattr(self, f) for f in ProteinBatch._fields})

    def mutant(self) -> ProteinBatch:
        d = {f: getattr(self, f) for f in ProteinBatch._fields}
        d.update({f: getattr(self, f + "_mut") for f in _MUTANT_FIELDS})
        return ProteinBatch(**d)


def stack_affinity_batch(feats_list: list[dict], device: Union[str, torch.device],
                         target_len: Optional[int] = None) -> AffinityBatch:
    """Pad each feature dict to the common bucketed length (or
    ``target_len``), stack and move to ``device``."""
    max_len = max(len(f["residue_type"]) for f in feats_list)
    target = target_len if target_len is not None else bucket_length(max_len)
    padded = [pad_features({k: v for k, v in f.items() if k != "ddg"}, target)
              for f in feats_list]
    fields = {"ddg": torch.tensor([float(f["ddg"]) for f in feats_list], dtype=torch.float32,
                                  device=device)}
    for name in AffinityBatch._fields:
        if name == "ddg":
            continue
        arr = np.stack([p[name] for p in padded])
        if arr.dtype.kind in "iu":
            arr = arr.astype(np.int64)
        elif arr.dtype.kind == "f":
            arr = arr.astype(np.float32)
        fields[name] = torch.from_numpy(arr).to(device)
    return AffinityBatch(**fields)


def esm_item(protein: Protein, mutations: list[dict], ddg: float = 0.0,
             strict: bool = True) -> dict:
    """esm mode's input of one mutation, with no geometry: the ESM-2 tokens
    of the wild type (``wt_tokens``) and of the mutant (``mt_tokens``), each
    residue's token index (``token_rows``, ``data.esm.residue_tokens``),
    ``residue_type`` and ``ddg``. As the JAX package's ``cli.ddg --mode
    esm`` embeds them: the wild type's residue types and chain ids zeroed
    where the backbone is incomplete, as featurization zeroes them; the
    mutant's residue types as ``apply_mutations`` gives them."""
    from packppi_torch.data.esm import residue_tokens

    rm = residue_mask_of(protein.atom_positions.astype(np.float32)).astype(np.int64)
    chains = chain_indices_of(protein) * rm
    residue_type = protein.aaindex.astype(np.int64) * rm
    residue_type_mut, _ = apply_mutations(protein, mutations, strict)
    wt_tokens, rows = residue_tokens(residue_type, chains)
    mt_tokens, _ = residue_tokens(residue_type_mut, chains)
    return {"residue_type": residue_type, "wt_tokens": wt_tokens, "mt_tokens": mt_tokens,
            "token_rows": rows, "ddg": np.float32(ddg)}


class EsmBatch(NamedTuple):
    """esm mode's batch of B mutations padded to L residues, as tensors on
    one device: the token rows of one ESM-2 forward and where each
    mutation's residues lie in its output."""

    input_ids: torch.Tensor       # [R, T] int64: each distinct sequence of the batch once
    attention_mask: torch.Tensor  # [R, T] float32
    rows: torch.Tensor            # [2, B, L] int64: wild type, mutant; into R * T, R * T at padding
    row_mask: torch.Tensor        # [B, L] float32: 1.0 on the mutation's residues
    ddg: torch.Tensor             # [B]


def stack_esm_batch(items: list[dict], device: Union[str, torch.device]) -> EsmBatch:
    """``esm_item``s -> ``EsmBatch``: their distinct token sequences (a
    complex's wild type once, however many of its mutations the batch
    holds) padded to one length (``models.esm2.pad_tokens``), and the map
    from each mutation's residues to the forward's rows. The residues are
    padded to the batch's longest mutation, not to a bucket, as esm
    training pads them: the head pools over padded rows too (strict
    parity), so a mutation of a batch of one complex reads as it reads
    alone."""
    from packppi_torch.models.esm2 import pad_tokens

    L = max(len(it["token_rows"]) for it in items)
    distinct: dict = {}
    for it in items:
        for key in ("wt_tokens", "mt_tokens"):
            distinct.setdefault(it[key].tobytes(), (len(distinct), it[key]))
    ids, mask = pad_tokens([t for _, t in distinct.values()])
    T = ids.shape[1]
    rows = np.full((2, len(items), L), len(distinct) * T, np.int64)
    row_mask = np.zeros((len(items), L), np.float32)
    for b, it in enumerate(items):
        n = len(it["token_rows"])
        for side, key in enumerate(("wt_tokens", "mt_tokens")):
            rows[side, b, :n] = distinct[it[key].tobytes()][0] * T + it["token_rows"]
        row_mask[b, :n] = 1.0
    ddg = np.array([float(it["ddg"]) for it in items], np.float32)
    return EsmBatch(*(torch.from_numpy(a).to(device) for a in (ids, mask, rows, row_mask, ddg)))
