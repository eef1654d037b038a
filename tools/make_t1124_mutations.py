"""Write ``perfbench/data/t1124_mutations.csv``: 32 single-point mutations of
the CASP target T1124 (chains A and B) in SKEMPI-v2's format, 16 on each
chain, each at a residue with a complete backbone whose CA lies within
10 A of a CA of the other chain, each to another residue type, drawn once
with a fixed seed. T1124 has no measured affinities, so those columns are
empty. The file is data: the benchmark reads it and never redraws it.

    python tools/make_t1124_mutations.py [--seed 19] [--out perfbench/data/t1124_mutations.csv]
"""
from __future__ import annotations

import argparse
import csv
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
DATA = ROOT / "perfbench" / "data"
PER_CHAIN = 16
RADIUS = 10.0


def draw(seed: int) -> list:
    from packppi_torch.chem import RESTYPES
    from packppi_torch.structure import from_pdb_file
    from packppi_torch.structure.featurize import residue_mask_of

    prot = from_pdb_file(DATA / "t1124.pdb", mse_to_met=True)
    ca = prot.atom_positions[:, 1]
    complete = residue_mask_of(prot.atom_positions.astype(np.float32)) > 0
    chains = np.asarray(prot.chain_id)
    rng = np.random.default_rng(seed)
    out = []
    for c in sorted(set(chains.tolist())):
        mine, other = chains == c, (chains != c) & complete
        d = np.linalg.norm(ca[mine & complete][:, None] - ca[other][None], axis=-1).min(1)
        sites = np.flatnonzero(mine & complete)[d < RADIUS]
        for i in sorted(rng.choice(sites, PER_CHAIN, replace=False)):
            wt = RESTYPES[int(prot.aaindex[i])]
            mt = rng.choice([r for r in RESTYPES if r != wt])
            out.append(f"{wt}{c}{int(prot.residue_index[i])}{mt}")
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=19)
    p.add_argument("--out", default=str(DATA / "t1124_mutations.csv"))
    args = p.parse_args()
    with open(DATA / "skempi_v2.csv", newline="") as f:
        header = next(csv.reader(f, delimiter=";"))
    with open(args.out, "w", newline="") as f:
        w = csv.DictWriter(f, header, delimiter=";", lineterminator="\n")
        w.writeheader()
        for m in draw(args.seed):
            # T1124 has no insertion codes: the file's numbering is the parser's
            w.writerow({"#Pdb": "T1124_A_B", "Mutation(s)_PDB": m, "Mutation(s)_cleaned": m,
                        "Protein 1": "T1124 chain A", "Protein 2": "T1124 chain B"})


if __name__ == "__main__":
    main()
