"""packppi-torch-prox: standalone proximal clash optimization (PackPPI-Prox).

Takes a structure WITH side chains, optimizes the chi angles of its
clash-heavy residues, and writes the relaxed ``structure.pdb`` and
``metrics.json`` (``accepted``, ``optimize_seconds``, ``objective_initial``,
``objective_final``, ``objective_convention``) to ``--outdir``. Runs on the
CUDA device unless ``--device cpu`` is given.

    python -m packppi_torch.cli.prox --input complex.pdb --outdir out \\
        [--num_steps 50] [--lamda 1.0] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch


def build_parser():
    p = argparse.ArgumentParser(description="PackPPI proximal clash optimization (PyTorch/CUDA)")
    p.add_argument("--input", required=True, help="input PDB with side chains")
    p.add_argument("--outdir", default="packppi_out")
    p.add_argument("--num_steps", type=int, default=50)
    p.add_argument("--lamda", type=float, default=1.0)
    p.add_argument("--violation_tolerance_factor", type=float, default=12.0)
    p.add_argument("--clash_overlap_tolerance", type=float, default=0.5)
    p.add_argument("--no_strict_parity", action="store_true",
                   help="when the optimization is REJECTED (objective did not "
                        "decrease), write the raw input coordinates unchanged "
                        "instead of the reference's re-idealized rebuild from "
                        "the input chis")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; without a GPU, cpu must be asked for")
    return p


def run(args) -> dict:
    from packppi_torch.cli.pack import merge_output_structure
    from packppi_torch.data import stack_batch
    from packppi_torch.device import resolve_device
    from packppi_torch.geometry import atom14_coords_from_torsions
    from packppi_torch.sampling import proximal_optimize
    from packppi_torch.structure import featurize, from_pdb_file, to_pdb

    device = resolve_device(args.device)
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)

    prot = from_pdb_file(args.input, mse_to_met=True)
    feats = featurize(prot)
    if feats["SC_D_mask"].sum() == 0:
        raise SystemExit("input structure has no side-chain chi angles to optimize")
    if args.num_steps < 1:
        raise SystemExit("--num_steps must be >= 1")
    batch = stack_batch([feats], device)

    t0 = time.perf_counter()
    res = proximal_optimize(batch, batch.SC_D, args.violation_tolerance_factor,
                            args.clash_overlap_tolerance, args.lamda, args.num_steps)
    losses = res.losses.tolist()               # the one read-back; waits for the device
    t_opt = time.perf_counter() - t0

    accepted = losses[-1] < losses[0]
    if not accepted and args.no_strict_parity:
        print("objective did not decrease; emitting the raw input structure "
              "unchanged (--no_strict_parity)")
        out_prot = prot
    else:
        if not accepted:
            # the written structure is still REBUILT at ideal bond geometry
            # from the input chis, as the reference does
            print("objective did not decrease; keeping input chi angles "
                  "(coordinates re-idealized, as in the reference)")
        sc_final = res.SC_D if accepted else batch.SC_D
        with torch.no_grad():
            coords = atom14_coords_from_torsions(batch.X, batch.residue_type, batch.BB_D,
                                                 sc_final)
        out_prot = merge_output_structure(prot, feats, batch.atom_mask.cpu().numpy(),
                                          coords.cpu().numpy(), len(feats["residue_type"]))
    out_pdb = outdir / "structure.pdb"
    out_pdb.write_text(to_pdb(out_prot))
    print(f"wrote {out_pdb}  ({t_opt:.2f}s on {device}, "
          f"objective {losses[0]:.4f} -> {losses[-1]:.4f})")

    result = {
        "accepted": accepted,
        "optimize_seconds": t_opt,
        # losses are recorded BEFORE each Adam step: _final is the objective
        # entering the last step, not that of the returned chis
        "objective_initial": losses[0],
        "objective_final": losses[-1],
        "objective_convention": "pre-step (reference parity)",
    }
    (outdir / "metrics.json").write_text(json.dumps(result, indent=1))
    return result


def main():
    run(build_parser().parse_args())


if __name__ == "__main__":
    main()
