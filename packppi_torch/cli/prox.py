"""packppi-torch-prox: standalone proximal clash optimization (PackPPI-Prox).

Takes a structure WITH side chains, optimizes the chi angles of its
clash-heavy residues, and writes the relaxed ``structure.pdb`` and
``metrics.json`` (``clashscore_before``, ``clashscore_after``,
``accepted``, ``optimize_seconds``, ``objective_initial``,
``objective_final``, ``objective_convention``) to ``--outdir``. A directory
as ``--input`` optimizes every PDB with side chains in it
(``run_directory``). Runs on the CUDA device unless ``--device cpu`` is
given.

    python -m packppi_torch.cli.prox --input complex.pdb|dir/ --outdir out \\
        [--num_steps 50] [--lamda 1.0] [--molprobity_loc BIN] [--exact_length] \\
        [--batch_size 1] [--no_clashscore] [--no_strict_parity] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from packppi_torch.cli._directory import merge_output_structure


def build_parser():
    p = argparse.ArgumentParser(description="PackPPI proximal clash optimization (PyTorch/CUDA)")
    p.add_argument("--input", required=True,
                   help="input PDB with side chains, or a directory of PDBs")
    p.add_argument("--outdir", default="packppi_out")
    p.add_argument("--num_steps", type=int, default=50)
    p.add_argument("--lamda", type=float, default=1.0)
    p.add_argument("--violation_tolerance_factor", type=float, default=12.0)
    p.add_argument("--clash_overlap_tolerance", type=float, default=0.5)
    p.add_argument("--molprobity_loc", "--molprobity_clash_loc", default=None,
                   help="molprobity.clashscore binary (reference-compatible alias); "
                        "without it the clashscore is the native H-aware count")
    p.add_argument("--exact_length", action="store_true",
                   help="pad to the structure's own length instead of its "
                        "length bucket (single-structure mode)")
    p.add_argument("--batch_size", type=int, default=1,
                   help="directory mode: structures per device pass")
    p.add_argument("--n_devices", type=int, default=None,
                   help="directory mode: ranks, one a card (default: every visible "
                        "card; one on the CPU, where --device cpu --n_devices N runs N "
                        "ranks over gloo); each chunk's rows shard over them")
    p.add_argument("--share_device", action="store_true",
                   help="run every rank on one card over gloo (checks on a one-card "
                        "machine; NCCL takes a card a rank)")
    p.add_argument("--no_clashscore", action="store_true",
                   help="directory mode: skip the per-structure before/after "
                        "clashscores (host work on the writer pool)")
    p.add_argument("--no_strict_parity", action="store_true",
                   help="when the optimization is REJECTED (objective did not "
                        "decrease), write the raw input coordinates unchanged "
                        "instead of the reference's re-idealized rebuild from "
                        "the input chis")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; without a GPU, cpu must be asked for")
    return p


def _optimize(args, batch, n_rows=None):
    """The refinement of every row of ``batch`` from its own chis, accepted
    per row: ``(coords, accept [B], objective initial [B], final [B])`` on
    the device; a rejected row is rebuilt from its input chis. ``n_rows``:
    ``batch`` is a rank's rows of that many."""
    from packppi_torch.geometry import atom14_coords_from_torsions
    from packppi_torch.sampling import proximal_optimize

    res = proximal_optimize(batch, batch.SC_D, args.violation_tolerance_factor,
                            args.clash_overlap_tolerance, args.lamda, args.num_steps,
                            n_rows=n_rows)
    first, last = res.row_losses[0], res.row_losses[-1]
    accept = last < first
    sc = torch.where(accept[:, None, None], res.SC_D, batch.SC_D)
    with torch.no_grad():
        coords = atom14_coords_from_torsions(batch.X, batch.residue_type, batch.BB_D, sc)
    return coords, accept, first, last


def run(args) -> dict:
    from packppi_torch.data import stack_batch
    from packppi_torch.device import resolve_device
    from packppi_torch.structure import featurize, from_pdb_file, to_pdb
    from packppi_torch.utils.analysis import ProteinAnalysis

    device = resolve_device(args.device)
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    analysis = ProteinAnalysis(args.molprobity_loc, tmp_dir=str(outdir / "tmp"))

    prot = from_pdb_file(args.input, mse_to_met=True)
    feats = featurize(prot)
    if feats["SC_D_mask"].sum() == 0:
        raise SystemExit("input structure has no side-chain chi angles to optimize")
    L = len(feats["residue_type"])
    batch = stack_batch([feats], device, target_len=L if args.exact_length else None)

    clash_before = analysis.get_clashscore(args.input)
    print(f"clashscore before: {clash_before}")

    if args.num_steps < 1:
        raise SystemExit("--num_steps must be >= 1")
    t0 = time.perf_counter()
    coords, accept, first, last = _optimize(args, batch)
    accepted = bool(accept[0])                 # the one read-back; waits for the device
    t_opt = time.perf_counter() - t0
    first, last = float(first[0]), float(last[0])

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
        out_prot = merge_output_structure(prot, feats, batch.atom_mask.cpu().numpy(),
                                          coords.cpu().numpy(), L)
    out_pdb = outdir / "structure.pdb"
    out_pdb.write_text(to_pdb(out_prot))

    clash_after = analysis.get_clashscore(str(out_pdb))
    print(f"clashscore after: {clash_after}  ({t_opt:.2f}s on {device}, "
          f"objective {first:.4f} -> {last:.4f})")

    result = {
        "clashscore_before": clash_before,
        "clashscore_after": clash_after,
        "accepted": accepted,
        "optimize_seconds": t_opt,
        # losses are recorded BEFORE each Adam step: _final is the objective
        # entering the last step, not that of the returned chis
        "objective_initial": first,
        "objective_final": last,
        "objective_convention": "pre-step (reference parity)",
    }
    (outdir / "metrics.json").write_text(json.dumps(result, indent=1))
    return result


def run_directory(args) -> list:
    """Optimize every PDB with side chains in a directory, a length
    bucket's structures ``batch_size`` at a time (``cli._directory``);
    structures without chis are listed under ``skipped``.

    Each chunk is one device pass: the refinement of every row from its own
    chis with the per-row accept rule and the coordinate rebuild, read back
    once. The writer pool then writes each structure (with
    ``--no_strict_parity``, a rejected one as its raw input) and, unless
    ``--no_clashscore``, its clashscores before and after, while the device
    takes the next chunk. ``summary.json`` holds ``n``, ``seconds``,
    ``n_devices``, ``num_steps``, ``skipped`` and one record a structure.
    On ``--n_devices`` ranks a chunk holds ``batch_size`` structures a rank,
    each rank refines its rows, and rank 0 writes.
    """
    from packppi_torch.cli._directory import on_ranks, resolve_n_devices
    from packppi_torch.device import resolve_device

    device = resolve_device(args.device)
    n_devices = resolve_n_devices(args)
    if args.num_steps < 1:
        raise SystemExit("--num_steps must be >= 1")
    return on_ranks(_run_directory, args, device, n_devices)


def _run_directory(args, device, mesh) -> list:
    from packppi_torch.cli._directory import (bucket_indices, load_directory, run_chunks,
                                              sharding_env)
    from packppi_torch.data import stack_batch
    from packppi_torch.parallel.launch import is_main
    from packppi_torch.structure import to_pdb
    from packppi_torch.utils.analysis import ProteinAnalysis

    n_devices = 1 if mesh is None else mesh.data
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    proteins, feats, skipped = load_directory(args.input, require_chis=True)
    per_chunk = max(args.batch_size, 1) * n_devices
    take, gather = sharding_env(mesh)
    analysis = (None if args.no_clashscore or not is_main() else
                ProteinAnalysis(args.molprobity_loc, tmp_dir=str(outdir / "tmp")))

    def write_one(i, out, row) -> dict:
        path, prot = proteins[i]
        accepted = bool(out["accept"][row])
        if args.no_strict_parity and not accepted:
            out_prot = prot                    # the parsed input, coordinates untouched
        else:
            out_prot = merge_output_structure(prot, feats[i], out["atom_mask"][row:row + 1],
                                              out["coords"][row:row + 1],
                                              len(feats[i]["residue_type"]))
        out_path = outdir / path.name
        out_path.write_text(to_pdb(out_prot))
        rec = {"input": str(path), "output": str(out_path), "accepted": accepted,
               "objective_initial": float(out["first"][row]),
               "objective_final": float(out["last"][row])}
        if analysis is not None:
            try:
                rec["clashscore_before"] = analysis.get_clashscore(str(path))
                rec["clashscore_after"] = analysis.get_clashscore(str(out_path))
            except Exception as e:  # noqa: BLE001 (a metric failure keeps the write)
                rec["clashscore_error"] = f"{type(e).__name__}: {e}"
        return rec

    def dispatch(padded, bucket):
        batch = stack_batch([feats[i] for i in padded[take(per_chunk)]], device,
                            target_len=bucket)
        coords, accept, first, last = _optimize(args, batch,
                                                None if mesh is None else per_chunk)
        out = {"coords": coords, "atom_mask": batch.atom_mask, "accept": accept,
               "first": first, "last": last}
        out = {k: gather(v) for k, v in out.items()}          # every rank takes part
        return {k: v.cpu().numpy() for k, v in out.items()} if is_main() else None

    def submit(pool, futures, chunk, out):
        for row, i in enumerate(chunk):
            futures.append(pool.submit(write_one, i, out, row))

    t0 = time.perf_counter()
    results = run_chunks(bucket_indices(feats), per_chunk, dispatch, submit)
    elapsed = time.perf_counter() - t0
    if not is_main():
        return None
    print(f"optimized {len(results)} structures in {elapsed:.2f}s on {device} "
          f"({len(results) / elapsed:.3f} structures/s)")
    (outdir / "summary.json").write_text(json.dumps(
        {"n": len(results), "seconds": elapsed, "n_devices": n_devices,
         "num_steps": args.num_steps, "skipped": skipped, "results": results}, indent=1))
    return results


def main():
    args = build_parser().parse_args()
    if Path(args.input).is_dir():
        run_directory(args)
    else:
        run(args)


if __name__ == "__main__":
    main()
