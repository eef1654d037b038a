"""packppi-torch-pack: side-chain packing (PackPPI-MSC).

One structure: parse and featurize a PDB, run the ``n_steps`` ODE reverse
diffusion of the chi angles, rebuild atom14 coordinates and write
``structure.pdb`` and ``metrics.json`` to ``--outdir``: the metric suite
against the input's own side chains (chi accuracy and AE, ``total_acc``,
``interface_acc``, ``atom_rmsd``, ``clashscore``, ``clashscore_is_exact``,
each a float as the JAX CLI writes them; empty when the input has no side
chains), ``sampling_seconds`` and, with
``--use_proximal``, ``proximal_seconds``, ``proximal_accepted`` and
``proximal_objective_initial`` / ``_final``. ``--n_samples N`` packs N
noise samples and keeps the least clashing. A directory as ``--input``
packs every PDB in it (``run_directory``). Runs on the CUDA device unless
``--device cpu`` is given.

    python -m packppi_torch.cli.pack --input complex.pdb|dir/ --outdir out \\
        [--ckpt weights.pt|weights.npz] [--precision bfloat16|float32] \\
        [--n_steps 30] [--corrector_steps 0] [--n_samples 1] [--use_proximal] \\
        [--seed 0] [--geometry global|local] [--no_fused] [--exact_length] \\
        [--no_strict_parity] [--molprobity_loc BIN] \\
        [--batch_size 1] [--metrics] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from packppi_torch.cli._directory import merge_output_structure


def build_parser():
    p = argparse.ArgumentParser(description="PackPPI side-chain packing (PyTorch/CUDA)")
    p.add_argument("--input", required=True,
                   help="input PDB, or a directory of PDBs for batched packing")
    p.add_argument("--outdir", default="packppi_out", help="output directory")
    p.add_argument("--ckpt", default=None,
                   help="reference-named state dict: torch.save file or .npz "
                        "(keys optionally prefixed 'sd::')")
    p.add_argument("--precision", default="bfloat16", choices=["bfloat16", "float32"],
                   help="network compute dtype")
    p.add_argument("--n_steps", type=int, default=30, help="reverse-diffusion steps")
    p.add_argument("--corrector_steps", type=int, default=0,
                   help="Langevin corrector sub-steps per denoising step (extra "
                        "network evaluations; 0 = off, as the reference sampler)")
    p.add_argument("--n_samples", type=int, default=1,
                   help="pack N noise samples of each complex in one batch and "
                        "keep the least clashing")
    p.add_argument("--use_proximal", action="store_true",
                   help="refine the sample with the proximal clash optimizer")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--top_k", type=int, default=32,
                   help="neighbours each residue attends (NetworkConfig.top_k); the network's "
                        "other widths are the checkpoint's")
    p.add_argument("--no_fused", action="store_true",
                   help="run the network without its kernels: message passes and "
                        "residual chains as plain tensor operations (the JAX "
                        "package's unfused path)")
    p.add_argument("--geometry", default="global", choices=["global", "local"],
                   help="point-geometry layout: 'local' caches static "
                        "relative frame transforms and gathers bf16-safe "
                        "local points (see NetworkConfig.geometry_mode)")
    p.add_argument("--exact_length", action="store_true",
                   help="pad to the structure's own length instead of its "
                        "length bucket (single-structure mode)")
    p.add_argument("--molprobity_loc", "--molprobity_clash_loc", default=None,
                   help="molprobity.clashscore binary (reference-compatible alias); "
                        "without it the clashscore is the native H-aware count")
    p.add_argument("--print_metrics", action="store_true", default=True)
    p.add_argument("--no_strict_parity", action="store_true",
                   help="score metrics without the reference's quirks: chi "
                        "accuracy on the periodicity-folded error (exact "
                        "matches count) and atom_rmsd as a true RMSD")
    p.add_argument("--batch_size", type=int, default=1,
                   help="directory mode: sampler rows per device pass "
                        "(complexes per pass = batch_size // n_samples)")
    p.add_argument("--n_devices", type=int, default=None,
                   help="ranks, one a card (default: every visible card; one on the "
                        "CPU, where --device cpu --n_devices N runs N ranks over gloo): "
                        "best-of-N samples (when N divides by them) or directory rows "
                        "shard over them")
    p.add_argument("--share_device", action="store_true",
                   help="run every rank on one card over gloo (checks on a one-card "
                        "machine; NCCL takes a card a rank)")
    p.add_argument("--metrics", action="store_true",
                   help="directory mode: run the metric suite of every "
                        "structure on the writer pool and record it in "
                        "summary.json")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; without a GPU, cpu must be asked for")
    return p


def _model(args, device):
    """The sampler with its weights, on ``device``; a configuration the
    device cannot run is refused first. The network takes the checkpoint's
    widths (``weights.network_widths``; the defaults without one) and
    ``--top_k``. Local geometry runs the feature-message kernel (the
    in-kernel-geometry kernels need global points) and ``--no_fused`` no
    kernel at all, as the JAX CLI does."""
    from packppi_torch.models import NetworkConfig, TorsionalDiffusion
    from packppi_torch.weights import init_weights, load_weights, network_widths, read_state_dict

    fused = not args.no_fused
    local = args.geometry == "local"
    state = read_state_dict(args.ckpt) if args.ckpt else {}
    cfg = NetworkConfig(compute_dtype=args.precision, geometry_mode=args.geometry,
                        fused_messages=(True if local else "geom_lanes") if fused else False,
                        fused_chain=fused, top_k=getattr(args, "top_k", 32),
                        **network_widths(state))
    cfg.check_device(device)
    model = TorsionalDiffusion(cfg)
    if args.ckpt:
        load_weights(model.net, state)
    else:
        print("WARNING: no --ckpt given; sampling with random weights from --seed")
        init_weights(model.net, args.seed)
    return model.to(device)


def _refine(model, batch, sc, n_rows=None):
    """The proximal refinement of every row with the per-row accept rule:
    ``(chis, accept [B], objective initial [B], final [B])``, on the device
    (``n_rows``: ``batch`` is a rank's rows of that many)."""
    from packppi_torch.sampling import proximal_optimize

    cfg = model.sample_cfg
    res = proximal_optimize(batch, sc, cfg.violation_tolerance_factor,
                            cfg.clash_overlap_tolerance, cfg.lamda, cfg.num_steps,
                            n_rows=n_rows)
    first, last = res.row_losses[0], res.row_losses[-1]
    accept = last < first
    return torch.where(accept[:, None, None], res.SC_D, sc), accept, first, last


def run(args) -> dict:
    """Pack one structure. ``--n_samples N`` over ``--n_devices`` ranks when
    they divide N (as the JAX CLI shards best-of-N): each rank samples its
    N / ranks rows of the one-device draw, the clash sums are gathered, one
    winner is chosen, and rank 0 refines and writes it."""
    from packppi_torch.cli._directory import on_ranks, resolve_n_devices
    from packppi_torch.device import resolve_device

    device = resolve_device(args.device)
    n_devices = resolve_n_devices(args)
    n_samples = max(1, args.n_samples)
    if n_devices > 1 and n_samples % n_devices == 0:
        print(f"sharding {n_samples} samples over {n_devices} devices")
        return on_ranks(_run, args, device, n_devices)
    return _run(args, device, None)


def _run(args, device, mesh) -> dict:
    from packppi_torch.cli._directory import sharding_env
    from packppi_torch.data import ProteinBatch, stack_batch
    from packppi_torch.geometry import atom14_coords_from_torsions
    from packppi_torch.models.torsional_diffusion import Rows
    from packppi_torch.ops.clash import compute_residue_clash
    from packppi_torch.parallel.launch import is_main
    from packppi_torch.structure import featurize, from_pdb_file, to_pdb
    from packppi_torch.utils.analysis import ProteinAnalysis, as_floats

    model = _model(args, device)
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)

    prot = from_pdb_file(args.input, mse_to_met=True)
    feats = featurize(prot)
    L = len(feats["residue_type"])
    n_samples = max(1, args.n_samples)
    take, gather = sharding_env(mesh)
    mine = take(n_samples)
    # best-of-N: the protein repeated along the batch axis (this rank's rows)
    batch = stack_batch([feats] * (mine.stop - mine.start), device,
                        target_len=L if args.exact_length else None)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    rows = None if mesh is None else Rows(mine.start, n_samples, mesh.data_group)

    t0 = time.perf_counter()
    sc = model.sample(batch, generator, n_steps=args.n_steps,
                      corrector_steps=args.corrector_steps, rows=rows)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_sample = time.perf_counter() - t0

    if n_samples > 1:
        with torch.no_grad():
            per_sample = gather((compute_residue_clash(batch, sc)
                                 * batch.residue_mask).sum(-1))
        sc = gather(sc)
        best = int(per_sample.argmin())
        if not is_main():
            return None
        print(f"best-of-{n_samples}: clash sums {np.round(per_sample.cpu().numpy(), 2)}"
              f" -> keeping sample {best}")
        batch = ProteinBatch(*(t[:1] for t in batch))      # every row is the protein
        sc = sc[best:best + 1]

    timing = {"sampling_seconds": t_sample}
    if args.use_proximal:
        t0 = time.perf_counter()
        sc, accept, first, last = _refine(model, batch, sc)
        accepted = bool(accept[0])              # the one read-back; waits for the device
        timing.update(proximal_seconds=time.perf_counter() - t0,
                      proximal_accepted=accepted,
                      proximal_objective_initial=float(first[0]),
                      proximal_objective_final=float(last[0]))
        if not accepted:
            print("proximal refinement did not reduce the objective; keeping the sample")

    with torch.no_grad():
        coords = atom14_coords_from_torsions(batch.X, batch.residue_type, batch.BB_D, sc)
    out_prot = merge_output_structure(prot, feats, batch.atom_mask.cpu().numpy(),
                                      coords.cpu().numpy(), L)
    out_pdb = outdir / "structure.pdb"
    out_pdb.write_text(to_pdb(out_prot))
    print(f"wrote {out_pdb}  (sampling {t_sample:.3f}s"
          + (f", proximal {timing['proximal_seconds']:.3f}s" if args.use_proximal else "")
          + f" on {device})")

    if feats["SC_D_mask"].sum() == 0:
        # chi metrics are undefined without true side chains; the reference
        # skips the suite too (src/eval_diffusion.py:43-50,73-77)
        print("no side chain atoms in the input PDB; skipping metric calculation")
        metric = {}
    else:
        analysis = ProteinAnalysis(args.molprobity_loc, tmp_dir=str(outdir / "tmp"))
        metric = as_floats(analysis.get_metric(args.input, str(out_pdb),
                                               strict_parity=not args.no_strict_parity) or {})
    metric.update(timing)
    if args.print_metrics:
        for k, v in metric.items():
            print(f"  {k}: {v}")
    (outdir / "metrics.json").write_text(json.dumps(metric, indent=1))
    return metric


def run_directory(args) -> list:
    """Pack every PDB of a directory, a length bucket's complexes
    ``batch_size x ranks // n_samples`` at a time (``cli._directory``).

    Each chunk is one device pass: sample the chunk's rows (each complex
    repeated ``n_samples`` times; on ranks, each rank its rows of the
    one-device draw), keep each complex's least clashing row
    (``compute_residue_clash``, argmin over the gathered sums; skipped at
    ``--n_samples 1``), with ``--use_proximal`` refine the winners (each
    rank its rows) and accept per row on its own objective, rebuild atom14
    coordinates, and read them back once (gathered to rank 0). The writer
    pool then merges each complex, writes its PDB and, with ``--metrics``,
    runs ``get_metric``, while the device takes the next chunk.
    ``summary.json`` holds ``n``, ``seconds`` (end to end, loading
    excluded), ``n_devices``, ``n_samples``, ``use_proximal`` and one record
    a structure.

    The noise of every chunk comes from one ``torch.Generator`` seeded with
    ``--seed``, drawn chunk after chunk (the JAX CLI splits a key per chunk
    instead, so the two differ draw for draw). A directory of one structure
    at ``--batch_size 1`` draws what ``run`` draws on that structure, and N
    ranks at ``--batch_size b`` draw what one device draws at ``N x b``.
    """
    from packppi_torch.cli._directory import on_ranks, resolve_n_devices
    from packppi_torch.device import resolve_device

    device = resolve_device(args.device)
    return on_ranks(_run_directory, args, device, resolve_n_devices(args))


def _run_directory(args, device, mesh) -> list:
    from packppi_torch.cli._directory import (bucket_indices, load_directory, padded_rows,
                                              run_chunks, sharding_env)
    from packppi_torch.data import ProteinBatch, stack_batch
    from packppi_torch.geometry import atom14_coords_from_torsions
    from packppi_torch.models.torsional_diffusion import Rows
    from packppi_torch.ops.clash import compute_residue_clash
    from packppi_torch.parallel.launch import is_main
    from packppi_torch.structure import to_pdb
    from packppi_torch.utils.analysis import ProteinAnalysis, as_floats

    n_devices = 1 if mesh is None else mesh.data
    model = _model(args, device)
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    proteins, feats, _ = load_directory(args.input)

    n_samples = max(1, args.n_samples)
    # a fixed row budget a pass: batch_size rows a rank
    per_chunk = max(1, max(args.batch_size, 1) * n_devices // n_samples)   # complexes a pass
    n_rows = padded_rows(per_chunk * n_samples, mesh)                      # sampler rows
    n_win = padded_rows(per_chunk, mesh)                                   # winner rows
    take, gather = sharding_env(mesh)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    analysis = (ProteinAnalysis(args.molprobity_loc, tmp_dir=str(outdir / "tmp"))
                if args.metrics and is_main() else None)
    strict = not args.no_strict_parity

    def pack_chunk(batch):
        mine = take(n_rows)
        rows = None if mesh is None else Rows(mine.start, n_rows, mesh.data_group)
        sc = model.sample(batch, generator, n_steps=args.n_steps,
                          corrector_steps=args.corrector_steps, rows=rows)
        base = torch.arange(per_chunk, device=device) * n_samples
        win = base
        if n_samples > 1:
            with torch.no_grad():
                clash = gather((compute_residue_clash(batch, sc) * batch.residue_mask).sum(-1))
            win = base + clash[:per_chunk * n_samples].view(per_chunk, n_samples).argmin(1)
        # the winner rows pad to the rank count with repeats of the last
        pad = n_win - per_chunk
        base, win = (torch.cat([v, v[-1:].expand(pad)]) for v in (base, win))
        batch, sc = ProteinBatch(*(gather(t) for t in batch)), gather(sc)
        mine = take(n_win)
        wb = ProteinBatch(*(t.index_select(0, base[mine]) for t in batch))
        sc = sc.index_select(0, win[mine])
        out = {}
        if args.use_proximal:
            sc, out["accept"], out["first"], out["last"] = _refine(
                model, wb, sc, None if mesh is None else n_win)
        with torch.no_grad():
            out["coords"] = atom14_coords_from_torsions(wb.X, wb.residue_type, wb.BB_D, sc)
        out["atom_mask"] = wb.atom_mask
        out = {k: gather(v)[:per_chunk] for k, v in out.items()}
        return {k: v.cpu().numpy() for k, v in out.items()} if is_main() else None

    def write_one(i, out, row) -> dict:
        path, prot = proteins[i]
        L = len(feats[i]["residue_type"])
        out_prot = merge_output_structure(prot, feats[i], out["atom_mask"][row:row + 1],
                                          out["coords"][row:row + 1], L)
        out_path = outdir / path.name
        out_path.write_text(to_pdb(out_prot))
        rec = {"input": str(path), "output": str(out_path)}
        if "accept" in out:
            rec.update(proximal_accepted=bool(out["accept"][row]),
                       proximal_objective_initial=float(out["first"][row]),
                       proximal_objective_final=float(out["last"][row]))
        if analysis is not None:
            if feats[i]["SC_D_mask"].sum() == 0:
                rec["metrics"] = {"skipped": "no side chains in input"}
            else:
                try:
                    rec["metrics"] = as_floats(analysis.get_metric(
                        str(path), str(out_path), strict_parity=strict) or {})
                except Exception as e:  # noqa: BLE001 (a metric failure keeps the write)
                    rec["metrics"] = {"error": f"{type(e).__name__}: {e}"}
        return rec

    def dispatch(padded, bucket):
        rows = [feats[i] for i in padded for _ in range(n_samples)]
        rows += [rows[-1]] * (n_rows - len(rows))
        return pack_chunk(stack_batch(rows[take(n_rows)], device, target_len=bucket))

    def submit(pool, futures, chunk, out):
        for row, i in enumerate(chunk):
            futures.append(pool.submit(write_one, i, out, row))

    t0 = time.perf_counter()
    results = run_chunks(bucket_indices(feats), per_chunk, dispatch, submit)
    elapsed = time.perf_counter() - t0
    if not is_main():
        return None
    print(f"packed {len(results)} complexes in {elapsed:.2f}s on {device} "
          f"({len(results) / elapsed:.3f} complexes/s)")
    (outdir / "summary.json").write_text(json.dumps(
        {"n": len(results), "seconds": elapsed, "n_devices": n_devices,
         "n_samples": n_samples, "use_proximal": bool(args.use_proximal),
         "results": results}, indent=1))
    return results


def main():
    args = build_parser().parse_args()
    if Path(args.input).is_dir():
        run_directory(args)
    else:
        run(args)


if __name__ == "__main__":
    main()
