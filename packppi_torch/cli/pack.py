"""packppi-torch-pack: side-chain packing of one structure (PackPPI-MSC).

Parse and featurize a PDB, run the ``n_steps`` ODE reverse diffusion of
the chi angles, rebuild atom14 coordinates and write ``structure.pdb`` and
``metrics.json`` (``sampling_seconds``) to ``--outdir``. ``--n_samples N``
packs N noise samples and keeps the least clashing; ``--use_proximal``
refines the sample with PackPPI-Prox (``proximal_seconds``). Runs on the
CUDA device unless ``--device cpu`` is given.

    python -m packppi_torch.cli.pack --input complex.pdb --outdir out \\
        [--ckpt weights.pt|weights.npz] [--precision bfloat16|float32] \\
        [--n_steps 30] [--n_samples 1] [--use_proximal] [--seed 0] \\
        [--geometry global|local] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser(description="PackPPI side-chain packing (PyTorch/CUDA)")
    p.add_argument("--input", required=True, help="input PDB")
    p.add_argument("--outdir", default="packppi_out", help="output directory")
    p.add_argument("--ckpt", default=None,
                   help="reference-named state dict: torch.save file or .npz "
                        "(keys optionally prefixed 'sd::')")
    p.add_argument("--precision", default="bfloat16", choices=["bfloat16", "float32"],
                   help="network compute dtype")
    p.add_argument("--n_steps", type=int, default=30, help="reverse-diffusion steps")
    p.add_argument("--n_samples", type=int, default=1,
                   help="pack N noise samples in one batch and keep the least clashing")
    p.add_argument("--use_proximal", action="store_true",
                   help="refine the sample with the proximal clash optimizer")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--geometry", default="global", choices=["global", "local"],
                   help="point-geometry layout: 'local' caches static "
                        "relative frame transforms and gathers bf16-safe "
                        "local points (see NetworkConfig.geometry_mode)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; without a GPU, cpu must be asked for")
    return p


def merge_output_structure(prot, feats, atom_mask, coords, L):
    """Rebuilt coordinates for modelled residues; residues the model cannot
    represent (incomplete backbone -> residue_mask 0) pass through unchanged
    so the output keeps the input's residue count. ``coords`` [1, L_pad, 14,
    3] and ``atom_mask`` [1, L_pad, 14] are numpy."""
    rm = feats["residue_mask"].astype(bool)
    pos = np.where(rm[:, None, None], coords[0, :L], np.nan_to_num(prot.atom_positions))
    mask = np.where(rm[:, None], atom_mask[0, :L], prot.atom_mask)
    return dataclasses.replace(prot, atom_positions=pos, atom_mask=mask)


def run(args) -> dict:
    from packppi_torch.data import ProteinBatch, stack_batch
    from packppi_torch.device import resolve_device
    from packppi_torch.geometry import atom14_coords_from_torsions
    from packppi_torch.models import NetworkConfig, TorsionalDiffusion
    from packppi_torch.ops.clash import compute_residue_clash
    from packppi_torch.sampling import proximal_optimize
    from packppi_torch.structure import featurize, from_pdb_file, to_pdb
    from packppi_torch.weights import init_weights, load_weights

    device = resolve_device(args.device)
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)

    prot = from_pdb_file(args.input, mse_to_met=True)
    feats = featurize(prot)
    L = len(feats["residue_type"])
    n_samples = max(1, args.n_samples)
    # best-of-N: the protein repeated along the batch axis
    batch = stack_batch([feats] * n_samples, device)

    # local geometry runs the feature-message kernel (the in-kernel-geometry
    # kernels need global points), as the JAX CLI does
    local = args.geometry == "local"
    model = TorsionalDiffusion(NetworkConfig(
        compute_dtype=args.precision, geometry_mode=args.geometry,
        fused_messages=True if local else "geom_lanes"))
    if args.ckpt:
        load_weights(model.net, args.ckpt)
    else:
        print("WARNING: no --ckpt given; sampling with random weights from --seed")
        init_weights(model.net, args.seed)
    model.to(device)
    generator = torch.Generator(device=device).manual_seed(args.seed)

    t0 = time.perf_counter()
    sc = model.sample(batch, generator, n_steps=args.n_steps)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_sample = time.perf_counter() - t0

    if n_samples > 1:
        with torch.no_grad():
            per_sample = (compute_residue_clash(batch, sc) * batch.residue_mask).sum(-1)
        best = int(per_sample.argmin())
        print(f"best-of-{n_samples}: clash sums {np.round(per_sample.cpu().numpy(), 2)}"
              f" -> keeping sample {best}")
        batch = ProteinBatch(*(t[best:best + 1] for t in batch))
        sc = sc[best:best + 1]

    metrics = {"sampling_seconds": t_sample}
    if args.use_proximal:
        cfg = model.sample_cfg
        t0 = time.perf_counter()
        res = proximal_optimize(batch, sc, cfg.violation_tolerance_factor,
                                cfg.clash_overlap_tolerance, cfg.lamda, cfg.num_steps)
        losses = res.losses.tolist()           # the one read-back; waits for the device
        metrics.update(proximal_seconds=time.perf_counter() - t0,
                       proximal_accepted=losses[-1] < losses[0],
                       proximal_objective_initial=losses[0],
                       proximal_objective_final=losses[-1])
        if metrics["proximal_accepted"]:
            sc = res.SC_D
        else:
            print("proximal refinement did not reduce the objective; keeping the sample")

    with torch.no_grad():
        coords = atom14_coords_from_torsions(batch.X, batch.residue_type, batch.BB_D, sc)
    out_prot = merge_output_structure(prot, feats, batch.atom_mask.cpu().numpy(),
                                      coords.cpu().numpy(), L)
    out_pdb = outdir / "structure.pdb"
    out_pdb.write_text(to_pdb(out_prot))
    print(f"wrote {out_pdb}  (sampling {t_sample:.3f}s"
          + (f", proximal {metrics['proximal_seconds']:.3f}s" if args.use_proximal else "")
          + f" on {device})")
    (outdir / "metrics.json").write_text(json.dumps(metrics, indent=1))
    return metrics


def main():
    run(build_parser().parse_args())


if __name__ == "__main__":
    main()
