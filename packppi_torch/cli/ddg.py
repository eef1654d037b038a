"""packppi-torch-ddg: the change of binding free energy under mutations
(PackPPI-AP).

Parse a complex, apply a mutation string (``KI15G`` or ``KA25A,DD35A``), run
the affinity model and print the predicted ddG in kcal/mol; ``ddg.json``
goes to ``--outdir``. Modes: ``network`` (frozen diffusion backbone, then
the mutation encoder and IPMP stack on the mutation's local subgraph),
``linear`` (the backbone's features and the head) and ``esm`` (ESM-2
embeddings, computed with the ESM-2 weights of ``--esm_ckpt`` in one
forward over the wild type and the mutant, or for a single mutation read
from ``--esm_dir``/``--esm_key``; then the head). ``--eval_csv DATA_DIR``
predicts every mutation of ``DATA_DIR/skempi_v2.csv`` (PDBs under
``DATA_DIR/PDBs``) in batches of one length bucket and reports RMSE, MAE,
Pearson and Spearman against the measured values; in ``esm`` mode each
batch's distinct sequences go through one ESM-2 forward. Runs on the CUDA
device unless ``--device cpu`` is given.

    python -m packppi_torch.cli.ddg --input complex.pdb --mutstr KI15G \\
        [--mode network|linear|esm] [--ckpt affinity.pt] [--pre_ckpt backbone.pt] \\
        [--esm_ckpt esm2.pt | --esm_dir DIR --esm_key KEY] [--outdir out] \\
        [--seed 0] [--device cuda|cpu] [--no_strict_parity]
    python -m packppi_torch.cli.ddg --eval_csv DATA_DIR --ckpt ... --pre_ckpt ...
    python -m packppi_torch.cli.ddg --eval_csv DATA_DIR --mode esm --esm_ckpt esm2.pt --ckpt ...
"""
from __future__ import annotations

import argparse
import functools
import json
from pathlib import Path

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser(description="PackPPI ddG prediction (PyTorch/CUDA)")
    p.add_argument("--input", default=None, help="wild-type complex PDB")
    p.add_argument("--mutstr", default=None,
                   help="comma-separated mutations, e.g. KI15G or KA25A,DD35A")
    p.add_argument("--eval_csv", default=None, metavar="DATA_DIR",
                   help="dataset mode: evaluate every mutation in DATA_DIR/skempi_v2.csv "
                        "(PDBs under DATA_DIR/PDBs) against the measured ddG")
    p.add_argument("--batch_size", type=int, default=4, help="dataset mode: mutations per batch")
    p.add_argument("--ckpt", default=None,
                   help="affinity network state dict (reference names, .pt or .npz)")
    p.add_argument("--pre_ckpt", default=None,
                   help="diffusion backbone state dict (reference names, .pt or .npz)")
    p.add_argument("--mode", default="network", choices=["network", "linear", "esm"])
    p.add_argument("--esm_dir", default=None,
                   help="esm mode, a single mutation only (not --eval_csv): directory with "
                        "precomputed <key>.npz (wt/mut) embeddings")
    p.add_argument("--esm_key", default=None, help="esm mode: embedding file stem")
    p.add_argument("--esm_ckpt", default=None,
                   help="esm mode: ESM-2 weights (.pt of tools/convert_hf_esm_to_torch.py)")
    p.add_argument("--outdir", default="packppi_out")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; without a GPU, cpu must be asked for")
    p.add_argument("--no_strict_parity", action="store_true",
                   help="mask padding out of the ddG max-pool (padding-invariant "
                        "predictions) instead of pooling over padded rows as the reference")
    return p


def _weights(module, path, seed, flag, what):
    from packppi_torch.weights import init_weights, load_weights

    if path:
        load_weights(module, path)
    else:
        print(f"WARNING: no {flag}; using a randomly initialized {what} from --seed")
        init_weights(module, seed)


def _affinity_model(args, device):
    from packppi_torch.models import NetworkConfig
    from packppi_torch.models.affinity import AffinityModel

    cfg = NetworkConfig()
    cfg.check_device(device)
    model = AffinityModel(cfg, args.mode, strict_parity=not args.no_strict_parity)
    _weights(model.backbone.net, args.pre_ckpt, args.seed, "--pre_ckpt", "diffusion backbone")
    _weights(model.net, args.ckpt, args.seed + 1, "--ckpt", "affinity net")
    return model.to(device)


def _write_ddg(args, value: float) -> float:
    print(f"Predicted ddG (kcal/mol): {value:.4f}")
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    (outdir / "ddg.json").write_text(json.dumps(
        {"input": args.input, "mutstr": args.mutstr, "ddg_pred": value}))
    return value


def _esm_head(args, dim: int, device):
    from packppi_torch.models import NetworkConfig
    from packppi_torch.models.affinity import AffinityNet

    net = AffinityNet(NetworkConfig(), "esm", not args.no_strict_parity, esm_dim=dim).eval()
    _weights(net, args.ckpt, args.seed, "--ckpt", "esm head")
    return net.to(device)


def _esm_model(args, device):
    """ESM-2 from ``--esm_ckpt`` and the head: ``EsmAffinityModel``."""
    from packppi_torch.data.esm import load_esm_model
    from packppi_torch.models.affinity import EsmAffinityModel

    esm = load_esm_model(args.esm_ckpt, device)
    if esm is None:
        raise SystemExit("esm mode needs --esm_ckpt (ESM-2 weights), or --esm_dir/--esm_key "
                         "for a single mutation")
    return EsmAffinityModel(esm, _esm_head(args, esm.cfg.hidden_size, device))


def _esm_precomputed(args, device):
    """The head over the ``--esm_dir`` embeddings: ddG [1], or None when
    there is no such file."""
    from packppi_torch.data.esm import load_precomputed

    emb = load_precomputed(args.esm_dir, args.esm_key) if args.esm_dir else None
    if emb is None:
        return None
    if "wt" not in emb or "mut" not in emb:
        raise SystemExit("esm npz must contain 'wt' and 'mut' arrays")
    wt, mt = (torch.as_tensor(emb[k], device=device)[None] for k in ("wt", "mut"))
    return _esm_head(args, wt.shape[-1], device)(None, None, wt, mt, None)[0]


def run(args) -> float:
    from packppi_torch.data.skempi import (esm_item, parse_mutation, skempi_features,
                                           stack_affinity_batch, stack_esm_batch)
    from packppi_torch.device import resolve_device
    from packppi_torch.structure import from_pdb_file

    device = resolve_device(args.device)
    prot = from_pdb_file(args.input, mse_to_met=True)
    mutations = [parse_mutation(m.strip()) for m in args.mutstr.split(",")]

    with torch.no_grad():
        if args.mode == "esm":
            item = esm_item(prot, mutations)          # checks the mutations against the structure
            ddg = _esm_precomputed(args, device)
            if ddg is None:
                # the dataset path's batch of one: wild type and mutant in one forward
                ddg, _ = _esm_model(args, device).predict(stack_esm_batch([item], device))
        else:
            batch = stack_affinity_batch([skempi_features(prot, mutations)], device)
            ddg, _ = _affinity_model(args, device).predict(batch)
    return _write_ddg(args, float(ddg[0]))


def run_eval_csv(args) -> dict:
    """Dataset mode: the predicted ddG of every mutation of a SKEMPI-format
    CSV, per mutation (``ddg_eval.jsonl``, in CSV order) and summarised
    (``ddg_eval_summary.json``) against the measured values."""
    from packppi_torch.data.loader import BucketedLoader
    from packppi_torch.data.skempi import (esm_item, load_skempi_entries, skempi_features,
                                           stack_affinity_batch, stack_esm_batch)
    from packppi_torch.device import resolve_device
    from packppi_torch.structure import from_pdb_file
    from packppi_torch.utils.metrics import spearman

    if args.esm_dir:
        raise SystemExit("--esm_dir embeds a single mutation; --eval_csv --mode esm takes "
                         "--esm_ckpt (ESM-2 weights)")
    device = resolve_device(args.device)
    entries = load_skempi_entries(args.eval_csv, "PDBs")
    if not entries:
        raise SystemExit(f"no usable SKEMPI entries under {args.eval_csv}")
    if args.mode == "esm":
        model, item = _esm_model(args, device), esm_item
        stack = lambda items, target_len: stack_esm_batch(items, device)   # noqa: E731
    else:
        model, item = _affinity_model(args, device), skempi_features
        stack = functools.partial(stack_affinity_batch, device=device)

    # parse-only residue counts, so that planning the batches featurizes nothing
    pdb_len: dict = {}
    for e in entries:
        if e["pdb_path"] not in pdb_len:
            pdb_len[e["pdb_path"]] = len(from_pdb_file(e["pdb_path"], mse_to_met=True).aaindex)
    entry_lengths = [pdb_len[e["pdb_path"]] for e in entries]

    class Mutations:
        lengths = staticmethod(lambda: entry_lengths)

        def __len__(self):
            return len(entries)

        def __getitem__(self, i):
            e = entries[i]
            return item(from_pdb_file(e["pdb_path"], mse_to_met=True), e["mutations"],
                        ddg=e["ddG"])

    loader = BucketedLoader(Mutations(), args.batch_size, shuffle=False, drop_last=False,
                            prefetch=2, stack_fn=stack)
    order = [i for b in loader.plan() for i in b]    # bucket grouping permutes entries
    preds, labels = [], []
    with torch.no_grad():
        for batch in loader:
            preds.append(model.predict(batch)[0].cpu().numpy())
            labels.append(batch.ddg.cpu().numpy())
    flat_p, flat_y = np.concatenate(preds), np.concatenate(labels)
    if len(flat_p) != len(entries):
        raise SystemExit(f"evaluated {len(flat_p)} of {len(entries)} entries: incomplete "
                         "evaluation, no metrics reported")
    p = np.empty(len(entries), flat_p.dtype)
    y = np.empty(len(entries), flat_y.dtype)
    p[order], y[order] = flat_p, flat_y

    out = {"n": len(entries), "rmse": float(np.sqrt(np.mean((p - y) ** 2))),
           "mae": float(np.mean(np.abs(p - y)))}
    if len(p) > 2 and p.std() > 0 and y.std() > 0:
        out["pearson"] = float(np.corrcoef(p, y)[0, 1])
        out["spearman"] = spearman(p, y)
    print(json.dumps(out))

    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    with open(outdir / "ddg_eval.jsonl", "w") as f:
        for e, pi, yi in zip(entries, p, y):
            f.write(json.dumps({"complex": e["complex"], "mutstr": e["mutstr"],
                                "ddg_pred": float(pi), "ddg_exp": float(yi)}) + "\n")
    (outdir / "ddg_eval_summary.json").write_text(json.dumps(out))
    return out


def run_cli(argv=None):
    """Parse ``argv`` and run: returns the ddG of ``run``, or the summary of
    ``run_eval_csv`` with ``--eval_csv``."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.eval_csv:
        return run_eval_csv(args)
    if not args.input or not args.mutstr:
        parser.error("--input and --mutstr are required (or use --eval_csv DATA_DIR)")
    return run(args)


def main(argv=None) -> None:
    run_cli(argv)


if __name__ == "__main__":
    main()
