#!/usr/bin/env python3
"""Check that the JAX package still reproduces the shipped per-mutation ddG
predictions of ``docs/ckpts/affinity_skempi_mini_pretrained``.

    JAX_PLATFORMS=cpu python tools/check_jax_ddg_eval.py [--outdir DIR]

Runs ``packppi_tpu.cli.ddg --eval_csv tests/fixtures/skempi_mini`` in
``network`` mode on the CPU with the shipped orbax checkpoints (126
mutations, batch 4) and compares each prediction, and the summary, with
``ddg_eval.jsonl`` and ``ddg_eval_summary.json`` beside the checkpoints.
Prints the largest difference and exits 1 if any prediction differs by
more than ``--tol`` kcal/mol or a metric of the summary (RMSE, Pearson,
Spearman; shipped at four decimals) differs by 5e-4 or more. The port
(``packppi_torch.cli.ddg``) is held to the same file.
"""
import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
CKPTS = REPO / "docs" / "ckpts" / "affinity_skempi_mini_pretrained"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--outdir", default="jax_ddg_eval_out")
    ap.add_argument("--tol", type=float, default=1e-4)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from packppi_tpu.cli.ddg import build_parser, run_eval_csv

    t0 = time.perf_counter()
    summary = run_eval_csv(build_parser().parse_args([
        "--eval_csv", str(REPO / "tests" / "fixtures" / "skempi_mini"),
        "--ckpt", str(CKPTS / "affinity"), "--pre_ckpt", str(CKPTS / "backbone"),
        "--mode", "network", "--outdir", args.outdir, "--platform", "cpu"]))
    seconds = time.perf_counter() - t0
    got = [json.loads(line) for line in open(Path(args.outdir) / "ddg_eval.jsonl")]
    want = [json.loads(line) for line in open(CKPTS / "ddg_eval.jsonl")]
    if [(r["complex"], r["mutstr"]) for r in got] != [(r["complex"], r["mutstr"]) for r in want]:
        sys.exit("the evaluated mutations differ from the shipped file's")
    worst = max(abs(a["ddg_pred"] - b["ddg_pred"]) for a, b in zip(got, want))
    shipped = json.loads((CKPTS / "ddg_eval_summary.json").read_text())
    # the shipped summary is rounded to four decimals
    same = {k: abs(summary[k] - shipped[k]) < 5e-4 for k in ("rmse", "pearson", "spearman")}
    print(json.dumps({"n": len(got), "max_abs_diff_kcal": worst, "summary": summary,
                      "shipped_summary": shipped, "summary_within_5e-4": same,
                      "seconds": seconds}))
    if worst > args.tol or not all(same.values()):
        sys.exit(1)


if __name__ == "__main__":
    main()
