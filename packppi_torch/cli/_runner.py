"""Shared training-CLI runner: config composition, per-run output
directories, ``-m`` multirun sweeps and ``optimized_metric`` retrieval.

Each CLI invocation writes into a fresh timestamped directory under the
config's ``output_dir`` (``runs/<ts>[_<tags>]``, or ``multiruns/<ts>/<job>``
under ``-m``), with the composed config echoed to ``config.yaml``; a run
is resumed with ``ckpt_path=<checkpoint>``. Programmatic callers of
``train_*`` keep raw ``output_dir`` semantics (and resume from the last
checkpoint found there).
"""
from __future__ import annotations

import argparse
import datetime
import json
from pathlib import Path

import yaml


def run_training(train_fn_loader, default_cfg_name: str, description: str, argv=None):
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config", default=None, help="task config YAML")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; without a GPU, cpu must be asked for")
    p.add_argument("--share_device", action="store_true",
                   help="trainer.n_devices ranks all on one card over gloo (checks on a "
                        "one-card machine; NCCL takes a card a rank)")
    p.add_argument("-m", "--multirun", action="store_true",
                   help="sweep comma-separated override values "
                        "(e.g. -m trainer.lr=1e-4,3e-4)")
    p.add_argument("overrides", nargs="*",
                   help="dotlist overrides: a.b=c or group=name")
    args = p.parse_args(argv)

    from packppi_torch.device import resolve_device
    from packppi_torch.utils.config import (expand_multirun, get_metric_value, load_config,
                                            make_run_dir)

    device = resolve_device(args.device)
    train_fn = train_fn_loader()
    default_cfg = Path(__file__).resolve().parents[2] / "configs" / default_cfg_name
    cfg_path = args.config or str(default_cfg)

    jobs = expand_multirun(args.overrides) if args.multirun else [list(args.overrides)]
    ts = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")

    results = []
    for i, job in enumerate(jobs):
        cfg = load_config(cfg_path, job)
        run_dir = make_run_dir(cfg["output_dir"], multirun=args.multirun,
                               job=i if args.multirun else None,
                               tags=cfg.get("tags"), timestamp=ts)
        cfg["output_dir"] = str(run_dir)
        (run_dir / "config.yaml").write_text(yaml.safe_dump(cfg.to_dict()))
        if args.multirun:
            print(f"[multirun {i + 1}/{len(jobs)}] {job} -> {run_dir}")
        metrics = train_fn(cfg, device=device, share_device=args.share_device)
        value = get_metric_value(metrics, cfg.get("optimized_metric"))
        results.append({"job": i, "overrides": job, "run_dir": str(run_dir),
                        "metrics": {k: v for k, v in metrics.items()
                                    if isinstance(v, (int, float, str, type(None)))},
                        "optimized_metric": value})
        print(metrics)

    if args.multirun:
        base = Path(results[0]["run_dir"]).parent
        (base / "multirun_summary.json").write_text(json.dumps(results, indent=1))
        scored = [r for r in results if r["optimized_metric"] is not None]
        if scored:
            best = min(scored, key=lambda r: r["optimized_metric"])
            print(f"best optimized_metric={best['optimized_metric']:.6g} "
                  f"overrides={best['overrides']} run_dir={best['run_dir']}")
    return results
