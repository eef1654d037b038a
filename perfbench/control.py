"""The readings that the limits of ``correct`` are set from, on the chip at
a cell's own size: for each seed, the numbers of a sound run, of the
control (the reference put in the network's place at the precision below
the configuration's: fp8 below bfloat16, TF32 below float32, read at the
program's recorded inputs), and of each fault planted in the timed path.
The benchmark's own runs never run this.

    python3 perfbench/control.py --workload <name> --seeds 11,12,13 \\
        [--seconds 4] [--faults all|none|name,...] [--fault_seeds 3] [--check N]

One JSON line per (seed, mode) on standard output.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench.harness import common  # noqa: E402

FAULTS = {"pack": ("sampler_frozen", "refine_skipped", "write_unrefined", "feature_chi_zero",
                   "pick_worst", "half_batch"),
          "ddg": ("half_batch", "feature_mutation_dropped")}


def readings(spec, seed, seconds, faults=(), control=False):
    import torch

    from perfbench.reference.precision import BELOW

    kind = importlib.import_module(f"perfbench.harness.{spec['traffic']['kind']}")
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    cell = kind.Cell(spec, seed, device, faults)
    cell.setup()
    cell.window(seconds)
    cell.release()
    c = cell.check()
    out = {"sound" if not faults else "+".join(faults): dict(c.values, **c.notes)}
    if control:
        c = cell.check(BELOW[spec["traffic"]["precision"]])
        out["control"] = dict(c.values, **c.notes)
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--faults", default="all")
    p.add_argument("--fault_seeds", type=int, default=3,
                   help="the faults run on the first this many seeds; the rest read sound runs "
                        "and the control only")
    p.add_argument("--check", type=int, default=None,
                   help="requests or batches compared a run (default: the mix's own)")
    args = p.parse_args()
    common.prepare_environment()
    spec = common.load_spec(args.workload)
    kind = spec["traffic"]["kind"]
    if args.check:
        spec["traffic"]["check_chunks" if kind == "pack" else "check_batches"] = args.check
    faults = FAULTS[kind] if args.faults == "all" else (
        () if args.faults == "none" else tuple(args.faults.split(",")))
    if kind == "pack" and 1 in (spec["traffic"]["n_samples"], spec["traffic"]["per_chunk"]):
        faults = tuple(f for f in faults if f not in ("pick_worst", "half_batch"))
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        rows = readings(spec, seed, args.seconds, control=True)
        for f in faults if k < args.fault_seeds else ():
            rows.update(readings(spec, seed, args.seconds, (f,)))
        for mode, values in rows.items():
            print(json.dumps({"workload": args.workload, "seed": seed, "mode": mode,
                              "values": values}), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
