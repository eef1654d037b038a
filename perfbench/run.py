"""Run one cell of the benchmark of ``packppi_torch`` once and print its
result as the last line of standard output.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic mix and its metrics are found by
name from ``BENCHMARK.json``: ``configs/<config>.json``,
``traffic/<traffic>.json`` (whose ``kind`` names the module that runs it,
``harness/<kind>.py``) and ``metrics/<metric>.py``. Set-up builds the cell's
kernel libraries, makes the weights from the seed and warms every shape of
the mix; the window then runs the mix closed-loop for ``--seconds``. With
``--trace 1`` a profiled stretch of whole requests follows the window and
the per-layer metrics are printed instead of the end-to-end ones. Once the
window has closed the outputs are compared with the plain reference
(``reference/``), and the line says whether they are ``correct``.

It needs a CUDA device: without one (or with fewer than the cell's chips)
it exits with code 3 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

# one thread a process for the host's numerical libraries, set before any of
# them loads: their worker threads would take cores from the launch loop
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench.harness import common  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run(args, require_cuda: bool = True, faults=(), overrides=None, t_start: float = T_START):
    """One run; returns (exit code, result line or None). For the tests of
    the harness itself: ``require_cuda`` off runs on the CPU, ``faults``
    breaks the timed path on purpose (``harness/pack.py``,
    ``harness/ddg.py``), ``overrides`` ({"config": {...}, "traffic": {...}})
    replaces entries of the cell's files."""
    common.prepare_environment()
    import torch

    spec = common.load_spec(args.workload)
    for part, values in (overrides or {}).items():
        spec[part].update(values)
    chips = spec["cell"]["chips"]
    if require_cuda and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3, None
    device = torch.device("cuda", 0) if require_cuda else torch.device("cpu")
    kind = importlib.import_module(f"perfbench.harness.{spec['traffic']['kind']}")
    cell = kind.Cell(spec, args.seed, device, faults)
    common.log_setup(start=time.perf_counter() - t_start)
    cell.setup()
    ctx = types.SimpleNamespace(setup_s=time.perf_counter() - t_start, trace=None, work=None,
                                spans=cell.spans, spec=spec)
    ctx.window = cell.window(args.seconds)
    ctx.spans = common.Spans()     # the window's spans, not the profiled stretch's
    ctx.spans.seconds.update({k: list(v) for k, v in cell.spans.seconds.items()})
    breakdown = None
    if args.trace:
        from perfbench.harness import devtrace

        cell.spans.annotate = True
        ctx.work = []
        ctx.trace = devtrace.profile(torch, lambda: ctx.work.extend(cell.traced()))
        breakdown = {"device_ops": ctx.trace.device_ops(), "idle_gaps": ctx.trace.idle_gaps()}
    device_line = (common.device_info(torch, chips) if require_cuda else
                   {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0})
    if ctx.trace is not None:
        device_line.update(busy_s=ctx.trace.busy_s, window_s=ctx.trace.window_s)
    cell.release()
    checks = cell.check()
    metrics = {}
    for m in spec["per_layer" if args.trace else "end_to_end"]:
        value = common.metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    bad = common.forbidden_modules()
    if bad:
        print(f"modules loaded that no run may hold: {', '.join(bad)}", file=sys.stderr)
        return 4, None
    checks.print()
    return 0, common.result_line(checks.correct, ctx.window["items"], 0, metrics, device_line,
                                 checks.table(), breakdown)


def main():
    code, line = run(parse())
    if line is not None:
        print(line, flush=True)
    sys.exit(code)


if __name__ == "__main__":
    main()
