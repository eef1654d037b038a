"""What every cell shares: the benchmark's declaration, host spans, the
run's environment, the import guard and the result line."""
from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]      # the checkout
BENCH = ROOT / "perfbench"

# top-level module names no run may hold: JAX, its libraries, the JAX
# package and the script that drives it
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "packppi_tpu", "chip_smoke")


def prepare_environment() -> None:
    """Caches inside the checkout at fixed paths; libraries that would load
    JAX by themselves told not to."""
    cache = ROOT / ".perfbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"


def load_spec(workload: str, root: Path = ROOT) -> dict:
    """The cell named ``workload``: its entry of ``BENCHMARK.json`` with the
    configuration (``configs/<config>.json``), the traffic mix
    (``traffic/<traffic>.json``) and the metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json ({sorted(cells)})")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    mine = lambda m: workload in m.get("workloads", [workload])
    return {"cell": cell, "run_seconds": bench["run_seconds"],
            "config": json.loads((root / config["file"]).read_text()),
            "traffic": json.loads((root / "perfbench" / "traffic" / f"{cell['traffic']}.json").read_text()),
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def metric_reader(name: str, root: Path = ROOT):
    """``read(ctx)`` of ``metrics/<name>.py``."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Spans:
    """Host-clock spans around the program's calls, kept in memory: seconds
    by name. Under a trace each span is also a profiler annotation, so idle
    gaps on the device can be named by the host work of the time."""

    def __init__(self):
        self.seconds = defaultdict(list)
        self.annotate = False

    @contextlib.contextmanager
    def __call__(self, name: str, sync=None):
        """``sync``: a callable run before the span closes (a synchronise),
        so that the span covers the device work it launched."""
        ctx = contextlib.nullcontext()
        if self.annotate:
            from torch.profiler import record_function
            ctx = record_function(f"perfbench.{name}")
        t0 = time.perf_counter()
        with ctx:
            yield
            if sync is not None:
                sync()
        self.seconds[name].append(time.perf_counter() - t0)

    def mean_ms(self, name: str):
        v = self.seconds.get(name)
        return 1e3 * sum(v) / len(v) if v else None


def log_setup(**seconds) -> None:
    """The set-up's phases, in seconds, on standard error."""
    print("setup: " + ", ".join(f"{k} {v:.3f} s" for k, v in seconds.items()), file=sys.stderr)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(torch, chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(chips))}


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: dict, breakdown=None) -> str:
    """The last line of standard output; ``checks`` (each number compared
    with its limit) comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
