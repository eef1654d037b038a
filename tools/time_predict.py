"""Time PackPPI-AP's ``predict`` (network mode) of one or more checkouts of
the port on the card.

    python tools/time_predict.py [ROOT ...]

Each ROOT is a directory holding a ``packppi_torch/`` (a checkout, or an
older commit unpacked with ``git archive``); no ROOT means this repository.
Each runs in a process of its own: PackPPI-AP at its published widths in
float32, routed as ``cli.ddg`` routes it, random weights from seeds 0 and 1,
on SKEMPI mini's mutations of 1BRS and 2FTL (buckets 256 and 384) at the
batch shapes of ``cli.ddg --eval_csv`` (B = 4 and 2 at L = 256, 4 and 1 at
L = 384). For every shape it prints one JSON line: the first call's seconds
(a checkout that captures CUDA graphs captures them there), the median wall
seconds of ten more (each to a synchronise), the device time of one call
(its kernels and copies summed from ``torch.profiler``), the device memory
the first call left allocated and reserved (the graphs' pools), and, where
the checkout has the eager passes beside the graphs
(``AffinityModel._mutation_pass``), their median wall seconds and device
time and the largest gap between the two predictions (kcal/mol), with
whether they agree bit for bit. Run the checkouts to compare in one call,
parent, change, change, parent; the card's name and power limit come first.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SHAPES = ((4, "1BRS"), (2, "1BRS"), (4, "2FTL"), (1, "2FTL"))


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _device_ms(torch, fn):
    """Milliseconds of device work of one call: every kernel and copy the
    profiler saw (one stream, so their sum is the busy time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = lambda e: (getattr(e, "self_device_time_total", None)
                    or getattr(e, "self_cuda_time_total", 0))
    return sum(us(e) for e in prof.key_averages()) / 1e3


def run_one(root: Path):
    """In this process: import ``root``'s port and time its ``predict``."""
    sys.path.insert(0, str(root))
    import torch

    from packppi_torch.data.skempi import (load_skempi_entries, skempi_features,
                                           stack_affinity_batch)
    from packppi_torch.models import NetworkConfig
    from packppi_torch.models.affinity import AffinityModel
    from packppi_torch.structure import from_pdb_file
    from packppi_torch.weights import init_weights

    dev = torch.device("cuda")
    model = AffinityModel(NetworkConfig(), "network")
    init_weights(model.backbone.net, 0)
    init_weights(model.net, 1)
    model = model.to(dev)
    mutations: dict = {}
    for e in load_skempi_entries(str(REPO / "tests" / "fixtures" / "skempi_mini"), "PDBs"):
        prot = from_pdb_file(e["pdb_path"], mse_to_met=True)
        mutations.setdefault(e["pdb_id"], []).append(skempi_features(prot, e["mutations"],
                                                                     ddg=e["ddG"]))
    for rows, name in SHAPES:
        batch = stack_affinity_batch(mutations[name][:rows], dev)

        def predict():
            with torch.no_grad():
                return model.predict(batch)

        torch.cuda.empty_cache()
        alloc, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        first, res = _timed(torch, predict)
        torch.cuda.empty_cache()
        line = {"root": str(root), "complex": name, "B": rows, "L": batch.X.shape[1],
                "first_s": first,
                "steady_s": statistics.median(_timed(torch, predict)[0] for _ in range(10)),
                "device_ms": _device_ms(torch, predict),
                "allocated_mb": (torch.cuda.memory_allocated() - alloc) / 2 ** 20,
                "reserved_mb": (torch.cuda.memory_reserved() - reserved) / 2 ** 20}
        if hasattr(model, "_mutation_pass"):
            def eager():
                model.net.eval()
                with torch.no_grad():
                    h = [model.pret(b) for b in (batch.wild(), batch.mutant())]
                    return model._mutation_pass(batch, *h)
            times = [_timed(torch, eager) for _ in range(10)]
            want = times[-1][1]
            line.update(eager_s=statistics.median(t for t, _ in times),
                        eager_device_ms=_device_ms(torch, eager),
                        ddg_gap=max(float((a - b).abs().max()) for a, b in zip(res, want)),
                        bit_equal=all(torch.equal(a, b) for a, b in zip(res, want)))
        print(json.dumps(line), flush=True)


def main():
    if sys.argv[1:2] == ["--one"]:
        run_one(Path(sys.argv[2]))
        return
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                   check=False)
    for root in sys.argv[1:] or [str(REPO)]:
        subprocess.run([sys.executable, __file__, "--one", str(Path(root).resolve())],
                       check=True)


if __name__ == "__main__":
    main()
