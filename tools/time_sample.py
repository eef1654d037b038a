"""Time the ODE sampler (30 steps) of one or more checkouts of the port on
the card.

    python tools/time_sample.py [ROOT ...]

Each ROOT is a directory holding a ``packppi_torch/`` (a checkout, or an
older commit unpacked with ``git archive``); no ROOT means this repository.
Each runs in a process of its own: PackPPI-MSC at its published widths in
bf16, routed as ``cli.pack`` routes it, random weights from seed 0, on the
fixtures 1BRS, 2FTL and T1124 (buckets 256, 384 and 768) at B = 1 and on
T1124 at B = 16, each from a seeded t=1 start. For every shape it prints
one JSON line: the first call's seconds (a checkout that captures a CUDA
graph captures it there), the median wall seconds of five more (each to a
synchronise), the device time of one call (its kernels and copies summed
from ``torch.profiler``), the device memory the first call left allocated
and reserved, and, where the checkout has the eager loop beside the graphs
(``TorsionalDiffusion._eager``: the same steps run one call each), that
loop's median wall seconds and device time and the largest wrapped gap
between the two over the final chis and every trajectory row, with
whether they agree bit for bit. Run the checkouts to compare in one call,
parent, change, change, parent; the card's name and power limit come
first.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SHAPES = (("1brs", 1), ("2ftl", 1), ("t1124", 1), ("t1124", 16))
STEPS = 30


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
    """In this process: import ``root``'s port and time its sampler."""
    sys.path.insert(0, str(root))
    import torch

    from packppi_torch.data import stack_batch
    from packppi_torch.models import NetworkConfig, TorsionalDiffusion
    from packppi_torch.structure import featurize, from_pdb_file
    from packppi_torch.weights import init_weights

    dev = torch.device("cuda")
    model = TorsionalDiffusion(NetworkConfig(compute_dtype="bfloat16",
                                             fused_messages="geom_lanes", fused_chain=True))
    init_weights(model.net, 0)
    model = model.to(dev)
    for name, rows in SHAPES:
        feats = featurize(from_pdb_file(REPO / "tests" / "fixtures" / f"{name}.pdb",
                                        mse_to_met=True))
        batch = stack_batch([feats] * rows, dev)
        init = model.init_noise(batch, torch.Generator(device=dev).manual_seed(rows))
        sample = lambda: model.sample(batch, init_sc=init, n_steps=STEPS, return_trajectory=True)
        torch.cuda.empty_cache()
        alloc, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        first, res = _timed(torch, sample)
        torch.cuda.empty_cache()
        line = {"root": str(root), "complex": name, "B": rows, "L": batch.X.shape[1],
                "first_s": first,
                "steady_s": statistics.median(_timed(torch, sample)[0] for _ in range(5)),
                "device_ms": _device_ms(torch, sample),
                "allocated_mb": (torch.cuda.memory_allocated() - alloc) / 2 ** 20,
                "reserved_mb": (torch.cuda.memory_reserved() - reserved) / 2 ** 20}
        if hasattr(model, "_eager"):
            def eager():
                with torch.no_grad():
                    return model._eager(batch, model.net.encode_static(batch), init, STEPS,
                                        return_trajectory=True)
            times = [_timed(torch, eager) for _ in range(3)]
            want = times[-1][1]
            gap = lambda a, b: float(torch.minimum((a - b).abs(),
                                                   2 * torch.pi - (a - b).abs()).max())
            line.update(eager_s=statistics.median(t for t, _ in times),
                        eager_device_ms=_device_ms(torch, eager),
                        chi_gap=max(gap(a, b) for a, b in zip(res, want)),
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
