"""Time the proximal refinement (50 Adam steps) of one or more checkouts of
the port on the card.

    python tools/time_refine.py [ROOT ...]

Each ROOT is a directory holding a ``packppi_torch/`` (a checkout, or an
older commit unpacked with ``git archive``); no ROOT means this repository.
Each runs in a process of its own on the fixtures 1BRS, 2FTL and T1124
(buckets 256, 384 and 768) at B = 1 and B = 8, chis moved off the native
ones by a seeded N(0, 0.5). For every shape it prints one JSON line: the
first call's seconds (a checkout that captures a CUDA graph captures it
there), the median of five more (each to a synchronise), the device memory
the first call left allocated and reserved, and, where the checkout has
the eager loop beside the graphs (``proximal._eager``: the same steps run
one call each), that loop's median seconds and the largest chi and
relative loss gaps between the two, and the chi gap between two eager
runs (torch's atomic adds in any order). Run the
checkouts to compare in one call, parent, change, change, parent; the
card's name and power limit come first.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SHAPES = (("1brs", 1), ("2ftl", 1), ("t1124", 1), ("1brs", 8), ("2ftl", 8), ("t1124", 8))


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def run_one(root: Path):
    """In this process: import ``root``'s port and time its refinement."""
    sys.path.insert(0, str(root))
    import torch

    from packppi_torch.data import stack_batch
    from packppi_torch.sampling import proximal
    from packppi_torch.structure import featurize, from_pdb_file

    dev = torch.device("cuda")
    for name, rows in SHAPES:
        feats = featurize(from_pdb_file(REPO / "tests" / "fixtures" / f"{name}.pdb",
                                        mse_to_met=True))
        batch = stack_batch([feats] * rows, dev)
        gen = torch.Generator().manual_seed(rows)
        noise = torch.randn(batch.SC_D.shape, generator=gen).to(dev)
        sc = batch.SC_D + 0.5 * noise * batch.SC_D_mask
        refine = lambda: proximal.proximal_optimize(batch, sc)
        torch.cuda.empty_cache()
        alloc, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        first, res = _timed(torch, refine)
        torch.cuda.empty_cache()
        line = {"root": str(root), "complex": name, "B": rows, "L": batch.X.shape[1],
                "first_s": first,
                "steady_s": statistics.median(_timed(torch, refine)[0] for _ in range(5)),
                "allocated_mb": (torch.cuda.memory_allocated() - alloc) / 2 ** 20,
                "reserved_mb": (torch.cuda.memory_reserved() - reserved) / 2 ** 20}
        if hasattr(proximal, "_eager"):
            cm = proximal.find_clash_mask(batch, sc)
            eager = lambda: proximal._eager(batch, sc, sc * cm, cm, 50, 1e-2, 1.0, (12.0, 0.5),
                                            None)
            times = [_timed(torch, eager) for _ in range(3)]
            x, losses = times[-1][1]
            gap = lambda a, b: float(torch.minimum((a - b).abs(),
                                                   2 * torch.pi - (a - b).abs()).max())
            line.update(eager_s=statistics.median(t for t, _ in times),
                        chi_gap=gap(res.SC_D, x), eager_chi_gap=gap(times[0][1][0], x),
                        loss_gap=float(((res.row_losses - losses).abs()
                                        / losses.abs().clamp_min(1e-12)).max()))
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
