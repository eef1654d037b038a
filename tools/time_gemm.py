"""Time ESM-2 650M's linear maps on the card: the port's 3xTF32 GEMM
(``ops.gemm``, ``csrc/gemm.cu``) beside cuBLAS's float32 GEMM
(``F.linear`` with TF32 off, as the package leaves it: the FMA units) and,
for context only, ``F.linear`` with TF32 on (one TF32 product, not
float32-accurate; the port never runs it).

    python tools/time_gemm.py [--reps N]

For each map of a block (q/k/v stacked N = 3,840 as the model runs them,
the attention output, the FFN's two) at M = 1,280, 1,920 and 4,480 rows
(five rows at T = 256, 384 and 896), one JSON line: each route's mean
milliseconds over ``--reps`` launches timed by CUDA events, with a 256 MB
buffer written before each launch so that L2 holds none of the operands
(and the card kept busy while the host enqueues the launch);
its TFLOP/s (2 M N K over the time) and its share of the 165 TFLOP/s
float32 bound (495 TF32 TFLOP/s over three products); and the kernel's
largest gap to the float64 product over that product's largest magnitude.
The card's name and power limit come first; a last line sums the maps of
one forward at each M (33 blocks).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

PEAK = 495e12 / 3
D, FF, BLOCKS = 1280, 5120, 33
MAPS = {"qkv": (3 * D, D), "out": (D, D), "ffn_in": (FF, D), "ffn_out": (D, FF)}
ROWS = (1280, 1920, 4480)


def time_ms(torch, fn, reps, flush):
    """Mean milliseconds of ``fn`` over ``reps`` launches, L2 flushed before
    each; a spin of the card after the flush (as ``chip_smoke.py``'s timer)
    keeps the wrapper's host time out of the interval."""
    fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                   check=False)
    import torch
    import torch.nn.functional as F

    from packppi_torch.ops import gemm

    dev = torch.device("cuda")
    flush = torch.empty(64 * 2 ** 20, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    forward = {M: {"simt": 0.0, "kernel": 0.0, "tf32": 0.0} for M in ROWS}
    for name, (N, K) in MAPS.items():
        w = (torch.rand(N, K, device=dev, generator=g) * 2 - 1) * (6 / (N + K)) ** 0.5
        b = (torch.rand(N, device=dev, generator=g) * 2 - 1) * 0.1
        for M in ROWS:
            x = torch.randn(M, K, device=dev, generator=g)
            with torch.no_grad():
                y = gemm.linear(x, w, b)
                ref = torch.addmm(b.double(), x.double(), w.double().T)
                gap = ((y.double() - ref).abs().max() / ref.abs().max()).item()
                ms = {"simt": time_ms(torch, lambda: F.linear(x, w, b), args.reps, flush),
                      "kernel": time_ms(torch, lambda: gemm.linear(x, w, b), args.reps, flush)}
                torch.backends.cuda.matmul.allow_tf32 = True
                try:
                    ms["tf32"] = time_ms(torch, lambda: F.linear(x, w, b), args.reps, flush)
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = False
            flops = 2.0 * M * N * K
            line = {"map": name, "M": M, "N": N, "K": K, "kernel_gap": gap}
            for route, t in ms.items():
                line[f"{route}_ms"] = t
                line[f"{route}_tflops"] = flops / t / 1e9
                line[f"{route}_share_of_165"] = flops / t / 1e9 / (PEAK / 1e12)
                forward[M][route] += BLOCKS * t
            print(json.dumps(line), flush=True)
    for M in ROWS:
        flops = 2.0 * BLOCKS * M * sum(N * K for N, K in MAPS.values())
        print(json.dumps({"forward_maps_M": M, **{f"{r}_ms": t for r, t in forward[M].items()},
                          **{f"{r}_tflops": flops / t / 1e9 for r, t in forward[M].items()}}),
              flush=True)


if __name__ == "__main__":
    main()
