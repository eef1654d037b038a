"""Time the clash kernels (forward and gradient) of one or more checkouts of
the port on the card, with the kernel timer of ``chip_smoke.py``.

    python tools/time_clash.py [--end-to-end] [ROOT ...]

Each ROOT is a directory holding a ``packppi_torch/`` (a checkout, or an
older commit unpacked with ``git archive``); no ROOT means this repository.
Each is run in a process of its own, which builds that checkout's ``clash``
source and calls its wrappers on ``chip_smoke.py``'s clash-heavy T1124
conformation (L = 768, A = 10,752 atoms; chis perturbed by a seeded
N(0, 0.8)) and on 11 copies of it (L = 8,151), with a seeded non-uniform
cotangent: the forward (its packing and listing launches included), the
gradient with the forward's culling state, and both with culling off. For
every call it prints the mean CUDA-event time of one wrapper call (L2
flushed, the card spinning while the host prepares the launches), the
profiler's device time of all the call's kernels (L2 warm), max |d|
against the plain version, and the first 16 hex digits of the output's
sha256 (equal digests across checkouts: equal bits). ``--end-to-end`` adds,
for each checkout, ``chip_smoke.py``'s proximal refinement latency of a bf16
T1124 sample (median of five) and its profiles of one network evaluation
and of one Adam step (device busy time, idle share, device operations).
Run the checkouts to compare in one call, in the order parent, change,
change, parent; the card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import inspect
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
# the clash kernels' names, this tree's and the parent's (boxes_kernel)
KERNELS = ("pair_kernel", "pack_kernel", "boxes_kernel")


def device_ms(torch, fn, reps=20):
    """Mean device time of all the kernels one call of ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total", None) or e.cuda_time_total
                for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA") and any(k in e.key for k in KERNELS))
    return total / reps / 1e3 if total else None


def run_one(root: Path, end_to_end: bool):
    """In this process: import ``root``'s port and time its clash kernels."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    spec = importlib.util.spec_from_file_location("smoke_timer", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from packppi_torch.ops import _build
    from packppi_torch.ops import clash as C

    assert Path(_build.__file__).resolve().is_relative_to(root.resolve()), _build.__file__
    _build.build_all(["clash"])
    timer = smoke.Timer(torch)
    tol = smoke.CLASH_TOL_SOFT
    out = {"root": str(root), "registers": [
        line.strip() for line in _build.build_log("clash").splitlines()
        if "registers" in line or "spill" in line]}
    # the gradient reuses the forward's culling state: boxes (parent) or Culling
    state_kw = ("culling" if "culling" in inspect.signature(C.clash_backward_cuda).parameters
                else "boxes")
    for label, copies in (("T1124", 1), ("11xT1124", 11)):
        ops = smoke.clash_inputs(torch, copies=copies, padded=copies == 1)
        ex = ops[1]
        w = torch.as_tensor(np.random.default_rng(copies).uniform(0.1, 1.0, tuple(ex.shape))
                            .astype(np.float32), device="cuda") * ex
        want, want_g = smoke.plain_clash_and_grad(torch, ops, w)
        _, state = C.clash_forward_cuda(*ops, tol)
        _, uncut = C.clash_forward_cuda(*ops, tol, cull=False)
        calls = {
            "forward": (lambda: C.clash_forward_cuda(*ops, tol)[0], want),
            "gradient": (lambda: C.clash_backward_cuda(*ops, w, tol, **{state_kw: state}), want_g),
            "forward, culling off": (lambda: C.clash_forward_cuda(*ops, tol, cull=False)[0], want),
            "gradient, culling off": (
                lambda: C.clash_backward_cuda(*ops, w, tol, cull=False, **{state_kw: uncut}),
                want_g)}
        for name, (fn, ref) in calls.items():
            got = fn()
            digest = hashlib.sha256(got.contiguous().view(torch.uint8).cpu().numpy().tobytes())
            out[f"{name} {label}"] = dict(
                ms=timer(fn), device_ms=device_ms(torch, fn),
                max_abs_err=(got - ref).abs().max().item(), digest=digest.hexdigest()[:16])
        if hasattr(state, "pair_tests"):
            out[f"pair tests {label}"] = state.pair_tests()
        del ops, w, want, want_g, state, uncut
        torch.cuda.empty_cache()
    if end_to_end:
        sc = smoke.phase_latency(torch, reps=1, prox_reps=5)
        smoke.phase_profile(torch, sc)
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", type=Path)
    ap.add_argument("--end-to-end", action="store_true",
                    help="also time the proximal refinement and profile an Adam step, as "
                         "chip_smoke.py does")
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        run_one(args.one, args.end_to_end)
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    failed = False
    for root in list(args.roots) or [REPO]:
        proc = subprocess.run([sys.executable, __file__, "--one", str(root)]
                              + ["--end-to-end"] * args.end_to_end, capture_output=True, text=True)
        if proc.returncode != 0:
            print(f"{root}: exit {proc.returncode}\n{proc.stdout[-4000:]}\n{proc.stderr[-8000:]}",
                  flush=True)
            failed = True
            continue
        lines = proc.stdout.strip().splitlines()
        rec = json.loads(lines[-1])
        print(f"== {root}", flush=True)
        for line in lines[:-1]:               # chip_smoke.py's end-to-end phases
            print(f"   {line}")
        for line in rec.pop("registers"):
            print(f"   {line}")
        for k, v in rec.items():
            if isinstance(v, dict):
                dev = "n/a" if v["device_ms"] is None else f"{v['device_ms']:.4f}"
                print(f"   {k}: {v['ms']:.4f} ms (kernels alone {dev} ms), max|d| "
                      f"{v['max_abs_err']:.3g}, output sha256 {v['digest']}", flush=True)
            elif k != "root":
                print(f"   {k}: {v}", flush=True)
    if failed:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
