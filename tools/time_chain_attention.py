"""Time the chain and attention kernels of one or more checkouts of the
port on the card, with the kernel timer of ``chip_smoke.py``.

    python tools/time_chain_attention.py [--variants NAME,...] [ROOT ...]

Each ROOT is a directory holding a ``packppi_torch/`` (a checkout, or an
older commit unpacked with ``git archive``); no ROOT means this
repository. Each is run in a process of its own, which builds that
checkout's ``chain`` and ``attention`` sources and calls its wrappers
``ops.chain.chain`` and ``ops.attention.mha`` on the same random operands
(made from a seed) at the shapes of the main paths:

* chain, bf16 stream: T1124's edge pass (24,576 rows, bf16 message, masked
  before the residual add) and node pass (768 rows, float32 message);
  float32 at the training shape B = 4 x L = 1,024 (131,072 and 4,096 rows);
  and bf16 at the training shape;
* attention at ESM-2 650M's shape for T1124 (B = 1, H = 20, T = 896,
  D = 64, 113 padded keys), float32 and bf16.

For every kernel it prints the mean CUDA-event time of one wrapper call
(``chip_smoke.Timer``: L2 flushed, the card spinning while the host
prepares the launch) and the profiler's device time of the kernel alone,
and, the first time, max |d| against the plain version. ``--variants``
adds copies of this repository's ``packppi_torch`` with one source
substitution each (``VARIANTS``: the hidden split on or off and other
ring depths of the bf16 chain kernel), unpacked under ``smoke_out/variants/``. Run the
checkouts to compare in one call, in the order parent, change, change,
parent; the card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

# name -> [(file under packppi_torch/csrc, text, replacement)]; a name
# joined by "+" applies each part
_KS = "if (tiles < sms)"
_STAGES = "constexpr int kStages = 2;"
VARIANTS = {
    "ks1": [("chain.cu", _KS, "if (false)")],
    "stages3": [("chain_wgmma.cuh", _STAGES, "constexpr int kStages = 3;")],
}


CHAIN_SHAPES = {   # label: (stream dtype, msg dtype, rows, pre_mask)
    "bf16 edge T1124": ("bfloat16", "bfloat16", 24576, True),
    "bf16 node T1124": ("bfloat16", "float32", 768, False),
    "f32 edge train": ("float32", "float32", 131072, True),
    "f32 node train": ("float32", "float32", 4096, False),
    "bf16 edge train": ("bfloat16", "bfloat16", 131072, True),
}
ATTN_SHAPE = (1, 20, 896, 64, 113)   # B, H, T, D, padded keys


def make_variant(name: str) -> Path:
    root = REPO / "smoke_out" / "variants" / name
    if root.exists():
        shutil.rmtree(root)
    shutil.copytree(REPO / "packppi_torch", root / "packppi_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for fname, old, new in [p for part in name.split("+") for p in VARIANTS[part]]:
        path = root / "packppi_torch" / "csrc" / fname
        text = path.read_text()
        if old not in text:
            raise SystemExit(f"variant {name}: {old!r} not in {fname}")
        path.write_text(text.replace(old, new))
    return root


def chain_ops(torch, sd, md, n, seed=1):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    H = 128
    ops = (r(n, H).to(sd), r(n, H).to(md), (torch.rand(n, generator=g) > 0.2).float(),
           1 + 0.1 * r(H), 0.1 * r(H), r(4 * H, H) / H ** 0.5, 0.1 * r(4 * H),
           r(H, 4 * H) / (4 * H) ** 0.5, 0.1 * r(H), 1 + 0.1 * r(H), 0.1 * r(H))
    return tuple(t.to("cuda").contiguous() for t in ops)


def attn_ops(torch, dt, seed=0):
    B, H, T, D, pad = ATTN_SHAPE
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, H, T, D, generator=g) for _ in range(3))
    bias = torch.zeros(B, T)
    bias[:, T - pad:] = -1e9
    return (*(t.to(dt).to("cuda").contiguous() for t in (q * D ** -0.5, k, v)),
            bias.to("cuda"))


def profiled_ms(torch, fn, key, reps=20):
    """Mean device time of the kernels whose name contains ``key``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if key in e.key:
            total += getattr(e, "device_time_total", None) or e.cuda_time_total
            count += e.count
    return total / count / 1e3 if count else None


def run_one(root: Path):
    """In this process: import ``root``'s port and time its kernels."""
    sys.path.insert(0, str(root))
    import torch

    spec = importlib.util.spec_from_file_location("smoke_timer", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from packppi_torch.ops import _build
    from packppi_torch.ops.attention import mha, mha_plain
    from packppi_torch.ops.chain import chain, chain_plain

    assert Path(_build.__file__).resolve().is_relative_to(root.resolve()), _build.__file__
    _build.build_all(["chain", "attention"])
    timer = smoke.Timer(torch)
    out = {"root": str(root), "registers": [
        line.strip() for n in ("chain", "attention")
        for line in _build.build_log(n).splitlines() if "registers" in line or "spill" in line]}
    for label, (sd, md, n, pre_mask) in CHAIN_SHAPES.items():
        ops = chain_ops(torch, getattr(torch, sd), getattr(torch, md), n)
        err = (chain(*ops, pre_mask).float() - chain_plain(*ops, pre_mask).float()).abs().max()
        out[f"chain {label}"] = dict(
            ms=timer(lambda: chain(*ops, pre_mask)),
            kernel_ms=profiled_ms(torch, lambda: chain(*ops, pre_mask), "chain"),
            max_abs_err=err.item())
    for dt in ("float32", "bfloat16"):
        ops = attn_ops(torch, getattr(torch, dt))
        err = (mha(*ops) - mha_plain(*ops)).abs().max()
        out[f"attention {dt} T=896"] = dict(
            ms=timer(lambda: mha(*ops)),
            kernel_ms=profiled_ms(torch, lambda: mha(*ops), "mha"),
            max_abs_err=err.item())
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", type=Path)
    ap.add_argument("--variants", default="", help="comma-separated names of VARIANTS")
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        run_one(args.one)
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    roots = list(args.roots) or [REPO]
    roots += [make_variant(v) for v in args.variants.split(",") if v]
    failed = False
    for root in roots:
        proc = subprocess.run([sys.executable, __file__, "--one", str(root)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(f"{root}: exit {proc.returncode}\n{proc.stdout[-4000:]}\n{proc.stderr[-8000:]}",
                  flush=True)
            failed = True
            continue
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"== {root}", flush=True)
        for line in rec.pop("registers"):
            print(f"   {line}")
        for k, v in rec.items():
            if isinstance(v, dict):
                kern = "n/a" if v["kernel_ms"] is None else f"{v['kernel_ms']:.4f}"
                print(f"   {k}: {v['ms']:.4f} ms (kernel alone {kern} ms), "
                      f"max|d| {v['max_abs_err']:.3g}", flush=True)
    if failed:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
