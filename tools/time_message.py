"""Time the message kernels of one or more checkouts of the port on the
card, with the kernel timer of ``chip_smoke.py``.

    python tools/time_message.py [--variants NAME,...] [--end-to-end] [ROOT ...]

Each ROOT is a directory holding a ``packppi_torch/`` (a checkout, or an
older commit unpacked with ``git archive``); no ROOT means this
repository. Each is run in a process of its own, which builds that
checkout's ``message`` and ``message_feat`` sources and calls its wrappers
``ops.message.message``, ``ops.message.message_gather`` and
``ops.message_feat.message_feat`` on the same random operands (made from a
seed; neighbours drawn uniformly from the structure) at the shapes of the
main paths:

* ``message``, T1124's pack shape (B = 1, L = 768, K = 32: 24,576 edge
  rows), node (pool) and edge, bf16 and float32;
* ``message_gather`` at 11 x T1124 (L = 8,151), bf16, node and edge;
* ``message_feat`` at the training shape B = 4 x L = 1,024 (131,072 edge
  rows), node and edge, float32 and bf16.

For every kernel it prints the mean CUDA-event time of one wrapper call
(``chip_smoke.Timer``: L2 flushed, the card spinning while the host
prepares the launch), the profiler's device time of the kernel alone (L2
warm), the bound of ``chip_smoke.bound_ms`` and, the first time, max |d|
against the plain version. ``--end-to-end`` adds, for each checkout,
``chip_smoke.py``'s repeated bf16 T1124 packs (median of five), its
profile of one bf16 T1124 network evaluation (device busy, idle share,
device operations) and its 20 + 5 training steps at B = 4 x L = 1,024
(step wall time and profile), so that the end-to-end effect of the
kernels is read on one host. ``--variants`` adds copies of this
repository's ``packppi_torch`` with one source substitution each
(``VARIANTS``: other ring depths and blocks an SM), unpacked under
``smoke_out/variants/``. Run the checkouts to compare in one call, in the
order parent, change, change, parent; the card's name and power limit come
first.
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
sys.path.insert(0, str(REPO / "tools"))
from time_chain_attention import profiled_ms  # noqa: E402

_TC = "message_tc.cuh"
VARIANTS = {
    # bf16: ring depth (2 stages, three blocks an SM)
    "bf16_s3": [(_TC, "static constexpr int kStages = 2;", "static constexpr int kStages = 3;"),
                (_TC, "static constexpr int kMinBlocks = 3;",
                 "static constexpr int kMinBlocks = 2;")],
    "bf16_s4": [(_TC, "static constexpr int kStages = 2;", "static constexpr int kStages = 4;"),
                (_TC, "static constexpr int kMinBlocks = 3;",
                 "static constexpr int kMinBlocks = 2;")],
    # float32: ring depth (3 stages, two blocks an SM)
    "f32_s2": [(_TC, "static constexpr int kStages = 3;", "static constexpr int kStages = 2;")],
    "f32_s4": [(_TC, "static constexpr int kStages = 3;", "static constexpr int kStages = 4;"),
               (_TC, "static constexpr int kMinBlocks = 2;",
                "static constexpr int kMinBlocks = 1;")],
}

def make_variant(name: str) -> Path:
    """A copy of this repository's ``packppi_torch`` with the substitutions
    of ``VARIANTS[part]`` for each part of ``name`` (joined by "+")."""
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


T1124 = (1, 768, 32)
GATHER = (1, 8151, 32)
TRAIN = (4, 1024, 32)
H, P = 128, 8


def message_ops(torch, dtype, B, L, K, seed=0):
    """``message``'s operands (as ``tests/test_torch_kernels_gpu.py`` makes
    them), on the card."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    rot, _ = torch.linalg.qr(r(B, L, 3, 3))
    idx = torch.randint(0, L, (B, L, K), generator=g)
    mask = (torch.rand(B, L, K, generator=g) > 0.1).float()
    p_local, trans = 3 * r(B, L, P, 3), 20 * r(B, L, 3)
    pg = torch.cat([(rot[..., i, None, :] * p_local).sum(-1) + trans[..., i, None]
                    for i in range(3)], -1)
    w = lambda o, i: r(o, i) / i ** 0.5
    ops = (r(B, L, H), r(B, L, H).to(dtype), r(B, L, K, H).to(dtype), idx, p_local,
           rot.contiguous(), trans, pg, mask, w(H, 3 * H + 9 * P), 0.1 * r(H),
           w(H, H), 0.1 * r(H), w(H, H), 0.1 * r(H))
    return tuple(t.to("cuda").contiguous() for t in ops)


def feat_ops(torch, dtype, B, L, K, seed=3):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    w = lambda o, i: r(o, i) / i ** 0.5
    mask = (torch.rand(B, L, K, generator=g) > 0.1).float()
    ops = (r(B, L, H), r(B, L, K, H).to(dtype), r(B, L, K, H).to(dtype),
           (3 * r(B, L, K, 9 * P)).to(dtype), mask, w(H, 3 * H + 9 * P), 0.1 * r(H),
           w(H, H), 0.1 * r(H), w(H, H), 0.1 * r(H))
    return tuple(t.to("cuda").contiguous() for t in ops)


def pack_costs(torch, timer):
    """Time and device operations of one packing of the message weights
    (made again after every optimizer write), where the checkout packs."""
    from torch.profiler import ProfilerActivity, profile

    try:
        from packppi_torch.ops import message_feat as mf
        packs = {"bfloat16": mf.pack_message_weights_bf16, "float32": mf.pack_message_weights_f32}
    except AttributeError:          # a checkout that reads the weights as they are
        return {}
    w = message_ops(torch, torch.float32, 1, 8, 4)[9:15:2]        # w_in, w_mid, w_out
    out = {}
    for dt, pack in packs.items():
        pack(*w)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pack(*w)
            torch.cuda.synchronize()
        ops = sum(e.count for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA") and e.key != "cudaDeviceSynchronize")
        out[f"pack_message_weights {dt}"] = dict(ms=timer(lambda: pack(*w)), device_ops=ops)
    return out


def run_one(root: Path, end_to_end: bool):
    """In this process: import ``root``'s port and time its kernels."""
    sys.path.insert(0, str(root))
    import torch

    spec = importlib.util.spec_from_file_location("smoke_timer", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from packppi_torch.ops import _build
    from packppi_torch.ops.message import message, message_gather, message_plain
    from packppi_torch.ops.message_feat import message_feat, message_feat_plain

    assert Path(_build.__file__).resolve().is_relative_to(root.resolve()), _build.__file__
    _build.build_all(["message", "message_feat"])
    timer = smoke.Timer(torch)
    out = {"root": str(root), "registers": [
        line.strip() for n in ("message", "message_feat")
        for line in _build.build_log(n).splitlines() if "registers" in line or "spill" in line]}
    cases = []
    for dt in ("bfloat16", "float32"):
        for pool in (True, False):
            cases.append((f"message {dt} T1124 {'node' if pool else 'edge'}", message,
                          message_plain, smoke.message_cost, message_ops, dt, T1124, pool))
    for pool in (True, False):
        cases.append((f"message_gather bfloat16 L=8151 {'node' if pool else 'edge'}",
                      message_gather, message_plain, smoke.message_cost, message_ops,
                      "bfloat16", GATHER, pool))
    for dt in ("float32", "bfloat16"):
        for pool in (True, False):
            cases.append((f"message_feat {dt} train {'node' if pool else 'edge'}", message_feat,
                          message_feat_plain, smoke.message_feat_cost, feat_ops, dt, TRAIN,
                          pool))
    for label, fn, plain, cost, make, dt, shape, pool in cases:
        ops = make(torch, getattr(torch, dt), *shape)
        got = fn(*ops, pool)
        err = (got.float() - plain(*ops, pool).float()).abs().max().item()
        nb, no = cost(ops, pool)
        bound, by = smoke.bound_ms(nb, no, dt)
        out[label] = dict(ms=timer(lambda: fn(*ops, pool)),
                          kernel_ms=profiled_ms(torch, lambda: fn(*ops, pool), "message"),
                          bound_ms=bound, bound_by=by, max_abs_err=err)
        del ops, got
        torch.cuda.empty_cache()
    out.update(pack_costs(torch, timer))
    if end_to_end:
        smoke.phase_profile(torch, smoke.phase_latency(torch, prox_reps=1))
        smoke.phase_train(torch)
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", type=Path)
    ap.add_argument("--variants", default="", help="comma-separated names of VARIANTS")
    ap.add_argument("--end-to-end", action="store_true",
                    help="also pack, profile an evaluation and train, as chip_smoke.py does")
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
    roots = list(args.roots) or [REPO]
    roots += [make_variant(v) for v in args.variants.split(",") if v]
    failed = False
    for root in roots:
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
            if isinstance(v, dict) and "device_ops" in v:
                print(f"   {k}: {v['ms']:.4f} ms, {v['device_ops']} device operations", flush=True)
            elif isinstance(v, dict):
                kern = "n/a" if v["kernel_ms"] is None else f"{v['kernel_ms']:.4f}"
                print(f"   {k}: {v['ms']:.4f} ms (kernel alone {kern} ms; bound "
                      f"{v['bound_ms']:.4f}, {v['bound_by']}), max|d| {v['max_abs_err']:.3g}",
                      flush=True)
    if failed:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
