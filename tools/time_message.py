"""Time the message kernels, the kernels that run a message tile and then
the residual chain, and the chain kernel, of one or more checkouts of the
port on the card, with the kernel timer of ``chip_smoke.py``.

    python tools/time_message.py [--variants NAME,...] [--end-to-end] [--routings R,...]
                                 [ROOT ...]

Each ROOT is a directory holding a ``packppi_torch/`` (a checkout, or an
older commit unpacked with ``git archive``); no ROOT means this
repository. Each is run in a process of its own, which builds that
checkout's ``message``, ``message_feat``, ``layer`` and ``chain`` sources
and calls its wrappers on the same random operands (made from a seed;
neighbours drawn uniformly from the structure) at the shapes of the main
paths:

* ``message``, T1124's pack shape (B = 1, L = 768, K = 32: 24,576 edge
  rows), node (pool) and edge, bf16 and float32;
* ``message_geom`` (the gathered-operand route), T1124's pack shape, node
  and edge, bf16 and float32;
* ``message_gather`` at 11 x T1124 (L = 8,151), bf16, node and edge;
* ``message_feat`` at the training shape B = 4 x L = 1,024 (131,072 edge
  rows), node and edge, float32 and bf16;
* ``message_chain`` (the folded edge pass), ``layer_node`` (at the
  checkout's own ``NODES_PER_BLOCK``) and ``layer_edge`` at T1124, bf16 and
  float32;
* ``chain`` at T1124's edge and node rows in bf16 and at the training
  shape's edge rows in float32.

For every kernel it prints the mean CUDA-event time of one wrapper call
(``chip_smoke.Timer``: L2 flushed, the card spinning while the host
prepares the launch), the profiler's device time of the kernel alone (L2
warm), the bound of ``chip_smoke.bound_ms``, max |d| of the first output
against the plain version, and the first 16 hex digits of that output's
sha256 (equal digests across checkouts: equal bits). ``--end-to-end`` adds,
for each checkout, ``chip_smoke.py``'s bf16 T1124 pack under the routings
these kernels serve (``--routings``, by default ``geom``,
``FOLD_EDGE_CHAIN`` and ``fused_layers``: the first pack with its launch
counts, the median of five more, a profile of one network evaluation with
its device busy time, idle share and device operations) and each routing's
float32 evaluation against the default one, so that the end-to-end effect
of the kernels is read on one host. ``--variants`` adds
copies of this repository's ``packppi_torch`` with one source substitution
each (``VARIANTS``: other ring depths and blocks an SM), unpacked under
``smoke_out/variants/``. Run the checkouts to compare in one call, in the
order parent, change, change, parent; the card's name and power limit come
first.
"""
from __future__ import annotations

import argparse
import hashlib
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
                (_TC, "static constexpr int kMinBlocks = kH <= 128 ? 3 : 1;",
                 "static constexpr int kMinBlocks = 2;")],
    "bf16_s4": [(_TC, "static constexpr int kStages = 2;", "static constexpr int kStages = 4;"),
                (_TC, "static constexpr int kMinBlocks = kH <= 128 ? 3 : 1;",
                 "static constexpr int kMinBlocks = 2;")],
    # float32: ring depth (3 stages, two blocks an SM)
    "f32_s2": [(_TC, "static constexpr int kStages = 3;", "static constexpr int kStages = 2;")],
    "f32_s4": [(_TC, "static constexpr int kStages = 3;", "static constexpr int kStages = 4;"),
               (_TC, "static constexpr int kMinBlocks = kH <= 128 ? 2 : 1;",
                "static constexpr int kMinBlocks = 1;")],
    # the bf16 fold and whole-layer edge pass: two blocks an SM (no register cap of 168)
    "fused_bf16_b2": [("message_chain.cuh",
                       "static constexpr int kMinBlocks = MessageTc<__nv_bfloat16>::kMinBlocks;",
                       "static constexpr int kMinBlocks = 2;")],
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


def geom_ops(torch, dtype, B, L, K):
    """``message_geom``'s operands gathered from ``message_ops``': the
    neighbour term and global-point planes per edge, the local planes, R
    row-major."""
    from packppi_torch.ops.graph import gather_nodes

    per_i, per_j, h_E, idx, p_local, rot, trans, pg, mask, *w = message_ops(torch, dtype, B, L, K)
    pl = torch.cat([p_local[..., 0], p_local[..., 1], p_local[..., 2]], -1).contiguous()
    return (per_i, gather_nodes(per_j, idx).contiguous(), h_E, pl,
            gather_nodes(pg, idx).contiguous(), rot.reshape(B, L, 9).contiguous(), trans, mask,
            *w)


def feat_ops(torch, dtype, B, L, K, seed=3):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    w = lambda o, i: r(o, i) / i ** 0.5
    mask = (torch.rand(B, L, K, generator=g) > 0.1).float()
    ops = (r(B, L, H), r(B, L, K, H).to(dtype), r(B, L, K, H).to(dtype),
           (3 * r(B, L, K, 9 * P)).to(dtype), mask, w(H, 3 * H + 9 * P), 0.1 * r(H),
           w(H, H), 0.1 * r(H), w(H, H), 0.1 * r(H))
    return tuple(t.to("cuda").contiguous() for t in ops)


def chain_weights(torch, seed=4):
    """The chain's eight weights (as ``tests/test_torch_kernels_gpu.py``
    makes them), on the card."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    w = (1 + 0.1 * r(H), 0.1 * r(H), r(4 * H, H) / H ** 0.5, 0.1 * r(4 * H),
         r(H, 4 * H) / (4 * H) ** 0.5, 0.1 * r(H), 1 + 0.1 * r(H), 0.1 * r(H))
    return tuple(t.to("cuda").contiguous() for t in w)


def fold_ops(torch, dtype, B, L, K):
    return message_ops(torch, dtype, B, L, K) + chain_weights(torch)


def layer_ops(torch, dtype, B, L, K, pool):
    per_i, pj, h_E, geom, mask, *w = feat_ops(torch, dtype, B, L, K)
    if not pool:
        return (h_E, per_i, pj, geom, mask, *w, *chain_weights(torch))
    g = torch.Generator().manual_seed(6)
    h_V = torch.randn(B, L, H, generator=g).to("cuda", dtype)
    mask_V = (torch.rand(B, L, generator=g) > 0.1).float().to("cuda")
    return (h_V, per_i, pj, h_E, geom, mask, mask_V, *w, *chain_weights(torch))


def chain_ops(torch, dtype, N, seed=1):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(N, H, generator=g).to("cuda", dtype)
    msg = torch.randn(N, H, generator=g).to("cuda", dtype)
    mask = (torch.rand(N, generator=g) > 0.2).float().to("cuda")
    return (x, msg, mask) + chain_weights(torch)


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


def run_one(root: Path, routings: tuple):
    """In this process: import ``root``'s port and time its kernels."""
    sys.path.insert(0, str(root))
    import torch

    spec = importlib.util.spec_from_file_location("smoke_timer", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from packppi_torch.ops import _build
    from packppi_torch.ops.chain import chain, chain_plain
    from packppi_torch.ops.layer import layer_edge, layer_edge_plain, layer_node, layer_node_plain
    from packppi_torch.ops.message import (message, message_chain, message_chain_plain,
                                           message_gather, message_geom, message_geom_plain,
                                           message_plain)
    from packppi_torch.ops.message_feat import message_feat, message_feat_plain

    assert Path(_build.__file__).resolve().is_relative_to(root.resolve()), _build.__file__
    sources = ("message", "message_feat", "layer", "chain")
    _build.build_all(sources)
    timer = smoke.Timer(torch)
    out = {"root": str(root), "registers": [
        line.strip() for n in sources
        for line in _build.build_log(n).splitlines()
        if "registers" in line or "spill" in line or "Performance Loss" in line]}

    def cost_of(erows, crows):
        """(bytes, operations): every input read once, the output written
        once; the message's products over erows edge rows, the chain's over
        crows rows."""
        return lambda ops, out: (sum(smoke._nbytes(t) for t in ops) + smoke._nbytes(out),
                                 smoke.MESSAGE_OPS_PER_ROW * erows + smoke.CHAIN_OPS_PER_ROW * crows)

    # (label, call, plain, operands, dtype name, (bytes, operations) of (ops, out), profiler key)
    cases = []
    for dt in ("bfloat16", "float32"):
        for pool in (True, False):
            cases.append((f"message {dt} T1124 {'node' if pool else 'edge'}",
                          lambda o, p=pool: message(*o, p), lambda o, p=pool: message_plain(*o, p),
                          lambda dt=dt: message_ops(torch, getattr(torch, dt), *T1124), dt,
                          lambda o, _, p=pool: smoke.message_cost(o, p), "message"))
    erows, nodes = T1124[0] * T1124[1] * T1124[2], T1124[0] * T1124[1]
    for dt in ("bfloat16", "float32"):
        for pool in (True, False):
            cases.append((f"message_geom {dt} T1124 {'node' if pool else 'edge'}",
                          lambda o, p=pool: message_geom(*o, p),
                          lambda o, p=pool: message_geom_plain(*o, p),
                          lambda dt=dt: geom_ops(torch, getattr(torch, dt), *T1124), dt,
                          cost_of(erows, 0), "message_geom"))
    for pool in (True, False):
        cases.append((f"message_gather bfloat16 L=8151 {'node' if pool else 'edge'}",
                      lambda o, p=pool: message_gather(*o, p),
                      lambda o, p=pool: message_plain(*o, p),
                      lambda: message_ops(torch, torch.bfloat16, *GATHER), "bfloat16",
                      lambda o, _, p=pool: smoke.message_cost(o, p), "message"))
    for dt in ("float32", "bfloat16"):
        for pool in (True, False):
            cases.append((f"message_feat {dt} train {'node' if pool else 'edge'}",
                          lambda o, p=pool: message_feat(*o, p),
                          lambda o, p=pool: message_feat_plain(*o, p),
                          lambda dt=dt: feat_ops(torch, getattr(torch, dt), *TRAIN), dt,
                          lambda o, _, p=pool: smoke.message_feat_cost(o, p), "message"))
    for dt in ("bfloat16", "float32"):
        d = getattr(torch, dt)
        cases.append((f"message_chain {dt} T1124 edge", lambda o: message_chain(*o),
                      lambda o: message_chain_plain(*o),
                      lambda d=d: fold_ops(torch, d, *T1124), dt, cost_of(erows, erows),
                      "message_chain"))
        cases.append((f"layer_node {dt} T1124", lambda o: layer_node(*o),
                      lambda o: layer_node_plain(*o),
                      lambda d=d: layer_ops(torch, d, *T1124, True), dt, cost_of(erows, nodes),
                      "layer_node"))
        cases.append((f"layer_edge {dt} T1124", lambda o: layer_edge(*o),
                      lambda o: layer_edge_plain(*o),
                      lambda d=d: layer_ops(torch, d, *T1124, False), dt, cost_of(erows, erows),
                      "layer_edge"))
    for label, dt, n in (("chain bfloat16 T1124 edge", "bfloat16", erows),
                         ("chain bfloat16 T1124 node", "bfloat16", nodes),
                         ("chain float32 train edge", "float32", TRAIN[0] * TRAIN[1] * TRAIN[2])):
        cases.append((label, lambda o: chain(*o, True), lambda o: chain_plain(*o, True),
                      lambda dt=dt, n=n: chain_ops(torch, getattr(torch, dt), n), dt,
                      lambda o, _: smoke.chain_cost(o), "chain_"))
    for label, fn, plain, make, dt, cost, key in cases:
        ops = make()
        got = fn(ops)
        err = (got.float() - plain(ops).float()).abs().max().item()
        nb, no = cost(ops, got)
        bound, by = smoke.bound_ms(nb, no, dt)
        digest = hashlib.sha256(got.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        out[label] = dict(ms=timer(lambda: fn(ops)),
                          kernel_ms=profiled_ms(torch, lambda: fn(ops), key),
                          bound_ms=bound, bound_by=by, max_abs_err=err,
                          digest=digest.hexdigest()[:16])
        del ops, got
        torch.cuda.empty_cache()
    out.update(pack_costs(torch, timer))
    if routings:
        smoke.phase_pack_variants(torch, names=routings)
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", type=Path)
    ap.add_argument("--variants", default="", help="comma-separated names of VARIANTS")
    ap.add_argument("--end-to-end", action="store_true",
                    help="also pack T1124 under the --routings and profile an evaluation, as "
                         "chip_smoke.py does")
    ap.add_argument("--routings", default="geom,fold,fused_layers",
                    help="comma-separated names of chip_smoke.VARIANTS for --end-to-end")
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        run_one(args.one, tuple(args.routings.split(",")) if args.end_to_end else ())
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
                              + ["--end-to-end", f"--routings={args.routings}"]
                              * args.end_to_end, capture_output=True, text=True)
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
                      f"{v['bound_ms']:.4f}, {v['bound_by']}), max|d| {v['max_abs_err']:.3g}, "
                      f"output sha256 {v['digest']}", flush=True)
    if failed:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
