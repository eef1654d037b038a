#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (packppi_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card
(sm_90a), the CUDA toolkit (nvcc) and PyTorch built for CUDA. Phases, each
fatal on failure:

1. versions: Python, torch, CUDA, nvcc, the card's name and power limit,
   and a content hash of the code (``packppi_torch/`` and this script);
2. build: every kernel of ``packppi_torch/csrc`` with nvcc for sm_90a, one
   nvcc per source, all started together;
3. kernels: each kernel against its plain PyTorch version on the card, on
   the T1124 complex's real graph and activations (L=768, K=32, H=128;
   node N=768 and edge N=24,576 rows), float32 and bf16, timed with CUDA
   events (L2 flushed before every launch). In bf16 two controls check
   that the tolerance can fail: the plain version without its rounding
   points, and the kernel's output with its first block's rows zeroed.
   The clash kernels (forward and gradient, float32) run on a clash-heavy
   T1124 conformation with a non-uniform cotangent: controls (a column
   tile dropped; the partner's weight left out of the gradient) must
   fail; culling on and off, and two runs of one launch, must agree bit
   for bit; B = 2 and a length that is no multiple of the tile are held
   too. Then the same check and times on 11 copies of T1124 (L = 8,151);
4. golden replay: the 1BRS float32 30-step trajectory through the kernels
   against the reference's ``tests/golden/pipeline_golden.npz`` (5e-4
   rad), and its 50-step proximal refinement (mask exact, losses 1e-4,
   chis 5e-4 rad, accept equal);
5. the full-length float32 T1124 edge features and network evaluation on
   the card against the same on the CPU;
6. the main paths: the bf16 T1124 30-step pack through the CLI entry point
   with the reference weights of ``pipeline_golden.npz``, with its time,
   peak memory and kernel launch counts (5 of each kernel per step); the
   same with ``--use_proximal`` (51 clash forward and 50 gradient
   launches more); and ``cli.prox`` on T1124's own side chains;
7. more bf16 T1124 samplings and proximal refinements for the latency
   distributions, and profiles of one network evaluation and of one Adam
   step of the refinement (device time by kernel, idle share).

It then prints the ``kernels`` JSON line, the card's name and power limit,
and ``{"ok": true, "device": {...}}`` as the last line.
"""
import hashlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
T1124 = REPO / "tests" / "fixtures" / "t1124.pdb"
ONE_BRS = REPO / "tests" / "fixtures" / "1brs.pdb"
PIPELINE_GOLDEN = REPO / "tests" / "golden" / "pipeline_golden.npz"
OUT = REPO / "smoke_out"

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}   # tensor-core bf16; fp32 FMA

# kernel vs plain version on the card: float32 max |d|; bf16 relative to
# max|ref|. The bf16 mean limit lies between the sound kernels' readings
# (<= 2.5e-7) and the plain versions without their rounding points (2.9e-4
# to 6.0e-4 here at T1124); the max limit rejects a dropped block's rows.
F32_TOL = 1e-4
BF16_MAX_REL, BF16_MEAN_REL = 2.0 ** -6, 2.0 ** -16
ROWS_PER_BLOCK = 64                     # csrc/tile.cuh kRows: edge rows per block
STEPS = 30
# clash kernels vs the plain version, float32 max |d|: the sums run in
# another order (readings here stay under 2e-6 at every size)
CLASH_FWD_TOL, CLASH_GRAD_TOL = 1e-5, 2e-5
CLASH_TOL_SOFT = 0.5                    # sc_violation_loss's overlap tolerance
PROX_STEPS = 50
# float32 operations per atom pair, for the bound: three differences, three
# squares and their sum with eps, the root, the reach, the overlap, mask and
# add (forward); plus the weight sum, the quotient and three products
CLASH_PAIR_OPS = {"clash_fwd": 17, "clash_bwd": 28}


def log(*a):
    print(*a, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def code_hash():
    """sha256 over the path and bytes of every source file of the port and
    of this script, so a printed number can be tied to the code it ran."""
    files = [f for f in (REPO / "packppi_torch").rglob("*")
             if f.is_file() and "_build" not in f.parts and "__pycache__" not in f.parts]
    h = hashlib.sha256()
    for f in sorted(files + [REPO / "chip_smoke.py"]):
        h.update(f.relative_to(REPO).as_posix().encode() + b"\0" + f.read_bytes())
    return h.hexdigest()


def phase_versions(torch):
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    nv = subprocess.run([nvcc, "--version"], capture_output=True, text=True, check=True).stdout
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"nvcc {nv.strip().splitlines()[-1]}")
    log(f"card: {card_line()}  ({torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} visible)")
    log(f"code: sha256 {code_hash()} (packppi_torch/ and chip_smoke.py)")


def phase_build():
    from packppi_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all(["message", "chain", "clash"])
    log(f"build: {time.perf_counter() - t0:.3f} s (nvcc, sm_90a, all sources in parallel)")
    for name in ("message", "chain", "clash"):
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


class Timer:
    """Mean CUDA-event time of one launch, with L2 flushed before each."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")   # 256 MB

    def __call__(self, fn, reps=20):
        torch = self.torch
        for _ in range(2):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            times.append((e0, e1))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in times) / reps


def _nbytes(t):
    return 0 if t is None else t.numel() * t.element_size()


def message_cost(ops, pool):
    """(bytes, operations) the message pass needs: every input read once,
    the output written once; the three products' multiply-adds."""
    per_i, per_j, h_E = ops[0], ops[1], ops[2]
    B, L, K, He = h_E.shape
    H = per_i.shape[-1]
    G = ops[7].shape[-1] * 3                           # 9P from pg's 3P
    out = B * L * H * 4 if pool else h_E.numel() // He * H * h_E.element_size()
    return (sum(_nbytes(t) for t in ops) + out,
            2 * B * L * K * (He + G + 2 * H) * H)


def chain_cost(ops):
    x = ops[0]
    N, H = x.shape
    return sum(_nbytes(t) for t in ops) + _nbytes(x), 2 * N * 2 * H * 4 * H


def bound_ms(nbytes, nops, dtype):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = nops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def readings(got, want):
    """max |d|, mean |d|, max|ref|"""
    d = (got.float() - want.float()).abs()
    return d.max().item(), d.mean().item(), want.float().abs().max().item()


def check_close(name, got, want, dtype):
    dmax, dmean, scale = readings(got, want)
    ok = bool(got.float().isfinite().all()) and (
        dmax <= F32_TOL if dtype == "float32"
        else dmax <= BF16_MAX_REL * scale and dmean <= BF16_MEAN_REL * scale)
    rel = f"  (/max|ref|: {dmax / scale:.3e}, {dmean / scale:.3e})" if dtype != "float32" else ""
    log(f"  {name}: max|d| {dmax:.6g}  mean|d| {dmean:.6g}  max|ref| {scale:.6g}{rel}  "
        f"{'ok' if ok else 'OUT OF TOLERANCE'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return dmax


def upcast(ops):
    """The operands with every bf16 tensor in float32: the plain versions
    then run with no bf16 rounding point."""
    return tuple(t.float() if t is not None and t.dtype.is_floating_point
                 and t.element_size() == 2 else t for t in ops)


def check_controls(name, got, want, unrounded, rows):
    """Two wrong answers the bf16 tolerance must reject: the plain version
    without its rounding points (mean limit), and the kernel's output with
    the first ``rows`` rows zeroed, as if a block were dropped (max limit)."""
    _, cmean, scale = readings(unrounded, want)
    dropped = got.clone().reshape(-1, got.shape[-1])
    dropped[:rows] = 0
    dmax, _, _ = readings(dropped, want.reshape(dropped.shape))
    log(f"    controls: unrounded mean|d|/max|ref| {cmean / scale:.3e} "
        f"(limit {BF16_MEAN_REL:.3e}); dropped block max|d|/max|ref| {dmax / scale:.3e} "
        f"(limit {BF16_MAX_REL:.3e})")
    if cmean <= 4 * BF16_MEAN_REL * scale or dmax <= BF16_MAX_REL * scale:
        fail(f"{name}: the bf16 tolerance does not reject its controls")


def t1124_network(torch, dtype_name, device):
    from packppi_torch.data import stack_batch
    from packppi_torch.models import ChiScoreNetwork, NetworkConfig
    from packppi_torch.structure import featurize, from_pdb_file
    from packppi_torch.weights import load_weights

    net = ChiScoreNetwork(NetworkConfig(compute_dtype=dtype_name)).eval()
    load_weights(net, PIPELINE_GOLDEN)
    feats = featurize(from_pdb_file(T1124, mse_to_met=True))
    return net.to(device), stack_batch([feats], device)


def phase_kernels(torch, timer):
    """Kernel vs plain version at T1124 shapes; returns per-(kernel, dtype,
    variant) records."""
    from packppi_torch.geometry import bb_frames_from_atom14
    from packppi_torch.models.ipmp import chain_operands
    from packppi_torch.ops.chain import chain, chain_plain
    from packppi_torch.ops.message import message, message_plain

    records = {}
    for dtype_name in ("float32", "bfloat16"):
        net, batch = t1124_network(torch, dtype_name, "cuda")
        with torch.no_grad():
            static = net.encode_static(batch)
            t = torch.full(batch.residue_mask.shape, 0.5, device="cuda")
            h_V = net.encoder.encode_nodes(batch.residue_type, batch.BB_D_sincos,
                                           batch.SC_D_sincos, t, net.cfg.dtype)
            layer = net.mpnn.mpnn_layers[0]
            frames = bb_frames_from_atom14(batch.X)
            for variant, pool, mlp, pts in (("node", True, layer.node_message_fn, layer.points_fn_node),
                                            ("edge", False, layer.edge_message_fn, layer.points_fn_edge)):
                ops = mlp.operands(h_V, static.h_E, static.idx, layer._points(pts, h_V), frames,
                                   static.mask_attend)
                got = message(*ops, pool)
                torch.cuda.synchronize()
                want = message_plain(*ops, pool)
                err = check_close(f"message {variant} {dtype_name} {tuple(got.shape)}",
                                  got, want, dtype_name)
                if dtype_name == "bfloat16":
                    check_controls(f"message {variant}", got, want,
                                   message_plain(*upcast(ops), pool).to(got.dtype),
                                   ROWS_PER_BLOCK // static.idx.shape[-1] if pool
                                   else ROWS_PER_BLOCK)
                nb, no = message_cost(ops, pool)
                records[("message", dtype_name, variant)] = dict(
                    max_abs_err=err, ms=timer(lambda: message(*ops, pool)),
                    plain_ms=timer(lambda: message_plain(*ops, pool)),
                    bound=bound_ms(nb, no, dtype_name))

                if pool:
                    cops = chain_operands(h_V, want, batch.residue_mask, layer.norm[0],
                                          layer.node_dense, layer.norm[1])
                else:
                    cops = chain_operands(static.h_E, want, static.mask_attend, layer.norm[2],
                                          layer.edge_dense, layer.norm[3])
                got = chain(*cops, not pool)
                torch.cuda.synchronize()
                cwant = chain_plain(*cops, not pool)
                err = check_close(f"chain {variant} {dtype_name} {tuple(got.shape)}",
                                  got, cwant, dtype_name)
                if dtype_name == "bfloat16":
                    check_controls(f"chain {variant}", got, cwant,
                                   chain_plain(*upcast(cops), not pool).to(got.dtype),
                                   ROWS_PER_BLOCK)
                nb, no = chain_cost(cops)
                records[("chain", dtype_name, variant)] = dict(
                    max_abs_err=err, ms=timer(lambda: chain(*cops, not pool)),
                    plain_ms=timer(lambda: chain_plain(*cops, not pool)),
                    bound=bound_ms(nb, no, dtype_name))
    for (k, d, v), r in records.items():
        log(f"  time {k} {v} {d}: kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
            f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]})")
    return records


def clash_inputs(torch, copies=1, padded=True, perturbed=True, seed=0):
    """(positions, exists, radius, residue_index) of T1124 on the card, on a
    clash-heavy conformation (chis perturbed by a seeded N(0, 0.8)) or the
    native one; ``copies`` > 1 lays that many copies 120 A apart along x with
    residue indices offset, as one complex."""
    import numpy as np

    from packppi_torch.data import stack_batch
    from packppi_torch.geometry import atom14_coords_from_torsions
    from packppi_torch.geometry.frames import chem_table
    from packppi_torch.structure import featurize, from_pdb_file

    feats = featurize(from_pdb_file(T1124, mse_to_met=True))
    b = stack_batch([feats], "cuda", target_len=None if padded else len(feats["residue_type"]))
    sc = b.SC_D
    if perturbed:
        noise = np.random.default_rng(seed).normal(0, 0.8, tuple(sc.shape)).astype(np.float32)
        sc = sc + torch.as_tensor(noise, device="cuda") * b.SC_D_mask
    with torch.no_grad():
        pos = atom14_coords_from_torsions(b.X, b.residue_type, b.BB_D, sc)
    ex = b.atom_mask
    rad = chem_table("vdw_radius_atom14", pos.device)[b.residue_type] * ex
    ridx = b.residue_index
    if copies > 1:
        shift = torch.zeros(copies, 1, 1, 3, device="cuda")
        shift[:, 0, 0, 0] = 120.0 * torch.arange(copies, device="cuda")
        pos = (pos + shift).reshape(1, -1, 14, 3)
        stride = int(ridx.max()) + 100
        ridx = (ridx + stride * torch.arange(copies, device="cuda")[:, None]).reshape(1, -1)
        ex, rad = ex.repeat(1, copies, 1), rad.repeat(1, copies, 1)
    return pos.contiguous(), ex.contiguous(), rad.contiguous(), ridx.contiguous()


def count_near_pairs(torch, pos, ex, reach, block=512):
    """Unordered pairs of existing atoms closer than ``reach``, counted by
    plain PyTorch in row blocks: the pairs the clash sums cannot do without."""
    p = pos.reshape(-1, 3)[ex.reshape(-1) > 0]
    n = 0
    for s in range(0, len(p), block):
        n += int((torch.cdist(p[s:s + block], p,
                              compute_mode="donot_use_mm_for_euclid_dist") < reach).sum())
    return (n - len(p)) // 2


def clash_cost(torch, name, ops, w=None):
    """(bytes, operations): every input read once, the output written once;
    the near pairs of this run's tensors at CLASH_PAIR_OPS each."""
    pos, ex, rad, ridx = ops
    out = _nbytes(pos) if name == "clash_bwd" else _nbytes(ex)
    reach = 2 * float(rad.max()) - CLASH_TOL_SOFT
    near = count_near_pairs(torch, pos[0], ex[0], reach) * pos.shape[0]
    return sum(_nbytes(t) for t in ops) + _nbytes(w) + out, near * CLASH_PAIR_OPS[name], near, reach


def plain_clash_and_grad(torch, ops, w):
    from packppi_torch.ops.clash import between_residue_clash_plain

    p = ops[0].clone().requires_grad_(True)
    per_atom = between_residue_clash_plain(p, *ops[1:], CLASH_TOL_SOFT)["per_atom_loss_sum"]
    (grad,) = torch.autograd.grad((per_atom * w).sum(), p)
    return per_atom.detach(), grad


def check_max(name, got, want, tol):
    d = (got - want).abs().max().item()
    ok = bool(got.isfinite().all()) and d <= tol
    log(f"  {name}: max|d| {d:.6g}  max|ref| {want.abs().max().item():.6g}  (limit {tol:g})  "
        f"{'ok' if ok else 'OUT OF TOLERANCE'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return d


def check_clash(torch, timer, label, ops, seed, reps, plain_reps):
    """Forward and gradient kernels against the plain version on ``ops``;
    the bit-for-bit checks; times, bound and the share of live tiles.
    Returns the two kernels' records."""
    import numpy as np

    from packppi_torch.ops import clash as C

    pos, ex, rad, ridx = ops
    B, L = pos.shape[:2]
    w = torch.as_tensor(np.random.default_rng(seed).uniform(0.1, 1.0, tuple(ex.shape))
                        .astype(np.float32), device="cuda") * ex
    want, want_g = plain_clash_and_grad(torch, ops, w)
    if not (want.sum().item() > 1.0 and want_g.abs().sum().item() > 1e-3):
        fail(f"{label}: the conformation does not clash; the check would be empty")

    nrow, ncol = -(-14 * L // C.ROWS_PER_BLOCK), -(-14 * L // C.COLS_PER_TILE)
    live = torch.zeros(B, nrow, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got, boxes = C.clash_forward_cuda(*ops, CLASH_TOL_SOFT, live_tiles=live)
    got_g = C.clash_backward_cuda(*ops, w, CLASH_TOL_SOFT, boxes=boxes)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    err = {"clash_fwd": check_max(f"clash forward {label} {tuple(got.shape)}", got, want,
                                  CLASH_FWD_TOL),
           "clash_bwd": check_max(f"clash gradient {label} {tuple(got_g.shape)}", got_g, want_g,
                                  CLASH_GRAD_TOL)}
    # bit for bit: culling off (dead tiles add exact zeros) and a second run
    same = {"forward, culling off": torch.equal(got, C.clash_forward_cuda(
                *ops, CLASH_TOL_SOFT, cull=False)[0]),
            "gradient, culling off": torch.equal(got_g, C.clash_backward_cuda(
                *ops, w, CLASH_TOL_SOFT, cull=False)),
            "forward, second run": torch.equal(got, C.clash_forward_cuda(*ops, CLASH_TOL_SOFT)[0]),
            "gradient, second run": torch.equal(got_g, C.clash_backward_cuda(
                *ops, w, CLASH_TOL_SOFT))}
    share = live.sum().item() / (B * nrow * ncol)
    log(f"    bit-identical: {same}; live tiles {live.sum().item()} of {B * nrow * ncol} "
        f"({share:.4f}); kernels' peak memory {peak:.2f} MiB")
    if not all(same.values()):
        fail(f"{label}: clash kernels are not bit-identical: {same}")

    records = {}
    fns = {"clash_fwd": (lambda: C.clash_forward_cuda(*ops, CLASH_TOL_SOFT),
                         lambda: C.clash_forward_cuda(*ops, CLASH_TOL_SOFT, cull=False),
                         lambda: C.between_residue_clash_plain(*ops, CLASH_TOL_SOFT)),
           "clash_bwd": (lambda: C.clash_backward_cuda(*ops, w, CLASH_TOL_SOFT, boxes=boxes),
                         lambda: C.clash_backward_cuda(*ops, w, CLASH_TOL_SOFT, cull=False,
                                                       boxes=boxes),
                         lambda: plain_clash_and_grad(torch, ops, w))}
    for name, (kernel, uncut, plain) in fns.items():
        nb, no, near, reach = clash_cost(torch, name, ops, w if name == "clash_bwd" else None)
        with torch.no_grad() if name == "clash_fwd" else torch.enable_grad():
            records[name] = dict(max_abs_err=err[name], ms=timer(kernel, reps),
                                 uncut_ms=timer(uncut, reps), plain_ms=timer(plain, plain_reps),
                                 bound=bound_ms(nb, no, "float32"))
        r = records[name]
        log(f"  time {name} {label}: kernel {r['ms']:.4f} ms  culling off {r['uncut_ms']:.4f} ms  "
            f"plain {r['plain_ms']:.4f} ms{' (forward and backward)' if name == 'clash_bwd' else ''}"
            f"  bound {r['bound'][0]:.6f} ms ({r['bound'][1]}; {nb} bytes, {near} pairs under "
            f"{reach:.2f} A at {CLASH_PAIR_OPS[name]} operations; all pairs A^2/2 = "
            f"{(14 * L) ** 2 // 2 * B})")
    return records, (want, want_g, w)


def phase_clash_kernels(torch, timer):
    """The clash kernels at T1124 shapes (L = 768, A = 10,752) and at 11
    copies of T1124 (L = 8,151, A = 114,114); returns the T1124 records."""
    from packppi_torch.ops import clash as C

    ops = clash_inputs(torch)
    records, (want, want_g, w) = check_clash(torch, timer, "T1124", ops, 1, 20, 3)

    # two wrong answers the tolerances must reject, made with the plain
    # version: one column tile's atoms dropped; the partner's weight w_b
    # left out of the gradient (each pair then weighs w_a alone, which is
    # half the gradient of the unweighted sum times w_a)
    pos, ex, rad, ridx = ops
    tile = (14 * pos.shape[1] // C.COLS_PER_TILE) // 2
    ex_drop = ex.clone().reshape(ex.shape[0], -1)
    ex_drop[:, tile * C.COLS_PER_TILE:(tile + 1) * C.COLS_PER_TILE] = 0
    dropped = C.between_residue_clash_plain(pos, ex_drop.reshape(ex.shape), rad, ridx,
                                            CLASH_TOL_SOFT)["per_atom_loss_sum"]
    d_drop = (dropped - want).abs().max().item()
    _, g_unit = plain_clash_and_grad(torch, ops, torch.ones_like(w))
    d_wb = (0.5 * w[..., None] * g_unit - want_g).abs().max().item()
    log(f"    controls: column tile {tile} dropped max|d| {d_drop:.4g} (limit {CLASH_FWD_TOL:g}); "
        f"w_b left out max|d| {d_wb:.4g} (limit {CLASH_GRAD_TOL:g})")
    if d_drop <= 100 * CLASH_FWD_TOL or d_wb <= 100 * CLASH_GRAD_TOL:
        fail("the clash tolerances do not reject their controls")

    # B = 2, two conformations: each row equals its own single run, bit for bit
    native = clash_inputs(torch, perturbed=False)
    two = tuple(torch.cat([a, b]).contiguous() for a, b in zip(ops, native))
    w2 = torch.cat([w, w.flip(1)]).contiguous()
    got2, boxes2 = C.clash_forward_cuda(*two, CLASH_TOL_SOFT)
    grad2 = C.clash_backward_cuda(*two, w2, CLASH_TOL_SOFT, boxes=boxes2)
    want2, want_g2 = plain_clash_and_grad(torch, two, w2)
    check_max("clash forward B=2", got2, want2, CLASH_FWD_TOL)
    check_max("clash gradient B=2", grad2, want_g2, CLASH_GRAD_TOL)
    rows_ok = (torch.equal(got2[:1], C.clash_forward_cuda(*ops, CLASH_TOL_SOFT)[0])
               and torch.equal(got2[1:], C.clash_forward_cuda(*native, CLASH_TOL_SOFT)[0])
               and torch.equal(grad2[1:], C.clash_backward_cuda(*native, w2[1:].contiguous(),
                                                                CLASH_TOL_SOFT)))
    log(f"    B=2 rows equal their single runs bit for bit: {rows_ok}")
    if not rows_ok:
        fail("clash kernels: the rows of a batch are not independent")

    # a length that is no multiple of either tile (741 residues, 10,374 atoms)
    ragged = clash_inputs(torch, padded=False)
    wr = w[:, :ragged[0].shape[1]].contiguous()
    want_r, want_gr = plain_clash_and_grad(torch, ragged, wr)
    got_r, boxes_r = C.clash_forward_cuda(*ragged, CLASH_TOL_SOFT)
    check_max(f"clash forward L={ragged[0].shape[1]}", got_r, want_r, CLASH_FWD_TOL)
    check_max(f"clash gradient L={ragged[0].shape[1]}",
              C.clash_backward_cuda(*ragged, wr, CLASH_TOL_SOFT, boxes=boxes_r), want_gr,
              CLASH_GRAD_TOL)

    large = clash_inputs(torch, copies=11, padded=False)
    large_records, _ = check_clash(torch, timer, "11xT1124", large, 2, 20, 1)
    for name, r in large_records.items():
        records[name]["large"] = r
    return records


def phase_prox_golden(torch):
    """The reference's 50-step proximal refinement of its own 1BRS sample,
    replayed through the clash kernels."""
    import numpy as np

    from packppi_torch.data import stack_batch
    from packppi_torch.ops.clash import between_residue_clash as brc
    from packppi_torch.sampling import proximal_optimize
    from packppi_torch.structure import featurize, from_pdb_file

    golden = np.load(PIPELINE_GOLDEN)
    feats = featurize(from_pdb_file(ONE_BRS, mse_to_met=True))
    batch = stack_batch([feats], "cuda", target_len=len(feats["residue_type"]))
    f0, b0 = brc.launches_fwd, brc.launches_bwd
    res = proximal_optimize(batch, torch.as_tensor(golden["final_sc"], device="cuda"),
                            12.0, 0.5, 1.0, PROX_STEPS)
    if (brc.launches_fwd - f0, brc.launches_bwd - b0) != (PROX_STEPS + 1, PROX_STEPS):
        fail("proximal golden replay did not run through the clash kernels")
    mask_ok = np.array_equal(res.clash_mask.cpu().numpy(), golden["clash_mask"].astype(bool))
    losses = res.losses.cpu().numpy()
    d_loss = np.abs(losses - golden["prox_losses"]).max()
    valid = batch.SC_D_mask[0].cpu().numpy() > 0
    d = np.abs(res.SC_D[0].cpu().numpy() - golden["prox_final_sc"][0])
    d_sc = np.minimum(d, 2 * np.pi - d)[valid].max()
    accepted = bool(losses[-1] < losses[0])
    log(f"proximal golden replay (1BRS, {PROX_STEPS} steps, kernels): clash mask equal {mask_ok}, "
        f"losses max|d| {d_loss:.3e} (bound 1e-4), chis {d_sc:.3e} rad (bound 5e-4), accepted "
        f"{accepted} (reference {bool(golden['accepted'])})")
    if not mask_ok:
        # a residue at the mean threshold may fall on the other side on the card
        from packppi_torch.ops.clash import compute_residue_clash
        from packppi_torch.sampling.proximal import _row_mean

        with torch.no_grad():
            prc = compute_residue_clash(batch, torch.as_tensor(golden["final_sc"], device="cuda"))
            margin = (prc - _row_mean(prc, batch.residue_mask)[:, None])[0].cpu().numpy()
        for r in np.nonzero(res.clash_mask[0, :, 0].cpu().numpy()
                            != golden["clash_mask"][0, :, 0].astype(bool))[0]:
            log(f"    residue {r}: clash minus the mean {margin[r]:.3e}")
        fail("proximal golden replay selects other residues than the reference")
    if not (d_loss < 1e-4 and d_sc < 5e-4 and accepted == bool(golden["accepted"])):
        fail("proximal golden replay out of tolerance")


def phase_golden(torch):
    import numpy as np

    from packppi_torch.data import stack_batch
    from packppi_torch.models import NetworkConfig, TorsionalDiffusion
    from packppi_torch.ops.chain import chain
    from packppi_torch.ops.message import message
    from packppi_torch.structure import featurize, from_pdb_file
    from packppi_torch.weights import load_weights

    golden = np.load(PIPELINE_GOLDEN)
    feats = featurize(from_pdb_file(ONE_BRS, mse_to_met=True))
    batch = stack_batch([feats], "cuda", target_len=len(feats["residue_type"]))
    model = TorsionalDiffusion(NetworkConfig())
    load_weights(model.net, PIPELINE_GOLDEN)
    model.to("cuda")
    m0, c0 = message.launches, chain.launches
    sc, traj = model.sample(batch, init_sc=golden["init_sc"], return_trajectory=True)
    if message.launches - m0 != 5 * STEPS or chain.launches - c0 != 5 * STEPS:
        fail("golden replay did not run through the kernels")
    mask = batch.SC_D_mask[0].cpu().numpy() > 0
    wrap = lambda d: np.minimum(np.abs(d), 2 * np.pi - np.abs(d))
    worst = max(wrap(traj[s, 0].cpu().numpy() - golden["traj"][s, 0])[mask].max()
                for s in range(STEPS))
    final = wrap(sc[0].cpu().numpy() - golden["final_sc"][0])[mask].max()
    log(f"golden replay (1BRS, float32, {STEPS} steps, kernels): worst step {worst:.3e} rad, "
        f"final {final:.3e} rad (bound 5e-4)")
    if not (worst < 5e-4 and final < 5e-4):
        fail("golden replay out of tolerance")


def check_edge_features(torch, nets, statics):
    """Each device's own kNN graph and float32 edge features, edge by edge,
    on the rows whose neighbour sets agree (near-ties at the K-th distance
    may differ). An edge may differ only where a raw pairwise dihedral sits
    at its +-pi wrap, where one device reads +pi and the other -pi (or 0,
    when the normals' dot rounds past -1): the encoder feeds that angle raw."""
    import math

    per_device = {}
    for d, st in statics.items():
        net, batch = nets[d]
        idx, order = st.idx.cpu().sort(-1)
        X = batch.X
        dihed = net.encoder._pairwise_dihedrals(X[:, :, 0], X[:, :, 1], X[:, :, 2], st.idx)
        per_device[d] = (idx[0], torch.take_along_dim(st.h_E.float().cpu(), order[..., None], -2)[0],
                         torch.take_along_dim(dihed.cpu(), order[..., None], -2)[0])
    (i_card, e_card, a_card), (i_cpu, e_cpu, a_cpu) = per_device["cuda"], per_device["cpu"]
    valid = nets["cpu"][1].residue_mask[0].cpu() > 0
    same = (i_card == i_cpu).all(-1) & valid
    d_edge = (e_card - e_cpu).abs().amax(-1)[same]                       # [rows, K]
    a_card, a_cpu, i_same = a_card[same], a_cpu[same], i_cpu[same]
    differs = d_edge > 1e-3
    at_wrap = ((torch.maximum(a_card.abs(), a_cpu.abs()) > math.pi - 1e-3)
               & ((a_card - a_cpu).abs() > 1e-3)).any(-1)
    log(f"T1124 float32 edge features, card vs CPU, each on its own graph: kNN rows whose "
        f"sets differ {int((~same & valid).sum())} of {int(valid.sum())}; of the "
        f"{d_edge.numel()} edges of the other rows, {int(differs.sum())} differ by > 1e-3 "
        f"({int((differs & at_wrap).sum())} at the dihedral wrap); max|d| over the rest "
        f"{d_edge[~differs].max().item():.3e}")
    rows = same.nonzero()[:, 0]
    for r, k in differs.nonzero()[:10].tolist():
        log(f"    edge ({int(rows[r])}, {int(i_same[r, k])}): max|d| {d_edge[r, k].item():.3g}  "
            f"raw phi/psi card {a_card[r, k].tolist()}  CPU {a_cpu[r, k].tolist()}")
    if (differs & ~at_wrap).any():
        fail("card and CPU edge features differ away from the dihedral wrap")


def phase_network_vs_cpu(torch):
    """The same float32 T1124 edge features (``check_edge_features``) and
    network evaluation on the card (kernels) and the CPU (plain versions).
    Both network evaluations read the CPU's graph, so that comparison holds
    the network alone."""
    from packppi_torch.models.diffusion_net import StaticGraph

    nets = {d: t1124_network(torch, "float32", d) for d in ("cuda", "cpu")}
    with torch.no_grad():
        statics = {d: net.encode_static(b) for d, (net, b) in nets.items()}
        check_edge_features(torch, nets, statics)
        g = torch.Generator().manual_seed(0)
        sc = nets["cpu"][1].SC_D + torch.randn(nets["cpu"][1].SC_D.shape, generator=g)
        results = {}
        for d, (net, batch) in nets.items():
            static = StaticGraph(*(t.to(d) for t in statics["cpu"]))
            t = torch.full(batch.residue_mask.shape, 0.5, device=d)
            score, h = net(batch, sc.to(d), t, static=static, skip_last_edge_update=True)
            results[d] = (score.cpu(), h.cpu())
    ds = (results["cuda"][0] - results["cpu"][0]).abs().max().item()
    dh = (results["cuda"][1] - results["cpu"][1]).abs().max().item()
    log(f"T1124 float32 network, card vs CPU on the CPU's graph: score max|d| {ds:.3e}, "
        f"h_V max|d| {dh:.3e} (bound 1e-3)")
    if not (ds < 1e-3 and dh < 1e-3):
        fail("card and CPU networks disagree")


def zero_launches():
    from packppi_torch.ops.chain import chain
    from packppi_torch.ops.clash import between_residue_clash as brc
    from packppi_torch.ops.message import message

    message.launches = chain.launches = brc.launches_fwd = brc.launches_bwd = 0


def read_launches():
    from packppi_torch.ops.chain import chain
    from packppi_torch.ops.clash import between_residue_clash as brc
    from packppi_torch.ops.message import message

    return {"message": message.launches, "chain": chain.launches,
            "clash_fwd": brc.launches_fwd, "clash_bwd": brc.launches_bwd}


def check_structure(outdir):
    import numpy as np

    from packppi_torch.structure import from_pdb_file

    inp = from_pdb_file(T1124, mse_to_met=True)
    out = from_pdb_file(outdir / "structure.pdb")
    if (len(out.aaindex) != len(inp.aaindex) or not np.array_equal(out.aaindex, inp.aaindex)
            or not np.isfinite(out.atom_positions[out.atom_mask > 0]).all()):
        fail("written structure does not match the input's residues or is not finite")
    log(f"  wrote {outdir / 'structure.pdb'}: {len(out.aaindex)} residues, finite")


def phase_pack(torch):
    """The main paths through their CLI entry points on T1124: the bf16
    30-step pack, the same with the proximal refinement, and the standalone
    refinement of the input's own side chains. Counts are set to 0 before
    each and read after it; returns the second run's."""
    from packppi_torch.cli import pack, prox

    common = ["--input", str(T1124), "--ckpt", str(PIPELINE_GOLDEN), "--precision", "bfloat16",
              "--n_steps", str(STEPS), "--seed", "0"]
    expect = {"message": 5 * STEPS, "chain": 5 * STEPS, "clash_fwd": 0, "clash_bwd": 0}
    launches = None
    for name, extra in (("pack_t1124", []), ("pack_prox_t1124", ["--use_proximal"])):
        args = pack.build_parser().parse_args(common + ["--outdir", str(OUT / name)] + extra)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        t0 = time.perf_counter()
        metrics = pack.run(args)
        wall = time.perf_counter() - t0
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        log(f"pack T1124 bf16 {STEPS} steps {' '.join(extra)}: sampling "
            f"{metrics['sampling_seconds']:.4f} s, whole run {wall:.3f} s, peak memory "
            f"{peak:.1f} MiB, launches {launches}")
        if extra:
            expect.update(clash_fwd=PROX_STEPS + 1, clash_bwd=PROX_STEPS)
            log(f"  proximal {metrics['proximal_seconds']:.4f} s, objective "
                f"{metrics['proximal_objective_initial']:.6f} -> "
                f"{metrics['proximal_objective_final']:.6f}, accepted "
                f"{metrics['proximal_accepted']}")
        if launches != expect:
            fail(f"pack {extra}: launches {launches}, expected {expect}")
        check_structure(OUT / name)

    args = prox.build_parser().parse_args(["--input", str(T1124), "--outdir",
                                           str(OUT / "prox_t1124")])
    zero_launches()
    result = prox.run(args)
    got = read_launches()
    log(f"prox T1124 (input's own side chains, {PROX_STEPS} steps): "
        f"{result['optimize_seconds']:.4f} s, objective {result['objective_initial']:.6f} -> "
        f"{result['objective_final']:.6f}, accepted {result['accepted']}, launches {got}")
    if got != {"message": 0, "chain": 0, "clash_fwd": PROX_STEPS + 1, "clash_bwd": PROX_STEPS}:
        fail(f"prox: launches {got}")
    check_structure(OUT / "prox_t1124")
    return launches


def phase_latency(torch, reps=5, prox_reps=10):
    """Repeated bf16 T1124 30-step samplings and 50-step proximal
    refinements (of the last sample) after the counted runs: the latency
    distributions the single CLI runs cannot give."""
    import numpy as np

    from packppi_torch.data import stack_batch
    from packppi_torch.models import NetworkConfig, TorsionalDiffusion
    from packppi_torch.structure import featurize, from_pdb_file
    from packppi_torch.weights import load_weights

    model = TorsionalDiffusion(NetworkConfig(compute_dtype="bfloat16"))
    load_weights(model.net, PIPELINE_GOLDEN)
    model.to("cuda")
    batch = stack_batch([featurize(from_pdb_file(T1124, mse_to_met=True))], "cuda")
    times = []
    for seed in range(reps):
        g = torch.Generator(device="cuda").manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sc = model.sample(batch, g, n_steps=STEPS)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if not bool(torch.isfinite(sc).all()):
            fail("non-finite chis in a repeated pack")
    q = np.percentile(times, [0, 25, 50, 75, 100])
    log(f"pack latency T1124 bf16 {STEPS} steps, {reps} runs: median {q[2]:.4f} s, "
        f"quartiles {q[1]:.4f}-{q[3]:.4f} s, min {q[0]:.4f} s, max {q[4]:.4f} s")

    from packppi_torch.sampling import proximal_optimize

    times = []
    for _ in range(prox_reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = proximal_optimize(batch, sc, num_steps=PROX_STEPS).losses.tolist()
        times.append(time.perf_counter() - t0)
        if not all(map(np.isfinite, losses)):
            fail("non-finite objective in a repeated proximal refinement")
    q = np.percentile(times, [0, 25, 50, 75, 100])
    log(f"proximal latency T1124 {PROX_STEPS} steps, {prox_reps} runs: median {q[2]:.4f} s, "
        f"quartiles {q[1]:.4f}-{q[3]:.4f} s, min {q[0]:.4f} s, max {q[4]:.4f} s "
        f"(objective {losses[0]:.6f} -> {losses[-1]:.6f})")
    return sc


def report_profile(what, prof, wall_ms, reps, unit):
    dev = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
    # kernel events only: an operator's own device time repeats its kernels',
    # and so does a host annotation mirrored on the device (Optimizer.step)
    events = prof.key_averages()
    host_names = {e.key for e in events if not str(e.device_type).endswith("CUDA")}
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")
               and e.key not in host_names and not getattr(e, "is_user_annotation", False)]
    rows = sorted((e for e in kernels if dev(e) > 0), key=dev, reverse=True)
    busy_ms = sum(dev(e) for e in rows) / reps / 1e3
    if not rows:
        log(f"profile: {what} {wall_ms:.4f} ms wall; device time not measured "
            "(the profiler recorded none)")
        return
    log(f"profile: {what} {wall_ms:.4f} ms wall, device busy {busy_ms:.4f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.3f}, {sum(e.count for e in rows) / reps:.0f} device "
        f"operations/{unit}")
    for e in rows[:10]:
        log(f"  {dev(e) / reps / 1e3:8.4f} ms  {e.count / reps:6.1f} calls/{unit}  {e.key[:90]}")


def phase_profile(torch, sc):
    """Where one bf16 T1124 network evaluation, and one Adam step of the
    T1124 proximal refinement of the sample ``sc``, spend device time: the
    profiler's device time by kernel, against the wall time measured
    without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from packppi_torch.sampling import proximal_optimize

    net, batch = t1124_network(torch, "bfloat16", "cuda")
    reps = 10
    with torch.no_grad():
        static = net.encode_static(batch)
        t = torch.full(batch.residue_mask.shape, 0.5, device="cuda")
        evaluate = lambda: net(batch, batch.SC_D, t, static=static, skip_last_edge_update=True)
        for _ in range(3):
            evaluate()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            evaluate()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / reps * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                evaluate()
            torch.cuda.synchronize()
    report_profile("bf16 T1124 network evaluation", prof, wall_ms, reps, "eval")

    # the refinement: its steps are alike, so a run of `reps` steps (and the
    # one forward pass that picks the residues) stands for one step
    refine = lambda: proximal_optimize(batch, sc, num_steps=reps).losses.tolist()
    refine()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    refine()
    wall_ms = (time.perf_counter() - t0) / reps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        refine()
        torch.cuda.synchronize()
    report_profile("T1124 proximal Adam step", prof, wall_ms, reps, "step")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import packppi_torch  # noqa: F401  (fails outside a checkout)

    phase_versions(torch)
    phase_build()
    timer = Timer(torch)
    records = phase_kernels(torch, timer)
    clash_records = phase_clash_kernels(torch, timer)
    phase_golden(torch)
    phase_prox_golden(torch)
    phase_network_vs_cpu(torch)
    launches = phase_pack(torch)
    sc = phase_latency(torch)
    phase_profile(torch, sc)

    kernels = []
    for name, source, replaces in (
            ("message", "packppi_torch/csrc/message.cu", "packppi_tpu/ops/pallas_ipmp.py:249"),
            ("chain", "packppi_torch/csrc/chain.cu", "packppi_tpu/ops/pallas_layer.py:62"),
            ("clash_fwd", "packppi_torch/csrc/clash.cu", "packppi_tpu/ops/pallas_clash.py:132"),
            ("clash_bwd", "packppi_torch/csrc/clash.cu", "packppi_tpu/ops/pallas_clash.py:272")):
        # the main path's dtype and larger pass; the clash kernels at T1124
        r = clash_records[name] if name in clash_records else records[(name, "bfloat16", "edge")]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": None})
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
