#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (packppi_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card
(sm_90a), the CUDA toolkit (nvcc) and PyTorch built for CUDA. Phases, each
fatal on failure:

1. versions: Python, torch, CUDA, nvcc, the card's name and power limit,
   and a content hash of the code (``packppi_torch/`` and this script);
2. build: every kernel of ``packppi_torch/csrc`` (six sources) with nvcc
   for sm_90a, one nvcc per source, all started together; ptxas's lines
   (registers, shared memory, spills) of the sources with tensor-core
   kernels (attention, chain, layer, message, message_feat) and the
   registers and spills of the others;
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
   for bit; the kernels' tile boxes and lists of live tiles must equal
   the plain culling's and list every tile pair that holds an overlapping
   pair; B = 2 and a length that is no multiple of the tile are held
   too. Then the same check and times on 11 copies of T1124 (L = 8,151).
   The feature-message kernel runs at the training shape (4 copies of
   T1124 padded to L = 1,024: 131,072 edge rows) and at L = 741, node and
   edge, float32 and bf16 with the same two controls, and row for row
   against the geometry-in-kernel message kernel on the same features; the
   chain kernel after it at the same shape (4,096 node and 131,072 edge
   rows), timed. The chain and attention kernels' times come with their
   achieved TFLOP/s and share of the bound. The
   two differentiable passes (feature-message and chain: kernel forward,
   recomputed plain backward) are held, gradient by gradient, to autograd
   through their plain versions. The attention kernel runs at ESM-2 650M's
   shapes (H = 20, D = 64): T1124's T = 896, T = 768, B = 2 at T = 763 and
   T = 2,048, float32 (max |d| <= 1e-5) and bf16 with the two controls (the
   weights left unrounded; one query tile zeroed), bit for bit across two
   launches, timed beside ``scaled_dot_product_attention``. The 3xTF32
   GEMM runs ESM-2 650M's maps after the attention with their epilogues
   (bias, GELU, residual) and the query, key and value through its heads
   epilogue at M = 1,280, 1,920 and 4,480 rows, float32, within 2e-6 of
   max|ref| of the float64 product (plain TF32, the control, must fail),
   bit for bit across two launches, timed beside ``F.linear``. The five
   kernels of the variant routings (``message_geom``, ``message_gather``,
   ``message_chain``, ``layer_node``, ``layer_edge``) run on T1124's graph
   and activations, node and edge, float32 and bf16 with the two controls,
   timed beside their plain versions; the gathered-operand and
   in-kernel-gather routes are held against the message kernel, the folded
   edge pass against message then chain (bit for bit: both run one
   tensor-core message body and one chain body in the same form), the node
   pass at 2, 4, 8 and 16 nodes a block (bit for bit); the gather route at
   11 x T1124 (L = 8,151), the fold at K = 24, the layer passes at L = 741;
   the SASS of the gathered-operand message kernel's, the fold's and the
   layer passes' kernels (tensor-core products: HGMMA in bf16, HMMA in
   float32); every activation of the table (``NetworkConfig.act``, a
   library per activation built with the rest) on the message and chain
   kernels at T1124, node and edge, float32 and bf16, each timed beside
   relu, and gelu on the five variant kernels and the feature-message
   kernel;
4. golden replay: the 1BRS float32 30-step trajectory through the kernels
   against the reference's ``tests/golden/pipeline_golden.npz`` (5e-4
   rad), again under each variant routing (``geom``, ``geom_gather``, the
   folded edge chain, ``fused_layers``, local geometry) with its launch
   counts, and its 50-step proximal refinement (mask exact, losses 1e-4,
   chis 5e-4 rad, accept equal);
5. the full-length float32 T1124 edge features and network evaluation on
   the card against the same on the CPU;
6. the main paths: the bf16 T1124 30-step pack through the CLI entry point
   with the reference weights of ``pipeline_golden.npz``, with its time,
   peak memory and kernel launch counts (5 of each kernel per step); the
   same with ``--use_proximal`` (51 clash forward and 50 gradient
   launches more) and with ``--corrector_steps 1`` (10 of each a step),
   each with its metric suite (the JAX CLI's ``metrics.json`` keys, finite,
   equal to ``get_metric`` recomputed on the CPU from the written PDB, its
   host seconds); and ``cli.prox`` on T1124's own side chains with both
   clashscores; directory mode on a corpus of T1124, 1BRS, 2FTL and five
   crops of 72 and 96 residues (bucket 96, its last chunk padded): every
   message and chain call of one evaluation of each bucket-96 chunk, row
   by row, against the same kernel on the row alone, and the chunk's rows
   against each complex alone and against a batch of its copies (bf16 and
   float32, with a control that must fail); ``cli.pack --input <corpus>
   --batch_size 4 --n_samples 2 --use_proximal --metrics`` with its
   launches per chunk (150 message, 150 chain, 52 clash forward, 50
   gradient), one finite record per input, the accept flags and the
   throughput end to end, again at ``--batch_size 1`` and without
   ``--metrics``, a profile of the
   batch-4 run (idle share per chunk), and ``cli.prox --input <corpus>
   --batch_size 4`` (51 and 50 a chunk) with its clashscores; the bf16
   T1124 pack under each variant routing (``TorsionalDiffusion.sample``
   for the four kernel routings, ``cli.pack --geometry local``) with launch
   counts, sampling seconds (median of five more), peak memory and a
   profile of one network evaluation, and each routing's float32 T1124
   network evaluation against the default routing's (1e-4);
7. more bf16 T1124 samplings and proximal refinements for the latency
   distributions, and profiles of one network evaluation and of one Adam
   step of the refinement (device time by kernel, idle share);
8. one whole training loss at B = 2, L = 256: the configuration that trains
   through the kernels against the unfused one, and the card against the
   CPU, loss and every parameter gradient;
9. training at full width: 20 float32 steps and 5 in bf16 compute at B = 4,
   L = 1,024 with random weights from a seed; 5 feature-message and 5 chain
   launches asserted in every step, finite losses, a falling loss on a
   fixed draw, a poisoned batch that must change nothing bit for bit, the
   step's time, peak memory and profile;
10. the trainer end to end: the crop corpus from 1BRS and 2FTL,
    ``cli.train_diffusion`` for one epoch and resumed for a second,
    ``cli.pack`` with its checkpoint; the network options at full width:
    the bf16 T1124 pack with ``act="gelu"`` (150 and 150 launches) against
    the unfused route, a float32 gelu evaluation card against CPU,
    ``cli.train_diffusion trainer=debug model.act=gelu`` with the kernel
    knobs; T1124 packs with the bfloat16 and int8 edge caches (within
    0.01 rad of the float32 cache's in float32 compute; the caches' bytes);
    the vanilla stack (``use_ipmp=False``): a float32 T1124 pack with no
    launch, card against CPU, one ``cli.train_affinity`` step; the native
    parser's library built and loaded, its T1124 parse and 2FTL's delta-SASA
    interface timed; and T1124 packed with the shipped
    checkpoint ``docs/ckpts/diffusion_crops/torch_state.pt``, with its chi
    accuracies;
11. PackPPI-AP: ESM-2 650M at full width with random weights from seed 0 on
    T1124's wild type and LA10A mutant through ``make_extractor`` (33
    attention launches per extraction asserted; time per extraction, peak
    memory; the card against the CPU on the same weights and tokens);
    ``cli.ddg --mode esm`` on T1124 through a weight file written from the
    same weights (33 launches: wild type and mutant in one forward, a
    finite ddG); ``cli.ddg --eval_csv`` on the
    126 SKEMPI mutations in network mode with the converted shipped
    checkpoints, message and chain launches counted, each prediction held
    to the JAX package's ``ddg_eval.jsonl`` (2e-3 kcal/mol);
12. the unfused route: ``cli.pack --no_fused`` on T1124 (bf16, 30 steps,
    the metric suite) with no kernel launch at all, and one T1124 network
    evaluation under it against the kernel route (float32 1e-3, bf16
    6e-2), each route's wall, busy and idle share;
13. PackPPI-AP training: ``cli.train_affinity`` for one epoch at the
    published widths on ``skempi_mini`` fold 0 (94 + 32 mutations, batch 2,
    float32, the shipped backbone) with its launches (10 message and 10
    chain a step, 20 and 20 a validation batch), the backbone artifact
    through ``cli.ddg`` giving the run's validation metrics, one training
    step's wall, busy, idle share and peak memory, and one step under the
    knobs configuration against the unfused route (loss and gradients);
    esm mode on 4 + 4 mutations through ESM-2 650M (33 attention launches
    a mutation: wild type and mutant in one forward);
14. the server: ``cli.serve`` in a thread, warmed with T1124, driven over
    HTTP (``/healthz``; ``/pack`` of T1124 with 2 samples, the refinement
    and metrics: 150 / 150 / 52 / 50 launches; ``/prox``: 51 / 50;
    ``/ddg`` of 2FTL KI15G within 2e-3 kcal/mol of the shipped JAX
    prediction), first and warm latencies, and two concurrent seeded
    ``/pack`` requests equal to their lone answers; any answer but 200
    fails;
15. multi-device (``packppi_torch.parallel``), ranks on the one card (their
    times are no scaling measurement): a world of one over NCCL (the dry
    run; a training step through the mesh code against the step without a
    mesh: equal losses, parameters as close as two one-device steps); two
    ranks sharing ``cuda:0`` over gloo (the best-of-4 bf16 T1124 pack with
    ``--use_proximal``, 150 + 150 launches a rank, the same winner and chis
    as one device; a float32 DP training step at B = 2 a rank against one
    device at B = 4, loss 1e-5 relative and every gradient at the card vs
    CPU limits; ESM-2 650M under tensor parallelism at T = 896, 33
    attention and 132 gemm launches a rank on 10 heads, 1e-4 of max|ref|;
    directory mode at ``--batch_size 2`` against one device at 4); three
    ranks (ESM-2 650M over 3 pipeline stages, M = 2, 22 attention and 88
    gemm launches a stage, 1e-4);
    four ranks, 2 x 2 (the eight-stage dry run; ``cli.train_diffusion``
    with FSDP for an epoch and a resume, its checkpoint trained on one
    device). Every rank reports its wall, peak memory, launches and the
    time of each process-group call.

It then prints the ``kernels`` JSON line, the card's name and power limit,
and ``{"ok": true, "device": {...}}`` as the last line.
"""
import functools
import hashlib
import json
import math
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
# bf16 on the tensor cores; float32-accurate products on the tensor cores
# (3xTF32: three TF32 products, 495 TFLOP/s, for each), the least time the
# card needs for them whatever computes them (the FMA units' 67 TFLOP/s is
# slower), so no kernel can read above 100% of its bound
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 495e12 / 3}

# kernel vs plain version on the card: float32 max |d| (readings up to
# 1.34e-5, the message kernels' float32 edge pass on T1124, whose products
# are 3xTF32 on tensor cores; plain TF32 would read about 1e-3); bf16
# relative to max|ref|. The bf16 mean limit lies between the sound kernels' readings
# (<= 2.5e-7) and the plain versions without their rounding points (2.9e-4
# to 6.0e-4 here at T1124); the max limit rejects a dropped block's rows.
F32_TOL = 2e-5
BF16_MAX_REL, BF16_MEAN_REL = 2.0 ** -6, 2.0 ** -16
ROWS_PER_BLOCK = 64                     # csrc/tile.cuh kRows: edge rows per block
STEPS = 30
# clash kernels vs the plain version, float32 max |d|: the sums run in
# another order (readings here stay under 2e-6 at every size)
CLASH_FWD_TOL, CLASH_GRAD_TOL = 1e-5, 2e-5
CLASH_TOL_SOFT = 0.5                    # sc_violation_loss's overlap tolerance
PROX_STEPS = 50
SOURCES = ("message", "message_feat", "chain", "clash", "attention", "layer", "gemm")
# products on tensor cores (csrc/mma.cuh): every ptxas line of these is printed
TENSOR_CORE_SOURCES = ("attention", "chain", "layer", "message", "message_feat", "gemm")
# the training shape: 4 copies of T1124 padded to 1,024 residues (131,072 edge rows)
TRAIN_B, TRAIN_L = 4, 1024
# the two differentiable passes: each gradient against autograd through the
# plain version, relative to that gradient's max (the reference tests' limit)
GRAD_REL_TOL = 5e-4
# one whole loss, card against CPU: a parameter whose gradient is hundreds of
# times smaller than the network's largest (a first-layer bias behind a
# LayerNorm: a sum over all edge rows of terms that cancel) shows the two
# devices' float32 summation orders at up to 7.5e-4 of its own max, so each
# parameter is held to 2e-3 of its max there, and every difference to 2e-4 of
# the largest gradient max of the network (readings 4.7e-6 on one device,
# 4.3e-5 between the two)
GRAD_REL_TOL_DEVICES, GRAD_GLOBAL_TOL = 2e-3, 2e-4
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

    # every activation's message and chain libraries; gelu's of the
    # feature-message and whole-layer sources (rows 3 and 6)
    act_builds = [_build.lib_name(s, a) for a in _build.ACTS[1:] for s in ("message", "chain")]
    act_builds += [_build.lib_name("message_feat", "gelu"), _build.lib_name("layer", "gelu")]
    wide = width_builds()
    t0 = time.perf_counter()
    _build.build_all([*SOURCES, *act_builds, *wide])
    log(f"build: {time.perf_counter() - t0:.3f} s (nvcc, sm_90a, {len(SOURCES)} sources, "
        f"{len(act_builds)} activation libraries and {len(wide)} width libraries in parallel)")
    for name in [*SOURCES, *act_builds, *wide]:
        for line in _build.build_log(name).splitlines():
            # every ptxas line (entry, registers, shared memory, spills) of the
            # tensor-core kernels; registers and spills of the others
            if ("registers" in line or "spill" in line or "Performance Loss" in line
                    or (name in TENSOR_CORE_SOURCES and "ptxas" in line)):
                log(f"  {name}: {line.strip()}")


class Timer:
    """Mean CUDA-event time of one launch, with L2 flushed before each. A
    spin of the card after the flush keeps it busy while the host prepares
    the launch, so the wrapper's host time does not show up as idle time
    between the two events."""

    SPIN_CYCLES = 1_000_000        # about 0.5 ms at the H100's clock

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
            torch.cuda._sleep(self.SPIN_CYCLES)
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


def message_feat_cost(ops, pool):
    """(bytes, operations) of the feature-message pass: per_i, pj, h_E, geom,
    mask and the weights read once, the output written once."""
    per_i, pj, h_E, geom = ops[:4]
    B, L, K, He = h_E.shape
    H = per_i.shape[-1]
    out = B * L * H * 4 if pool else pj.numel() * pj.element_size()
    return (sum(_nbytes(t) for t in ops) + out,
            2 * B * L * K * (He + geom.shape[-1] + 2 * H) * H)


def chain_cost(ops):
    x = ops[0]
    N, H = x.shape
    return sum(_nbytes(t) for t in ops) + _nbytes(x), 2 * N * 2 * H * 4 * H


def bound_ms(nbytes, nops, dtype):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = nops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def rate_line(r):
    """Achieved TFLOP/s and share of the bound of one timed record."""
    return (f"{r['operations'] / (r['ms'] * 1e-3) / 1e12:.2f} TFLOP/s, "
            f"{100 * r['bound'][0] / r['ms']:.1f}% of bound")


def readings(got, want):
    """max |d|, mean |d|, max|ref|"""
    d = (got.float() - want.float()).abs()
    return d.max().item(), d.mean().item(), want.float().abs().max().item()


def check_close(name, got, want, dtype, mean_rel=BF16_MEAN_REL):
    dmax, dmean, scale = readings(got, want)
    ok = bool(got.float().isfinite().all()) and (
        dmax <= F32_TOL if dtype == "float32"
        else dmax <= BF16_MAX_REL * scale and dmean <= mean_rel * scale)
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


def check_controls(name, got, want, unrounded, rows, mean_rel=BF16_MEAN_REL):
    """Two wrong answers the bf16 tolerance must reject: the plain version
    without its rounding points (mean limit), and the kernel's output with
    the first ``rows`` rows zeroed, as if a block were dropped (max limit)."""
    _, cmean, scale = readings(unrounded, want)
    dropped = got.clone().reshape(-1, got.shape[-1])
    dropped[:rows] = 0
    dmax, _, _ = readings(dropped, want.reshape(dropped.shape))
    log(f"    controls: unrounded mean|d|/max|ref| {cmean / scale:.3e} "
        f"(limit {mean_rel:.3e}); dropped block max|d|/max|ref| {dmax / scale:.3e} "
        f"(limit {BF16_MAX_REL:.3e})")
    if cmean <= 4 * mean_rel * scale or dmax <= BF16_MAX_REL * scale:
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
                    bound=bound_ms(nb, no, dtype_name), operations=no)

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
                    bound=bound_ms(nb, no, dtype_name), operations=no)
    for (k, d, v), r in records.items():
        rate = f"; {rate_line(r)}"
        log(f"  time {k} {v} {d}: kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
            f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]}{rate})")
    return records


def t1124_train_batch(device, copies=TRAIN_B, target_len=TRAIN_L):
    from packppi_torch.data import stack_batch
    from packppi_torch.structure import featurize, from_pdb_file

    feats = featurize(from_pdb_file(T1124, mse_to_met=True))
    return stack_batch([feats] * copies, device, target_len=target_len)


def layer0_state(torch, net, batch):
    """(static graph, h_V, layer 0, frames) of ``net`` on ``batch`` at t = 0.5."""
    from packppi_torch.geometry import bb_frames_from_atom14

    static = net.encode_static(batch)
    t = torch.full(batch.residue_mask.shape, 0.5, device=batch.X.device)
    h_V = net.encoder.encode_nodes(batch.residue_type, batch.BB_D_sincos, batch.SC_D_sincos, t,
                                   net.cfg.dtype)
    return static, h_V, net.mpnn.mpnn_layers[0], bb_frames_from_atom14(batch.X)


def phase_message_feat(torch, timer):
    """The feature-message kernel against its plain version at the training
    shape (B = 4, L = 1,024, K = 32: 131,072 edge rows), node and edge,
    float32 and bf16 with the two controls; row for row against the
    geometry-in-kernel message kernel on the same features; and at a length
    that no block divides (one T1124, L = 741). Returns the records."""
    from packppi_torch.ops.message import message
    from packppi_torch.ops.message_feat import message_feat, message_feat_plain

    records = {}
    for dtype_name in ("float32", "bfloat16"):
        net, _ = t1124_network(torch, dtype_name, "cuda")
        for label, batch in (("train", t1124_train_batch("cuda")),
                             ("L=741", t1124_train_batch("cuda", 1, 741))):
            with torch.no_grad():
                static, h_V, layer, frames = layer0_state(torch, net, batch)
                for variant, pool, mlp, pts in (
                        ("node", True, layer.node_message_fn, layer.points_fn_node),
                        ("edge", False, layer.edge_message_fn, layer.points_fn_edge)):
                    args = (h_V, static.h_E, static.idx, layer._points(pts, h_V), frames,
                            static.mask_attend)
                    ops = mlp.feat_operands(*args)
                    got = message_feat(*ops, pool)
                    torch.cuda.synchronize()
                    want = message_feat_plain(*ops, pool)
                    name = f"message_feat {variant} {dtype_name} {label} {tuple(got.shape)}"
                    err = check_close(name, got, want, dtype_name)
                    # the other message kernel computes the same function
                    check_close(f"  against the message kernel, {variant} {dtype_name} {label}",
                                got, message(*mlp.operands(*args), pool), dtype_name)
                    if label != "train":
                        continue
                    if dtype_name == "bfloat16":
                        check_controls(name, got, want,
                                       message_feat_plain(*upcast(ops), pool).to(got.dtype),
                                       ROWS_PER_BLOCK // static.idx.shape[-1] if pool
                                       else ROWS_PER_BLOCK)
                    nb, no = message_feat_cost(ops, pool)
                    records[("message_feat", dtype_name, variant)] = dict(
                        max_abs_err=err, ms=timer(lambda: message_feat(*ops, pool)),
                        plain_ms=timer(lambda: message_feat_plain(*ops, pool), 5),
                        bound=bound_ms(nb, no, dtype_name), bytes=nb, operations=no)
                    # the chain after this message, as a training step runs it
                    records[("chain", dtype_name, f"train {variant}")] = train_chain(
                        torch, timer, layer, h_V, static, batch, want, pool, dtype_name)
    for (k, d, v), r in records.items():
        rate = f"; {rate_line(r)}"
        log(f"  time {k} {v} {d} B={TRAIN_B} L={TRAIN_L}: kernel {r['ms']:.4f} ms  plain "
            f"{r['plain_ms']:.4f} ms  bound {r['bound'][0]:.4f} ms ({r['bound'][1]}; "
            f"{r['bytes']} bytes, {r['operations']} operations{rate})")
    return records


def train_chain(torch, timer, layer, h_V, static, batch, msg, pool, dtype_name):
    """The chain kernel against its plain version at the training shape
    (node: 4,096 rows, edge: 131,072), with its time, bound and rate."""
    from packppi_torch.models.ipmp import chain_operands
    from packppi_torch.ops.chain import chain, chain_plain

    if pool:
        cops = chain_operands(h_V, msg, batch.residue_mask, layer.norm[0], layer.node_dense,
                              layer.norm[1])
    else:
        cops = chain_operands(static.h_E, msg, static.mask_attend, layer.norm[2],
                              layer.edge_dense, layer.norm[3])
    got = chain(*cops, not pool)
    torch.cuda.synchronize()
    err = check_close(f"chain {'node' if pool else 'edge'} {dtype_name} B={TRAIN_B} "
                      f"L={TRAIN_L} {tuple(got.shape)}", got, chain_plain(*cops, not pool),
                      dtype_name)
    nb, no = chain_cost(cops)
    return dict(max_abs_err=err, ms=timer(lambda: chain(*cops, not pool)),
                plain_ms=timer(lambda: chain_plain(*cops, not pool), 5),
                bound=bound_ms(nb, no, dtype_name), bytes=nb, operations=no)


def grads_of(torch, fn, ops, cot):
    """Gradients of ``0.5 * sum(cot * fn(ops)^2)`` with respect to every
    floating operand that is not a mask (those carry requires_grad here)."""
    leaves = [t.detach().clone().requires_grad_(True) if g else t for t, g in ops]
    out = fn(*leaves)
    loss = 0.5 * (cot * out.float() ** 2).sum()
    return torch.autograd.grad(loss, [t for t, (_, g) in zip(leaves, ops) if g])


def check_grads(torch, what, names, got, want):
    worst = 0.0
    for name, g, w in zip(names, got, want):
        scale = w.float().abs().max().item()
        rel = (g.float() - w.float()).abs().max().item() / max(scale, 1e-30)
        worst = max(worst, rel)
        if not (bool(g.isfinite().all()) and rel <= GRAD_REL_TOL):
            fail(f"{what}: gradient of {name} off by {rel:.3e} of its max {scale:.3e} "
                 f"(limit {GRAD_REL_TOL:g})")
    log(f"  {what}: {len(names)} gradients, worst max|d|/max|ref| {worst:.3e} "
        f"(limit {GRAD_REL_TOL:g})")


def phase_function_grads(torch):
    """The two differentiable passes on the card in float32: the Function's
    gradients (kernel forward, recomputed plain backward) against autograd
    through the plain version, for every operand, at the training shape."""
    import numpy as np

    from packppi_torch.models.ipmp import chain_operands
    from packppi_torch.ops.chain import chain, chain_plain
    from packppi_torch.ops.message_feat import message_feat, message_feat_plain

    net, _ = t1124_network(torch, "float32", "cuda")
    batch = t1124_train_batch("cuda")
    rng = np.random.default_rng(0)
    cot_like = lambda t: torch.as_tensor(rng.uniform(0.5, 1.5, tuple(t.shape)).astype(np.float32),
                                         device="cuda")
    with torch.no_grad():
        static, h_V, layer, frames = layer0_state(torch, net, batch)
    m_names = ("per_i", "pj", "h_E", "geom", "w_in", "b_in", "w_mid", "b_mid", "w_out", "b_out")
    c_names = ("x", "msg", "lna_w", "lna_b", "w1", "b1", "w2", "b2", "lnb_w", "lnb_b")
    for variant, pool, mlp, pts in (("node", True, layer.node_message_fn, layer.points_fn_node),
                                    ("edge", False, layer.edge_message_fn, layer.points_fn_edge)):
        with torch.no_grad():
            ops = mlp.feat_operands(h_V, static.h_E, static.idx, layer._points(pts, h_V), frames,
                                    static.mask_attend)
            msg = message_feat_plain(*ops, pool)
        tagged = [(t, i != 4) for i, t in enumerate(ops)]           # operand 4 is the mask
        cot = cot_like(msg)
        m0 = message_feat.launches
        got = grads_of(torch, lambda *a: message_feat(*a, pool), tagged, cot)
        if message_feat.launches != m0 + 1:
            fail("message_feat's gradient did not launch the kernel once in its forward")
        want = grads_of(torch, lambda *a: message_feat_plain(*a, pool), tagged, cot)
        check_grads(torch, f"message_feat {variant} gradients", m_names, got, want)

        if pool:
            cops = chain_operands(h_V, msg, batch.residue_mask, layer.norm[0], layer.node_dense,
                                  layer.norm[1])
        else:
            cops = chain_operands(static.h_E, msg, static.mask_attend, layer.norm[2],
                                  layer.edge_dense, layer.norm[3])
        tagged = [(t, i != 2) for i, t in enumerate(cops)]          # operand 2 is the mask
        cot = cot_like(cops[0])
        c0 = chain.launches
        got = grads_of(torch, lambda *a: chain(*a, not pool), tagged, cot)
        if chain.launches != c0 + 1:
            fail("chain's gradient did not launch the kernel once in its forward")
        want = grads_of(torch, lambda *a: chain_plain(*a, not pool), tagged, cot)
        check_grads(torch, f"chain {variant} gradients", c_names, got, want)
        padded = cops[2] == 0
        if not bool(got[0][padded].eq(0).all()):
            fail(f"chain {variant}: masked rows carry a gradient into x")


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

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got, culling = C.clash_forward_cuda(*ops, CLASH_TOL_SOFT)
    got_g = C.clash_backward_cuda(*ops, w, CLASH_TOL_SOFT, culling=culling)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    err = {"clash_fwd": check_max(f"clash forward {label} {tuple(got.shape)}", got, want,
                                  CLASH_FWD_TOL),
           "clash_bwd": check_max(f"clash gradient {label} {tuple(got_g.shape)}", got_g, want_g,
                                  CLASH_GRAD_TOL)}
    check_culling(torch, label, ops, culling)
    # bit for bit: culling off (dead tiles add exact zeros) and a second run
    got_uncut, uncut = C.clash_forward_cuda(*ops, CLASH_TOL_SOFT, cull=False)
    same = {"forward, culling off": torch.equal(got, got_uncut),
            "gradient, culling off": torch.equal(got_g, C.clash_backward_cuda(
                *ops, w, CLASH_TOL_SOFT, culling=uncut)),
            "forward, second run": torch.equal(got, C.clash_forward_cuda(*ops, CLASH_TOL_SOFT)[0]),
            "gradient, second run": torch.equal(got_g, C.clash_backward_cuda(
                *ops, w, CLASH_TOL_SOFT))}
    T = culling.counts.shape[-1]
    listed = int(culling.counts.sum())
    log(f"    bit-identical: {same}; listed tile pairs {listed} of {B * T * T} "
        f"({listed / (B * T * T):.4f}); kernels' peak memory {peak:.2f} MiB")
    if not all(same.values()):
        fail(f"{label}: clash kernels are not bit-identical: {same}")

    records = {}
    fns = {"clash_fwd": (lambda: C.clash_forward_cuda(*ops, CLASH_TOL_SOFT),
                         lambda: C.clash_forward_cuda(*ops, CLASH_TOL_SOFT, cull=False),
                         lambda: C.between_residue_clash_plain(*ops, CLASH_TOL_SOFT)),
           "clash_bwd": (lambda: C.clash_backward_cuda(*ops, w, CLASH_TOL_SOFT, culling=culling),
                         lambda: C.clash_backward_cuda(*ops, w, CLASH_TOL_SOFT, culling=uncut),
                         lambda: plain_clash_and_grad(torch, ops, w))}
    for name, (kernel, uncut_fn, plain) in fns.items():
        nb, no, near, reach = clash_cost(torch, name, ops, w if name == "clash_bwd" else None)
        with torch.no_grad() if name == "clash_fwd" else torch.enable_grad():
            records[name] = dict(max_abs_err=err[name], ms=timer(kernel, reps),
                                 uncut_ms=timer(uncut_fn, reps),
                                 plain_ms=timer(plain, plain_reps),
                                 bound=bound_ms(nb, no, "float32"),
                                 pair_tests=culling.pair_tests())
        r = records[name]
        log(f"  time {name} {label}: kernel {r['ms']:.4f} ms  culling off {r['uncut_ms']:.4f} ms  "
            f"plain {r['plain_ms']:.4f} ms{' (forward and backward)' if name == 'clash_bwd' else ''}"
            f"  bound {r['bound'][0]:.6f} ms ({r['bound'][1]}; {nb} bytes, {near} pairs under "
            f"{reach:.2f} A at {CLASH_PAIR_OPS[name]} operations; all pairs A^2/2 = "
            f"{(14 * L) ** 2 // 2 * B}); pair tests a launch {r['pair_tests']} "
            f"({listed} tile pairs x 1,024; culling off {uncut.pair_tests()})")
    return records, (want, want_g, w)


def check_culling(torch, label, ops, culling):
    """The kernels' boxes and lists against the plain culling on the same
    tensors (bit for bit), and every tile pair that holds an overlapping pair
    listed."""
    from packppi_torch.ops import clash as C

    boxes, tiles, counts = C.clash_tiles_plain(*ops[:3], CLASH_TOL_SOFT)
    n = torch.arange(tiles.shape[-1], device="cuda") < counts[..., None]
    same = (torch.equal(culling.boxes, boxes) and torch.equal(culling.counts, counts)
            and torch.equal(culling.tiles[n], tiles[n]))
    _, overlap = C.tiled_clash_plain(*ops, CLASH_TOL_SOFT)
    missed = int((overlap & ~C.listed_tile_pairs(culling.tiles, culling.counts)).sum())
    log(f"    culling: boxes and lists equal the plain culling's: {same}; tile pairs holding an "
        f"overlapping pair {int(overlap.sum())}, not listed {missed}")
    if not same or missed or not overlap.any():
        fail(f"{label}: the clash kernels' culling disagrees with its plain version")


def phase_clash_kernels(torch, timer):
    """The clash kernels at T1124 shapes (L = 768, A = 10,752) and at 11
    copies of T1124 (L = 8,151, A = 114,114); returns the T1124 records."""
    from packppi_torch.ops import clash as C

    ops = clash_inputs(torch)
    records, (want, want_g, w) = check_clash(torch, timer, "T1124", ops, 1, 20, 3)

    # two wrong answers the tolerances must reject, made with the plain
    # version: the atoms of one column tile (the one holding the atom with
    # the largest clash sum) dropped; the partner's weight w_b left out of
    # the gradient (each pair then weighs w_a alone, which is half the
    # gradient of the unweighted sum times w_a)
    pos, ex, rad, ridx = ops
    tile = int(want.reshape(-1).argmax()) // C.TILE
    ex_drop = ex.clone().reshape(ex.shape[0], -1)
    ex_drop[:, tile * C.TILE:(tile + 1) * C.TILE] = 0
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
    got2, culling2 = C.clash_forward_cuda(*two, CLASH_TOL_SOFT)
    grad2 = C.clash_backward_cuda(*two, w2, CLASH_TOL_SOFT, culling=culling2)
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
    got_r, culling_r = C.clash_forward_cuda(*ragged, CLASH_TOL_SOFT)
    check_max(f"clash forward L={ragged[0].shape[1]}", got_r, want_r, CLASH_FWD_TOL)
    check_max(f"clash gradient L={ragged[0].shape[1]}",
              C.clash_backward_cuda(*ragged, wr, CLASH_TOL_SOFT, culling=culling_r), want_gr,
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
            static = StaticGraph(*(t.to(d) for t in statics["cpu"][:3]))
            t = torch.full(batch.residue_mask.shape, 0.5, device=d)
            score, h = net(batch, sc.to(d), t, static=static, skip_last_edge_update=True)
            results[d] = (score.cpu(), h.cpu())
    ds = (results["cuda"][0] - results["cpu"][0]).abs().max().item()
    dh = (results["cuda"][1] - results["cpu"][1]).abs().max().item()
    log(f"T1124 float32 network, card vs CPU on the CPU's graph: score max|d| {ds:.3e}, "
        f"h_V max|d| {dh:.3e} (bound 1e-3)")
    if not (ds < 1e-3 and dh < 1e-3):
        fail("card and CPU networks disagree")


_LAUNCH_BASE = {}


def zero_launches():
    """Count launches from here on (``read_launches``)."""
    from packppi_torch.utils.trace import counters

    _LAUNCH_BASE.update(counters())


def read_launches():
    from packppi_torch.utils.trace import counters

    return {name: n - _LAUNCH_BASE.get(name, 0) for name, n in counters().items()}


def expect_launches(**counts):
    """Every kernel's expected count: the given ones, 0 for the rest."""
    from packppi_torch.utils.trace import counters

    return {name: counts.get(name, 0) for name in counters()}


def check_structure(outdir):
    import numpy as np

    from packppi_torch.structure import from_pdb_file

    inp = from_pdb_file(T1124, mse_to_met=True)
    out = from_pdb_file(outdir / "structure.pdb")
    if (len(out.aaindex) != len(inp.aaindex) or not np.array_equal(out.aaindex, inp.aaindex)
            or not np.isfinite(out.atom_positions[out.atom_mask > 0]).all()):
        fail("written structure does not match the input's residues or is not finite")
    log(f"  wrote {outdir / 'structure.pdb'}: {len(out.aaindex)} residues, finite")


# metrics.json of cli.pack: the JAX CLI's key set, and the port's proximal keys
METRIC_KEYS = ({f"chi_{i}_{m}" for i in range(4) for m in ("ae_rad", "ae_deg", "acc")}
               | {"total_acc", "interface_acc", "atom_rmsd", "clashscore",
                  "clashscore_is_exact", "sampling_seconds"})
PROXIMAL_KEYS = {"proximal_seconds", "proximal_accepted", "proximal_objective_initial",
                 "proximal_objective_final"}


def check_metric_suite(metrics, outdir, proximal):
    """metrics.json against the JAX CLI's key set, every value finite, and
    the suite equal to ``get_metric`` recomputed on the CPU from the written
    PDB; returns that recomputation's host seconds."""
    from packppi_torch.utils.analysis import ProteinAnalysis

    want = METRIC_KEYS | (PROXIMAL_KEYS if proximal else set())
    if set(metrics) != want:
        fail(f"metrics.json keys {sorted(set(metrics) ^ want)} differ from the JAX CLI's")
    if json.loads((outdir / "metrics.json").read_text()) != metrics:
        fail("metrics.json differs from what cli.pack returned")
    exact = metrics["clashscore_is_exact"]
    if not (type(exact) is float and exact == 0.0):
        fail("clashscore_is_exact is not 0.0 (a float, as the JAX CLI writes it) without the "
             "MolProbity binary")
    bad = [k for k, v in metrics.items() if not isinstance(v, bool) and not math.isfinite(v)]
    if bad:
        fail(f"non-finite metrics {bad}")
    t0 = time.perf_counter()
    again = ProteinAnalysis(tmp_dir=str(outdir / "recheck")).get_metric(
        str(T1124), str(outdir / "structure.pdb"))
    host = time.perf_counter() - t0
    differ = [k for k, v in again.items() if metrics[k] != v]
    if differ:
        fail(f"metrics {differ} differ from get_metric on the written structure")
    log(f"  metric suite: {host:.4f} s on the host (get_metric recomputed on the CPU from the "
        f"written PDB: equal), beside sampling {metrics['sampling_seconds']:.4f} s on the card; "
        f"total_acc {metrics['total_acc']:.4f}, interface_acc {metrics['interface_acc']:.4f}, "
        f"atom_rmsd {metrics['atom_rmsd']:.4f}, clashscore {metrics['clashscore']:.4f}")
    return host


def phase_pack(torch):
    """The main paths through their CLI entry points on T1124: the bf16
    30-step pack, the same with the proximal refinement and with one
    corrector step, each with its metric suite, and the standalone
    refinement of the input's own side chains with its clashscores. Counts
    are set to 0 before each and read after it; returns the proximal run's."""
    from packppi_torch.cli import pack, prox

    common = ["--input", str(T1124), "--ckpt", str(PIPELINE_GOLDEN), "--precision", "bfloat16",
              "--n_steps", str(STEPS), "--seed", "0"]
    plain = expect_launches(message=5 * STEPS, chain=5 * STEPS)
    runs = (("pack_t1124", [], plain),
            ("pack_prox_t1124", ["--use_proximal"],
             dict(plain, clash_fwd=PROX_STEPS + 1, clash_bwd=PROX_STEPS)),
            ("pack_corrector_t1124", ["--corrector_steps", "1"],
             expect_launches(message=10 * STEPS, chain=10 * STEPS)))
    result = None
    for name, extra, expect in runs:
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
            f"{metrics['sampling_seconds']:.4f} s, whole run {wall:.3f} s (metric suite "
            f"included), peak memory {peak:.1f} MiB, launches {launches}")
        if "--use_proximal" in extra:
            result = launches
            log(f"  proximal {metrics['proximal_seconds']:.4f} s, objective "
                f"{metrics['proximal_objective_initial']:.6f} -> "
                f"{metrics['proximal_objective_final']:.6f}, accepted "
                f"{metrics['proximal_accepted']}")
        if launches != expect:
            fail(f"pack {extra}: launches {launches}, expected {expect}")
        check_structure(OUT / name)
        check_metric_suite(metrics, OUT / name, "--use_proximal" in extra)

    args = prox.build_parser().parse_args(["--input", str(T1124), "--outdir",
                                           str(OUT / "prox_t1124")])
    zero_launches()
    out = prox.run(args)
    got = read_launches()
    log(f"prox T1124 (input's own side chains, {PROX_STEPS} steps): "
        f"{out['optimize_seconds']:.4f} s, objective {out['objective_initial']:.6f} -> "
        f"{out['objective_final']:.6f}, accepted {out['accepted']}, clashscore "
        f"{out['clashscore_before']} -> {out['clashscore_after']}, launches {got}")
    if got != expect_launches(clash_fwd=PROX_STEPS + 1, clash_bwd=PROX_STEPS):
        fail(f"prox: launches {got}")
    if not all(isinstance(out[k], float) and math.isfinite(out[k])
               for k in ("clashscore_before", "clashscore_after")):
        fail("cli.prox gave no finite clashscores")
    check_structure(OUT / "prox_t1124")
    return result


# directory mode: a corpus of T1124, 1BRS, 2FTL and crops of 1BRS and 2FTL
# of 72 and 96 residues (bucket 96; (source, size, crop centre)), named so
# that every chunk of two holds both lengths and the last is a padded tail
DIR_CROPS = (("1brs", 72, 0), ("1brs", 96, 40), ("2ftl", 72, 0), ("2ftl", 96, 60),
             ("2ftl", 72, 120))
DIR_BATCH, DIR_SAMPLES = 4, 2


def directory_corpus():
    """Writes the corpus; returns its directory and the bucket-96 members'
    paths in the order directory mode takes them."""
    from packppi_torch.data.crops import spatial_crops, take_residues
    from packppi_torch.structure import from_pdb_file, to_pdb

    d = OUT / "corpus"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for src in (T1124, ONE_BRS, REPO / "tests" / "fixtures" / "2ftl.pdb"):
        shutil.copy(src, d / src.name)
    members = []
    for k, (name, size, centre) in enumerate(DIR_CROPS):
        prot = from_pdb_file(REPO / "tests" / "fixtures" / f"{name}.pdb", mse_to_met=True)
        path = d / f"c{k}_{name}_{size}.pdb"
        path.write_text(to_pdb(take_residues(prot, dict(spatial_crops(prot, size, 20))[centre])))
        members.append(path)
    return d, members


def unmask_padding(batch, r, L):
    """Row r with its padding made real: a copy of its first residues,
    shifted 0.5 A, in the padded slots, and residue_mask 1 there."""
    n = batch.X.shape[1] - L
    X, rm = batch.X.clone(), batch.residue_mask.clone()
    X[r, L:] = X[r, :n] + 0.5
    rm[r, L:] = 1.0
    return batch._replace(X=X, residue_mask=rm)


def kernel_rows(torch, calls, B):
    """Each recorded message / chain call of one evaluation of a B-row
    batch, row by row, against the same kernel on that row's slice of the
    same inputs: (name, worst max|d|/max|ref|, all bits equal) per call."""
    from packppi_torch.ops.chain import chain
    from packppi_torch.ops.message import message

    out = []
    for name, a, got in calls:
        worst, same = 0.0, True
        for r in range(B):
            if name == "message":
                one, row = message(*(x[r:r + 1] for x in a[:9]), *a[9:]), got[r:r + 1]
            else:
                s = slice(r * (len(a[0]) // B), (r + 1) * (len(a[0]) // B))
                one = chain(a[0][s], a[1][s], None if a[2] is None else a[2][s], *a[3:])
                row = got[s]
            dmax, _, scale = readings(row, one)
            worst = max(worst, dmax / scale)
            same = same and bool(torch.equal(row, one))
        out.append((name, worst, same))
    return out


def check_mixed_bucket(torch, members):
    """Directory mode's chunks of bucket 96 as ``run_chunks`` lays them out
    (two complexes of two rows each, the tail padded with repeats), with the
    reference weights, in bf16 and float32, on one draw of chis and times:

    - every message and chain kernel call of one network evaluation, row by
      row, against the same kernel on that row's slice of its inputs: the
      message kernel and the bf16 chain bit for bit, the float32 chain
      within 2e-5 (its LayerNorm sums group by the launch's tile height);
    - the evaluation's rows against each complex alone at B = 1 padded to
      96: float32 within 2e-5; bf16, where the float32 GEMMs outside the
      kernels (cuBLAS picks its algorithm by the row count) move single
      roundings, within twice the distance (max and mean) of the bf16
      evaluation of that complex alone from its float32 evaluation, as two
      bf16 evaluations of equal accuracy are;
    - each row equal, bit for bit, to the same row of a batch of as many
      copies of its complex: a row depends on the batch's shape, never on
      what the other rows hold;
    - a row with its padding unmasked must fail both."""
    from packppi_torch.data import stack_batch
    from packppi_torch.models import ChiScoreNetwork, NetworkConfig, ipmp
    from packppi_torch.structure import featurize, from_pdb_file
    from packppi_torch.weights import load_weights

    feats = [featurize(from_pdb_file(p, mse_to_met=True)) for p in members]
    per_chunk = DIR_BATCH // DIR_SAMPLES
    nets = {}
    for dtype in ("bfloat16", "float32"):
        nets[dtype] = ChiScoreNetwork(NetworkConfig(compute_dtype=dtype)).eval()
        load_weights(nets[dtype], PIPELINE_GOLDEN)
        nets[dtype].to("cuda")
    message, chain = ipmp.message, ipmp.chain
    g = torch.Generator(device="cuda").manual_seed(0)
    bad_rows = []
    for s in range(0, len(feats), per_chunk):
        chunk = feats[s:s + per_chunk]
        rows = [f for f in chunk + [chunk[-1]] * (per_chunk - len(chunk))
                for _ in range(DIR_SAMPLES)]
        B, lengths = len(rows), [len(f["residue_type"]) for f in rows]
        batch = stack_batch(rows, "cuda", target_len=96)
        sc = (torch.rand(batch.SC_D.shape, device="cuda", generator=g) * 6 - 3) * batch.SC_D_mask
        t = torch.linspace(0.2, 0.9, B, device="cuda")[:, None].expand(-1, 96).contiguous()
        c = lengths.index(min(lengths))
        out, want, ctl, per_call, copies = {}, {}, {}, {}, {}
        with torch.no_grad():
            for dtype, net in nets.items():
                calls = []
                record = lambda fn, name: lambda *a: calls.append((name, a, fn(*a))) or calls[-1][2]
                zero_launches()
                ipmp.message, ipmp.chain = record(message, "message"), record(chain, "chain")
                try:
                    out[dtype] = net(batch, sc, t, skip_last_edge_update=True)[0]
                finally:
                    ipmp.message, ipmp.chain = message, chain
                got = read_launches()
                if got != expect_launches(message=5, chain=5):
                    fail(f"mixed bucket: launches {got}")
                per_call[dtype] = kernel_rows(torch, calls, B)
                want[dtype] = [net(stack_batch([rows[r]], "cuda", target_len=96), sc[r:r + 1],
                                   t[r:r + 1], skip_last_edge_update=True)[0][0]
                               for r in range(B)]
                ctl[dtype] = net(unmask_padding(batch, c, lengths[c]), sc, t,
                                 skip_last_edge_update=True)[0][c]
                # the same row count filled with copies of row r's complex
                copies[dtype] = [bool(torch.equal(out[dtype][r], net(
                    stack_batch([rows[r]] * B, "cuda", target_len=96),
                    sc[r:r + 1].expand(B, -1, -1).contiguous(),
                    t[r:r + 1].expand(B, -1).contiguous(), skip_last_edge_update=True)[0][0]))
                    for r in range(B)]
        for dtype in nets:
            for name, worst, same in per_call[dtype]:
                if ((name == "message" or dtype == "bfloat16") and not same) or worst > F32_TOL:
                    fail(f"mixed bucket {dtype}: a {name} call's rows differ from the same "
                         f"kernel on each row alone (max|d|/max|ref| {worst:.3e}, bits {same})")

            def close(r, got):
                dmax, dmean, scale = readings(got, want[dtype][r])
                if dtype == "float32":
                    return bool(got.isfinite().all()) and dmax <= F32_TOL, dmax / scale, dmean / scale
                emax, emean, _ = readings(want[dtype][r], want["float32"][r])
                # two bf16 evaluations each within e of the float32 one lie
                # within 2 e of each other
                return (bool(got.float().isfinite().all()) and dmax <= 2 * emax
                        and dmean <= 2 * emean, dmax / scale, dmean / scale)

            worst = [0.0, 0.0, 0.0]
            for r in range(B):
                ok, dmax, dmean = close(r, out[dtype][r])
                worst = [max(worst[0], dmax), max(worst[1], dmean),
                         max(worst[2], readings(want[dtype][r], want["float32"][r])[0]
                             / readings(want[dtype][r], want["float32"][r])[2])]
                if not ok:
                    bad_rows.append((dtype, s // per_chunk, r, lengths[r]))
            control, cmax, _ = close(c, ctl[dtype])
            if control:
                fail(f"mixed bucket {dtype}: the unmasked-padding control passes")
            bits = [bool(torch.equal(out[dtype][r], want[dtype][r])) for r in range(B)]
            if not all(copies[dtype]):
                bad_rows.append((dtype, s // per_chunk, "copies", copies[dtype]))
            calls_of = lambda n: [(w, b) for name, w, b in per_call[dtype] if name == n]
            log(f"  mixed bucket {dtype}, chunk {s // per_chunk}, rows of L = {lengths}: each "
                "kernel call row by row against the row alone, max|d|/max|ref| (same bits): "
                + ", ".join(f"{n} {max(w for w, _ in calls_of(n)):.3e} "
                            f"({all(b for _, b in calls_of(n))})" for n in ("message", "chain"))
                + f"; the evaluation against each complex alone max|d|/max|ref| {worst[0]:.3e}, "
                f"mean|d|/max|ref| {worst[1]:.3e}, the same bits {bits}"
                + ("" if dtype == "float32" else
                   f" (bf16 alone against float32 alone: max|d|/max|ref| up to {worst[2]:.3e})")
                + f"; equal to the row of {B} copies of its complex, bit for bit: "
                f"{copies[dtype]}; control (row {c}'s padding unmasked) max|d|/max|ref| "
                f"{cmax:.3e}: fails")
    if bad_rows:
        fail(f"mixed bucket: rows (dtype, chunk, row, L) {bad_rows} differ from their complex "
             "alone beyond the limits")


def directory_run(torch, cli, args, n_chunks, per_chunk_launches):
    """One directory run with its counts set to 0 before and read after:
    every count equal to ``n_chunks`` times its launches a chunk. Returns
    (results, summary, wall seconds of the whole call)."""
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = cli.run_directory(args)
    wall = time.perf_counter() - t0
    got = read_launches()
    want = expect_launches(**{k: n_chunks * v for k, v in per_chunk_launches.items()})
    if got != want:
        fail(f"directory {cli.__name__}: launches {got}, expected {want} ({n_chunks} chunks)")
    return results, json.loads((Path(args.outdir) / "summary.json").read_text()), wall


def check_directory_records(results, inputs):
    """One record per input, no tail duplicate, no error, every output with
    its input's residues and finite coordinates."""
    import numpy as np

    from packppi_torch.structure import from_pdb_file

    names = sorted(Path(r.get("input", "?")).name for r in results)
    if names != sorted(p.name for p in inputs):
        fail(f"directory records {names} are not one per input")
    for r in results:
        if "error" in r or "clashscore_error" in r or "error" in r.get("metrics", {}):
            fail(f"directory record failed: {r}")
        inp = from_pdb_file(r["input"], mse_to_met=True)
        out = from_pdb_file(r["output"])
        if (not np.array_equal(out.aaindex, inp.aaindex)
                or not np.isfinite(out.atom_positions[out.atom_mask > 0]).all()):
            fail(f"{r['output']} does not keep its input's residues or is not finite")


def phase_directory(torch):
    """Directory mode on the card: the mixed-bucket row check, then
    ``cli.pack --input <corpus> --batch_size 4 --n_samples 2 --use_proximal
    --metrics`` (bf16, 30 steps, reference weights) with its launches per
    chunk, records and throughput, the same at ``--batch_size 1`` and
    without ``--metrics``, a profile of the batch-4 run, and ``cli.prox
    --input <corpus> --batch_size 4``.
    Returns the message, chain and clash launches of one pack chunk."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from packppi_torch.cli import pack, prox
    from packppi_torch.cli._directory import bucket_indices
    from packppi_torch.structure import featurize, from_pdb_file

    corpus, members = directory_corpus()
    inputs = sorted(corpus.glob("*.pdb"))
    feats = [featurize(from_pdb_file(p, mse_to_met=True)) for p in inputs]
    buckets = bucket_indices(feats)
    log(f"directory corpus: {len(inputs)} structures, buckets "
        f"{ {b: [len(feats[i]['residue_type']) for i in m] for b, m in sorted(buckets.items())} }")
    check_mixed_bucket(torch, members)

    chunks = lambda per_chunk: sum(-(-len(m) // per_chunk) for m in buckets.values())
    per_chunk = dict(message=5 * STEPS, chain=5 * STEPS, clash_fwd=1 + PROX_STEPS + 1,
                     clash_bwd=PROX_STEPS)
    common = ["--input", str(corpus), "--ckpt", str(PIPELINE_GOLDEN), "--precision", "bfloat16",
              "--n_steps", str(STEPS), "--n_samples", str(DIR_SAMPLES), "--use_proximal",
              "--metrics", "--seed", "0"]
    rates = {}
    for bs, metrics in ((DIR_BATCH, True), (1, True), (DIR_BATCH, False)):
        out = OUT / f"dir_pack_b{bs}{'' if metrics else '_no_metrics'}"
        args = pack.build_parser().parse_args(
            [a for a in common if metrics or a != "--metrics"]
            + ["--batch_size", str(bs), "--outdir", str(out)])
        n_chunks = chunks(max(1, bs // DIR_SAMPLES))
        results, summary, wall = directory_run(torch, pack, args, n_chunks, per_chunk)
        check_directory_records(results, inputs)
        for r in results:
            if r["proximal_accepted"] != (r["proximal_objective_final"]
                                          < r["proximal_objective_initial"]):
                fail(f"{r['input']}: accept flag is not its own trajectory's")
            m = r.get("metrics", {})
            if metrics and (set(m) != METRIC_KEYS - {"sampling_seconds"} or not all(
                    isinstance(v, bool) or math.isfinite(v) for v in m.values())):
                fail(f"{r['input']}: metric record {m}")
        rates[bs, metrics] = len(results) / wall
        log(f"directory pack --batch_size {bs} --n_samples {DIR_SAMPLES} --use_proximal"
            f"{' --metrics' if metrics else ''}: {len(results)} complexes, {n_chunks} chunks, "
            f"{wall:.3f} s end to end (summary {summary['seconds']:.3f} s): "
            f"{rates[bs, metrics]:.4f} complexes/s; accepted "
            f"{sum(r['proximal_accepted'] for r in results)} of {len(results)}"
            + (f"; mean total_acc {np.mean([r['metrics']['total_acc'] for r in results]):.4f}"
               if metrics else ""))

    # device busy per chunk of the batch-4 run, the wall per chunk from the
    # run above (without the profiler)
    n_chunks = chunks(DIR_BATCH // DIR_SAMPLES)
    args = pack.build_parser().parse_args(common + ["--batch_size", str(DIR_BATCH), "--outdir",
                                                    str(OUT / "dir_pack_profiled")])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pack.run_directory(args)
        torch.cuda.synchronize()
    report_profile(f"directory pack --batch_size {DIR_BATCH} (mean over its {n_chunks} chunks)",
                   prof, len(inputs) / rates[DIR_BATCH, True] / n_chunks * 1e3, n_chunks, "chunk")

    args = prox.build_parser().parse_args(["--input", str(corpus), "--outdir",
                                           str(OUT / "dir_prox"), "--batch_size", str(DIR_BATCH)])
    n_chunks = chunks(DIR_BATCH)
    results, summary, wall = directory_run(
        torch, prox, args, n_chunks, dict(clash_fwd=PROX_STEPS + 1, clash_bwd=PROX_STEPS))
    check_directory_records(results, inputs)
    for r in results:
        if r["accepted"] != (r["objective_final"] < r["objective_initial"]) or not all(
                math.isfinite(r[k]) for k in ("clashscore_before", "clashscore_after")):
            fail(f"directory prox record {r}")
    log(f"directory prox --batch_size {DIR_BATCH}: {len(results)} structures, {n_chunks} chunks, "
        f"{wall:.3f} s end to end: {len(results) / wall:.4f} structures/s; clashscore before -> "
        f"after, mean {np.mean([r['clashscore_before'] for r in results]):.4f} -> "
        f"{np.mean([r['clashscore_after'] for r in results]):.4f}")
    return per_chunk


# the configuration that trains through the kernels
TRAIN_KNOBS = dict(dropout=0.0, fused_messages=True, fused_messages_train=True,
                   fused_chain_train=True)
TRAIN_STEPS, TRAIN_STEPS_BF16 = 20, 5
CROP_SOURCES = (ONE_BRS, REPO / "tests" / "fixtures" / "2ftl.pdb")
SHIPPED_CKPT = REPO / "docs" / "ckpts" / "diffusion_crops" / "torch_state.pt"


def new_train_state(torch, seed, device="cuda", **cfg):
    from packppi_torch.models import NetworkConfig, TorsionalDiffusion
    from packppi_torch.train.diffusion_task import init_state

    return init_state(TorsionalDiffusion(NetworkConfig(**cfg)), seed, device)


def param_grads(net):
    return {k: (p.grad.detach().clone() if p.grad is not None else p.new_zeros(p.shape))
            for k, p in net.named_parameters()}


def compare_param_grads(what, got, want, limit):
    worst, at, worst_abs = 0.0, "", 0.0
    largest = max(w.abs().max().item() for w in want.values())
    for k, w in want.items():
        scale = max(w.abs().max().item(), 1e-3)
        d = (got[k].to(w.device) - w).abs().max().item()
        if not (d <= limit * scale and d <= GRAD_GLOBAL_TOL * largest):
            fail(f"{what}: gradient of {k} off by {d:.3e}: {d / scale:.3e} of its max (limit "
                 f"{limit:g}), {d / largest:.3e} of the largest gradient max {largest:.3e} "
                 f"(limit {GRAD_GLOBAL_TOL:g})")
        worst_abs = max(worst_abs, d)
        if d / scale > worst:
            worst, at = d / scale, k
    log(f"  {what}: {len(want)} parameter gradients, worst max|d|/max|ref| {worst:.3e} at {at} "
        f"(limit {limit:g}); worst max|d| {worst_abs:.3e} = {worst_abs / largest:.3e} of the "
        f"largest gradient max {largest:.3e} (limit {GRAD_GLOBAL_TOL:g})")


def phase_loss_grads(torch):
    """One whole loss at B = 2, L = 256 (two halves of T1124's first 512
    residues), float32, same weights and draws: the configuration that runs
    the kernels against the unfused configuration, and the card's against
    the CPU's, loss and every parameter gradient."""
    from packppi_torch.data import stack_batch
    from packppi_torch.structure import featurize, from_pdb_file

    feats = featurize(from_pdb_file(T1124, mse_to_met=True))
    halves = [{k: v[s:s + 256] for k, v in feats.items()} for s in (0, 256)]
    batch = stack_batch(halves, "cuda", target_len=256)
    g = torch.Generator(device="cuda").manual_seed(11)
    draws = dict(t=torch.rand(2, generator=g, device="cuda"),
                 noise_pi=torch.randn(batch.SC_D.shape, generator=g, device="cuda"),
                 noise_2pi=torch.randn(batch.SC_D.shape, generator=g, device="cuda"))
    results = {}
    for name, device, cfg in (("kernels", "cuda", TRAIN_KNOBS), ("unfused", "cuda", dict(dropout=0.0)),
                              ("kernels on the CPU", "cpu", TRAIN_KNOBS)):
        state = new_train_state(torch, 5, device, **cfg)
        b = type(batch)(*(t.to(device) for t in batch))
        zero_launches()
        loss = state.model.loss(b, None, **{k: v.to(device) for k, v in draws.items()})
        loss.backward()
        launches = read_launches()
        want = 5 if name == "kernels" else 0
        if (launches["message_feat"], launches["chain"], launches["message"]) != (want, want, 0):
            fail(f"loss ({name}): launches {launches}")
        results[name] = (loss.item(), param_grads(state.model.net))
        log(f"  loss B=2 L=256 float32, {name}: {loss.item():.7f}  launches message_feat "
            f"{launches['message_feat']}, chain {launches['chain']}")
    for other, limit in (("unfused", GRAD_REL_TOL), ("kernels on the CPU", GRAD_REL_TOL_DEVICES)):
        d = abs(results["kernels"][0] - results[other][0])
        if not d <= 1e-5:
            fail(f"loss: kernels vs {other} differ by {d:.3e} (limit 1e-5)")
        compare_param_grads(f"loss gradients, kernels vs {other} (loss |d| {d:.3e})",
                            results["kernels"][1], results[other][1], limit)


def state_snapshot(state):
    return ([p.detach().clone() for p in state.model.net.parameters()],
            [{k: (v.clone() if hasattr(v, "clone") else v) for k, v in s.items()}
             for s in state.optimizer.state.values()])


def snapshots_equal(torch, a, b):
    same = lambda x, y: torch.equal(x, y) if hasattr(x, "shape") else x == y
    return (all(torch.equal(x, y) for x, y in zip(a[0], b[0])) and len(a[1]) == len(b[1])
            and all(s.keys() == t.keys() and all(same(s[k], t[k]) for k in s)
                    for s, t in zip(a[1], b[1])))


def run_steps(torch, state, step, batch, n, what):
    """``n`` training steps with the launch counts of each asserted (5
    feature-message and 5 chain launches, forward only); returns the losses
    the wall milliseconds of each step, and the launches summed."""
    losses, ms, totals = [], [], {}
    for i in range(n):
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(state, batch))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        got = read_launches()
        if (got["message_feat"], got["chain"], got["message"]) != (5, 5, 0):
            fail(f"{what}, step {i}: launches {got}, expected 5 message_feat and 5 chain")
        totals = {k: totals.get(k, 0) + v for k, v in got.items()}
    losses = [x.item() for x in losses]
    if not all(map(math.isfinite, losses)):
        fail(f"{what}: a loss is not finite: {losses}")
    return losses, ms, totals


def phase_train(torch):
    """Training at full width: B = 4 x L = 1,024 of T1124, published widths,
    random weights from a seed, the configuration that trains through the
    kernels. 20 float32 steps and 5 in bf16 compute. Returns the launch
    counts of the 20 steps."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from packppi_torch.train.diffusion_task import make_train_step

    batch = t1124_train_batch("cuda")
    state = new_train_state(torch, 0, **TRAIN_KNOBS)
    n_params = sum(p.numel() for p in state.model.net.parameters())
    step = make_train_step(state.model, state.optimizer)
    fixed_loss = lambda: state.model.loss(batch, torch.Generator(device="cuda").manual_seed(123),
                                          deterministic=True).item()
    with torch.no_grad():
        zero_launches()
        before = fixed_loss()
        if (read_launches()["message_feat"], read_launches()["chain"]) != (5, 5):
            fail(f"evaluation loss: launches {read_launches()}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms, totals = run_steps(torch, state, step, batch, TRAIN_STEPS, "float32 training")
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    with torch.no_grad():
        after = fixed_loss()
    q = np.percentile(ms[-10:], [0, 25, 50, 75, 100])
    log(f"train B={TRAIN_B} L={TRAIN_L} float32, {n_params} parameters, {TRAIN_STEPS} steps: "
        f"first step {ms[0]:.1f} ms; last 10: median {q[2]:.2f} ms, quartiles {q[1]:.2f}-{q[3]:.2f}, "
        f"min {q[0]:.2f}, max {q[4]:.2f}; peak memory {peak:.1f} MiB; launches {totals} "
        f"(5 message_feat + 5 chain in every step)")
    log(f"  training losses {losses[0]:.5f} -> {losses[-1]:.5f}; loss on a fixed evaluation draw "
        f"{before:.6f} -> {after:.6f}")
    if not after < before:
        fail("the loss on the fixed evaluation draw did not fall")

    # a poisoned batch: one NaN coordinate; nothing may change, bit for bit
    snap = state_snapshot(state)
    X = batch.X.clone()
    X[0, 17, 1, 0] = float("nan")
    poisoned = step(state, batch._replace(X=X)).item()
    unchanged = snapshots_equal(torch, snap, state_snapshot(state))
    log(f"  poisoned step: loss {poisoned}, parameters and Adam state unchanged bit for bit: "
        f"{unchanged}; opt_steps {state.opt_steps} of {state.step} steps")
    if math.isfinite(poisoned) or not unchanged or state.opt_steps != TRAIN_STEPS:
        fail("the non-finite skip did not leave parameters and optimizer state as they were")

    # where one step's time goes
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    report_profile(f"float32 training step B={TRAIN_B} L={TRAIN_L}", prof, q[2], 1, "step")
    del state, step

    # bf16 compute; parameters, gradients and Adam moments stay float32
    state = new_train_state(torch, 0, compute_dtype="bfloat16", **TRAIN_KNOBS)
    step = make_train_step(state.model, state.optimizer)
    torch.cuda.reset_peak_memory_stats()
    losses, ms, _ = run_steps(torch, state, step, batch, TRAIN_STEPS_BF16, "bf16 training")
    f32 = torch.float32
    dtypes_ok = (all(p.dtype == f32 for p in state.model.net.parameters())
                 and all(v.dtype == f32 for s in state.optimizer.state.values()
                         for k, v in s.items() if k != "step"))
    log(f"train B={TRAIN_B} L={TRAIN_L} bf16 compute, {TRAIN_STEPS_BF16} steps: "
        f"{' '.join(f'{m:.1f}' for m in ms)} ms; losses {losses[0]:.5f} -> {losses[-1]:.5f}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB; parameters and "
        f"Adam moments float32: {dtypes_ok}")
    if not dtypes_ok:
        fail("bf16 compute changed the dtype of parameters or optimizer state")
    return totals


def phase_trainer(torch):
    """The trainer end to end through its CLI entry point: build the crop
    corpus, train one epoch, resume from its checkpoint for a second (in a
    run directory of its own, as the CLI makes them), pack 1BRS with the
    last checkpoint."""
    import numpy as np

    from packppi_torch.cli import pack, train_diffusion
    from packppi_torch.data import crops

    corpus, base = OUT / "crops", OUT / "train_run"
    for d in (corpus, base):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    n = crops.build([str(p) for p in CROP_SOURCES], str(corpus))
    log(f"crop corpus: {n} crops of 64 and 96 residues in {time.perf_counter() - t0:.2f} s")
    argv = ["trainer=debug", f"data.data_dir={corpus}", "data.batch_size=16",
            "sample.n_diffusion_steps=3", f"output_dir={base}"]
    argv += [f"model.{k}={str(v).lower()}" for k, v in TRAIN_KNOBS.items()]
    train_steps, resume = [], []
    for epochs in (1, 2):
        zero_launches()
        t0 = time.perf_counter()
        (result,) = train_diffusion.main(argv + [f"trainer.max_epochs={epochs}"] + resume)
        got = read_launches()
        m, run = result["metrics"], Path(result["run_dir"])
        resume = [f"ckpt_path={m['last_ckpt']}"]
        log(f"cli.train_diffusion, max_epochs={epochs}: {time.perf_counter() - t0:.2f} s, "
            f"epochs_run {m['epochs_run']}, best val/loss {m['best_val_loss']:.5f}, test/loss "
            f"{m['test_loss']:.5f}, last checkpoint {Path(m['last_ckpt']).name}, launches {got}")
        if not (got["message_feat"] > 0 and got["chain"] > 0 and got["message"] == 0):
            fail(f"the trainer did not run through the kernels: {got}")
        if m["epochs_run"] != epochs:
            fail("the second invocation did not resume from the first's checkpoint")
        records = [json.loads(line)
                   for line in (run / "logs" / "metrics.jsonl").read_text().splitlines()]
        train_steps += [r["step"] for r in records if "train/loss" in r]
        index = json.loads((run / "checkpoints" / "index.json").read_text())
        ok = ((run / "split.json").exists() and index and Path(m["last_ckpt"]).exists()
              and all(np.isfinite(v) for r in records for v in r.values())
              and sum("val/loss" in r for r in records) == 1
              and sum("test/loss" in r for r in records) == 1)
        log(f"  {run.relative_to(OUT)}: split.json, index.json {sorted(index)}, train/loss, "
            f"val/loss and test/loss records all finite: {bool(ok)}")
        if not ok:
            fail("the trainer's outputs are incomplete")
    log(f"  train/loss records over both runs: steps {train_steps[0]}-{train_steps[-1]}")
    if train_steps != list(range(1, len(train_steps) + 1)):
        fail(f"the resumed run did not take up where the first stopped: steps {train_steps}")
    args = pack.build_parser().parse_args(["--input", str(ONE_BRS), "--ckpt", m["last_ckpt"],
                                           "--outdir", str(OUT / "pack_1brs_trained"),
                                           "--n_steps", "10"])
    metrics = pack.run(args)
    if not (OUT / "pack_1brs_trained" / "structure.pdb").exists():
        fail("cli.pack did not pack with the trainer's checkpoint")
    log(f"  cli.pack --ckpt {Path(m['last_ckpt']).name} on 1BRS: sampling "
        f"{metrics['sampling_seconds']:.4f} s")


def phase_shipped_checkpoint(torch):
    """T1124 packed with the converted shipped checkpoint, seed 0: the chi
    accuracies of the written structure against the input's side chains."""
    from packppi_torch.cli import pack
    from packppi_torch.structure import featurize, from_pdb_file
    from packppi_torch.utils.metrics import chi_metrics

    out = OUT / "pack_t1124_shipped"
    args = pack.build_parser().parse_args(["--input", str(T1124), "--ckpt", str(SHIPPED_CKPT),
                                           "--outdir", str(out), "--seed", "0"])
    pack.run(args)
    true = featurize(from_pdb_file(T1124, mse_to_met=True))
    pred = featurize(from_pdb_file(out / "structure.pdb", mse_to_met=True))
    m = chi_metrics(true["SC_D"], pred["SC_D"], true["SC_D_mask"], true["chi_1pi_periodic_mask"])
    log("T1124 with docs/ckpts/diffusion_crops/torch_state.pt, bf16, 30 steps, seed 0: chi1-4 "
        f"accuracy {m['chi_0_acc']:.4f} {m['chi_1_acc']:.4f} {m['chi_2_acc']:.4f} "
        f"{m['chi_3_acc']:.4f}, total {m['total_acc']:.4f}")
    if not m["chi_0_acc"] > 0.3:
        fail("the shipped checkpoint packs T1124 no better than chance")


def phase_latency(torch, reps=5, prox_reps=5):
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
        return None
    log(f"profile: {what} {wall_ms:.4f} ms wall, device busy {busy_ms:.4f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.3f}, {sum(e.count for e in rows) / reps:.0f} device "
        f"operations/{unit}")
    for e in rows[:10]:
        log(f"  {dev(e) / reps / 1e3:8.4f} ms  {e.count / reps:6.1f} calls/{unit}  {e.key[:90]}")
    return busy_ms


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


# PackPPI-AP and ESM-2 650M
# attention kernel vs plain version, float32 max |d| (sums in another order)
ATTN_F32_TOL = 1e-5
# shapes (B, H, T, D, padded keys: one count for every row, or one per
# row): T1124 through the ESM extractor (741 residues, three chain groups,
# 783 tokens padded to 896); the same with one inter-chain run fewer (763
# tokens in 768); two rows at a length that no 64-key tile divides; a long
# sequence; the dataset scan's batches of a wild type and four mutants
# (1BRS 217 tokens, 2FTL 322, T1124 783); and scan batches whose rows are
# complexes of one length bucket with other token counts, down to one key
ATTN_SHAPES = {"T1124": (1, 20, 896, 64, 113), "T=768": (1, 20, 768, 64, 5),
               "B=2 T=763": (2, 20, 763, 64, 7), "T=2048": (1, 20, 2048, 64, 0),
               "B=5 T=256": (5, 20, 256, 64, 39), "B=5 T=384": (5, 20, 384, 64, 62),
               "B=5 T=896": (5, 20, 896, 64, 113),
               "B=5 T=896 mixed": (5, 20, 896, 64, [113, 300, 500, 113, 700]),
               "B=6 T=384 mixed": (6, 20, 384, 64, [62, 0, 127, 383, 130, 64])}
# float32 only (the scan's precision): the row with one key outputs one
# row of v, so max|ref| reaches ~3.5 and the bf16 tolerance, scaled by it,
# no longer rejects the unrounded-weights control (2.9e-5 of max|ref|
# against the 6.1e-5 needed)
ATTN_F32_ONLY = ("B=6 T=384 mixed",)
# ``cli.ddg --eval_csv --mode esm`` against ``cli.ddg --mode esm`` one
# mutation at a time, on the card, kcal/mol (both --no_strict_parity, so a
# prediction reads its own residues only): the scan's forward pads a
# shorter complex to the batch's T and the single path does not, so the
# float32 GEMMs may sum in other orders (the card reads 8.6e-8 at full
# width, the CPU 3e-7 at a tiny one)
DDG_ESM_SCAN_TOL = 1e-5
# the cut copy of T1124 keeps chain B's residues up to this number:
# 379 + 151 = 530 residues (552 tokens), in T1124's length bucket (513-768)
T1124_CUT_B = 157
# ESM-2 650M float32, card against CPU on the same weights and tokens:
# max |d| relative to max|ref|
ESM_DEVICES_TOL = 1e-3
ESM_CPU_SECONDS = 60.0        # full depth on the CPU if it takes less than this
ESM_REPS = 10
# the port's network-mode predictions against the JAX package's, kcal/mol
DDG_EVAL_TOL = 2e-3
AFFINITY_CKPTS = REPO / "docs" / "ckpts" / "affinity_skempi_mini_pretrained"
SKEMPI_MINI = REPO / "tests" / "fixtures" / "skempi_mini"
T1124_MUTATION = "LA10A"      # T1124 chain A, residue 10: L -> A


def attention_operands(torch, dtype, B, H, T, D, pad, seed=0):
    """q, k, v ~ N(0, 1) (q scaled by D^-0.5, as ESM-2 scales it) and the
    key bias with the last ``pad`` keys of each row padded (``pad`` one
    count, or a list of one per row), on the card."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, H, T, D, generator=g) for _ in range(3))
    bias = torch.zeros(B, T)
    for b, n in enumerate(pad if isinstance(pad, list) else [pad] * B):
        bias[b, T - n:] = -1e9 if n else 0.0
    return (*(t.to(dtype).to("cuda").contiguous() for t in (q * D ** -0.5, k, v)),
            bias.to("cuda"))


def attention_cost(ops):
    """(bytes, operations): q, k, v and the bias read once, the float32
    output written once; the two products' multiply-adds, 4 B H T^2 D."""
    B, H, T, D = ops[0].shape
    return sum(_nbytes(t) for t in ops) + B * H * T * D * 4, 4 * B * H * T * T * D


def phase_attention(torch, timer):
    """The attention kernel against its plain version on the card at
    ``ATTN_SHAPES``, float32 and bf16 (float32 alone at ``ATTN_F32_ONLY``);
    in bf16 two controls must fail (the weights left unrounded; the first
    query tile of one head zeroed); two launches on one input must agree
    bit for bit. Times of the kernel, the
    plain version and ``scaled_dot_product_attention`` with the same
    additive mask (timed only: the port never calls it). Returns records."""
    import torch.nn.functional as F

    from packppi_torch.ops.attention import mha, mha_plain

    records = {}
    for label, (B, H, T, D, pad) in ATTN_SHAPES.items():
        for dtype_name in ("float32",) if label in ATTN_F32_ONLY else ("float32", "bfloat16"):
            dt = getattr(torch, dtype_name)
            ops = attention_operands(torch, dt, B, H, T, D, pad)
            got = mha(*ops)
            again = mha(*ops)
            torch.cuda.synchronize()
            want = mha_plain(*ops)
            name = f"attention {label} {dtype_name} {tuple(got.shape)}"
            if not torch.equal(got, again):
                fail(f"{name}: two launches on one input differ")
            if dtype_name == "float32":
                err, dmean, scale = readings(got, want)
                ok = bool(got.isfinite().all()) and err <= ATTN_F32_TOL
                log(f"  {name}: max|d| {err:.6g}  mean|d| {dmean:.6g}  max|ref| {scale:.6g}  "
                    f"{'ok' if ok else 'OUT OF TOLERANCE'} (limit {ATTN_F32_TOL:g})")
                if not ok:
                    fail(f"{name} disagrees with its plain version")
            else:
                err = check_close(name, got, want, dtype_name)
                q, k, v, bias = ops
                logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) + bias[:, None, None]
                unrounded = torch.matmul(torch.softmax(logits, -1), v.float())
                check_controls(name, got, want, unrounded, 64)
                del logits, unrounded
            nb, no = attention_cost(ops)
            mask = ops[3][:, None, None, :].to(dt)
            records[("attention", dtype_name, label)] = dict(
                max_abs_err=err, ms=timer(lambda: mha(*ops)),
                plain_ms=timer(lambda: mha_plain(*ops), 5),
                library_ms=timer(lambda: F.scaled_dot_product_attention(
                    ops[0], ops[1], ops[2], attn_mask=mask, scale=1.0)),
                bound=bound_ms(nb, no, dtype_name), bytes=nb, operations=no)
            del ops, got, again, want, mask
    for (k, d, v), r in records.items():
        log(f"  time {k} {v} {d}: kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
            f"sdpa {r['library_ms']:.4f} ms  bound {r['bound'][0]:.4f} ms ({r['bound'][1]}; "
            f"{r['bytes']} bytes, {r['operations']} operations; {rate_line(r)})")
    return records


# the 3xTF32 GEMM (ops.gemm) against the float64 product with the same
# epilogue: max |d| over max|ref| (tests/test_torch_gemm_gpu.py's limit;
# the kernel reads 4.5e-7 to 8.7e-7 there). The same product on operands
# rounded to TF32 (one TF32 product, the control) reads ~3e-4 and must
# fail. F.linear on the FMA units is logged beside it, not held: its own
# float32 error is of the kernel's order, so the two can differ by more
# than 2e-6 of max|ref| (2.07e-6 at the FFN-in map, M = 1,280)
GEMM_TOL = 2e-6
# ESM-2 650M's maps after the attention, each with the epilogue the model
# gives it: (N, K, gelu, residual); the query, key and value run through
# the heads epilogue (B = 5 rows of T tokens, 20 heads of 64)
GEMM_MAPS = {"out": (1280, 1280, False, True), "ffn_in": (5120, 1280, True, False),
             "ffn_out": (1280, 5120, False, True)}
GEMM_T = (256, 384, 896)              # a scan batch of 5 rows: M = 1,280, 1,920, 4,480


def phase_gemm(torch, timer):
    """The 3xTF32 GEMM on the card at ESM-2 650M's shapes, float32: the
    three maps after the attention with their epilogues (``GEMM_MAPS``) and
    the query, key and value through the heads epilogue, each at M = 5 x
    ``GEMM_T`` rows; one launch a call, two launches bit for bit, within
    ``GEMM_TOL`` of max|ref| of the plain version run in float64, and the
    plain version on operands rounded to TF32 (the control) outside it; the
    plain version in float32 (``F.linear``) logged beside. Times of the
    kernel, the plain version and ``F.linear`` alone (cuBLAS with TF32 off,
    the FMA units). Returns records."""
    import torch.nn.functional as F

    from packppi_torch.models.esm2 import rope_tables
    from packppi_torch.ops import gemm
    from packppi_torch.ops.message_feat import tf32_split

    tf32 = lambda t: tf32_split(t)[0]
    g = torch.Generator(device="cuda").manual_seed(0)
    uniform = lambda *shape, scale: (torch.rand(*shape, device="cuda", generator=g) * 2 - 1) * scale
    records = {}
    for T in GEMM_T:
        M = 5 * T
        cases = {}
        for name, (N, K, gelu, with_res) in GEMM_MAPS.items():
            x = torch.randn(M, K, device="cuda", generator=g)
            w, b = uniform(N, K, scale=(6 / (N + K)) ** 0.5), uniform(N, scale=0.1)
            res = torch.randn(M, N, device="cuda", generator=g) if with_res else None
            kw = dict(gelu=gelu, residual=res)
            kw64 = dict(gelu=gelu, residual=None if res is None else res.double())
            cases[name] = (
                lambda x=x, w=w, b=b, kw=kw: gemm.linear(x, w, b, **kw),
                lambda x=x, w=w, b=b, kw=kw: gemm.linear_plain(x, w, b, **kw),
                lambda x=x, w=w, b=b, kw=kw64: gemm.linear_plain(x.double(), w.double(),
                                                                 b.double(), **kw),
                lambda x=x, w=w, b=b, kw=kw: gemm.linear_plain(tf32(x), tf32(w), b, **kw),
                lambda x=x, w=w, b=b: F.linear(x, w, b),
                sum(_nbytes(t) for t in (x, w, b, res)) + M * N * 4, 2 * M * N * K)
        D, width, K = 64, 1280, 1280
        x = torch.randn(5, T, K, device="cuda", generator=g)
        ws = [uniform(width, K, scale=(6 / (width + K)) ** 0.5) for _ in range(3)]
        bs = [uniform(width, scale=0.1) for _ in range(3)]
        cos, sin = rope_tables(T, D, "cuda")
        w_all, b_all = torch.cat(ws), torch.cat(bs)
        heads = lambda out: torch.stack(out)
        cases["qkv_heads"] = (
            lambda: heads(gemm.linear_heads(x, ws, bs, cos, sin, D ** -0.5)),
            lambda: heads(gemm.linear_heads_plain(x, ws, bs, cos, sin, D ** -0.5)),
            lambda: heads(gemm.linear_heads_plain(
                x.double(), [w.double() for w in ws], [b.double() for b in bs], cos.double(),
                sin.double(), D ** -0.5)),
            lambda: heads(gemm.linear_heads_plain(tf32(x), [tf32(w) for w in ws], bs, cos, sin,
                                                  D ** -0.5)),
            lambda: F.linear(x, w_all, b_all),
            sum(_nbytes(t) for t in (x, w_all, b_all, cos, sin)) + 3 * M * width * 4,
            2 * M * 3 * width * K)
        for name, (kernel, plain, plain64, control, library, nb, no) in cases.items():
            label = f"gemm {name} float32 M = {M}"
            with torch.no_grad():
                before = gemm.linear.launches
                got = kernel()
                launched = gemm.linear.launches - before
                again = kernel()
                ref = plain64()
                gaps = [(t.double() - ref).abs().max().item() for t in (got, plain(), control())]
            torch.cuda.synchronize()
            if launched != 1:
                fail(f"{label}: {launched} kernel launches, expected 1")
            if not torch.equal(got, again):
                fail(f"{label}: two launches on one input differ")
            scale = ref.abs().max().item()
            err, f32_rel, c_rel = gaps[0], gaps[1] / scale, gaps[2] / scale
            ok = bool(got.isfinite().all()) and err <= GEMM_TOL * scale
            log(f"  {label}: max|d| to float64 {err:.6g}  max|ref| {scale:.6g}  "
                f"max|d|/max|ref| {err / scale:.3e}; F.linear {f32_rel:.3e}; TF32 control "
                f"{c_rel:.3e}  {'ok' if ok else 'OUT OF TOLERANCE'} (limit {GEMM_TOL:g})")
            if not ok:
                fail(f"{label} disagrees with the float64 product")
            if c_rel <= GEMM_TOL:
                fail(f"{label}: the TF32 control passes the limit ({c_rel:.3e})")
            with torch.no_grad():
                records[("gemm", "float32", f"{name} M={M}")] = dict(
                    max_abs_err=err, max_rel_err=err / scale, plain_rel_err=f32_rel,
                    control_rel_err=c_rel, ms=timer(kernel), plain_ms=timer(plain, 5),
                    library_ms=timer(library), bound=bound_ms(nb, no, "float32"), bytes=nb,
                    operations=no)
            del got, again, ref
        del cases, x, ws, bs
    for (k, d, v), r in records.items():
        log(f"  time {k} {v} {d}: kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
            f"F.linear {r['library_ms']:.4f} ms  bound {r['bound'][0]:.4f} ms ({r['bound'][1]}; "
            f"{r['bytes']} bytes, {r['operations']} operations; {rate_line(r)})")
    return records


def esm2_650m(torch, device, seed=None, weights=None):
    """ESM-2 650M (33 layers, hidden 1280, 20 heads, attention "auto") on
    ``device``: random weights from ``seed`` (drawn on the CPU), or a copy
    of ``weights``, a state dict."""
    from packppi_torch.models.esm2 import ESM2, ESM2Config, init_esm_weights

    with torch.device("meta"):
        model = ESM2(ESM2Config(attention_impl="auto"))
    model = model.to_empty(device=device)
    if weights is None:
        init_esm_weights(model, seed)
    else:
        model.load_state_dict(weights)
    return model.eval()


def t1124_esm_tokens():
    """The ESM-2 tokens of T1124's wild type and of its ``T1124_MUTATION``
    mutant, as the extractor of ``data.esm`` builds them."""
    from packppi_torch.data.esm import build_chain_separated_sequence
    from packppi_torch.data.skempi import apply_mutations, parse_mutation
    from packppi_torch.models.esm2 import tokenize
    from packppi_torch.structure import featurize, from_pdb_file

    prot = from_pdb_file(T1124, mse_to_met=True)
    feats = featurize(prot)
    rt_mut, _ = apply_mutations(prot, [parse_mutation(T1124_MUTATION)])
    return [tokenize(build_chain_separated_sequence(rt, feats["chain_indices"]))
            for rt in (feats["residue_type"], rt_mut)]


def phase_esm(torch):
    """ESM-2 650M at full width with random weights from seed 0: T1124's
    wild type and mutant through ``make_extractor`` with 33 attention
    launches asserted in each extraction; the time per extraction (median
    of ``ESM_REPS``) and peak memory; the card against the CPU on the same
    weights and tokens. Returns the CPU model (its weights feed the next
    phase)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from packppi_torch.models.esm2 import make_extractor

    t0 = time.perf_counter()
    cpu_model = esm2_650m(torch, "cpu", seed=0)
    card = esm2_650m(torch, "cuda", weights=cpu_model.state_dict())
    n_params = sum(p.numel() for p in card.parameters())
    log(f"ESM-2 650M: {n_params} parameters, random weights from seed 0, on the CPU and the "
        f"card in {time.perf_counter() - t0:.2f} s")
    extract = make_extractor(card)
    tokens = t1124_esm_tokens()
    n_layers = card.cfg.num_layers
    outs = []
    for what, ids in zip(("wild type", "mutant"), tokens):
        zero_launches()
        (out,) = extract([ids])
        got = read_launches()
        T = -(-len(ids) // 128) * 128
        log(f"  extraction of T1124 {what} ({T1124_MUTATION}): {len(ids)} tokens padded to "
            f"T = {T}, output {out.shape}, launches {got}")
        # a block: the attention, q/k/v as one product and three more products
        if got != {**{k: 0 for k in got}, "attention": n_layers, "gemm": 4 * n_layers}:
            fail(f"ESM-2 extraction ({what}): launches {got}, expected {n_layers} attention "
                 f"and {4 * n_layers} gemm")
        if out.shape != (len(ids), card.cfg.hidden_size) or not np.isfinite(out).all():
            fail(f"ESM-2 extraction ({what}): shape {out.shape} or values not finite")
        outs.append(out)
    if np.array_equal(outs[0], outs[1]):
        fail("the mutant's embeddings equal the wild type's")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    times = []
    for _ in range(ESM_REPS):
        t0 = time.perf_counter()
        extract(tokens[:1])                 # returns host numpy: synchronised
        times.append(time.perf_counter() - t0)
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    weights = sum(p.numel() * p.element_size() for p in card.parameters()) / 2 ** 20
    q = np.percentile(times, [0, 25, 50, 75, 100]) * 1e3
    log(f"  ESM-2 650M float32 extraction of T1124, {ESM_REPS} runs: median {q[2]:.2f} ms, "
        f"quartiles {q[1]:.2f}-{q[3]:.2f}, min {q[0]:.2f}, max {q[4]:.2f}; peak memory "
        f"{weights + peak:.1f} MiB: the weights {weights:.1f} MiB and the extraction's "
        f"{peak:.1f} MiB above what was resident")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        extract(tokens[:1])
    report_profile("ESM-2 650M float32 extraction of T1124", prof, q[2], 1, "extraction")

    # the card against the CPU, same weights and tokens; depth cut to 4 only
    # if the CPU would take longer than ESM_CPU_SECONDS
    ids = tokens[0]
    T = -(-len(ids) // 128) * 128
    ids_p = np.full((1, T), card.cfg.pad_token_id, np.int64)
    ids_p[0, :len(ids)] = ids
    mask = np.zeros((1, T), np.float32)
    mask[0, :len(ids)] = 1.0
    run = lambda m, dev, n: m(torch.from_numpy(ids_p).to(dev), torch.from_numpy(mask).to(dev),
                              num_layers=n)[0, :len(ids)].cpu()
    with torch.inference_mode():
        t0 = time.perf_counter()
        run(cpu_model, "cpu", 1)
        one = time.perf_counter() - t0
        depth = n_layers if one * n_layers < ESM_CPU_SECONDS else 4
        t0 = time.perf_counter()
        want = run(cpu_model, "cpu", depth)
        t_cpu = time.perf_counter() - t0
        got = run(card, "cuda", depth)
    dmax, dmean, scale = readings(got, want)
    ok = bool(got.isfinite().all()) and dmax <= ESM_DEVICES_TOL * scale
    log(f"  card vs CPU, float32, {depth} of {n_layers} layers (CPU {t_cpu:.1f} s; one layer "
        f"{one:.2f} s): max|d| {dmax:.6g}  mean|d| {dmean:.6g}  max|ref| {scale:.6g}  "
        f"max|d|/max|ref| {dmax / scale:.3e} (limit {ESM_DEVICES_TOL:g})  "
        f"{'ok' if ok else 'OUT OF TOLERANCE'}")
    if not ok:
        fail("ESM-2 on the card disagrees with ESM-2 on the CPU")
    del card, extract
    torch.cuda.empty_cache()
    return cpu_model


def phase_ddg_esm(torch, cpu_model):
    """``cli.ddg --mode esm`` on T1124 with ``T1124_MUTATION``: the ESM-2
    weights written from seed 0 into ``smoke_out/`` as a ``.pt`` file,
    33 attention launches (one forward over wild type and mutant) and no
    other, a finite ddG. Returns the attention launches of the call and the
    weight file (``phase_train_affinity_esm`` trains with it, then deletes
    it)."""
    import numpy as np

    from packppi_torch.cli import ddg

    cfg = cpu_model.cfg
    path = OUT / "esm2_650M_seed0.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    fields = {k: getattr(cfg, k) for k in ("vocab_size", "hidden_size", "num_layers",
                                           "num_heads", "intermediate_size", "layer_norm_eps",
                                           "token_dropout", "mask_token_id", "pad_token_id")}
    t0 = time.perf_counter()
    torch.save({"config": fields, "state_dict": cpu_model.state_dict()}, path)
    log(f"wrote {path.relative_to(REPO)}: {path.stat().st_size / 2 ** 20:.1f} MiB in "
        f"{time.perf_counter() - t0:.2f} s")
    argv = ["--input", str(T1124), "--mutstr", T1124_MUTATION, "--mode", "esm", "--esm_ckpt",
            str(path), "--outdir", str(OUT / "ddg_esm_t1124"), "--seed", "0"]
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    value = ddg.run_cli(argv)
    wall = time.perf_counter() - t0
    got = read_launches()
    expect = {**{k: 0 for k in got}, "attention": cfg.num_layers, "gemm": 4 * cfg.num_layers}
    log(f"cli.ddg --mode esm T1124 {T1124_MUTATION}: ddG {value:.6f} kcal/mol, whole call "
        f"{wall:.3f} s (reading the weights and building the model included), launches {got}")
    if got != expect or not np.isfinite(value):
        fail(f"cli.ddg --mode esm: launches {got} (expected {expect}) or ddG {value}")
    return got, path


def esm_scan_table(name):
    """A SKEMPI table under ``smoke_out/<name>``: four mutations of T1124
    and four of a copy cut to chain A and chain B up to residue
    ``T1124_CUT_B`` (``T1124CUT``), interleaved, so that each batch of four
    embeds rows of 783 and of 552 tokens in one forward of T = 896.
    Returns the directory and the ``(pdb, mutation)`` of each row."""
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    (d / "PDBs").mkdir(parents=True)
    shutil.copy(T1124, d / "PDBs" / "T1124.pdb")
    kept = [ln for ln in T1124.read_text().splitlines()
            if not ln.startswith(("ATOM", "HETATM"))
            or ln[21] == "A" or (ln[21] == "B" and int(ln[22:26]) <= T1124_CUT_B)]
    (d / "PDBs" / "T1124CUT.pdb").write_text("\n".join(kept) + "\n")
    header, row = (SKEMPI_MINI / "skempi_v2.csv").read_text().splitlines()[:2]
    rows = []
    for full, cut in zip(("VA11K", "LA85Y", "VB11C", "PA356D"),
                         ("SA14T", "AB48I", "KA310L", "LB85N")):
        rows += [("T1124", full), ("T1124CUT", cut)]
    fields = row.split(";")
    lines = [header] + [";".join([f"{pdb}_A_B", m, m] + fields[3:]) for pdb, m in rows]
    (d / "skempi_v2.csv").write_text("\n".join(lines) + "\n")
    return d, [(d / "PDBs" / f"{pdb}.pdb", m) for pdb, m in rows]


def phase_ddg_eval_esm(torch, esm_weights):
    """``cli.ddg --eval_csv --mode esm`` on the card over ``esm_scan_table``
    (two complexes of one length bucket, so the attention kernel masks
    other key counts in the rows of one launch): 33 attention launches a
    batch, the rows in the CSV's order, and each prediction held to
    ``cli.ddg --mode esm`` on that mutation alone (``DDG_ESM_SCAN_TOL``)."""
    from packppi_torch.cli import ddg

    data, rows = esm_scan_table("skempi_esm_scan")
    common = ["--mode", "esm", "--esm_ckpt", str(esm_weights), "--seed", "0",
              "--no_strict_parity"]
    outdir = OUT / "ddg_eval_esm"
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    summary = ddg.run_cli(["--eval_csv", str(data), "--outdir", str(outdir), *common])
    wall = time.perf_counter() - t0
    got = read_launches()
    n_batches = -(-len(rows) // 4)
    log(f"cli.ddg --eval_csv --mode esm, T1124 and T1124CUT interleaved: {summary['n']} "
        f"mutations in {n_batches} batches, {wall:.2f} s (reading the 650M weights included); "
        f"launches {got}")
    if got != expect_launches(attention=33 * n_batches, gemm=4 * 33 * n_batches):
        fail(f"cli.ddg --eval_csv --mode esm: launches {got}, expected {33 * n_batches} "
             f"attention and {4 * 33 * n_batches} gemm")
    scan = [json.loads(line) for line in open(outdir / "ddg_eval.jsonl")]
    if [(r["complex"].split("_")[0], r["mutstr"]) for r in scan] != \
            [(pdb.stem, m) for pdb, m in rows]:
        fail("cli.ddg --eval_csv --mode esm: rows out of the CSV's order")
    worst = 0.0
    for (pdb, m), r in zip(rows, scan):
        alone = ddg.run_cli(["--input", str(pdb), "--mutstr", m,
                             "--outdir", str(OUT / "ddg_esm_alone"), *common])
        d = abs(r["ddg_pred"] - alone)
        worst = max(worst, d)
        log(f"  {pdb.stem} {m}: scan {r['ddg_pred']:.6f}  alone {alone:.6f}  |d| {d:.3e}")
    log(f"  scan against one mutation at a time: max |d| {worst:.3e} kcal/mol (limit "
        f"{DDG_ESM_SCAN_TOL:g}) {'ok' if worst <= DDG_ESM_SCAN_TOL else 'OUT OF TOLERANCE'}")
    if not worst <= DDG_ESM_SCAN_TOL:
        fail("cli.ddg --eval_csv --mode esm disagrees with the single-mutation path")


def phase_ddg_eval(torch):
    """``cli.ddg --eval_csv tests/fixtures/skempi_mini`` in network mode on
    the converted shipped checkpoints: message and chain launches counted
    (5 of each per backbone or mutation-stack evaluation, four evaluations
    per batch), each prediction held to the JAX package's in
    ``ddg_eval.jsonl`` (which ``tools/check_jax_ddg_eval.py`` reproduces
    with the JAX package), the summary to ``ddg_eval_summary.json``."""
    from packppi_torch.cli import ddg
    from packppi_torch.data import bucket_length
    from packppi_torch.data.skempi import load_skempi_entries
    from packppi_torch.structure import from_pdb_file

    outdir = OUT / "ddg_eval"
    argv = ["--eval_csv", str(SKEMPI_MINI), "--mode", "network",
            "--ckpt", str(AFFINITY_CKPTS / "torch_affinity.pt"),
            "--pre_ckpt", str(AFFINITY_CKPTS / "torch_backbone.pt"), "--outdir", str(outdir)]
    entries = load_skempi_entries(SKEMPI_MINI, "PDBs")
    per_bucket = {}
    for e in entries:
        b = bucket_length(len(from_pdb_file(e["pdb_path"], mse_to_met=True).aaindex))
        per_bucket[b] = per_bucket.get(b, 0) + 1
    n_batches = sum(-(-n // 4) for n in per_bucket.values())
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    summary = ddg.run_cli(argv)
    wall = time.perf_counter() - t0
    got = read_launches()
    expect = {**{k: 0 for k in got}, "message": 20 * n_batches, "chain": 20 * n_batches}
    log(f"cli.ddg --eval_csv skempi_mini network: {summary['n']} mutations in {n_batches} "
        f"batches, {wall:.2f} s; launches {got}; summary {summary}")
    if got != expect:
        fail(f"cli.ddg --eval_csv: launches {got}, expected {expect}")
    mine = [json.loads(line) for line in open(outdir / "ddg_eval.jsonl")]
    ref = [json.loads(line) for line in open(AFFINITY_CKPTS / "ddg_eval.jsonl")]
    if [(a["complex"], a["mutstr"]) for a in mine] != [(b["complex"], b["mutstr"]) for b in ref]:
        fail("cli.ddg --eval_csv evaluated other mutations than the JAX package's file")
    worst = max(abs(a["ddg_pred"] - b["ddg_pred"]) for a, b in zip(mine, ref))
    shipped = json.loads((AFFINITY_CKPTS / "ddg_eval_summary.json").read_text())
    d_summary = {k: abs(summary[k] - shipped[k]) for k in ("rmse", "pearson", "spearman")}
    log(f"  per mutation against the JAX package's predictions: max |d| {worst:.3e} kcal/mol "
        f"(limit {DDG_EVAL_TOL:g}); summary against the shipped one (four decimals): "
        f"{ {k: f'{v:.2e}' for k, v in d_summary.items()} } (limit 5e-4)")
    if worst > DDG_EVAL_TOL or max(d_summary.values()) >= 5e-4:
        fail("cli.ddg --eval_csv disagrees with the JAX package's predictions")


# The variant routings of the packing network: kernel rows 4 (message_geom),
# 5 (message_gather), 1b (message_chain) and 6 (layer_node, layer_edge), and
# local geometry (message_feat over local features)
MESSAGE_OPS_PER_ROW = 2 * (128 + 72 + 2 * 128) * 128   # 116,736 per edge row
CHAIN_OPS_PER_ROW = 2 * 2 * 128 * 512                  # 262,144 per chain row
# name -> (NetworkConfig fields, FOLD_EDGE_CHAIN, launches per network
# evaluation with the last edge pass skipped: 3 node and 2 edge passes)
VARIANTS = {
    "geom": (dict(fused_messages="geom"), False, dict(message_geom=5, chain=5)),
    "geom_gather": (dict(fused_messages="geom_gather"), False, dict(message_gather=5, chain=5)),
    "fold": ({}, True, dict(message=3, chain=3, message_chain=2)),
    "fused_layers": (dict(fused_layers=True), False, dict(layer_node=3, layer_edge=2)),
    "local": (dict(fused_messages=True, geometry_mode="local"), False,
              dict(message_feat=5, chain=5)),
}
NODE_BLOCK_SWEEP = (2, 4, 8, 16)


class folded_edge_chain:
    """``packppi_torch.models.ipmp.FOLD_EDGE_CHAIN`` set for a ``with`` block."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        import packppi_torch.models.ipmp as ipmp

        self.prev, ipmp.FOLD_EDGE_CHAIN = ipmp.FOLD_EDGE_CHAIN, self.on

    def __exit__(self, *exc):
        import packppi_torch.models.ipmp as ipmp

        ipmp.FOLD_EDGE_CHAIN = self.prev


def variant_cases(static, h_V, layer, frames, mask_V, act="relu"):
    """(kernel, variant, kernel fn, plain fn, operands, rows of a first
    block, edge rows of messages, chain rows) for the five new kernels on
    layer 0 of the network, with activation ``act``."""
    from packppi_torch.models.ipmp import chain_weights
    from packppi_torch.ops.layer import (NODES_PER_BLOCK, layer_edge, layer_edge_plain,
                                         layer_node, layer_node_plain)
    from packppi_torch.ops.message import (message_chain, message_chain_plain, message_gather,
                                           message_geom, message_geom_plain, message_plain)

    K = static.idx.shape[-1]
    edge_rows = static.idx.numel()
    node_rows = h_V.shape[0] * h_V.shape[1]
    cases = []
    for variant, pool, mlp, pts in (("node", True, layer.node_message_fn, layer.points_fn_node),
                                    ("edge", False, layer.edge_message_fn, layer.points_fn_edge)):
        args = (h_V, static.h_E, static.idx, layer._points(pts, h_V), frames, static.mask_attend)
        first = max(ROWS_PER_BLOCK // K, 1) if pool else ROWS_PER_BLOCK
        bind = lambda f, pool=pool: (lambda *o: f(*o, pool, act))
        with_act = lambda f: functools.partial(f, act=act)
        cases.append(("message_geom", variant, bind(message_geom), bind(message_geom_plain),
                      mlp.geom_operands(*args), first, edge_rows, 0))
        cases.append(("message_gather", variant, bind(message_gather), bind(message_plain),
                      mlp.operands(*args), first, edge_rows, 0))
        feat = mlp.feat_operands(*args)
        per_i, pjg, h_E, geom, mask, *msg_w = feat
        if pool:
            cw = chain_weights(layer.norm[0], layer.node_dense, layer.norm[1])
            cases.append(("layer_node", variant, with_act(layer_node),
                          with_act(layer_node_plain),
                          (h_V, per_i, pjg, h_E, geom, mask, mask_V, *msg_w, *cw),
                          NODES_PER_BLOCK, edge_rows, node_rows))
        else:
            cw = chain_weights(layer.norm[2], layer.edge_dense, layer.norm[3])
            cases.append(("message_chain", variant, with_act(message_chain),
                          with_act(message_chain_plain), (*mlp.operands(*args), *cw), first,
                          edge_rows, edge_rows))
            cases.append(("layer_edge", variant, with_act(layer_edge), with_act(layer_edge_plain),
                          (h_E, per_i, pjg, geom, mask, *msg_w, *cw), first, edge_rows,
                          edge_rows))
    return cases


def check_variant(torch, name, fn, plain, ops, first, dtype_name, mean_rel=BF16_MEAN_REL):
    """One new kernel against its plain version (and, in bf16, the two
    controls); returns (output, max |d|)."""
    got = fn(*ops)
    torch.cuda.synchronize()
    want = plain(*ops)
    err = check_close(f"{name} {tuple(got.shape)}", got, want, dtype_name, mean_rel)
    if dtype_name == "bfloat16":
        check_controls(name, got, want, plain(*upcast(ops)).to(got.dtype), first, mean_rel)
    return got, err


def check_same_function(torch, name, got, other, dtype_name, bits=False):
    """Two kernels that compute one function: within the kernel tolerance,
    and whether they agree bit for bit (which ``bits`` requires)."""
    check_close(name, got, other, dtype_name)
    same = torch.equal(got, other)
    log(f"    bit for bit: {same}")
    if bits and not same:
        fail(f"{name}: not bit for bit")


def eleven_copies_batch(torch, copies=11):
    """One structure of ``copies`` T1124s laid 120 A apart along x, residue
    indices offset (L = 8,151 for 11), on the card."""
    import numpy as np

    from packppi_torch.data import stack_batch
    from packppi_torch.structure import featurize, from_pdb_file

    f = featurize(from_pdb_file(T1124, mse_to_met=True))
    stride = int(f["residue_index"].max()) + 100
    big = {}
    for k, v in f.items():
        parts = [v] * copies
        if k == "X":
            parts = [v + np.array([120.0 * c, 0, 0], v.dtype) for c in range(copies)]
        elif k == "residue_index":
            parts = [v + stride * c for c in range(copies)]
        big[k] = np.concatenate(parts, 0)
    L = len(big["residue_type"])
    return stack_batch([big], "cuda", target_len=L)


def phase_variant_kernels(torch, timer):
    """The five new kernels against their plain versions on T1124's real graph
    and activations (L = 768, K = 32), node and edge, float32 and bf16 with
    the two controls, timed beside the plain versions; the gathered-operand
    and in-kernel-gather routes against the lanes kernel, the folded edge
    pass against message-then-chain; the node pass's blocking swept; the
    gather route at 8,151 residues, the fold at K = 24, the layer passes at
    L = 741. Returns the records."""
    from packppi_torch.models.ipmp import chain_operands
    from packppi_torch.ops.chain import chain
    from packppi_torch.ops.layer import layer_node
    from packppi_torch.ops.message import message, message_gather, message_plain

    records = {}
    for dtype_name in ("float32", "bfloat16"):
        net, batch = t1124_network(torch, dtype_name, "cuda")
        with torch.no_grad():
            static, h_V, layer, frames = layer0_state(torch, net, batch)
            for name, variant, fn, plain, ops, first, erows, crows in variant_cases(
                    static, h_V, layer, frames, batch.residue_mask):
                label = f"{name} {variant} {dtype_name}"
                got, err = check_variant(torch, label, fn, plain, ops, first, dtype_name)
                if name in ("message_geom", "message_gather"):
                    mlp = layer.node_message_fn if variant == "node" else layer.edge_message_fn
                    lanes = message(*mlp.operands(*message_args(static, h_V, layer, frames,
                                                                variant)), variant == "node")
                    check_same_function(torch, f"  {label} against the message kernel", got,
                                        lanes, dtype_name)
                if name == "message_chain":
                    msg = message(*ops[:15], False)
                    two = chain(*chain_operands(static.h_E, msg, static.mask_attend,
                                                layer.norm[2], layer.edge_dense, layer.norm[3]),
                                True).reshape(got.shape)
                    # T1124's edge pass: 384 tiles, so chain.cu runs the fold's form
                    check_same_function(torch, f"  {label} against message then chain", got, two,
                                        dtype_name, bits=True)
                nb = sum(_nbytes(t) for t in ops) + _nbytes(got)
                no = MESSAGE_OPS_PER_ROW * erows + CHAIN_OPS_PER_ROW * crows
                records[(name, dtype_name, variant)] = dict(
                    max_abs_err=err, ms=timer(lambda: fn(*ops)),
                    plain_ms=timer(lambda: plain(*ops), 5),
                    bound=bound_ms(nb, no, dtype_name), bytes=nb, operations=no)
                if name == "layer_node" and dtype_name == "bfloat16":
                    for npb in NODE_BLOCK_SWEEP:
                        alt = layer_node(*ops, nodes_per_block=npb)
                        same = torch.equal(alt, got)
                        log(f"    layer_node bf16, {npb} nodes a block: "
                            f"{timer(lambda: layer_node(*ops, nodes_per_block=npb)):.4f} ms, "
                            f"equal to the default bit for bit: {same}")
                        if not same:
                            fail("layer_node's result depends on its blocking")

    # the gather route at 8,151 residues (where the TPU's one-hot does not fit)
    net, _ = t1124_network(torch, "bfloat16", "cuda")
    big = eleven_copies_batch(torch)
    with torch.no_grad():
        static, h_V, layer, frames = layer0_state(torch, net, big)
        for variant, mlp, pool in (("node", layer.node_message_fn, True),
                                   ("edge", layer.edge_message_fn, False)):
            ops = mlp.operands(*message_args(static, h_V, layer, frames, variant))
            got = message_gather(*ops, pool)
            torch.cuda.synchronize()
            check_close(f"message_gather {variant} bf16 11xT1124 {tuple(got.shape)}", got,
                        message_plain(*ops, pool), "bfloat16")
            log(f"    time: kernel {timer(lambda: message_gather(*ops, pool)):.4f} ms")
        del static, h_V

        # the fold at K = 24 (no multiple of the 64-row tile), and the layer
        # passes at a length their node block does not divide
        for dtype_name in ("float32", "bfloat16"):
            net, batch = t1124_network(torch, dtype_name, "cuda")
            static, h_V, layer, frames = layer0_state(torch, net, batch)
            k24 = static._replace(h_E=static.h_E[:, :, :24].contiguous(),
                                  idx=static.idx[:, :, :24].contiguous(),
                                  mask_attend=static.mask_attend[:, :, :24].contiguous())
            for name, variant, fn, plain, ops, first, _, _ in variant_cases(
                    k24, h_V, layer, frames, batch.residue_mask):
                if name == "message_chain":
                    check_variant(torch, f"{name} {dtype_name} K=24", fn, plain, ops, first,
                                  dtype_name)
            b741 = t1124_train_batch("cuda", 1, 741)
            static, h_V, layer, frames = layer0_state(torch, net, b741)
            for name, variant, fn, plain, ops, first, _, _ in variant_cases(
                    static, h_V, layer, frames, b741.residue_mask):
                if name.startswith("layer_"):
                    check_variant(torch, f"{name} {dtype_name} L=741", fn, plain, ops, first,
                                  dtype_name)
    for (k, d, v), r in records.items():
        log(f"  time {k} {v} {d} T1124: kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
            f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]}; {r['bytes']} bytes, "
            f"{r['operations']} operations)")
    return records


# the kernels of the variant routings whose products the SASS must show on
# tensor cores: HGMMA (wgmma) in bf16, HMMA (mma.sync) in float32; the
# gathered-operand message kernel (row 4) has a POOL instantiation of each,
# and every one a K <= 64 and a K > 64 (SPAN, its last flag) instantiation
SASS_KERNELS = {"message": ("message_chain_kernel", "message_geom_kernel"),
                "layer": ("layer_node_kernel", "layer_edge_kernel")}
SASS_INSTANCES = 20


def phase_sass():
    """SASS instruction counts (``tools/sass_counts.py``) of the gathered-operand
    message kernel, the fold's and the whole-layer passes' kernels; fails
    where a product is not on tensor cores. The FFMA left are the geometry,
    the LayerNorms and the pool."""
    import re

    sys.path.insert(0, str(REPO / "tools"))
    from sass_counts import counts
    from packppi_torch.ops import _build

    paths = _build.build_all(list(SASS_KERNELS))
    seen = 0
    for source, names in SASS_KERNELS.items():
        for fn, c in counts(paths[source]).items():
            for name in names:
                m = re.search(rf"{name}I(13__nv_bfloat16|f)((?:Lb[01]E)+)E", fn)
                if not m:
                    continue
                seen += 1
                dtype = "float32" if m.group(1) == "f" else "bfloat16"
                flags = re.findall(r"Lb([01])E", m.group(2))
                pool = {"0": " edge", "1": " pool"}[flags[0]] if len(flags) == 2 else ""
                span = " K>64" if flags[-1] == "1" else ""
                unit = "HMMA" if dtype == "float32" else "HGMMA"
                log(f"  sass {name} {dtype}{pool}{span}: HGMMA {c['HGMMA']}, HMMA {c['HMMA']}, "
                    f"FFMA {c['FFMA']}")
                if c[unit] == 0:
                    fail(f"{name} {dtype} has no {unit}: its products are not on tensor cores")
    if seen != SASS_INSTANCES:
        fail(f"sass: found {seen} of the {SASS_INSTANCES} instantiations of {SASS_KERNELS}")


def message_args(static, h_V, layer, frames, variant):
    pts = layer.points_fn_node if variant == "node" else layer.points_fn_edge
    return (h_V, static.h_E, static.idx, layer._points(pts, h_V), frames, static.mask_attend)


def variant_model(torch, name, dtype_name, weights=PIPELINE_GOLDEN):
    from packppi_torch.models import NetworkConfig, TorsionalDiffusion
    from packppi_torch.weights import load_weights

    model = TorsionalDiffusion(NetworkConfig(compute_dtype=dtype_name, **VARIANTS[name][0]))
    load_weights(model.net, weights)
    return model.to("cuda")


def phase_golden_variants(torch):
    """The 1BRS float32 30-step golden replay under each variant routing,
    with its launch counts (5 network passes a step)."""
    import numpy as np

    from packppi_torch.data import stack_batch
    from packppi_torch.structure import featurize, from_pdb_file

    golden = np.load(PIPELINE_GOLDEN)
    feats = featurize(from_pdb_file(ONE_BRS, mse_to_met=True))
    batch = stack_batch([feats], "cuda", target_len=len(feats["residue_type"]))
    mask = batch.SC_D_mask[0].cpu().numpy() > 0
    wrap = lambda d: np.minimum(np.abs(d), 2 * np.pi - np.abs(d))
    for name, (_, fold, per_eval) in VARIANTS.items():
        model = variant_model(torch, name, "float32")
        zero_launches()
        with folded_edge_chain(fold):
            sc, traj = model.sample(batch, init_sc=golden["init_sc"], return_trajectory=True)
        got = read_launches()
        expect = expect_launches(**{k: v * STEPS for k, v in per_eval.items()})
        worst = max(wrap(traj[s, 0].cpu().numpy() - golden["traj"][s, 0])[mask].max()
                    for s in range(STEPS))
        final = wrap(sc[0].cpu().numpy() - golden["final_sc"][0])[mask].max()
        log(f"golden replay {name} (1BRS, float32, {STEPS} steps): worst step {worst:.3e} rad, "
            f"final {final:.3e} rad (bound 5e-4); launches "
            f"{ {k: v for k, v in got.items() if v} }")
        if got != expect:
            fail(f"golden replay {name}: launches {got}, expected {expect}")
        if not (worst < 5e-4 and final < 5e-4):
            fail(f"golden replay {name} out of tolerance")


def phase_pack_variants(torch, reps=5, names=tuple(VARIANTS)):
    """The bf16 T1124 30-step pack under each variant routing (of
    ``names``): through
    ``TorsionalDiffusion.sample`` (the function ``cli.pack`` calls) for the
    four kernel routings and through ``cli.pack --geometry local`` for local
    geometry; launch counts asserted, the sampling seconds (median of
    ``reps`` more), peak memory, a profile of one network evaluation; and
    each routing's float32 T1124 network evaluation against the default
    one's. Returns the main run's launches per routing."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from packppi_torch.cli import pack
    from packppi_torch.data import stack_batch
    from packppi_torch.structure import featurize, from_pdb_file

    batch = stack_batch([featurize(from_pdb_file(T1124, mse_to_met=True))], "cuda")
    launches = {}
    for name in names:
        _, fold, per_eval = VARIANTS[name]
        model = variant_model(torch, name, "bfloat16")
        with folded_edge_chain(fold):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_launches()
            if name == "local":
                args = pack.build_parser().parse_args([
                    "--input", str(T1124), "--ckpt", str(PIPELINE_GOLDEN), "--precision",
                    "bfloat16", "--n_steps", str(STEPS), "--seed", "0", "--geometry", "local",
                    "--outdir", str(OUT / "pack_t1124_local")])
                first = pack.run(args)["sampling_seconds"]
            else:
                g = torch.Generator(device="cuda").manual_seed(0)
                t0 = time.perf_counter()
                sc = model.sample(batch, g, n_steps=STEPS)
                torch.cuda.synchronize()
                first = time.perf_counter() - t0
                if not bool(torch.isfinite(sc).all()):
                    fail(f"pack {name}: non-finite chis")
            got = read_launches()
            peak = torch.cuda.max_memory_allocated() / 2 ** 20
            launches[name] = got
            expect = expect_launches(**{k: v * STEPS for k, v in per_eval.items()})
            if got != expect:
                fail(f"pack {name}: launches {got}, expected {expect}")
            if name == "local":
                check_structure(OUT / "pack_t1124_local")
            times = []
            for seed in range(reps):
                g = torch.Generator(device="cuda").manual_seed(seed)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model.sample(batch, g, n_steps=STEPS)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            q = np.percentile(times, [0, 25, 50, 75, 100])
            log(f"pack T1124 bf16 {STEPS} steps, {name}: first {first:.4f} s; {reps} more: "
                f"median {q[2]:.4f} s, quartiles {q[1]:.4f}-{q[3]:.4f}, min {q[0]:.4f}, max "
                f"{q[4]:.4f}; peak memory {peak:.1f} MiB; launches "
                f"{ {k: v for k, v in got.items() if v} }")

            net = model.net
            with torch.no_grad():
                static = net.encode_static(batch)
                t = torch.full(batch.residue_mask.shape, 0.5, device="cuda")
                evaluate = lambda: net(batch, batch.SC_D, t, static=static,
                                       skip_last_edge_update=True)
                for _ in range(3):
                    evaluate()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(10):
                    evaluate()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) / 10 * 1e3
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range(10):
                        evaluate()
                    torch.cuda.synchronize()
            report_profile(f"bf16 T1124 network evaluation, {name}", prof, wall_ms, 10, "eval")

    # float32: each routing's evaluation against the default routing's
    g = torch.Generator().manual_seed(0)
    sc = (batch.SC_D.cpu() + torch.randn(batch.SC_D.shape, generator=g)).cuda()
    t = torch.full(batch.residue_mask.shape, 0.5, device="cuda")
    with torch.no_grad():
        ref_net, _ = t1124_network(torch, "float32", "cuda")
        static = ref_net.encode_static(batch)
        s_ref, h_ref = ref_net(batch, sc, t, static=static, skip_last_edge_update=True)
        for name in names:
            fold = VARIANTS[name][1]
            net = variant_model(torch, name, "float32").net
            with folded_edge_chain(fold):
                s, h = net(batch, sc, t, static=net.encode_static(batch),
                           skip_last_edge_update=True)
            ds = (s - s_ref).abs().max().item()
            dh = (h - h_ref).abs().max().item()
            log(f"T1124 float32 network, {name} against geom_lanes: score max|d| {ds:.3e}, "
                f"h_V max|d| {dh:.3e} (bound 1e-4)")
            if not (ds <= 1e-4 and dh <= 1e-4):
                fail(f"the {name} network disagrees with the default routing")
    return launches


# this slice's routes: cli.pack --no_fused, cli.train_affinity, cli.serve
UNFUSED_BF16_TOL = 6e-2        # the tests' bf16 bound between the two routes
AFFINITY_BATCH = 2
AFFINITY_STEP_REPS = 10
SERVE_REPS = 3
TWO_FTL = REPO / "tests" / "fixtures" / "2ftl.pdb"


def time_evaluations(torch, what, evaluate, reps=10):
    """Wall time of ``evaluate`` (mean of ``reps``, synchronized) and its
    device busy time from the profiler: ``(wall_ms, busy_ms or None)``."""
    from torch.profiler import ProfilerActivity, profile

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
    return wall_ms, report_profile(what, prof, wall_ms, reps, "call")


def phase_pack_unfused(torch):
    """``cli.pack --no_fused`` on T1124 (bf16, 30 steps, the metric suite):
    no kernel launch at all. Then one T1124 network evaluation under the
    unfused route against the kernel route on the same weights and inputs
    (float32 within phase_network_vs_cpu's 1e-3, bf16 within 6e-2, each
    rounding at its own points), each route's wall, busy and idle share."""
    from packppi_torch.cli import pack
    from packppi_torch.models import ChiScoreNetwork, NetworkConfig

    outdir = OUT / "pack_unfused_t1124"
    args = pack.build_parser().parse_args([
        "--input", str(T1124), "--ckpt", str(PIPELINE_GOLDEN), "--precision", "bfloat16",
        "--n_steps", str(STEPS), "--seed", "0", "--no_fused", "--outdir", str(outdir)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    metrics = pack.run(args)
    wall = time.perf_counter() - t0
    got = read_launches()
    log(f"pack T1124 bf16 {STEPS} steps --no_fused: sampling {metrics['sampling_seconds']:.4f} s, "
        f"whole run {wall:.3f} s, peak memory {torch.cuda.max_memory_allocated() / 2 ** 20:.1f} "
        f"MiB, launches {got}")
    if got != expect_launches():
        fail(f"--no_fused launched kernels: {got}")
    check_structure(outdir)
    check_metric_suite(metrics, outdir, False)

    for dtype_name, tol in (("float32", 1e-3), ("bfloat16", UNFUSED_BF16_TOL)):
        net, batch = t1124_network(torch, dtype_name, "cuda")
        unfused = ChiScoreNetwork(NetworkConfig(compute_dtype=dtype_name, fused_messages=False,
                                                fused_chain=False)).eval()
        unfused.load_state_dict(net.state_dict())
        unfused.to("cuda")
        g = torch.Generator().manual_seed(0)
        sc = batch.SC_D + torch.randn(batch.SC_D.shape, generator=g).to("cuda")
        t = torch.full(batch.residue_mask.shape, 0.5, device="cuda")
        results = {}
        with torch.no_grad():
            static = net.encode_static(batch)
            for name, model, want in (("kernels", net, 5), ("unfused", unfused, 0)):
                evaluate = functools.partial(model, batch, sc, t, static=static,
                                             skip_last_edge_update=True)
                zero_launches()
                results[name] = evaluate()
                launches = read_launches()
                if launches != expect_launches(message=want, chain=want):
                    fail(f"{dtype_name} T1124 evaluation, {name} route: launches {launches}")
                time_evaluations(torch, f"{dtype_name} T1124 network evaluation, {name} route",
                                 evaluate)
        ds, dh = ((results["kernels"][i] - results["unfused"][i]).abs().max().item()
                  for i in (0, 1))
        log(f"T1124 {dtype_name} network, kernel route vs unfused route: score max|d| {ds:.3e}, "
            f"h_V max|d| {dh:.3e} (bound {tol:g})")
        if not (ds <= tol and dh <= tol):
            fail(f"the unfused route disagrees with the kernel route in {dtype_name}")


def skempi_copy(name, rows=None):
    """``skempi_mini`` copied to ``smoke_out/<name>`` with its PDB files and
    no feature cache; ``rows`` ((complex, n), ...) keeps the first n rows
    of each complex named."""
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    (d / "PDBs").mkdir(parents=True)
    for f in (SKEMPI_MINI / "PDBs").iterdir():
        shutil.copy(f, d / "PDBs" / f.name)
    lines = (SKEMPI_MINI / "skempi_v2.csv").read_text().splitlines()
    keep = lines[1:]
    if rows is not None:
        keep = [ln for pdb, n in rows for ln in [x for x in lines[1:] if x.startswith(pdb)][:n]]
    (d / "skempi_v2.csv").write_text("\n".join([lines[0], *keep]) + "\n")
    return d


def affinity_records(run):
    return [json.loads(ln)
            for ln in (Path(run) / "logs" / "metrics.jsonl").read_text().splitlines()]


def phase_train_affinity(torch):
    """``cli.train_affinity`` for one epoch at the published widths of
    ``configs/model/affinity.yaml`` on ``skempi_mini`` fold 0 of 2 (94
    training mutations of 1BRS, 32 validation mutations of 2FTL), batch 2,
    float32, the backbone from ``docs/ckpts/diffusion_crops/torch_state.pt``:
    launches as the code gives them (a training step evaluates the frozen
    backbone on the wild type and the mutant, 3 node and 2 edge passes each:
    10 message and 10 chain launches, the mutation stack in train() runs no
    kernel; a validation batch adds the mutation stack's two evaluations in
    eval(): 20 and 20, the loss and the predictions from one forward),
    finite records, the backbone artifact through ``cli.ddg`` giving the
    run's validation metrics; the time of one training step (wall, busy,
    idle share) and its peak memory; one step under the knobs configuration
    against the unfused route (loss and every gradient). Returns the
    epoch's launches."""
    from packppi_torch.cli import ddg, train_affinity
    from packppi_torch.data.skempi import cv_split, load_skempi_entries

    data = skempi_copy("skempi_train")
    split = cv_split(load_skempi_entries(data, "PDBs"), 2, 0, 42)
    if (len(split["train"]), len(split["valid"])) != (94, 32):
        fail(f"skempi_mini fold 0: {len(split['train'])} / {len(split['valid'])} mutations")
    steps, val_batches = 94 // AFFINITY_BATCH, -(-32 // AFFINITY_BATCH)
    base = OUT / "affinity_run"
    shutil.rmtree(base, ignore_errors=True)
    argv = [f"data.data_dir={data}", "data.num_cvfolds=2", "data.cvfold_index=0",
            f"data.batch_size={AFFINITY_BATCH}", "trainer.max_epochs=1",
            f"pre_checkpoint_path={SHIPPED_CKPT}", f"output_dir={base}", "logger=[jsonl]"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    (result,) = train_affinity.main(argv)
    wall = time.perf_counter() - t0
    got = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    m, run = result["metrics"], Path(result["run_dir"])
    (rec,) = affinity_records(run)
    log(f"cli.train_affinity, one epoch ({steps} steps, {val_batches} validation batches): "
        f"{wall:.2f} s (featurizing the 126 mutations into the cache included), peak memory "
        f"{peak:.1f} MiB, launches {got}; record {rec}")
    expect = expect_launches(message=10 * steps + 20 * val_batches,
                             chain=10 * steps + 20 * val_batches)
    if got != expect:
        fail(f"cli.train_affinity: launches {got}, expected {expect}")
    keys = {"step", "train/loss", "val/loss", "val/pearson", "val/spearman", "val/rmse"}
    if set(rec) != keys or rec["step"] != steps or not all(map(math.isfinite, rec.values())):
        fail(f"cli.train_affinity: record {rec}")

    # the backbone artifact and the best checkpoint through cli.ddg on the
    # validation mutations: the run's validation metrics
    val = skempi_copy("skempi_val", rows=(("2FTL", 32),))
    summary = ddg.run_cli(["--eval_csv", str(val), "--ckpt", m["best_ckpt"],
                           "--pre_ckpt", str(run / "backbone.pt"),
                           "--outdir", str(OUT / "affinity_ddg")])
    d = {k: abs(summary[k] - rec[f"val/{k}"]) for k in ("rmse", "pearson", "spearman")}
    log(f"  cli.ddg --pre_ckpt <run>/backbone.pt --ckpt <best>: {summary}; against the run's "
        f"validation record: {d} (limit 1e-4)")
    if max(d.values()) > 1e-4:
        fail("cli.ddg with the run's artifacts does not give its validation metrics")

    affinity_step_timing(torch, run, m["best_ckpt"], data)
    affinity_knobs_step(torch, data)
    return got


def affinity_batch(torch, data, n=AFFINITY_BATCH):
    from packppi_torch.data.skempi import load_skempi_entries, skempi_features, stack_affinity_batch
    from packppi_torch.structure import from_pdb_file

    entries = load_skempi_entries(data, "PDBs")[:n]
    return stack_affinity_batch([skempi_features(from_pdb_file(e["pdb_path"], mse_to_met=True),
                                                 e["mutations"], ddg=e["ddG"]) for e in entries],
                                "cuda")


def affinity_step_timing(torch, run, ckpt, data):
    """One training step of the trainer (``make_affinity_train_step``) at
    batch 2 on 1BRS mutations: wall, busy, idle share, peak memory."""
    from packppi_torch.models import NetworkConfig
    from packppi_torch.models.affinity import AffinityModel
    from packppi_torch.train.loop import affinity_optimizer, make_affinity_train_step
    from packppi_torch.weights import load_weights

    model = AffinityModel(NetworkConfig())
    load_weights(model.backbone.net, run / "backbone.pt")
    load_weights(model.net, ckpt)
    model.to("cuda")
    step = make_affinity_train_step(model, affinity_optimizer(model, 1e-4, 1e-12), 1e-4)
    batch = affinity_batch(torch, data)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wall_ms, _ = time_evaluations(torch, "affinity training step, B=2 L=256 float32",
                                  lambda: step(batch, 0), AFFINITY_STEP_REPS)
    log(f"  affinity training step: {wall_ms:.4f} ms wall, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB")


def affinity_knobs_step(torch, data):
    """One affinity loss and its gradients under the knobs configuration
    (the backbone's evaluations and the mutation stack through the
    feature-message and chain kernels, differentiable in the stack)
    against the unfused route, same weights and batch, dropout 0. The loss
    within 1e-5 relative; the gradients at phase_loss_grads' limits for two
    evaluation orders (2e-3 of each parameter's max, 2e-4 of the largest):
    the antisymmetric loss pools the difference of the mutant's and the
    wild type's features, so a parameter's gradient is the difference of
    two nearly equal sums, and the kernels' float32 products (3xTF32)
    show in it more than in the diffusion loss
    (``tools/probe_affinity_grads.py`` reads each pair of routes and
    devices)."""
    from packppi_torch.models import NetworkConfig
    from packppi_torch.models.affinity import AffinityModel
    from packppi_torch.weights import init_weights, load_weights

    batch = affinity_batch(torch, data)
    results = {}
    for name, cfg, want in (("kernels", TRAIN_KNOBS, 20),
                            ("unfused", dict(dropout=0.0, fused_messages=False,
                                             fused_chain=False), 0)):
        model = AffinityModel(NetworkConfig(**cfg))
        load_weights(model.backbone.net, SHIPPED_CKPT)
        init_weights(model.net, 7)
        model.to("cuda")
        zero_launches()
        loss = model.loss(batch, deterministic=False)
        loss.backward()
        launches = read_launches()
        if launches != expect_launches(message_feat=want, chain=want):
            fail(f"affinity loss ({name}): launches {launches}")
        results[name] = (loss.item(), param_grads(model.net))
        log(f"  affinity loss B=2 float32, {name}: {loss.item():.7f}, launches message_feat "
            f"{launches['message_feat']}, chain {launches['chain']}")
    d = abs(results["kernels"][0] - results["unfused"][0])
    if not d <= 1e-5 * abs(results["unfused"][0]):
        fail(f"affinity loss: kernels vs unfused differ by {d:.3e}")
    compare_param_grads(f"affinity gradients, kernels vs unfused (loss |d| {d:.3e})",
                        results["kernels"][1], results["unfused"][1], GRAD_REL_TOL_DEVICES)


def phase_train_affinity_esm(torch, esm_weights):
    """``cli.train_affinity model.mode=esm`` on 4 + 4 mutations, one epoch,
    embeddings extracted with ESM-2 650M (the random weights of
    ``phase_ddg_esm``'s file): 33 attention launches per mutation (wild
    type and mutant in one forward), finite losses. Returns the attention
    and gemm launches."""
    from packppi_torch.cli import train_affinity

    data = skempi_copy("skempi_esm", rows=(("1BRS", 4), ("2FTL", 4)))
    base = OUT / "affinity_esm_run"
    shutil.rmtree(base, ignore_errors=True)
    argv = [f"data.data_dir={data}", "data.num_cvfolds=2", f"data.batch_size={AFFINITY_BATCH}",
            "trainer.max_epochs=1", "model.mode=esm", f"esm_weights={esm_weights}",
            f"output_dir={base}", "logger=[jsonl]"]
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    (result,) = train_affinity.main(argv)
    wall = time.perf_counter() - t0
    got = read_launches()
    extracted = len(list((data / "dataset_cache").glob("esm_*.npz")))
    (rec,) = affinity_records(result["run_dir"])
    log(f"cli.train_affinity model.mode=esm, 4 + 4 mutations: {wall:.2f} s (reading the 650M "
        f"weights and {extracted} extractions of wild type and mutant included), launches "
        f"{got}; record {rec}")
    if extracted != 8 or got != expect_launches(attention=33 * extracted,
                                                 gemm=4 * 33 * extracted):
        fail(f"esm training: {extracted} cached pairs, launches {got}")
    if not all(math.isfinite(rec[k]) for k in ("train/loss", "val/loss")):
        fail(f"esm training: record {rec}")
    return {k: got[k] for k in ("attention", "gemm")}


def http_request(addr, method, path, body=None):
    import http.client

    conn = http.client.HTTPConnection(*addr, timeout=600)
    t0 = time.perf_counter()
    conn.request(method, path, body=body)
    resp = conn.getresponse()
    payload = json.loads(resp.read())
    seconds = time.perf_counter() - t0
    conn.close()
    return resp.status, payload, seconds


def phase_serve(torch):
    """``cli.serve`` on 127.0.0.1 (a free port) in a thread, the packing
    weights of ``pipeline_golden.npz`` and the shipped converted affinity
    checkpoints, warmed with T1124, driven over HTTP: ``/healthz``; ``/pack``
    of T1124 (2 samples, the proximal refinement, metrics: 150 message, 150
    chain, 52 clash forward and 50 gradient launches); ``/prox`` of T1124
    (51 and 50); ``/ddg`` of 2FTL KI15G (20 and 20; within 2e-3 kcal/mol of
    the JAX package's shipped prediction); each again ``SERVE_REPS`` times
    for the warm latency; two concurrent seeded ``/pack`` requests, each
    equal bit for bit to its lone answer. Any answer other than 200 fails.
    Returns the launches of one /pack, /prox and /ddg."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from packppi_torch.cli import serve
    from packppi_torch.structure import from_pdb_string

    args = serve.build_parser().parse_args([
        "--port", "0", "--ckpt", str(PIPELINE_GOLDEN),
        "--affinity_ckpt", str(AFFINITY_CKPTS / "torch_affinity.pt"),
        "--pre_ckpt", str(AFFINITY_CKPTS / "torch_backbone.pt"), "--warmup", str(T1124),
        "--tmp_dir", str(OUT / "serve_tmp")])
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    srv = serve.make_server(args)
    startup = time.perf_counter() - t0
    log(f"cli.serve: started in {startup:.3f} s (the warmup pack of T1124 included), warmup "
        f"launches {read_launches()}")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    addr = srv.server_address
    t1124 = T1124.read_text()
    with open(AFFINITY_CKPTS / "ddg_eval.jsonl") as f:
        want_ddg = next(r["ddg_pred"] for r in map(json.loads, f)
                        if (r["complex"], r["mutstr"]) == ("2FTL_E_I", "KI15G"))
    requests = {
        "/pack": (json.dumps({"pdb": t1124, "n_samples": 2, "use_proximal": True, "seed": 0}),
                  expect_launches(message=5 * STEPS, chain=5 * STEPS, clash_fwd=PROX_STEPS + 2,
                                  clash_bwd=PROX_STEPS)),
        "/prox": (json.dumps({"pdb": t1124}),
                  expect_launches(clash_fwd=PROX_STEPS + 1, clash_bwd=PROX_STEPS)),
        "/ddg": (json.dumps({"pdb": TWO_FTL.read_text(), "mutstr": "KI15G"}),
                 expect_launches(message=20, chain=20)),
    }

    def call(method, path, body=None, expect=None):
        zero_launches()
        status, out, seconds = http_request(addr, method, path, body)
        got = read_launches()
        if status != 200:
            fail(f"cli.serve {method} {path}: status {status}: {out}")
        if expect is not None and got != expect:
            fail(f"cli.serve {path}: launches {got}, expected {expect}")
        return out, seconds, got

    launches = {k: 0 for k in read_launches()}
    try:
        health, _, _ = call("GET", "/healthz")
        log(f"  /healthz: {health}")
        if (health["backend"], health["devices"]) != (torch.cuda.get_device_name(0),
                                                      torch.cuda.device_count()):
            fail(f"/healthz: {health}")
        times = {p: [] for p in requests}
        for rep in range(1 + SERVE_REPS):
            for path, (body, expect) in requests.items():
                out, seconds, got = call("POST", path, body, expect)
                times[path].append(seconds)
                if rep:
                    continue
                for k, v in got.items():
                    launches[k] += v
                m = out.get("metrics", {})
                if path == "/pack":
                    prot = from_pdb_string(out["pdb"])
                    bad = [k for k in METRIC_KEYS - {"sampling_seconds"} if k not in m]
                    if (bad or m["clashscore_is_exact"] != 0.0
                            or type(m["clashscore_is_exact"]) is not float
                            or not np.isfinite(prot.atom_positions[prot.atom_mask > 0]).all()):
                        fail(f"/pack: metrics {sorted(m)} (missing {bad}) or non-finite atoms")
                    log(f"  /pack T1124: device {m['device_seconds']:.4f} s, accepted "
                        f"{m['proximal_accepted']}, total_acc {m['total_acc']:.4f}, clashscore "
                        f"{m['clashscore']:.4f}, launches {got}")
                elif path == "/prox":
                    log(f"  /prox T1124: device {m['device_seconds']:.4f} s, clashscore "
                        f"{m['clashscore_before']} -> {m['clashscore_after']}, launches {got}")
                else:
                    d = abs(out["ddg_pred"] - want_ddg)
                    log(f"  /ddg 2FTL KI15G: {out['ddg_pred']:.6f} kcal/mol, |d| {d:.3e} from "
                        f"the JAX package's shipped prediction (limit {DDG_EVAL_TOL:g}), "
                        f"launches {got}")
                    if d > DDG_EVAL_TOL or out["random_weights"]:
                        fail("/ddg disagrees with the JAX package's prediction")
        for path, ts in times.items():
            cold = " (builds the affinity session)" if path == "/ddg" else ""
            log(f"  {path} latency: first {ts[0]:.4f} s{cold}, warm median "
                f"{float(np.median(ts[1:])):.4f} s over {SERVE_REPS} "
                f"({', '.join(f'{t:.4f}' for t in ts[1:])})")

        bodies = [json.dumps({"pdb": t1124, "seed": s, "metrics": False}) for s in (1, 2)]
        alone = [call("POST", "/pack", b)[0]["pdb"] for b in bodies]
        with ThreadPoolExecutor(2) as pool:
            both = list(pool.map(lambda b: http_request(addr, "POST", "/pack", b), bodies))
        if [s for s, _, _ in both] != [200, 200] or [o["pdb"] for _, o, _ in both] != alone:
            fail("two concurrent seeded /pack requests differ from their lone answers")
        log(f"  two concurrent seeded /pack requests: each equal to its lone answer, "
            f"{', '.join(f'{t:.4f}' for _, _, t in both)} s")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join()
    return launches


# the network options of NetworkConfig beyond the published configuration:
# the activation table (a kernel library per activation), static_edge_dtype,
# the vanilla MPNN (use_ipmp=False), and the native host library
STATIC_TOL_RAD = 0.01          # the JAX package's bound for a narrower edge cache
VANILLA_SEED = 7


# (H, He, P, K) of phase_widths: hidden_dim, edge_features, n_points and
# top_k each away from 128 / 128 / 8 / 32 in some entry, He != H in two, K
# past the 64-row tile in one. The two edge passes that add the message to
# h_E (message_chain, layer_edge) need He = H: where He != H they run at
# (H, H, P, K).
WIDTH_GRID = ((64, 64, 4, 16), (256, 256, 8, 32), (128, 64, 16, 48), (128, 128, 8, 96),
              (96, 160, 3, 24))
WIDE = dict(hidden_dim=256, node_features=256, edge_features=256)   # the wide pack
WIDE_TRAIN = dict(WIDE, n_points=4)                                  # the wide training step
WIDE_K = 96                                                          # the dense-graph pack
WIDTH_SEED = 3
# phase_widths' bf16 mean limit, relative to max|ref|. Rounding flips grow
# with the width: two sound versions of the node pass (the plain one summing
# in float32 and in float64, at the same rounding points) differ by up to
# about 2e-5 of max|ref| at H = 256 on these random networks, past
# BF16_MEAN_REL (phase_widths logs that floor beside every bf16 reading).
# 2^-15 lies above it, and 4x 2^-15 under the plain versions without their
# rounding points (2.3e-4 to 6.5e-4 here), so the controls still fail it.
WIDTH_BF16_MEAN_REL = 2.0 ** -15


def width_builds():
    """The libraries phase_widths and the wide packs and step launch."""
    from packppi_torch.ops import _build

    names = []
    for H, He, P, _ in WIDTH_GRID:
        names += [_build.lib_name(source, "relu", H, He, P)
                  for source in ("message", "message_feat", "layer")]
        # the edge passes on h_E at He = H
        names += [_build.lib_name(source, "relu", H, H, P) for source in ("message", "layer")]
        names.append(_build.lib_name("chain", "relu", H))
    names.append(_build.lib_name("message_feat", "relu", 256, 256, WIDE_TRAIN["n_points"]))
    return list(dict.fromkeys(n for n in names if "@" in n))


def width_config(H, He, P, K):
    return dict(hidden_dim=H, node_features=H, edge_features=He, n_points=P, top_k=K)


def width_network(torch, dtype_name, seed, **cfg):
    """A score network of ``cfg`` in ``dtype_name`` on the card, with random
    weights from ``seed``: init_weights' Xavier kernels, and its zero biases
    and unit LayerNorm scales each moved by 0.1 of a unit normal (so that a
    bias or a scale that a kernel misplaced shows)."""
    from packppi_torch.models import ChiScoreNetwork, NetworkConfig
    from packppi_torch.weights import init_weights

    net = ChiScoreNetwork(NetworkConfig(compute_dtype=dtype_name, **cfg)).eval()
    init_weights(net, seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in net.parameters():
            if p.ndim == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return net.to("cuda")


def width_cases(torch, static, h_V, layer, frames, mask_V, edge_chains):
    """variant_cases' five kernels (the edge-chain passes only with
    ``edge_chains``) and the message (lanes), feature-message and chain
    kernels on layer 0: (kernel, variant, fn, plain, operands, rows of a
    first block, message rows, chain rows)."""
    from packppi_torch.models.ipmp import chain_operands
    from packppi_torch.ops.chain import chain, chain_plain
    from packppi_torch.ops.message import message, message_plain
    from packppi_torch.ops.message_feat import message_feat, message_feat_plain

    K = static.idx.shape[-1]
    erows, nrows = static.idx.numel(), h_V.shape[0] * h_V.shape[1]
    cases = [c for c in variant_cases(static, h_V, layer, frames, mask_V)
             if edge_chains or c[0] not in ("message_chain", "layer_edge")]
    for variant, pool, mlp, pts in (("node", True, layer.node_message_fn, layer.points_fn_node),
                                    ("edge", False, layer.edge_message_fn, layer.points_fn_edge)):
        args = (h_V, static.h_E, static.idx, layer._points(pts, h_V), frames, static.mask_attend)
        first = max(ROWS_PER_BLOCK // K, 1) if pool else ROWS_PER_BLOCK
        bind = lambda f, pool=pool: (lambda *o: f(*o, pool))
        cases.append(("message", variant, bind(message), bind(message_plain),
                      mlp.operands(*args), first, erows, 0))
        feat = mlp.feat_operands(*args)
        cases.append(("message_feat", variant, bind(message_feat), bind(message_feat_plain),
                      feat, first, erows, 0))
        msg = message_feat_plain(*feat, pool)
        if pool:
            cops = chain_operands(h_V, msg, mask_V, layer.norm[0], layer.node_dense,
                                  layer.norm[1])
        elif edge_chains:
            cops = chain_operands(static.h_E, msg, static.mask_attend, layer.norm[2],
                                  layer.edge_dense, layer.norm[3])
        else:
            continue
        cases.append(("chain", variant, (lambda *o, p=pool: chain(*o, not p)),
                      (lambda *o, p=pool: chain_plain(*o, not p)), cops, ROWS_PER_BLOCK, 0,
                      cops[0].shape[0]))
    return cases


class float64_sums:
    """The plain versions' products summed in float64 for a ``with`` block
    (the same operands, rounded at the same points): a second sound version
    whose distance from the first is the width's rounding-flip floor."""

    MODULES = ("packppi_torch.ops.chain", "packppi_torch.ops.message_feat")

    def __enter__(self):
        import importlib

        from packppi_torch.ops.precision import round_to

        def mm(x, w, cd):
            return (round_to(x.float(), cd).double() @ round_to(w.float(), cd).double()).float()

        self.mods = [importlib.import_module(m) for m in self.MODULES]
        self.prev = [m.matmul_f32acc for m in self.mods]
        for m in self.mods:
            m.matmul_f32acc = mm

    def __exit__(self, *exc):
        for m, f in zip(self.mods, self.prev):
            m.matmul_f32acc = f


def width_ops(H, He, P, erows, crows):
    """Operations of message rows and chain rows at (H, He, P)."""
    return 2 * (He + 9 * P + 2 * H) * H * erows + 16 * H * H * crows


def phase_widths(torch, timer):
    """Every templated kernel route at each width of WIDTH_GRID, float32 and
    bf16 (with the two controls), on T1124's graph (L = 768) and a network
    of those widths with random weights from a seed: against its plain
    version, timed beside it and its bound; in float32 the gradients of the
    two differentiable passes against autograd through the plain versions;
    at K = 96 the node pass bit for bit at 1, 2 and 16 nodes a block.
    Returns {(kernel, dtype, variant, H, He, P, K): record}."""
    import numpy as np

    from packppi_torch.ops.chain import chain, chain_plain
    from packppi_torch.ops.layer import layer_node
    from packppi_torch.ops.message_feat import message_feat, message_feat_plain

    t_phase = time.perf_counter()
    batch = t1124_batch("cuda")
    rng = np.random.default_rng(0)
    records = {}
    for H, He, P, K in WIDTH_GRID:
        for dtype_name in ("float32", "bfloat16"):
            nets = [(True, width_network(torch, dtype_name, WIDTH_SEED,
                                         **width_config(H, He, P, K)))]
            if He != H:
                nets = [(False, nets[0][1]),
                        (True, width_network(torch, dtype_name, WIDTH_SEED,
                                             **width_config(H, H, P, K)))]
            for edge_chains, net in nets:
                with torch.no_grad():
                    static, h_V, layer, frames = layer0_state(torch, net, batch)
                    cases = width_cases(torch, static, h_V, layer, frames, batch.residue_mask,
                                        edge_chains)
                he = static.h_E.shape[-1]
                for name, variant, fn, plain, ops, first, erows, crows in cases:
                    # the companion network at He = H runs the passes on h_E alone
                    on_h_E = name in ("message_chain", "layer_edge") or (name, variant) == (
                        "chain", "edge")
                    if he != He and not on_h_E:
                        continue
                    label = f"{name} {variant} {dtype_name} H={H} He={he} P={P} K={K}"
                    with torch.no_grad():
                        got, err = check_variant(torch, label, fn, plain, ops, first, dtype_name,
                                                 WIDTH_BF16_MEAN_REL)
                        if dtype_name == "bfloat16":
                            with float64_sums():
                                floor = plain(*ops)
                            _, fmean, scale = readings(floor, plain(*ops))
                            log(f"    floor: the plain version with float64 sums, mean|d|/"
                                f"max|ref| {fmean / scale:.3e}")
                        nb = sum(_nbytes(t) for t in ops) + _nbytes(got)
                        no = width_ops(H, he, P, erows, crows)
                        records[(name, dtype_name, variant, H, he, P, K)] = dict(
                            max_abs_err=err, ms=timer(lambda: fn(*ops)),
                            plain_ms=timer(lambda: plain(*ops), 3),
                            bound=bound_ms(nb, no, dtype_name), bytes=nb, operations=no)
                    if name == "layer_node" and K > ROWS_PER_BLOCK and dtype_name == "bfloat16":
                        with torch.no_grad():
                            for npb in (1, 16):
                                same = torch.equal(layer_node(*ops, nodes_per_block=npb), got)
                                log(f"    {label}: {npb} nodes a block bit for bit: {same}")
                                if not same:
                                    fail("layer_node's result depends on its blocking")
                    if dtype_name == "float32" and name in ("message_feat", "chain"):
                        pool = variant == "node"
                        skip = 4 if name == "message_feat" else 2          # the mask
                        tagged = [(t, i != skip and t is not None) for i, t in enumerate(ops)]
                        cot = torch.as_tensor(rng.uniform(0.5, 1.5, tuple(got.shape)).astype(
                            np.float32), device="cuda")
                        if name == "message_feat":
                            kf = lambda *a, p=pool: message_feat(*a, p)
                            pf = lambda *a, p=pool: message_feat_plain(*a, p)
                        else:
                            kf = lambda *a, p=pool: chain(*a, not p)
                            pf = lambda *a, p=pool: chain_plain(*a, not p)
                        names = [f"operand {i}" for i, (_, g) in enumerate(tagged) if g]
                        check_grads(torch, f"{label} gradients", names,
                                    grads_of(torch, kf, tagged, cot),
                                    grads_of(torch, pf, tagged, cot))
                del static, h_V, layer, cases
    for (k, d, v, H, He, P, K), r in records.items():
        log(f"  time {k} {v} {d} H={H} He={He} P={P} K={K} T1124: kernel {r['ms']:.4f} ms  "
            f"plain {r['plain_ms']:.4f} ms  bound {r['bound'][0]:.4f} ms ({r['bound'][1]}; "
            f"{rate_line(r)})")
    log(f"phase widths: {time.perf_counter() - t_phase:.1f} s, {len(records)} kernel checks")
    return records


def wide_checkpoint(torch, cfg, seed):
    """A state dict of a score network of ``cfg`` with random weights from
    ``seed`` (width_network's), written to smoke_out for cli.pack."""
    path = OUT / f"wide_{seed}_{'_'.join(f'{v}' for v in cfg.values())}.pt"
    OUT.mkdir(exist_ok=True)
    net = width_network(torch, "float32", seed, **cfg)
    torch.save({k: v.cpu() for k, v in net.state_dict().items()}, path)
    return path


def evaluation_routes(torch, what, weights, batch, cfg):
    """One T1124 network evaluation per dtype through the kernels and on the
    unfused route, same weights and inputs, within phase_pack_unfused's
    limits (float32 1e-3, bf16 6e-2)."""
    from packppi_torch.models import ChiScoreNetwork, NetworkConfig
    from packppi_torch.weights import load_weights

    for dtype_name, tol in (("float32", 1e-3), ("bfloat16", UNFUSED_BF16_TOL)):
        out = {}
        for route, extra in (("kernels", {}), ("unfused", dict(fused_messages=False,
                                                               fused_chain=False))):
            net = ChiScoreNetwork(NetworkConfig(compute_dtype=dtype_name, **cfg, **extra)).eval()
            load_weights(net, weights)
            net.to("cuda")
            g = torch.Generator().manual_seed(0)
            sc = batch.SC_D + torch.randn(batch.SC_D.shape, generator=g).to("cuda")
            t = torch.full(batch.residue_mask.shape, 0.5, device="cuda")
            zero_launches()
            with torch.no_grad():
                out[route] = net(batch, sc, t, static=net.encode_static(batch),
                                 skip_last_edge_update=True)
            got = read_launches()
            want = 5 if route == "kernels" else 0
            if got != expect_launches(message=want, chain=want):
                fail(f"{what} {dtype_name} evaluation, {route} route: launches {got}")
        ds, dh = ((out["kernels"][i] - out["unfused"][i]).abs().max().item() for i in (0, 1))
        log(f"  {what} {dtype_name} evaluation, kernel vs unfused route: score {ds:.3e}, h_V "
            f"{dh:.3e} (bound {tol:g})")
        if not (ds <= tol and dh <= tol):
            fail(f"{what}: the kernel route disagrees with the unfused route in {dtype_name}")


def phase_width_packs(torch):
    """T1124 through ``cli.pack`` (bf16, 30 steps, --use_proximal, the
    metric suite) at hidden_dim = node_features = edge_features = 256 on
    random weights from a seed (a checkpoint whose widths cli.pack reads),
    and at the default widths with ``--top_k 96``: 150 message and 150
    chain launches each, 51 and 50 clash; one network evaluation of each
    against the unfused route (phase_pack_unfused's limits); the chis of an
    unfused 30-step sample beside the kernels' (reported). Returns the
    wide pack's launches."""
    from packppi_torch.cli import pack

    t_phase = time.perf_counter()
    batch = t1124_batch("cuda")
    mask = batch.SC_D_mask.cpu().numpy() > 0
    result = None
    for what, ckpt, extra, cfg in (
            ("H=He=256", wide_checkpoint(torch, WIDE, WIDTH_SEED), [], WIDE),
            (f"top_k={WIDE_K}", PIPELINE_GOLDEN, ["--top_k", str(WIDE_K)], dict(top_k=WIDE_K))):
        outdir = OUT / f"pack_wide_{what.replace('=', '').replace(' ', '')}"
        args = pack.build_parser().parse_args([
            "--input", str(T1124), "--ckpt", str(ckpt), "--precision", "bfloat16",
            "--n_steps", str(STEPS), "--seed", "0", "--use_proximal", "--outdir", str(outdir),
            *extra])
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        metrics = pack.run(args)
        wall = time.perf_counter() - t0
        got = read_launches()
        log(f"pack T1124 bf16 {STEPS} steps --use_proximal at {what}: sampling "
            f"{metrics['sampling_seconds']:.4f} s, whole run {wall:.3f} s, launches {got}")
        want = expect_launches(message=5 * STEPS, chain=5 * STEPS, clash_fwd=PROX_STEPS + 1,
                               clash_bwd=PROX_STEPS)
        if got != want:
            fail(f"the pack at {what}: launches {got}, expected {want}")
        check_structure(outdir)
        check_metric_suite(metrics, outdir, True)
        result = result or got
        evaluation_routes(torch, f"T1124 at {what}", ckpt, batch, cfg)
        kern = option_model(torch, "bfloat16", ckpt, **cfg)
        unf = option_model(torch, "bfloat16", ckpt, fused_messages=False, fused_chain=False, **cfg)
        sc, got, _ = sample_counted(torch, kern, batch)
        sc_u, _, _ = sample_counted(torch, unf, batch)
        gmax, g99 = chi_gap(sc, sc_u, mask)
        log(f"  {STEPS}-step samples at {what}, kernels vs unfused route: chis max {gmax:.4e} "
            f"rad, 99th percentile {g99:.4e} rad; finite {bool(sc.isfinite().all())}")
        if not bool(sc.isfinite().all()):
            fail(f"the sample at {what} is not finite")
    log(f"phase width packs: {time.perf_counter() - t_phase:.1f} s")
    return result


def phase_width_train(torch):
    """One float32 training step's loss and parameter gradients at B = 4 x
    L = 1,024 with the training knobs at hidden_dim = edge_features = 256,
    n_points = 4, against the same step on the unfused route (same weights
    and draws; phase_loss_grads' limits): 5 feature-message and 5 chain
    launches."""
    t_phase = time.perf_counter()
    batch = t1124_train_batch("cuda")
    g = torch.Generator(device="cuda").manual_seed(11)
    draws = dict(t=torch.rand(TRAIN_B, generator=g, device="cuda"),
                 noise_pi=torch.randn(batch.SC_D.shape, generator=g, device="cuda"),
                 noise_2pi=torch.randn(batch.SC_D.shape, generator=g, device="cuda"))
    results = {}
    for name, cfg in (("kernels", TRAIN_KNOBS), ("unfused", dict(dropout=0.0))):
        state = new_train_state(torch, 5, "cuda", **WIDE_TRAIN, **cfg)
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = state.model.loss(batch, None, **draws)
        loss.backward()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        want = 5 if name == "kernels" else 0
        if (launches["message_feat"], launches["chain"], launches["message"]) != (want, want, 0):
            fail(f"wide training step ({name}): launches {launches}")
        results[name] = (loss.item(), param_grads(state.model.net))
        log(f"  loss B={TRAIN_B} L={TRAIN_L} float32 at {WIDE_TRAIN}, {name}: "
            f"{loss.item():.7f} ({wall:.3f} s with its backward); launches message_feat "
            f"{launches['message_feat']}, chain {launches['chain']}")
        del state
    d = abs(results["kernels"][0] - results["unfused"][0])
    if not d <= 1e-5:
        fail(f"wide training step: loss of kernels vs unfused differs by {d:.3e} (limit 1e-5)")
    compare_param_grads(f"wide training step gradients, kernels vs unfused (loss |d| {d:.3e})",
                        results["kernels"][1], results["unfused"][1], GRAD_REL_TOL)
    log(f"phase width train: {time.perf_counter() - t_phase:.1f} s")


def phase_activations(torch, timer):
    """Every activation's message (node, edge) and chain (node, edge)
    kernels against their plain versions at T1124 shapes, float32 and bf16,
    each timed beside relu's (the same bound: it counts the products); a
    non-relu kernel must give other values than relu's. Then gelu on the
    variant kernels (rows 4, 5, 1b, 6) and on the feature-message kernel
    (row 3), float32 and bf16 with the bf16 controls. Returns
    {(kernel, dtype, variant): {act: ms}}."""
    from packppi_torch.models.ipmp import chain_operands
    from packppi_torch.ops._build import ACTS
    from packppi_torch.ops.chain import chain, chain_plain
    from packppi_torch.ops.message import message, message_plain
    from packppi_torch.ops.message_feat import message_feat, message_feat_plain

    t_phase = time.perf_counter()
    times = {}
    for dtype_name in ("float32", "bfloat16"):
        net, batch = t1124_network(torch, dtype_name, "cuda")
        with torch.no_grad():
            static, h_V, layer, frames = layer0_state(torch, net, batch)
            for variant, pool in (("node", True), ("edge", False)):
                mlp = layer.node_message_fn if pool else layer.edge_message_fn
                ops = mlp.operands(*message_args(static, h_V, layer, frames, variant))
                relu = {}
                for act in ACTS:
                    got = message(*ops, pool, act)
                    torch.cuda.synchronize()
                    want = message_plain(*ops, pool, act)
                    check_close(f"message {variant} {dtype_name} {act}", got, want, dtype_name)
                    if pool:
                        cops = chain_operands(h_V, want, batch.residue_mask, layer.norm[0],
                                              layer.node_dense, layer.norm[1])
                    else:
                        cops = chain_operands(static.h_E, want, static.mask_attend,
                                              layer.norm[2], layer.edge_dense, layer.norm[3])
                    cgot = chain(*cops, not pool, act)
                    torch.cuda.synchronize()
                    check_close(f"chain {variant} {dtype_name} {act}", cgot,
                                chain_plain(*cops, not pool, act), dtype_name)
                    if act == "relu":
                        relu = {"message": got, "chain": cgot}
                    elif torch.equal(got, relu["message"]) or torch.equal(cgot, relu["chain"]):
                        fail(f"{act} gives relu's values")
                    times.setdefault(("message", dtype_name, variant), {})[act] = timer(
                        lambda: message(*ops, pool, act))
                    times.setdefault(("chain", dtype_name, variant), {})[act] = timer(
                        lambda: chain(*cops, not pool, act))

            for name, variant, fn, plain, ops, first, _, _ in variant_cases(
                    static, h_V, layer, frames, batch.residue_mask, act="gelu"):
                check_variant(torch, f"{name} {variant} {dtype_name} gelu", fn, plain, ops, first,
                              dtype_name)
                times.setdefault((name, dtype_name, variant), {})["gelu"] = timer(
                    lambda: fn(*ops))
            for variant, pool in (("node", True), ("edge", False)):
                feat = (layer.node_message_fn if pool else layer.edge_message_fn).feat_operands(
                    *message_args(static, h_V, layer, frames, variant))
                fn = lambda *o, pool=pool: message_feat(*o, pool, "gelu")
                plain = lambda *o, pool=pool: message_feat_plain(*o, pool, "gelu")
                check_variant(torch, f"message_feat {variant} {dtype_name} gelu", fn, plain,
                              feat, ROWS_PER_BLOCK // static.idx.shape[-1] if pool
                              else ROWS_PER_BLOCK, dtype_name)
                times.setdefault(("message_feat", dtype_name, variant), {})["gelu"] = timer(
                    lambda: fn(*feat))
    for (k, d, v), by_act in times.items():
        log(f"  time {k} {v} {d} T1124 by activation: "
            + ", ".join(f"{a} {ms:.4f} ms" for a, ms in by_act.items()))
    log(f"phase activations: {time.perf_counter() - t_phase:.1f} s")
    return times


def option_model(torch, dtype_name, weights=PIPELINE_GOLDEN, device="cuda", **cfg):
    """A TorsionalDiffusion of ``NetworkConfig(compute_dtype=dtype_name,
    **cfg)`` on ``device`` with ``weights`` (a file, or a seed)."""
    from packppi_torch.models import NetworkConfig, TorsionalDiffusion
    from packppi_torch.weights import init_weights, load_weights

    model = TorsionalDiffusion(NetworkConfig(compute_dtype=dtype_name, **cfg))
    if isinstance(weights, int):
        init_weights(model.net, weights)
    else:
        load_weights(model.net, weights)
    return model.to(device)


def t1124_batch(device):
    from packppi_torch.data import stack_batch
    from packppi_torch.structure import featurize, from_pdb_file

    return stack_batch([featurize(from_pdb_file(T1124, mse_to_met=True))], device)


def sample_counted(torch, model, batch, seed=0):
    """A 30-step sample with its launches (counts set to 0 just before),
    wall seconds and chis."""
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        sc = model.sample(batch, torch.Generator(device=batch.X.device).manual_seed(seed),
                          n_steps=STEPS)
    torch.cuda.synchronize()
    return sc, read_launches(), time.perf_counter() - t0


def chi_gap(sc, ref, mask):
    """max and 99th percentile of the wrapped chi distance over ``mask``."""
    import numpy as np

    d = (sc - ref).abs().cpu().numpy()
    d = np.minimum(d, 2 * np.pi - d)[mask]
    return float(d.max()), float(np.percentile(d, 99))


def phase_gelu_path(torch):
    """The slice's path at full width with ``act="gelu"``: the bf16 T1124
    30-step pack through the kernels (150 message and 150 chain launches),
    against the same pack on the unfused route on the card (one network
    evaluation within the routes' bf16 limit; the packs' chis reported);
    a float32 evaluation, card against the CPU on the CPU's graph (1e-3, as
    phase_network_vs_cpu); ``cli.train_diffusion trainer=debug
    model.act=gelu`` with the four kernel knobs on the crop corpus, through
    the feature-message and chain kernels."""
    from packppi_torch.cli import train_diffusion
    from packppi_torch.models.diffusion_net import StaticGraph

    t_phase = time.perf_counter()
    batch = t1124_batch("cuda")
    mask = batch.SC_D_mask.cpu().numpy() > 0
    kern = option_model(torch, "bfloat16", act="gelu")
    unf = option_model(torch, "bfloat16", act="gelu", fused_messages=False, fused_chain=False)
    sc, got, wall = sample_counted(torch, kern, batch)
    log(f"gelu pack T1124 bf16 {STEPS} steps, kernels: {wall:.4f} s, launches {got}")
    if got != expect_launches(message=5 * STEPS, chain=5 * STEPS):
        fail(f"the gelu pack: launches {got}")
    sc_u, got_u, wall_u = sample_counted(torch, unf, batch)
    if got_u != expect_launches():
        fail(f"the unfused gelu pack launched kernels: {got_u}")
    gmax, g99 = chi_gap(sc, sc_u, mask)
    log(f"  unfused route: {wall_u:.4f} s; chis kernel vs unfused route: max {gmax:.4e} rad, "
        f"99th percentile {g99:.4e} rad; finite {bool(sc.isfinite().all())}")
    if not bool(sc.isfinite().all()) or (sc[~batch.SC_D_mask.bool()] != 0).any():
        fail("the gelu pack's chis are not finite, or masked chis are not 0")
    with torch.no_grad():
        static = kern.net.encode_static(batch)
        t = torch.full(batch.residue_mask.shape, 0.5, device="cuda")
        a, b = (m.net(batch, batch.SC_D, t, static=static, skip_last_edge_update=True)
                for m in (kern, unf))
    ds, dh = ((a[i] - b[i]).abs().max().item() for i in (0, 1))
    log(f"  one gelu bf16 evaluation, kernel vs unfused route: score {ds:.3e}, h_V {dh:.3e} "
        f"(bound {UNFUSED_BF16_TOL})")
    if not (ds <= UNFUSED_BF16_TOL and dh <= UNFUSED_BF16_TOL):
        fail("the gelu kernel route disagrees with the unfused route")

    nets = {d: option_model(torch, "float32", device=d, act="gelu").net.eval()
            for d in ("cuda", "cpu")}
    cpu_batch = t1124_batch("cpu")
    with torch.no_grad():
        st = nets["cpu"].encode_static(cpu_batch)
        g = torch.Generator().manual_seed(0)
        sc0 = cpu_batch.SC_D + torch.randn(cpu_batch.SC_D.shape, generator=g)
        out = {}
        for d, net in nets.items():
            b = cpu_batch if d == "cpu" else batch
            t = torch.full(b.residue_mask.shape, 0.5, device=d)
            out[d] = net(b, sc0.to(d), t, static=StaticGraph(*(x.to(d) for x in st[:3])),
                         skip_last_edge_update=True)
    ds, dh = ((out["cuda"][i].cpu() - out["cpu"][i]).abs().max().item() for i in (0, 1))
    log(f"  gelu float32 T1124 evaluation, card vs CPU: score {ds:.3e}, h_V {dh:.3e} "
        f"(bound 1e-3)")
    if not (ds < 1e-3 and dh < 1e-3):
        fail("the gelu network differs between the card and the CPU")

    argv = ["trainer=debug", f"data.data_dir={OUT / 'crops'}", "data.batch_size=16",
            "sample.n_diffusion_steps=3", f"output_dir={OUT / 'train_gelu'}", "model.act=gelu"]
    argv += [f"model.{k}={str(v).lower()}" for k, v in TRAIN_KNOBS.items()]
    shutil.rmtree(OUT / "train_gelu", ignore_errors=True)
    zero_launches()
    t0 = time.perf_counter()
    (result,) = train_diffusion.main(argv + ["trainer.max_epochs=1"])
    got = read_launches()
    m = result["metrics"]
    log(f"  cli.train_diffusion trainer=debug model.act=gelu (knobs): "
        f"{time.perf_counter() - t0:.2f} s, val/loss {m['best_val_loss']:.5f}, launches {got}")
    if not (got["message_feat"] > 0 and got["chain"] > 0 and got["message_feat"] % 5 == 0
            and math.isfinite(m["best_val_loss"])):
        fail(f"the gelu trainer did not run through the kernels: {got}")
    log(f"phase gelu path: {time.perf_counter() - t_phase:.1f} s")


def phase_static_edge_dtype(torch):
    """T1124 30-step packs through the kernels with the bfloat16 and int8
    edge caches, with the float32 cache's noise, in float32 compute (where
    a bf16 cache narrows the stored edges): chis within ``STATIC_TOL_RAD``
    of the float32 cache's pack (the JAX package's bound, which it holds in
    float32 compute), masked chis 0; the cache's bytes for each. The int8
    cache in bf16 compute too, its distance reported beside that of the
    kernel and unfused bf16 routes (phase_gelu_path): bf16 compute's own
    noise, which 30 steps carry to a few 1e-2 rad."""
    t_phase = time.perf_counter()
    batch = t1124_batch("cuda")
    mask = batch.SC_D_mask.cpu().numpy() > 0
    for compute, caches in (("float32", ("bfloat16", "int8")), ("bfloat16", ("int8",))):
        runs = {}
        for cache in ("float32", *caches):
            model = option_model(torch, compute, static_edge_dtype=cache)
            sc, got, wall = sample_counted(torch, model, batch)
            with torch.no_grad():
                nbytes = model.net.encode_static(batch).nbytes()
            runs[cache] = sc
            log(f"static_edge_dtype {cache}, {compute} compute, T1124 {STEPS} steps: {wall:.4f} s, "
                f"edge cache {nbytes} bytes, launches {got}")
            if got != expect_launches(message=5 * STEPS, chain=5 * STEPS):
                fail(f"static_edge_dtype {cache}: launches {got}")
            if (sc[~batch.SC_D_mask.bool()] != 0).any() or not bool(sc.isfinite().all()):
                fail(f"static_edge_dtype {cache}: masked chis not 0 or chis not finite")
        for cache in caches:
            gmax, g99 = chi_gap(runs[cache], runs["float32"], mask)
            bound = STATIC_TOL_RAD if compute == "float32" else "none, bf16 compute"
            log(f"  {cache} cache vs float32 cache ({compute} compute): max {gmax:.4e} rad, "
                f"99th percentile {g99:.4e} rad (bound {bound})")
            if compute == "float32" and gmax > STATIC_TOL_RAD:
                fail(f"the {cache} edge cache moves the chis by {gmax:.4e} rad")
    log(f"phase static_edge_dtype: {time.perf_counter() - t_phase:.1f} s")


def phase_vanilla(torch):
    """``use_ipmp=False`` at the published widths with random weights from a
    seed: a float32 T1124 30-step pack with no message or chain launch, its
    busy time; one evaluation, card against the CPU on the CPU's graph
    (1e-4); one ``cli.train_affinity`` epoch of one training step with
    ``model.use_ipmp=false``: the backbone takes the same configuration (as
    in the JAX trainer), so it is a vanilla network on random weights (no
    checkpoint of one ships) and nothing launches a kernel."""
    from packppi_torch.cli import train_affinity
    from packppi_torch.data.skempi import cv_split, load_skempi_entries
    from packppi_torch.models.diffusion_net import StaticGraph

    t_phase = time.perf_counter()
    batch = t1124_batch("cuda")
    model = option_model(torch, "float32", VANILLA_SEED, use_ipmp=False)
    sc, got, wall = sample_counted(torch, model, batch)
    log(f"vanilla pack T1124 float32 {STEPS} steps: {wall:.4f} s, launches {got}")
    if got != expect_launches() or not bool(sc.isfinite().all()):
        fail(f"the vanilla pack: launches {got}, finite {bool(sc.isfinite().all())}")
    with torch.no_grad():
        static = model.net.encode_static(batch)
        t = torch.full(batch.residue_mask.shape, 0.5, device="cuda")
        time_evaluations(torch, "vanilla float32 T1124 network evaluation",
                         lambda: model.net(batch, batch.SC_D, t, static=static,
                                           skip_last_edge_update=True))
    cpu_model = option_model(torch, "float32", VANILLA_SEED, device="cpu", use_ipmp=False)
    cpu_batch = t1124_batch("cpu")
    with torch.no_grad():
        st = cpu_model.net.encode_static(cpu_batch)
        out = {}
        for d, m, b in (("cuda", model, batch), ("cpu", cpu_model, cpu_batch)):
            t = torch.full(b.residue_mask.shape, 0.5, device=d)
            out[d] = m.net(b, b.SC_D, t, static=StaticGraph(*(x.to(d) for x in st[:3])),
                           skip_last_edge_update=True)
    ds, dh = ((out["cuda"][i].cpu() - out["cpu"][i]).abs().max().item() for i in (0, 1))
    log(f"  vanilla float32 evaluation, card vs CPU: score {ds:.3e}, h_V {dh:.3e} (bound 1e-4)")
    if not (ds <= 1e-4 and dh <= 1e-4):
        fail("the vanilla network differs between the card and the CPU")

    data = skempi_copy("skempi_vanilla", rows=(("1BRS", 4), ("2FTL", 4)))
    split = cv_split(load_skempi_entries(data, "PDBs"), 2, 0, 42)
    steps = -(-len(split["train"]) // 4)
    val_batches = -(-len(split["valid"]) // 4)
    shutil.rmtree(OUT / "affinity_vanilla", ignore_errors=True)
    argv = [f"data.data_dir={data}", "data.num_cvfolds=2", "data.cvfold_index=0",
            "data.batch_size=4", "trainer.max_epochs=1", "model.use_ipmp=false",
            f"output_dir={OUT / 'affinity_vanilla'}", "logger=[jsonl]"]
    zero_launches()
    t0 = time.perf_counter()
    (result,) = train_affinity.main(argv)
    got = read_launches()
    (rec,) = affinity_records(result["run_dir"])
    log(f"  cli.train_affinity model.use_ipmp=false: {steps} step(s), {val_batches} validation "
        f"batch(es), {time.perf_counter() - t0:.2f} s, launches {got}; record {rec}")
    if got != expect_launches() or not math.isfinite(rec["train/loss"]):
        fail(f"cli.train_affinity with the vanilla stack: launches {got}, record {rec}")
    log(f"phase vanilla: {time.perf_counter() - t_phase:.1f} s")


def phase_native():
    """The native host library: built from the checkout with g++ and loaded;
    the T1124 parse and the delta-SASA interface of 2FTL timed on the host
    (median of 5)."""
    import statistics

    from packppi_torch import native
    from packppi_torch.structure import from_pdb_file
    from packppi_torch.structure.interface import interface_by_delta_sasa

    t0 = time.perf_counter()
    lib = native.get_lib()
    log(f"native: {native.library_path()} ({time.perf_counter() - t0:.2f} s to build or load)")
    if lib is None or native.library_path() is None:
        fail(f"packppi_torch.native did not build or load its library: {native.build_error()}")
    text = T1124.read_text()

    def median_s(fn):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    parse = median_s(lambda: native.parse_pdb_native(text, mse_to_met=True))
    if native.parse_pdb_native(text, mse_to_met=True) is None:
        fail("the native parser returned nothing")
    prot = from_pdb_file(TWO_FTL)
    sasa = median_s(lambda: interface_by_delta_sasa(prot))
    n = int(interface_by_delta_sasa(prot).sum())
    log(f"  T1124 parse {parse * 1e3:.3f} ms; 2FTL delta-SASA interface {sasa * 1e3:.1f} ms "
        f"({n} interface residues of {len(prot.aaindex)}), host")


# ---- phase_multidevice --------------------------------------------------------
# Ranks of one launch (packppi_torch.parallel.launch) on the one card: a world
# of one over NCCL, and 2, 3 and 4 ranks sharing cuda:0 over gloo
# (share_device=True). Their times say nothing of scaling over cards.

COLLECTIVE_KEYS = ("gloo:", "nccl:", "c10d::")       # the process group's profiler events
MD_ESM_TOL = 1e-4                       # of max|ref|, float32 ESM-2 under TP and PP
KERNEL_NAMES = ("message", "message_feat", "chain", "clash_fwd", "clash_bwd", "attention",
                "message_geom", "message_gather", "message_chain", "layer_node", "layer_edge",
                "gemm")


def collective_ms(prof):
    """{collective op name: (calls, CPU ms)} of a profile: the time each
    rank spent in the process group's calls."""
    out = {}
    for e in prof.key_averages():
        if e.key.startswith(COLLECTIVE_KEYS):
            out[e.key] = (e.count, round(e.cpu_time_total / 1e3, 3))
    return out


def rank_report(torch, t0, prof=None, **more):
    """What every multi-device rank returns: its rank, wall seconds, peak
    memory, launches and collective times."""
    from packppi_torch.parallel.launch import current

    torch.cuda.synchronize()
    return {"rank": current().rank, "backend": current().backend,
            "wall_s": round(time.perf_counter() - t0, 3),
            "peak_mib": round(torch.cuda.max_memory_allocated() / 2 ** 20, 1),
            "launches": read_launches(),
            "collectives": collective_ms(prof) if prof is not None else {}, **more}


def md_train_step(torch, mesh, device, capture):
    """One float32 training step of the knobs configuration on this rank's
    rows of 4 x T1124 at L = 1,024 (random weights from seed 0); returns the
    loss, and with ``capture`` the reduced gradients and the parameters after
    the step (on the CPU)."""
    from packppi_torch.models import NetworkConfig, TorsionalDiffusion
    from packppi_torch.parallel.mesh import batch_rows
    from packppi_torch.train.diffusion_task import init_state, make_train_step

    batch = t1124_train_batch(device)
    batch = type(batch)(*(t[batch_rows(mesh, TRAIN_B)] for t in batch))
    state = init_state(TorsionalDiffusion(NetworkConfig(**TRAIN_KNOBS)), 0, device, mesh=mesh)
    grads = {}
    reduce = state.sharded.reduce_grads

    def reduce_and_capture():
        reduce()
        grads.update({k: (p.grad.detach().cpu().clone() if p.grad is not None
                          else torch.zeros(p.shape))
                      for k, p in state.model.net.named_parameters()})

    if capture:
        state.sharded.reduce_grads = reduce_and_capture
    zero_launches()
    loss = make_train_step(state.model, state.optimizer)(state, batch).item()
    launches = read_launches()
    params = {k: v.detach().cpu().clone() for k, v in state.params.items()} if capture else None
    return loss, grads, params, launches


def md_rank_nccl():
    """Phase a's rank (a world of one over NCCL on cuda:0): one DP training
    step through the mesh code against the same step without a mesh, bit for
    bit, and the communicator's all-reduce and broadcast."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from packppi_torch.parallel import launch as ranks
    from packppi_torch.parallel.mesh import make_mesh
    from packppi_torch.train.diffusion_task import make_train_step

    import os

    # deterministic index_add_ and cuBLAS workspaces (read when the first
    # cuBLAS handle is made, after this): the step is then repeatable bit for
    # bit, so the meshed one can be held to one device bit for bit
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    t0 = time.perf_counter()
    device = ranks.current().device
    mesh = make_mesh(1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loss_m, _, params_m, launches_m = md_train_step(torch, mesh, device, True)
        ones = []
        for _ in range(2):      # the step without a mesh, twice
            state = new_train_state(torch, 0, device, **TRAIN_KNOBS)
            loss = make_train_step(state.model, state.optimizer)(state, t1124_train_batch(device))
            ones.append((loss.item(), {k: v.detach().cpu() for k, v in state.params.items()}))
        x = torch.tensor([loss_m], device=device)
        y = ranks.broadcast(ranks.all_reduce(x.clone()), 0)

    def max_d(a, b):
        return max((a[k] - b[k]).abs().max().item() for k in a)

    return rank_report(torch, t0, prof, loss=loss_m, comm_ok=bool(torch.equal(x, y)),
                       launches_step=launches_m,
                       same_loss=loss_m == ones[0][0] == ones[1][0],
                       d_mesh=max_d(params_m, ones[0][1]), d_repeat=max_d(ones[0][1], ones[1][1]))


def md_rank_two(pack_argv, esm_file, tokens):
    """Phase b's rank (2 ranks sharing cuda:0 over gloo): the best-of-4
    pack with its rows over the ranks, one DP training step (B = 2 a rank)
    and ESM-2 650M's forward under tensor parallelism (10 heads a rank)."""
    import contextlib
    import io

    import torch
    from torch.profiler import ProfilerActivity, profile

    from packppi_torch.cli import pack
    from packppi_torch.models.esm2 import ESM2, ESM2Config, TensorParallelESM2
    from packppi_torch.parallel import launch as ranks
    from packppi_torch.parallel.mesh import make_mesh

    device = ranks.current().device
    out = {}
    rows = make_mesh(1)                       # (data 2, model 1)
    heads = make_mesh(2)                      # (data 1, model 2)

    ranks.barrier()                           # each part's clock starts on every rank at once
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    args = pack.build_parser().parse_args(pack_argv)
    text = io.StringIO()
    with profile(activities=[ProfilerActivity.CPU]) as prof, contextlib.redirect_stdout(text):
        metric = pack._run(args, device, rows)
    out["pack"] = rank_report(torch, t0, prof, stdout=text.getvalue(), metric=metric)

    ranks.barrier()
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loss, grads, params, launches = md_train_step(torch, rows, device, ranks.is_main())
    out["train"] = rank_report(torch, t0, prof, loss=loss, grads=grads, params=params)
    out["train"]["launches"] = launches

    blob = torch.load(esm_file, map_location="cpu", mmap=True, weights_only=True)
    with torch.device("meta"):
        model = ESM2(ESM2Config(attention_impl="auto"))
    model.load_state_dict(blob["state_dict"], assign=True)
    ranks.barrier()
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    tp = TensorParallelESM2(model.eval(), heads, device)
    ids, mask = (torch.from_numpy(a).to(device) for a in tokens)
    zero_launches()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        emb = tp.forward(ids, mask)
    out["esm_tp"] = rank_report(torch, t0, prof, emb=emb.cpu() if ranks.is_main() else None,
                                heads=tp.tensors["encoder.layer.0.attention.self.query.weight"]
                                .shape[0] // model.cfg.head_dim)
    return out


def md_rank_pipeline(esm_file, tokens):
    """Phase c's rank (3 ranks sharing cuda:0): ESM-2 650M over 3 stages of
    11 blocks, two microbatches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from packppi_torch.models.esm2 import (ESM2, ESM2Config, esm2_pipeline_forward,
                                           place_pipeline_stage)
    from packppi_torch.parallel import launch as ranks
    from packppi_torch.parallel.mesh import make_mesh

    device = ranks.current().device
    mesh = make_mesh(3)
    blob = torch.load(esm_file, map_location="cpu", mmap=True, weights_only=True)
    with torch.device("meta"):
        model = ESM2(ESM2Config(attention_impl="auto"))
    model.load_state_dict(blob["state_dict"], assign=True)
    ranks.barrier()
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    place_pipeline_stage(model.eval(), mesh, device)
    ids, mask = (torch.from_numpy(a).to(device) for a in tokens)
    zero_launches()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        emb = esm2_pipeline_forward(model, ids, mask, mesh, n_microbatches=2)
    return rank_report(torch, t0, prof, emb=emb.cpu() if ranks.is_main() else None)


def esm_token_rows(n):
    """T1124's wild-type and mutant ESM-2 tokens (the first ``n`` of them),
    padded to 896 as the extractor pads them, with their masks."""
    import numpy as np

    from packppi_torch.models.esm2 import PAD_ID

    toks = t1124_esm_tokens()[:n]
    T = max(128, -(-max(map(len, toks)) // 128) * 128)
    ids = np.full((n, T), PAD_ID, np.int64)
    mask = np.zeros((n, T), np.float32)
    for i, t in enumerate(toks):
        ids[i, :len(t)], mask[i, :len(t)] = t, 1.0
    return ids, mask


def log_ranks(what, reports):
    for r in reports:
        log(f"  {what} rank {r['rank']} ({r['backend']}): wall {r['wall_s']:.3f} s, peak memory "
            f"{r['peak_mib']:.1f} MiB, launches "
            f"{ {k: v for k, v in r['launches'].items() if v} }, collectives "
            f"{r['collectives']}")


def wrapped_chi_diff(np, a, b, mask):
    d = np.abs(np.angle(np.exp(1j * (a - b)))) * mask
    return float(d.max()), float(d.sum() / max(mask.sum(), 1))


def chis_of(pdb):
    import numpy as np

    from packppi_torch.structure import featurize, from_pdb_file

    f = featurize(from_pdb_file(pdb, mse_to_met=True))
    return np.asarray(f["SC_D"]), np.asarray(f["SC_D_mask"])


def phase_multidevice(torch, esm_weights):
    """Ranks on the one card: (a) a world of one over NCCL, the dry run and
    a DP step bit for bit against one device; (b) 2 ranks sharing the card:
    the sharded best-of-4 pack, a DP training step, ESM-2 650M under tensor
    parallelism and directory mode, each against one device; (c) 3 ranks:
    ESM-2 650M pipelined over 3 stages; (d) 4 ranks (2 x 2): the dry run's
    eight stages and ``cli.train_diffusion`` with FSDP for an epoch and a
    resume. Launch counts come from every rank. Returns the launches per
    rank of the sharded paths, a kernel each."""
    import numpy as np

    from packppi_torch.cli import pack, train_diffusion
    from packppi_torch.parallel.dryrun import dryrun_multichip
    from packppi_torch.parallel.launch import launch
    from packppi_torch.train.diffusion_task import make_train_step

    t_phase = time.perf_counter()
    per_rank = {}
    log(f"multi-device: ranks sharing one card are not a scaling measurement ({card_line()})")

    # a. a world of one over NCCL
    t0 = time.perf_counter()
    dry = dryrun_multichip(1, "cuda")
    log(f"  dryrun_multichip(1) over NCCL: {len(dry['lines'])} stages in "
        f"{time.perf_counter() - t0:.2f} s (launch included), launches "
        f"{ {k: v for k, v in dry['launches'][0].items() if v} }")
    (a,) = launch(md_rank_nccl, 1, "cuda")
    log_ranks("DP step, world of one, NCCL", [a])
    log(f"  DP step through the mesh code vs the step without a mesh (deterministic algorithms): "
        f"losses equal bit for bit {a['same_loss']}; parameters after the step max |d| "
        f"{a['d_mesh']:.3e}, two steps without a mesh max |d| {a['d_repeat']:.3e}")
    if not (a["same_loss"] and a["d_mesh"] == a["d_repeat"] == 0.0 and a["comm_ok"]
            and a["backend"] == "nccl"):
        fail(f"the NCCL world of one departs from one device, or its all-reduce and broadcast "
             f"({a['comm_ok']})")
    if (a["launches_step"]["message_feat"], a["launches_step"]["chain"]) != (5, 5):
        fail(f"the meshed step launched {a['launches_step']}")

    # b. 2 ranks sharing the card over gloo
    pack_argv = ["--input", str(T1124), "--ckpt", str(PIPELINE_GOLDEN), "--n_samples", "4",
                 "--use_proximal", "--precision", "bfloat16", "--n_steps", str(STEPS)]
    one_out = OUT / "md_pack_one"
    t0 = time.perf_counter()
    one = pack.run(pack.build_parser().parse_args(
        pack_argv + ["--outdir", str(one_out), "--n_devices", "1"]))
    log(f"  best-of-4 on one device: {time.perf_counter() - t0:.2f} s")
    esm_tokens = esm_token_rows(1)
    t0 = time.perf_counter()
    reports = launch(md_rank_two, 2, "cuda", pack_argv + ["--outdir", str(OUT / "md_pack_two")],
                     str(esm_weights), esm_tokens, share_device=True)
    log(f"  2 ranks (pack, training step, ESM-2 TP): {time.perf_counter() - t0:.2f} s, "
        f"start-up included")
    for part in ("pack", "train", "esm_tp"):
        log_ranks(part, [r[part] for r in reports])
    # the pack: the same winner, chis within the bf16 limits
    best = [int(line.rsplit(" ", 1)[1]) for line in reports[0]["pack"]["stdout"].splitlines()
            if "keeping sample" in line]
    one_best = None
    for r in reports:
        got = r["pack"]["launches"]
        if (got["message"], got["chain"]) != (150, 150):
            fail(f"sharded pack, rank {r['rank']}: launches {got} (150 message, 150 chain)")
    got0 = reports[0]["pack"]["launches"]
    if (got0["clash_fwd"], got0["clash_bwd"]) != (51 + 1, 50):
        fail(f"sharded pack, rank 0: clash launches {got0} (52 forward with the best-of "
             f"sums, 50 gradient)")
    chi1, m1 = chis_of(one_out / "structure.pdb")
    chi2, _ = chis_of(OUT / "md_pack_two" / "structure.pdb")
    d_max, d_mean = wrapped_chi_diff(np, chi2, chi1, m1)
    # the bf16 limit: twice the distance of the one-device bf16 sample from
    # its float32 sample (the same rows, seed and weights)
    from packppi_torch.data import stack_batch
    from packppi_torch.models import NetworkConfig, TorsionalDiffusion
    from packppi_torch.structure import featurize, from_pdb_file
    from packppi_torch.weights import load_weights

    feats = featurize(from_pdb_file(T1124, mse_to_met=True))
    batch = stack_batch([feats] * 4, "cuda")
    samples = {}
    for dt in ("bfloat16", "float32"):
        m = TorsionalDiffusion(NetworkConfig(compute_dtype=dt, fused_messages="geom_lanes",
                                             fused_chain=True))
        load_weights(m.net, PIPELINE_GOLDEN)
        m.to("cuda")
        samples[dt] = m.sample(batch, torch.Generator(device="cuda").manual_seed(0),
                               n_steps=STEPS).cpu().numpy()
    with torch.no_grad():
        from packppi_torch.ops.clash import compute_residue_clash

        sums = (compute_residue_clash(batch, torch.from_numpy(samples["bfloat16"]).cuda())
                * batch.residue_mask).sum(-1)
    one_best = int(sums.argmin())
    L = len(feats["residue_type"])
    lim_max, lim_mean = wrapped_chi_diff(np, samples["bfloat16"][one_best, :L],
                                         samples["float32"][one_best, :L], m1)
    log(f"  best-of-4 winner: 2 ranks {best}, one device {one_best}; chis of the written PDBs, "
        f"2 ranks vs one device: max {d_max:.3e} mean {d_mean:.3e} rad (limits twice the bf16 "
        f"vs float32 sample distance: {2 * lim_max:.3e}, {2 * lim_mean:.3e}); sampling "
        f"{reports[0]['pack']['metric']['sampling_seconds']:.3f} s on rank 0, "
        f"{one['sampling_seconds']:.3f} s on one device")
    if best != [one_best] or d_max > 2 * lim_max or d_mean > 2 * lim_mean:
        fail("the sharded best-of-4 pack departs from one device")
    # the training step
    state = new_train_state(torch, 0, **TRAIN_KNOBS)
    batch = t1124_train_batch("cuda")
    loss_1 = state.model.loss(batch, state.generator)
    loss_1.backward()
    grads_1 = {k: p.grad.detach().cpu().clone() if p.grad is not None else torch.zeros(p.shape)
               for k, p in state.model.net.named_parameters()}
    lr = state.optimizer.param_groups[0]["lr"]
    state.optimizer.step()
    tr = reports[0]["train"]
    rel = abs(tr["loss"] - loss_1.item()) / abs(loss_1.item())
    log(f"  DP training step (B = 2 a rank): loss {tr['loss']:.6f} vs one device "
        f"{loss_1.item():.6f} (relative {rel:.2e}, limit 1e-5)")
    if rel > 1e-5:
        fail("the DP training step's loss departs from one device")
    compare_param_grads("DP step vs one device", tr["grads"], grads_1, GRAD_REL_TOL_DEVICES)
    d_param = max((tr["params"][k] - v.detach().cpu()).abs().max().item()
                  for k, v in state.params.items())
    log(f"  parameters after the step: max |d| {d_param:.3e} (limit 2 lr = {2 * lr:.1e}: the "
        f"most one Adam step can differ by where a gradient element changes sign)")
    if d_param > 2 * lr:
        fail("the DP step's parameters depart from one device")
    for r in reports:
        got = r["train"]["launches"]
        if (got["message_feat"], got["chain"]) != (5, 5):
            fail(f"DP step, rank {r['rank']}: launches {got} (5 message_feat, 5 chain)")
    del state, batch
    # ESM-2 under TP
    ref_model = esm2_650m(torch, "cuda", weights=torch.load(
        esm_weights, map_location="cuda", weights_only=True)["state_dict"])
    with torch.no_grad():
        ref = ref_model(*(torch.from_numpy(a).cuda() for a in esm_tokens)).cpu()
    emb = reports[0]["esm_tp"]["emb"]
    d = (emb - ref).abs().max().item() / ref.abs().max().item()
    log(f"  ESM-2 650M TP at T = {esm_tokens[0].shape[1]}: max|d| / max|ref| {d:.2e} (limit "
        f"{MD_ESM_TOL:g}); heads a rank {reports[0]['esm_tp']['heads']}")
    if d > MD_ESM_TOL:
        fail("ESM-2 under tensor parallelism departs from one device")
    for r in reports:
        got = r["esm_tp"]["launches"]
        if got["attention"] != 33 or got["gemm"] != 4 * 33 or r["esm_tp"]["heads"] != 10:
            fail(f"ESM-2 TP rank {r['rank']}: {got} on {r['esm_tp']['heads']} heads (33 "
                 f"attention and {4 * 33} gemm launches on 10 heads)")
    for path, part in (("pack_best_of_4", "pack"), ("dp_train_step", "train"),
                       ("esm2_tp", "esm_tp")):
        for k in KERNEL_NAMES:
            counts = [r[part]["launches"][k] for r in reports]
            if any(counts):
                per_rank.setdefault(k, {})[path] = counts
    # directory mode at 2 ranks against one device with the same chunk
    corpus = OUT / "corpus"
    common = ["--input", str(corpus), "--ckpt", str(PIPELINE_GOLDEN), "--n_samples", "2",
              "--use_proximal"]
    sums = {}
    for tag, extra in (("two", ["--batch_size", "2", "--n_devices", "2", "--share_device"]),
                       ("one", ["--batch_size", "4", "--n_devices", "1"]),
                       ("one_f32", ["--batch_size", "4", "--n_devices", "1", "--precision",
                                    "float32"])):
        t0 = time.perf_counter()
        out = OUT / f"md_directory_{tag}"
        pack.run_directory(pack.build_parser().parse_args(common + extra + ["--outdir", str(out)]))
        sums[tag] = json.loads((out / "summary.json").read_text())
        log(f"  cli.pack --input corpus {' '.join(extra)}: {time.perf_counter() - t0:.2f} s, "
            f"{sums[tag]['n'] / sums[tag]['seconds']:.3f} complexes/s")
    # directory mode's bf16 limit (ROADMAP C): each complex within twice its
    # own bf16-to-float32 distance; the ranks' launches hold 2 rows where one
    # device's hold 4, and cuBLAS picks its bf16-path GEMMs by the row count
    worst = []
    for r2, r1, rf in zip(*(sums[t]["results"] for t in ("two", "one", "one_f32"))):
        c2, _ = chis_of(r2["output"])
        c1, mk = chis_of(r1["output"])
        cf, _ = chis_of(rf["output"])
        worst.append((wrapped_chi_diff(np, c2, c1, mk)[0], wrapped_chi_diff(np, c1, cf, mk)[0],
                      Path(r2["output"]).name))
    bits = sum(d == 0.0 for d, _, _ in worst)
    log(f"  directory mode, 2 ranks vs one device: {sums['two']['n']} structures, {bits} equal "
        f"bit for bit in their chis; chi max |d| (limit twice the bf16 vs float32 distance) "
        + ", ".join(f"{n}: {d:.3e} ({2 * lim:.3e})" for d, lim, n in worst))
    if sums["two"]["n"] != sums["one"]["n"] or any(d > 2 * lim for d, lim, _ in worst):
        fail("directory mode on 2 ranks departs from one device")

    # c. 3 ranks: ESM-2 650M over 3 pipeline stages
    tokens2 = esm_token_rows(2)
    with torch.no_grad():
        ref2 = ref_model(*(torch.from_numpy(a).cuda() for a in tokens2)).cpu()
    del ref_model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    reports = launch(md_rank_pipeline, 3, "cuda", str(esm_weights), tokens2, share_device=True)
    log(f"  3 ranks (ESM-2 650M pipeline, 3 stages x 11 blocks, M = 2): "
        f"{time.perf_counter() - t0:.2f} s, start-up included")
    log_ranks("pipeline", reports)
    d = (reports[0]["emb"] - ref2).abs().max().item() / ref2.abs().max().item()
    log(f"  pipeline vs the sequential forward: max|d| / max|ref| {d:.2e} (limit {MD_ESM_TOL:g})")
    if d > MD_ESM_TOL:
        fail("the ESM-2 pipeline departs from the sequential forward")
    for r in reports:
        if r["launches"]["attention"] != 11 * 2 or r["launches"]["gemm"] != 4 * 11 * 2:
            fail(f"pipeline stage {r['rank']}: {r['launches']} (11 attention and 44 gemm a "
                 "microbatch, 2 microbatches)")
    for k in ("attention", "gemm"):
        per_rank.setdefault(k, {})["esm2_pp"] = [r["launches"][k] for r in reports]

    # d. 4 ranks (2 x 2): the dry run's eight stages and the trainer with FSDP
    t0 = time.perf_counter()
    dry = dryrun_multichip(4, "cuda", share_device=True)
    log(f"  dryrun_multichip(4), 2 x 2 sharing the card: {len(dry['lines'])} stages in "
        f"{time.perf_counter() - t0:.2f} s; launches per rank "
        f"{[{k: v for k, v in r.items() if v} for r in dry['launches']]}")
    if len(dry["lines"]) != 8 or any(not r["message"] or not r["attention"]
                                     for r in dry["launches"]):
        fail("the 4-rank dry run skipped a stage or a rank launched no kernel")
    for k in KERNEL_NAMES:
        counts = [r[k] for r in dry["launches"]]
        if any(counts):
            per_rank.setdefault(k, {})["dryrun_4"] = counts
    base, crops = OUT / "md_train_run", OUT / "md_crops"
    for d in (base, crops):
        shutil.rmtree(d, ignore_errors=True)
    crops.mkdir(parents=True)
    for f in sorted((OUT / "crops").glob("*.pdb"))[:64]:     # 64 of phase_trainer's crops
        shutil.copy(f, crops / f.name)
    argv = ["--share_device", "trainer=debug", f"data.data_dir={crops}",
            "data.split_fractions=[0.5,0.25,0.25]", "data.batch_size=4",
            "sample.n_diffusion_steps=3", f"output_dir={base}",
            "trainer.n_devices=4", "trainer.model_parallel=2"]
    argv += [f"model.{k}={str(v).lower()}" for k, v in TRAIN_KNOBS.items()]
    resume = []
    for epochs in (1, 2):
        t0 = time.perf_counter()
        (result,) = train_diffusion.main(argv + [f"trainer.max_epochs={epochs}"] + resume)
        m = result["metrics"]
        resume = [f"ckpt_path={m['last_ckpt']}"]
        log(f"  cli.train_diffusion on 4 ranks (2 x 2, FSDP), max_epochs={epochs}: "
            f"{time.perf_counter() - t0:.2f} s, epochs_run {m['epochs_run']}, best val/loss "
            f"{m['best_val_loss']:.5f}, test/loss {m['test_loss']:.5f}")
        if (m["epochs_run"] != epochs or not np.isfinite(m["best_val_loss"])
                or not np.isfinite(m["test_loss"])):
            fail("the 4-rank trainer did not train, validate, test or resume")
    blob = torch.load(m["last_ckpt"], map_location="cpu", weights_only=True)
    state = new_train_state(torch, 0, **TRAIN_KNOBS)
    state.load_state_dict(blob)               # the 4-rank checkpoint at one device
    step = make_train_step(state.model, state.optimizer)
    loss = step(state, t1124_train_batch("cuda", copies=1, target_len=1024)).item()
    log(f"  the 4-rank checkpoint resumes on one device: a step's loss {loss:.5f}")
    if not math.isfinite(loss):
        fail("the 4-rank checkpoint did not train on one device")
    log(f"phase_multidevice: {time.perf_counter() - t_phase:.1f} s; launches per rank "
        f"{json.dumps(per_rank)}")
    return per_rank


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import packppi_torch  # noqa: F401  (fails outside a checkout)

    t_start = time.perf_counter()
    seconds = {}

    def run(phase, *args):
        """One phase, its seconds kept for the summary line."""
        t0 = time.perf_counter()
        out = phase(*args)
        seconds[phase.__name__] = round(time.perf_counter() - t0, 1)
        return out

    run(phase_versions, torch)
    run(phase_build)
    timer = Timer(torch)
    records = run(phase_kernels, torch, timer)
    records.update(run(phase_message_feat, torch, timer))
    records.update(run(phase_variant_kernels, torch, timer))
    act_times = run(phase_activations, torch, timer)
    width_records = run(phase_widths, torch, timer)
    run(phase_sass)
    run(phase_function_grads, torch)
    clash_records = run(phase_clash_kernels, torch, timer)
    attention_records = run(phase_attention, torch, timer)
    gemm_records = run(phase_gemm, torch, timer)
    run(phase_golden, torch)
    run(phase_golden_variants, torch)
    run(phase_prox_golden, torch)
    run(phase_network_vs_cpu, torch)
    launches = run(phase_pack, torch)
    run(phase_width_packs, torch)
    run(phase_width_train, torch)
    directory_launches = run(phase_directory, torch)
    variant_launches = run(phase_pack_variants, torch)
    sc = run(phase_latency, torch)
    run(phase_profile, torch, sc)
    run(phase_loss_grads, torch)
    train_launches = run(phase_train, torch)
    run(phase_trainer, torch)
    run(phase_gelu_path, torch)
    run(phase_static_edge_dtype, torch)
    run(phase_vanilla, torch)
    run(phase_native)
    run(phase_shipped_checkpoint, torch)
    cpu_esm = run(phase_esm, torch)
    esm_launches, esm_weights = run(phase_ddg_esm, torch, cpu_esm)
    del cpu_esm
    run(phase_ddg_eval_esm, torch, esm_weights)
    run(phase_ddg_eval, torch)
    run(phase_pack_unfused, torch)
    affinity_launches = run(phase_train_affinity, torch)
    affinity_launches.update(run(phase_train_affinity_esm, torch, esm_weights))
    multidevice_launches = run(phase_multidevice, torch, esm_weights)
    esm_weights.unlink()
    serve_launches = run(phase_serve, torch)
    log(f"seconds by phase: {json.dumps(seconds)}")

    kernels = []
    for name, source, replaces in (
            ("message", "packppi_torch/csrc/message.cu", "packppi_tpu/ops/pallas_ipmp.py:249"),
            ("message_feat", "packppi_torch/csrc/message_feat.cu",
             "packppi_tpu/ops/pallas_ipmp.py:52"),
            ("chain", "packppi_torch/csrc/chain.cu", "packppi_tpu/ops/pallas_layer.py:62"),
            ("clash_fwd", "packppi_torch/csrc/clash.cu", "packppi_tpu/ops/pallas_clash.py:132"),
            ("clash_bwd", "packppi_torch/csrc/clash.cu", "packppi_tpu/ops/pallas_clash.py:272"),
            ("attention", "packppi_torch/csrc/attention.cu",
             "packppi_tpu/ops/pallas_attention.py:40"),
            ("message_geom", "packppi_torch/csrc/message.cu", "packppi_tpu/ops/pallas_ipmp.py:79"),
            ("message_gather", "packppi_torch/csrc/message.cu",
             "packppi_tpu/ops/pallas_ipmp.py:398"),
            ("message_chain", "packppi_torch/csrc/message.cu",
             "packppi_tpu/ops/pallas_ipmp.py:370"),
            ("layer_node", "packppi_torch/csrc/layer.cu", "packppi_tpu/ops/pallas_layer.py:315"),
            ("layer_edge", "packppi_torch/csrc/layer.cu", "packppi_tpu/ops/pallas_layer.py:344"),
            ("gemm", "packppi_torch/csrc/gemm.cu", None)):
        # each kernel at its main path's dtype and larger pass (packing in
        # bf16 at T1124, training in float32 at B = 4, L = 1,024, ESM-2 in
        # float32 at T1124's 896 tokens, the GEMM at the FFN's first map of
        # a scan batch at T = 896 with its GELU); the clash kernels at
        # T1124, the node pass of the whole layer at T1124's nodes. The
        # GEMM replaces no TPU kernel (the JAX package leaves ESM-2's
        # products to XLA); its ``maps`` give every shape of phase_gemm.
        # Launches: the packing run's (for the new kernels, the pack under
        # their routing), for the feature-message kernel the 20 training
        # steps', for attention the cli.ddg --mode esm call's
        if name in clash_records:
            r = clash_records[name]
        elif name == "attention":
            r = attention_records[("attention", "float32", "T1124")]
        elif name == "gemm":
            r = gemm_records[("gemm", "float32", "ffn_in M=4480")]
        else:
            r = records[(name, "float32" if name == "message_feat" else "bfloat16",
                         "node" if name == "layer_node" else "edge")]
        routing = {"message_geom": "geom", "message_gather": "geom_gather",
                   "message_chain": "fold", "layer_node": "fused_layers",
                   "layer_edge": "fused_layers"}.get(name)
        launches_main = ({"message_feat": train_launches["message_feat"],
                          "attention": esm_launches["attention"],
                          "gemm": esm_launches["gemm"]}.get(name, launches[name])
                         if routing is None else variant_launches[routing][name])
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches_main,
            "launches_training": train_launches[name],
            "launches_directory_chunk": directory_launches.get(name, 0),
            "launches_affinity_training": affinity_launches[name],
            "launches_serve": serve_launches[name],
            "launches_per_rank_sharded": multidevice_launches.get(name, {}),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r.get("library_ms")})
        # the same pass's kernel under each activation built (phase_activations)
        by_act = act_times.get((name, "float32" if name == "message_feat" else "bfloat16",
                                "node" if name == "layer_node" else "edge"))
        if by_act:
            kernels[-1]["ms_by_activation"] = by_act
        if name == "gemm":
            kernels[-1]["maps"] = [
                {"map": v, "max_rel_err": r["max_rel_err"], "plain_rel_err": r["plain_rel_err"],
                 "control_rel_err": r["control_rel_err"], "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
                 "bound_ms": r["bound"][0], "bound_by": r["bound"][1]}
                for (k, d, v), r in gemm_records.items()]
        # the same kernel at the widths of phase_widths (T1124's graph)
        kernels[-1]["widths"] = [
            {"H": H, "He": He, "P": P, "K": K, "dtype": d, "variant": v,
             "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
             "bound_ms": r["bound"][0], "bound_by": r["bound"][1]}
            for (k, d, v, H, He, P, K), r in width_records.items() if k == name]
    log(f"whole script: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
