"""Multi-rank dry run: every parallel path of the port, once, at small shapes.

``dryrun_multichip(n_devices, device)`` starts ``n_devices`` ranks and runs,
in order and with the JAX package's asserts:

1. dp x fsdp: one training step of the full network, the batch's rows over
   ``data`` and the large tensors sharded over ``model``;
2. dp x sp: the loss with the residue axis sharded over ``model`` as well;
3. sharded inference: the reverse sampler and per-complex clash sums, one
   row a rank;
4. select + refine: a directory chunk of two samples a complex, its winners
   chosen from the gathered clash sums and refined (each rank its rows);
5. local geometry: the sampler with ``geometry_mode="local"``;
6. affinity dp x fsdp: one step of the affinity network over the frozen
   backbone, both sharded over ``model``;
7. ESM-2 dp x tp: the transformer with its heads over ``model``;
8. ESM-2 dp x pp: its blocks pipelined over ``model``, held to the
   sequential forward (max |pp - sequential| < 1e-4).

``model_parallel`` is 2 when the rank count is even and above 1, else 1;
stages 2, 6, 7 and 8 need it and stage 4 an even count, as in the JAX
package's dry run. Each rank returns its report (one line a stage, and the
kernel launches it made); ``dryrun_multichip`` returns rank 0's lines and
every rank's launches.

    python -m packppi_torch.parallel.dryrun [N] [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch


def synthetic_batch(B: int = 1, L: int = 64, seed: int = 0) -> dict:
    """A small physically plausible batch without file I/O, as numpy arrays
    under ``ProteinBatch``'s names: an ideal helix-like backbone with random
    chi angles."""
    from packppi_torch.chem import CHEM

    rng = np.random.default_rng(seed)
    restype = rng.integers(0, 20, (B, L))
    chi_mask = CHEM.chi_mask[restype]
    t = np.arange(L, dtype=np.float32)
    ca = np.stack([3.8 * t, 2.0 * np.sin(t), 2.0 * np.cos(t)], -1)
    n = ca + np.array([-1.2, 0.6, 0.0], np.float32)
    c = ca + np.array([1.3, 0.6, 0.0], np.float32)
    o = c + np.array([0.3, 1.1, 0.0], np.float32)
    X = np.zeros((B, L, 14, 3), np.float32)
    X[:, :, 0], X[:, :, 1], X[:, :, 2], X[:, :, 3] = n, ca, c, o
    sc_d = (rng.uniform(-np.pi, np.pi, (B, L, 4)) * chi_mask).astype(np.float32)
    sc_mask = chi_mask.astype(np.float32)
    bb_d = rng.uniform(-np.pi, np.pi, (B, L, 3)).astype(np.float32)
    pi_p = CHEM.chi_pi_periodic[restype].astype(bool)
    return dict(
        X=X, atom_mask=CHEM.atom14_mask[restype].astype(np.float32),
        residue_type=restype.astype(np.int64), residue_mask=np.ones((B, L), np.float32),
        residue_index=np.tile(np.arange(1, L + 1, dtype=np.int64), (B, 1)),
        chain_indices=np.ones((B, L), np.int64), BB_D=bb_d,
        BB_D_sincos=np.stack([np.sin(bb_d), np.cos(bb_d)], -1).astype(np.float32),
        BB_D_mask=np.ones((B, L, 3), np.float32), SC_D=sc_d,
        SC_D_sincos=(np.stack([np.sin(sc_d), np.cos(sc_d)], -1)
                     * sc_mask[..., None]).astype(np.float32),
        SC_D_mask=sc_mask, chi_1pi_periodic_mask=sc_mask.astype(bool) & pi_p,
        chi_2pi_periodic_mask=sc_mask.astype(bool) & ~pi_p)


def to_batch(arrays: dict, device, cls=None):
    """numpy arrays under a batch's field names -> the batch on ``device``."""
    from packppi_torch.data.batch import ProteinBatch

    cls = cls or ProteinBatch
    return cls(**{f: torch.from_numpy(np.ascontiguousarray(arrays[f])).to(device)
                  for f in cls._fields})


def _rows(arrays: dict, rows: slice) -> dict:
    return {k: v[rows] for k, v in arrays.items()}


def _dryrun_rank(n_devices: int) -> dict:
    from packppi_torch.models import NetworkConfig, SampleConfig, TorsionalDiffusion
    from packppi_torch.models.torsional_diffusion import Rows
    from packppi_torch.ops.clash import compute_residue_clash
    from packppi_torch.parallel.launch import current
    from packppi_torch.parallel.mesh import (batch_rows, gather_rows, gather_seq, make_mesh,
                                             seq_batch_shards)
    from packppi_torch.sampling.proximal import proximal_optimize
    from packppi_torch.train.diffusion_task import (global_loss_terms, init_state,
                                                    make_train_step)
    from packppi_torch.utils.trace import counters

    device = current().device
    model_parallel = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(model_parallel)
    dmesh = make_mesh(1)                       # every rank along data
    n_data = mesh.data
    lines = []

    # 1. dp x fsdp train step
    model = TorsionalDiffusion(NetworkConfig(), SampleConfig())
    state = init_state(model, 0, device, mesh=mesh)
    host = synthetic_batch(B=n_data, L=64)
    batch = to_batch(_rows(host, batch_rows(mesh, n_data)), device)
    loss = make_train_step(model, state.optimizer)(state, batch)
    assert bool(torch.isfinite(loss)), f"non-finite loss {loss}"
    assert state.step == 1 and state.opt_steps == 1
    lines.append(f"dryrun_multichip OK (dp x fsdp): mesh={mesh.shape} loss={float(loss):.4f}")

    if model_parallel > 1:
        # 2. dp x sp: the residue axis sharded over model for storage,
        # gathered at the loss's entry
        full = to_batch(host, device)
        sp = seq_batch_shards(mesh, full)
        g = torch.Generator(device=device).manual_seed(2)
        with torch.no_grad():
            v, _ = global_loss_terms(model, mesh, gather_seq(mesh, sp), g, True)
        assert bool(torch.isfinite(v))
        lines.append(f"dryrun_multichip OK (dp x sp): loss={float(v):.4f}")

    # 3. sharded inference: the sampler and the clash sums, rows over data
    inf = synthetic_batch(B=n_devices, L=64, seed=3)
    mine = batch_rows(dmesh, n_devices)
    b_rows = to_batch(_rows(inf, mine), device)
    g = torch.Generator(device=device).manual_seed(4)
    rows = Rows(mine.start, n_devices, dmesh.data_group)
    sc = model.sample(b_rows, g, n_steps=2, rows=rows)
    with torch.no_grad():
        clash = gather_rows(dmesh, (compute_residue_clash(b_rows, sc)
                                    * b_rows.residue_mask).sum(-1))
    sc_all = gather_rows(dmesh, sc)
    assert bool(torch.isfinite(clash).all())
    assert tuple(sc_all.shape) == (n_devices, 64, 4)
    lines.append(f"dryrun_multichip OK (sharded inference): rows={n_devices} "
                 f"mean_clash={float(clash.mean()):.4f}")

    if n_devices % 2 == 0:
        # 4. select + refine: two samples a complex, winners from the
        # gathered sums, each rank refining its rows of the winner batch
        g = torch.Generator(device=device).manual_seed(5)
        sc = gather_rows(dmesh, model.sample(b_rows, g, n_steps=2, rows=rows))
        per_chunk = n_devices // 2
        win = clash.view(per_chunk, 2).argmin(1) + torch.arange(per_chunk, device=device) * 2
        win = torch.cat([win, win[-1:].expand(n_devices - per_chunk)])
        base = torch.cat([torch.arange(per_chunk, device=device) * 2,
                          torch.full((n_devices - per_chunk,), (per_chunk - 1) * 2,
                                     device=device)])
        full_inf = to_batch(inf, device)
        wb = type(full_inf)(*(t.index_select(0, base[mine]) for t in full_inf))
        sw = sc.index_select(0, win[mine])
        res = proximal_optimize(wb, sw, 12.0, 0.5, 1.0, 2, n_rows=n_devices)
        accept = res.row_losses[-1] < res.row_losses[0]
        out = torch.where(accept[:, None, None], res.SC_D, sw)
        accept = gather_rows(dmesh, accept)
        assert bool(torch.isfinite(out).all())
        lines.append(f"dryrun_multichip OK (select+refine chunk): "
                     f"accepted={int(accept.sum())}/{accept.shape[0]}")

    # 5. local-frame geometry: the static relative transforms with the rows
    local = TorsionalDiffusion(NetworkConfig(geometry_mode="local", fused_messages=True),
                               SampleConfig()).to(device)
    local.net.load_state_dict(model.net.state_dict())
    g = torch.Generator(device=device).manual_seed(6)
    sc_local = local.sample(b_rows, g, n_steps=2, rows=rows)
    assert bool(torch.isfinite(sc_local).all())
    lines.append("dryrun_multichip OK (local-geometry inference)")

    if model_parallel > 1:
        lines.append(_affinity_stage(model, mesh, device, n_data))
        lines.extend(_esm_stages(mesh, device, n_data, model_parallel))
    return {"lines": lines, "launches": counters()}


def _affinity_stage(model, mesh, device, n_data) -> str:
    """6. affinity dp x fsdp: the trainable network and the frozen backbone
    sharded over model, mutation rows over data."""
    from packppi_torch.chem import CHEM
    from packppi_torch.data.skempi import AffinityBatch
    from packppi_torch.models import NetworkConfig
    from packppi_torch.models.affinity import AffinityModel
    from packppi_torch.parallel.mesh import batch_rows
    from packppi_torch.train.loop import (_backbone_context, affinity_optimizer,
                                          make_affinity_train_step)
    from packppi_torch.weights import init_weights

    pb = synthetic_batch(B=n_data, L=64, seed=7)
    rng = np.random.default_rng(7)
    mut_pos = rng.integers(4, 60, n_data)
    rt_mut = pb["residue_type"].copy()
    rt_mut[np.arange(n_data), mut_pos] = (rt_mut[np.arange(n_data), mut_pos] + 1) % 20
    mut_mask = np.zeros((n_data, 64), np.int64)
    mut_mask[np.arange(n_data), mut_pos] = 1
    chi_mut = CHEM.chi_mask[rt_mut].astype(bool)
    ab = dict(pb, residue_type_mut=rt_mut, atom_mask_mut=CHEM.atom14_mask[rt_mut],
              SC_D_mut=pb["SC_D"], SC_D_sincos_mut=pb["SC_D_sincos"],
              SC_D_mask_mut=chi_mut.astype(np.float32),
              chi_1pi_periodic_mask_mut=CHEM.chi_pi_periodic[rt_mut].astype(bool) & chi_mut,
              chi_2pi_periodic_mask_mut=chi_mut & ~CHEM.chi_pi_periodic[rt_mut].astype(bool),
              ddg=rng.normal(size=n_data).astype(np.float32), mut_mask=mut_mask)
    ab = {k: (v.astype(np.float32) if v.dtype.kind == "f" else v) for k, v in ab.items()}
    batch = to_batch(_rows(ab, batch_rows(mesh, n_data)), device, AffinityBatch)

    amodel = AffinityModel(NetworkConfig())
    amodel.backbone.net.load_state_dict(model.net.state_dict())
    init_weights(amodel.net, 8)
    amodel.to(device)
    opt = affinity_optimizer(amodel, 1e-4, 1e-4, mesh)
    torch.manual_seed(9)
    step = make_affinity_train_step(amodel, opt, None, mesh, _backbone_context(amodel, mesh))
    loss = step(batch, 0)
    assert bool(torch.isfinite(loss)), f"non-finite affinity loss {loss}"
    return f"dryrun_multichip OK (affinity dp x fsdp): loss={float(loss):.4f}"


def _esm_stages(mesh, device, n_data, model_parallel) -> list:
    """7. and 8.: ESM-2 under tensor and pipeline parallelism."""
    from packppi_torch.models.esm2 import (ESM2, ESM2Config, TensorParallelESM2,
                                           esm2_pipeline_forward, init_esm_weights)
    from packppi_torch.parallel.mesh import gather_rows

    cfg = ESM2Config(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
                     attention_impl="auto")
    esm = ESM2(cfg).eval()
    init_esm_weights(esm, 11)
    rng = np.random.default_rng(11)
    T = 16
    ids = torch.from_numpy(rng.integers(4, 31, size=(n_data, T))).to(device)
    emask = torch.ones(n_data, T, device=device)
    tp = TensorParallelESM2(esm, mesh, device)
    emb = gather_rows(mesh, tp.forward(ids, emask))
    assert bool(torch.isfinite(emb).all())
    assert tuple(emb.shape) == (n_data, T, cfg.hidden_size)
    lines = [f"dryrun_multichip OK (esm2 dp x tp): emb_norm={float(emb.norm()):.4f}"]

    esm.to(device)
    ids2 = ids.repeat_interleave(2, 0)           # 2 rows a data shard -> M = 2
    emask2 = torch.ones_like(ids2, dtype=torch.float32)
    with torch.no_grad():
        ref = esm(ids2, emask2)
    emb_pp = gather_rows(mesh, esm2_pipeline_forward(esm, ids2, emask2, mesh, 2))
    assert bool(torch.isfinite(emb_pp).all())
    delta = float((emb_pp - ref).abs().max())
    assert delta < 1e-4, f"pipeline forward mismatch vs the sequential forward: {delta}"
    lines.append(f"dryrun_multichip OK (esm2 dp x pp): stages={model_parallel} "
                 f"microbatches=2 max|pp-seq|={delta:.2e}")
    return lines


def dryrun_multichip(n_devices: int, device="cuda", share_device: bool = False) -> dict:
    """Run the eight stages on ``n_devices`` ranks; returns ``{"lines":
    rank 0's report, "launches": [each rank's kernel launches]}``."""
    from packppi_torch.parallel.launch import launch

    reports = launch(_dryrun_rank, n_devices, device, n_devices, share_device=share_device)
    for line in reports[0]["lines"]:
        print(line)
    return {"lines": reports[0]["lines"], "launches": [r["launches"] for r in reports]}


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Multi-rank dry run of the port's parallel paths")
    p.add_argument("n_devices", nargs="?", type=int, default=None,
                   help="ranks (default: every visible card)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--share_device", action="store_true")
    args = p.parse_args(argv)
    n = args.n_devices or (torch.cuda.device_count() if args.device == "cuda" else 1)
    dryrun_multichip(n, args.device, args.share_device)


if __name__ == "__main__":
    main()
