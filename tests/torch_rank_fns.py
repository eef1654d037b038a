"""What the multi-rank tests run on each rank (``packppi_torch.parallel.launch``
spawns the ranks and imports this module in each). It imports torch and the
port only, never JAX: the tests compare what the ranks return with the JAX
package in the test process. Inputs and outputs are numpy arrays."""
import sys

import numpy as np
import torch


def loaded_jax_modules() -> list:
    import packppi_torch.parallel.dryrun  # noqa: F401
    import packppi_torch.train.loop  # noqa: F401

    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "packppi_tpu"))


def _mlp_carry(w, b, x, bias, keep):
    layers = [(torch.from_numpy(w[i]), torch.from_numpy(b[i])) for i in range(len(w))]
    carry = (torch.from_numpy(x), torch.from_numpy(bias), torch.from_numpy(keep))

    def apply_layer(lp, c):
        x, bias, keep = c
        return torch.tanh(x @ lp[0] + lp[1] + bias) * keep[:, None, None].to(x.dtype), bias, keep

    return layers, carry, apply_layer


def pipeline(pp, M, w, b, x, bias, keep, errors=False) -> dict:
    """``pipeline_apply`` of a tanh MLP stack over a (x, bias, bool keep)
    carry on a ``(ranks / pp, pp)`` mesh; this rank's rows, the dtype of the
    bool leaf, and with ``errors`` the two divisibility errors' messages."""
    from packppi_torch.parallel import batch_rows, make_mesh, pipeline_apply

    mesh = make_mesh(pp)
    layers, carry, apply_layer = _mlp_carry(w, b, x, bias, keep)
    out = pipeline_apply(mesh, layers, carry, apply_layer, M)
    res = {"rows": batch_rows(mesh, x.shape[0]), "x": out[0].numpy(), "bias": out[1].numpy(),
           "keep": out[2].numpy(), "keep_dtype": str(out[2].dtype)}
    if errors:
        res["errors"] = []
        for n_layers, B, n_micro in ((3, x.shape[0], M), (len(w), 3, M)):
            try:
                pipeline_apply(mesh, layers[:n_layers], tuple(t[:B] for t in carry),
                               apply_layer, n_micro)
            except ValueError as e:
                res["errors"].append(str(e))
    return res


def esm_parallel(sd, cfg_kw, ids, mask, mp, M) -> dict:
    """ESM-2 under tensor and pipeline parallelism on a ``(ranks / mp, mp)``
    mesh: this rank's rows of each forward."""
    from packppi_torch.models.esm2 import (ESM2, ESM2Config, TensorParallelESM2,
                                           esm2_pipeline_forward)
    from packppi_torch.parallel import batch_rows, make_mesh
    from packppi_torch.weights import load_esm_state_dict

    mesh = make_mesh(mp)
    model = ESM2(ESM2Config(**cfg_kw)).eval()
    load_esm_state_dict(model, sd)
    ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
    tp = TensorParallelESM2(model, mesh, "cpu").forward(ids, mask)
    pp = esm2_pipeline_forward(model, ids, mask, mesh, M)
    return {"rows": batch_rows(mesh, ids.shape[0]), "tp": tp.numpy(), "pp": pp.numpy()}


def mesh_2x2(fsdp, mlp, esm) -> dict:
    """One launch of 4 ranks (2 x 2): ``fsdp_step``, ``pipeline`` and
    ``esm_parallel``, and the JAX modules a rank has loaded."""
    return {"fsdp": fsdp_step(*fsdp), "pipeline": pipeline(2, *mlp),
            "esm": esm_parallel(*esm), "jax_modules": loaded_jax_modules()}


def _model(sd, **cfg):
    from packppi_torch.models import NetworkConfig, TorsionalDiffusion

    model = TorsionalDiffusion(NetworkConfig(**cfg))
    model.net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return model


def dp_loss(sd, cfg, feats, L, draws) -> dict:
    """The loss of a global batch (``feats``, padded to ``L``) split over a
    data mesh of every rank, with the global batch's draws."""
    from packppi_torch.data import stack_batch
    from packppi_torch.parallel import batch_rows, make_mesh
    from packppi_torch.train.diffusion_task import global_loss_terms

    mesh = make_mesh(1)
    rows = batch_rows(mesh, len(feats))
    batch = stack_batch(feats[rows], "cpu", target_len=L)
    loss, local = global_loss_terms(_model(sd, **cfg), mesh, batch, None, False,
                                    {k: torch.from_numpy(v) for k, v in draws.items()})
    return {"loss": loss.item(), "chis": float(batch.SC_D_mask.sum())}


def fsdp_step(sd, cfg, feats, L, draws, model_parallel, seq_case) -> dict:
    """One AdamW step of the train step under DP x FSDP (every parameter
    after it, gathered), and the sequence-parallel refinement of
    ``seq_case`` on the same mesh."""
    from packppi_torch.data import stack_batch
    from packppi_torch.parallel import batch_rows, make_mesh, seq_batch_shards
    from packppi_torch.parallel.mesh import gather_seq
    from packppi_torch.sampling.proximal import proximal_optimize_seq
    from packppi_torch.train.diffusion_task import init_state, make_train_step

    mesh = make_mesh(model_parallel)
    model = _model(sd, **cfg)
    state = init_state(model, 0, "cpu", mesh=mesh)
    state.sharded.load_full({k: torch.from_numpy(v) for k, v in sd.items()})
    batch = stack_batch(feats[batch_rows(mesh, len(feats))], "cpu", target_len=L)
    loss = make_train_step(model, state.optimizer)(
        state, batch, **{k: torch.from_numpy(v) for k, v in draws.items()})
    params = {k: v.numpy().copy() for k, v in state.params.items()}
    sharded = sorted(state.sharded.sharded())
    opt = state.state_dict()["opt_state"]

    from packppi_torch.parallel.dryrun import to_batch

    arrays, bad, steps = seq_case
    sp = seq_batch_shards(mesh, to_batch(arrays, "cpu"))
    bad_sp = torch.from_numpy(bad)[batch_rows(mesh, bad.shape[0])]
    L_seq = bad.shape[1]
    bad_sp = bad_sp[:, mesh.model_index * (L_seq // mesh.model):
                    (mesh.model_index + 1) * (L_seq // mesh.model)]
    res = proximal_optimize_seq(mesh, sp, bad_sp, num_steps=steps)
    return {"loss": loss.item(), "params": params, "sharded": sharded,
            "opt_state": opt, "rows": batch_rows(mesh, bad.shape[0]),
            "seq_sc": gather_seq(mesh, res.SC_D).numpy(), "seq_losses": res.losses.numpy()}


def cli_paths(pack_argv, dir_pack_argv, dir_prox_argv) -> dict:
    """cli.pack on one structure (best-of-N rows over the ranks) and the
    directory modes of cli.pack and cli.prox, each as ``on_ranks`` runs it
    on every rank of a data mesh; rank 0's results."""
    from packppi_torch.cli import pack, prox
    from packppi_torch.parallel.launch import current
    from packppi_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1)
    device = current().device
    return {"pack": pack._run(pack.build_parser().parse_args(pack_argv), device, mesh),
            "dir_pack": pack._run_directory(pack.build_parser().parse_args(dir_pack_argv),
                                            device, mesh),
            "dir_prox": prox._run_directory(prox.build_parser().parse_args(dir_prox_argv),
                                            device, mesh)}
