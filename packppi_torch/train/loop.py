"""The training loops of both task families, on one device or a mesh of
ranks.

``trainer.n_devices`` ranks (null: every visible card, one on the CPU; a
request above the visible cards is clamped) in a ``(data, model)`` mesh with
``trainer.model_parallel`` ranks along ``model``: each rank trains on its
rows of the global batch (``data.batch_size`` x data), the parameters and
optimizer state FSDP-sharded over ``model`` (``parallel.ShardedParams``).
Rank 0 alone writes checkpoints (whole tensors, the one-device format),
logs and split files; a checkpoint of any rank count resumes at any other.

``train_diffusion``: seeded draws, bucketed loaders, per-epoch validation on
fixed draws, top-k + last checkpoints with resume, EMA, early stopping,
periodic sampling evaluation and the final test on the best checkpoint.

``train_affinity``: PackPPI-AP on SKEMPI cross-validation folds over a
frozen diffusion backbone (``network``/``linear`` mode) or over ESM-2
embeddings (``esm`` mode, ``_train_affinity_esm``), with per-epoch
validation (loss, Pearson, Spearman, RMSE), EMA and top-k + last
checkpoints of the affinity network's parameters.
"""
from __future__ import annotations

import contextlib
import functools
import json
import math
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from packppi_torch.parallel import launch as ranks
from packppi_torch.parallel.mesh import (ShardedParams, batch_rows, gather_rows, make_mesh,
                                         reduce_sum)
from packppi_torch.train.checkpoints import load_params, save_params
from packppi_torch.train.diffusion_task import (global_loss_terms, init_state, make_ema_update,
                                                make_optimizer, make_train_step)
from packppi_torch.utils.logging import MetricLogger, get_logger

log = get_logger(__name__)

# tags of the fixed evaluation streams, never advanced by training
VAL_STREAM, TEST_STREAM, SAMPLE_STREAM = 0x5EED, 0x7E57, 0x5A3D


def init_ema(cfg, params: dict, resume: Optional[str]):
    """``(ema_decay, ema, ema_step)``; ema and ema_step are None when
    ``trainer.ema_decay`` is 0. The EMA starts as a copy of the parameters
    (never an alias: it is updated in place), or from the ``_ema`` sidecar of
    the checkpoint being resumed."""
    ema_decay = float(cfg.trainer.get("ema_decay", 0.0) or 0.0)
    if ema_decay <= 0.0:
        return ema_decay, None, None
    ema = {k: v.detach().clone() for k, v in params.items()}
    sidecar = ema_path(resume) if resume else None
    if sidecar is not None and sidecar.exists():
        loaded = load_params(sidecar)
        ema = {k: loaded[k].to(v.device) for k, v in ema.items()}
    return ema_decay, ema, make_ema_update(ema_decay)


def ema_path(ckpt: str) -> Path:
    p = Path(ckpt)
    return p.with_name(f"{p.stem}_ema{p.suffix}")


class CheckpointManager:
    """top-k-by-metric + always-last retention over ``<dir>/step_XXXXXXXX.pt``
    files (an ``_ema`` sidecar beside each when given), indexed in
    ``index.json``."""

    def __init__(self, directory: str, top_k: int = 3, mode: str = "min",
                 write: bool = True):
        self.dir = Path(directory)
        self.write = write      # False: the index only (a rank other than 0)
        if write:
            self.dir.mkdir(parents=True, exist_ok=True)
        self.top_k = top_k
        self.mode = mode
        self.index_file = self.dir / "index.json"
        self.index = json.loads(self.index_file.read_text()) if self.index_file.exists() else {}

    def path(self, name: str) -> Path:
        return self.dir / f"{name}.pt"

    def save(self, step: int, state: dict, metric: Optional[float] = None,
             ema: Optional[dict] = None) -> None:
        name = f"step_{step:08d}"
        if self.write:
            save_params(self.path(name), state)
            if ema is not None:
                # params-only sidecar: `cli.pack --ckpt <...>_ema.pt` loads it directly
                save_params(ema_path(self.path(name)), ema)
        self.index[name] = {"step": step, "metric": metric}
        self._prune()
        if self.write:
            self.index_file.write_text(json.dumps(self.index))

    def _scored(self):
        scored = [(n, m["metric"]) for n, m in self.index.items() if m["metric"] is not None]
        scored.sort(key=lambda x: x[1], reverse=(self.mode == "max"))
        return scored

    def _prune(self):
        keep = {n for n, _ in self._scored()[: self.top_k]}
        keep.add(max(self.index, key=lambda n: self.index[n]["step"]))
        for name in list(self.index):
            if name not in keep:
                if self.write:
                    self.path(name).unlink(missing_ok=True)
                    ema_path(self.path(name)).unlink(missing_ok=True)
                del self.index[name]

    def latest(self) -> Optional[str]:
        if not self.index:
            return None
        return str(self.path(max(self.index, key=lambda n: self.index[n]["step"])))

    def best(self) -> Optional[str]:
        scored = self._scored()
        return str(self.path(scored[0][0])) if scored else self.latest()


def make_lr(trainer_cfg, steps_per_epoch: int):
    """The learning rate, or a schedule over optimizer steps: linear warm-up
    from 0 to ``lr`` over ``warmup_steps``, then a cosine to ``lr / 10`` at
    the run's last optimizer step."""
    schedule = trainer_cfg.get("lr_schedule", "constant") or "constant"
    lr = float(trainer_cfg.lr)
    if schedule == "constant":
        return lr
    if schedule != "cosine":
        raise ValueError(f"unknown lr_schedule {schedule!r} (constant | cosine)")
    warmup = int(trainer_cfg.get("warmup_steps", 0))
    # the horizon counts optimizer steps, not micro-batches
    accum = max(1, int(trainer_cfg.get("grad_accum_steps", 1)))
    total = max(trainer_cfg.max_epochs * max(steps_per_epoch // accum, 1), warmup + 1)
    end = lr * 0.1

    def at(count: int) -> float:
        if count < warmup:
            return lr * count / warmup
        frac = min(max(count - warmup, 0) / (total - warmup), 1.0)
        return end + (lr - end) * 0.5 * (1.0 + math.cos(math.pi * frac))

    return at


class EarlyStopper:
    """val/loss early stopping with patience counted in validation checks,
    mode min. Disabled when ``trainer.early_stopping_patience`` <= 0."""

    def __init__(self, trainer_cfg):
        self.patience = int(trainer_cfg.get("early_stopping_patience", 0) or 0)
        self.min_delta = float(trainer_cfg.get("early_stopping_min_delta", 0.0) or 0.0)
        self.min_epochs = int(trainer_cfg.get("min_epochs", 0) or 0)
        self.best = float("inf")
        self.stale = 0

    def should_stop(self, epoch: int, val_loss: float) -> bool:
        """Feed one validation result; True once ``patience`` consecutive
        checks brought no improvement and ``min_epochs`` have completed.
        Non-finite losses (epochs without validation) neither improve nor
        count."""
        if self.patience <= 0 or not np.isfinite(val_loss):
            return False
        if val_loss < self.best - self.min_delta:
            self.best, self.stale = val_loss, 0
        else:
            self.stale += 1
        return self.stale >= self.patience and (epoch + 1) >= self.min_epochs


def eval_generator(seed: int, stream: int, index: int, device) -> torch.Generator:
    """The fixed generator of evaluation batch ``index`` of one stream: every
    pass over an unshuffled loader sees the same time and noise draws, so
    differences in val/loss across epochs come from the parameters alone."""
    g = torch.Generator(device=device)
    return g.manual_seed((seed * 0x9E3779B1 + stream * 0x85EBCA6B + index + 1) % (2 ** 63))


@contextlib.contextmanager
def swapped_params(net: torch.nn.Module, params: Optional[dict]):
    """Evaluate ``net`` on ``params`` (the EMA weights), then put the live
    parameters back."""
    if params is None:
        yield
        return
    live = {k: v.detach().clone() for k, v in net.state_dict().items()}
    net.load_state_dict(params, strict=True)
    try:
        yield
    finally:
        net.load_state_dict(live, strict=True)


def _mean(losses) -> float:
    return float(torch.stack(losses).mean()) if losses else float("nan")


def mesh_shape(cfg, device, share_device: bool = False) -> tuple:
    """``(ranks, model_parallel)`` of ``cfg.trainer``: ``n_devices`` as the
    JAX package resolves it (null: every visible card; clamped to them
    unless the ranks share a card)."""
    n = ranks.resolve_ranks(cfg.trainer.get("n_devices"), device, "trainer.n_devices",
                            share_device)
    mp = int(cfg.trainer.get("model_parallel", 1) or 1)
    if n > 1 and n % mp:          # one device trains without a mesh, as in JAX
        raise ValueError(f"{n} devices not divisible by model_parallel={mp}")
    return n, mp


def _on_ranks(fn, cfg, device, n, mp, share_device):
    """``fn(cfg, device, mesh)`` on one device (mesh None), or rank 0's
    result of it over ``n`` ranks, ``mp`` along ``model``."""
    if n == 1:
        return fn(cfg, device, None)
    return ranks.launch(_rank_entry, n, device, fn, cfg, mp, share_device=share_device)[0]


def _rank_entry(fn, cfg, mp):
    mesh = make_mesh(mp)
    log.info(f"rank {mesh.rank}: mesh {mesh.shape}")
    return fn(cfg, ranks.current().device, mesh)


def _main_first(fn):
    """``fn()`` on rank 0, then on the other ranks: what rank 0 writes (a
    split file, a feature cache) the others read whole."""
    if ranks.current() is None:
        return fn()
    out = fn() if ranks.is_main() else None
    ranks.barrier()
    return out if ranks.is_main() else fn()


def train_diffusion(cfg, device=None, share_device: bool = False) -> dict:
    """PackPPI-MSC training from a composed config (``configs/train_diffusion.yaml``),
    on ``trainer.n_devices`` ranks (``share_device``: every rank on one card
    over gloo, for checks on a one-card machine)."""
    from packppi_torch.device import resolve_device

    device = resolve_device(device)
    n, mp = mesh_shape(cfg, device, share_device)
    return _on_ranks(_train_diffusion_anomaly, cfg, device, n, mp, share_device)


def _train_diffusion_anomaly(cfg, device, mesh):
    # trainer.debug_nans: autograd's anomaly mode for the length of the run
    with torch.autograd.set_detect_anomaly(bool(cfg.trainer.get("debug_nans"))):
        return _train_diffusion(cfg, device, mesh)


class _NullLogger:
    def log(self, *args, **kwargs):
        pass

    def close(self):
        pass


def _metric_logger(cfg, out):
    if not ranks.is_main():
        return _NullLogger()
    return MetricLogger(out / "logs", backends=cfg.get("logger") or ("tensorboard",))


def _train_diffusion(cfg, device, mesh=None) -> dict:
    from packppi_torch.data.complex import ComplexDataset, scan_complex_dir, split_entries
    from packppi_torch.data.loader import BucketedLoader
    from packppi_torch.models import SampleConfig, TorsionalDiffusion
    from packppi_torch.utils.config import network_config
    from packppi_torch.utils.metrics import chi_metrics

    # a configuration the device cannot run is refused before any data is read
    net_cfg = network_config(cfg.model)
    net_cfg.check_device(device)
    main = ranks.is_main()
    n_data = 1 if mesh is None else mesh.data
    out = Path(cfg.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    metrics_log = _metric_logger(cfg, out)
    if main:
        (out / "config.json").write_text(json.dumps(cfg.to_dict(), indent=1, default=str))

    # ---- data ---------------------------------------------------------------
    codes = scan_complex_dir(cfg.data.data_dir, cfg.data.pdb_suffix)
    if not codes:
        raise SystemExit(f"no PDBs matching *{cfg.data.pdb_suffix}.pdb in {cfg.data.data_dir}")
    cache = Path(cfg.data.data_dir) / cfg.data.cache_dir

    def datasets():
        splits = split_entries(codes, cfg.data.split_fractions, cfg.data.split_seed,
                               split_file=str(out / "split.json"))
        return {k: ComplexDataset(cfg.data.data_dir, v, cache_dir=str(cache),
                                  suffix=cfg.data.pdb_suffix,
                                  len_region=cfg.data.len_region).filtered()
                for k, v in splits.items()}

    ds = _main_first(datasets)
    # the global batch is batch_size rows a data shard; each rank reads its rows
    batch_size = cfg.data.batch_size * n_data
    rows = None if mesh is None else batch_rows(mesh, batch_size)
    loaders = {
        "train": BucketedLoader(ds["train"], batch_size, device, shuffle=True, seed=cfg.seed,
                                drop_last=True, rows=rows),
        # sharded batches stay divisible by the data axis
        "val": BucketedLoader(ds["val"], batch_size, device, shuffle=False, prefetch=0,
                              drop_last=mesh is not None, rows=rows),
    }
    log.info(f"data: {len(ds['train'])} train / {len(ds['val'])} val / "
             f"{len(ds['test'])} test complexes")
    steps_per_epoch = len(loaders["train"])
    if steps_per_epoch == 0 and loaders["val"].first_batch() is None:
        raise SystemExit("no full batch available; lower data.batch_size")

    # ---- model / optimizer --------------------------------------------------
    sample_cfg = SampleConfig(
        annealed_temp=cfg.sample.annealed_temp, mode=cfg.sample.mode,
        violation_tolerance_factor=cfg.sample.violation_tolerance_factor,
        clash_overlap_tolerance=cfg.sample.clash_overlap_tolerance,
        lamda=cfg.sample.lamda, num_steps=cfg.sample.num_steps)
    model = TorsionalDiffusion(net_cfg, sample_cfg)
    lr = make_lr(cfg.trainer, steps_per_epoch)
    state = init_state(model, cfg.seed, device, lambda p: make_optimizer(
        p, lr=float(cfg.trainer.lr), weight_decay=float(cfg.trainer.weight_decay)), mesh=mesh)
    accum = int(cfg.trainer.grad_accum_steps)
    train_step = make_train_step(model, state.optimizer, lr, accum)

    ckpt_mgr = CheckpointManager(out / "checkpoints", top_k=cfg.trainer.checkpoint_top_k,
                                 write=main)
    start_epoch = 0
    resume = cfg.get("ckpt_path") or ckpt_mgr.latest()
    if resume:
        log.info(f"resuming from {resume}")
        state.load_state_dict(load_params(resume, map_location=device))
        start_epoch = state.step // max(1, steps_per_epoch)
        # the loader's shuffle is seeded by the epoch: take it up where it stopped
        loaders["train"].epoch = start_epoch
    ema_decay, ema, ema_step = init_ema(cfg, state.params, resume)
    sharded = state.sharded
    if ema is not None and sharded is not None:
        ema = sharded.local(ema)            # the EMA of this rank's slices
    full_ema = (lambda: ema) if sharded is None or ema is None else (lambda: sharded.full(ema))

    def eval_loss(loader, stream, params):
        losses = []
        with torch.no_grad(), swapped_params(model.net, params):
            for i, batch in enumerate(loader):
                g = eval_generator(cfg.seed, stream, i, device)
                if mesh is None:
                    losses.append(model.loss(batch, g, deterministic=True))
                else:
                    losses.append(global_loss_terms(model, mesh, batch, g, True)[0])
        return losses

    def sample_rows(batch, generator):
        """The sampler on this rank's rows, then the global batch's chis."""
        if mesh is None:
            return batch, model.sample(batch, generator, n_steps=cfg.sample.n_diffusion_steps)
        from packppi_torch.models.torsional_diffusion import Rows

        B = batch.residue_mask.shape[0]
        sc = model.sample(batch, generator, n_steps=cfg.sample.n_diffusion_steps,
                          rows=Rows(mesh.data_index * B, B * mesh.data, mesh.data_group))
        return type(batch)(*(gather_rows(mesh, t) for t in batch)), gather_rows(mesh, sc)

    # ---- epochs -------------------------------------------------------------
    best_val = float("inf")
    stopper = EarlyStopper(cfg.trainer)
    epochs_run = 0
    log_every = cfg.trainer.log_every_steps
    for epoch in range(start_epoch, cfg.trainer.max_epochs):
        epochs_run = epoch + 1
        losses = []
        for batch in loaders["train"]:
            losses.append(train_step(state, batch))
            if ema is not None:
                ema_step(ema, state.masters)
            if len(losses) % log_every == 0:
                metrics_log.log(state.step, {"train/loss": _mean(losses[-log_every:])})
        train_loss = _mean(losses)

        val_loss = float("nan")
        if (epoch + 1) % cfg.trainer.val_every_epochs == 0 and len(ds["val"]):
            # with EMA on, validation, sampling and best-checkpoint selection
            # all evaluate the EMA weights (what inference will use)
            ema_now = full_ema()
            vlosses = eval_loss(loaders["val"], VAL_STREAM, ema_now)
            val_loss = _mean(vlosses)
            best_val = min(best_val, val_loss) if vlosses else best_val
            metrics_log.log(state.step, {"val/loss": val_loss, "train/loss_epoch": train_loss})

            if cfg.sample.sample_during_training and (epoch + 1) % cfg.sample.eval_epochs == 0:
                batch = loaders["val"].first_batch()
                if batch is not None:
                    # the same draw at every sampling evaluation: chi metrics
                    # are comparable from epoch to epoch
                    with swapped_params(model.net, ema_now):
                        batch, sc = sample_rows(
                            batch, eval_generator(cfg.seed, SAMPLE_STREAM, 0, device))
                    metrics_log.log(state.step,
                                    chi_metrics(batch.SC_D, sc, batch.SC_D_mask,
                                                batch.chi_1pi_periodic_mask), prefix="val/")

        log.info(f"epoch {epoch}: train {train_loss:.4f} val {val_loss:.4f}")
        # on the validation cadence and at the end; by cadence, not by
        # finiteness: an epoch with no validation batch must still save
        if (epoch + 1) % cfg.trainer.val_every_epochs == 0 or epoch == cfg.trainer.max_epochs - 1:
            # whole tensors (gathered on every rank); rank 0 writes them
            ckpt_mgr.save(state.step, state.state_dict(),
                          metric=val_loss if np.isfinite(val_loss) else None, ema=full_ema())
        if stopper.should_stop(epoch, val_loss):
            log.info(f"early stopping at epoch {epoch}: no val/loss improvement in "
                     f"{stopper.patience} validation check(s)")
            break

    # ---- the held-out test on the best checkpoint ---------------------------
    test_loss = float("nan")
    ranks.barrier()                         # rank 0's checkpoints are on disk
    if len(ds["test"]):
        best = ckpt_mgr.best()
        test_params = full_ema()
        if best:
            state.load_state_dict(load_params(best, map_location=device))
            if ema is not None and ema_path(best).exists():
                test_params = {k: v.to(device) for k, v in load_params(ema_path(best)).items()}
        test_loader = BucketedLoader(ds["test"], batch_size, device, shuffle=False, prefetch=0,
                                     drop_last=mesh is not None, rows=rows)
        test_loss = _mean(eval_loss(test_loader, TEST_STREAM, test_params))
        metrics_log.log(state.step, {"test/loss": test_loss})
        log.info(f"test loss (best ckpt): {test_loss:.4f}")

    metrics_log.close()
    return {"best_val_loss": best_val, "test_loss": test_loss, "epochs_run": epochs_run,
            "best_ckpt": ckpt_mgr.best(), "last_ckpt": ckpt_mgr.latest()}


def _optimizer(net: torch.nn.Module, lr: float, weight_decay: float, mesh=None):
    """AdamW over ``net``'s parameters, each with a zero gradient from the
    start: a parameter the loss does not reach still takes every step, as
    under optax, where its gradient is zeros. Under a ``mesh`` the optimizer
    works on the ``ShardedParams`` layout, which ``optimizer.sharded``
    holds (None on one device)."""
    for p in net.parameters():
        p.grad = torch.zeros_like(p)
    sharded = None if mesh is None else ShardedParams(mesh, net)
    params = net.parameters() if sharded is None else sharded.parameters()
    optimizer = make_optimizer(params, lr=lr, weight_decay=weight_decay)
    optimizer.sharded = sharded
    return optimizer


def affinity_optimizer(model, lr: float, weight_decay: float, mesh=None):
    """AdamW over the affinity network (the backbone stays frozen)."""
    for p in model.backbone.parameters():
        p.requires_grad_(False)
    return _optimizer(model.net, lr, weight_decay, mesh)


def make_affinity_train_step(model, optimizer, lr, mesh=None, backbone=contextlib.nullcontext):
    """``train_step(batch, opt_steps) -> loss``: the loss with dropout, its
    backward and one AdamW step at the schedule's rate ``lr`` (a float or a
    callable of ``opt_steps``). A non-finite loss zeroes the gradients and
    the step is still taken, as in the JAX package; the choice is made on
    the device, with no read-back. Under a ``mesh`` the batch is this rank's
    rows: the loss is the global batch's mean (the rows' means summed over
    ``data``, each over ``data``) and the choice is made on it. ``backbone``:
    the context the frozen backbone runs in (its FSDP gather)."""
    params = list(model.net.parameters())
    n_data = 1 if mesh is None else mesh.data

    def train_step(batch, opt_steps: int) -> torch.Tensor:
        with backbone():
            local = model.loss(batch, deterministic=False) / n_data
        loss = local if mesh is None else reduce_sum(mesh, local)
        local.backward()
        ok = torch.isfinite(loss)
        with torch.no_grad():
            for p in params:
                p.grad.copy_(torch.where(ok, p.grad, torch.zeros_like(p.grad)))
        _adamw_step(optimizer, lr, opt_steps)
        return loss.detach()

    return train_step


def _adamw_step(optimizer, lr, opt_steps: int) -> None:
    """One AdamW update at the schedule's learning rate for ``opt_steps``
    (under a mesh the gradients reduced first and the whole tensors
    gathered after)."""
    sharded = getattr(optimizer, "sharded", None)
    if sharded is not None:
        sharded.reduce_grads()
    if callable(lr):
        for group in optimizer.param_groups:
            group["lr"] = lr(opt_steps)
    optimizer.step()
    optimizer.zero_grad(set_to_none=False)
    if sharded is not None:
        with torch.no_grad():
            for p in sharded.params.values():
                p.grad.zero_()
        sharded.gather()


def _backbone_context(model, mesh):
    """The frozen backbone under FSDP when ``mesh.model`` > 1: only its
    slices stay resident, gathered whole for each use."""
    if mesh is None or mesh.model == 1:
        return contextlib.nullcontext
    sharded = ShardedParams(mesh, model.backbone.net)
    sharded.release()
    return sharded.gathered


def _weighted_loss(pred, pred_inv, ddg, w, mesh):
    """The antisymmetric MSE of a batch whose rows carry weights ``w``
    (zero on padding rows), over every rank's rows of ``mesh.data``."""
    num = 0.5 * (torch.sum(w * (pred - ddg) ** 2) + torch.sum(w * (pred_inv + ddg) ** 2))
    den = w.sum()
    if mesh is not None:
        num, den = reduce_sum(mesh, num), reduce_sum(mesh, den)
    return num / torch.clamp(den, min=1e-9)


def _pad_rows(tensors, mesh):
    """A ragged evaluation batch padded to a multiple of ``mesh.data`` with
    repeats of its last row, and weights (1, then 0 on the padding); then
    this rank's rows of each."""
    n = tensors[0].shape[0]
    pad = -n % (1 if mesh is None else mesh.data)
    w = torch.cat([torch.ones(n), torch.zeros(pad)]).to(tensors[0].device)
    out = [torch.cat([t, t[-1:].expand(pad, *t.shape[1:])], 0) if pad else t for t in tensors]
    if mesh is not None:
        rows = batch_rows(mesh, n + pad)
        out, w = [t[rows] for t in out], w[rows]
    return out, w


def esm_batches(entries, batch_size: int, shuffle: bool, seed: int, load_item, device):
    """Padded (wt, mut, ddg) batches over SKEMPI entries for esm mode, on
    ``device``. Training (``shuffle``) drops the ragged tail, so every step
    sees a full batch; evaluation keeps it. ``load_item`` gives None for an
    entry whose mutations do not apply. The width is the embeddings'."""
    from packppi_torch.data.esm import ESM_DIM

    idx = np.arange(len(entries))
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
        stops = range(0, len(idx) - batch_size + 1, batch_size)
    else:
        stops = range(0, len(idx), batch_size)
    for s in stops:
        items = [it for it in (load_item(entries[i]) for i in idx[s:s + batch_size])
                 if it is not None]
        if not items:
            continue
        L = max(w.shape[0] for w, _, _ in items)
        dim = items[0][0].shape[-1] if items[0][0].ndim == 2 else ESM_DIM
        wt = np.zeros((len(items), L, dim), np.float32)
        mt = np.zeros_like(wt)
        ddg = np.zeros(len(items), np.float32)
        for k, (w, m, d) in enumerate(items):
            wt[k, :len(w)], mt[k, :len(m)], ddg[k] = w, m, d
        yield tuple(torch.from_numpy(a).to(device) for a in (wt, mt, ddg))


def _train_affinity_esm(cfg, splits, cache_dir: Path, out: Path, metrics_log, device,
                        mesh=None) -> dict:
    """esm mode: the ddG head over ESM-2 embeddings, cached per mutation as
    ``<cache_dir>/esm_<pdb>_<id>.npz`` (``wt``, ``mut``) or extracted with
    the ESM-2 weights of ``esm_weights`` (a ``.pt`` as ``cli.ddg
    --esm_ckpt`` takes it; wild type and mutant in one forward). Only the
    head is built: its network configuration is the default one, as in the
    JAX package."""
    from packppi_torch.data.esm import load_esm_model
    from packppi_torch.data.skempi import esm_item, stack_esm_batch
    from packppi_torch.models import NetworkConfig
    from packppi_torch.models.affinity import AffinityNet
    from packppi_torch.models.esm2 import embed_rows
    from packppi_torch.structure import from_pdb_file
    from packppi_torch.structure.featurize import residue_mask_of
    from packppi_torch.weights import init_weights

    esm = load_esm_model(cfg.get("esm_weights"), device)

    def load_item(e):
        cache = cache_dir / f"esm_{e['pdb_id']}_{e['id']}.npz"
        if cache.exists():
            with np.load(cache) as z:
                return z["wt"], z["mut"], np.float32(e["ddG"])
        if esm is None:
            raise SystemExit(
                "ESM mode needs either cached embeddings under "
                f"{cache_dir} (esm_<pdb>_<id>.npz with wt/mut arrays) or ESM-2 weights "
                "(esm_weights=<file.pt>, as tools/convert_hf_esm_to_torch.py writes them)")
        prot = from_pdb_file(e["pdb_path"], mse_to_met=True)
        try:
            # strict: a mutation that does not apply would train wt == mut
            # embeddings against a nonzero ddG, and cache the pair
            batch = stack_esm_batch([esm_item(prot, e["mutations"], strict=True)], device)
        except ValueError as err:
            log.warning(f"skipping {e['pdb_id']}/{e['id']}: {err}")
            return None
        rm = residue_mask_of(prot.atom_positions.astype(np.float32))[:, None]
        with torch.inference_mode():
            rows = embed_rows(esm, batch.input_ids, batch.attention_mask, batch.rows)
        wt, mut = (r[0].cpu().numpy() * rm for r in rows)
        np.savez_compressed(cache, wt=wt, mut=mut)
        return wt, mut, np.float32(e["ddG"])

    make_batches = functools.partial(esm_batches, load_item=load_item, device=device)
    n_data = 1 if mesh is None else mesh.data
    batch_size = int(cfg.data.batch_size) * n_data
    if len(splits["train"]) < batch_size:
        raise SystemExit(
            f"train split ({len(splits['train'])} mutations) yields no full "
            f"batches at global batch {batch_size} — lower data.batch_size")
    strict_parity = bool(cfg.model.get("strict_parity", True))
    wt0, _, _ = next(make_batches(splits["train"], 1, False, 0))
    net = AffinityNet(NetworkConfig(), "esm", strict_parity, esm_dim=wt0.shape[-1])
    init_weights(net, cfg.seed)
    resume = cfg.get("ckpt_path")
    if resume:
        log.info(f"resuming params from {resume}")
        net.load_state_dict(load_params(resume), strict=True)
    net.to(device).eval()
    # real rows: embeddings are zeroed at padding, so a nonzero row is a residue
    pool_mask = (lambda wt: None) if strict_parity else (lambda wt: (wt.abs().sum(-1) > 0).float())

    def loss_of(wt, mt, ddg):
        pred, pred_inv = net(None, None, wt, mt, None, pool_mask(wt))
        return 0.5 * (torch.mean((pred - ddg) ** 2) + torch.mean((pred_inv + ddg) ** 2))

    def eval_loss(wt, mt, ddg):
        if mesh is None:
            return loss_of(wt, mt, ddg)
        (wt, mt, ddg), w = _pad_rows((wt, mt, ddg), mesh)
        return _weighted_loss(*net(None, None, wt, mt, None, pool_mask(wt)), ddg, w, mesh)

    optimizer = _optimizer(net, float(cfg.trainer.lr), float(cfg.trainer.weight_decay), mesh)
    sharded = optimizer.sharded
    _, ema, ema_step = init_ema(cfg, net.state_dict(), resume)
    masters = net.state_dict if sharded is None else (
        lambda: {k: v.detach() for k, v in sharded.masters.items()})
    if ema is not None and sharded is not None:
        ema = sharded.local(ema)
    full = (lambda d: d) if sharded is None else (lambda d: None if d is None else sharded.full(d))
    rows = None if mesh is None else batch_rows(mesh, batch_size)

    ckpt_mgr = CheckpointManager(out / "checkpoints", top_k=cfg.trainer.checkpoint_top_k,
                                 write=ranks.is_main())
    best_val, step = float("inf"), 0
    stopper = EarlyStopper(cfg.trainer)
    for epoch in range(cfg.trainer.max_epochs):
        losses = []
        for wt, mt, ddg in make_batches(splits["train"], batch_size, True, cfg.seed + epoch):
            if rows is not None:
                wt, mt, ddg = wt[rows], mt[rows], ddg[rows]
            local = loss_of(wt, mt, ddg) / n_data
            loss = local if mesh is None else reduce_sum(mesh, local)
            local.backward()
            _adamw_step(optimizer, None, step)
            if ema is not None:
                ema_step(ema, masters())
            losses.append(loss.detach())
            step += 1
        with torch.no_grad(), swapped_params(net, full(ema)):
            vlosses = [eval_loss(wt, mt, ddg)
                       for wt, mt, ddg in make_batches(splits["valid"], batch_size, False, 0)]
        train_loss, val_loss = _mean(losses), _mean(vlosses)
        best_val = min(best_val, val_loss)
        metrics_log.log(step, {"train/loss": train_loss, "val/loss": val_loss})
        log.info(f"epoch {epoch}: train {train_loss:.4f} val {val_loss:.4f}")
        ckpt_mgr.save(step, net.state_dict(),
                      metric=val_loss if np.isfinite(val_loss) else None, ema=full(ema))
        if stopper.should_stop(epoch, val_loss):
            log.info(f"early stopping at epoch {epoch}")
            break
    metrics_log.close()
    ranks.barrier()
    return {"best_val_loss": best_val, "best_ckpt": ckpt_mgr.best(),
            "last_ckpt": ckpt_mgr.latest()}


def train_affinity(cfg, device=None, share_device: bool = False) -> dict:
    """PackPPI-AP training from a composed config (``configs/train_affinity.yaml``),
    on ``trainer.n_devices`` ranks (``share_device`` as ``train_diffusion``).
    Dropout draws come from torch's global generator, seeded with
    ``cfg.seed`` inside the run and restored after it."""
    from packppi_torch.device import resolve_device
    from packppi_torch.utils.config import network_config

    device = resolve_device(device)
    # esm mode builds the head alone; otherwise a configuration the device
    # cannot run is refused before any data is read
    if cfg.model.mode != "esm":
        network_config(cfg.model).check_device(device)
    n, mp = mesh_shape(cfg, device, share_device)
    if cfg.model.mode == "esm" and n > 1:
        # never scale the global batch past what the split can fill
        from packppi_torch.data import skempi

        entries = skempi.load_skempi_entries(cfg.data.data_dir, cfg.data.pdb_dirname,
                                             cfg.data.meta_filename, list(cfg.data.block_list))
        train = skempi.cv_split(entries, cfg.data.num_cvfolds, cfg.data.cvfold_index,
                                cfg.data.split_seed)["train"]
        dp = max(1, min(n // mp, len(train) // max(1, int(cfg.data.batch_size))))
        n = dp * mp
    return _on_ranks(_train_affinity_seeded, cfg, device, n, mp, share_device)


def _train_affinity_seeded(cfg, device, mesh):
    from packppi_torch.utils.config import network_config

    net_cfg = None if cfg.model.mode == "esm" else network_config(cfg.model)
    devices = [device] if device.type == "cuda" else []
    with torch.random.fork_rng(devices=devices), \
            torch.autograd.set_detect_anomaly(bool(cfg.trainer.get("debug_nans"))):
        torch.manual_seed(int(cfg.seed))
        return _train_affinity(cfg, net_cfg, device, mesh)


class _SkempiDataset:
    """The featurized wild-type/mutant pair of each entry, cached as
    ``<cache_dir>/<pdb>_<id>.npz`` (the JAX package's file name and
    arrays, so either package reads what the other wrote)."""

    def __init__(self, entries, cache_dir: Path):
        self.entries, self.cache_dir = entries, cache_dir

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        from packppi_torch.data.skempi import skempi_features
        from packppi_torch.structure import from_pdb_file

        e = self.entries[i]
        cache = self.cache_dir / f"{e['pdb_id']}_{e['id']}.npz"
        if cache.exists():
            with np.load(cache) as z:
                return dict(z)
        feats = skempi_features(from_pdb_file(e["pdb_path"], mse_to_met=True),
                                e["mutations"], ddg=e["ddG"])
        np.savez_compressed(cache, **feats)
        return feats


def _train_affinity(cfg, net_cfg, device, mesh=None) -> dict:
    from packppi_torch.data import skempi
    from packppi_torch.data.loader import BucketedLoader
    from packppi_torch.models.affinity import AffinityModel
    from packppi_torch.utils.metrics import spearman
    from packppi_torch.weights import init_weights, load_weights

    main = ranks.is_main()
    out = Path(cfg.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    metrics_log = _metric_logger(cfg, out)

    entries = skempi.load_skempi_entries(cfg.data.data_dir, cfg.data.pdb_dirname,
                                         cfg.data.meta_filename, list(cfg.data.block_list))
    if not entries:
        raise SystemExit(f"no usable SKEMPI entries under {cfg.data.data_dir}")
    splits = skempi.cv_split(entries, cfg.data.num_cvfolds, cfg.data.cvfold_index,
                             cfg.data.split_seed)
    log.info(f"skempi: {len(splits['train'])} train / {len(splits['valid'])} val mutations")
    cache_dir = Path(cfg.data.data_dir) / cfg.data.cache_dir
    cache_dir.mkdir(parents=True, exist_ok=True)
    if net_cfg is None:
        return _train_affinity_esm(cfg, splits, cache_dir, out, metrics_log, device, mesh)

    n_data = 1 if mesh is None else mesh.data
    batch_size = int(cfg.data.batch_size) * n_data
    rows = None if mesh is None else batch_rows(mesh, batch_size)
    ds = {k: _SkempiDataset(splits[k], cache_dir) for k in ("train", "valid")}
    # rank 0 writes the feature cache; the other ranks read it whole
    _main_first(lambda: [d[i] for d in ds.values() for i in range(len(d))])
    stack = functools.partial(skempi.stack_affinity_batch, device=device)
    loaders = {
        "train": BucketedLoader(ds["train"], batch_size, shuffle=True, seed=cfg.seed,
                                drop_last=True, stack_fn=stack, rows=rows),
        # an empty validation fold gives no batch: val/loss is NaN and
        # checkpoints are saved without a metric, as in the JAX package
        "val": BucketedLoader(ds["valid"], batch_size, shuffle=False, prefetch=0,
                              drop_last=mesh is not None, stack_fn=stack, rows=rows),
    }
    steps_per_epoch = len(loaders["train"])
    if steps_per_epoch == 0:
        raise SystemExit(
            f"train split ({len(splits['train'])} mutations) yields no full batches at "
            f"global batch {batch_size} (data.batch_size x {n_data} devices) — lower "
            "data.batch_size or trainer.n_devices")

    model = AffinityModel(net_cfg, cfg.model.mode, bool(cfg.model.get("strict_parity", True)))
    if cfg.get("pre_checkpoint_path"):
        load_weights(model.backbone.net, cfg.pre_checkpoint_path)
    else:
        log.warning("no pre_checkpoint_path: affinity training on a random backbone")
        init_weights(model.backbone.net, cfg.seed + 1)
    # the frozen backbone is part of the model: with it beside the affinity
    # checkpoints, `cli.ddg --pre_ckpt <out>/backbone.pt` reproduces the run
    if main:
        save_params(out / "backbone.pt", model.backbone.net.state_dict())
    init_weights(model.net, cfg.seed)
    resume = cfg.get("ckpt_path")
    if resume:
        # params-level resume, as the reference's ckpt_path; no automatic
        # resume from the run's own latest checkpoint
        log.info(f"resuming params from {resume}")
        load_weights(model.net, resume)
    model.to(device)

    lr = make_lr(cfg.trainer, steps_per_epoch)
    optimizer = affinity_optimizer(model, float(cfg.trainer.lr),
                                   float(cfg.trainer.weight_decay), mesh)
    sharded = optimizer.sharded
    backbone = _backbone_context(model, mesh)
    _, ema, ema_step = init_ema(cfg, model.net.state_dict(), resume)
    masters = model.net.state_dict if sharded is None else (
        lambda: {k: v.detach() for k, v in sharded.masters.items()})
    if ema is not None and sharded is not None:
        ema = sharded.local(ema)
    full = (lambda d: d) if sharded is None else (lambda d: None if d is None else sharded.full(d))
    train_step = make_affinity_train_step(model, optimizer, lr, mesh, backbone)

    ckpt_mgr = CheckpointManager(out / "checkpoints", top_k=cfg.trainer.checkpoint_top_k,
                                 write=main)
    best_val, step = float("inf"), 0
    stopper = EarlyStopper(cfg.trainer)
    for epoch in range(cfg.trainer.max_epochs):
        losses = []
        for batch in loaders["train"]:
            losses.append(train_step(batch, step))
            if ema is not None:
                ema_step(ema, masters())
            step += 1
        train_loss = _mean(losses)

        # with EMA on, validation, the records and checkpoint selection use
        # the EMA weights (what inference will use); the loss and the
        # predictions come from one forward without dropout
        vlosses, preds, labels = [], [], []
        with torch.no_grad(), swapped_params(model.net, full(ema)):
            for batch in loaders["val"]:
                with backbone():
                    ddg, ddg_inv = model.predict(batch)
                y = batch.ddg
                local = 0.5 * (torch.mean((ddg - y) ** 2) + torch.mean((ddg_inv + y) ** 2))
                vlosses.append(local if mesh is None else reduce_sum(mesh, local / n_data))
                if mesh is not None:
                    ddg, y = gather_rows(mesh, ddg), gather_rows(mesh, y)
                preds.append(ddg.cpu().numpy())
                labels.append(y.cpu().numpy())
        val_loss = _mean(vlosses)
        best_val = min(best_val, val_loss)
        extras = {}
        if preds:
            p, y = np.concatenate(preds), np.concatenate(labels)
            if len(p) > 2 and p.std() > 0 and y.std() > 0:
                extras["val/pearson"] = float(np.corrcoef(p, y)[0, 1])
                extras["val/spearman"] = spearman(p, y)
            extras["val/rmse"] = float(np.sqrt(np.mean((p - y) ** 2)))
        metrics_log.log(step, {"train/loss": train_loss, "val/loss": val_loss, **extras})
        log.info(f"epoch {epoch}: train {train_loss:.4f} val {val_loss:.4f} {extras}")
        ckpt_mgr.save(step, model.net.state_dict(),
                      metric=val_loss if np.isfinite(val_loss) else None, ema=full(ema))
        if stopper.should_stop(epoch, val_loss):
            log.info(f"early stopping at epoch {epoch}")
            break

    ranks.barrier()
    metrics_log.close()
    return {"best_val_loss": best_val, "best_ckpt": ckpt_mgr.best(),
            "last_ckpt": ckpt_mgr.latest(), "backbone": str(out / "backbone.pt")}
