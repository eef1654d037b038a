"""Diffusion training step.

``make_train_step(model, optimizer)`` returns ``train_step(state, batch) ->
loss``: one loss evaluation in ``train()`` mode, its backward, and one AdamW
update. A loss that is not finite skips the update: parameters and
optimizer state stay exactly as they were (the check reads the loss back,
one host synchronisation per step). The train state carries the random
generator's state, so a resumed run draws what the uninterrupted run would
have drawn.

Under a mesh (``init_state(..., mesh=...)``) each rank holds its rows of the
global batch and the parameters as ``parallel.ShardedParams`` lays them out
(FSDP slices over ``model``, the optimizer over the slices). Every rank
draws the global batch's time and noise and keeps its rows; the loss is the
global sum of the numerators over the global chi count, the non-finite skip
is decided once from that global loss, and the gradients are reduced before
the AdamW step. The numbers are one device's up to float32 summation order.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from packppi_torch.data.batch import ProteinBatch
from packppi_torch.models.torsional_diffusion import TorsionalDiffusion
from packppi_torch.parallel.mesh import Mesh, ShardedParams, batch_rows, reduce_sum
from packppi_torch.weights import init_weights


@dataclasses.dataclass
class TrainState:
    """Parameters (in ``model.net``), optimizer state, micro-step count,
    optimizer-step count and the generator every draw of training comes
    from."""

    model: TorsionalDiffusion
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    step: int = 0        # loss evaluations (micro-batches)
    opt_steps: int = 0   # optimizer updates (= step under grad_accum_steps=1, skips aside)
    micro: int = 0       # micro-batches accumulated towards the next update
    sharded: Optional[ShardedParams] = None   # the layout under a mesh

    @property
    def params(self) -> dict:
        return self.model.net.state_dict()

    @property
    def masters(self) -> dict:
        """What the optimizer updates, a name each: the parameters, or under
        a mesh this rank's slices of the sharded ones (the EMA's layout)."""
        if self.sharded is None:
            return self.params
        return {k: v.detach() for k, v in self.sharded.masters.items()}

    def state_dict(self) -> dict:
        """The train state as one device holds it; under a mesh the optimizer
        state is gathered from the slices (every rank must call it)."""
        opt = (self.optimizer.state_dict() if self.sharded is None
               else self.sharded.full_optimizer_state(self.optimizer))
        return {"params": {k: v.detach().clone() for k, v in self.params.items()},
                "opt_state": opt,
                "step": int(self.step), "opt_steps": int(self.opt_steps),
                "generator": self.generator.get_state()}

    def load_state_dict(self, blob: dict) -> None:
        """A train state of any rank count (always written whole)."""
        if self.sharded is None:
            self.model.net.load_state_dict(blob["params"], strict=True)
            self.optimizer.load_state_dict(blob["opt_state"])
        else:
            self.sharded.load_full(blob["params"])
            self.sharded.load_optimizer_state(self.optimizer, blob["opt_state"])
            self.sharded.zero_grad()
        self.step, self.opt_steps, self.micro = int(blob["step"]), int(blob["opt_steps"]), 0
        self.generator.set_state(blob["generator"].cpu())
        self.optimizer.zero_grad(set_to_none=True)


def make_optimizer(params, lr: float = 1e-4, weight_decay: float = 1e-12) -> torch.optim.AdamW:
    """AdamW with betas (0.9, 0.999) and eps 1e-8; parameters, gradients and
    both moments are float32."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def init_state(model: TorsionalDiffusion, seed: int, device,
               optimizer_fn: Callable = make_optimizer,
               mesh: Optional[Mesh] = None) -> TrainState:
    """Random weights from ``seed``, the model on ``device``, a fresh
    optimizer and a generator seeded from ``seed`` (the same on every rank
    of a ``mesh``, whose layout the parameters and optimizer then take)."""
    init_weights(model.net, seed)
    model.to(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    if mesh is None:
        return TrainState(model, optimizer_fn(model.net.parameters()), generator)
    sharded = ShardedParams(mesh, model.net)
    return TrainState(model, optimizer_fn(sharded.parameters()), generator, sharded=sharded)


def make_train_step(model: TorsionalDiffusion, optimizer: torch.optim.Optimizer,
                    lr: Union[float, Callable[[int], float], None] = None,
                    grad_accum_steps: int = 1):
    """``lr``: None keeps the optimizer's, a float sets it, a callable is a
    schedule over optimizer steps. ``grad_accum_steps`` micro-batches are
    averaged into one update."""
    accum = max(1, int(grad_accum_steps))

    def train_step(state: TrainState, batch: ProteinBatch, **loss_overrides) -> torch.Tensor:
        """``loss_overrides`` (``t``, ``noise_pi``, ``noise_2pi``) replace the
        draws; under a mesh they are the global batch's."""
        if state.sharded is None:
            loss = local = model.loss(batch, state.generator, **loss_overrides)
        else:
            loss, local = _global_loss(model, state, batch, loss_overrides)
        state.step += 1
        if not bool(torch.isfinite(loss)):
            # skip the whole micro-batch: no gradient of it is kept, and
            # parameters and optimizer state stay bit for bit as they were
            return loss.detach()
        (local / accum).backward()
        state.micro += 1
        if state.micro == accum:
            if lr is not None:
                value = lr(state.opt_steps) if callable(lr) else lr
                for group in optimizer.param_groups:
                    group["lr"] = value
            if state.sharded is not None:
                state.sharded.reduce_grads()
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
            if state.sharded is not None:
                state.sharded.zero_grad()
                state.sharded.gather()
            state.micro = 0
            state.opt_steps += 1
        return loss.detach()

    return train_step


def global_loss_terms(model: TorsionalDiffusion, mesh: Mesh, batch: ProteinBatch,
                      generator: Optional[torch.Generator], deterministic: bool = False,
                      overrides: Optional[dict] = None):
    """``(loss, local)`` of this rank's rows of a global batch split over
    ``mesh.data``: the global loss (equal on every rank) and this rank's
    share of it (its numerator over the global chi count), whose gradients
    summed over the ranks are the global loss's. The draws are the global
    batch's (``overrides``, else drawn from ``generator``), sliced."""
    B, L = batch.residue_mask.shape
    B_global = B * mesh.data
    rows = batch_rows(mesh, B_global)
    draws = overrides or dict(zip(("t", "noise_pi", "noise_2pi"), model.train_draws(
        B_global, L, generator, batch.SC_D.device)))
    draws = {k: v[rows] for k, v in draws.items()}
    num, count = model.loss_terms(batch, generator, deterministic, **draws)
    local = num / torch.clamp(reduce_sum(mesh, count), min=1.0)
    return reduce_sum(mesh, local), local


def _global_loss(model, state, batch, overrides):
    return global_loss_terms(model, state.sharded.mesh, batch, state.generator,
                             overrides=overrides)


def make_ema_update(decay: float):
    """``ema_update(ema, params)``: the exponential moving average of the
    parameters, updated in place in ``ema`` (a name -> tensor dict kept
    outside the train state and saved as a ``_ema`` sidecar)."""

    @torch.no_grad()
    def ema_update(ema: dict, params: dict) -> dict:
        for k, e in ema.items():
            e.mul_(decay).add_(params[k].detach().to(e.dtype), alpha=1.0 - decay)
        return ema

    return ema_update
