"""Diffusion training step.

``make_train_step(model, optimizer)`` returns ``train_step(state, batch) ->
loss``: one loss evaluation in ``train()`` mode, its backward, and one AdamW
update. A loss that is not finite skips the update: parameters and
optimizer state stay exactly as they were (the check reads the loss back,
one host synchronisation per step). The train state carries the random
generator's state, so a resumed run draws what the uninterrupted run would
have drawn.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Union

import torch

from packppi_torch.data.batch import ProteinBatch
from packppi_torch.models.torsional_diffusion import TorsionalDiffusion
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

    @property
    def params(self) -> dict:
        return self.model.net.state_dict()

    def state_dict(self) -> dict:
        return {"params": {k: v.detach().clone() for k, v in self.params.items()},
                "opt_state": self.optimizer.state_dict(),
                "step": int(self.step), "opt_steps": int(self.opt_steps),
                "generator": self.generator.get_state()}

    def load_state_dict(self, blob: dict) -> None:
        self.model.net.load_state_dict(blob["params"], strict=True)
        self.optimizer.load_state_dict(blob["opt_state"])
        self.step, self.opt_steps, self.micro = int(blob["step"]), int(blob["opt_steps"]), 0
        self.generator.set_state(blob["generator"].cpu())
        self.optimizer.zero_grad(set_to_none=True)


def make_optimizer(params, lr: float = 1e-4, weight_decay: float = 1e-12) -> torch.optim.AdamW:
    """AdamW with betas (0.9, 0.999) and eps 1e-8; parameters, gradients and
    both moments are float32."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def init_state(model: TorsionalDiffusion, seed: int, device,
               optimizer_fn: Callable = make_optimizer) -> TrainState:
    """Random weights from ``seed``, the model on ``device``, a fresh
    optimizer and a generator seeded from ``seed``."""
    init_weights(model.net, seed)
    model.to(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    return TrainState(model, optimizer_fn(model.net.parameters()), generator)


def make_train_step(model: TorsionalDiffusion, optimizer: torch.optim.Optimizer,
                    lr: Union[float, Callable[[int], float], None] = None,
                    grad_accum_steps: int = 1):
    """``lr``: None keeps the optimizer's, a float sets it, a callable is a
    schedule over optimizer steps. ``grad_accum_steps`` micro-batches are
    averaged into one update."""
    accum = max(1, int(grad_accum_steps))

    def train_step(state: TrainState, batch: ProteinBatch, **loss_overrides) -> torch.Tensor:
        loss = model.loss(batch, state.generator, **loss_overrides)
        state.step += 1
        if not bool(torch.isfinite(loss)):
            # skip the whole micro-batch: no gradient of it is kept, and
            # parameters and optimizer state stay bit for bit as they were
            return loss.detach()
        (loss / accum).backward()
        state.micro += 1
        if state.micro == accum:
            if lr is not None:
                value = lr(state.opt_steps) if callable(lr) else lr
                for group in optimizer.param_groups:
                    group["lr"] = value
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
            state.micro = 0
            state.opt_steps += 1
        return loss.detach()

    return train_step


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
