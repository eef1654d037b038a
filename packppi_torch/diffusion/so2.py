"""SO(2) variance-exploding schedule for torsional diffusion (ODE sampling).

``sigma(t) = sigma_min^(1-t) sigma_max^t`` with the annealed-temperature
probability-flow ODE step (temperature 3, the reference's sampling config). ODE sampling never reads the wrapped-Gaussian
score tables (the sampler discards the score of its initial noise), so
this module has no tables; training needs them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

ANNEALED_TEMP = 3.0


@dataclasses.dataclass(frozen=True)
class SO2Schedule:
    sigma_min: float = 0.01 * math.pi
    sigma_max: float = math.pi

    def t_to_sigma(self, t):
        lo, hi = math.log(self.sigma_min), math.log(self.sigma_max)
        if isinstance(t, torch.Tensor):
            return torch.exp(lo + (hi - lo) * t)
        return math.exp(lo + (hi - lo) * t)

    def add_noise(self, x: torch.Tensor, t: torch.Tensor, generator: torch.Generator,
                  x_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Perturb angles by sigma(t)-scaled Gaussian noise (masked)."""
        sigma = self.t_to_sigma(t)[..., None]
        noise = torch.randn(x.shape, generator=generator, device=x.device,
                            dtype=x.dtype) * sigma
        if x_mask is not None:
            noise = noise * x_mask
        return x + noise

    def step(self, x: torch.Tensor, x_score: torch.Tensor, t: float, dt: float,
             x_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One reverse-time probability-flow ODE step at scalar time ``t``."""
        sigma = self.t_to_sigma(t)
        g = sigma * math.sqrt(2 * math.log(self.sigma_max / self.sigma_min))
        alpha = 1 - (sigma / self.sigma_max) ** 2
        weight = ANNEALED_TEMP / (alpha + (1 - alpha) * ANNEALED_TEMP)
        x_next = x + (0.5 * g ** 2 * dt) * (x_score * weight)
        if x_mask is not None:
            x_next = torch.where(x_mask, x_next, x)
        return x_next
