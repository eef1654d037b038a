"""PackPPI-MSC sampling: the score network under the SO(2) ODE schedule.

``TorsionalDiffusion.sample`` encodes the static graph once and runs the
``n_steps`` denoising iterations as a Python loop (each one network
evaluation with the last layer's edge pass skipped).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from packppi_torch.data.batch import ProteinBatch
from packppi_torch.diffusion.so2 import SO2Schedule
from packppi_torch.geometry.dihedrals import wrap_angle
from packppi_torch.models.diffusion_net import ChiScoreNetwork, NetworkConfig


@dataclasses.dataclass(frozen=True)
class SampleConfig:
    """Settings of the proximal refinement that follows sampling."""

    violation_tolerance_factor: float = 12.0
    clash_overlap_tolerance: float = 0.5
    lamda: float = 1.0
    num_steps: int = 50  # proximal refinement steps


class TorsionalDiffusion(nn.Module):
    def __init__(self, cfg: NetworkConfig = NetworkConfig(),
                 sample_cfg: SampleConfig = SampleConfig()):
        super().__init__()
        self.sample_cfg = sample_cfg
        self.net = ChiScoreNetwork(cfg).eval()
        # both chi periodicities share one sigma(t) and ODE step; the score
        # tables that tell them apart are not read by ODE sampling
        self.schedule = SO2Schedule()

    def init_noise(self, batch: ProteinBatch, generator: torch.Generator) -> torch.Tensor:
        """The t=1 starting chis: true chis plus sigma_max noise on every
        present chi, wrapped to [-pi, pi)."""
        t = torch.ones(batch.residue_mask.shape, device=batch.SC_D.device)
        sc = self.schedule.add_noise(batch.SC_D, t, generator, batch.chi_1pi_periodic_mask)
        sc = self.schedule.add_noise(sc, t, generator, batch.chi_2pi_periodic_mask)
        return wrap_angle(sc)

    @torch.no_grad()
    def sample(self, batch: ProteinBatch, generator: Optional[torch.Generator] = None,
               n_steps: int = 30, corrector_steps: int = 0,
               init_sc: Optional[torch.Tensor] = None, return_trajectory: bool = False):
        """Reverse diffusion from t=1 to 0. Returns SC_D [B, L, 4], and with
        ``return_trajectory`` also the [n_steps, B, L, 4] network inputs.

        ``init_sc`` replaces the t=1 noise (ODE sampling's only randomness),
        for replaying a recorded trajectory.
        """
        if corrector_steps:
            raise ValueError("corrector_steps is not implemented in packppi_torch")
        if init_sc is None:
            if generator is None:
                raise ValueError("sample needs a generator or init_sc")
            sc = self.init_noise(batch, generator)
        else:
            sc = torch.as_tensor(init_sc, dtype=torch.float32, device=batch.SC_D.device)

        ts = np.linspace(1.0, 0.0, n_steps + 1)
        times = ts[:-1].astype(np.float32)
        dts = (ts[:-1] - ts[1:]).astype(np.float32)
        m1, m2 = batch.chi_1pi_periodic_mask, batch.chi_2pi_periodic_mask

        static = self.net.encode_static(batch)
        traj = []
        for time, dt in zip(times, dts):
            t = torch.full(batch.residue_mask.shape, float(time), device=sc.device)
            score, _ = self.net(batch, sc, t, static=static, skip_last_edge_update=True)
            traj.append(sc)
            sc_next = self.schedule.step(sc, score, float(time), float(dt), m1)
            sc_next = self.schedule.step(sc_next, score, float(time), float(dt), m2)
            sc = wrap_angle(sc_next) * batch.SC_D_mask
        if return_trajectory:
            return sc, torch.stack(traj)
        return sc
