"""PackPPI-MSC: the score network under the two SO(2) schedules (pi- and
2pi-periodic chis), for training and sampling.

``TorsionalDiffusion.loss`` is the score-matching loss of one batch (one
diffusion time per protein, the score normalised per chi by E[score^2]).
``TorsionalDiffusion.sample`` encodes the static graph once and runs the
``n_steps`` denoising iterations (each one network evaluation with the last
layer's edge pass skipped), optionally with Langevin corrector sub-steps.

One denoising iteration is one function (``TorsionalDiffusion._step``). On
the CPU, and for SDE, corrector or split-row sampling, it runs eagerly
``n_steps`` times. An ODE sample on the card captures it once a shape into a
CUDA graph (``_GraphedStep``, kept in a ``device.GraphCache`` on the model)
and replays it ``n_steps`` times, so a step costs one launch of the host's
rather than the ~290 operations of the network and the schedule's update;
the message and chain kernels run inside the graph.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from packppi_torch.data.batch import ProteinBatch
from packppi_torch.device import GraphCache, Replay, static_copies, weight_versions
from packppi_torch.diffusion.so2 import SO2Schedule
from packppi_torch.geometry.dihedrals import wrap_angle
from packppi_torch.models import ipmp
from packppi_torch.models.diffusion_net import ChiScoreNetwork, NetworkConfig, StaticGraph
from packppi_torch.utils.trace import span, tally


@dataclasses.dataclass(frozen=True)
class Rows:
    """A batch that holds rows ``[start, start + n)`` of a global batch of
    ``total`` rows, split over ranks (``group``: the mesh's data axis).
    Every draw is made at the global batch's shape and sliced to these rows,
    and batch means are taken over the global batch, so the sampler gives
    one device's numbers at any rank count."""

    start: int
    total: int
    group: object = None

    def draw(self, shape, generator, device) -> torch.Tensor:
        full = torch.randn((self.total,) + tuple(shape[1:]), generator=generator, device=device)
        return full[self.start:self.start + shape[0]]

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        from packppi_torch.parallel.launch import all_reduce

        return all_reduce(x.sum(), self.group) / self.total


@dataclasses.dataclass(frozen=True)
class SampleConfig:
    """The reverse process (annealed temperature; "ode" or "sde") and the
    proximal refinement that follows sampling."""

    annealed_temp: float = 3.0
    mode: str = "ode"
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
        # both periodicities share sigma(t) and the step; their score tables
        # differ, and ODE sampling reads neither
        kw = dict(annealed_temp=sample_cfg.annealed_temp, mode=sample_cfg.mode)
        self.schedule_pi = SO2Schedule(pi_periodic=True, **kw)
        self.schedule_2pi = SO2Schedule(pi_periodic=False, **kw)
        # the captured ODE steps of each shape (``sample``) and each step
        # count's table of step scalars on each device (``ode_table``)
        self._graphs = GraphCache()
        self._tables: dict = {}

    def add_chi_noise(self, batch: ProteinBatch, t: torch.Tensor,
                      generator: Optional[torch.Generator] = None, *,
                      noise_pi: Optional[torch.Tensor] = None,
                      noise_2pi: Optional[torch.Tensor] = None, with_score: bool = True):
        """Noise each chi by its periodicity's schedule at times ``t`` [B, L];
        returns the noised angles wrapped to [-pi, pi) and the true wrapped
        score (None with ``with_score=False``, which reads no table).
        ``noise_pi``/``noise_2pi`` [B, L, 4] replace the standard-normal
        draws."""
        m1, m2 = batch.chi_1pi_periodic_mask, batch.chi_2pi_periodic_mask
        noised, score1 = self.schedule_pi.add_noise(batch.SC_D, t, generator, m1, noise_pi,
                                                    with_score)
        noised, score2 = self.schedule_2pi.add_noise(noised, t, generator, m2, noise_2pi,
                                                     with_score)
        return wrap_angle(noised), torch.where(m1, score1, score2) if with_score else None

    def init_noise(self, batch: ProteinBatch, generator: torch.Generator) -> torch.Tensor:
        """The t=1 starting chis: true chis plus sigma_max noise on every
        present chi, wrapped to [-pi, pi)."""
        t = torch.ones(batch.residue_mask.shape, device=batch.SC_D.device)
        return self.add_chi_noise(batch, t, generator, with_score=False)[0]

    def loss(self, batch: ProteinBatch, generator: Optional[torch.Generator] = None,
             deterministic: bool = False, *, t: Optional[torch.Tensor] = None,
             noise_pi: Optional[torch.Tensor] = None,
             noise_2pi: Optional[torch.Tensor] = None, eps: float = 1e-6) -> torch.Tensor:
        """Score-matching loss, normalised per chi by E[score^2].

        One uniform diffusion time per protein, broadcast over its residues.
        ``deterministic`` evaluates the network in ``eval()`` mode (no
        dropout; validation and test), otherwise in ``train()`` mode; the
        time and noise draws stay random either way. ``t`` [B] and the two
        standard-normal ``noise_*`` [B, L, 4] replace the draws from
        ``generator``.
        """
        num, chi_count = self.loss_terms(batch, generator, deterministic, t=t,
                                         noise_pi=noise_pi, noise_2pi=noise_2pi, eps=eps)
        return num / torch.clamp(chi_count, min=1.0)

    def train_draws(self, B: int, L: int, generator: torch.Generator, device):
        """``(t [B], noise_pi [B, L, 4], noise_2pi [B, L, 4])``: what ``loss``
        draws from ``generator`` for a batch of ``B`` rows of ``L`` residues,
        in its order. Ranks that each hold rows of one global batch draw the
        global batch's and keep their rows, so every rank count gives one
        device's draws."""
        t = self.schedule_2pi.sample_train_t((B,), generator, device)
        noise = [torch.randn((B, L, 4), generator=generator, device=device)
                 for _ in range(2)]
        return t, noise[0], noise[1]

    def loss_terms(self, batch: ProteinBatch, generator: Optional[torch.Generator] = None,
                   deterministic: bool = False, *, t: Optional[torch.Tensor] = None,
                   noise_pi: Optional[torch.Tensor] = None,
                   noise_2pi: Optional[torch.Tensor] = None, eps: float = 1e-6):
        """``(numerator, chi count)`` of ``loss``: the normalised squared
        error summed over the batch's chis, and the number of chis. The loss
        of a batch split over ranks is the sum of the numerators over the sum
        of the counts (never a mean of the ranks' losses)."""
        B, L = batch.residue_mask.shape
        device = batch.SC_D.device
        if t is None:
            t = self.schedule_2pi.sample_train_t((B,), generator, device)
        t = t.to(device=device, dtype=torch.float32)[:, None] * torch.ones(1, L, device=device)
        sigma = self.schedule_2pi.t_to_sigma(t)[..., None]     # the same map for both

        noised, target = self.add_chi_noise(batch, t, generator, noise_pi=noise_pi,
                                            noise_2pi=noise_2pi)
        self.net.train(not deterministic)
        try:
            # the stack returns h_V only, so the last layer's edge pass is dead here
            pred, _ = self.net(batch, noised, t, skip_last_edge_update=True)
        finally:
            self.net.eval()

        sn_pi = self.schedule_pi.tables(device).lookup_score_norm(sigma)
        sn_2pi = self.schedule_2pi.tables(device).lookup_score_norm(sigma)
        score_norm = torch.where(batch.chi_1pi_periodic_mask, sn_pi, sn_2pi)

        pred = pred * torch.sqrt(score_norm) * batch.SC_D_mask
        return torch.sum((target - pred) ** 2 / (score_norm + eps)), batch.SC_D_mask.sum()

    @torch.no_grad()
    def sample(self, batch: ProteinBatch, generator: Optional[torch.Generator] = None,
               n_steps: int = 30, corrector_steps: int = 0,
               init_sc: Optional[torch.Tensor] = None, return_trajectory: bool = False,
               rows: Optional[Rows] = None):
        """Reverse diffusion from t=1 to 0. Returns SC_D [B, L, 4], and with
        ``return_trajectory`` also the [n_steps, B, L, 4] network inputs.

        ``init_sc`` replaces the t=1 noise (ODE sampling's only randomness),
        for replaying a recorded trajectory. SDE steps and
        ``corrector_steps`` Langevin sub-steps per iteration draw from
        ``generator``. ``rows``: ``batch`` is these rows of a global batch
        split over ranks (``Rows``).

        On the card an ODE sample with neither corrector steps nor ``rows``
        replays one captured step a shape (``_GraphedStep``), with the same
        bits as the eager loop; what it returns is its own.
        """
        draw = _draws(rows, generator)
        if init_sc is None:
            if generator is None:
                raise ValueError("sample needs a generator or init_sc")
            if rows is None:
                sc = self.init_noise(batch, generator)
            else:
                t1 = torch.ones(batch.residue_mask.shape, device=batch.SC_D.device)
                sc = self.add_chi_noise(batch, t1, noise_pi=draw(batch.SC_D),
                                        noise_2pi=draw(batch.SC_D), with_score=False)[0]
        else:
            sc = torch.as_tensor(init_sc, dtype=torch.float32, device=batch.SC_D.device)

        with span("sample.encode"):
            static = self.net.encode_static(batch)
        if sc.is_cuda and self.schedule_pi.mode == "ode" and not corrector_steps and rows is None:
            key = (sc.device, *sc.shape[:2], self.net.training, ipmp.FOLD_EDGE_CHAIN)
            weights = weight_versions(self.net)
            g = self._graphs.get(key, lambda: _GraphedStep(self, batch, static, sc, weights),
                                 lambda g: g.weights == weights)
            traj = sc.new_empty((n_steps,) + sc.shape) if return_trajectory else None
            sc = g.run(batch, static, sc, self.ode_table(n_steps, sc.device), traj)
            return (sc, traj) if return_trajectory else sc

        return self._eager(batch, static, sc, n_steps, corrector_steps, generator, rows,
                           return_trajectory)

    def _eager(self, batch: ProteinBatch, static: StaticGraph, sc: torch.Tensor, n_steps: int,
               corrector_steps: int = 0, generator: Optional[torch.Generator] = None,
               rows: Optional[Rows] = None, return_trajectory: bool = False):
        """The denoising loop from chis ``sc``, one eager step a call (as
        ``sample``'s arguments): the CPU's path and that of SDE, corrector
        and split-row samples; on the card what the graph's replays are
        held to."""
        draw = _draws(rows, generator)
        m1, m2 = batch.chi_1pi_periodic_mask, batch.chi_2pi_periodic_mask
        traj = []
        for time, dt in zip(*_step_times(n_steps)):
            with span("sample.step"):
                t = torch.full(batch.residue_mask.shape, float(time), device=sc.device)
                traj.append(sc)
                sc = self._step(batch, static, sc, t, float(time), float(dt), generator, draw)
                tally("sample_eager_steps")
            for _ in range(corrector_steps):
                # each periodicity's step size from its own masked norms
                score, _ = self.net(batch, sc, t, static=static, skip_last_edge_update=True)
                mean = torch.mean if rows is None else rows.mean
                sc_next = self.schedule_pi.step_correct(sc, score, m1, generator, draw(sc),
                                                        batch_mean=mean)
                sc_next = self.schedule_2pi.step_correct(sc_next, score, m2, generator,
                                                         draw(sc_next), batch_mean=mean)
                sc = wrap_angle(sc_next) * batch.SC_D_mask
        if return_trajectory:
            return sc, torch.stack(traj)
        return sc

    def _step(self, batch: ProteinBatch, static: StaticGraph, sc: torch.Tensor,
              t: torch.Tensor, time: Optional[float], dt: Optional[float],
              generator: Optional[torch.Generator] = None, draw=lambda x: None,
              ode: tuple = (None, None)) -> torch.Tensor:
        """One denoising iteration from chis ``sc`` at times ``t`` [B, L]:
        the network, each periodicity's step and the wrap; returns the next
        chis. The eager loop passes the step's ``time`` and ``dt``; a CUDA
        graph's capture passes ``ode``, each schedule's ODE scalars as
        float32 tensors (``SO2Schedule.step``), which its replays read.
        ``draw`` gives an SDE step's noise (None: drawn from ``generator``)."""
        score, _ = self.net(batch, sc, t, static=static, skip_last_edge_update=True)
        noise = (lambda: draw(score)) if self.schedule_pi.mode == "sde" else (lambda: None)
        sc_next = self.schedule_pi.step(sc, score, time, dt, batch.chi_1pi_periodic_mask,
                                        generator, noise(), ode[0])
        sc_next = self.schedule_2pi.step(sc_next, score, time, dt, batch.chi_2pi_periodic_mask,
                                         generator, noise(), ode[1])
        return wrap_angle(sc_next) * batch.SC_D_mask

    def ode_table(self, n_steps: int, device) -> torch.Tensor:
        """[n_steps, 5] float32 on ``device``, a row a step: its time, then
        each schedule's ``ode_coefficients`` (pi-periodic first), computed
        in float64 from the times the eager loop steps through and rounded
        to float32 once. Made once for each step count and device."""
        key = (n_steps, torch.device(device))
        table = self._tables.get(key)
        if table is None:
            rows = [[float(time), *self.schedule_pi.ode_coefficients(float(time), float(dt)),
                     *self.schedule_2pi.ode_coefficients(float(time), float(dt))]
                    for time, dt in zip(*_step_times(n_steps))]
            table = self._tables[key] = torch.tensor(rows, dtype=torch.float64).to(
                torch.float32).to(device)
        return table


def _draws(rows: Optional[Rows], generator):
    """What a draw of the shape of ``x`` gives: the global batch's draw cut
    to ``rows``, or None (the step draws from ``generator`` itself)."""
    if rows is None:
        return lambda x: None
    return lambda x: rows.draw(x.shape, generator, x.device)


def _step_times(n_steps: int):
    """Each step's time (1 down to 1/n_steps) and length, as float32."""
    ts = np.linspace(1.0, 0.0, n_steps + 1)
    return ts[:-1].astype(np.float32), (ts[:-1] - ts[1:]).astype(np.float32)


# the fields of the batch a step reads
_READ = ("X", "residue_type", "residue_mask", "BB_D_sincos", "SC_D_mask",
         "chi_1pi_periodic_mask", "chi_2pi_periodic_mask")


class _GraphedStep:
    """One ODE step captured for one shape under ``weights``: the ``Replay``
    of a step that reads static copies of the batch's fields, the static
    graph and the chis, and a slot of the step's scalars (a row of
    ``ode_table``)."""

    def __init__(self, model: TorsionalDiffusion, batch, static, sc, weights):
        self.weights = weights
        self.sc, self.slot = sc.clone(), sc.new_zeros(5)
        copies = (static_copies(batch, _READ), static_copies(static), self.sc)

        def step():
            s = self.slot
            t = s[0].expand(self.sc.shape[:2])
            self.sc.copy_(model._step(*copies, t, None, None, ode=((s[1], s[2]), (s[3], s[4]))))

        self.replay = Replay(step, sc.device, copies, "sample.step", "sample_")

    def run(self, batch, static, sc, table, traj=None):
        """The ``len(table)`` steps from chis ``sc``; each step's input goes
        to ``traj``'s row when given. Returns the final chis."""
        def each(i):
            if traj is not None:
                traj[i].copy_(self.sc)
            self.slot.copy_(table[i])

        return self.replay.run((batch, static, sc), table.shape[0], self.sc.clone, each)
