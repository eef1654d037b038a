"""Wrapped-Gaussian (SO(2)) score model for torsional diffusion.

``SO2Schedule`` is the variance-exploding schedule ``sigma(t) =
sigma_min^(1-t) sigma_max^t`` with annealed-temperature reverse steps (SDE
with noise injection, or the probability-flow ODE) and the Langevin
corrector. ``SO2Tables`` holds, for one periodicity, the density and score
of the wrapped Gaussian on a log-log (sigma, |x|) grid and E[score^2] per
sigma: built once in float32 (a stabilised image sum), cached on disk, and
kept on the device as tensors, so every lookup in a training or sampling
step is an index into device memory and never a host round trip.

Chi angles of symmetric side chains (ASP chi2, GLU chi3, PHE/TYR chi2) are
pi-periodic, the rest 2pi-periodic: two table sets, with half-period
``PI = pi/2`` and ``PI = pi``. ODE sampling reads no table, so packing
builds none; training (score targets and norms) does.

The disk cache is ``$PACKPPI_TORCH_CACHE/so2`` (default
``~/.cache/packppi_torch/so2``); a file is written under a temporary name
and renamed into place, so concurrent processes never read a partial file.
"""
from __future__ import annotations

import dataclasses
import math
import os
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

X_MIN, X_N = 1e-5, 5000
SIGMA_MIN, SIGMA_MAX, SIGMA_N = 3e-3, 2.0, 5000


def cache_dir() -> Path:
    root = os.environ.get("PACKPPI_TORCH_CACHE",
                          os.path.join(os.path.expanduser("~"), ".cache", "packppi_torch"))
    p = Path(root) / "so2"
    p.mkdir(parents=True, exist_ok=True)
    return p


# below this exponent a float32 exp is exactly 0 (the smallest subnormal is e^-103.3)
_EXP_UNDERFLOW = -110.0


def _density_and_score(x_row: np.ndarray, sigma_col: np.ndarray, PI: float, n_images: int,
                       rows: int = 256):
    """Image sums of (density, d/dx log density) on the [sigma, x] grid, in
    float32, ``rows`` sigma rows at a time.

    Stabilised around the k = 0 image (the nearest centre for |x| below half
    the period): every exponent is <= 0 and the 0th term is exactly 1, so
    the score stays exact in float32 where the raw density underflows. An
    image whose term is exactly 0 over a whole block of rows (small sigma:
    all but k = 0 and its nearest neighbours) is skipped: the sums do not
    change by a bit.
    """
    x = torch.as_tensor(x_row, dtype=torch.float32)[None, :]
    x_abs_max = float(np.abs(x_row).max())
    dens, scores = [], []
    for s in range(0, len(sigma_col), rows):
        sigma = torch.as_tensor(sigma_col[s:s + rows], dtype=torch.float32)[:, None]
        inv_var = 1.0 / (sigma * sigma)
        base = 0.5 * x * x * inv_var          # -log of the k = 0 image
        den = torch.zeros(sigma.shape[0], x.shape[1])
        num = torch.zeros_like(den)
        sigma_max = float(sigma.max())
        for k in range(-n_images, n_images + 1):
            # the largest exponent of image k in this block, (x^2 - xk^2) / (2 sigma^2) at
            # the x nearest its centre and the largest sigma (the float32 sum below rounds
            # it by less than 0.01; _EXP_UNDERFLOW leaves 6)
            top = -2 * PI * abs(k) * (PI * abs(k) - x_abs_max) / sigma_max ** 2
            if k and top < _EXP_UNDERFLOW:
                continue
            xk = x + (2 * PI) * k
            e = torch.exp(base - 0.5 * xk * xk * inv_var)
            den += e
            num -= (xk * inv_var) * e
        scores.append(num / torch.where(den == 0, torch.full_like(den, 1e-10), den))
        dens.append(den * torch.exp(-base))   # un-stabilised: may underflow, the score does not
    return torch.cat(dens), torch.cat(scores)


def _build_tables(PI: float):
    """(p, score, score_norm) as numpy float32: the density, the *negated*
    score at positive x (the lookup applies ``-sign(x)``), and E[score^2]
    per sigma by quadrature over the period."""
    x = 10 ** np.linspace(np.log10(X_MIN), 0, X_N + 1) * PI          # (0, PI]
    sigma = 10 ** np.linspace(np.log10(SIGMA_MIN), np.log10(SIGMA_MAX), SIGMA_N + 1) * PI

    n_images = max(12, int(np.ceil(8 * sigma[-1] / (2 * PI))) + 2)
    p, score = _density_and_score(x, sigma, PI, n_images)
    p, s = p.numpy(), (-score).numpy()

    # the reference builds its tables in raw float64, where the density
    # underflows to 0 far beyond sigma and the score becomes 0/eps = 0 (no
    # force in zero-density regions): zero both where a float64 exp would
    base = 0.5 * (x[None, :].astype(np.float64) / sigma[:, None]) ** 2
    underflow = base > 745.0
    s[underflow] = 0.0
    p[underflow] = 0.0
    # subnormal densities count as zero, as in the reference's tables
    p[p < np.finfo(np.float32).tiny] = 0.0

    xs = np.linspace(-PI, PI, 2049)[1:-1]
    pd, sc = _density_and_score(xs, sigma, PI, n_images)
    w = pd / pd.sum(-1, keepdim=True)
    score_norm = (w * sc ** 2).sum(-1).numpy()
    return p, s, score_norm


@dataclasses.dataclass(frozen=True)
class SO2Tables:
    """Lookup tables for one periodicity, as tensors on one device."""

    PI: float
    p: torch.Tensor           # [SIGMA_N+1, X_N+1] density
    score: torch.Tensor       # [SIGMA_N+1, X_N+1] -score at positive x
    score_norm: torch.Tensor  # [SIGMA_N+1] E[score^2]

    @staticmethod
    def build(PI: float, cache: bool = True) -> "SO2Tables":
        path = cache_dir() / f"so2_{PI:.6f}.npz" if cache else None
        if path is not None and path.exists():
            with np.load(path) as d:
                p, s, sn = d["p"], d["score"], d["score_norm"]
        else:
            p, s, sn = _build_tables(PI)
            if path is not None:
                tmp = path.with_name(f"{path.stem}.{os.getpid()}.{threading.get_ident()}.tmp.npz")
                # uncompressed (200 MB a periodicity): compressing costs more than the build
                np.savez(tmp, p=p, score=s, score_norm=sn)
                os.replace(tmp, path)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
        return SO2Tables(PI, t(p), t(s), t(sn))

    def to(self, device) -> "SO2Tables":
        return SO2Tables(self.PI, self.p.to(device), self.score.to(device),
                         self.score_norm.to(device))

    # ---- lookups: index arithmetic and a gather on the tables' device -------

    def _x_index(self, x):
        xa = torch.log(x.abs() / self.PI + 1e-10)
        idx = (xa - math.log(X_MIN)) / (0 - math.log(X_MIN)) * X_N
        return idx.round().clamp(0, X_N).long()

    def _sigma_index(self, sigma):
        s = torch.log(sigma / self.PI)
        idx = (s - math.log(SIGMA_MIN)) / (math.log(SIGMA_MAX) - math.log(SIGMA_MIN)) * SIGMA_N
        return idx.round().clamp(0, SIGMA_N).long()

    def _wrap(self, x):
        return torch.remainder(x + self.PI, 2 * self.PI) - self.PI

    def lookup_score(self, x, sigma):
        x = self._wrap(x)
        idx = self._sigma_index(sigma) * (X_N + 1) + self._x_index(x)
        return -torch.sign(x) * self.score.reshape(-1)[idx]

    def lookup_p(self, x, sigma):
        idx = self._sigma_index(sigma) * (X_N + 1) + self._x_index(self._wrap(x))
        return self.p.reshape(-1)[idx]

    def lookup_score_norm(self, sigma):
        return self.score_norm[self._sigma_index(sigma)]


_TABLES: dict = {}
_TABLES_LOCK = threading.Lock()


def get_tables(PI: float, device) -> SO2Tables:
    """The tables of half-period ``PI`` on ``device``: loaded (or built and
    cached) once per process, moved once per device."""
    device = torch.device(device)
    with _TABLES_LOCK:
        key = (round(PI, 6), device)
        if key not in _TABLES:
            host = (round(PI, 6), torch.device("cpu"))
            if host not in _TABLES:
                _TABLES[host] = SO2Tables.build(PI)
            _TABLES[key] = _TABLES[host].to(device)
        return _TABLES[key]


def _randn(shape, generator, device, dtype):
    if generator is None:
        raise ValueError("a random draw needs a generator (or the noise itself)")
    return torch.randn(tuple(shape), generator=generator, device=device, dtype=dtype)


@dataclasses.dataclass(frozen=True)
class SO2Schedule:
    """sigma(t) and the reverse-time steps for one periodicity. Every
    random draw comes from the ``generator`` passed in, or is replaced by a
    standard-normal ``noise`` tensor of the same shape."""

    pi_periodic: bool = False
    sigma_min: float = 0.01 * math.pi
    sigma_max: float = math.pi
    annealed_temp: float = 3.0
    mode: str = "ode"

    @property
    def PI(self) -> float:
        return math.pi / 2 if self.pi_periodic else math.pi

    def tables(self, device) -> SO2Tables:
        return get_tables(self.PI, device)

    def t_to_sigma(self, t):
        lo, hi = math.log(self.sigma_min), math.log(self.sigma_max)
        if isinstance(t, torch.Tensor):
            return torch.exp(lo + (hi - lo) * t)
        return math.exp(lo + (hi - lo) * t)

    def add_noise(self, x: torch.Tensor, t: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  x_mask: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None, with_score: bool = True):
        """Perturb angles by sigma(t)-scaled Gaussian noise (masked). Returns
        (noised x, the true wrapped score at the noise offset); the score is
        None with ``with_score=False``, which reads no table."""
        sigma = self.t_to_sigma(t)[..., None]
        if noise is None:
            noise = _randn(x.shape, generator, x.device, x.dtype)
        noise = noise * sigma
        score = self.tables(x.device).lookup_score(noise, sigma) if with_score else None
        if x_mask is not None:
            noise = noise * x_mask
            if with_score:
                score = score * x_mask
        return x + noise, score

    def _drift(self, t: float):
        """(g(t), the annealing weight) at scalar time ``t``, in float64."""
        sigma = self.t_to_sigma(t)
        g = sigma * math.sqrt(2 * math.log(self.sigma_max / self.sigma_min))
        if self.annealed_temp:
            alpha = 1 - (sigma / self.sigma_max) ** 2
            weight = self.annealed_temp / (alpha + (1 - alpha) * self.annealed_temp)
        else:
            weight = 1.0
        return g, weight

    def ode_coefficients(self, t: float, dt: float):
        """(0.5 g(t)^2 dt, the annealing weight): the two scalars of the
        probability-flow ODE's step from ``t`` over ``dt``, in float64."""
        g, weight = self._drift(t)
        return 0.5 * g ** 2 * dt, weight

    def step(self, x: torch.Tensor, x_score: torch.Tensor, t: Optional[float],
             dt: Optional[float], x_mask: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None, ode: Optional[tuple] = None) -> torch.Tensor:
        """One reverse-time step at scalar time ``t``: the probability-flow
        ODE, or the SDE with noise injection. ``ode`` replaces the ODE's
        ``ode_coefficients(t, dt)`` (``t`` and ``dt`` are then unread) by
        the same two numbers rounded to float32, as float32 tensors on
        ``x``'s device that a CUDA graph's replays read: a Python float
        multiplies a float32 tensor as its float32 rounding, so the step's
        bits are the same."""
        if self.mode == "ode":
            factor, weight = self.ode_coefficients(t, dt) if ode is None else ode
            delta = factor * (x_score * weight)
        elif self.mode == "sde":
            g, weight = self._drift(t)
            if noise is None:
                noise = _randn(x_score.shape, generator, x_score.device, x_score.dtype)
            delta = (g ** 2 * dt) * (x_score * weight) + (g * math.sqrt(dt)) * noise
        else:
            raise NotImplementedError(self.mode)
        x_next = x + delta
        if x_mask is not None:
            x_next = torch.where(x_mask, x_next, x)
        return x_next

    def step_correct(self, x: torch.Tensor, x_score: torch.Tensor, x_mask: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None, snr: float = 0.16,
                     batch_mean=torch.mean) -> torch.Tensor:
        """Langevin corrector: the step size from the masked per-protein
        score and noise norms, averaged over the batch (``batch_mean`` of the
        [B] norms; a batch split over ranks passes the global batch's)."""
        m = x_mask.to(x.dtype)
        axes = tuple(range(1, x.ndim))
        score_norm = batch_mean(torch.sqrt(torch.sum(x_score ** 2 * m, dim=axes)))
        if noise is None:
            noise = _randn(x.shape, generator, x.device, x.dtype)
        noise_norm = batch_mean(torch.sqrt(torch.sum(noise ** 2 * m, dim=axes)))
        step_size = (snr * noise_norm / score_norm) ** 2 * 2
        x_next = x + step_size * x_score + torch.sqrt(step_size * 2) * noise
        return torch.where(x_mask, x_next, x)

    def sample_train_t(self, shape, generator: torch.Generator, device) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=generator, device=device)
