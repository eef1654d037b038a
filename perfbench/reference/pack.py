"""The rest of PackPPI-MSC's packing path in plain float32 PyTorch: the ODE
step of the torsional diffusion sampler, the side-chain rebuild from torsion
angles, and the proximal clash refinement (PackPPI-Prox).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from perfbench.reference import chem

SIGMA_MIN, SIGMA_MAX, TEMP = 0.01 * math.pi, math.pi, 3.0


def wrap(x: torch.Tensor) -> torch.Tensor:
    return torch.remainder(x + math.pi, 2 * math.pi) - math.pi


def sampler_times(n_steps: int):
    """(t, dt) of each step: t from 1 down to 0 in ``n_steps`` equal steps."""
    ts = np.linspace(1.0, 0.0, n_steps + 1)
    return ts[:-1].astype(np.float32), (ts[:-1] - ts[1:]).astype(np.float32)


def ode_delta(score: torch.Tensor, t: float, dt: float) -> torch.Tensor:
    """The probability-flow ODE's step, annealed at temperature 3: ``0.5 g^2
    dt w score`` with sigma = sigma_min^(1-t) sigma_max^t and g = sigma
    sqrt(2 ln(sigma_max / sigma_min)); the same for both chi periodicities."""
    sigma = math.exp(math.log(SIGMA_MIN) + (math.log(SIGMA_MAX) - math.log(SIGMA_MIN)) * t)
    g = sigma * math.sqrt(2 * math.log(SIGMA_MAX / SIGMA_MIN))
    alpha = 1 - (sigma / SIGMA_MAX) ** 2
    w = TEMP / (alpha + (1 - alpha) * TEMP)
    return (0.5 * g ** 2 * dt) * (score * w)


def _table(a, like):
    return torch.as_tensor(a, device=like.device)


def _compose(Ra, ta, Rb, tb):
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def atom14(X: torch.Tensor, aatype: torch.Tensor, bb: torch.Tensor, sc: torch.Tensor):
    """Atom14 coordinates [B, L, 14, 3]: backbone atoms of ``X``, side-chain
    atoms placed through the eight rigid groups at torsions (pre-omega, phi,
    psi, chi1..4)."""
    from perfbench.reference.net import backbone_frames

    ang = torch.cat([bb, sc], -1)
    s, c = torch.sin(ang), torch.cos(ang)
    n = torch.sqrt(torch.clamp(s * s + c * c, min=1e-12))
    s, c = s / n, c / n
    s8 = torch.cat([torch.zeros_like(s[..., :1]), s], -1)
    c8 = torch.cat([torch.ones_like(c[..., :1]), c], -1)
    z, o = torch.zeros_like(s8), torch.ones_like(s8)
    rot = torch.stack([torch.stack([o, z, z], -1), torch.stack([z, c8, -s8], -1),
                       torch.stack([z, s8, c8], -1)], -2)
    default = _table(chem.GROUP_FRAMES, X)[aatype]
    R, t = _compose(default[..., :3, :3], default[..., :3, 3], rot, torch.zeros_like(rot[..., 0]))
    Rs, ts = [R[..., g, :, :] for g in range(5)], [t[..., g, :] for g in range(5)]
    for g in range(5, 8):   # chi_k in the frame of chi_(k-1)
        Rg, tg = _compose(Rs[-1], ts[-1], R[..., g, :, :], t[..., g, :])
        Rs.append(Rg)
        ts.append(tg)
    R, t = torch.stack(Rs, -3), torch.stack(ts, -2)
    Rb, tb = backbone_frames(X)
    R, t = _compose(Rb[..., None, :, :], tb[..., None, :], R, t)
    group = _table(chem.ATOM14_GROUP, X)[aatype]
    Ra = torch.gather(R, -3, group[..., None, None].expand(*group.shape, 3, 3))
    ta = torch.gather(t, -2, group[..., None].expand(*group.shape, 3))
    pos = ((Ra @ _table(chem.ATOM14_LOCAL, X)[aatype][..., None])[..., 0] + ta) \
        * _table(chem.ATOM14_MASK, X)[aatype][..., None]
    return torch.cat([X[..., :4, :], pos[..., 4:, :]], -2)


def residue_clash(b: dict, sc: torch.Tensor, tol: float = 0.5, factor: float = 12.0) -> torch.Tensor:
    """[B, L] clash of each residue's side-chain atoms, over their count:
    overlaps ``relu(r_a + r_b - tol - d)`` with every atom of the other
    residues (backbone pairs, CYS-slot SG pairs and the peptide C-N bond
    exempt), plus within-residue bound violations."""
    X = atom14(b["X"], b["aatype"], b["bb"], sc)
    ex = b["atom_mask"]
    rad = _table(chem.VDW, X)[b["aatype"]] * ex
    ridx = b["ridx"]
    B, L = ridx.shape
    keep = torch.ones(14, 14, device=X.device)
    keep[:4, :4] = 0.0
    keep[5, 5] = 0.0
    cn = torch.zeros(14, 14, device=X.device)
    cn[2, 0] = 1.0

    def rows(xi, ei, ri, ii):
        d = torch.sqrt(((xi[:, :, :, None, None] - X[:, None, None]) ** 2).sum(-1) + 1e-10)
        m = ei[:, :, :, None, None] * ex[:, None, None] * keep[:, None, :]
        m = m * (ii[:, :, None] != ridx[:, None, :])[:, :, None, :, None]
        nxt = (ridx[:, None, :] == ii[:, :, None] + 1)[:, :, None, :, None]
        prv = (ii[:, :, None] == ridx[:, None, :] + 1)[:, :, None, :, None]
        m = m * (1.0 - nxt * cn[:, None, :]) * (1.0 - prv * cn.t()[:, None, :])
        return (m * torch.relu(ri[:, :, :, None, None] + rad[:, None, None] - tol - d)).sum((3, 4))

    block = max(1, int(2e7 // (B * 196 * L)))
    per_atom = []
    for s in range(0, L, block):
        args = (X[:, s:s + block], ex[:, s:s + block], rad[:, s:s + block], ridx[:, s:s + block])
        per_atom.append(checkpoint(rows, *args, use_reentrant=False)
                        if torch.is_grad_enabled() and X.requires_grad else rows(*args))
    between = torch.cat(per_atom, 1)
    lo, hi = (_table(a, X)[b["aatype"]] for a in chem.dist_bounds(tol, factor))
    pm = ex[..., :, None] * ex[..., None, :]
    k = torch.ones(14, 14, device=X.device)
    k.fill_diagonal_(0.0)
    k[:4, :4] = 0.0
    d = torch.sqrt(((X[..., :, None, :] - X[..., None, :, :]) ** 2).sum(-1) + 1e-10)
    err = pm * k * (torch.relu(lo - d) + torch.relu(d - hi))
    total = between + err.sum(-2) + err.sum(-1)
    side = torch.ones(14, device=X.device)
    side[:4] = 0.0
    return (total * side).sum(-1) / (1e-10 + (ex * side).sum(-1))


def _row_mean(x, mask):
    axes = tuple(range(1, x.dim()))
    return (x * mask).sum(axes) / (mask.sum(axes) + 1e-10)


def refine(b: dict, sc: torch.Tensor, steps: int = 50, lr: float = 1e-2, lamda: float = 1.0):
    """PackPPI-Prox: Adam on the chis of the residues whose clash is above
    their complex's mean, minimising ``mean_res |x - z|^2 + lamda
    mean_res clash(x)`` (the batch's mean of the rows' objectives), each row
    keeping the result only where its objective entering the last step is
    below its first. Returns (chis [B, L, 4], accepted [B])."""
    rm = b["rmask"]
    with torch.no_grad():
        prc = residue_clash(b, sc)
        sel = (prc > _row_mean(prc, rm)[:, None]) & (rm > 0)
    sel = sel[..., None].expand(*sel.shape, 4)
    z = sc * sel
    x = z.clone().requires_grad_(True)
    opt = torch.optim.Adam([x], lr=lr)
    rows = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        xe = torch.where(sel, x, sc)
        row = _row_mean(((xe - z) ** 2).sum(-1), rm) + lamda * _row_mean(residue_clash(b, xe), rm)
        row.mean().backward()
        rows.append(row.detach())
        opt.step()
    accept = rows[-1] < rows[0]
    out = torch.where(sel, x.detach(), sc)
    return torch.where(accept[:, None, None], out, sc), accept
