"""PackPPI-Prox: proximal-gradient removal of steric clashes.

Minimizes ``||x - z||^2 + lambda * mean_residue_clash(x)`` over the chi
angles of clash-heavy residues (those above their complex's mean
per-residue clash) with Adam, differentiating through the whole
torsion -> frames -> atom14 chain. On the card every step is one launch of
the clash kernel and one of its gradient kernel (``ops.clash``); nothing of
size [L, L] is ever held, so complexes of thousands of residues fit.

Means are taken over the residue mask, so padding changes nothing and the
complexes of a batch stay independent.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from packppi_torch.data.batch import ProteinBatch
from packppi_torch.ops.clash import compute_residue_clash


def _row_mean(x, mask, eps=1e-10):
    """Per-complex masked mean over all but the batch axis. [B]"""
    axes = tuple(range(1, x.dim()))
    return (x * mask).sum(axes) / (mask.sum(axes) + eps)


@torch.no_grad()
def find_clash_mask(batch: ProteinBatch, SC_D,
                    violation_tolerance_factor: float = 12.0,
                    clash_overlap_tolerance: float = 0.5):
    """Residues whose clash exceeds their complex's mean get optimized.
    [B, L, 4] bool."""
    prc = compute_residue_clash(batch, SC_D, violation_tolerance_factor,
                                clash_overlap_tolerance)
    mean_clash = _row_mean(prc, batch.residue_mask)[:, None]
    sel = (prc > mean_clash) & (batch.residue_mask > 0)
    return sel[..., None].expand(*sel.shape, 4)


class ProximalResult(NamedTuple):
    SC_D: torch.Tensor        # [B, L, 4] optimized chis (non-selected kept)
    losses: torch.Tensor      # [num_steps] objective BEFORE each Adam step, so
    #                           the accept rule is losses[-1] < losses[0]
    clash_mask: torch.Tensor  # [B, L, 4] which chis were optimized
    row_losses: torch.Tensor  # [num_steps, B] per-complex trajectories: batched
    #                           callers apply the accept rule per complex


def proximal_optimize(batch: ProteinBatch, SC_D,
                      violation_tolerance_factor: float = 12.0,
                      clash_overlap_tolerance: float = 0.5,
                      lamda: float = 1.0,
                      num_steps: int = 50,
                      lr: float = 1e-2) -> ProximalResult:
    """``num_steps`` Adam steps on the chis of the clash-heavy residues.
    Enables gradients itself, so it may be called under ``torch.no_grad``.
    The per-step losses stay on the device until the caller reads them."""
    SC_D = SC_D.detach()
    clash_mask = find_clash_mask(batch, SC_D, violation_tolerance_factor,
                                 clash_overlap_tolerance)
    z = SC_D * clash_mask
    rm = batch.residue_mask
    rows = []
    with torch.enable_grad():
        x = z.clone().requires_grad_(True)
        opt = torch.optim.Adam([x], lr=lr)
        for _ in range(num_steps):
            opt.zero_grad(set_to_none=True)
            x_eff = torch.where(clash_mask, x, SC_D)
            prc = compute_residue_clash(batch, x_eff, violation_tolerance_factor,
                                        clash_overlap_tolerance)
            row = (_row_mean(((x_eff - z) ** 2).sum(-1), rm)
                   + lamda * _row_mean(prc, rm))       # [B] independent complexes
            row.mean().backward()
            # recorded before the step: rows[0] is the initial objective and
            # rows[-1] the one entering the last step
            rows.append(row.detach())
            opt.step()
    row_losses = torch.stack(rows)
    return ProximalResult(torch.where(clash_mask, x.detach(), SC_D), row_losses.mean(1),
                          clash_mask, row_losses)
