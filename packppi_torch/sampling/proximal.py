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

from typing import NamedTuple, Optional

import torch

from packppi_torch.data.batch import ProteinBatch
from packppi_torch.ops.clash import compute_residue_clash
from packppi_torch.utils.trace import span


def _row_mean(x, mask, eps=1e-10):
    """Per-complex masked mean over all but the batch axis. [B]"""
    axes = tuple(range(1, x.dim()))
    return (x * mask).sum(axes) / (mask.sum(axes) + eps)


def proximal_optimize_seq(mesh, batch: ProteinBatch, SC_D, *args, n_rows=None, **kwargs):
    """``proximal_optimize`` on the sequence-parallel layout
    (``parallel.seq_batch_shards``: this rank's rows and residues): the
    residues are all-gathered over ``mesh.model`` at entry, the rows refined
    as one device refines them, and the result returned in the same layout
    (``SC_D`` and ``clash_mask`` this rank's residues; the losses of every
    row, gathered over ``data``).
    ``n_rows``: the global batch's rows (default: ``data`` x this rank's)."""
    from packppi_torch.parallel.mesh import gather_seq, seq_rows

    full = gather_seq(mesh, batch)
    res = proximal_optimize(full, gather_seq(mesh, SC_D), *args,
                            n_rows=n_rows or SC_D.shape[0] * mesh.data, **kwargs)
    mine = seq_rows(mesh, full.residue_mask.shape[1])
    row_losses = res.row_losses
    if mesh.data > 1:
        from packppi_torch.parallel.launch import all_gather

        row_losses = all_gather(row_losses, mesh.data_group, dim=1)
    return ProximalResult(res.SC_D[:, mine], row_losses.mean(1), res.clash_mask[:, mine],
                          row_losses)


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
                      lr: float = 1e-2, n_rows: Optional[int] = None) -> ProximalResult:
    """``num_steps`` Adam steps on the chis of the clash-heavy residues.
    Enables gradients itself, so it may be called under ``torch.no_grad``.
    The per-step losses stay on the device until the caller reads them.
    ``n_rows``: ``batch`` is a rank's rows of a batch of ``n_rows``; each
    row's gradient is scaled as in the whole batch's mean."""
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
            with span("refine.step"):
                opt.zero_grad(set_to_none=True)
                x_eff = torch.where(clash_mask, x, SC_D)
                prc = compute_residue_clash(batch, x_eff, violation_tolerance_factor,
                                            clash_overlap_tolerance)
                row = (_row_mean(((x_eff - z) ** 2).sum(-1), rm)
                       + lamda * _row_mean(prc, rm))       # [B] independent complexes
                (row.mean() if n_rows is None else row.sum() / n_rows).backward()
                # recorded before the step: rows[0] is the initial objective and
                # rows[-1] the one entering the last step
                rows.append(row.detach())
                opt.step()
    row_losses = torch.stack(rows)
    return ProximalResult(torch.where(clash_mask, x.detach(), SC_D), row_losses.mean(1),
                          clash_mask, row_losses)
