"""PackPPI-Prox: proximal-gradient removal of steric clashes.

Minimizes ``||x - z||^2 + lambda * mean_residue_clash(x)`` over the chi
angles of clash-heavy residues (those above their complex's mean
per-residue clash) with Adam, differentiating through the whole
torsion -> frames -> atom14 chain. On the card every step is one launch of
the clash kernel and one of its gradient kernel (``ops.clash``); nothing of
size [L, L] is ever held, so complexes of thousands of residues fit.

Means are taken over the residue mask, so padding changes nothing and the
complexes of a batch stay independent.

One Adam step is one function (``_Refinement.step``). On the CPU it runs
eagerly ``num_steps`` times. On the card it is captured once a shape into a
CUDA graph (``device.Replay``, kept in a ``device.GraphCache``) and
replayed ``num_steps`` times, so a step costs one launch of the host's
rather than the ~200 operations of the objective, its backward and Adam;
the clash kernels run inside the graph.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from packppi_torch.data.batch import ProteinBatch
from packppi_torch.device import GraphCache, Replay, static_copies
from packppi_torch.ops.clash import compute_residue_clash
from packppi_torch.utils.trace import span, tally


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


# the fields of the batch a step reads
_READ = ("X", "atom_mask", "residue_type", "residue_mask", "residue_index", "BB_D")


class _Refinement:
    """One refinement's tensors and its Adam step on ``x``, the chis of the
    optimized residues (``z`` where it starts)."""

    def __init__(self, batch, SC_D, z, clash_mask, num_steps, lr, lamda, tolerances, n_rows):
        self.batch, self.SC_D, self.z, self.clash_mask = batch, SC_D, z, clash_mask
        self.lamda, self.tolerances, self.n_rows = lamda, tolerances, n_rows
        self.x = z.clone().requires_grad_(True)
        # on the card Adam's step count and bias corrections live on the device,
        # as a graph needs, whether or not this loop is captured
        self.opt = torch.optim.Adam([self.x], lr=lr, capturable=z.is_cuda)
        self.losses = z.new_zeros(num_steps, z.shape[0])     # [num_steps, B]
        self.slot = torch.zeros(1, dtype=torch.long, device=z.device)

    def step(self):
        """One Adam step; the objective of every row entering it goes to row
        ``slot`` of ``losses``, and ``slot`` moves on (on the device)."""
        self.opt.zero_grad(set_to_none=True)
        x_eff = torch.where(self.clash_mask, self.x, self.SC_D)
        rm = self.batch.residue_mask
        prc = compute_residue_clash(self.batch, x_eff, *self.tolerances)
        row = (_row_mean(((x_eff - self.z) ** 2).sum(-1), rm)
               + self.lamda * _row_mean(prc, rm))             # [B] independent complexes
        (row.mean() if self.n_rows is None else row.sum() / self.n_rows).backward()
        # recorded before the step: losses[0] is the initial objective and
        # losses[-1] the one entering the last step
        self.losses.index_copy_(0, self.slot, row.detach()[None])
        self.slot.add_(1)
        self.opt.step()

    def result(self):
        return torch.where(self.clash_mask, self.x.detach(), self.SC_D), self.losses


def _captured(batch, SC_D, z, clash_mask, *args):
    """A refinement on static copies of what a step reads, and the
    ``Replay`` of its Adam step."""
    r = _Refinement(static_copies(batch, _READ), SC_D.clone(), z.clone(), clash_mask.clone(),
                    *args)

    def warm_up():   # Adam's state is made here, outside the graph
        r.slot.zero_()
        r.step()
        r.opt.zero_grad(set_to_none=True)   # the capture allocates its own

    with torch.enable_grad():
        return r, Replay(r.step, z.device, (r.batch, r.SC_D, r.z, r.clash_mask, r.x),
                         "refine.step", warm_up=warm_up)


_GRAPHS = GraphCache()


def proximal_optimize(batch: ProteinBatch, SC_D,
                      violation_tolerance_factor: float = 12.0,
                      clash_overlap_tolerance: float = 0.5,
                      lamda: float = 1.0,
                      num_steps: int = 50,
                      lr: float = 1e-2, n_rows: Optional[int] = None) -> ProximalResult:
    """``num_steps`` Adam steps on the chis of the clash-heavy residues:
    replays of a CUDA graph for CUDA tensors, eager steps for CPU ones.
    Enables gradients itself, so it may be called under ``torch.no_grad``.
    The per-step losses stay on the device until the caller reads them.
    ``n_rows``: ``batch`` is a rank's rows of a batch of ``n_rows``; each
    row's gradient is scaled as in the whole batch's mean."""
    if num_steps < 1:
        raise ValueError(f"proximal_optimize: num_steps is {num_steps}, expected >= 1")
    SC_D = SC_D.detach()
    tolerances = (violation_tolerance_factor, clash_overlap_tolerance)
    clash_mask = find_clash_mask(batch, SC_D, *tolerances)
    z = SC_D * clash_mask
    if SC_D.is_cuda:
        key = (SC_D.device, *SC_D.shape[:2], num_steps, lr, lamda, *tolerances, n_rows)
        r, replay = _GRAPHS.get(key, lambda: _captured(batch, SC_D, z, clash_mask, num_steps, lr,
                                                       lamda, tolerances, n_rows))
        # Adam's state (step, exp_avg, exp_avg_sq) and the losses' slot start at 0
        x, row_losses = replay.run((batch, SC_D, z, clash_mask, z), num_steps,
                                   lambda: (r.result()[0], r.losses.clone()),
                                   zero=(*r.opt.state[r.x].values(), r.slot))
    else:
        x, row_losses = _eager(batch, SC_D, z, clash_mask, num_steps, lr, lamda, tolerances,
                               n_rows)
    return ProximalResult(x, row_losses.mean(1), clash_mask, row_losses)


def _eager(batch, SC_D, z, clash_mask, num_steps, *args):
    """The refinement as a loop of eager steps: the CPU's path, and on the
    card what the graph's replays are held to."""
    r = _Refinement(batch, SC_D, z, clash_mask, num_steps, *args)
    with torch.enable_grad():
        for _ in range(num_steps):
            with span("refine.step"):
                r.step()
                tally("eager_steps")
    return r.result()
