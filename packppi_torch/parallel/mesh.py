"""The ``(data, model)`` mesh of ranks and its layout rules.

``Mesh(data, model)`` is a grid of ranks, data outer and model inner: rank
``r`` sits at ``(r // model, r % model)``, as the JAX package's
``make_mesh`` reshapes its devices. Each axis has a process group a rank
belongs to: ``data_group`` joins the ranks of its model column (one rank of
each data row), ``model_group`` the ranks of its data row.

Layouts (the JAX package's shardings, held by each rank for its part):

- rows over ``data`` (``batch_rows`` / ``gather_rows``): data row ``d``
  holds rows ``[d * B / data, (d + 1) * B / data)`` of a global batch of B;
  the ranks of one data row hold the same rows.
- FSDP over ``model`` (``param_shards``, ``ShardedParams``): a tensor of at
  least 16,384 elements is split along its largest axis that ``model``
  divides, counted in the JAX package's layout (a ``Linear`` weight is
  ``[out, in]`` here and ``[in, out]`` there, so the rule reads its shape
  reversed). Each rank stores its slice and the optimizer state of that
  slice; the slices are all-gathered before use and the gradients
  reduce-scattered.
- sequence parallelism (``seq_rows``, ``gather_seq``): the residue axis of
  a batch split over ``model`` as well, for storage; consumers (the loss,
  ``proximal_optimize``) all-gather it at entry, so the numbers are those of
  one device. It moves no compute: a row-partitioned IPMP stack and clash
  listing are later work.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from packppi_torch.parallel import launch


@dataclasses.dataclass
class Mesh:
    data: int
    model: int
    rank: int
    data_group: object = None
    model_group: object = None

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}


def make_mesh(model_parallel: int = 1) -> Mesh:
    """The mesh of every rank of this launch (one rank outside ``launch``),
    ``model_parallel`` ranks along ``model``. Every rank must call it, in the
    same order as its other group creations."""
    here = launch.current()
    n, r = (1, 0) if here is None else (here.world, here.rank)
    if n % model_parallel:
        raise ValueError(f"{n} ranks not divisible by model_parallel={model_parallel}")
    data = n // model_parallel
    mesh = Mesh(data, model_parallel, r)
    if here is None:
        return mesh
    # every rank creates every group, in one order
    for m in range(model_parallel):
        g = dist.new_group([d * model_parallel + m for d in range(data)])
        if m == mesh.model_index:
            mesh.data_group = g
    for d in range(data):
        g = dist.new_group([d * model_parallel + m for m in range(model_parallel)])
        if d == mesh.data_index:
            mesh.model_group = g
    return mesh


def batch_rows(mesh: Mesh, B: int) -> slice:
    """This rank's rows of a global batch of ``B`` rows (``B`` divisible by
    ``data``)."""
    if B % mesh.data:
        raise ValueError(f"global batch {B} not divisible by data={mesh.data}")
    n = B // mesh.data
    return slice(mesh.data_index * n, (mesh.data_index + 1) * n)


def gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The global batch of a row-sharded tensor, on every rank."""
    if mesh.data == 1:
        return x
    return launch.all_gather(x, mesh.data_group, dim=0)


def reduce_sum(mesh: Mesh, x: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """``x`` summed over a mesh axis (a copy; ``x`` is left as it was)."""
    if getattr(mesh, axis) == 1:
        return x
    return launch.all_reduce(x.detach().clone(), getattr(mesh, f"{axis}_group"))


# ---- FSDP ------------------------------------------------------------------

def _transposed(module: nn.Module, name: str) -> bool:
    """True where the JAX package stores the parameter transposed: a
    ``Linear`` weight (``[out, in]`` here, ``[in, out]`` there)."""
    owner = module.get_submodule(name.rpartition(".")[0]) if "." in name else module
    return isinstance(owner, nn.Linear) and name.endswith("weight")


def shard_axis(shape: tuple, model: int, min_size: int = 16384) -> Optional[int]:
    """The JAX package's FSDP rule on one shape: the largest axis that
    ``model`` divides (the first of equal ones), for tensors of at least
    ``min_size`` elements; None replicates."""
    numel = 1
    for s in shape:
        numel *= s
    if model <= 1 or numel < min_size:
        return None
    for axis in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[axis] % model == 0:
            return axis
    return None


def param_shards(module: nn.Module, model: int, min_size: int = 16384) -> dict:
    """``{name: axis or None}`` for every parameter of ``module``: the axis
    of the torch tensor that holds the JAX rule's choice."""
    out = {}
    for name, p in module.named_parameters():
        flip = _transposed(module, name)
        axis = shard_axis(tuple(reversed(p.shape)) if flip else tuple(p.shape), model, min_size)
        out[name] = p.ndim - 1 - axis if flip and axis is not None else axis
    return out


class ShardedParams:
    """``module``'s parameters under FSDP over ``mesh.model``.

    ``masters`` holds, a name each, what the optimizer updates: this rank's
    slice of a sharded parameter (a tensor of its own) or the module's own
    tensor of a replicated one. The module keeps whole tensors for the
    forward pass: ``gather()`` refills the sharded ones from the slices.
    ``reduce_grads()`` turns the module's gradients of this rank's rows into
    the gradients of the global batch: replicated ones all-reduced over
    ``data``; sharded ones reduce-scattered over ``model`` (the ranks of a
    data row hold the same rows, so the sum is ``model`` equal terms and is
    divided by ``model``) and the slice all-reduced over ``data``.
    """

    def __init__(self, mesh: Mesh, module: nn.Module, min_size: int = 16384):
        self.mesh = mesh
        self.module = module
        self.axes = param_shards(module, mesh.model, min_size)
        self.params = dict(module.named_parameters())
        self.masters = {}
        for name, p in self.params.items():
            axis = self.axes[name]
            if axis is None:
                self.masters[name] = p
            else:
                piece = p.detach().chunk(mesh.model, axis)[mesh.model_index].clone()
                self.masters[name] = piece.requires_grad_(p.requires_grad)

    def parameters(self) -> list:
        """The optimizer's tensors, in the module's parameter order."""
        return list(self.masters.values())

    def sharded(self) -> list:
        return [n for n, a in self.axes.items() if a is not None]

    @torch.no_grad()
    def gather(self) -> None:
        """The whole tensors from every rank's slices: one all-gather over
        ``model`` of all the slices, flattened together."""
        names = self.sharded()
        if not names:
            return
        slices = [self.masters[n] for n in names]
        flat = launch.all_gather(torch.cat([t.reshape(-1) for t in slices]),
                                 self.mesh.model_group)
        per_rank = flat.view(self.mesh.model, -1).split([t.numel() for t in slices], dim=1)
        for name, t, parts in zip(names, slices, per_rank):
            full = torch.cat([part.view_as(t) for part in parts], self.axes[name])
            p = self.params[name]
            if p.shape == full.shape:
                p.copy_(full)
            else:
                p.data = full

    def release(self) -> None:
        """Free the module's whole copies of the sharded tensors: only the
        slices stay resident (``gathered`` brings them back)."""
        for name in self.sharded():
            p = self.params[name]
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)

    @contextlib.contextmanager
    def gathered(self):
        """A frozen module's FSDP: whole tensors inside the block, slices
        only outside it."""
        self.gather()
        try:
            yield
        finally:
            self.release()

    @torch.no_grad()
    def reduce_grads(self) -> None:
        m = self.mesh
        whole = [p.grad for n, p in self.params.items()
                 if p.grad is not None and self.axes[n] is None]
        if whole and m.data > 1:
            # one all-reduce of the replicated gradients, flattened together
            flat = launch.all_reduce(torch.cat([g.reshape(-1) for g in whole]), m.data_group)
            for g, part in zip(whole, flat.split([g.numel() for g in whole])):
                g.copy_(part.view_as(g))
        names = [n for n in self.sharded() if self.params[n].grad is not None]
        if not names:
            return
        # one reduce-scatter of all the sharded gradients: member j's chunk
        # holds every tensor's j-th slice, flattened
        pieces = [self.params[n].grad.chunk(m.model, self.axes[n]) for n in names]
        flat = torch.cat([torch.cat([p[j].reshape(-1) for p in pieces]) for j in range(m.model)])
        mine = launch.reduce_scatter(flat, m.model_group) / m.model
        if m.data > 1:
            launch.all_reduce(mine, m.data_group)
        sizes = [p[m.model_index].numel() for p in pieces]
        for name, p, g in zip(names, pieces, mine.split(sizes)):
            self.masters[name].grad = g.view_as(p[m.model_index]).clone()

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None
        for t in self.masters.values():
            t.grad = None

    @torch.no_grad()
    def load_full(self, state: dict) -> None:
        """Whole tensors (a one-device state dict) into the module and the
        slices."""
        self.module.load_state_dict(state, strict=True)
        for name in self.sharded():
            piece = self.params[name].chunk(self.mesh.model, self.axes[name])
            self.masters[name].copy_(piece[self.mesh.model_index])

    def full(self, tensors: dict) -> dict:
        """``{name: tensor}`` of masters' layout (slices of the sharded
        names) -> whole tensors, gathered over ``model``. Collective."""
        out = {}
        for name, t in tensors.items():
            axis = self.axes.get(name)
            out[name] = (t if axis is None
                         else launch.all_gather(t, self.mesh.model_group, dim=axis))
        return out

    def local(self, tensors: dict) -> dict:
        """Whole tensors -> this rank's slices of the sharded names."""
        out = {}
        for name, t in tensors.items():
            axis = self.axes.get(name)
            out[name] = t if axis is None else t.chunk(self.mesh.model, axis)[
                self.mesh.model_index].clone()
        return out

    def full_optimizer_state(self, optimizer: torch.optim.Optimizer) -> dict:
        """The optimizer's state dict as one device holds it (the slices'
        moments gathered). Collective."""
        sd = optimizer.state_dict()
        names = list(self.masters)
        state = {}
        for i, s in sd["state"].items():
            name = names[i]
            state[i] = {k: (self.full({name: v})[name]
                            if isinstance(v, torch.Tensor) and v.ndim > 0 else v)
                        for k, v in s.items()}
        return {"state": state, "param_groups": sd["param_groups"]}

    def load_optimizer_state(self, optimizer: torch.optim.Optimizer, full: dict) -> None:
        names = list(self.masters)
        state = {}
        for i, s in full["state"].items():
            name = names[int(i)]
            state[i] = {k: (self.local({name: v})[name]
                            if isinstance(v, torch.Tensor) and v.ndim > 0 else v)
                        for k, v in s.items()}
        optimizer.load_state_dict({"state": state, "param_groups": full["param_groups"]})


# ---- sequence parallelism ----------------------------------------------------

def seq_rows(mesh: Mesh, L: int) -> slice:
    """This rank's residues of ``L`` under the sequence layout (``L``
    divisible by ``model``)."""
    if L % mesh.model:
        raise ValueError(f"{L} residues not divisible by model={mesh.model}")
    n = L // mesh.model
    return slice(mesh.model_index * n, (mesh.model_index + 1) * n)


def seq_batch_shards(mesh: Mesh, batch):
    """The sequence-parallel layout of a global ``ProteinBatch``: this rank's
    rows (over ``data``) and residues (over ``model``) of every field with a
    residue axis, its rows of the rest."""
    B, L = batch.residue_mask.shape
    rows, res = batch_rows(mesh, B), seq_rows(mesh, L)
    return type(batch)(*(t[rows, res] if t.ndim >= 2 and t.shape[1] == L else t[rows]
                         for t in batch))


def gather_seq(mesh: Mesh, x):
    """A tensor or ``ProteinBatch`` of the sequence layout -> this rank's
    rows, every residue (all-gathered over ``model``)."""
    if isinstance(x, torch.Tensor):
        return x if mesh.model == 1 else launch.all_gather(x, mesh.model_group, dim=1)
    if mesh.model == 1:
        return x
    L_local = x.residue_mask.shape[1]
    return type(x)(*(launch.all_gather(t, mesh.model_group, dim=1)
                     if t.ndim >= 2 and t.shape[1] == L_local else t for t in x))
