"""Pipeline parallelism (GPipe) over the mesh's ``model`` axis.

The ``model`` ranks of a data row are the stages: stage ``s`` holds layers
``[s * n, (s + 1) * n)`` of ``num_layers = S * n``. The rank's rows of the
global batch (its ``data`` row's) split into ``M`` microbatches; stage 0
reads them from its input, every later stage receives each one from the
stage before it (a point-to-point send between consecutive ranks), runs its
layers on it and sends it on. The chain has no cycle, so blocking sends
cannot deadlock; a stage computes only the ticks of its schedule (the
bubble is idle time, ``(S - 1) / (M + S - 1)`` of the run). The last
stage's outputs are broadcast to the stages of its row, each leaf in its own
dtype (a bool leaf travels as uint8 and comes back bool).
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch.utils import _pytree as pytree

from packppi_torch.parallel import launch
from packppi_torch.parallel.mesh import Mesh, batch_rows


def pipeline_apply(mesh: Mesh, layers: Sequence, carry, apply_layer: Callable,
                   n_microbatches: int):
    """Run ``layers`` over ``carry``, pipelined over ``mesh.model`` stages.

    ``layers``: every layer in order (a stage reads only its own, so the
    others may be None). ``carry``: a pytree of ``[B, ...]`` tensors of the
    GLOBAL batch (activations and side inputs, e.g. attention biases);
    ``apply_layer(layer, carry) -> carry`` keeps every leaf's shape.
    Returns this rank's rows of the result (``batch_rows``), equal to
    applying the layers one after another up to float32 summation order.
    """
    S = mesh.model
    M = int(n_microbatches)
    num_layers = len(layers)
    if num_layers % S:
        raise ValueError(f"num_layers={num_layers} not divisible by {S} stages")
    leaves, spec = pytree.tree_flatten(carry)
    B = leaves[0].shape[0]
    if B % (mesh.data * M):
        raise ValueError(f"global batch {B} not divisible by "
                         f"data={mesh.data} x microbatches={M}")
    rows = batch_rows(mesh, B)
    leaves = [t[rows] for t in leaves]
    mb = leaves[0].shape[0] // M
    s = mesh.model_index
    per = num_layers // S
    mine = layers[s * per:(s + 1) * per]
    row0 = mesh.data_index * S                 # global rank of stage 0 of this row

    def run_local(c):
        for layer in mine:
            c = apply_layer(layer, c)
        return c

    outs = [None] * M
    for i in range(M):
        x = [t[i * mb:(i + 1) * mb] for t in leaves]
        if s > 0:
            x = [launch.recv(torch.empty_like(t), row0 + s - 1) for t in x]
        y = pytree.tree_flatten(run_local(pytree.tree_unflatten(x, spec)))[0]
        if s < S - 1:
            for t in y:
                launch.send(t, row0 + s + 1)
        else:
            outs[i] = y
    if S == 1:
        return pytree.tree_unflatten([torch.cat(p, 0) for p in zip(*outs)], spec)

    last = row0 + S - 1
    result = []
    for k, ref in enumerate(leaves):
        full = (torch.cat([o[k] for o in outs], 0) if s == S - 1
                else torch.empty_like(ref))
        wire = full.to(torch.uint8) if full.dtype == torch.bool else full
        launch.broadcast(wire, last, mesh.model_group)
        result.append(wire.to(torch.bool) if full.dtype == torch.bool else wire)
    return pytree.tree_unflatten(result, spec)
