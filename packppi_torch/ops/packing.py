"""Packed copies of kernel weights, made once for each version of the
weights.

A kernel that reads its weights in a layout of its own (the bf16 chain's
swizzled panels, the message kernels' panels and TF32 parts) takes a copy
made by a packing function. ``packed`` keeps that copy per packing function
and weight tensors, and makes it again only when one of the tensors is
another object or was written in place since (its ``_version``, which an
optimizer step bumps), so a pass over weights that do not change launches
no extra device operation.
"""
from __future__ import annotations

import weakref

# (pack, id of each weight) -> (weakrefs, versions, packed copy)
_PACKED: dict = {}


def packed(pack, *weights):
    """``pack(*weights)``, kept until one of ``weights`` changes."""
    if any(w.is_inference() for w in weights):       # no version counter to go by
        return pack(*weights)
    key = (pack, *(id(w) for w in weights))
    version = tuple(w._version for w in weights)
    hit = _PACKED.get(key)
    if (hit is not None and all(r() is w for r, w in zip(hit[0], weights))
            and hit[1] == version):
        return hit[2]
    drop = lambda _, key=key: _PACKED.pop(key, None)
    copy = pack(*weights)
    _PACKED[key] = (tuple(weakref.ref(w, drop) for w in weights), version, copy)
    return copy
