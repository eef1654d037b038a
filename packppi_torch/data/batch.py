"""The padded batch every model of the port consumes.

Dense ``[B, L, ...]`` tensors with explicit masks, on one device. ``L`` is
rounded up to a length bucket so every structure of a bucket shares shapes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch


class ProteinBatch(NamedTuple):
    X: torch.Tensor                      # [B, L, 14, 3] float32
    atom_mask: torch.Tensor              # [B, L, 14]
    residue_type: torch.Tensor           # [B, L] int64
    residue_mask: torch.Tensor           # [B, L]
    residue_index: torch.Tensor          # [B, L] int64
    chain_indices: torch.Tensor          # [B, L] int64
    BB_D: torch.Tensor                   # [B, L, 3]
    BB_D_sincos: torch.Tensor            # [B, L, 3, 2]
    BB_D_mask: torch.Tensor              # [B, L, 3]
    SC_D: torch.Tensor                   # [B, L, 4]
    SC_D_sincos: torch.Tensor            # [B, L, 4, 2]
    SC_D_mask: torch.Tensor              # [B, L, 4]
    chi_1pi_periodic_mask: torch.Tensor  # [B, L, 4] bool
    chi_2pi_periodic_mask: torch.Tensor  # [B, L, 4] bool


LENGTH_BUCKETS = (64, 96, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096)


def bucket_length(length: int) -> int:
    for b in LENGTH_BUCKETS:
        if length <= b:
            return b
    return int(np.ceil(length / 1024) * 1024)


def pad_features(feats: dict[str, np.ndarray], target_len: Optional[int] = None) -> dict[str, np.ndarray]:
    """Pad one protein's feature dict along the residue axis."""
    L = len(feats["residue_type"])
    target = target_len if target_len is not None else bucket_length(L)
    return {k: np.pad(v, [(0, target - L)] + [(0, 0)] * (v.ndim - 1))
            for k, v in feats.items()}


def stack_batch(protein_feats: list[dict[str, np.ndarray]],
                device: Union[str, torch.device],
                target_len: Optional[int] = None) -> ProteinBatch:
    """Pad each protein to the common bucketed length, stack to [B, L, ...]
    and move to ``device``: floats as float32, integers as int64."""
    max_len = max(len(f["residue_type"]) for f in protein_feats)
    target = target_len if target_len is not None else bucket_length(max_len)
    padded = [pad_features(f, target) for f in protein_feats]
    fields = {}
    for name in ProteinBatch._fields:
        arr = np.stack([p[name] for p in padded])
        if arr.dtype.kind in "iu":
            arr = arr.astype(np.int64)
        elif arr.dtype.kind == "f":
            arr = arr.astype(np.float32)
        fields[name] = torch.from_numpy(arr).to(device)
    return ProteinBatch(**fields)
