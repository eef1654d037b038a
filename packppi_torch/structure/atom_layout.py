"""atom14 <-> atom37 layout conversion, on tensors.

The port computes in the compact atom14 layout; atom37 (AlphaFold's fixed
atom order) is for interoperability with other tools and datasets
(reference: src/utils/features.py:8-87). The conversions run on the device
of their input.
"""
from __future__ import annotations

import numpy as np
import torch

from packppi_torch.chem import CHEM


def atom14_masks(residue_type):
    """Per-residue layout maps for a [*, L] residue-type array (numpy):
    ``atom14_to_atom37`` [*, L, 14], ``atom37_to_atom14`` [*, L, 37],
    ``atom14_mask`` [*, L, 14] and ``atom37_mask`` [*, L, 37]."""
    rt = np.asarray(residue_type)
    return {
        "atom14_to_atom37": CHEM.atom14_to_atom37[rt],
        "atom37_to_atom14": CHEM.atom37_to_atom14[rt],
        "atom14_mask": CHEM.atom14_mask[rt],
        "atom37_mask": CHEM.atom37_mask[rt],
    }


def _convert(data, residue_type, index_table, mask_table):
    data = torch.as_tensor(data)
    rt = torch.as_tensor(residue_type, device=data.device).long()
    gather = torch.as_tensor(index_table, device=data.device)[rt]
    mask = torch.as_tensor(mask_table, device=data.device)[rt]
    idx = gather[..., None].expand(*gather.shape, data.shape[-1])
    return torch.take_along_dim(data, idx, dim=-2) * mask[..., None].to(data.dtype)


def atom14_to_atom37(atom14_data, residue_type) -> torch.Tensor:
    """[*, L, 14, C] -> [*, L, 37, C], zeros at atoms the residue lacks."""
    return _convert(atom14_data, residue_type, CHEM.atom37_to_atom14, CHEM.atom37_mask)


def atom37_to_atom14(atom37_data, residue_type) -> torch.Tensor:
    """[*, L, 37, C] -> [*, L, 14, C], zeros at empty atom14 slots."""
    return _convert(atom37_data, residue_type, CHEM.atom14_to_atom37, CHEM.atom14_mask)
