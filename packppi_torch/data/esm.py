"""ESM-2 sequence embeddings for PackPPI-AP's ``esm`` mode.

The reference embeds the complex's sequence with ESM-2 650M, chains joined
by 20 ``<pad>`` tokens and optional ``<mask>`` tokens (``residue_tokens``).
Here the embedding runs on the port's ``models.esm2.ESM2`` from a local
``.pt`` file (``load_esm_model``): a HuggingFace-named ``EsmModel`` state
dict beside the ``ESM2Config`` fields, as ``tools/convert_hf_esm_to_torch.py``
writes it from a local HuggingFace copy. ``data.skempi.stack_esm_batch``
lays out the sequences of a batch for one forward (``models.esm2.embed_rows``,
``models.affinity.EsmAffinityModel``). Without such a file, embeddings are
precomputed inputs (``load_precomputed``).
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np

from packppi_torch.chem import RESTYPES

ESM_DIM = 1280
_PAD_RUN = 20


def build_chain_separated_sequence(residue_types: np.ndarray,
                                   chain_indices: np.ndarray,
                                   mask_positions: Optional[np.ndarray] = None) -> str:
    """Sequence string with '<pad>'*20 between chains and '<mask>' at masked
    positions (the reference's format)."""
    parts = []
    uniq = sorted(set(int(c) for c in chain_indices))
    for j, c in enumerate(uniq):
        for i in np.flatnonzero(chain_indices == c):
            if mask_positions is not None and mask_positions[i]:
                parts.append("<mask>")
            else:
                idx = int(residue_types[i])
                parts.append(RESTYPES[idx] if idx < len(RESTYPES) else "X")
        if j != len(uniq) - 1:
            parts.append("<pad>" * _PAD_RUN)
    return "".join(parts)


def chain_grouped_order(chain_indices: np.ndarray) -> np.ndarray:
    """Residue indices in the order ``build_chain_separated_sequence`` emits
    them (sorted chain ids, original order within a chain). Featurization
    zeroes the chain id of residues with an incomplete backbone, so chain ids
    need not be non-decreasing; this order maps the embeddings back."""
    ci = np.asarray(chain_indices)
    return np.concatenate([np.flatnonzero(ci == c) for c in sorted(set(int(x) for x in ci))])


def residue_keep_indices(chain_indices: np.ndarray) -> np.ndarray:
    """Token indices (after <cls> is stripped) of the residues of the
    sequence ``build_chain_separated_sequence`` builds: each ``<pad>`` and
    ``<mask>`` is one token, so the stream is chain 0, 20 pads, chain 1, ...,
    the last chain, <eos>. (The reference keeps tokens ``[1 : L+1]``, which
    misaligns every chain after the first; the JAX package and the port
    drop the pads instead.)"""
    keep: list[int] = []
    uniq = sorted(set(int(c) for c in chain_indices))
    pos = 0
    for j, c in enumerate(uniq):
        n = int((np.asarray(chain_indices) == c).sum())
        keep.extend(range(pos, pos + n))
        pos += n + (_PAD_RUN if j != len(uniq) - 1 else 0)
    return np.asarray(keep, dtype=np.int64)


def residue_tokens(residue_types: np.ndarray, chain_indices: np.ndarray,
                   mask_positions: Optional[np.ndarray] = None):
    """``(ids, rows)``: the ESM-2 token ids of the chain-separated sequence
    (<cls>, the chains joined by 20 <pad>, <eos>) and, for each residue i,
    the index of its token in ``ids`` (the pads between chains skipped, the
    chain ids in any order)."""
    from packppi_torch.models.esm2 import tokenize

    ids = tokenize(build_chain_separated_sequence(residue_types, chain_indices, mask_positions))
    rows = np.empty(len(chain_indices), np.int64)
    rows[chain_grouped_order(chain_indices)] = residue_keep_indices(chain_indices) + 1   # <cls>
    return ids, rows


def esm_model(config: dict, state_dict, device):
    """The port's ESM-2 with ``config``'s ``ESM2Config`` fields and the
    HuggingFace-named float32 tensors of ``state_dict`` (taken as its
    parameters, not copied), attention "auto", on ``device``, in eval mode."""
    import torch

    from packppi_torch.models.esm2 import ESM2, ESM2Config
    from packppi_torch.weights import load_esm_state_dict

    with torch.device("meta"):               # no throwaway initialisation of the weights
        model = ESM2(ESM2Config(**{**config, "attention_impl": "auto"}))
    load_esm_state_dict(model, state_dict, assign=True)
    return model.to(device).eval()


def load_esm_model(path: Optional[Union[str, Path]], device="cuda"):
    """``esm_model`` over the ``.pt`` file at ``path``; None when there is
    no such file."""
    if path is None or not Path(path).is_file():
        return None
    import torch

    blob = torch.load(path, map_location="cpu", weights_only=True)
    return esm_model(blob["config"], blob["state_dict"], device)


def load_precomputed(path: Union[str, Path], entry_key: str) -> Optional[dict]:
    """Precomputed embeddings from ``<path>/<entry_key>.npz``: arrays keyed
    'wt' and 'mut' ([L, 1280] each)."""
    npz = Path(path) / f"{entry_key}.npz"
    if npz.exists():
        with np.load(npz) as z:
            return {k: z[k].astype(np.float32) for k in z.files}
    return None
