"""Host-side featurization: Protein -> the canonical dense feature dict.

Per protein, before padding: ``X [L,14,3]``, ``atom_mask [L,14]``,
``residue_type [L]``, ``residue_mask [L]``, ``residue_index [L]`` (with +100
inter-chain offsets), ``chain_indices [L]``, ``BB_D/BB_D_sincos/BB_D_mask``,
``SC_D/SC_D_sincos/SC_D_mask``, ``chi_{1,2}pi_periodic_mask``. Runs in numpy;
``data.batch.stack_batch`` pads and moves the result to the device.

Conventions kept from the reference dataset transform: pre-omega column
order, ``SC_D_mask`` defined as ``dihedral != 0``, and inter-chain offsets
that accumulate each chain's original maximum plus a 100-residue gap.
"""
from __future__ import annotations

import numpy as np

from packppi_torch.chem import CHEM
from packppi_torch.structure.protein import Protein
from packppi_torch.utils.trace import span


def _normalize(v: np.ndarray, axis: int = -1) -> np.ndarray:
    with np.errstate(invalid="ignore", divide="ignore"):
        out = v / np.linalg.norm(v, axis=axis, keepdims=True)
    return np.nan_to_num(out)


def dihedrals_along_chain_np(points: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    """Dihedrals over a chain of points [..., M, 3] -> [..., M-3], sign from
    ``sign(u_i . n_{i+1})``."""
    u = _normalize(points[..., 1:, :] - points[..., :-1, :])
    u2, u1, u0 = u[..., :-2, :], u[..., 1:-1, :], u[..., 2:, :]
    n2 = _normalize(np.cross(u2, u1))
    n1 = _normalize(np.cross(u1, u0))
    with np.errstate(invalid="ignore"):
        cos_d = np.clip(np.sum(n2 * n1, -1), -1 + eps, 1 - eps)
        return np.sign(np.sum(u2 * n1, -1)) * np.arccos(cos_d)


def bb_dihedrals(X: np.ndarray, residue_index: np.ndarray | None = None,
                 use_pre_omega: bool = True):
    """Backbone dihedrals [L,3] + validity mask. With ``use_pre_omega`` the
    columns are (pre-omega, phi, psi)."""
    L = X.shape[0]
    chain = X[:, :3].reshape(3 * L, 3)
    d = dihedrals_along_chain_np(chain)
    d = np.concatenate([[np.nan], d, [np.nan, np.nan]])  # phi[0], psi[-1], omega[-1]
    d = d.reshape(L, 3)  # columns: phi, psi, omega

    if residue_index is not None:
        pre = np.concatenate([[0.0], (residue_index[1:] - 1 == residue_index[:-1]).astype(np.float32)])
        post = np.concatenate([(residue_index[:-1] + 1 == residue_index[1:]).astype(np.float32), [0.0]])
        mask = np.stack([pre, post, post], -1)
    else:
        mask = np.ones_like(d, dtype=np.float32)

    if use_pre_omega:
        omega_pre = np.concatenate([[np.nan], d[:-1, 2]])
        d = np.stack([omega_pre, d[:, 0], d[:, 1]], -1)
        mask[:, 1] = mask[:, 0]  # phi shares the needs-previous-residue mask

    mask = mask * np.isfinite(d).astype(np.float32)
    return d, mask


def sc_dihedrals(X: np.ndarray, aatype: np.ndarray):
    """Side-chain chi angles [L,4] + mask (``angle != 0`` after scrubbing)."""
    idx = CHEM.chi_atom14_indices[aatype]                      # [L, 7]
    cmask = CHEM.chi_mask[aatype]                              # [L, 4]
    pts = np.take_along_axis(X, idx[..., None].repeat(3, -1), axis=-2)
    d = dihedrals_along_chain_np(pts)                          # [L, 4]
    d = np.nan_to_num(d) * cmask
    return d, (d != 0.0).astype(np.float32)


def apply_chain_residue_offsets(residue_index: np.ndarray, chain_indices: np.ndarray,
                                gap: int = 100) -> np.ndarray:
    """Shift each chain past the previous chains' original maxima plus a
    ``gap``-residue buffer (offsets do not compound)."""
    orig = residue_index
    residue_index = residue_index.copy()
    offset = 0
    for k in np.unique(chain_indices)[:-1]:
        offset += orig[chain_indices == k].max() + gap
        residue_index[chain_indices == k + 1] += offset
    return residue_index


def featurize(protein: Protein) -> dict[str, np.ndarray]:
    """Protein -> canonical feature dict (all numpy, NaN-scrubbed)."""
    with span("structure.featurize"):
        return _featurize(protein)


def chain_indices_of(protein: Protein) -> np.ndarray:
    """[L] 1-based chain index of each residue, the chains numbered in the
    order of their first residue."""
    _, first_idx = np.unique(protein.chain_id, return_index=True)
    order = protein.chain_id[np.sort(first_idx)]
    chain_map = {c: i + 1 for i, c in enumerate(order)}
    return np.array([chain_map[c] for c in protein.chain_id], np.int64)


def residue_mask_of(X: np.ndarray) -> np.ndarray:
    """[L] 1.0 where the backbone atoms N, CA, C and O are all present."""
    return np.isfinite(X[:, :4].sum(axis=(-1, -2))).astype(np.float32)


def _featurize(protein: Protein) -> dict[str, np.ndarray]:
    X = protein.atom_positions.astype(np.float32)
    residue_type = protein.aaindex.astype(np.int64)
    atom_mask = protein.atom_mask.astype(np.float32)
    residue_index = protein.residue_index.astype(np.int64)
    chain_indices = chain_indices_of(protein)

    if chain_indices.max(initial=0) > 1:
        residue_index = apply_chain_residue_offsets(residue_index, chain_indices)
    if np.abs(residue_index).max() >= 2**24:
        raise ValueError(
            f"residue_index max {residue_index.max()} exceeds the 2^24 "
            "integer-exact f32 range (pathological input numbering?)")

    residue_mask = residue_mask_of(X)

    BB_D, BB_D_mask = bb_dihedrals(X, residue_index)
    SC_D, SC_D_mask = sc_dihedrals(X, residue_type)

    BB_D_sincos = np.stack([np.sin(BB_D), np.cos(BB_D)], -1) * BB_D_mask[..., None]
    SC_D_sincos = np.stack([np.sin(SC_D), np.cos(SC_D)], -1) * SC_D_mask[..., None]

    pi_periodic = CHEM.chi_pi_periodic[residue_type].astype(bool)

    rm = residue_mask
    feats = {
        "X": X * rm[:, None, None],
        "atom_mask": atom_mask * rm[:, None],
        "residue_type": (residue_type * rm).astype(np.int64),
        "residue_mask": rm,
        "residue_index": (residue_index * rm).astype(np.int64),
        "chain_indices": (chain_indices * rm).astype(np.int64),
        "BB_D": BB_D * rm[:, None],
        "BB_D_sincos": BB_D_sincos * rm[:, None, None],
        "BB_D_mask": BB_D_mask * rm[:, None],
        "SC_D": SC_D * rm[:, None],
        "SC_D_sincos": SC_D_sincos * rm[:, None, None],
        "SC_D_mask": SC_D_mask * rm[:, None],
        "chi_1pi_periodic_mask": (SC_D_mask * rm[:, None]).astype(bool) & pi_periodic,
        "chi_2pi_periodic_mask": (SC_D_mask * rm[:, None]).astype(bool) & ~pi_periodic,
    }
    return {k: (np.nan_to_num(v) if v.dtype.kind == "f" else v) for k, v in feats.items()}
