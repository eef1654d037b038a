"""Torsion angles -> rigid frames -> atom14 coordinates.

AF2's 8-rigid-group frame algebra with the reference's conventions: given
backbone coordinates and (pre-omega, phi, psi, chi1..4) angles, place every
side-chain atom. Each atom's group frame is picked by an index gather.
"""
from __future__ import annotations

import functools

import torch

from packppi_torch.chem import CHEM
from packppi_torch.geometry.rigid import (Rigid, bb_frames_from_atom14,
                                          compose, from_4x4, rigid_apply)


@functools.lru_cache(maxsize=None)
def chem_table(name: str, device: torch.device) -> torch.Tensor:
    """The constant chemistry table ``CHEM.<name>`` on ``device``, copied
    there once: the proximal loop rebuilds coordinates at every step."""
    return torch.as_tensor(getattr(CHEM, name), device=device)


def torsion_angles_to_frames(bb: Rigid, sincos: torch.Tensor,
                             aatype: torch.Tensor) -> Rigid:
    """Compose per-group frames into global frames.

    Args:
        bb: backbone-to-global frames, batch shape [..., L].
        sincos: [..., L, 7, 2] (sin, cos) of (pre-omega, phi, psi, chi1..4).
        aatype: [..., L] residue types.

    Returns:
        [..., L, 8] frames mapping each rigid group to global coordinates.
    """
    default = from_4x4(chem_table("rigid_group_default_frame", aatype.device)[aatype])

    sin = sincos[..., 0]
    cos = sincos[..., 1]
    # prepend the identity rotation for the backbone group
    sin8 = torch.cat([torch.zeros_like(sin[..., :1]), sin], -1)
    cos8 = torch.cat([torch.ones_like(cos[..., :1]), cos], -1)
    zero = torch.zeros_like(sin8)
    one = torch.ones_like(sin8)
    # rotation about the group x-axis by the torsion angle
    rot = torch.stack([
        torch.stack([one, zero, zero], -1),
        torch.stack([zero, cos8, -sin8], -1),
        torch.stack([zero, sin8, cos8], -1),
    ], -2)  # [..., L, 8, 3, 3]
    frames = compose(default, Rigid(rot, torch.zeros(*sin8.shape, 3, dtype=sin8.dtype,
                                                     device=sin8.device)))

    # chain chi frames: chi_k is defined relative to chi_{k-1}
    at = lambda g: Rigid(frames.rot[..., g, :, :], frames.trans[..., g, :])
    chi2 = compose(at(4), at(5))
    chi3 = compose(chi2, at(6))
    chi4 = compose(chi3, at(7))
    rot_all = torch.cat([frames.rot[..., :5, :, :], chi2.rot[..., None, :, :],
                         chi3.rot[..., None, :, :], chi4.rot[..., None, :, :]], -3)
    trans_all = torch.cat([frames.trans[..., :5, :], chi2.trans[..., None, :],
                           chi3.trans[..., None, :], chi4.trans[..., None, :]], -2)
    bb_exp = Rigid(bb.rot[..., None, :, :], bb.trans[..., None, :])
    return compose(bb_exp, Rigid(rot_all, trans_all))


def frames_to_atom14_positions(frames: Rigid, aatype: torch.Tensor) -> torch.Tensor:
    """Place literature atom positions through their group frames.

    Args:
        frames: [..., L, 8] group-to-global frames.
        aatype: [..., L].

    Returns:
        [..., L, 14, 3] atom positions (masked to existing atoms).
    """
    group = chem_table("atom14_to_rigid_group", aatype.device)[aatype]       # [..., L, 14]
    rot = torch.gather(frames.rot, -3, group[..., None, None].expand(*group.shape, 3, 3))
    trans = torch.gather(frames.trans, -2, group[..., None].expand(*group.shape, 3))
    lit = chem_table("atom14_local_positions", aatype.device)[aatype]        # [..., L, 14, 3]
    mask = chem_table("atom14_mask", aatype.device)[aatype]                  # [..., L, 14]
    return rigid_apply(Rigid(rot, trans), lit) * mask[..., None]


def atom14_coords_from_torsions(X: torch.Tensor, aatype: torch.Tensor,
                                bb_d: torch.Tensor, sc_d: torch.Tensor) -> torch.Tensor:
    """(backbone dihedrals, chi angles) -> atom14 coordinates. Backbone
    atoms (N, CA, C, O) are copied from ``X``; side-chain atoms are rebuilt.

    Args:
        X: [..., L, 14, 3]; aatype: [..., L]; bb_d: [..., L, 3] (pre-omega,
        phi, psi); sc_d: [..., L, 4] chi angles.
    """
    angles = torch.cat([bb_d, sc_d], -1)                              # [..., L, 7]
    sincos = torch.stack([torch.sin(angles), torch.cos(angles)], -1)
    sincos = sincos / torch.sqrt(torch.clamp(torch.sum(sincos ** 2, -1, keepdim=True), min=1e-12))
    frames = torsion_angles_to_frames(bb_frames_from_atom14(X), sincos, aatype)
    pred = frames_to_atom14_positions(frames, aatype)
    return torch.cat([X[..., :4, :], pred[..., 4:, :]], dim=-2)
