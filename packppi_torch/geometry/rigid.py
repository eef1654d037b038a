"""Rigid transforms as a (rotation, translation) pair of tensors.

Rotation matrices hold basis vectors in COLUMNS: ``rot @ p_local + trans``
maps local to global coordinates. Frames from three points use the legacy
axis convention of the reference checkpoints: for backbone atoms (N, CA, C)
the x-axis points CA->C and the y-axis is the Gram-Schmidt remainder of
CA->N.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Rigid(NamedTuple):
    rot: torch.Tensor    # [..., 3, 3]
    trans: torch.Tensor  # [..., 3]


def compose(a: Rigid, b: Rigid) -> Rigid:
    """a then b in a's frame: x -> a(b(x))."""
    rot = a.rot @ b.rot
    trans = (a.rot @ b.trans[..., None])[..., 0] + a.trans
    return Rigid(rot, trans)


def rigid_apply(r: Rigid, points: torch.Tensor) -> torch.Tensor:
    """Map local points [..., 3] into the global frame."""
    return (r.rot @ points[..., None])[..., 0] + r.trans


def invert_apply(r: Rigid, points: torch.Tensor) -> torch.Tensor:
    """Map global points into the local frame (rotation transpose)."""
    return (r.rot.transpose(-1, -2) @ (points - r.trans)[..., None])[..., 0]


def invert(r: Rigid) -> Rigid:
    rot_t = r.rot.transpose(-1, -2)
    return Rigid(rot_t, -(rot_t @ r.trans[..., None])[..., 0])


def scale_translation(r: Rigid, factor: float) -> Rigid:
    return Rigid(r.rot, r.trans * factor)


def from_4x4(m: torch.Tensor) -> Rigid:
    return Rigid(m[..., :3, :3], m[..., :3, 3])


def rigid_from_3_points(p_a: torch.Tensor, origin: torch.Tensor, p_b: torch.Tensor,
                        eps: float = 1e-8) -> Rigid:
    """x-axis: origin->p_b (normalized); y-axis: origin->p_a orthogonalized
    against x; z = x × y. Origin is the translation."""
    e0 = p_b - origin
    e1 = p_a - origin
    e0 = e0 / torch.sqrt(torch.sum(e0 * e0, -1, keepdim=True) + eps)
    e1 = e1 - e0 * torch.sum(e0 * e1, -1, keepdim=True)
    e1 = e1 / torch.sqrt(torch.sum(e1 * e1, -1, keepdim=True) + eps)
    e2 = torch.linalg.cross(e0, e1, dim=-1)
    return Rigid(torch.stack([e0, e1, e2], dim=-1), origin)


def bb_frames_from_atom14(X: torch.Tensor) -> Rigid:
    """Backbone frames from atom14 coordinates [..., 14, 3] (N=0, CA=1, C=2)."""
    return rigid_from_3_points(X[..., 0, :], X[..., 1, :], X[..., 2, :])
