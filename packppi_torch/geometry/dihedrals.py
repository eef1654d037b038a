"""Dihedral-angle math.

Two sign conventions, both kept from the reference for parity:

* ``dihedrals_along_chain``: the featurization convention, sign from
  ``sign(u_i . n_{i+1})``;
* ``dihedral_from_four_points``: the encoder's pairwise-dihedral convention.
"""
from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def wrap_angle(x: torch.Tensor) -> torch.Tensor:
    """Wrap to [-pi, pi)."""
    return torch.remainder(x + math.pi, TWO_PI) - math.pi


def _safe_normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    # zero vectors normalize to zero without intermediate NaNs
    n = torch.sqrt(torch.sum(v * v, -1, keepdim=True))
    return torch.where(n > eps, v, torch.zeros_like(v)) / torch.clamp(n, min=eps)


def dihedrals_along_chain(points: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Dihedrals over a chain of points [..., M, 3] -> [..., M-3]; the k-th
    dihedral is about the bond (k+1, k+2)."""
    u = _safe_normalize(points[..., 1:, :] - points[..., :-1, :])
    u2, u1, u0 = u[..., :-2, :], u[..., 1:-1, :], u[..., 2:, :]
    n2 = _safe_normalize(torch.linalg.cross(u2, u1, dim=-1))
    n1 = _safe_normalize(torch.linalg.cross(u1, u0, dim=-1))
    cos_d = torch.clamp(torch.sum(n2 * n1, -1), -1 + eps, 1 - eps)
    return torch.sign(torch.sum(u2 * n1, -1)) * torch.arccos(cos_d)


def dihedral_from_four_points(p0, p1, p2, p3):
    """Dihedral defined by points p0-p1-p2-p3 (encoder convention).

    The reference takes arccos of the unclamped normal dot product, so
    rounding past +/-1 at degenerate normals gives NaN -> 0; this returns 0
    exactly there and clamps elsewhere.
    """
    axis = p2 - p1
    v1 = p0 - p1
    v2 = p3 - p2
    axis, v1, v2 = torch.broadcast_tensors(axis, v1, v2)
    n1 = _safe_normalize(torch.linalg.cross(axis, v1, dim=-1))
    n2 = _safe_normalize(torch.linalg.cross(axis, v2, dim=-1))
    sign = torch.sign(torch.sum(torch.linalg.cross(v1, v2, dim=-1) * axis, -1))
    dot = torch.sum(n1 * n2, -1)
    d = sign * torch.arccos(torch.clamp(dot, -1.0, 1.0))
    return torch.where(dot.abs() > 1.0, torch.zeros_like(d), torch.nan_to_num(d))
