"""Packing-quality and ddG metrics (host-side numpy).

The chi accuracy and absolute-error definitions replicate the reference's,
including the quirks that must stay for comparability: accuracy requires
``chi_diff > 0`` (exact matches are excluded), and AE is the raw |diff|
folded over 2pi (and over pi for pi-periodic chis).
"""
from __future__ import annotations

import numpy as np


def _np(a):
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def spearman(p, y) -> float:
    """Spearman's rho with average ranks for ties (SKEMPI's ddG labels are
    heavily tied; distinct ranks for equal values would move the result)."""
    from scipy.stats import rankdata

    return float(np.corrcoef(rankdata(_np(p)), rankdata(_np(y)))[0, 1])


def chi_metrics(sc_true, sc_pred, sc_mask, pi_periodic_mask,
                interface_mask=None, prefix: str = "chi",
                strict_parity: bool = True):
    """Per-chi accuracy (<20 deg) and absolute error.

    Args: all [*, L, 4] except interface_mask [*, L] (tensors or arrays).
    Returns dict of scalars (+ total_acc / interface_acc).

    ``strict_parity=True`` (default) replicates the reference accuracy bit
    for bit, including its two quirks: the raw UNFOLDED |pred - true| is
    thresholded (so -3.13 vs +3.13 rad, a 1.5 deg error across the periodic
    boundary, counts as wrong), and ``diff > 0`` excludes exact matches
    (which doubles as the implicit padding mask: padded chis have diff ==
    0). ``strict_parity=False`` scores the periodicity-FOLDED error against
    the 20-deg threshold, counts exact matches as correct, and masks padding
    explicitly. AE is identical in both modes.
    """
    sc_true = _np(sc_true).astype(np.float64)
    sc_pred = _np(sc_pred).astype(np.float64)
    sc_mask = _np(sc_mask)
    pi_mask = _np(pi_periodic_mask).astype(bool)

    out = {}
    total_acc = 0.0
    interface_acc = 0.0
    for i in range(4):
        diff = np.abs(sc_pred[..., i] - sc_true[..., i])
        n = sc_mask[..., i].sum()
        n = 1.0 if n == 0 else n

        ae = np.minimum(diff, 2 * np.pi - diff)
        ae_folded = np.minimum(ae, np.pi - ae)
        ae = np.where(pi_mask[..., i], ae_folded, ae)
        if strict_parity:
            acc = ((diff * 180 / np.pi < 20) & (diff > 0)).astype(np.float64)
        else:
            acc = (ae * 180 / np.pi < 20) * np.asarray(sc_mask[..., i], np.float64)

        out[f"{prefix}_{i}_ae_rad"] = ae.sum() / n
        out[f"{prefix}_{i}_ae_deg"] = ae.sum() / n * 180 / np.pi
        out[f"{prefix}_{i}_acc"] = acc.sum() / n
        total_acc += acc.sum() / n

        if interface_mask is not None:
            im = _np(interface_mask)
            ni = (sc_mask[..., i] * im).sum()
            ni = 1.0 if ni == 0 else ni
            interface_acc += (acc * im).sum() / ni
    out["total_acc"] = total_acc / 4
    if interface_mask is not None:
        out["interface_acc"] = interface_acc / 4
    return out
