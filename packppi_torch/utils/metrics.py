"""Packing-quality and ddG metrics (host-side numpy).

The chi accuracy and absolute-error definitions replicate the reference's,
including the quirks that must stay for comparability: accuracy requires
``chi_diff > 0`` (exact matches are excluded), AE is the raw |diff|
folded over 2pi (and over pi for pi-periodic chis), and 'atom_rmsd' is a
mean squared deviation (no square root).

``probe_clashscore`` is the H-aware clashscore (hydrogens placed, Probe's
contact rules), host code; ``approx_clashscore`` is a heavy-atom count over
the clash loss's plain pair terms, on whatever device its tensors are on.
The MolProbity binary itself is wrapped in ``utils.analysis``.
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


def mean_squared_atom_deviation(true_coords, pred_coords, atom_mask, residue_mask,
                                eps: float = 1e-6, strict_parity: bool = True):
    """The reference's 'atom_rmsd' (``strict_parity=True``, default): mean
    squared deviation over real atoms with NO square root, and an eps added
    per ELEMENT of the mask — the denominator grows with the padded tensor
    size, so the value depends on the padding bucket (reference:
    src/models/TorsionalDiffusion.py:303). A Python float in both modes.

    ``strict_parity=False``: a true RMSD — sqrt of the squared deviation
    averaged over exactly the real (masked) atoms; padding-invariant.
    """
    m = np.asarray(atom_mask) * np.asarray(residue_mask)[..., None]
    sq = ((np.asarray(true_coords) - np.asarray(pred_coords)) ** 2).sum(-1) * m
    if strict_parity:
        return float(sq.sum() / (m + eps).sum())
    return float(np.sqrt(sq.sum() / max(m.sum(), 1.0)))


PROBE_RADII = {"C": 1.70, "N": 1.625, "O": 1.480, "S": 1.782, "P": 1.871}
PROBE_H_RADIUS = 1.17       # H bonded to carbon (Word et al. 1999 e-cloud radii)
PROBE_H_POLAR_RADIUS = 1.05  # H bonded to N/O/S
# single source of truth shared with the H-placement orientation scorers —
# the optimizer must optimize exactly the objective this metric measures
from packppi_torch.structure.hydrogens import (  # noqa: E402
    HBOND_OVERLAP_CAP, SERIOUS_OVERLAP)


def probe_clashscore(prot, overlap: float = SERIOUS_OVERLAP,
                     hbond_overlap_cap: float = HBOND_OVERLAP_CAP) -> float:
    """H-aware clashscore: serious steric overlaps per 1000 atoms,
    Probe/MolProbity semantics (reference shells out to
    ``molprobity.clashscore keep_hydrogens=True``,
    src/utils/protein_analysis.py:26-34; here computed natively).

    Steps: place ideal hydrogens (structure.hydrogens, the Reduce step),
    then count unique atom pairs whose van-der-Waals shells interpenetrate
    by >= ``overlap`` A using Probe's e-cloud radii — excluding pairs within
    3 bonds of each other (incl. the peptide C-N link and disulfides) and
    hydrogen-bond donor-H/acceptor contacts, which Probe scores as H-bonds
    rather than clashes. Denominator counts ALL atoms including the placed
    hydrogens, as MolProbity does.

    Pure numpy with a KD-tree (scipy); metric-time host code.
    """
    from packppi_torch.chem import RESTYPE_1TO3
    from packppi_torch.structure.hbond_networks import optimize_hbond_networks
    from packppi_torch.structure.hydrogens import (
        add_hydrogens, heavy_graph, is_hbond_acceptor, static_hydrogen_probes)

    # Reduce step 1: ASN/GLN/HIS flips + polar-rotor phases decided JOINTLY
    # over interacting H-bond networks (shares the graph; only coordinates
    # change, so the bond topology carries over). Static hydrogens (fixed
    # donors/contacts) are computed ONCE and shared by every orientation
    # scorer — their positions never depend on flips (flip-group H are
    # excluded from the static set) or rotor phases.
    graph = heavy_graph(prot)
    coords_arr, names, res_of, flat_index, heavy_dist = graph
    static_h = static_hydrogen_probes(prot, flat_index)
    prot, n_flipped, rotor_phases, _ = optimize_hbond_networks(
        prot, graph=graph, static_h=static_h)
    if n_flipped:
        valid = flat_index >= 0
        coords_arr = np.array(coords_arr)
        coords_arr[flat_index[valid]] = np.asarray(prot.atom_positions,
                                                   np.float64)[valid]
        graph = (coords_arr, names, res_of, flat_index, heavy_dist)
    coords = list(coords_arr)
    radii = [PROBE_RADII.get(nm[0], 1.7) for nm in names]
    resname_of = [RESTYPE_1TO3.get(_safe_restype(prot.aaindex[r]), "UNK")
                  for r in res_of]
    acceptor = [is_hbond_acceptor(rn, nm) for rn, nm in zip(resname_of, names)]
    n_heavy = len(coords)

    # ---- append hydrogens: network-decided rotor phases pinned, remaining
    # (singleton) rotors greedy-optimized against the heavy cloud
    hyd = add_hydrogens(prot, optimize_rotors=True, graph=graph, static_h=static_h,
                        rotor_phase_overrides=rotor_phases)
    h_parent = [int(flat_index[r, s]) for r, s in
                zip(hyd["parent_res"], hyd["parent_slot"])]
    all_coords = np.concatenate([np.asarray(coords).reshape(-1, 3),
                                 hyd["positions"]], 0)
    all_radii = np.concatenate([
        np.asarray(radii),
        np.where(hyd["polar"], PROBE_H_POLAR_RADIUS, PROBE_H_RADIUS)])
    n_all = len(all_coords)
    is_h = np.arange(n_all) >= n_heavy
    parent = np.concatenate([np.arange(n_heavy), np.asarray(h_parent, np.int64)])
    is_polar_h = np.concatenate([np.zeros(n_heavy, bool), hyd["polar"]])
    is_acceptor = np.concatenate([np.asarray(acceptor, bool),
                                  np.zeros(len(h_parent), bool)])

    # ---- vectorized pair sweep (KD-tree candidates, array filters) ------
    from scipy.spatial import cKDTree

    # max contact distance: two largest shells minus the overlap threshold
    r_max = 2 * float(all_radii.max()) - overlap + 1e-3
    pairs = cKDTree(all_coords).query_pairs(r_max, output_type="ndarray")
    if len(pairs) == 0:
        return 0.0
    a, b = pairs[:, 0], pairs[:, 1]  # a < b, each unordered pair once
    gap = (np.linalg.norm(all_coords[a] - all_coords[b], axis=-1)
           - (all_radii[a] + all_radii[b]))
    sel = gap <= -overlap
    a, b, gap = a[sel], b[sel], gap[sel]

    # bond-path distance via the heavy-bond table (shared vectorized lookup)
    from packppi_torch.structure.hydrogens import encode_bond_sep, lookup_bond_sep

    pa, pb = parent[a], parent[b]
    enc_keys, enc_vals = encode_bond_sep(heavy_dist, n_heavy)
    base = lookup_bond_sep(enc_keys, enc_vals, np.minimum(pa, pb),
                           np.maximum(pa, pb), n_heavy)
    base[pa == pb] = 0
    bond_sep = base + is_h[a].astype(np.int64) + is_h[b].astype(np.int64)

    # H-bond exemption: polar H against an acceptor scores as an H-bond, not
    # a clash — but only up to a plausible H-bond interpenetration; deeper
    # overlap at a donor/acceptor contact is still a clash (Probe counts
    # severe penetration at H-bond sites)
    hbond = ((is_polar_h[a] & is_acceptor[b]) | (is_polar_h[b] & is_acceptor[a]))
    waived = hbond & (-gap < hbond_overlap_cap)

    n_clashes = int(np.count_nonzero((bond_sep > 3) & ~waived))
    return 1000.0 * n_clashes / max(n_all, 1)


def _safe_restype(idx):
    from packppi_torch.chem import RESTYPES
    return RESTYPES[idx] if idx < len(RESTYPES) else "?"


def approx_clashscore(positions, atom_exists, residue_type, residue_index,
                      overlap: float = 0.4, block: int = 128) -> float:
    """Serious steric overlaps (>= ``overlap`` A vdW interpenetration) per
    1000 atoms: a heavy-atom approximation of the MolProbity clashscore,
    over the plain pair terms of the clash loss (``ops.clash.pair_errors``),
    row-blocked, on the device of ``positions``. A pair counts where its
    error is positive, which the kernels' per-atom sums cannot tell.

    positions [B, L, 14, 3], atom_exists [B, L, 14], residue_type and
    residue_index [B, L] (tensors or arrays).
    """
    import torch

    from packppi_torch.geometry.frames import chem_table
    from packppi_torch.ops.clash import pair_errors

    positions = torch.as_tensor(positions, dtype=torch.float32)
    dev = positions.device
    atom_exists = torch.as_tensor(atom_exists, dtype=torch.float32, device=dev)
    residue_type = torch.as_tensor(residue_type, dtype=torch.int64, device=dev)
    residue_index = torch.as_tensor(residue_index, dtype=torch.int64, device=dev)

    radius = chem_table("vdw_radius_atom14", dev)[residue_type] * atom_exists
    count = 0
    with torch.no_grad():
        for s in range(0, positions.shape[1], block):
            sl = slice(s, s + block)
            err, _ = pair_errors(positions[:, sl], atom_exists[:, sl], radius[:, sl],
                                 residue_index[:, sl], positions, atom_exists, radius,
                                 residue_index, tol_soft=overlap)
            count += int((err > 0).sum())
    # the symmetric form visits every pair from both of its atoms
    n_atoms = float(atom_exists.sum())
    return 1000.0 * (count // 2) / max(n_atoms, 1.0)
