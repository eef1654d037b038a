"""PDB text -> atom14 arrays -> the padded feature tensors the reference
network reads.

Parsing rules (those of the PackPPI reference dataset): ATOM and HETATM
records of the first model, waters and non-standard residues dropped, MSE
read as MET, chains in sorted id order and residues in ascending number,
the altLoc of highest occupancy (the first on ties), a global offset of one
after every residue with an insertion code, duplicate numbers bumped to the
next free one. Features: backbone dihedrals (pre-omega, phi, psi), chi
angles with the mask ``chi != 0``, inter-chain residue offsets of the
previous chains' maxima plus 100.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import chem

BUCKETS = (64, 96, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096)


def bucket(n: int) -> int:
    for b in BUCKETS:
        if n <= b:
            return b
    return int(np.ceil(n / 1024) * 1024)


def parse_pdb(text: str) -> dict:
    """atom14 arrays of the first model: ``X`` [L, 14, 3] (NaN where absent),
    ``aatype``, ``atom_mask``, ``resseq`` (with insertion offsets),
    ``chain`` (ids)."""
    chains: dict = {}
    model, seen_model = 0, False
    for line in text.splitlines():
        rec = line[:6]
        if rec.startswith("MODEL"):
            model += seen_model
            seen_model = True
            continue
        if model != 0 or not (rec.startswith("ATOM") or rec == "HETATM"):
            continue
        try:
            resseq = int(line[22:26])
        except ValueError:
            continue
        name, resname, chain, icode = line[12:16].strip(), line[17:20].strip(), line[21], line[26]
        xyz = (float(line[30:38]), float(line[38:46]), float(line[46:54]))
        try:
            occ = float(line[54:60])
        except ValueError:
            occ = 1.0
        res = chains.setdefault(chain, {}).setdefault((resseq, icode), [resname, resseq, icode, {}])
        prev = res[3].get(name)
        if prev is None or occ > prev[1]:
            res[3][name] = (xyz, occ)

    X, aatype, mask, resseq, chain_ids = [], [], [], [], []
    offset = 0
    for cid in sorted(chains):
        for resname, num, icode, atoms in sorted(chains[cid].values(), key=lambda r: r[1]):
            if resname == "HOH":
                continue
            if resname == "MSE":
                resname = "MET"
                atoms = {("SD" if n == "SE" else n): v for n, v in atoms.items()}
            one = chem.RESTYPE_3TO1.get(resname)
            if one is None:
                continue
            if icode != " ":
                offset += 1
            names = chem.ATOM14_NAMES[resname]
            pos = np.full((14, 3), np.nan)
            m = np.zeros(14)
            for name, (xyz, _) in atoms.items():
                if name in names:
                    pos[names.index(name)] = xyz
                    m[names.index(name)] = 1.0
            if m.sum() < 0.5:
                continue
            X.append(pos)
            aatype.append(chem.RESTYPES.index(one))
            mask.append(m)
            resseq.append(num + offset)
            chain_ids.append(cid)
    used: dict = {}
    final = []
    for cid, n in zip(chain_ids, resseq):
        taken = used.setdefault(cid, set())
        while n in taken:
            n += 1
        taken.add(n)
        final.append(n)
    return {"X": np.array(X), "aatype": np.array(aatype, np.int64), "atom_mask": np.array(mask),
            "resseq": np.array(final, np.int64), "chain": np.array(chain_ids)}


def _unit(v):
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.nan_to_num(v / np.linalg.norm(v, axis=-1, keepdims=True))


def chain_dihedrals(p: np.ndarray) -> np.ndarray:
    """Dihedrals along a chain of points [..., M, 3] -> [..., M - 3]."""
    u = _unit(p[..., 1:, :] - p[..., :-1, :])
    u2, u1, u0 = u[..., :-2, :], u[..., 1:-1, :], u[..., 2:, :]
    n2, n1 = _unit(np.cross(u2, u1)), _unit(np.cross(u1, u0))
    with np.errstate(invalid="ignore"):
        cos = np.clip(np.sum(n2 * n1, -1), -1 + 1e-8, 1 - 1e-8)
        return np.sign(np.sum(u2 * n1, -1)) * np.arccos(cos)


def chi_angles(X: np.ndarray, aatype: np.ndarray):
    """[L, 4] chi angles and their mask (``chi != 0``)."""
    idx = chem.CHI_ATOMS[aatype]
    pts = np.take_along_axis(X, idx[..., None].repeat(3, -1), axis=-2)
    d = np.nan_to_num(chain_dihedrals(pts)) * chem.CHI_MASK[aatype]
    return d, (d != 0.0).astype(np.float32)


def featurize(p: dict) -> dict:
    """Unpadded float32 / int64 features of one parsed structure."""
    X = p["X"].astype(np.float32)
    aatype = p["aatype"]
    L = len(aatype)
    ids = list(dict.fromkeys(p["chain"].tolist()))
    chain_idx = np.array([ids.index(c) + 1 for c in p["chain"]], np.int64)
    ridx = p["resseq"].copy()
    offset = 0
    for k in range(1, len(ids)):
        offset += p["resseq"][chain_idx == k].max() + 100
        ridx[chain_idx == k + 1] += offset
    rmask = np.isfinite(X[:, :4].sum(axis=(-1, -2))).astype(np.float32)

    d = chain_dihedrals(X[:, :3].reshape(3 * L, 3))
    d = np.concatenate([[np.nan], d, [np.nan, np.nan]]).reshape(L, 3)   # phi, psi, omega
    consecutive = (ridx[1:] - 1 == ridx[:-1]).astype(np.float32)
    pre = np.concatenate([[0.0], consecutive])
    post = np.concatenate([consecutive, [0.0]])
    bb = np.stack([np.concatenate([[np.nan], d[:-1, 2]]), d[:, 0], d[:, 1]], -1)
    bb_mask = np.stack([pre, pre, post], -1) * np.isfinite(bb)
    sc, sc_mask = chi_angles(X, aatype)
    pi = chem.CHI_PI_PERIODIC[aatype].astype(bool)
    rm = rmask
    out = {
        "X": X * rm[:, None, None], "atom_mask": p["atom_mask"] * rm[:, None],
        "aatype": aatype * rm.astype(np.int64), "rmask": rm,
        "ridx": ridx * rm.astype(np.int64), "chain": chain_idx * rm.astype(np.int64),
        "bb": bb * rm[:, None], "bb_mask": bb_mask * rm[:, None],
        "sc": sc * rm[:, None], "sc_mask": sc_mask * rm[:, None],
        "pi": (sc_mask * rm[:, None]).astype(bool) & pi,
        "twopi": (sc_mask * rm[:, None]).astype(bool) & ~pi,
    }
    out = {k: np.nan_to_num(v) if v.dtype.kind == "f" else v for k, v in out.items()}
    out["bb_sincos"] = np.stack([np.sin(out["bb"]), np.cos(out["bb"])], -1) * out["bb_mask"][..., None]
    out["sc_sincos"] = np.stack([np.sin(out["sc"]), np.cos(out["sc"])], -1) * out["sc_mask"][..., None]
    return out


def batch(feats: list, L: int, device) -> dict:
    """Pad each structure to ``L`` residues and stack: float32 / int64 /
    bool tensors on ``device``."""
    out = {}
    for k in feats[0]:
        arr = np.stack([np.pad(f[k], [(0, L - len(f[k]))] + [(0, 0)] * (f[k].ndim - 1))
                        for f in feats])
        if arr.dtype.kind == "f":
            arr = arr.astype(np.float32)
        elif arr.dtype.kind in "iu":
            arr = arr.astype(np.int64)
        out[k] = torch.from_numpy(arr).to(device)
    return out
