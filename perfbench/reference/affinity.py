"""PackPPI-AP in network mode, in plain float32 PyTorch: the frozen chi
score network at t = 0 gives per-residue features of the wild type and the
mutant; a mutation encoder (no time channel) and IPMP stack of their own run
on the local subgraph (residues whose CA lies within 10 A of a mutated CA),
over [backbone features | encoder features | sequence embedding] fused by
two linear maps, plus a learned bias at the mutated sites; the ddG head
reads the maximum over all rows (padding included) of mutant minus wild
type, and its antisymmetric twin reads wild type minus mutant.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import chem, net
from perfbench.reference.structure import chi_angles


def parse_mutation(name: str) -> dict:
    """'KI15G': wild type K, chain I, residue 15, mutant G."""
    return {"wt": name[0], "chain": name[1], "resseq": int(name[2:-1]), "mt": name[-1]}


def mutant_features(parsed: dict, feats: dict, mutations: list) -> dict:
    """The mutant's twins of ``feats``: residue types and atom masks at the
    mutated sites, their chis zeroed, the chi mask measured on the
    wild-type coordinates with the mutant's atoms, and ``mut_mask``."""
    aatype = parsed["aatype"].copy()
    atom_mask = parsed["atom_mask"].copy()
    for m in mutations:
        sel = (parsed["chain"] == m["chain"]) & (parsed["resseq"] == m["resseq"])
        if not sel.any() or chem.RESTYPES[int(parsed["aatype"][sel][0])] != m["wt"]:
            raise ValueError(f"mutation {m} does not match the structure")
        aatype[sel] = chem.RESTYPES.index(m["mt"])
        names = chem.ATOM14_NAMES[chem.RESTYPE_1TO3[m["mt"]]]
        atom_mask[sel] = [1.0 if a else 0.0 for a in names]
    rm = feats["rmask"]
    mut = (parsed["aatype"] != aatype).astype(np.int64) * rm.astype(np.int64)
    sc, sc_sincos = feats["sc"].copy(), feats["sc_sincos"].copy()
    sc[mut.astype(bool)] = 0.0
    sc_sincos[mut.astype(bool)] = 0.0
    sc_mask = chi_angles(parsed["X"], aatype)[1] * rm[:, None]
    pi = chem.CHI_PI_PERIODIC[aatype].astype(bool)
    return {"aatype": aatype * rm.astype(np.int64),
            "atom_mask": np.nan_to_num(atom_mask * rm[:, None]).astype(np.float32),
            "sc": np.nan_to_num(sc), "sc_sincos": np.nan_to_num(sc_sincos), "sc_mask": sc_mask,
            "pi": sc_mask.astype(bool) & pi, "twopi": sc_mask.astype(bool) & ~pi, "mut": mut}


def local_mask(ca: torch.Tensor, mut: torch.Tensor, rmask: torch.Tensor, radius: float = 10.0):
    d = torch.sqrt(((ca[:, :, None] - ca[:, None]) ** 2).sum(-1) + 1e-12)
    return ((d < radius) & (mut[:, None, :] > 0)).any(-1).float() * rmask


def _side(p: net.Params, b: dict, local, bias):
    """The mutation stack's per-residue features of one side."""
    h_pret = net.score(p, b, b["sc"], torch.zeros_like(b["rmask"]))[1]
    h_E, idx = net.encode_edges(p, "mutation_encoder", b, local)
    h_mut = net.encode_nodes(p, "mutation_encoder", b, b["sc_sincos"] * b["sc_mask"][..., None])
    seq = p.state["seq_embedding.weight"][b["aatype"]]
    x = torch.cat([h_pret, h_mut, seq], -1)
    h = p.lin("mutation_fusion.2", F.relu(p.lin("mutation_fusion.0", x))) + bias
    mask_E = local[:, :, None] * net.gather(local, idx)
    return net.stack(p, "mutation_mpnn", h, h_E, idx, b["X"], local, mask_E)


def ddg(p: net.Params, wild: dict, mutant: dict, mut: torch.Tensor):
    """(ddg [B], ddg_inv [B]). ``wild`` and ``mutant`` are padded batches
    (``structure.batch``), ``mut`` [B, L] the mutated sites. The backbone's
    parameters are named as the score network's, the rest as PackPPI-AP's
    (``mutation_encoder.*``, ``mutation_mpnn.*``, ``seq_embedding``,
    ``mut_bias``, ``mutation_fusion.{0,2}``, ``ddg_predictor.{0,2,4}``)."""
    local = local_mask(wild["X"][:, :, 1], mut, wild["rmask"])
    flag = torch.clamp(mut, 0, 1)
    bias = p.state["mut_bias.weight"][flag] * (flag > 0)[..., None]
    h_wt, h_mt = _side(p, wild, local, bias), _side(p, mutant, local, bias)

    def head(x):
        x = F.relu(p.lin("ddg_predictor.0", x))
        return p.lin("ddg_predictor.4", F.relu(p.lin("ddg_predictor.2", x)))[..., 0]

    return head((h_mt - h_wt).amax(1)), head((h_wt - h_mt).amax(1))
