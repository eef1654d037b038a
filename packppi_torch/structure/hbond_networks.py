"""Joint flip/rotor optimization over interacting H-bond networks.

Reduce (the MolProbity hydrogen-placement step the reference relies on via
``molprobity.clashscore``; reference: src/utils/protein_analysis.py:26-34)
does not decide ASN/GLN/HIS flips and rotatable-H phases one group at a
time: it groups MOVABLE groups that interact into cliques and scores every
combination jointly, because one group's best orientation depends on its
neighbors' (two facing hydroxyls, an amide donating into a rotatable OH,
chained His/Asn networks). The per-group greedy in
:mod:`packppi_torch.structure.hydrogens` is blind to exactly these cases —
each rotor is scored only against the static heavy-atom cloud.

This module implements the joint pass:

1. enumerate movable groups — flip groups (2 states) and polar rotors
   (``n_phases`` states) — each as a list of per-state probe sets
   (position, radius, polar-H flag, acceptor flag);
2. score ``unary(g, s)`` against the static heavy atoms (movable flip
   atoms excluded — their contribution is state-dependent) and
   ``pair(g, h, s, t)`` between interacting groups' probes;
3. connected components of the interaction graph are solved exactly by
   enumeration when the joint state space is small, else by best-response
   coordinate descent from the greedy (unary-argmin) start — descent can
   only improve on greedy;
4. winners are applied: flip states as coordinate swaps, rotor phases as
   ``rotor_phase_overrides`` for :func:`hydrogens.add_hydrogens`.

Cost = Reduce-style score shared with the greedy passes: serious clashes
(>= 0.4 A interpenetration) dominate, total overlap breaks ties, and
polar-H vs acceptor overlap below the waiver cap is REWARDED (Reduce's
H-bond term) so clash-equivalent states resolve toward hydrogen bonding.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from packppi_torch.chem import ATOM14_NAMES
from packppi_torch.structure.hydrogens import (
    disulfide_cysteines,
    FLIP_GROUPS,
    H_BOND_LENGTH,
    H_SPEC,
    HBOND_OVERLAP_CAP,
    HBOND_REWARD_WEIGHT,
    SERIOUS_OVERLAP as SERIOUS,
    _rotor_phases,
    flip_group_hydrogens,
    heavy_graph,
    is_hbond_acceptor,
    probe_spike_measure,
    residue_names,
    scoring_environment,
)


class Probes(NamedTuple):
    """One state's movable atoms: [n, 3] positions plus per-atom flags."""

    pos: np.ndarray       # [n, 3]
    radius: np.ndarray    # [n]
    polar_h: np.ndarray   # [n] bool
    acceptor: np.ndarray  # [n] bool


@dataclasses.dataclass
class Group:
    kind: str                   # "flip" | "rotor"
    res: int
    states: list                # list[Probes]
    # flip: per-state [(atom14_slot, xyz)] to write back; rotor: phases list
    apply_info: object
    exclude_flat: set           # static heavy atoms this group never scores
    # parent heavies whose STATIC H this group never scores (rotors: within
    # 1 bond of the rotor parent — H-H bond distance <= 3; heavier exclusion
    # than exclude_flat would drop H at H-H distance 4, which Probe counts)
    exclude_flat_h: set = None


def _probe_cost(a: Probes, b: Probes) -> float:
    """Summed steric cost between two probe sets with H-bond handling.

    Overlapping pairs score the Probe spike measure
    (:func:`~packppi_torch.structure.hydrogens.probe_spike_measure`, the
    analytic dot-density limit of Probe's per-dot penetration scoring).
    Polar-H/acceptor overlap below the waiver cap is an H-bond: REWARDED at
    ``HBOND_REWARD_WEIGHT`` (Reduce's +4 H-bond vs -10 clash dot weights)
    and zeroed from the clash terms. Beyond the cap it counts as a clash
    again, exactly like the final clashscore's waiver — an uncapped
    exemption here would let the optimizer prefer states the metric then
    scores as clashes."""
    d = np.linalg.norm(a.pos[:, None] - b.pos[None], axis=-1)
    overlap = np.clip((a.radius[:, None] + b.radius[None]) - d, 0.0, None)
    spike = probe_spike_measure(a.radius[:, None], b.radius[None], d)
    exempt = ((a.polar_h[:, None] & b.acceptor[None]) |
              (b.polar_h[None] & a.acceptor[:, None])) & \
             (overlap < HBOND_OVERLAP_CAP)
    reward = HBOND_REWARD_WEIGHT * np.where(exempt, spike, 0.0).sum()
    overlap = np.where(exempt, 0.0, overlap)
    spike = np.where(exempt, 0.0, spike)
    return float(1000.0 * (overlap >= SERIOUS).sum() + spike.sum() - reward)


def _pair_table(ga: "Group", gb: "Group") -> np.ndarray:
    """[S, T] ``_probe_cost`` table over two groups' state grids in ONE
    broadcast evaluation (states of a group share atoms — only positions
    differ — so flags/radii stack from state 0). The per-state-pair Python
    calls this replaces were the hot path of the whole clashscore
    (5.4k tiny-array calls on T1124)."""
    pa = np.stack([s.pos for s in ga.states])            # [S, na, 3]
    pb = np.stack([s.pos for s in gb.states])            # [T, nb, 3]
    ra, rb = ga.states[0].radius, gb.states[0].radius
    d = np.linalg.norm(pa[:, None, :, None] - pb[None, :, None, :], axis=-1)
    overlap = np.clip((ra[:, None] + rb[None]) - d, 0.0, None)   # [S,T,na,nb]
    spike = probe_spike_measure(ra[:, None], rb[None], d)
    exempt = ((ga.states[0].polar_h[:, None] & gb.states[0].acceptor[None]) |
              (gb.states[0].polar_h[None] & ga.states[0].acceptor[:, None]))
    hb = exempt[None, None] & (overlap < HBOND_OVERLAP_CAP)
    reward = HBOND_REWARD_WEIGHT * np.where(hb, spike, 0.0).sum(axis=(2, 3))
    overlap = np.where(hb, 0.0, overlap)
    spike = np.where(hb, 0.0, spike)
    return (1000.0 * (overlap >= SERIOUS).sum(axis=(2, 3))
            + spike.sum(axis=(2, 3)) - reward)


def _movable_groups(prot, graph, n_phases: int) -> list[Group]:
    from packppi_torch.utils.metrics import (
        PROBE_H_POLAR_RADIUS, PROBE_H_RADIUS, PROBE_RADII)

    X = np.asarray(prot.atom_positions, np.float64)
    mask = np.asarray(prot.atom_mask).astype(bool)
    L = X.shape[0]
    resnames = residue_names(prot)
    _, _, _, flat_index, sep = graph
    ss_cys = disulfide_cysteines(prot)  # no HG rotor on half-cystines

    # parent -> heavy atoms within 1 / 2 bonds, built ONCE (a per-rotor scan
    # of the full sep table would be O(n_rotors * |sep|) host time)
    within2: dict[int, list[int]] = {}
    within1: dict[int, list[int]] = {}
    for (a, b), d in sep.items():
        if d <= 2:
            within2.setdefault(a, []).append(b)
            within2.setdefault(b, []).append(a)
            if d <= 1:
                within1.setdefault(a, []).append(b)
                within1.setdefault(b, []).append(a)

    groups: list[Group] = []
    for i in range(L):
        rn = resnames[i]
        if rn == "UNK":
            continue
        names = ATOM14_NAMES[rn]
        slot = {nm: s for s, nm in enumerate(names) if nm}
        coords = {nm: X[i, s] for nm, s in slot.items() if mask[i, s]}

        pairs = FLIP_GROUPS.get(rn)
        if pairs and all(a in coords and b in coords for a, b in pairs):
            group_names = [a for p in pairs for a in p]
            states, apply_info = [], []
            for flipped in (False, True):
                pos_of = dict(coords)
                if flipped:
                    for a, b in pairs:
                        pos_of[a], pos_of[b] = coords[b], coords[a]
                hpos, hpolar = [], []
                for h, polar in flip_group_hydrogens(rn, pos_of):
                    hpos.append(h)
                    hpolar.append(polar)
                heavy_pos = [pos_of[nm] for nm in group_names]
                states.append(Probes(
                    pos=np.asarray(heavy_pos + hpos).reshape(-1, 3),
                    radius=np.concatenate([
                        [PROBE_RADII.get(nm[0], 1.7) for nm in group_names],
                        [PROBE_H_POLAR_RADIUS if p else PROBE_H_RADIUS
                         for p in hpolar]]),
                    polar_h=np.concatenate([np.zeros(len(group_names), bool),
                                            np.asarray(hpolar, bool)]),
                    acceptor=np.concatenate([
                        [is_hbond_acceptor(rn, nm) for nm in group_names],
                        np.zeros(len(hpos), bool)]),
                ))
                apply_info.append([(slot[nm], pos_of[nm]) for nm in group_names])
            groups.append(Group("flip", i, states, apply_info,
                                exclude_flat={int(flat_index[i, s])
                                              for s in range(14)
                                              if flat_index[i, s] >= 0}))

        # polar rotors: OH/SH/NH3+ side chains + the N-terminal NH3+
        rotor_specs = [(heavy, n_h, refs) for heavy, n_h, geom, refs
                       in H_SPEC.get(rn, [])
                       if geom == "rot" and heavy[0] in "NOS"]
        first_in_chain = i == 0 or prot.chain_id[i] != prot.chain_id[i - 1] or (
            not mask[i - 1, 2]) or (mask[i, 0] and
                                    np.linalg.norm(X[i, 0] - X[i - 1, 2]) > 2.0)
        if rn != "PRO" and first_in_chain and all(k in coords for k in ("N", "CA", "C")):
            rotor_specs.append(("N", 3, ("CA", "C")))
        for heavy, n_h, refs in rotor_specs:
            if heavy not in coords or any(r not in coords for r in refs):
                continue
            if heavy == "SG" and i in ss_cys:
                continue  # disulfide-bonded SG carries no hydrogen
            parent_flat = int(flat_index[i, slot[heavy]])
            if parent_flat < 0:
                continue
            span = 2 * np.pi / 3 if n_h == 3 else 2 * np.pi
            phases = np.linspace(0, span, n_phases, endpoint=False)
            hs = _rotor_phases(coords[heavy], coords[refs[0]], coords[refs[1]],
                               H_BOND_LENGTH[heavy[0]], n_h, phases)
            states = [Probes(pos=hs[p].reshape(-1, 3),
                             radius=np.full(n_h, PROBE_H_POLAR_RADIUS),
                             polar_h=np.ones(n_h, bool),
                             acceptor=np.zeros(n_h, bool))
                      for p in range(len(phases))]
            # heavy atoms <= 2 bonds from the parent never score (H-heavy
            # distance <= 3); static H only when their parent is <= 1 bond
            # away (H-H distance <= 3) — same rule as the greedy path
            excl = {parent_flat, *within2.get(parent_flat, ())}
            excl_h = {parent_flat, *within1.get(parent_flat, ())}
            groups.append(Group("rotor", i, states,
                                ((i, slot[heavy]), phases), excl, excl_h))
    return groups


def optimize_hbond_networks(prot, graph=None, n_phases: int = 12,
                            cutoff: float = 4.0, max_enum: int = 4096,
                            n_passes: int = 20, static_h=None):
    """Jointly optimize interacting flip/rotor groups.

    Returns ``(new_prot, n_flipped, rotor_phases, info)`` where
    ``rotor_phases`` maps ``(res, heavy_slot) -> phase`` for every polar
    rotor that sat in a multi-group component (singletons keep the greedy
    path) and ``info`` records component sizes and solver modes.
    """
    from scipy.spatial import cKDTree

    graph = graph or heavy_graph(prot)
    _gc, names, res_of, flat_index, _sep = graph
    # environment = heavy atoms + STATIC hydrogens (fixed donors/contacts;
    # hydrogens.scoring_environment) — a group's acceptor near a fixed
    # backbone/ARG/TRP NH must score the H-bond REWARD, not a penalty on
    # the donor's heavy atom
    env = scoring_environment(prot, graph, static_h)
    coords, radii, acceptor = env["coords"], env["radii"], env["acceptor"]
    env_polar_h, res_idx = env["polar_h"], env["res"]
    env_parent, env_is_h = env["parent"], env["is_h"]

    groups = _movable_groups(prot, graph, n_phases)
    if not groups:
        return prot, 0, {}, {"components": []}

    # flip-movable heavy atoms are excluded from every unary environment —
    # their positions are state-dependent, so they only score in pair terms
    flip_movable: set = set()
    for g in groups:
        if g.kind == "flip":
            for s, _ in g.apply_info[0]:
                fi = int(flat_index[g.res, s])
                if fi >= 0:
                    flip_movable.add(fi)
    tree = cKDTree(coords)

    def unary_all(g: Group) -> np.ndarray:
        """[S] unary costs for every state in one broadcast evaluation.
        The environment is the union of all states' neighborhoods — atoms
        outside a particular state's reach contribute 0 overlap, so this
        equals the per-state query. Exclusions apply to an env atom's
        PARENT heavy index, covering static H attached to excluded/movable
        heavies."""
        allpos = np.concatenate([s.pos for s in g.states], 0)
        cand = sorted({j for row in tree.query_ball_point(allpos, cutoff)
                       for j in row})
        excl_h = g.exclude_flat_h if g.exclude_flat_h is not None else g.exclude_flat
        cand = [j for j in cand
                if int(env_parent[j]) not in
                (excl_h if env_is_h[j] else g.exclude_flat)
                and int(env_parent[j]) not in flip_movable
                and (g.kind == "rotor" or res_idx[j] != g.res)]
        S = len(g.states)
        if not cand:
            return np.zeros(S)
        ca = np.asarray(cand, np.int64)
        pa = np.stack([s.pos for s in g.states])              # [S, n, 3]
        d = np.linalg.norm(pa[:, :, None] - coords[ca][None, None], axis=-1)
        overlap = np.clip((g.states[0].radius[:, None] + radii[ca][None]) - d,
                          0.0, None)                          # [S, n, K]
        spike = probe_spike_measure(g.states[0].radius[:, None],
                                    radii[ca][None], d)
        # H-bonds in both directions: group polar H -> env acceptor, and
        # group acceptor <- env static polar H
        hb = ((g.states[0].polar_h[:, None] & acceptor[ca][None]) |
              (g.states[0].acceptor[:, None] & env_polar_h[ca][None]))[None] & \
            (overlap < HBOND_OVERLAP_CAP)
        reward = HBOND_REWARD_WEIGHT * np.where(hb, spike, 0.0).sum(axis=(1, 2))
        overlap = np.where(hb, 0.0, overlap)
        spike = np.where(hb, 0.0, spike)
        return (1000.0 * (overlap >= SERIOUS).sum(axis=(1, 2))
                + spike.sum(axis=(1, 2)) - reward)

    # interaction edges: any-state probe clouds within reach. ONE tree over
    # all clouds + query_pairs, then point-pairs map to group-pairs — the
    # per-pair query_ball_tree loop this replaces was O(n_groups^2) Python
    # tree-to-tree queries (same edge set, exact)
    clouds = [np.concatenate([s.pos for s in g.states], 0) for g in groups]
    n = len(groups)
    edges = [[] for _ in range(n)]
    if n > 1:
        labels = np.concatenate([np.full(len(c), gi, np.int64)
                                 for gi, c in enumerate(clouds)])
        cloud_tree = cKDTree(np.concatenate(clouds, 0))
        pp = cloud_tree.query_pairs(cutoff, output_type="ndarray")
        ga, gb = labels[pp[:, 0]], labels[pp[:, 1]]
        cross = ga != gb
        for a, b in set(zip(np.minimum(ga, gb)[cross].tolist(),
                            np.maximum(ga, gb)[cross].tolist())):
            edges[a].append(b)
            edges[b].append(a)

    # connected components
    comp_of = [-1] * n
    components: list[list[int]] = []
    for i in range(n):
        if comp_of[i] >= 0:
            continue
        stack, comp = [i], []
        comp_of[i] = len(components)
        while stack:
            u = stack.pop()
            comp.append(u)
            for v in edges[u]:
                if comp_of[v] < 0:
                    comp_of[v] = len(components)
                    stack.append(v)
        components.append(sorted(comp))

    unaries = {}
    assignment = {}
    info = {"components": []}
    for comp in components:
        if len(comp) == 1:
            gi = comp[0]
            # singleton rotors keep the greedy path (scored identically
            # there) — their unaries are never read, and most polar groups
            # are singletons, so skipping them removes the bulk of this
            # host hot path's work; singleton flips decide here by unary
            if groups[gi].kind == "flip":
                assignment[gi] = int(np.argmin(unary_all(groups[gi])))
            info["components"].append({"groups": [gi], "mode": "singleton"})
            continue
        for gi in comp:
            unaries[gi] = unary_all(groups[gi])

        pair_tab = {}
        for ai, a in enumerate(comp):
            for b in comp[ai + 1:]:
                if b in edges[a]:
                    pair_tab[(a, b)] = _pair_table(groups[a], groups[b])

        # capped product: np.prod wraps int64 for ~19+ twelve-state groups,
        # which could misroute a huge component into exact enumeration
        n_states = 1
        for g in comp:
            n_states *= len(groups[g].states)
            if n_states > max_enum:
                break
        if n_states <= max_enum:
            # exact enumeration as ONE broadcast tensor over the joint state
            # grid (axis per group): unaries and pair tables reshape onto
            # their axes; argmin (C order) picks the same first-minimum the
            # itertools.product scan did
            axes = {g: ax for ax, g in enumerate(comp)}
            shape = [len(groups[g].states) for g in comp]
            joint = np.zeros(shape)
            for g in comp:
                sh = [1] * len(comp)
                sh[axes[g]] = shape[axes[g]]
                joint += unaries[g].reshape(sh)
            for (a, b), tab in pair_tab.items():
                sh = [1] * len(comp)
                sh[axes[a]], sh[axes[b]] = tab.shape
                joint += tab.reshape(sh)
            combo = np.unravel_index(int(np.argmin(joint)), joint.shape)
            best = {g: int(combo[axes[g]]) for g in comp}
            mode = "enumerated"
        else:
            best = {g: int(np.argmin(unaries[g])) for g in comp}
            for _ in range(n_passes):
                changed = False
                for g in comp:
                    costs = unaries[g].copy()
                    for (a, b), tab in pair_tab.items():
                        if a == g:
                            costs = costs + tab[:, best[b]]
                        elif b == g:
                            costs = costs + tab[best[a], :]
                    s = int(np.argmin(costs))
                    if s != best[g]:
                        best[g] = s
                        changed = True
                if not changed:
                    break
            mode = "descent"
        assignment.update(best)
        # in descent mode n_states is only the partial product where the
        # overflow-guard loop broke, NOT the joint state-space size —
        # flag it so diagnostics don't read a wrong-by-orders number
        info["components"].append({"groups": list(comp), "mode": mode,
                                   "n_states": n_states,
                                   "n_states_capped": mode == "descent"})

    # apply winners
    X = np.array(prot.atom_positions, np.float64)
    n_flipped = 0
    rotor_phases = {}
    for gi, s in assignment.items():
        g = groups[gi]
        if g.kind == "flip":
            if s != 0:
                for slot_i, pos in g.apply_info[s]:
                    X[g.res, slot_i] = pos
                n_flipped += 1
        else:
            key, phases = g.apply_info
            rotor_phases[key] = float(phases[s])
    return (dataclasses.replace(prot, atom_positions=X), n_flipped,
            rotor_phases, info)
