"""The port's PackPPI-AP (``models.affinity``, ``data.skempi``, the affinity
weight mapping of ``weights``) against the JAX package and the reference's
``tests/golden/affinity_golden.npz``, on the CPU.

Tolerances. Against the reference golden: per-residue features 2e-3, ddG
5e-3 (the JAX package's own limits, ``tests/test_convert.py``). Against the
JAX ``AffinityNet`` on the same weights and inputs: 1e-4 (float32; the
port's message and chain passes are the plain versions of its kernels, the
JAX package's its unfused path). The SKEMPI functions: equal.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from packppi_tpu.data import skempi as jax_skempi
from packppi_tpu.models import NetworkConfig as JaxNetworkConfig
from packppi_tpu.models.affinity import AffinityNet as JaxAffinityNet
from packppi_tpu.models.affinity import local_subgraph_mask as jax_local_subgraph_mask
from packppi_tpu.structure import from_pdb_file as jax_from_pdb_file
from packppi_torch.data import skempi
from packppi_torch.models import NetworkConfig
from packppi_torch.models.affinity import AffinityNet, local_subgraph_mask
from packppi_torch.structure import from_pdb_file
from packppi_torch.weights import affinity_from_flax_params, load_weights

from conftest import FIXTURES, GOLDEN
from torch_threads import _threads  # noqa: F401 (autouse fixture)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from convert_checkpoint import convert_affinity_state_dict  # noqa: E402

SKEMPI_MINI = os.path.join(FIXTURES, "skempi_mini")
MUTS = ("KA25A", "DD35A")


@pytest.fixture(scope="module")
def golden():
    z = np.load(os.path.join(GOLDEN, "affinity_golden.npz"))
    sd = {k[4:]: z[k] for k in z.files if k.startswith("sd::")}
    return sd, {k: z[k] for k in z.files if not k.startswith("sd::")}


@pytest.fixture(scope="module")
def brs():
    path = os.path.join(FIXTURES, "1brs.pdb")
    return from_pdb_file(path, mse_to_met=True), jax_from_pdb_file(path, mse_to_met=True)


def _batches(brs, target_len=None):
    """The golden's mutation on 1BRS as the port's batch and the JAX one."""
    prot, jprot = brs
    muts = [skempi.parse_mutation(m) for m in MUTS]
    feats = skempi.skempi_features(prot, muts, ddg=4.85)
    jfeats = jax_skempi.skempi_features(jprot, [jax_skempi.parse_mutation(m) for m in MUTS],
                                        ddg=4.85)
    L = len(feats["residue_type"])
    return (skempi.stack_affinity_batch([feats], "cpu", target_len or L),
            jax_skempi.stack_affinity_batch([jfeats], target_len or L))


def test_local_subgraph_mask_matches_jax():
    """Padding rows, a batch row with more than the 32-mutation cap (the
    first 32 in residue order are used) and one with none."""
    rng = np.random.default_rng(0)
    B, L = 3, 120
    ca = (rng.normal(size=(B, L, 3)) * 12).astype(np.float32)
    rmask = np.ones((B, L), np.float32)
    rmask[:, 100:] = 0
    ca[:, 100:] = 0
    mut = np.zeros((B, L), np.int64)
    mut[0, [3, 50, 99]] = 1
    mut[1, rng.choice(100, 40, replace=False)] = 1
    ca[1, 40:] += 30.0      # the later mutations lie elsewhere: the cap shows
    for rm in (rmask, None):
        got = local_subgraph_mask(torch.from_numpy(ca), torch.from_numpy(mut),
                                  residue_mask=None if rm is None else torch.from_numpy(rm))
        want = jax_local_subgraph_mask(jnp.asarray(ca), jnp.asarray(mut), residue_mask=rm)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    full = local_subgraph_mask(torch.from_numpy(ca), torch.from_numpy(mut), max_mutations=L)
    assert not torch.equal(full[1], got[1]) and got[2].sum() == 0


def test_network_mode_reproduces_the_reference_golden(golden, brs):
    sd, ref = golden
    net = AffinityNet(NetworkConfig(), "network").eval()
    load_weights(net, sd)                                   # strict: all 116 keys
    assert len(sd) == 116
    batch, _ = _batches(brs)
    wild, mut = batch.wild(), batch.mutant()
    h_wt, h_mt = (torch.from_numpy(ref[k]) for k in ("h_pret_wt", "h_pret_mt"))
    with torch.no_grad():
        local = local_subgraph_mask(wild.X[:, :, 1], batch.mut_mask, residue_mask=wild.residue_mask)
        f_wt, f_mt = net.features(wild, mut, h_wt, h_mt, batch.mut_mask)
        ddg, ddg_inv = net(wild, mut, h_wt, h_mt, batch.mut_mask)
    np.testing.assert_array_equal(local.numpy(), ref["local_mask"])
    np.testing.assert_allclose(f_wt.numpy(), ref["h_wt"], atol=2e-3)
    np.testing.assert_allclose(f_mt.numpy(), ref["h_mt"], atol=2e-3)
    np.testing.assert_allclose(ddg.numpy(), ref["ddg"], atol=5e-3)
    np.testing.assert_allclose(ddg_inv.numpy(), ref["ddg_inv"], atol=5e-3)


def test_all_modes_match_the_jax_net(golden, brs):
    """network, linear and esm mode, strict parity on and off, on one
    weight set each, over a batch padded from 195 to 256 rows (so the pool
    mask matters)."""
    sd, ref = golden
    batch, jbatch = _batches(brs, target_len=256)
    pad = lambda a: np.pad(a, ((0, 0), (0, 256 - a.shape[1]), (0, 0)))
    h = {k: pad(ref[k]) for k in ("h_pret_wt", "h_pret_mt")}
    rng = np.random.default_rng(3)
    esm = {k: pad(rng.normal(size=(1, 195, 64)).astype(np.float32)) for k in h}
    head = {k: v for k, v in sd.items() if k.startswith("ddg_predictor.")}
    esm_head = {f"ddg_predictor.{i}.{p}": (rng.normal(size=(n, 64) if p == "weight" else n) / 8
                                          ).astype(np.float32)
                for i, n in ((0, 64), (2, 64), (4, 1)) for p in ("weight", "bias")}
    cases = {"network": (sd, h), "linear": (head, h), "esm": (esm_head, esm)}
    for mode, (weights, inputs) in cases.items():
        jparams = convert_affinity_state_dict({**sd, **weights})["params"]
        if mode != "network":
            jparams = {"DdgHead_0": jparams["DdgHead_0"]}
        assert set(affinity_from_flax_params(jparams)) == set(weights)
        # one compiled JAX function for both pools: compiling costs more than running
        both = jax.jit(lambda params, *a: [JaxAffinityNet(JaxNetworkConfig(), mode, strict).apply(
            params, a[0], a[1], a[2], a[3], a[4], True, a[5]) for strict in (True, False)])
        wants = both({"params": jparams}, jbatch.wild(), jbatch.mutant(),
                     jnp.asarray(inputs["h_pret_wt"]), jnp.asarray(inputs["h_pret_mt"]),
                     jnp.asarray(jbatch.mut_mask), jnp.asarray(jbatch.residue_mask))
        for strict, want in zip((True, False), wants):
            net = AffinityNet(NetworkConfig(), mode, strict, esm_dim=64).eval()
            load_weights(net, weights)
            wt, mt = (torch.from_numpy(inputs[k]) for k in ("h_pret_wt", "h_pret_mt"))
            with torch.no_grad():
                got = net(batch.wild(), batch.mutant(), wt, mt, batch.mut_mask,
                          batch.residue_mask)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                           err_msg=f"{mode} strict={strict}")


def test_vanilla_mutation_stack_matches_the_jax_net(brs):
    """``use_ipmp=False`` (and ``k_neighbors`` 16, the vanilla sums'
    divisor) in the mutation stack, with JAX-initialised weights through
    ``affinity_from_flax_params``; the activation (gelu) reaches the stack
    too."""
    batch, jbatch = _batches(brs)
    kw = dict(use_ipmp=False, k_neighbors=16, num_mpnn_layers=2, act="gelu")
    rng = np.random.default_rng(6)
    L = batch.mut_mask.shape[1]
    h = [rng.normal(size=(1, L, 128)).astype(np.float32) for _ in range(2)]
    args = (jbatch.wild(), jbatch.mutant(), *map(jnp.asarray, h), jnp.asarray(jbatch.mut_mask))
    jnet = JaxAffinityNet(JaxNetworkConfig(**kw), "network")
    params = jax.tree_util.tree_map(np.asarray, jnet.init(jax.random.key(1), *args))
    want = jnet.apply(params, *args)
    sd = affinity_from_flax_params(params)
    assert any(".node_message_fn." in k for k in sd)
    net = AffinityNet(NetworkConfig(**kw), "network").eval()
    load_weights(net, sd)
    with torch.no_grad():
        got = net(batch.wild(), batch.mutant(), *map(torch.from_numpy, h), batch.mut_mask)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


@pytest.mark.parametrize("mode", ["network", "linear"])
def test_cpu_predict_runs_its_passes_eagerly(brs, mode):
    """On the CPU ``predict`` runs eagerly: three passes (backbone on the
    wild type and the mutant, the mutation stack) counted as
    ``affinity_eager_passes``, no capture and no replay. The two pass
    functions, each run on only the fields it names as read (the others
    None, as in a graph's static copies), give the bits of the backbone
    and the net called as before they were split out."""
    from packppi_torch.device import static_copies
    from packppi_torch.models import affinity
    from packppi_torch.utils import trace
    from packppi_torch.weights import init_weights

    model = affinity.AffinityModel(NetworkConfig(node_features=32, edge_features=32,
                                                 hidden_dim=32, top_k=8), mode)
    init_weights(model.backbone.net, 0)
    init_weights(model.net, 1)
    batch, _ = _batches(brs, target_len=256)
    wild, mut = batch.wild(), batch.mutant()
    before = trace.engagement()
    with torch.no_grad():
        got = model.predict(batch)
    after = trace.engagement()
    want = {k: 0 for k in after}
    want["affinity_eager_passes"] = 3
    assert {k: after[k] - before[k] for k in after} == want
    with torch.no_grad():
        t = torch.zeros(wild.residue_mask.shape)
        h = [model.backbone.net(b, b.SC_D, t, skip_last_edge_update=True)[1] for b in (wild, mut)]
        split = model.net(wild, mut, *h, batch.mut_mask, wild.residue_mask)
        passes = [model._backbone_pass(static_copies(b, affinity._BACKBONE_READ))
                  for b in (wild, mut)]
        stack = model._mutation_pass(static_copies(batch, affinity._MUTATION_READ), *h)
    for a, b in zip((*got, *passes, *stack), (*split, *h, *split)):
        assert torch.equal(a, b)


def test_esm_loss_matches_jax():
    """The antisymmetric loss over embeddings, plain and weighted (a
    zero-weight row pads the batch)."""
    from packppi_tpu.models.affinity import AffinityModel as JaxAffinityModel
    from packppi_torch.models.affinity import AffinityModel

    rng = np.random.default_rng(8)
    wt, mt = (rng.normal(size=(3, 20, 16)).astype(np.float32) for _ in range(2))
    ddg = rng.normal(size=3).astype(np.float32)
    weights = np.array([1.0, 2.0, 0.0], np.float32)
    head = {f"Dense_{i}": {"kernel": rng.normal(size=(16, n)).astype(np.float32) / 4,
                           "bias": rng.normal(size=n).astype(np.float32) / 4}
            for i, n in ((0, 16), (1, 16), (2, 1))}
    model = AffinityModel(NetworkConfig(), "esm", esm_dim=16)
    load_weights(model.net, affinity_from_flax_params({"DdgHead_0": head}))
    # the esm losses read the net alone (``create`` would build the SO(2) tables)
    jmodel = JaxAffinityModel(None, JaxAffinityNet(JaxNetworkConfig(), "esm"), "esm")
    params = {"params": {"DdgHead_0": head}}
    for w in (None, weights):
        with torch.no_grad():
            got = model.loss_esm(*(torch.from_numpy(a) for a in (wt, mt, ddg)),
                                 None if w is None else torch.from_numpy(w))
        want = jmodel.loss_esm(params, jnp.asarray(wt), jnp.asarray(mt), jnp.asarray(ddg),
                               None if w is None else jnp.asarray(w))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_flax_tree_maps_onto_the_reference_names(golden):
    sd, _ = golden
    back = affinity_from_flax_params(convert_affinity_state_dict(sd))
    assert back.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)


@pytest.fixture(scope="module")
def entries():
    return (skempi.load_skempi_entries(SKEMPI_MINI, "PDBs"),
            jax_skempi.load_skempi_entries(SKEMPI_MINI, "PDBs"))


def test_skempi_entries_and_folds_match_jax(entries):
    ours, theirs = entries
    assert len(ours) == 126 and ours == theirs
    for folds, index, seed in ((2, 0, 42), (2, 1, 42), (3, 2, 7)):
        assert skempi.cv_split(ours, folds, index, seed) == jax_skempi.cv_split(
            theirs, folds, index, seed)


def test_skempi_features_and_batch_match_jax(entries, brs):
    ours, _ = entries
    picked = [e for e in ours if e["pdb_id"] == "2FTL"][:2] + [ours[0]]
    proteins = {p: (from_pdb_file(p, mse_to_met=True), jax_from_pdb_file(p, mse_to_met=True))
                for p in {e["pdb_path"] for e in picked}}
    multi = [skempi.parse_mutation(m) for m in MUTS]
    cases = [(proteins[e["pdb_path"]], e["mutations"], e["ddG"]) for e in picked]
    cases.append((brs, multi, 1.5))
    feats, jfeats = [], []
    for (prot, jprot), muts, ddg in cases:
        rt, am = skempi.apply_mutations(prot, muts)
        jrt, jam = jax_skempi.apply_mutations(jprot, muts)
        np.testing.assert_array_equal(rt, jrt)
        np.testing.assert_array_equal(am, jam)
        f = skempi.skempi_features(prot, muts, ddg=ddg)
        jf = jax_skempi.skempi_features(jprot, muts, ddg=ddg)
        assert f.keys() == jf.keys()
        for k in f:
            np.testing.assert_array_equal(f[k], jf[k], err_msg=k)
        feats.append(f)
        jfeats.append(jf)
    batch = skempi.stack_affinity_batch(feats[:2], "cpu")
    jbatch = jax_skempi.stack_affinity_batch(jfeats[:2])
    for name in skempi.AffinityBatch._fields:
        np.testing.assert_array_equal(getattr(batch, name).numpy(), getattr(jbatch, name),
                                      err_msg=name)
    assert batch.mut_mask.shape == (2, 384)
    for view in ("wild", "mutant"):
        for name, t in getattr(batch, view)()._asdict().items():
            np.testing.assert_array_equal(t.numpy(), getattr(getattr(jbatch, view)(), name))


@pytest.mark.parametrize("name,match", [("KA26A", "inconsistent"), ("KA999A", "not found")])
def test_apply_mutations_raises_where_jax_raises(brs, name, match):
    prot, jprot = brs
    muts = [skempi.parse_mutation(name)]
    with pytest.raises(ValueError, match=match):
        skempi.apply_mutations(prot, muts)
    with pytest.raises(ValueError, match=match):
        jax_skempi.apply_mutations(jprot, muts)
    rt, _ = skempi.apply_mutations(prot, muts, strict=False)
    np.testing.assert_array_equal(rt, prot.aaindex)
    np.testing.assert_array_equal(rt, jax_skempi.apply_mutations(jprot, muts, strict=False)[0])
