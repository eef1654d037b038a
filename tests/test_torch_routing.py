"""The port's score network in each of the five routings this slice adds --
``fused_messages="geom"`` and ``"geom_gather"``, ``FOLD_EDGE_CHAIN`` with
``"geom_lanes"``, ``fused_layers`` and ``geometry_mode="local"`` -- against
the JAX network in the same routing on the same converted weights (float32
1e-4, bf16 6e-2: the bound of ``test_torch_network.py``), the JAX kernels in
interpret mode as ``tests/test_model.py`` runs them; the 1BRS golden
trajectory under ``fused_layers`` and local geometry; local mode's cached
and uncached transforms and its agreement with global mode; and the
routing rules of ``NetworkConfig``.

In bf16 XLA:CPU cannot compile the interpreted lane-major kernels, so the
JAX network runs the in-kernel-geometry kernel bodies eagerly there
(``eager_entries`` of ``test_torch_message_variants.py``).
"""
import contextlib
import os
import sys
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import packppi_tpu.models.ipmp as jax_ipmp
import packppi_tpu.ops.pallas_layer as pallas_layer
from packppi_tpu.data import stack_batch as jax_stack_batch
from packppi_tpu.models import ChiScoreNetwork as JaxChiScoreNetwork
from packppi_tpu.models import NetworkConfig as JaxNetworkConfig
from packppi_tpu.models.ipmp import FactoredMessageMLP as JaxMessageMLP
import packppi_torch.models.ipmp as port_ipmp
from packppi_torch.data import stack_batch
from packppi_torch.models import ChiScoreNetwork, NetworkConfig, TorsionalDiffusion
from packppi_torch.structure import featurize, from_pdb_file
from packppi_torch.weights import load_weights, read_state_dict

from conftest import FIXTURES, GOLDEN
from test_torch_message_variants import eager_entries
from torch_threads import _threads  # noqa: F401 (autouse fixture)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from convert_checkpoint import convert_diffusion_state_dict  # noqa: E402

NETWORK_GOLDEN = os.path.join(GOLDEN, "network_golden.npz")
PIPELINE_GOLDEN = os.path.join(GOLDEN, "pipeline_golden.npz")

# routing -> (port NetworkConfig fields, JAX NetworkConfig fields, fold).
# The port's eval() always runs the chain kernel, so the JAX side runs its
# fused chain too.
ROUTINGS = {
    "geom": (dict(fused_messages="geom"), dict(fused_messages="geom", fused_chain=True), False),
    "geom_gather": (dict(fused_messages="geom_gather"),
                    dict(fused_messages="geom_gather", fused_chain=True), False),
    "fold": ({}, dict(fused_messages="geom_lanes", fused_chain=True), True),
    "fused_layers": (dict(fused_layers=True), dict(fused_layers=True), False),
    "local": (dict(fused_messages=True, geometry_mode="local"),
              dict(fused_messages=True, fused_chain=True, geometry_mode="local"), False),
}


@pytest.fixture(scope="module")
def feats():
    return featurize(from_pdb_file(os.path.join(FIXTURES, "1brs.pdb"), chain_id="D",
                                   mse_to_met=True))


@pytest.fixture(scope="module")
def weights():
    sd = {k: v.numpy() for k, v in read_state_dict(NETWORK_GOLDEN).items()}
    return sd, convert_diffusion_state_dict(sd)


@contextlib.contextmanager
def folded(fold: bool):
    """``FOLD_EDGE_CHAIN`` set on both sides for a block."""
    prev = port_ipmp.FOLD_EDGE_CHAIN, jax_ipmp.FOLD_EDGE_CHAIN
    port_ipmp.FOLD_EDGE_CHAIN = jax_ipmp.FOLD_EDGE_CHAIN = fold
    try:
        yield
    finally:
        port_ipmp.FOLD_EDGE_CHAIN, jax_ipmp.FOLD_EDGE_CHAIN = prev


@contextlib.contextmanager
def jax_kernels(dtype: str):
    """The JAX kernels on the CPU: interpret mode for every Pallas entry
    (``tests/test_model.py``'s patches), and in bf16 the in-kernel-geometry
    entries as their kernel bodies run eagerly."""
    def interpreted(name):
        orig = getattr(JaxMessageMLP, name)

        def patched(self, *args, **kw):
            kw["interpret"] = True
            return orig(self, *args, **kw)
        return mock.patch.object(JaxMessageMLP, name, patched)

    with contextlib.ExitStack() as stack:
        for name in ("__call__", "geom_fused", "geom_fused_gather", "geom_fused_lanes"):
            stack.enter_context(interpreted(name))
        if dtype == "bfloat16":
            stack.enter_context(eager_entries(round_hidden=False))
        stack.enter_context(mock.patch.object(pallas_layer, "INTERPRET", True))
        yield


def _port_forward(cfg, sd, feats, t_value, sc, fold=False, skip=False):
    net = ChiScoreNetwork(cfg).eval()
    load_weights(net, sd)
    batch = stack_batch([feats], "cpu")
    t = torch.full(batch.residue_mask.shape, float(t_value))
    with torch.no_grad(), folded(fold):
        s, h = net(batch, torch.from_numpy(sc), t, skip_last_edge_update=skip)
    return s.numpy(), h.numpy()


def _jax_forward(cfg, params, feats, t_value, sc, fold=False, skip=False):
    jb = jax_stack_batch([feats])
    t = jnp.full(jb.residue_mask.shape, t_value)
    with jax_kernels(cfg.compute_dtype), folded(fold):
        s, h = JaxChiScoreNetwork(cfg).apply(params, jb, jnp.asarray(sc), t,
                                             skip_last_edge_update=skip)
    return np.asarray(s), np.asarray(h)


def _noised(feats):
    rng = np.random.default_rng(2)
    jb = jax_stack_batch([feats])
    sc = np.zeros((1, jb.residue_mask.shape[1], 4), np.float32)
    sc[0, :len(feats["SC_D"])] = feats["SC_D"] + rng.normal(size=feats["SC_D"].shape)
    return sc


CASES = [(r, d) for r in ROUTINGS for d in ("float32", "bfloat16")]


@pytest.mark.parametrize("routing,dtype", CASES, ids=[f"{r}-{d}" for r, d in CASES])
def test_routing_matches_jax_network(feats, weights, routing, dtype):
    sd, params = weights
    port_kw, jax_kw, fold = ROUTINGS[routing]
    sc = _noised(feats)
    s, h = _port_forward(NetworkConfig(compute_dtype=dtype, **port_kw), sd, feats, 0.45, sc, fold)
    s_ref, h_ref = _jax_forward(JaxNetworkConfig(compute_dtype=dtype, **jax_kw), params, feats,
                                0.45, sc, fold)
    tol = 1e-4 if dtype == "float32" else 6e-2
    np.testing.assert_allclose(s, s_ref, atol=tol, rtol=0)
    np.testing.assert_allclose(h, h_ref, atol=tol, rtol=0)


def test_fused_layers_skip_last_edge_update_matches_jax(feats, weights):
    sd, params = weights
    sc = _noised(feats)
    s, h = _port_forward(NetworkConfig(fused_layers=True), sd, feats, 0.3, sc, skip=True)
    s_ref, h_ref = _jax_forward(JaxNetworkConfig(fused_layers=True), params, feats, 0.3, sc,
                                skip=True)
    np.testing.assert_allclose(s, s_ref, atol=1e-4, rtol=0)
    np.testing.assert_allclose(h, h_ref, atol=1e-4, rtol=0)
    s_all, h_all = _port_forward(NetworkConfig(fused_layers=True), sd, feats, 0.3, sc)
    np.testing.assert_array_equal(s, s_all)       # the skipped pass feeds nothing
    np.testing.assert_array_equal(h, h_all)


def test_local_mode_cache_and_agreement_with_global(feats, weights):
    """The cached relative transforms (``encode_static``) give the same
    network as transforms computed in the stack, and local mode agrees with
    global mode at the JAX package's limits (``tests/test_model.py``)."""
    sd, _ = weights
    batch = stack_batch([feats], "cpu")
    t = torch.full(batch.residue_mask.shape, 0.37)
    sc = torch.from_numpy(_noised(feats))
    nets = {}
    for name, kw in (("local", dict(fused_messages=True, geometry_mode="local")),
                     ("global", dict(fused_messages=True))):
        nets[name] = ChiScoreNetwork(NetworkConfig(**kw)).eval()
        load_weights(nets[name], sd)
    with torch.no_grad():
        static = nets["local"].encode_static(batch)
        assert static.rel is not None and static.rel[0].shape == (*static.idx.shape, 9)
        s_cached, _ = nets["local"](batch, sc, t, static=static)
        s_local, _ = nets["local"](batch, sc, t, static=static._replace(rel=None))
        s_global, _ = nets["global"](batch, sc, t)
    np.testing.assert_allclose(s_cached.numpy(), s_local.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(s_local.numpy(), s_global.numpy(), atol=2e-4, rtol=2e-3)


def test_local_mode_trains_through_the_unfused_path(feats, weights):
    """train() in local mode computes the transforms in the stack and runs
    the unfused message path; without dropout it gives eval()'s network."""
    sd, _ = weights
    net = ChiScoreNetwork(NetworkConfig(fused_messages=True, geometry_mode="local",
                                        dropout=0.0))
    load_weights(net, sd)
    batch = stack_batch([feats], "cpu")
    t = torch.full(batch.residue_mask.shape, 0.6)
    s_train, _ = net.train()(batch, batch.SC_D, t)
    s_train.sum().backward()
    layer0 = net.mpnn.mpnn_layers[0]           # its point projections feed the local geometry
    for lin in (layer0.points_fn_node, layer0.points_fn_edge):
        assert lin.weight.grad is not None and lin.weight.grad.abs().max() > 0
    with torch.no_grad():
        s_eval, _ = net.eval()(batch, batch.SC_D, t)
    np.testing.assert_allclose(s_train.detach().numpy(), s_eval.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("routing", ["fused_layers", "local"])
def test_golden_trajectory_under_routing(routing):
    """The 1BRS 30-step fixed-noise replay (``pipeline_golden.npz``) within
    5e-4 rad, as ``tests/test_torch_sampler.py`` holds the default."""
    golden = dict(np.load(PIPELINE_GOLDEN))
    feats = featurize(from_pdb_file(os.path.join(FIXTURES, "1brs.pdb"), mse_to_met=True))
    batch = stack_batch([feats], "cpu", target_len=len(feats["residue_type"]))
    model = TorsionalDiffusion(NetworkConfig(**ROUTINGS[routing][0]))
    load_weights(model.net, PIPELINE_GOLDEN)
    sc, traj = model.sample(batch, init_sc=golden["init_sc"], return_trajectory=True)
    mask = batch.SC_D_mask[0].numpy() > 0
    wrap = lambda d: np.minimum(np.abs(d), 2 * np.pi - np.abs(d))
    for s in range(traj.shape[0]):
        assert wrap(traj[s, 0].numpy() - golden["traj"][s, 0])[mask].max() < 5e-4, s
    assert wrap(sc[0].numpy() - golden["final_sc"][0])[mask].max() < 5e-4


@pytest.mark.parametrize("bad", [dict(fused_messages="geom"), dict(fused_messages="geom_gather"),
                                 dict(fused_messages="geom_lanes"),
                                 dict(fused_messages=True, fused_layers=True)],
                         ids=["geom", "geom_gather", "geom_lanes", "fused_layers"])
def test_local_mode_refuses_global_point_kernels(bad):
    with pytest.raises(ValueError, match="incompatible"):
        ChiScoreNetwork(NetworkConfig(geometry_mode="local", **bad))


def test_pack_cli_local_geometry_on_cpu(tmp_path):
    from packppi_torch.cli.pack import build_parser, run
    from packppi_torch.ops.message_feat import message_feat

    args = build_parser().parse_args([
        "--input", os.path.join(FIXTURES, "1brs.pdb"), "--outdir", str(tmp_path), "--device",
        "cpu", "--n_steps", "2", "--geometry", "local", "--ckpt", PIPELINE_GOLDEN])
    before = message_feat.launches
    run(args)
    out = from_pdb_file(tmp_path / "structure.pdb")
    assert np.isfinite(out.atom_positions[out.atom_mask > 0]).all()
    assert message_feat.launches == before          # the CPU runs the plain versions
