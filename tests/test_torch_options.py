"""The network options of ``NetworkConfig`` beyond the published
configuration, each against the JAX package on the CPU on the same weights:

* ``act``: the network with ``act="gelu"`` through the kernels' plain
  versions against the JAX network through its Pallas kernels in the same
  routing (interpret mode; in bf16 the in-kernel-geometry bodies run
  eagerly), and the unfused route against the JAX unfused path: float32
  1e-4, bf16 6e-2 (the limits of ``test_torch_network.py``); the encoder and
  the score decoder stay relu;
* ``static_edge_dtype``: the bf16 and int8 edge caches against the JAX
  package's (values within one step, the scale within 1e-6), and a 2-step
  sample within 0.01 rad of the float32 cache's with masked chis exactly 0
  (the JAX package's own bound, ``tests/test_atom_layout.py``);
* ``use_ipmp=False``: the vanilla stack against the JAX one through
  ``from_flax_params`` (float32 1e-4, bf16 6e-2), its sums divided by
  ``k_neighbors``;
* ``geometry_lanes`` and ``coalesce_gathers``: the same bits as without.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from packppi_tpu.data import stack_batch as jax_stack_batch
from packppi_tpu.models import ChiScoreNetwork as JaxChiScoreNetwork
from packppi_tpu.models import NetworkConfig as JaxNetworkConfig
from packppi_torch.data import stack_batch
from packppi_torch.models import ChiScoreNetwork, NetworkConfig, TorsionalDiffusion
from packppi_torch.structure import featurize, from_pdb_file
from packppi_torch.weights import from_flax_params, load_weights, read_state_dict

from conftest import FIXTURES, GOLDEN
from test_torch_routing import _noised, jax_kernels
from torch_threads import _threads  # noqa: F401 (autouse fixture)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from convert_checkpoint import convert_diffusion_state_dict  # noqa: E402

NETWORK_GOLDEN = os.path.join(GOLDEN, "network_golden.npz")
TOL = {"float32": 1e-4, "bfloat16": 6e-2}


@pytest.fixture(scope="module")
def feats():
    return featurize(from_pdb_file(os.path.join(FIXTURES, "1brs.pdb"), chain_id="D",
                                   mse_to_met=True))


@pytest.fixture(scope="module")
def weights():
    sd = {k: v.numpy() for k, v in read_state_dict(NETWORK_GOLDEN).items()}
    return sd, convert_diffusion_state_dict(sd)


def _port(cfg, sd, feats, sc, t_value=0.45):
    net = ChiScoreNetwork(cfg).eval()
    load_weights(net, sd)
    batch = stack_batch([feats], "cpu")
    t = torch.full(batch.residue_mask.shape, t_value)
    with torch.no_grad():
        s, h = net(batch, torch.from_numpy(sc), t)
    return s.numpy(), h.numpy()


def _jax(cfg, params, feats, sc, t_value=0.45):
    jb = jax_stack_batch([feats])
    t = jnp.full(jb.residue_mask.shape, t_value)
    with jax_kernels(cfg.compute_dtype):
        s, h = JaxChiScoreNetwork(cfg).apply(params, jb, jnp.asarray(sc), t)
    return np.asarray(s), np.asarray(h)


# route -> (port fields, JAX fields)
ROUTES = {"kernels": ({}, dict(fused_messages="geom_lanes", fused_chain=True)),
          "unfused": (dict(fused_messages=False, fused_chain=False), {})}
CASES = [(r, d) for r in ROUTES for d in ("float32", "bfloat16")]


@pytest.mark.parametrize("route,dtype", CASES, ids=[f"{r}-{d}" for r, d in CASES])
def test_gelu_network_matches_jax(feats, weights, route, dtype):
    sd, params = weights
    sc = _noised(feats)
    port_kw, jax_kw = ROUTES[route]
    s, h = _port(NetworkConfig(act="gelu", compute_dtype=dtype, **port_kw), sd, feats, sc)
    s_ref, h_ref = _jax(JaxNetworkConfig(act="gelu", compute_dtype=dtype, **jax_kw), params,
                        feats, sc)
    np.testing.assert_allclose(s, s_ref, atol=TOL[dtype], rtol=0)
    np.testing.assert_allclose(h, h_ref, atol=TOL[dtype], rtol=0)
    if dtype == "float32" and route == "kernels":
        relu, _ = _port(NetworkConfig(), sd, feats, sc)
        assert np.abs(relu - s).max() > 1e-3         # the stack's activation changed


def test_only_the_stack_takes_the_activation():
    net = ChiScoreNetwork(NetworkConfig(act="gelu"))
    layer = net.mpnn.mpnn_layers[0]
    assert (layer.node_message_fn.act, layer.edge_dense.act) == ("gelu", "gelu")
    assert net.decoder_score[0].act == net.decoder_score[2].act == "relu"


def _caches(cfg_kw, feats, weights):
    """The port's and the JAX package's ``encode_static`` edge caches."""
    sd, params = weights
    net = ChiScoreNetwork(NetworkConfig(**cfg_kw)).eval()
    load_weights(net, sd)
    with torch.no_grad():
        ours = net.encode_static(stack_batch([feats], "cpu")).h_E
    jnet = JaxChiScoreNetwork(JaxNetworkConfig(**cfg_kw))
    theirs = jnet.apply(params, jax_stack_batch([feats]), method=jnet.encode_static)[0]
    return ours, theirs


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_int8_edge_cache_matches_jax(feats, weights, compute):
    """One scale per channel over the whole batch, from h_E as the encoder
    gives it (in the compute dtype): the float32 h_E differs from JAX's by
    ~1e-6, so a code at a .5 boundary may round the other way, in at most
    1e-4 of the codes; under bf16 compute h_E is bf16, whose entries already
    differ by one bf16 step in 4.4e-4 of them, so at most 1e-3 there."""
    (q, scale), (jq, jscale) = _caches(dict(static_edge_dtype="int8", compute_dtype=compute),
                                       feats, weights)
    assert q.dtype == torch.int8 and scale.shape == (1, 1, 1, q.shape[-1])
    assert scale.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}[compute]
    np.testing.assert_allclose(scale.float().numpy(), np.asarray(jscale, np.float32), atol=1e-6,
                               rtol=0)
    d = np.abs(q.numpy().astype(np.int32) - np.asarray(jq).astype(np.int32))
    apart = 1e-4 if compute == "float32" else 1e-3
    assert d.max() <= 1 and (d > 0).mean() <= apart, (d.max(), (d > 0).mean())


def test_bf16_edge_cache_matches_jax_and_reads_back_as_float32(feats, weights):
    """The float32 h_E of the two packages differ by ~1e-6, so a value at a
    bf16 rounding boundary may round the other way: by one bf16 step, in at
    most 1e-3 of the entries (4.4e-4 read). A self edge's pair dihedrals are
    degenerate and differ by up to 3.4e-4 in float32 (1 entry of 409,600
    read): at most 1e-5 of the entries are further apart than one step, by
    at most 1e-3."""
    from packppi_torch.models.diffusion_net import StaticGraph

    h, jh = _caches(dict(static_edge_dtype="bfloat16"), feats, weights)
    assert h.dtype == torch.bfloat16
    got, want = h.float().numpy(), np.asarray(jh.astype(jnp.float32))
    step = np.maximum(np.abs(got), np.abs(want)) * 2.0 ** -7 + 1e-6
    d = np.abs(got - want)
    assert (d > 0).mean() <= 1e-3 and (d > step).mean() <= 1e-5, ((d > 0).mean(),
                                                                  (d > step).mean())
    assert (d <= np.maximum(step, 1e-3)).all(), d.max()
    static = StaticGraph(h, None, None)
    assert static.edges(torch.float32).dtype == torch.float32
    assert static.nbytes() == h.numel() * 2


def test_static_edge_dtype_sample_within_jax_bound(feats, weights):
    """A 2-step sample with the bf16 and int8 caches within 0.01 rad of the
    float32 cache's, with the same noise; masked chis stay exactly 0; the
    caches are 2x and ~4x smaller."""
    sd, _ = weights
    batch = stack_batch([feats], "cpu")
    outs, sizes = {}, {}
    for sdt in ("float32", "bfloat16", "int8"):
        model = TorsionalDiffusion(NetworkConfig(static_edge_dtype=sdt))
        load_weights(model.net, sd)
        with torch.no_grad():
            outs[sdt] = model.sample(batch, torch.Generator().manual_seed(3), n_steps=2).numpy()
            sizes[sdt] = model.net.eval().encode_static(batch).nbytes()
    m = batch.SC_D_mask.numpy() > 0
    for sdt in ("bfloat16", "int8"):
        assert np.abs(outs[sdt] - outs["float32"])[m].max() < 0.01
        assert (outs[sdt][~m] == 0).all()
    assert sizes["float32"] == 2 * sizes["bfloat16"] and sizes["int8"] < sizes["bfloat16"] // 1.9


def _vanilla_params(cfg, feats):
    """A JAX vanilla network's parameters from a seed (no reference
    checkpoint has a vanilla stack)."""
    jb = jax_stack_batch([feats])
    sc = jnp.zeros(jb.residue_mask.shape + (4,))
    t = jnp.full(jb.residue_mask.shape, 0.5)
    return JaxChiScoreNetwork(cfg).init(jax.random.key(4), jb, sc, t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vanilla_stack_matches_jax(feats, dtype):
    """``use_ipmp=False`` with ``k_neighbors`` 16 (the sums' divisor, not
    ``top_k``); the port's layer runs float32 as the dtype-less flax one."""
    kw = dict(use_ipmp=False, k_neighbors=16, num_mpnn_layers=2, compute_dtype=dtype)
    params = jax.tree_util.tree_map(np.asarray, _vanilla_params(JaxNetworkConfig(**kw), feats))
    sd = from_flax_params(params)
    assert {k.split(".")[3] for k in sd if k.startswith("mpnn.")} == {
        "node_message_fn", "node_dense", "edge_message_fn", "norm"}
    sc = _noised(feats)
    s, h = _port(NetworkConfig(**kw), sd, feats, sc)
    s_ref, h_ref = _jax(JaxNetworkConfig(**kw), params, feats, sc)
    np.testing.assert_allclose(s, s_ref, atol=TOL[dtype], rtol=0)
    np.testing.assert_allclose(h, h_ref, atol=TOL[dtype], rtol=0)
    if dtype == "float32":
        other, _ = _port(NetworkConfig(**{**kw, "k_neighbors": 32}), sd, feats, sc)
        assert np.abs(other - s).max() > 1e-4


def test_vanilla_configuration_launches_no_kernel():
    """The vanilla layer runs no kernel in any routing, so its configuration
    is allowed on the card at any width, also one the kernels are not built
    for (hidden_dim = 320: wgmma's N ends at 256); gelu is allowed too, and
    the kernels' own widths (hidden_dim = 64)."""
    wide = dict(hidden_dim=320, node_features=320, edge_features=320)
    assert not NetworkConfig(use_ipmp=False, fused_layers=True).runs_kernels()
    NetworkConfig(use_ipmp=False, **wide).check_device("cuda")
    NetworkConfig(act="gelu").check_device("cuda")
    NetworkConfig(hidden_dim=64, node_features=64, edge_features=64).check_device("cuda")
    with pytest.raises(ValueError, match="hidden_dim=320"):
        NetworkConfig(**wide).check_device("cuda")


@pytest.mark.parametrize("routing", [
    dict(fused_messages=False, fused_chain=False),
    dict(fused_messages=True, geometry_mode="local"),
    dict()], ids=["unfused", "local", "kernels"])
def test_layout_fields_change_no_value(feats, weights, routing):
    sd, _ = weights
    sc = _noised(feats)
    s, h = _port(NetworkConfig(**routing), sd, feats, sc)
    s2, h2 = _port(NetworkConfig(geometry_lanes=True, coalesce_gathers=True, **routing), sd,
                   feats, sc)
    np.testing.assert_array_equal(s, s2)
    np.testing.assert_array_equal(h, h2)
