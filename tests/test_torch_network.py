"""The port's score network on the CPU: against the reference activations
in ``network_golden.npz``, against the JAX ``ChiScoreNetwork`` on the same
converted weights, and through ``from_flax_params`` on a JAX init tree."""
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
from packppi_torch.models import ChiScoreNetwork, NetworkConfig
from packppi_torch.structure import featurize, from_pdb_file
from packppi_torch.weights import from_flax_params, load_weights, read_state_dict

from conftest import FIXTURES, GOLDEN
from torch_threads import _threads  # noqa: F401 (autouse fixture)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from convert_checkpoint import convert_diffusion_state_dict  # noqa: E402

NETWORK_GOLDEN = os.path.join(GOLDEN, "network_golden.npz")


@pytest.fixture(scope="module")
def feats():
    return featurize(from_pdb_file(os.path.join(FIXTURES, "1brs.pdb"), chain_id="D",
                                   mse_to_met=True))


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(NETWORK_GOLDEN))


def _port(cfg, state):
    net = ChiScoreNetwork(cfg).eval()
    load_weights(net, state)
    return net


def _forward(net, batch, t_value, sc=None):
    t = torch.full(batch.residue_mask.shape, float(t_value))
    with torch.no_grad():
        return net(batch, batch.SC_D if sc is None else sc, t)


def _jax_forward(cfg, params, feats, t_value, sc=None):
    jb = jax_stack_batch([feats])
    t = jnp.full(jb.residue_mask.shape, t_value)
    s, h = JaxChiScoreNetwork(cfg).apply(params, jb, jnp.asarray(jb.SC_D if sc is None else sc), t)
    return np.asarray(s), np.asarray(h)


def test_port_reproduces_reference_activations(feats, golden):
    batch = stack_batch([feats], "cpu", target_len=len(feats["residue_type"]))
    score, h = _forward(_port(NetworkConfig(), NETWORK_GOLDEN), batch, golden["t_value"])
    np.testing.assert_allclose(h.numpy(), golden["h_out"], atol=2e-3)
    np.testing.assert_allclose(score.numpy(), golden["score"], atol=2e-3)


def test_port_matches_jax_network_on_converted_weights(feats, golden):
    sd = {k: v.numpy() for k, v in read_state_dict(NETWORK_GOLDEN).items()}
    params = convert_diffusion_state_dict(sd)
    batch = stack_batch([feats], "cpu")                       # bucketed: padded rows
    score, h = _forward(_port(NetworkConfig(), sd), batch, 0.6)
    s_ref, h_ref = _jax_forward(JaxNetworkConfig(), params, feats, 0.6)
    np.testing.assert_allclose(score.numpy(), s_ref, atol=1e-4)
    np.testing.assert_allclose(h.numpy(), h_ref, atol=1e-4)


def test_port_bf16_tracks_jax_bf16(feats):
    """bf16 on both sides (the JAX network's unfused CPU path, which rounds
    the chains at its own points): within the JAX package's bf16
    fused-vs-unfused chain bound of 6e-2 (tests/test_model.py)."""
    sd = {k: v.numpy() for k, v in read_state_dict(NETWORK_GOLDEN).items()}
    params = convert_diffusion_state_dict(sd)
    batch = stack_batch([feats], "cpu")
    score, h = _forward(_port(NetworkConfig(compute_dtype="bfloat16"), sd), batch, 0.3)
    s_ref, h_ref = _jax_forward(JaxNetworkConfig(compute_dtype="bfloat16"), params, feats, 0.3)
    np.testing.assert_allclose(score.numpy(), s_ref, atol=6e-2)
    np.testing.assert_allclose(h.numpy(), h_ref, atol=6e-2)


def test_from_flax_params_gives_the_same_forward(feats):
    jcfg = JaxNetworkConfig()
    jb = jax_stack_batch([feats])
    params = jax.tree.map(np.asarray, JaxChiScoreNetwork(jcfg).init(
        jax.random.key(3), jb, jb.SC_D, jnp.zeros(jb.residue_mask.shape), True))
    sd = from_flax_params(params)
    net = _port(NetworkConfig(), sd)                 # strict: every name matched
    assert set(sd) == set(net.state_dict())
    rng = np.random.default_rng(0)
    sc = (feats["SC_D"] + rng.normal(size=feats["SC_D"].shape)).astype(np.float32)
    sc_pad = np.zeros((1, jb.residue_mask.shape[1], 4), np.float32)
    sc_pad[0, :len(sc)] = sc
    score, h = _forward(net, stack_batch([feats], "cpu"), 0.45, torch.from_numpy(sc_pad))
    s_ref, h_ref = _jax_forward(jcfg, params, feats, 0.45, sc=sc_pad)
    np.testing.assert_allclose(score.numpy(), s_ref, atol=1e-4)
    np.testing.assert_allclose(h.numpy(), h_ref, atol=1e-4)


def test_shipped_checkpoint_matches_jax_network_on_the_orbax_parameters(feats):
    """``docs/ckpts/diffusion_crops/torch_state.pt`` (written by
    ``tools/convert_orbax_to_torch.py``) in the port against the JAX network
    on the orbax parameters it was converted from, in both message routes of
    ``eval()``: score and hidden state within 1e-4 at 87 residues."""
    from convert_orbax_to_torch import restore_numpy_tree

    ckpt = os.path.join(os.path.dirname(__file__), "..", "docs", "ckpts", "diffusion_crops")
    params = restore_numpy_tree(os.path.abspath(os.path.join(ckpt, "params")))
    sd = read_state_dict(os.path.join(ckpt, "torch_state.pt"))
    assert all(v.dtype == torch.float32 for v in sd.values())
    assert sum(v.numel() for v in sd.values()) == 1439172
    rng = np.random.default_rng(1)
    sc = (feats["SC_D"] + rng.normal(size=feats["SC_D"].shape)).astype(np.float32)
    jb = jax_stack_batch([feats])
    sc_pad = np.zeros((1, jb.residue_mask.shape[1], 4), np.float32)
    sc_pad[0, :len(sc)] = sc
    s_ref, h_ref = _jax_forward(JaxNetworkConfig(), params, feats, 0.35, sc=sc_pad)
    for fused in ("geom_lanes", True):
        net = _port(NetworkConfig(fused_messages=fused), sd)
        score, h = _forward(net, stack_batch([feats], "cpu"), 0.35, torch.from_numpy(sc_pad))
        np.testing.assert_allclose(score.numpy(), s_ref, atol=1e-4)
        np.testing.assert_allclose(h.numpy(), h_ref, atol=1e-4)
