"""The unfused route (``fused_messages=False, fused_chain=False``;
``cli.pack --no_fused``) on the CPU: the port's network in ``eval()``
against the JAX network's unfused path on the same weights (float32 1e-4,
bf16 6e-2, the limits of ``test_torch_network.py``), the 1BRS golden
trajectory through ``cli.pack``'s model under ``--no_fused`` (5e-4 rad),
and no kernel entry reached on that route."""
import os

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
from packppi_torch.weights import load_weights, read_state_dict

from conftest import FIXTURES, GOLDEN
from test_torch_network import convert_diffusion_state_dict
from torch_threads import _threads  # noqa: F401 (autouse fixture)

PIPELINE_GOLDEN = os.path.join(GOLDEN, "pipeline_golden.npz")
NETWORK_GOLDEN = os.path.join(GOLDEN, "network_golden.npz")
UNFUSED = dict(fused_messages=False, fused_chain=False)


@pytest.fixture(scope="module")
def feats():
    return featurize(from_pdb_file(os.path.join(FIXTURES, "1brs.pdb"), mse_to_met=True))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 6e-2)])
@pytest.mark.parametrize("geometry", ["global", "local"])
def test_unfused_network_matches_jax_unfused_path(feats, dtype, tol, geometry):
    sd = {k: v.numpy() for k, v in read_state_dict(NETWORK_GOLDEN).items()}
    rng = np.random.default_rng(2)
    jb = jax_stack_batch([feats])
    sc = np.zeros((1, jb.residue_mask.shape[1], 4), np.float32)
    sc[0, :len(feats["SC_D"])] = feats["SC_D"] + rng.normal(size=feats["SC_D"].shape)
    net = ChiScoreNetwork(NetworkConfig(compute_dtype=dtype, geometry_mode=geometry,
                                        **UNFUSED)).eval()
    load_weights(net, sd)
    batch = stack_batch([feats], "cpu")
    t = torch.full(batch.residue_mask.shape, 0.4)
    with torch.no_grad():
        score, h = net(batch, torch.from_numpy(sc), t)
    jcfg = JaxNetworkConfig(compute_dtype=dtype, geometry_mode=geometry, **UNFUSED)
    s_ref, h_ref = JaxChiScoreNetwork(jcfg).apply(
        convert_diffusion_state_dict(sd), jb, jnp.asarray(sc), jnp.full(jb.residue_mask.shape, 0.4))
    np.testing.assert_allclose(score.numpy(), np.asarray(s_ref), atol=tol)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=tol)


def _no_kernel_entries(monkeypatch):
    """Replace every kernel entry the network can reach with one that fails."""
    from packppi_torch.models import ipmp

    def refuse(*a, **k):
        raise AssertionError("a kernel entry was called on the unfused route")

    for name in ("chain", "message", "message_chain", "message_gather", "message_geom",
                 "message_feat", "layer_node", "layer_edge"):
        monkeypatch.setattr(ipmp, name, refuse)


def test_no_fused_replays_the_golden_trajectory(monkeypatch):
    """``cli.pack --no_fused``'s model (float32) replays the reference's
    fixed-noise 1BRS trajectory within 5e-4 rad, reaching no kernel entry."""
    from packppi_torch.cli.pack import _model, build_parser

    _no_kernel_entries(monkeypatch)
    golden = dict(np.load(PIPELINE_GOLDEN))
    args = build_parser().parse_args(["--input", "x.pdb", "--no_fused", "--precision", "float32",
                                      "--ckpt", PIPELINE_GOLDEN, "--device", "cpu"])
    model = _model(args, torch.device("cpu"))
    assert model.net.cfg.fused_messages is False and model.net.cfg.fused_chain is False
    feats = featurize(from_pdb_file(os.path.join(FIXTURES, "1brs.pdb"), mse_to_met=True))
    batch = stack_batch([feats], "cpu", target_len=len(feats["residue_type"]))
    sc, traj = model.sample(batch, init_sc=golden["init_sc"], return_trajectory=True)
    wrap = lambda a, b: np.minimum(np.abs(a - b), 2 * np.pi - np.abs(a - b))
    mask = batch.SC_D_mask[0].numpy() > 0
    for s in range(traj.shape[0]):
        assert wrap(traj[s, 0].numpy(), golden["traj"][s, 0])[mask].max() < 5e-4, s
    assert wrap(sc[0].numpy(), golden["final_sc"][0])[mask].max() < 5e-4


def test_no_fused_cli_pack_calls_no_kernel_entry(tmp_path, monkeypatch):
    """A whole bf16 CLI run under ``--no_fused`` reaches no kernel entry;
    without the flag, a one-step pack calls the chain entry 5 times."""
    from packppi_torch.cli.pack import build_parser, run
    from packppi_torch.models import ipmp

    common = ["--input", os.path.join(FIXTURES, "1brs.pdb"), "--device", "cpu", "--n_steps", "1",
              "--ckpt", PIPELINE_GOLDEN, "--print_metrics"]
    calls = []
    chain = ipmp.chain
    monkeypatch.setattr(ipmp, "chain", lambda *a: calls.append(1) or chain(*a))
    run(build_parser().parse_args(common + ["--outdir", str(tmp_path / "fused")]))
    assert len(calls) == 5
    _no_kernel_entries(monkeypatch)
    run(build_parser().parse_args(common + ["--outdir", str(tmp_path / "unfused"), "--no_fused"]))
    assert (tmp_path / "unfused" / "structure.pdb").exists()


def test_default_routing_keeps_the_kernels():
    """The default configuration routes through the kernels (``fused_chain``
    on, where the JAX package's default is off); the unfused one runs none."""
    cfg = NetworkConfig()
    assert cfg.fused_messages == "geom_lanes" and cfg.fused_chain is True
    assert cfg.runs_kernels() and not NetworkConfig(**UNFUSED).runs_kernels()
