"""packppi_torch stands alone: importing every module loads neither JAX nor
packppi_tpu, and entry points refuse to fall back to the CPU silently."""
import os
import subprocess
import sys

import pytest
import torch

from torch_threads import _threads  # noqa: F401 (autouse fixture)

REPO = os.path.join(os.path.dirname(__file__), "..")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import packppi_torch
names = [m.name for m in pkgutil.walk_packages(packppi_torch.__path__, "packppi_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "packppi_tpu"))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 59, names
for n in ("packppi_torch.ops.clash", "packppi_torch.sampling.proximal", "packppi_torch.cli.prox",
          "packppi_torch.ops.message_feat", "packppi_torch.train.loop",
          "packppi_torch.train.diffusion_task", "packppi_torch.train.checkpoints",
          "packppi_torch.data.complex", "packppi_torch.data.loader", "packppi_torch.data.crops",
          "packppi_torch.utils.config", "packppi_torch.utils.logging",
          "packppi_torch.utils.metrics", "packppi_torch.cli._runner",
          "packppi_torch.cli.train_diffusion", "packppi_torch.ops.attention",
          "packppi_torch.models.esm2", "packppi_torch.models.affinity", "packppi_torch.data.esm",
          "packppi_torch.data.skempi", "packppi_torch.cli.ddg", "packppi_torch.ops.layer",
          "packppi_torch.cli._directory", "packppi_torch.utils.analysis",
          "packppi_torch.structure.interface", "packppi_torch.structure.hydrogens",
          "packppi_torch.structure.hbond_networks", "packppi_torch.parallel",
          "packppi_torch.parallel.launch", "packppi_torch.parallel.mesh",
          "packppi_torch.parallel.pipeline", "packppi_torch.parallel.dryrun"):
    assert n in names, n
"""


def test_port_imports_no_jax_and_no_packppi_tpu():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(REPO))
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_default_device_raises_without_gpu():
    from packppi_torch.device import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-GPU refusal cannot be shown")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_pack_cli_without_gpu_raises(tmp_path):
    from packppi_torch.cli.pack import build_parser, run

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-GPU refusal cannot be shown")
    args = build_parser().parse_args([
        "--input", os.path.join(REPO, "tests", "fixtures", "1brs.pdb"),
        "--outdir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(args)


def test_pack_cli_local_geometry_without_gpu_raises(tmp_path):
    from packppi_torch.cli.pack import build_parser, run

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-GPU refusal cannot be shown")
    args = build_parser().parse_args([
        "--input", os.path.join(REPO, "tests", "fixtures", "1brs.pdb"),
        "--outdir", str(tmp_path), "--geometry", "local"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(args)


def test_prox_cli_without_gpu_raises(tmp_path):
    from packppi_torch.cli.prox import build_parser, run

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-GPU refusal cannot be shown")
    args = build_parser().parse_args([
        "--input", os.path.join(REPO, "tests", "fixtures", "1brs.pdb"),
        "--outdir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(args)


def test_pack_cli_with_proximal_without_gpu_raises(tmp_path):
    from packppi_torch.cli.pack import build_parser, run

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-GPU refusal cannot be shown")
    args = build_parser().parse_args([
        "--input", os.path.join(REPO, "tests", "fixtures", "1brs.pdb"),
        "--outdir", str(tmp_path), "--use_proximal", "--n_samples", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(args)


def test_unimplemented_config_values_raise():
    from packppi_torch.models import ChiScoreNetwork, NetworkConfig

    # every value the JAX package accepts builds; values outside its tables raise
    for good in (dict(use_ipmp=False), dict(static_edge_dtype="bfloat16"),
                 dict(static_edge_dtype="int8"), dict(act="gelu"), dict(k_neighbors=16),
                 dict(geometry_lanes=True), dict(coalesce_gathers=True)):
        ChiScoreNetwork(NetworkConfig(**good))
    for bad, what in ((dict(static_edge_dtype="float16"), "static_edge_dtype"),
                      (dict(act="tanh"), "act")):
        with pytest.raises(ValueError, match=what):
            ChiScoreNetwork(NetworkConfig(**bad))
    # local geometry is implemented; with a global-point kernel it is refused
    with pytest.raises(ValueError, match="incompatible"):
        ChiScoreNetwork(NetworkConfig(geometry_mode="local"))
    ChiScoreNetwork(NetworkConfig(geometry_mode="local", fused_messages=True))


def test_training_mode_with_dropout_raises():
    """Training mode with dropout runs (the unfused path, two passes with
    dropout draw different outputs); what raises is asking for the chain
    kernel in training with dropout on, because the kernel applies none."""
    from packppi_torch.data import stack_batch
    from packppi_torch.models import ChiScoreNetwork, NetworkConfig
    from packppi_torch.structure import featurize, from_pdb_file
    from packppi_torch.weights import init_weights

    with pytest.raises(ValueError, match="dropout"):
        ChiScoreNetwork(NetworkConfig(dropout=0.1, fused_chain_train=True))

    feats = featurize(from_pdb_file(os.path.join(REPO, "tests", "fixtures", "1brs.pdb"),
                                    chain_id="D"))
    batch = stack_batch([feats], "cpu")
    net = ChiScoreNetwork().train()
    init_weights(net, 0)
    torch.manual_seed(0)
    t = torch.full(batch.residue_mask.shape, 0.5)
    a, _ = net(batch, batch.SC_D, t)
    b, _ = net(batch, batch.SC_D, t)
    assert torch.isfinite(a).all() and not torch.equal(a, b)
    net.eval()
    with torch.no_grad():
        c, _ = net(batch, batch.SC_D, t)
        d, _ = net(batch, batch.SC_D, t)
    assert torch.equal(c, d)


def test_train_cli_without_gpu_raises(tmp_path):
    from packppi_torch.cli.train_diffusion import main

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-GPU refusal cannot be shown")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([f"output_dir={tmp_path}", "trainer=debug"])


def test_routing_config_values_are_validated():
    from packppi_torch.models import ChiScoreNetwork, NetworkConfig

    for bad in (dict(fused_messages="geom_aos"),
                dict(fused_messages=1), dict(geometry_mode="frame"),
                dict(mxu_gather_grad="yes"), dict(mxu_gather_grad=1)):
        with pytest.raises(ValueError):
            ChiScoreNetwork(NetworkConfig(**bad))
    for ok in (dict(mxu_gather_grad="auto"), dict(mxu_gather_grad=True),
               dict(fused_messages=True, fused_messages_train=True, fused_chain_train=True,
                    dropout=0.0, remat_layers=True),
               dict(fused_messages="geom"), dict(fused_messages="geom_gather"),
               dict(fused_layers=True), dict(geometry_mode="local", fused_messages=True),
               # the unfused route (cli.pack --no_fused), in either geometry mode
               dict(fused_messages=False, fused_chain=False),
               dict(fused_messages=False, fused_chain=False, geometry_mode="local")):
        ChiScoreNetwork(NetworkConfig(**ok))

