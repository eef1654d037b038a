"""packppi_torch stands alone: importing every module loads neither JAX nor
packppi_tpu, and entry points refuse to fall back to the CPU silently."""
import os
import subprocess
import sys

import pytest
import torch

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
assert len(names) >= 20, names
for n in ("packppi_torch.ops.clash", "packppi_torch.sampling.proximal", "packppi_torch.cli.prox"):
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

    for bad in (dict(geometry_mode="local"), dict(use_ipmp=False),
                dict(static_edge_dtype="bfloat16"), dict(act="gelu")):
        with pytest.raises(ValueError, match="not implemented"):
            ChiScoreNetwork(NetworkConfig(**bad))


def test_training_mode_with_dropout_raises():
    from packppi_torch.data import stack_batch
    from packppi_torch.models import ChiScoreNetwork
    from packppi_torch.structure import featurize, from_pdb_file

    feats = featurize(from_pdb_file(os.path.join(REPO, "tests", "fixtures", "1brs.pdb"),
                                    chain_id="D"))
    batch = stack_batch([feats], "cpu")
    net = ChiScoreNetwork().train()
    with pytest.raises(ValueError, match="dropout"):
        net(batch, batch.SC_D, torch.zeros(batch.residue_mask.shape))

