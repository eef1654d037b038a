"""PackPPI-Prox in the port (``packppi_torch.sampling.proximal`` and its two
CLI entry points) on the CPU: against the reference's recorded 1BRS
refinement (``pipeline_golden.npz``: clash mask index-exact, losses 1e-4,
chis 5e-4 rad, the accept decision, the bounds
``tests/test_pipeline_golden.py`` holds the JAX package to) and against the
JAX package's ``proximal_optimize`` on the same seeded input."""
import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from packppi_tpu.data import stack_batch as jax_stack_batch
from packppi_tpu.models import SampleConfig as JaxSampleConfig
from packppi_tpu.sampling.proximal import proximal_optimize as jax_proximal_optimize
from packppi_tpu.structure import from_pdb_file as jax_from_pdb_file
from packppi_tpu.structure.featurize import featurize as jax_featurize
from packppi_torch.cli import pack as pack_cli
from packppi_torch.cli import prox as prox_cli
from packppi_torch.data import ProteinBatch, stack_batch
from packppi_torch.models import SampleConfig
from packppi_torch.ops.clash import between_residue_clash, compute_residue_clash
from packppi_torch.sampling import ProximalResult, find_clash_mask, proximal_optimize
from packppi_torch.sampling.proximal import _row_mean
from packppi_torch.structure import featurize, from_pdb_file

from conftest import FIXTURES, GOLDEN
from torch_threads import _threads  # noqa: F401 (autouse fixture)

REPO = os.path.join(os.path.dirname(__file__), "..")
PDB = os.path.join(FIXTURES, "1brs.pdb")
PIPELINE_GOLDEN = os.path.join(GOLDEN, "pipeline_golden.npz")


def _wrapdiff(a, b):
    d = np.abs(a - b)
    return np.minimum(d, 2 * np.pi - d)


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(PIPELINE_GOLDEN))


@pytest.fixture(scope="module")
def batch():
    feats = featurize(from_pdb_file(PDB, mse_to_met=True))
    return stack_batch([feats], "cpu", target_len=len(feats["residue_type"]))


@pytest.fixture(scope="module")
def perturbed(batch):
    rng = np.random.default_rng(3)
    sc = batch.SC_D.numpy()
    return (sc + rng.normal(0, 0.5, sc.shape).astype(np.float32)
            * batch.SC_D_mask.numpy()).astype(np.float32)


def _well_conditioned(batch, sc, lamda=1.0):
    """Chis of the optimized residues whose first-step gradient stands clear
    of rounding noise. Adam's step is lr * g / (|g| + 1e-8): where the true
    gradient is zero (a chi that moves no clashing atom), the 2e-8 of noise
    two summation orders differ by is blown up to a full step of either
    sign, in every framework, so those few entries may differ by up to
    steps * lr and are held to that bound instead."""
    cm = find_clash_mask(batch, sc)
    x = sc.clone().requires_grad_(True)
    (lamda * _row_mean(compute_residue_clash(batch, x), batch.residue_mask)).sum().backward()
    opt = (cm & (batch.SC_D_mask > 0)).numpy()
    return opt & (x.grad.abs().numpy() > 1e-5), opt


def test_find_clash_mask_is_index_exact(golden, batch):
    cm = find_clash_mask(batch, torch.as_tensor(golden["final_sc"]), 12.0, 0.5)
    assert cm.dtype == torch.bool and cm.shape == golden["clash_mask"].shape
    np.testing.assert_array_equal(cm.numpy(), golden["clash_mask"].astype(bool))


def test_proximal_replays_reference(golden, batch):
    before = (between_residue_clash.launches_fwd, between_residue_clash.launches_bwd)
    with torch.no_grad():                     # the sampler that feeds it runs so
        res = proximal_optimize(batch, torch.as_tensor(golden["final_sc"]), 12.0, 0.5, 1.0, 50)
    assert isinstance(res, ProximalResult)
    assert (between_residue_clash.launches_fwd,
            between_residue_clash.launches_bwd) == before       # no kernel on the CPU
    np.testing.assert_array_equal(res.clash_mask.numpy(), golden["clash_mask"].astype(bool))
    np.testing.assert_allclose(res.losses.numpy(), golden["prox_losses"], atol=1e-4)
    mask = batch.SC_D_mask[0].numpy() > 0
    assert _wrapdiff(res.SC_D[0].numpy(), golden["prox_final_sc"][0])[mask].max() < 5e-4
    assert bool(res.losses[-1] < res.losses[0]) == bool(golden["accepted"])
    assert res.row_losses.shape == (50, 1)
    np.testing.assert_array_equal(res.row_losses[:, 0].numpy(), res.losses.numpy())
    assert not res.SC_D.requires_grad and not res.losses.requires_grad


def test_proximal_matches_jax_package(batch, perturbed):
    fj = jax_featurize(jax_from_pdb_file(PDB, mse_to_met=True))
    bj = jax_stack_batch([fj], target_len=len(fj["residue_type"]))
    steps = 12
    ours = proximal_optimize(batch, torch.as_tensor(perturbed), 12.0, 0.5, 0.7, steps)
    ref = jax_proximal_optimize(bj, jnp.asarray(perturbed), 12.0, 0.5, 0.7, steps,
                                backend="scan")
    np.testing.assert_array_equal(ours.clash_mask.numpy(), np.asarray(ref.clash_mask))
    np.testing.assert_allclose(ours.losses.numpy(), np.asarray(ref.losses), atol=1e-4)
    np.testing.assert_allclose(ours.row_losses.numpy(), np.asarray(ref.row_losses), atol=1e-4)
    firm, opt = _well_conditioned(batch, torch.as_tensor(perturbed), 0.7)
    assert firm.sum() > 0.9 * opt.sum()
    d = _wrapdiff(ours.SC_D.numpy(), np.asarray(ref.SC_D))
    assert d[firm].max() < 5e-4
    assert d[opt].max() <= steps * 1.01e-2 and d[~opt].max() == 0


def test_losses_are_recorded_before_each_step(batch, perturbed):
    sc = torch.as_tensor(perturbed)
    res = proximal_optimize(batch, sc, num_steps=2, lamda=1.0)
    cm = res.clash_mask
    z = sc * cm
    prc = compute_residue_clash(batch, sc)
    initial = (_row_mean(((sc - z) ** 2).sum(-1), batch.residue_mask)
               + _row_mean(prc, batch.residue_mask))
    np.testing.assert_allclose(res.losses[0].item(), initial.mean().item(), rtol=1e-6)
    # chis outside the mask are kept bit for bit; those inside moved by Adam's
    # first two steps of 1e-2 each
    keep = ~cm.numpy()
    np.testing.assert_array_equal(res.SC_D.numpy()[keep], perturbed[keep])
    moved = np.abs(res.SC_D.numpy() - perturbed)[cm.numpy() & (batch.SC_D_mask.numpy() > 0)]
    assert 0 < moved.max() <= 2.01e-2


def test_batched_complexes_stay_independent(batch, perturbed):
    chis = torch.cat([batch.SC_D, torch.as_tensor(perturbed)])
    two = ProteinBatch(*(torch.cat([t, t]) for t in batch))
    both = proximal_optimize(two, chis, num_steps=3)
    assert both.row_losses.shape == (3, 2) and both.losses.shape == (3,)
    np.testing.assert_allclose(both.losses.numpy(), both.row_losses.mean(1).numpy(), rtol=1e-6)
    for row in range(2):
        one = proximal_optimize(batch, chis[row:row + 1], num_steps=3)
        np.testing.assert_array_equal(both.clash_mask[row].numpy(), one.clash_mask[0].numpy())
        np.testing.assert_allclose(both.row_losses[:, row].numpy(), one.losses.numpy(),
                                   atol=1e-5, rtol=1e-5)
        firm, opt = _well_conditioned(batch, chis[row:row + 1])
        d = np.abs(both.SC_D[row:row + 1].numpy() - one.SC_D.numpy())
        assert d[firm].max() < 1e-5
        assert d[opt].max() <= 3 * 1.01e-2 and d[~opt].max() == 0


def test_sample_config_has_the_jax_defaults():
    ours, ref = SampleConfig(), JaxSampleConfig()
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    assert {f.name for f in dataclasses.fields(ours)} == {
        "annealed_temp", "mode",
        "violation_tolerance_factor", "clash_overlap_tolerance", "lamda", "num_steps"}
    assert {f.name for f in dataclasses.fields(ours)} == {f.name for f in dataclasses.fields(ref)}


def _prox(tmp_path, *extra, pdb=PDB):
    return prox_cli.run(prox_cli.build_parser().parse_args(
        ["--input", str(pdb), "--outdir", str(tmp_path), "--device", "cpu", *extra]))


def test_prox_cli_writes_structure_and_metrics(tmp_path):
    result = _prox(tmp_path, "--num_steps", "3")
    saved = json.loads((tmp_path / "metrics.json").read_text())
    assert set(saved) == {"clashscore_before", "clashscore_after", "accepted",
                          "optimize_seconds", "objective_initial", "objective_final",
                          "objective_convention"}
    assert np.isfinite(saved["clashscore_before"]) and np.isfinite(saved["clashscore_after"])
    assert saved["accepted"] is True and result["accepted"] is True
    assert saved["objective_final"] < saved["objective_initial"]
    assert saved["objective_convention"] == "pre-step (reference parity)"
    inp = from_pdb_file(PDB, mse_to_met=True)
    out = from_pdb_file(tmp_path / "structure.pdb")
    np.testing.assert_array_equal(out.aaindex, inp.aaindex)
    np.testing.assert_array_equal(out.atom_mask, inp.atom_mask)
    assert np.isfinite(out.atom_positions[out.atom_mask > 0]).all()
    np.testing.assert_allclose(out.atom_positions[:, :4], inp.atom_positions[:, :4], atol=1e-3)


@pytest.mark.parametrize("strict", [True, False], ids=["rebuilt", "raw"])
def test_prox_cli_reject_path(tmp_path, strict):
    """With lamda 0 the objective cannot fall, so the refinement is rejected:
    the output is rebuilt from the input chis (ideal bond geometry), or is
    the raw input with ``--no_strict_parity``."""
    result = _prox(tmp_path, "--num_steps", "2", "--lamda", "0",
                   *([] if strict else ["--no_strict_parity"]))
    assert result["accepted"] is False
    inp = from_pdb_file(PDB, mse_to_met=True)
    out = from_pdb_file(tmp_path / "structure.pdb")
    present = inp.atom_mask > 0
    d = np.abs(out.atom_positions - inp.atom_positions)[present]
    if strict:
        # re-idealized: side chains move a little, the backbone is copied
        assert d.max() > 1e-3 and np.median(d) < 0.05
        np.testing.assert_allclose(out.atom_positions[:, :4], inp.atom_positions[:, :4],
                                   atol=1e-3)
    else:
        assert d.max() <= 1e-3               # PDB precision


def test_prox_cli_exits_with_the_reference_messages(tmp_path):
    with pytest.raises(SystemExit, match="--num_steps must be >= 1"):
        _prox(tmp_path, "--num_steps", "0")
    backbone = tmp_path / "backbone.pdb"
    with open(PDB) as f:
        backbone.write_text("".join(
            line for line in f
            if not line.startswith(("ATOM", "HETATM")) or line[12:16].strip() in
            ("N", "CA", "C", "O")))
    with pytest.raises(SystemExit, match="no side-chain chi angles"):
        _prox(tmp_path / "out", pdb=backbone)


def test_prox_module_entry_point(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(REPO))
    res = subprocess.run(
        [sys.executable, "-m", "packppi_torch.cli.prox", "--input", PDB, "--outdir",
         str(tmp_path), "--device", "cpu", "--num_steps", "1"],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert (tmp_path / "structure.pdb").exists() and (tmp_path / "metrics.json").exists()


def test_pack_cli_best_of_n_with_proximal(tmp_path, capsys):
    args = pack_cli.build_parser().parse_args([
        "--input", PDB, "--outdir", str(tmp_path), "--device", "cpu", "--n_steps", "2",
        "--n_samples", "2", "--use_proximal", "--precision", "float32", "--ckpt",
        PIPELINE_GOLDEN])
    metrics = pack_cli.run(args)
    assert "best-of-2" in capsys.readouterr().out
    saved = json.loads((tmp_path / "metrics.json").read_text())
    assert {"sampling_seconds", "proximal_seconds"} <= set(saved)
    assert saved["proximal_seconds"] == pytest.approx(metrics["proximal_seconds"])
    assert saved["proximal_accepted"] == (saved["proximal_objective_final"]
                                          < saved["proximal_objective_initial"])
    inp = from_pdb_file(PDB, mse_to_met=True)
    out = from_pdb_file(tmp_path / "structure.pdb")
    np.testing.assert_array_equal(out.aaindex, inp.aaindex)
    assert np.isfinite(out.atom_positions[out.atom_mask > 0]).all()


def test_pack_cli_without_proximal_keeps_its_keys(tmp_path):
    args = pack_cli.build_parser().parse_args([
        "--input", PDB, "--outdir", str(tmp_path), "--device", "cpu", "--n_steps", "1",
        "--ckpt", PIPELINE_GOLDEN])
    # the metric suite and the timing; no key of the refinement
    suite = {f"chi_{i}_{m}" for i in range(4) for m in ("ae_rad", "ae_deg", "acc")}
    suite |= {"total_acc", "interface_acc", "atom_rmsd", "clashscore", "clashscore_is_exact"}
    assert set(pack_cli.run(args)) == suite | {"sampling_seconds"}
