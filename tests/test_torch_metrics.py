"""The port's metric suite against the JAX package's on the same inputs:
interface mask and file, ``mean_squared_atom_deviation``, the two
clashscores, ``ProteinAnalysis.get_metric`` and ``run_tool``."""
import dataclasses
import os
import stat

import numpy as np
import pytest
import torch

from packppi_torch.structure import from_pdb_file, to_pdb
from packppi_torch.structure.interface import (interface_residue_mask, parse_interface_file,
                                               write_interface_file)
from packppi_torch.utils import metrics as tm
from packppi_torch.utils.analysis import ProteinAnalysis

from conftest import FIXTURES, GOLDEN
from torch_threads import _threads  # noqa: F401 (autouse fixture)

NAMES = ("1brs", "2ftl", "t1124")


def _pdb(name):
    return os.path.join(FIXTURES, f"{name}.pdb")


def _both(name):
    """The port's parse of a PDB and the JAX package's, each package parsing
    the file itself (both native parsers: the same float32 coordinates)."""
    from packppi_tpu.structure import from_pdb_file as jax_from_pdb_file

    return (from_pdb_file(_pdb(name), mse_to_met=True),
            jax_from_pdb_file(_pdb(name), mse_to_met=True))


def _perturbed(prot, sigma=0.4, seed=0):
    """Side-chain atoms moved by seeded Gaussian noise (more clashes)."""
    rng = np.random.default_rng(seed)
    noise = rng.normal(0.0, sigma, prot.atom_positions.shape)
    noise[:, :4] = 0.0
    return dataclasses.replace(
        prot, atom_positions=prot.atom_positions + noise * prot.atom_mask[..., None])


@pytest.mark.parametrize("name", NAMES)
def test_interface_mask_and_file_equal_jax(name, tmp_path):
    from packppi_tpu.structure import interface as ji

    ours, theirs = _both(name)
    mask = interface_residue_mask(ours)
    np.testing.assert_array_equal(mask, ji.interface_residue_mask(theirs))
    assert mask.dtype == np.float32
    if name == "1brs":
        golden = np.load(os.path.join(GOLDEN, "pipeline_golden.npz"))
        np.testing.assert_array_equal(mask, golden["interface_mask"])
        assert mask.sum() > 0
    write_interface_file(mask, ours, str(tmp_path / "ours.txt"))
    ji.write_interface_file(mask, theirs, str(tmp_path / "theirs.txt"))
    assert (tmp_path / "ours.txt").read_text() == (tmp_path / "theirs.txt").read_text()
    parsed = parse_interface_file(str(tmp_path / "ours.txt"))
    assert parsed == ji.parse_interface_file(str(tmp_path / "theirs.txt"))
    assert sum(len(v) for v in parsed.values()) == int(mask.sum())


@pytest.mark.parametrize("strict", [True, False], ids=["strict", "true_rmsd"])
def test_mean_squared_atom_deviation_equals_jax(strict):
    from packppi_tpu.utils.metrics import mean_squared_atom_deviation as jax_msd

    rng = np.random.default_rng(3)
    true = rng.normal(0, 10, (2, 96, 14, 3))
    pred = true + rng.normal(0, 0.7, true.shape)
    atom_mask = (rng.random((2, 96, 14)) > 0.3).astype(np.float32)
    residue_mask = np.ones((2, 96), np.float32)
    residue_mask[:, 80:] = 0.0
    got = tm.mean_squared_atom_deviation(true, pred, atom_mask, residue_mask,
                                         strict_parity=strict)
    want = jax_msd(true, pred, atom_mask, residue_mask, strict_parity=strict)
    assert type(got) is float
    np.testing.assert_allclose(got, float(want), rtol=1e-12)


def test_approx_clashscore_counts_as_jax_on_perturbed_t1124():
    from packppi_tpu.utils.metrics import approx_clashscore as jax_approx

    from packppi_torch.structure import featurize

    feats = featurize(_perturbed(from_pdb_file(_pdb("t1124"), mse_to_met=True)))
    args = (feats["X"][None].astype(np.float32), feats["atom_mask"][None].astype(np.float32),
            feats["residue_type"][None], feats["residue_index"][None])
    got = tm.approx_clashscore(*args)
    want = jax_approx(*args)
    assert got == pytest.approx(want, rel=1e-12)
    assert got > 0
    # the same count from torch tensors
    assert tm.approx_clashscore(*map(torch.as_tensor, args)) == got


@pytest.mark.parametrize("case", ["1brs", "2ftl", "t1124", "t1124_perturbed"])
def test_probe_clashscore_equals_jax(case):
    from packppi_tpu.utils.metrics import probe_clashscore as jax_probe

    ours, theirs = _both(case.split("_")[0])
    if case.endswith("perturbed"):
        ours, theirs = _perturbed(ours), _perturbed(theirs)
    got = tm.probe_clashscore(ours)
    assert got == jax_probe(theirs)
    assert np.isfinite(got) and got > 0


@pytest.fixture(scope="module")
def golden_prediction(tmp_path_factory):
    """The reference's 1BRS prediction written as a PDB."""
    golden = np.load(os.path.join(GOLDEN, "pipeline_golden.npz"))
    prot = from_pdb_file(_pdb("1brs"), mse_to_met=True)
    pred = dataclasses.replace(prot, atom_positions=np.asarray(golden["pred_coords"][0],
                                                               np.float64))
    path = tmp_path_factory.mktemp("golden") / "pred.pdb"
    path.write_text(to_pdb(pred))
    return str(path), golden


@pytest.mark.parametrize("strict", [True, False], ids=["strict", "no_strict"])
def test_get_metric_matches_reference_and_jax(golden_prediction, strict, tmp_path):
    from packppi_tpu.utils.analysis import ProteinAnalysis as JaxAnalysis

    pred, golden = golden_prediction
    got = ProteinAnalysis(tmp_dir=str(tmp_path / "a")).get_metric(_pdb("1brs"), pred,
                                                                  strict_parity=strict)
    want = JaxAnalysis(tmp_dir=str(tmp_path / "b")).get_metric(_pdb("1brs"), pred,
                                                               strict_parity=strict)
    assert set(got) == set(want)
    assert got["clashscore_is_exact"] is False and want["clashscore_is_exact"] is False
    for k, v in want.items():
        if k != "clashscore_is_exact":
            np.testing.assert_allclose(got[k], float(v), rtol=0, atol=1e-6, err_msg=k)
    if strict:
        for k in golden.files:
            if k.startswith("metric::"):
                np.testing.assert_allclose(got[k[8:]], float(golden[k]), atol=1e-4, err_msg=k)


def test_get_metric_refuses_residue_count_mismatch(tmp_path):
    prot = from_pdb_file(_pdb("1brs"), mse_to_met=True)
    short = tmp_path / "short.pdb"
    short.write_text(to_pdb(dataclasses.replace(
        prot, **{f.name: getattr(prot, f.name)[:-3] for f in dataclasses.fields(prot)})))
    assert ProteinAnalysis(tmp_dir=str(tmp_path)).get_metric(_pdb("1brs"), str(short)) is None


def _script(path, body):
    path.write_text("#!/bin/sh\n" + body + "\n")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_run_tool_never_scores_a_stale_output(tmp_path):
    """A packer that writes nothing fails even with an earlier output in
    place; one that writes its output is scored by get_metric."""
    analysis = ProteinAnalysis(tmp_dir=str(tmp_path / "tmp"),
                               scwrl_loc=_script(tmp_path / "silent.sh", "echo no >&2"),
                               faspr_loc=_script(tmp_path / "copy.sh", 'cp "$2" "$4"'))
    stale = tmp_path / "tmp" / "baseline.pdb"
    stale.write_text(open(_pdb("1brs")).read())
    with pytest.raises(RuntimeError, match="scwrl produced no output"):
        analysis.run_tool(_pdb("1brs"), "scwrl")
    assert not stale.exists()
    m = analysis.run_tool(_pdb("1brs"), "faspr")
    assert m["atom_rmsd"] < 0.1 and m["clashscore_is_exact"] is False
    with pytest.raises(ValueError, match="not configured"):
        ProteinAnalysis(tmp_dir=str(tmp_path / "x")).run_tool(_pdb("1brs"), "faspr")


def test_molprobity_clashscore_from_a_stand_in_binary(tmp_path):
    """--molprobity_loc: the number the binary prints, is_exact only when it
    printed one."""
    good = ProteinAnalysis(_script(tmp_path / "mp.sh", 'echo "clashscore = 12.5"'),
                           tmp_dir=str(tmp_path / "a"))
    assert good.get_clashscore(_pdb("1brs")) == 12.5
    bad = ProteinAnalysis(_script(tmp_path / "mp_bad.sh", "echo failed"),
                          tmp_dir=str(tmp_path / "b"))
    assert bad.get_clashscore(_pdb("1brs")) is None
    prot = from_pdb_file(_pdb("1brs"), mse_to_met=True)
    pred = tmp_path / "pred.pdb"
    pred.write_text(to_pdb(prot))
    m = bad.get_metric(_pdb("1brs"), str(pred))
    assert m["clashscore"] is None and m["clashscore_is_exact"] is False
    assert good.get_metric(_pdb("1brs"), str(pred))["clashscore_is_exact"] is True
