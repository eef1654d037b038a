"""``python -m packppi_torch.cli.pack`` end to end on the CPU: 1BRS, two
steps, the reference weights of ``pipeline_golden.npz``."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from packppi_torch.cli.pack import build_parser, run
from packppi_torch.structure import from_pdb_file

from conftest import FIXTURES, GOLDEN
from torch_threads import _threads  # noqa: F401 (autouse fixture)

REPO = os.path.join(os.path.dirname(__file__), "..")
PDB = os.path.join(FIXTURES, "1brs.pdb")


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_pack_writes_structure_with_input_residues(tmp_path, precision):
    args = build_parser().parse_args([
        "--input", PDB, "--outdir", str(tmp_path), "--device", "cpu", "--n_steps", "2",
        "--precision", precision, "--ckpt", os.path.join(GOLDEN, "pipeline_golden.npz")])
    metrics = run(args)
    inp = from_pdb_file(PDB, mse_to_met=True)
    out = from_pdb_file(tmp_path / "structure.pdb")
    np.testing.assert_array_equal(out.aaindex, inp.aaindex)
    np.testing.assert_array_equal(out.residue_index, inp.residue_index)
    np.testing.assert_array_equal(out.chain_id, inp.chain_id)
    np.testing.assert_array_equal(out.atom_mask, inp.atom_mask)
    assert np.isfinite(out.atom_positions[out.atom_mask > 0]).all()
    # the backbone is copied through; side chains moved
    np.testing.assert_allclose(out.atom_positions[:, :4], inp.atom_positions[:, :4], atol=1e-3)
    assert not np.allclose(np.nan_to_num(out.atom_positions[:, 4:]),
                           np.nan_to_num(inp.atom_positions[:, 4:]), atol=1e-2)
    saved = json.loads((tmp_path / "metrics.json").read_text())
    assert saved["sampling_seconds"] == pytest.approx(metrics["sampling_seconds"])


def test_pack_module_entry_point(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(REPO))
    res = subprocess.run(
        [sys.executable, "-m", "packppi_torch.cli.pack", "--input", PDB, "--outdir",
         str(tmp_path), "--device", "cpu", "--n_steps", "1", "--seed", "3"],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "random weights" in res.stdout
    assert (tmp_path / "structure.pdb").exists()


def _args(tmp_path, *extra, pdb=PDB):
    return build_parser().parse_args([
        "--input", str(pdb), "--outdir", str(tmp_path), "--device", "cpu", "--n_steps", "2",
        "--precision", "float32", "--ckpt", os.path.join(GOLDEN, "pipeline_golden.npz"),
        *extra])


@pytest.mark.parametrize("strict", [True, False], ids=["strict", "no_strict_parity"])
def test_pack_writes_the_jax_metric_suite(tmp_path, strict):
    """metrics.json holds what the JAX CLI writes (its get_metric on the
    input and the written structure, then the timing), with its values."""
    from packppi_tpu.utils.analysis import ProteinAnalysis as JaxAnalysis

    metrics = run(_args(tmp_path, *([] if strict else ["--no_strict_parity"])))
    saved = json.loads((tmp_path / "metrics.json").read_text())
    assert saved == metrics
    want = JaxAnalysis(tmp_dir=str(tmp_path / "jax")).get_metric(
        PDB, str(tmp_path / "structure.pdb"), strict_parity=strict)
    assert set(saved) == set(want) | {"sampling_seconds"}
    assert type(saved["clashscore_is_exact"]) is float and saved["clashscore_is_exact"] == 0.0
    for k, v in want.items():
        if k != "clashscore_is_exact":
            np.testing.assert_allclose(saved[k], float(v), rtol=0, atol=1e-6, err_msg=k)


def test_pack_corrector_steps_add_network_evaluations(tmp_path, monkeypatch):
    """--corrector_steps c: (1 + c) network evaluations a step, as the JAX
    sampler's corrector loop; the suite stays in range."""
    from packppi_torch.models import ChiScoreNetwork

    calls = []
    forward = ChiScoreNetwork.forward
    monkeypatch.setattr(ChiScoreNetwork, "forward",
                        lambda self, *a, **k: calls.append(1) or forward(self, *a, **k))
    metrics = run(_args(tmp_path, "--corrector_steps", "1"))
    assert len(calls) == 2 * (1 + 1)
    assert np.isfinite(metrics["clashscore"]) and 0 <= metrics["total_acc"] <= 1


def test_pack_exact_length_pads_to_the_structure(tmp_path, monkeypatch):
    """--exact_length gives the sampler the structure's own length, as the
    JAX CLI's stack_batch(target_len=L); without it the length bucket."""
    from packppi_tpu.data import stack_batch as jax_stack

    from packppi_torch.models import TorsionalDiffusion
    from packppi_torch.structure import featurize

    lengths = []
    sample = TorsionalDiffusion.sample
    monkeypatch.setattr(TorsionalDiffusion, "sample", lambda self, batch, *a, **k: (
        lengths.append(batch.residue_mask.shape[1]) or sample(self, batch, *a, **k)))
    run(_args(tmp_path / "exact", "--exact_length"))
    run(_args(tmp_path / "bucket"))
    feats = featurize(from_pdb_file(PDB, mse_to_met=True))
    L = len(feats["residue_type"])
    assert lengths == [jax_stack([feats], target_len=L).residue_mask.shape[1],
                       jax_stack([feats]).residue_mask.shape[1]] == [L, 256]


def test_pack_skips_the_suite_without_side_chains(tmp_path):
    """A backbone-only input still writes its structure; metrics.json holds
    the timing alone, as the JAX CLI's guard gives."""
    import dataclasses

    from packppi_torch.structure import to_pdb

    prot = from_pdb_file(PDB, chain_id="D")
    bb_mask = np.zeros_like(prot.atom_mask)
    bb_mask[:, :4] = prot.atom_mask[:, :4]
    pdb = tmp_path / "bb_only.pdb"
    pdb.write_text(to_pdb(dataclasses.replace(prot, atom_mask=bb_mask)))
    metrics = run(_args(tmp_path / "out", pdb=pdb))
    assert set(metrics) == {"sampling_seconds"}
    assert (tmp_path / "out" / "structure.pdb").exists()


def test_prox_reports_clashscores_as_jax(tmp_path):
    """cli.prox's clashscore_before / _after are the JAX package's
    clashscore of its input and of the written structure."""
    from packppi_tpu.utils.analysis import ProteinAnalysis as JaxAnalysis

    from packppi_torch.cli import prox

    result = prox.run(prox.build_parser().parse_args(
        ["--input", PDB, "--outdir", str(tmp_path), "--device", "cpu", "--num_steps", "3",
         "--exact_length"]))
    jax = JaxAnalysis(tmp_dir=str(tmp_path / "jax"))
    assert result["clashscore_before"] == jax.get_clashscore(PDB)
    assert result["clashscore_after"] == jax.get_clashscore(str(tmp_path / "structure.pdb"))
    assert json.loads((tmp_path / "metrics.json").read_text()) == result
