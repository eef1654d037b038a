"""``python -m packppi_torch.cli.pack`` end to end on the CPU: 1BRS, two
steps, the reference weights of ``pipeline_golden.npz``."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from packppi_torch.cli.pack import build_parser, run
from packppi_torch.structure import from_pdb_file

from conftest import FIXTURES, GOLDEN

REPO = os.path.join(os.path.dirname(__file__), "..")
PDB = os.path.join(FIXTURES, "1brs.pdb")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    """xdist workers share the machine's cores: two torch threads each."""
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(min(2, torch.get_num_threads()))


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
