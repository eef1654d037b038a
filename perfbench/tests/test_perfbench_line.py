"""The result line, the refusal without a card, and the import guard."""
import json
import subprocess
import sys

import pytest

from perfbench import run as bench_run
from perfbench.harness import common


def test_result_line_keys():
    checks = {"step_rms": {"value": 0.01, "limit": 0.1}}
    dev = {"platform": "gpu", "kind": "X", "count": 1, "memory_peak_bytes": 1}
    plain = json.loads(common.result_line(True, 3, 0, {}, dev, checks))
    assert list(plain) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    traced = json.loads(common.result_line(True, 3, 0, {}, dev, checks,
                                           {"device_ops": [], "idle_gaps": []}))
    assert list(traced) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                            "checks"]


def test_no_card_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code, line = bench_run.run(bench_run.parse(["--workload", "msc-pack-single", "--seed", "1",
                                                "--seconds", "1", "--trace", "0"]))
    assert code != 0 and line is None
    assert "needs 1 CUDA device" in capsys.readouterr().err


def test_no_card_no_result_process():
    if __import__("torch").cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, str(common.BENCH / "run.py"), "--workload",
                        "msc-pack-single", "--seed", "4294967311", "--seconds", "1",
                        "--trace", "1"], capture_output=True, text=True, timeout=300,
                       cwd=common.ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.parametrize("name,found", [("jax", True), ("jax.numpy", True), ("flax.linen", True),
                                        ("optax", True), ("packppi_tpu.models", True),
                                        ("chip_smoke", True), ("jaxtyping", False),
                                        ("packppi_torch", False), ("flaxen", False)])
def test_guard_compares_whole_top_level_names(monkeypatch, name, found):
    monkeypatch.setitem(sys.modules, name, object())
    assert (name.split(".")[0] in common.forbidden_modules()) == found


def test_reference_and_harness_import_no_program_and_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import perfbench.reference.net, perfbench.reference.pack, "
            "perfbench.reference.affinity, perfbench.reference.precision, "
            "perfbench.reference.structure\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('packppi_torch', 'jax', 'jaxlib', 'flax', 'optax', 'packppi_tpu', 'chip_smoke')]\n"
            "assert not bad, bad\n") % str(common.ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
