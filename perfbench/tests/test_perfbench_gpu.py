"""On the card: each cell runs, traced, and comes out correct with the
device's numbers in its line. Skipped without a CUDA device."""
import json
import subprocess
import sys

import pytest

from perfbench.harness import common


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["msc-pack-single", "ap-ddg-scan", "msc-pack-batch"])
def test_cell_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, str(common.BENCH / "run.py"), "--workload", workload,
                        "--seed", "3221225473", "--seconds", "3", "--trace", "1"],
                       capture_output=True, text=True, timeout=1200, cwd=common.ROOT)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
    assert out["metrics"] and len(out["breakdown"]["device_ops"]) <= 10
