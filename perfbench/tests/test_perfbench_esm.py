"""The cell ``ap-ddg-esm`` (kind ``ddg_esm``, configuration ``esm2_650m``):
found by name; driven end to end on the CPU at a tiny width (2 layers,
hidden 64), it is correct, and it is not under each planted fault nor with
the TF32 control in the program's place; its traced run prints the
program's span and launch metrics; its cost functions against hand counts.
The card test runs the cell at full size, traced."""
import importlib
import json
import subprocess
import sys
import types

import pytest

from perfbench import run as bench_run
from perfbench.harness import common, costs, costs_esm
from perfbench.reference.precision import BELOW

CELL = "ap-ddg-esm"
TINY = {"config": {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
                   "intermediate_size": 128, "head": {"esm_dim": 64, "strict_parity": True}},
        "traffic": {"check_batches": 2, "trace_batches": 1}}
METRICS = ["featurize_ms.ap_esm", "loader_wait_ms.ap_esm", "predict_ms.ap_esm", "esm_ms.ap_esm",
           "attention_roofline.ap_esm", "idle.ap_esm", "mfu.ap_esm", "launches.ap_esm"]
SEED = 2147483659


def _run(trace=0, faults=()):
    args = bench_run.parse(["--workload", CELL, "--seed", str(SEED), "--seconds", "0.1",
                            "--trace", str(trace)])
    code, line = bench_run.run(args, require_cuda=False, faults=faults,
                               overrides=json.loads(json.dumps(TINY)))
    assert code == 0
    return json.loads(line)


def test_the_cell_is_found_by_name():
    spec = common.load_spec(CELL)
    assert spec["traffic"]["kind"] == "ddg_esm" and spec["cell"]["config"] == "esm2_650m"
    assert spec["config"]["hidden_size"] == 1280 and spec["config"]["num_hidden_layers"] == 33
    assert {m["name"] for m in spec["end_to_end"]} == {"ddg_mutations_per_s", "setup_s"}
    assert [m["name"] for m in spec["per_layer"]] == METRICS
    assert all(common.metric_reader(m) is not None for m in METRICS)


@pytest.mark.parametrize("faults,caught", [
    ((), None),
    (("esm_block_dropped",), "embed_gap"),
    (("mutant_not_embedded",), "embed_gap"),
    (("half_batch",), "ddg_gap"),
])
def test_fault_makes_the_run_incorrect(faults, caught):
    out = _run(faults=faults)
    failed = [k for k, v in out["checks"].items() if v["value"] > v["limit"]]
    assert set(out["checks"]) == {"token_gap", "embed_gap", "ddg_gap"}
    if caught is None:
        assert out["correct"] and not failed, out["checks"]
    else:
        assert not out["correct"] and caught in failed, out["checks"]


def test_tf32_control_fails():
    import torch

    spec = common.load_spec(CELL)
    for part, values in TINY.items():
        spec[part].update(values)
    cell = importlib.import_module("perfbench.harness.ddg_esm").Cell(spec, SEED,
                                                                    torch.device("cpu"))
    cell.setup()
    cell.window(0.1)
    cell.release()
    sound, control = cell.check(), cell.check(BELOW["float32"])
    limits = spec["traffic"]["limits"]
    assert sound.correct
    assert control.values["embed_gap"] > limits["embed_gap"], control.values
    assert control.values["ddg_gap"] > limits["ddg_gap"], control.values


def test_traced_run_prints_the_program_metrics():
    out = _run(trace=1)
    assert out["correct"], out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    # the CPU's plain route launches no kernel and the profiler sees no device
    assert m["launches.ap_esm"] == 0 and "attention_roofline.ap_esm" not in m
    for name in ("featurize_ms.ap_esm", "predict_ms.ap_esm", "esm_ms.ap_esm"):
        assert m[name] > 0, name


def test_untraced_run_reads_no_program_span():
    ctx = types.SimpleNamespace(trace=None, work=None)
    for name in ("esm_ms.ap_esm", "launches.ap_esm", "attention_roofline.ap_esm", "idle.ap_esm"):
        assert common.metric_reader(name)(ctx) is None


def test_costs_against_hand_counts():
    cfg = {"hidden_size": 8, "intermediate_size": 32, "num_hidden_layers": 2,
           "num_attention_heads": 2}
    # n = 5 tokens: per token per block 4 d^2 + 2 d f multiply-adds, and 2 n d in attention
    assert costs_esm.esm_flops(5, cfg) == 2 * 2 * 5 * (4 * 64 + 2 * 8 * 32 + 2 * 5 * 8)
    nb, no = costs_esm.attention_pass(2, 3, 16, 4, "float32")
    assert no == 4 * 2 * 3 * 16 * 16 * 4
    assert nb == 3 * 2 * 3 * 16 * 4 * 4 + 2 * 16 * 4 + 2 * 3 * 16 * 4 * 4
    work = [(1, 2, 16, cfg, "float32")]
    assert costs_esm.attention_bound_s(work) == pytest.approx(
        2 * costs.bound_s(*costs_esm.attention_pass(2, 2, 16, 4, "float32"), "float32"))
    assert costs_esm.head_flops(4) == 2 * 2 * (2 * 16 + 4)


@pytest.mark.gpu
def test_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, str(common.BENCH / "run.py"), "--workload", CELL,
                        "--seed", "3221225473", "--seconds", "3", "--trace", "1"],
                       capture_output=True, text=True, timeout=1200, cwd=common.ROOT)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(m) == set(METRICS) and m["launches.ap_esm"] == 33
    assert 0 < m["attention_roofline.ap_esm"] <= 100 and 0 < m["mfu.ap_esm"] <= 100
