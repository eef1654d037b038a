"""A run driven end to end on the CPU at a tiny size (the look for a chip
skipped): sound, it is correct; with the timed path broken underneath, the
comparison with the plain reference says it is not. And the control: the
reference itself at the precision below the configuration's fails the
comparison where the program passes."""
import json

import pytest

from perfbench import run as bench_run
from perfbench.harness import common
from perfbench.reference.precision import BELOW

TINY = {"config": {"sampler": {"mode": "ode", "n_steps": 2, "annealed_temp": 3.0},
                   "refinement": {"num_steps": 2, "lr": 0.01, "lamda": 1.0,
                                  "violation_tolerance_factor": 12.0,
                                  "clash_overlap_tolerance": 0.5}},
        "traffic": {"complexes": ["1brs.pdb"], "trace_chunks": 1, "check_chunks": 1}}
TINY_BATCH = {"config": TINY["config"], "traffic": dict(TINY["traffic"], per_chunk=2)}
# enough Adam steps (lr 1e-2) that skipping them moves a chi past the limit
LONG = {"config": dict(TINY["config"], refinement=dict(TINY["config"]["refinement"], num_steps=25)),
        "traffic": TINY["traffic"]}
LONG_BATCH = {"config": LONG["config"], "traffic": TINY_BATCH["traffic"]}
TINY_DDG = {"traffic": {"check_batches": 1, "trace_batches": 1}}


def _run(workload, overrides, faults=()):
    args = bench_run.parse(["--workload", workload, "--seed", "2147483659", "--seconds", "0.1",
                            "--trace", "0"])
    code, line = bench_run.run(args, require_cuda=False, faults=faults, overrides=overrides)
    assert code == 0
    return json.loads(line)


@pytest.mark.parametrize("workload,overrides,faults,caught", [
    ("msc-pack-single", TINY, (), None),
    ("msc-pack-single", TINY, ("sampler_frozen",), "step_gap"),
    ("msc-pack-single", LONG, ("refine_skipped",), "refine_gap"),
    ("msc-pack-single", TINY, ("write_unrefined",), "pdb_gap"),
    ("msc-pack-single", TINY, ("feature_chi_zero",), "feature_gap"),
    ("msc-pack-batch", TINY_BATCH, ("pick_worst",), "pick_gap"),
    ("msc-pack-batch", LONG_BATCH, ("half_batch",), "refine_gap"),
    ("ap-ddg-scan", TINY_DDG, (), None),
    ("ap-ddg-scan", TINY_DDG, ("half_batch",), "ddg_gap"),
    ("ap-ddg-scan", TINY_DDG, ("feature_mutation_dropped",), "feature_gap"),
])
def test_fault_makes_the_run_incorrect(workload, overrides, faults, caught):
    out = _run(workload, overrides, faults)
    failed = [k for k, v in out["checks"].items() if v["value"] > v["limit"]]
    if caught is None:
        assert out["correct"] and not failed, out["checks"]
    else:
        assert not out["correct"] and caught in failed, out["checks"]


@pytest.mark.parametrize("workload,overrides,number", [
    ("msc-pack-single", TINY, "step_gap"), ("ap-ddg-scan", TINY_DDG, "ddg_gap")])
def test_control_fails(workload, overrides, number):
    """The reference in the program's place, one precision down, reads past
    the limit that the program keeps."""
    import importlib

    import torch

    spec = common.load_spec(workload)
    for part, values in overrides.items():
        spec[part].update(values)
    cell = importlib.import_module(f"perfbench.harness.{spec['traffic']['kind']}").Cell(
        spec, 2147483659, torch.device("cpu"))
    cell.setup()
    cell.window(0.1)
    cell.release()
    sound, control = cell.check(), cell.check(BELOW[spec["traffic"]["precision"]])
    assert sound.correct
    assert control.values[number] > spec["traffic"]["limits"][number], control.values
