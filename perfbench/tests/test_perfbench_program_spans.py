"""A traced run of each cell on the CPU at a tiny size prints every metric
read from the program's own spans and launch counters
(``harness/program.py``): the host-ms ones above 0, the launches at 0 (the
CPU's plain route launches no kernel). The profiler runs on a CPU-only torch
and warns that it cannot trace CUDA."""
import json

import pytest

from perfbench import run as bench_run
from perfbench.harness import common

TINY = {"config": {"sampler": {"mode": "ode", "n_steps": 2, "annealed_temp": 3.0},
                   "refinement": {"num_steps": 2, "lr": 0.01, "lamda": 1.0,
                                  "violation_tolerance_factor": 12.0,
                                  "clash_overlap_tolerance": 0.5}},
        "traffic": {"complexes": ["1brs.pdb"], "trace_chunks": 1, "check_chunks": 1}}
TINY_BATCH = {"config": TINY["config"], "traffic": dict(TINY["traffic"], per_chunk=2)}
TINY_DDG = {"traffic": {"check_batches": 1, "trace_batches": 1}}

NEW = {"msc-pack-single": ["encode_ms.pack_single", "sample_step_ms.pack_single",
                           "refine_step_ms.pack_single", "launches.pack_single"],
       "msc-pack-batch": ["sample_step_ms.pack_batch", "featurize_one_ms.pack_batch",
                          "to_pdb_ms.pack_batch", "launches.pack_batch"],
       "ap-ddg-scan": ["backbone_ms.ap_ddg", "mutation_ms.ap_ddg", "launches.ap_ddg"]}


@pytest.mark.parametrize("workload,overrides", [
    ("msc-pack-single", TINY), ("msc-pack-batch", TINY_BATCH), ("ap-ddg-scan", TINY_DDG)])
def test_traced_run_prints_the_program_span_metrics(workload, overrides):
    args = bench_run.parse(["--workload", workload, "--seed", "2147483659", "--seconds", "0.1",
                            "--trace", "1"])
    code, line = bench_run.run(args, require_cuda=False, overrides=overrides)
    assert code == 0
    out = json.loads(line)
    assert out["correct"], out["checks"]
    declared = [m["name"] for m in common.load_spec(workload)["per_layer"]]
    for name in NEW[workload]:
        assert name in declared
        value = out["metrics"][name]["value"]
        if name.startswith("launches."):
            assert value == 0, (name, value)
        else:
            assert value > 0, (name, value)


def test_untraced_run_reads_no_program_span():
    """Without a profiled stretch each reader is silent, whatever the
    program kept from an earlier one."""
    import types

    ctx = types.SimpleNamespace(trace=None, work=None)
    for names in NEW.values():
        for name in names:
            assert common.metric_reader(name)(ctx) is None
