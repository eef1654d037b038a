"""``predict_graphed.ap_ddg`` on the CPU at a tiny size: a traced run of
``ap-ddg-scan`` reads 0.0, since off the card every PackPPI-AP pass runs
eagerly, beside the span metrics of the same passes; without a profiled
stretch it reads nothing."""
import json
import types

from perfbench import run as bench_run
from perfbench.harness import common

NAME = "predict_graphed.ap_ddg"


def test_traced_cpu_run_reads_every_pass_eager():
    args = bench_run.parse(["--workload", "ap-ddg-scan", "--seed", "3221225479",
                            "--seconds", "0.1", "--trace", "1"])
    code, line = bench_run.run(args, require_cuda=False,
                               overrides={"traffic": {"check_batches": 1, "trace_batches": 1}})
    assert code == 0
    out = json.loads(line)
    assert out["correct"], out["checks"]
    assert NAME in [m["name"] for m in common.load_spec("ap-ddg-scan")["per_layer"]]
    assert out["metrics"][NAME]["value"] == 0.0
    assert out["metrics"]["backbone_ms.ap_ddg"]["value"] > 0
    assert out["metrics"]["mutation_ms.ap_ddg"]["value"] > 0


def test_untraced_run_reads_nothing():
    assert common.metric_reader(NAME)(types.SimpleNamespace(trace=None, work=None)) is None
