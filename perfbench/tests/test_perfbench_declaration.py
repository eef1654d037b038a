"""BENCHMARK.json against the contract, and the harness finding a cell, its
configuration, its traffic mix and its metrics by name alone."""
import json
import re
import shutil

import pytest

from perfbench.harness import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
BENCH = json.loads((common.ROOT / "BENCHMARK.json").read_text())


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"] and BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert len((common.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and all(m["bound"] <= 0.25 for m in e2e.values())
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        spec = common.load_spec(w["name"])
        got = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in got and len(got) >= 2, w["name"]
        assert spec["per_layer"], w["name"]
        for m in spec["per_layer"]:
            assert m["moves"] in got, (w["name"], m["name"])
            assert common.metric_reader(m["name"]) is not None
    for c in BENCH["configs"]:
        assert (common.ROOT / c["file"]).exists() and c["reduced"] == []
    layers = {m["name"].split(".")[0]: m["layer"] for m in BENCH["per_layer"]}
    for m in BENCH["per_layer"]:
        assert m["layer"] == layers[m["name"].split(".")[0]] or "_roofline" in m["name"]
        if m["unit"] == "%":
            assert "roofline" in m["name"] or "mfu" in m["name"] or "idle" in m["name"]


def test_a_cell_added_as_files_is_found(tmp_path):
    """A later cell, configuration, mix and metric need only new files and
    entries: nothing that exists is edited."""
    root = tmp_path / "checkout"
    shutil.copytree(common.BENCH, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "data"))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "dummy_cfg", "source": "https://example.org/paper",
                             "file": "perfbench/configs/dummy_cfg.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "dummy-cell", "config": "dummy_cfg",
                               "traffic": "dummy_mix", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "dummy_ms.cell", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "dummy", "moves": "setup_s",
                               "workloads": ["dummy-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "perfbench/configs/dummy_cfg.json").write_text('{"hidden_dim": 7}')
    (root / "perfbench/traffic/dummy_mix.json").write_text('{"kind": "pack", "n": 3}')
    (root / "perfbench/metrics/dummy_ms.cell.py").write_text("def read(ctx):\n    return 4.5\n")
    spec = common.load_spec("dummy-cell", root)
    assert spec["config"] == {"hidden_dim": 7} and spec["traffic"]["n"] == 3
    assert [m["name"] for m in spec["per_layer"]] == ["dummy_ms.cell"]
    assert [m["name"] for m in spec["end_to_end"]] == ["setup_s"]
    assert common.metric_reader("dummy_ms.cell", root)(None) == 4.5
    # the cells that were there are found as before
    assert common.load_spec("msc-pack-single", root)["traffic"]["kind"] == "pack"
    with pytest.raises(SystemExit):
        common.load_spec("no-such-cell", root)
