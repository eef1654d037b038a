"""``packppi_torch.utils.trace``: spans that cost one flag check while no
profiler records, and under ``torch.profiler.profile`` lie in its trace and
in memory, on the trace's clock, with the kernels' launch counts of the
stretch. This file imports neither JAX nor ``conftest``; its card test runs
as

    python -m pytest --noconftest -m gpu tests/test_torch_trace.py
"""
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from packppi_torch.utils import trace

from torch_threads import _threads  # noqa: F401 (autouse fixture)

REPO = os.path.join(os.path.dirname(__file__), "..")
FIXTURES = os.path.join(REPO, "tests", "fixtures")


def _off_span():
    with trace.span("off"):
        pass


def _tiny_pack():
    """Parse, featurize, sample (2 steps), refine (3 Adam steps), rebuild and
    write 1BRS, as ``cli.pack --use_proximal`` does, at narrow widths on the
    CPU's plain route."""
    from packppi_torch.cli._directory import merge_output_structure
    from packppi_torch.data import stack_batch
    from packppi_torch.geometry import atom14_coords_from_torsions
    from packppi_torch.models import NetworkConfig, TorsionalDiffusion
    from packppi_torch.sampling import proximal_optimize
    from packppi_torch.structure import featurize, from_pdb_file, to_pdb
    from packppi_torch.weights import init_weights

    model = TorsionalDiffusion(NetworkConfig(node_features=32, edge_features=32, hidden_dim=32,
                                             top_k=8))
    init_weights(model.net, 0)
    prot = from_pdb_file(os.path.join(FIXTURES, "1brs.pdb"), mse_to_met=True)
    feats = featurize(prot)
    batch = stack_batch([feats], torch.device("cpu"))
    sc = model.sample(batch, torch.Generator().manual_seed(0), n_steps=2)
    sc = proximal_optimize(batch, sc, num_steps=3).SC_D
    with torch.no_grad():
        coords = atom14_coords_from_torsions(batch.X, batch.residue_type, batch.BB_D, sc)
    out = merge_output_structure(prot, feats, batch.atom_mask.cpu().numpy(),
                                 coords.cpu().numpy(), len(feats["residue_type"]))
    return to_pdb(out)


def test_span_is_live_exactly_while_torch_profiler_records():
    """The flag the span reads is ``torch.autograd.profiler._is_profiler_enabled``,
    which ``torch.profiler.profile`` sets for its duration."""
    assert not torch.autograd.profiler._is_profiler_enabled
    assert trace.span("x") is trace._OFF
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled
        assert trace.span("x") is not trace._OFF
    assert not torch.autograd.profiler._is_profiler_enabled
    assert trace.span("x") is trace._OFF


def test_span_off_is_one_shared_noop(monkeypatch):
    """No profiler: the same object every call, no annotation, no clock, no
    record."""
    _off_span()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("kept"):
            pass
    before = trace.records()

    def boom(*a, **k):
        raise AssertionError("an off span touched the profiler or the clock")

    monkeypatch.setattr(trace, "record_function", boom)
    monkeypatch.setattr(trace.time, "time_ns", boom)
    monkeypatch.setattr(trace, "counters", boom)
    first = trace.span("a")
    assert all(trace.span(n) is first for n in ("a", "b", "sample.step"))
    for _ in range(3):
        with trace.span("a"):
            with trace.span("b"):
                pass
    monkeypatch.undo()
    assert trace.records() == before
    assert [s.name for s in before] == ["kept"]


def test_profiled_pack_records_every_span_on_the_trace_clock(tmp_path):
    """A tiny pack under the profiler: the spans in memory, their counts and
    nesting, the same ``packppi.*`` annotations in the exported Chrome trace,
    each in-memory start within 1 ms of its event's, and no launch on the
    CPU's plain route."""
    _off_span()
    with profile(activities=[ProfilerActivity.CPU]) as p:
        pdb = _tiny_pack()
    assert pdb.startswith("MODEL")
    rep = trace.report()
    assert {k: v["n"] for k, v in rep["spans"].items()} == {
        "structure.featurize": 1, "sample.encode": 1, "sample.step": 2, "refine.step": 3,
        "structure.to_pdb": 1}
    assert all(v["total_s"] > 0 for v in rep["spans"].values())
    assert rep["counters"] == {k: 0 for k in trace.counters()}
    recs = trace.records()
    main = threading.get_native_id()
    assert all(s.thread == main and s.parent is None for s in recs)
    assert [s.name for s in sorted(recs, key=lambda s: s.start_ns)] == [
        "structure.featurize", "sample.encode", "sample.step", "sample.step",
        "refine.step", "refine.step", "refine.step", "structure.to_pdb"]

    path = tmp_path / "trace.json"
    p.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base = int(doc["baseTimeNanoseconds"])
    events = sorted((e for e in doc["traceEvents"] if e.get("ph") == "X"
                     and e.get("name", "").startswith("packppi.")), key=lambda e: float(e["ts"]))
    assert [e["name"][len("packppi."):] for e in events] == [
        s.name for s in sorted(recs, key=lambda s: s.start_ns)]
    for e, s in zip(events, sorted(recs, key=lambda s: s.start_ns)):
        assert abs(float(e["ts"]) * 1e3 + base - s.start_ns) < 1e6, (e, s)
        assert int(e["tid"]) == s.thread


def test_nested_spans_name_their_parent_and_close_the_stretch():
    _off_span()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("outer"):
            with trace.span("inner"):
                pass
            with trace.span("inner"):
                pass
    recs = trace.records()
    assert [(s.name, s.parent) for s in recs] == [("inner", "outer"), ("inner", "outer"),
                                                  ("outer", None)]
    outer = recs[-1]
    assert all(outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns for s in recs[:2])
    assert trace.report()["spans"]["inner"]["n"] == 2


def test_worker_thread_span_is_recorded_with_its_thread_id():
    """The profiler's trace keeps the annotations of the thread that started
    it only; the span in memory keeps the worker's native thread id, with no
    parent from the main thread's open span."""
    _off_span()
    with ThreadPoolExecutor(max_workers=1) as pool:
        with profile(activities=[ProfilerActivity.CPU]):
            with trace.span("main"):
                def work():
                    with trace.span("worker"):
                        time.sleep(0.001)
                    return threading.get_native_id()

                tid = pool.submit(work).result(timeout=30)
    by = {s.name: s for s in trace.records()}
    assert tid != threading.get_native_id()
    assert by["worker"].thread == tid and by["worker"].parent is None
    assert by["main"].thread == threading.get_native_id()


def test_second_profiled_stretch_replaces_the_first():
    _off_span()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with trace.span("first"):
                pass
    assert {k: v["n"] for k, v in trace.report()["spans"].items()} == {"first": 2}
    _off_span()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("second"):
            pass
    assert list(trace.report()["spans"]) == ["second"]
    assert [s.name for s in trace.records()] == ["second"]
    # what the stretch kept outlives the profiler and later off spans
    _off_span()
    assert list(trace.report()["spans"]) == ["second"]


def test_counters_are_every_kernel_wrappers_launches():
    from packppi_torch.ops import attention, chain, clash, gemm, layer, message, message_feat

    c = trace.counters()
    assert set(c) == {"message", "message_gather", "message_geom", "message_chain",
                      "message_feat", "chain", "layer_node", "layer_edge", "attention",
                      "clash_fwd", "clash_bwd", "gemm"}
    assert c["message"] == message.message.launches
    assert c["message_feat"] == message_feat.message_feat.launches
    assert c["chain"] == chain.chain.launches
    assert c["layer_edge"] == layer.layer_edge.launches
    assert c["attention"] == attention.mha.launches
    assert c["clash_bwd"] == clash.between_residue_clash.launches_bwd
    assert c["gemm"] == gemm.linear.launches


def test_cpu_refinement_counts_eager_steps_apart_from_the_launches():
    """On the CPU the Adam loop runs eagerly: a refinement of ``steps``
    steps counts as many eager steps, no capture and no replay, in
    ``engagement()`` and in the profiled stretch's report, and
    ``counters()`` keeps its 12 launch counters, none of which moved."""
    from packppi_torch.data import stack_batch
    from packppi_torch.sampling import proximal_optimize
    from packppi_torch.structure import featurize, from_pdb_file

    feats = featurize(from_pdb_file(os.path.join(FIXTURES, "1brs.pdb"), mse_to_met=True))
    batch = stack_batch([feats], torch.device("cpu"), target_len=len(feats["residue_type"]))
    sc = batch.SC_D + 0.5 * torch.randn(batch.SC_D.shape,
                                         generator=torch.Generator().manual_seed(0))
    steps = 2
    before, launches = trace.engagement(), trace.counters()
    _off_span()
    with profile(activities=[ProfilerActivity.CPU]):
        proximal_optimize(batch, sc, num_steps=steps)
    after = trace.engagement()
    want = {k: 0 for k in after}
    want["eager_steps"] = steps
    assert {k: after[k] - before[k] for k in after} == want
    rep = trace.report()
    assert rep["engagement"] == want
    assert rep["spans"]["refine.step"]["n"] == steps
    assert len(trace.counters()) == 12 and trace.counters() == launches
    assert rep["counters"] == {k: 0 for k in launches}


def test_cpu_sample_counts_eager_steps_apart_from_the_refinement():
    """On the CPU the sampler runs eagerly: a 3-step sample counts 3 eager
    ODE steps under the sampler's keys, no capture and no replay, and
    leaves the refinement's keys (``refine_graphed.*`` reads them) as they
    were, in ``engagement()`` and in the profiled stretch's report."""
    from packppi_torch.data import stack_batch
    from packppi_torch.models import NetworkConfig, TorsionalDiffusion
    from packppi_torch.structure import featurize, from_pdb_file
    from packppi_torch.weights import init_weights

    model = TorsionalDiffusion(NetworkConfig(node_features=32, edge_features=32, hidden_dim=32,
                                             top_k=8))
    init_weights(model.net, 0)
    feats = featurize(from_pdb_file(os.path.join(FIXTURES, "1brs.pdb"), mse_to_met=True))
    batch = stack_batch([feats], torch.device("cpu"))
    before = trace.engagement()
    _off_span()
    with profile(activities=[ProfilerActivity.CPU]):
        model.sample(batch, torch.Generator().manual_seed(0), n_steps=3)
    after = trace.engagement()
    want = {k: 0 for k in after}
    want["sample_eager_steps"] = 3
    assert {k: after[k] - before[k] for k in after} == want
    rep = trace.report()
    assert rep["engagement"] == want
    assert rep["spans"]["sample.step"]["n"] == 3
    assert {"graph_captures", "graph_replays", "eager_steps", "sample_graph_captures",
            "sample_graph_replays", "sample_eager_steps", "affinity_graph_captures",
            "affinity_graph_replays", "affinity_eager_passes"} == set(after)


@pytest.mark.gpu
def test_profiled_t1124_pack_counts_its_launches(tmp_path):
    """``cli.pack --use_proximal`` on T1124 under the profiler: 30 steps of 5
    message and 5 chain launches, 51 clash forward (the clash mask and 50
    Adam steps) and 50 gradient launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from packppi_torch.cli.pack import build_parser, run

    args = build_parser().parse_args([
        "--input", os.path.join(FIXTURES, "t1124.pdb"), "--outdir", str(tmp_path),
        "--ckpt", os.path.join(REPO, "docs", "ckpts", "diffusion_crops", "torch_state.pt"),
        "--use_proximal"])
    run(args)                                   # builds the kernels, warms the shapes
    _off_span()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        run(args)
    rep = trace.report()
    want = {k: 0 for k in trace.counters()}
    want.update(message=150, chain=150, clash_fwd=51, clash_bwd=50)
    assert rep["counters"] == want
    assert rep["spans"]["sample.encode"]["n"] == 1
    assert rep["spans"]["sample.step"]["n"] == 30
    assert rep["spans"]["refine.step"]["n"] == 50
    # the Adam and ODE steps are replays: the refinement's shape was captured
    # by the first run, and the run's new model captures its ODE step once
    want = {k: 0 for k in trace.engagement()}
    want.update(graph_replays=50, sample_graph_captures=1, sample_graph_replays=30)
    assert rep["engagement"] == want
