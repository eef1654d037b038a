"""PackPPI-AP's ``predict`` on the card (marker ``gpu``; skipped without a
CUDA device): the backbone's and the mutation stack's passes replayed from
one CUDA graph a shape against the same passes run eagerly on the card, in
float32 with the ddG CLI's routing. This file imports neither JAX nor
``conftest``, so on a machine without JAX it runs as

    python -m pytest --noconftest -m gpu tests/test_torch_affinity_gpu.py
"""
import os
import sys
import threading

import pytest
import torch

pytestmark = pytest.mark.gpu

SKEMPI_MINI = os.path.join(os.path.dirname(__file__), "fixtures", "skempi_mini")
# the replays run the eager passes' operations on the same numbers: equal
# bits are expected, and this (kcal/mol) is the most that fails the test
TOLERANCE = 1e-6
# (B, complex): 1BRS pads to bucket 256, 2FTL to 384
SHAPES = ((4, "1BRS"), (2, "1BRS"), (4, "2FTL"), (1, "2FTL"))


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def mutations():
    """SKEMPI mini's mutations by complex, each featurized with its twin."""
    from packppi_torch.data.skempi import load_skempi_entries, skempi_features
    from packppi_torch.structure import from_pdb_file

    out: dict = {}
    proteins: dict = {}
    for e in load_skempi_entries(SKEMPI_MINI, "PDBs"):
        prot = proteins.setdefault(e["pdb_path"], from_pdb_file(e["pdb_path"], mse_to_met=True))
        out.setdefault(e["pdb_id"], []).append(skempi_features(prot, e["mutations"],
                                                               ddg=e["ddG"]))
    return out


def _model(cuda, mode="network", dropout=0.1):
    """PackPPI-AP at its published widths in float32, routed as the ddG CLI
    routes it, random weights from seeds 0 and 1."""
    from packppi_torch.models import NetworkConfig
    from packppi_torch.models.affinity import AffinityModel
    from packppi_torch.weights import init_weights

    m = AffinityModel(NetworkConfig(dropout=dropout), mode)
    init_weights(m.backbone.net, 0)
    init_weights(m.net, 1)
    return m.to(cuda)


@pytest.fixture
def model(cuda):
    return _model(cuda)


def _batch(mutations, name, rows, cuda, start=0):
    from packppi_torch.data.skempi import stack_affinity_batch

    return stack_affinity_batch(mutations[name][start:start + rows], cuda)


def _eager(model, batch):
    """The same three passes run eagerly on the card, one call each (the
    net in eval(), as ``predict`` sets it)."""
    model.net.eval()
    with torch.no_grad():
        h = [model.pret(b) for b in (batch.wild(), batch.mutant())]
        return model._mutation_pass(batch, *h)


def _gap(got, want):
    return max((g - w).abs().max().item() for g, w in zip(got, want))


@pytest.mark.parametrize("mode", ["network", "linear"])
@pytest.mark.parametrize("rows,name", SHAPES)
def test_graphed_predict_matches_the_eager_passes(cuda, mutations, mode, rows, name):
    """(B, L) = (4, 256), (2, 256), (4, 384) and (1, 384): ddg and its
    antisymmetric twin against the eager passes' (bit for bit expected,
    1e-6 kcal/mol at most), with the same launches of each kernel (40 a
    batch in network mode, 20 in linear), two captures and three replays
    counted as such and no eager pass."""
    from packppi_torch.utils import trace

    model = _model(cuda, mode)
    batch = _batch(mutations, name, rows, cuda)
    c0, e0 = trace.counters(), trace.engagement()
    want = _eager(model, batch)
    c1, e1 = trace.counters(), trace.engagement()
    with torch.no_grad():
        got = model.predict(batch)
    c2, e2 = trace.counters(), trace.engagement()
    torch.cuda.synchronize()
    gap = _gap(got, want)
    print(f"{mode} B = {rows}, L = {batch.X.shape[1]}: largest gap {gap:.3e} kcal/mol, "
          f"bit for bit: {all(torch.equal(g, w) for g, w in zip(got, want))}")
    assert gap <= TOLERANCE
    assert all(g.shape == (rows,) for g in got)
    eager = {k: c1[k] - c0[k] for k in c0}
    assert {k: c2[k] - c1[k] for k in c1} == eager
    assert eager["message"] == eager["chain"] == (20 if mode == "network" else 10)
    assert sum(eager.values()) == (40 if mode == "network" else 20)
    assert {k: e1[k] - e0[k] for k in e0} == {k: 0 for k in e0}
    want_e = {k: 0 for k in e1}
    want_e.update(affinity_graph_captures=2, affinity_graph_replays=3)
    assert {k: e2[k] - e1[k] for k in e1} == want_e


def test_alternating_shapes_reuse_their_graphs(model, cuda, mutations):
    """The four shapes in turn, twice: each call gives the bits of its
    shape's first call, and the second and third rounds capture nothing."""
    from packppi_torch.utils import trace

    batches = [_batch(mutations, name, rows, cuda, start=i) for i, (rows, name)
               in enumerate(SHAPES)]
    with torch.no_grad():
        first = [model.predict(b) for b in batches]
        captures = trace.engagement()["affinity_graph_captures"]
        for _ in range(2):
            for b, want in zip(batches, first):
                assert all(torch.equal(g, w) for g, w in zip(model.predict(b), want))
    assert trace.engagement()["affinity_graph_captures"] == captures
    assert len(model._backbone_graphs.entries) == len(model._mutation_graphs.entries) == 4


@pytest.mark.parametrize("part", ["backbone", "net"])
def test_weights_written_in_place_are_seen_by_the_replay(model, cuda, mutations, part):
    """A message weight of the backbone or of the mutation stack scaled in
    place between two calls of one shape (the kernel reads a packed copy of
    it, made outside the graph): that pass's graph is captured again, and
    the call gives the eager passes' ddG under the new weights."""
    from packppi_torch.utils import trace

    batch = _batch(mutations, "1BRS", 4, cuda)
    with torch.no_grad():
        before = model.predict(batch)
    stack = model.backbone.net.mpnn if part == "backbone" else model.net.mutation_mpnn
    w = stack.mpnn_layers[0].node_message_fn.W_in.weight
    captures = trace.engagement()["affinity_graph_captures"]
    with torch.no_grad():
        w.mul_(1.5)
        after = model.predict(batch)
    assert trace.engagement()["affinity_graph_captures"] == captures + 1
    assert not torch.equal(after[0], before[0])
    assert _gap(after, _eager(model, batch)) <= TOLERANCE


def test_returned_predictions_outlive_the_next_call(model, cuda, mutations):
    """What a call returns is its own: a later call at the same shape, which
    loads the graphs' buffers anew, leaves the first call's ddG as it was."""
    first, second = (_batch(mutations, "1BRS", 4, cuda, start=s) for s in (0, 4))
    with torch.no_grad():
        got = model.predict(first)
        kept = tuple(t.clone() for t in got)
        other = model.predict(second)
    torch.cuda.synchronize()
    assert all(torch.equal(g, k) for g, k in zip(got, kept))
    assert not torch.equal(other[0], got[0])


def test_threads_of_one_shape_get_their_own_results(model, cuda, mutations):
    """Twelve threads (more than the host's cores) predict one shape at
    once, each its own mutation, three times, with the interpreter switching
    threads every 10 us (as ``cli.serve`` runs requests, more often): each
    gets the ddG its mutation gives alone."""
    batches = [_batch(mutations, "1BRS", 1, cuda, start=i) for i in range(12)]
    with torch.no_grad():
        alone = [model.predict(b) for b in batches]
    out = [[] for _ in batches]

    def run(i):
        with torch.no_grad():
            for _ in range(3):
                out[i].append(model.predict(batches[i]))
        torch.cuda.synchronize()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(batches))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for got, want in zip(out, alone):
        assert len(got) == 3
        assert all(torch.equal(a, b) for g in got for a, b in zip(g, want))


def test_training_loss_with_grad_stays_eager(model, cuda, mutations):
    """``loss`` (dropout 0.1 in the mutation stack, grad on) runs its three
    passes eagerly and captures nothing; its gradients equal those of the
    same passes called directly under the same dropout draws (torch's
    deterministic kernels on: the gathers' backward adds with atomics)."""
    from packppi_torch.utils import trace

    batch = _batch(mutations, "1BRS", 4, cuda)
    params = list(model.net.parameters())
    was, warn = torch.are_deterministic_algorithms_enabled(), \
        torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        e0 = trace.engagement()
        torch.cuda.manual_seed(5)
        model.loss(batch).backward()
        e1 = trace.engagement()
        got = [None if p.grad is None else p.grad.clone() for p in params]
        model.zero_grad(set_to_none=True)
        torch.cuda.manual_seed(5)
        h = [model.pret(b) for b in (batch.wild(), batch.mutant())]
        model.net.train()
        ddg, ddg_inv = model._mutation_pass(batch, *h)
        model.net.eval()
        y = batch.ddg
        (0.5 * (torch.mean((ddg - y) ** 2) + torch.mean((ddg_inv + y) ** 2))).backward()
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)
    want_e = {k: 0 for k in e0}
    want_e["affinity_eager_passes"] = 3
    assert {k: e1[k] - e0[k] for k in e0} == want_e
    # the parameters the training route leaves unused have no gradient on either side
    assert [g is None for g in got] == [p.grad is None for p in params]
    pairs = [(g, p.grad) for g, p in zip(got, params) if g is not None]
    assert len(pairs) > len(params) // 2
    assert all(torch.isfinite(g).all() for g, _ in pairs) and any(g.abs().max() > 0
                                                                  for g, _ in pairs)
    gap = max((g - w).abs().max().item() for g, w in pairs)
    print(f"loss gradients against the direct passes: largest gap {gap:.3e}, bit for bit: "
          f"{all(torch.equal(g, w) for g, w in pairs)}")
    assert all(torch.allclose(g, w, rtol=1e-5, atol=1e-8) for g, w in pairs)
    assert not model._backbone_graphs.entries and not model._mutation_graphs.entries
