"""The ODE sampler on the card (marker ``gpu``; skipped without a CUDA
device): the step replayed from one CUDA graph a shape against the same
steps run eagerly on the card, in bf16 with the packing CLI's routing. This
file imports neither JAX nor ``conftest``, so on a machine without JAX it
runs as

    python -m pytest --noconftest -m gpu tests/test_torch_sampler_gpu.py
"""
import os
import sys
import threading

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
STEPS = 30
# the graph's replays run the eager step's operations on the same numbers:
# equal bits are expected, and this is the most that fails the test
TOLERANCE = 1e-3


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def model(cuda):
    """PackPPI-MSC at its published widths in bf16, routed as ``cli.pack``
    routes it, random weights from seed 0."""
    from packppi_torch.models import NetworkConfig, TorsionalDiffusion
    from packppi_torch.weights import init_weights

    m = TorsionalDiffusion(NetworkConfig(compute_dtype="bfloat16",
                                         fused_messages="geom_lanes", fused_chain=True))
    init_weights(m.net, 0)
    return m.to(cuda)


def _batch(name, rows, device):
    from packppi_torch.data import stack_batch
    from packppi_torch.structure import featurize, from_pdb_file

    feats = featurize(from_pdb_file(os.path.join(FIXTURES, f"{name}.pdb"), mse_to_met=True))
    return stack_batch([feats] * rows, device)


def _start(model, batch, seed):
    return model.init_noise(batch, torch.Generator(device=batch.X.device).manual_seed(seed))


def _eager(model, batch, init):
    """The same 30 steps run eagerly on the card, one call each."""
    with torch.no_grad():
        return model._eager(batch, model.net.encode_static(batch), init.clone(), STEPS,
                            return_trajectory=True)


def _wrapdiff(a, b):
    d = (a - b).abs()
    return torch.minimum(d, 2 * np.pi - d)


def _gap(got, want):
    """The largest wrapped gap over the final chis and every trajectory row."""
    return max(_wrapdiff(g, w).max().item() for g, w in zip(got, want))


@pytest.mark.parametrize("rows", [1, 16])
def test_graphed_sample_matches_the_eager_loop(model, cuda, rows):
    """T1124 (bucket 768) at B = 1 and 2FTL (bucket 384) at B = 16, from
    one ``init_sc``: the graph's 30 trajectory rows and final chis against
    the eager loop's (bit for bit expected, 1e-3 rad at most), with the
    same launches of each kernel, one capture and 30 replays counted as
    such and no eager step."""
    from packppi_torch.utils import trace

    batch = _batch("t1124" if rows == 1 else "2ftl", rows, cuda)
    init = _start(model, batch, rows)
    c0, e0 = trace.counters(), trace.engagement()
    want = _eager(model, batch, init)
    c1, e1 = trace.counters(), trace.engagement()
    got = model.sample(batch, init_sc=init, n_steps=STEPS, return_trajectory=True)
    c2, e2 = trace.counters(), trace.engagement()
    torch.cuda.synchronize()
    gap = _gap(got, want)
    print(f"B = {rows}, L = {batch.X.shape[1]}: largest gap {gap:.3e} rad, "
          f"bit for bit: {all(torch.equal(g, w) for g, w in zip(got, want))}")
    assert gap <= TOLERANCE
    assert got[1].shape == want[1].shape == (STEPS,) + init.shape
    eager = {k: c1[k] - c0[k] for k in c0}
    assert {k: c2[k] - c1[k] for k in c1} == eager and eager["message"] == 5 * STEPS
    assert e1["sample_eager_steps"] - e0["sample_eager_steps"] == STEPS
    assert {k: e2[k] - e1[k] for k in e1} == {
        "graph_captures": 0, "graph_replays": 0, "eager_steps": 0,
        "sample_graph_captures": 1, "sample_graph_replays": STEPS, "sample_eager_steps": 0,
        "affinity_graph_captures": 0, "affinity_graph_replays": 0, "affinity_eager_passes": 0}


def test_alternating_shapes_reuse_their_graphs(model, cuda):
    """1BRS (bucket 256) and T1124 (bucket 768) in turn, twice each: each
    call gives the bits of its shape's first call, and the second round
    captures nothing."""
    from packppi_torch.utils import trace

    cases = [(b, _start(model, b, i)) for i, b in enumerate((_batch("1brs", 1, cuda),
                                                             _batch("t1124", 1, cuda)))]
    first = [model.sample(b, init_sc=s, n_steps=STEPS) for b, s in cases]
    captures = trace.engagement()["sample_graph_captures"]
    for _ in range(2):
        for (b, s), want in zip(cases, first):
            assert torch.equal(model.sample(b, init_sc=s, n_steps=STEPS), want)
    assert trace.engagement()["sample_graph_captures"] == captures
    assert len(model._graphs.entries) == 2


def test_weights_written_in_place_are_seen_by_the_replay(model, cuda):
    """A message weight scaled in place between two calls of one shape (the
    kernel reads a packed copy of it, made outside the graph): the second
    call captures again and gives the eager loop's chis under the new
    weights, not the first call's."""
    batch = _batch("1brs", 1, cuda)
    init = _start(model, batch, 7)
    before = model.sample(batch, init_sc=init, n_steps=STEPS)
    w = model.net.mpnn.mpnn_layers[0].node_message_fn.W_in.weight
    with torch.no_grad():
        w.mul_(1.5)
    after = model.sample(batch, init_sc=init, n_steps=STEPS)
    assert not torch.equal(after, before)
    assert _wrapdiff(after, _eager(model, batch, init)[0]).max().item() <= TOLERANCE


def test_returned_chis_outlive_the_next_call(model, cuda):
    """What a call returns is its own: a later call at the same shape, which
    loads the graph's buffers anew, leaves the first call's chis and
    trajectory as they were."""
    batch = _batch("1brs", 1, cuda)
    sc, traj = model.sample(batch, init_sc=_start(model, batch, 3), n_steps=STEPS,
                            return_trajectory=True)
    kept = (sc.clone(), traj.clone())
    model.sample(batch, init_sc=_start(model, batch, 4), n_steps=STEPS, return_trajectory=True)
    torch.cuda.synchronize()
    assert torch.equal(sc, kept[0]) and torch.equal(traj, kept[1])


def test_threads_of_one_shape_get_their_own_results(model, cuda):
    """Twelve threads (more than the host's cores) sample one shape at once,
    each from its own start, three times, with the interpreter switching
    threads every 10 us (as ``cli.serve`` runs requests, more often): each
    gets the chis its start gives alone."""
    batch = _batch("1brs", 1, cuda)
    starts = [_start(model, batch, s) for s in range(20, 32)]
    alone = [model.sample(batch, init_sc=s, n_steps=STEPS) for s in starts]
    out = [[] for _ in starts]

    def run(i):
        for _ in range(3):
            out[i].append(model.sample(batch, init_sc=starts[i], n_steps=STEPS))
        torch.cuda.synchronize()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(starts))]
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
        assert len(got) == 3 and all(torch.equal(g, want) for g in got)
