"""The proximal refinement on the card (marker ``gpu``; skipped without a
CUDA device): the Adam loop replayed from one CUDA graph a shape against the
same loop run eagerly on the card. This file imports neither JAX nor
``conftest``, so on a machine without JAX it runs as

    python -m pytest --noconftest -m gpu tests/test_torch_proximal_gpu.py
"""
import os

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
STEPS = 50


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def deterministic(cuda):
    """torch's deterministic kernels, and no graph captured without them.
    The backward of the frames' ``gather`` adds with atomics in any order,
    and Adam divides each gradient by its own running size, so over 50
    steps two eager runs part by up to ~7e-4 rad (T1124 at B = 8 on an
    H100). With the adds in a fixed order the graph's replays and the eager
    loop run the same kernels on the same numbers."""
    from packppi_torch.sampling import proximal

    was, warn = torch.are_deterministic_algorithms_enabled(), \
        torch.is_deterministic_algorithms_warn_only_enabled()
    proximal._GRAPHS.entries.clear()
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield cuda
    torch.use_deterministic_algorithms(was, warn_only=warn)
    proximal._GRAPHS.entries.clear()


def _complex(name, rows, device, seed):
    """``rows`` copies of a fixture, padded to its bucket, and chis moved
    off the native ones (normal, 0.5 rad) so that side chains clash, one
    draw a row."""
    from packppi_torch.data import stack_batch
    from packppi_torch.structure import featurize, from_pdb_file

    feats = featurize(from_pdb_file(os.path.join(FIXTURES, f"{name}.pdb"), mse_to_met=True))
    batch = stack_batch([feats] * rows, device)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    noise = torch.randn(batch.SC_D.shape, generator=gen).to(device) * 0.5
    return batch, batch.SC_D + noise * batch.SC_D_mask


def _eager(batch, sc):
    """The same Adam steps run eagerly on the card, one call each."""
    from packppi_torch.sampling.proximal import _eager, find_clash_mask

    cm = find_clash_mask(batch, sc)
    x, row_losses = _eager(batch, sc, sc * cm, cm, STEPS, 1e-2, 1.0, (12.0, 0.5), None)
    return x, row_losses


def _wrapdiff(a, b):
    d = (a - b).abs()
    return torch.minimum(d, 2 * np.pi - d)


def _assert_matches_eager(res, batch, sc):
    x, row_losses = _eager(batch, sc)
    assert res.row_losses.shape == row_losses.shape == (STEPS, batch.X.shape[0])
    assert _wrapdiff(res.SC_D, x).max().item() < 1e-5
    first, last = res.row_losses[0], res.row_losses[-1]
    assert torch.equal(last < first, row_losses[-1] < row_losses[0])
    rel = (res.row_losses - row_losses).abs() / row_losses.abs().clamp_min(1e-12)
    assert rel.max().item() < 1e-5
    # the loop did work: the objective fell where the clash mask held chis
    assert (last < first).any()


def test_graphed_refinement_matches_the_eager_loop_and_reuses_its_graph(deterministic):
    """1BRS at B = 1 (bucket 256), a second draw at the same shape (the
    graph reused, Adam's state reset), then two rows of 2FTL (bucket 384,
    a second capture): each within 1e-5 rad and 1e-5 of the losses of the
    eager loop, with its accept decisions, and 51 / 50 clash launches a
    one-row refinement, as the eager loop's."""
    from packppi_torch.ops.clash import between_residue_clash as brc
    from packppi_torch.sampling import proximal, proximal_optimize
    from packppi_torch.utils import trace

    cuda = deterministic
    calls = [_complex("1brs", 1, cuda, 0), _complex("1brs", 1, cuda, 1),
             _complex("2ftl", 2, cuda, 2)]
    assert calls[0][0].X.shape[1] == 256 and calls[2][0].X.shape[1] == 384
    for i, (batch, sc) in enumerate(calls):
        e0, f0, b0 = trace.engagement(), brc.launches_fwd, brc.launches_bwd
        with torch.no_grad():
            res = proximal_optimize(batch, sc)
        e1 = trace.engagement()
        assert e1["graph_captures"] - e0["graph_captures"] == (0 if i == 1 else 1)
        assert e1["graph_replays"] - e0["graph_replays"] == STEPS
        assert e1["eager_steps"] == e0["eager_steps"]
        if batch.X.shape[0] == 1:
            assert (brc.launches_fwd - f0, brc.launches_bwd - b0) == (STEPS + 1, STEPS)
        assert not res.SC_D.requires_grad
        _assert_matches_eager(res, batch, sc)
    assert len(proximal._GRAPHS.entries) == 2


def test_graphed_results_outlive_the_next_replay(cuda):
    """What a call returns is its own: a later call at the same shape, which
    loads the graph's buffers anew, leaves the first call's chis and losses
    as they were."""
    from packppi_torch.sampling import proximal_optimize

    (batch, sc), (_, sc2) = _complex("1brs", 1, cuda, 3), _complex("1brs", 1, cuda, 4)
    first = proximal_optimize(batch, sc)
    kept = (first.SC_D.clone(), first.row_losses.clone())
    proximal_optimize(batch, sc2)
    torch.cuda.synchronize()
    assert torch.equal(first.SC_D, kept[0]) and torch.equal(first.row_losses, kept[1])


def test_a_request_on_another_stream_loads_after_the_last_results(deterministic):
    """Two refinements of one shape issued back to back on two streams: the
    second waits for the first's results to be cloned out before it loads
    the graph's copies, though its own stream has no work before it. Each
    gets the chis and losses it gets alone."""
    from packppi_torch.sampling import proximal_optimize

    cuda = deterministic
    (batch, sc), (_, sc2) = _complex("1brs", 1, cuda, 5), _complex("1brs", 1, cuda, 6)
    alone = [proximal_optimize(batch, s) for s in (sc, sc2)]      # the capture, then a replay
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    got = []
    for stream, s in zip(streams, (sc, sc2)):
        stream.wait_stream(torch.cuda.current_stream(cuda))
        with torch.cuda.stream(stream):
            got.append(proximal_optimize(batch, s))
    torch.cuda.synchronize()
    for res, want in zip(got, alone):
        assert _wrapdiff(res.SC_D, want.SC_D).max().item() < 1e-5
        rel = (res.row_losses - want.row_losses).abs() / want.row_losses.abs().clamp_min(1e-12)
        assert rel.max().item() < 1e-5
