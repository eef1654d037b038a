"""The port's 30-step ODE sampler replays the reference's fixed-noise
trajectory on 1BRS (``pipeline_golden.npz``): same weights, same t=1
noise, every recorded network input and the final chis within 5e-4 rad
(the bound ``tests/test_pipeline_golden.py`` holds the JAX package to)."""
import os

import numpy as np
import pytest
import torch

from packppi_torch.data import stack_batch
from packppi_torch.models import NetworkConfig, TorsionalDiffusion
from packppi_torch.structure import featurize, from_pdb_file
from packppi_torch.weights import load_weights

from conftest import FIXTURES, GOLDEN
from torch_threads import _threads  # noqa: F401 (autouse fixture)

PIPELINE_GOLDEN = os.path.join(GOLDEN, "pipeline_golden.npz")


def _wrapdiff(a, b):
    d = np.abs(a - b)
    return np.minimum(d, 2 * np.pi - d)


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(PIPELINE_GOLDEN))


@pytest.fixture(scope="module")
def batch():
    feats = featurize(from_pdb_file(os.path.join(FIXTURES, "1brs.pdb"), mse_to_met=True))
    return stack_batch([feats], "cpu", target_len=len(feats["residue_type"]))


@pytest.fixture(scope="module")
def model():
    m = TorsionalDiffusion(NetworkConfig())
    load_weights(m.net, PIPELINE_GOLDEN)
    return m


def test_sampler_replays_reference_trajectory(golden, batch, model):
    sc, traj = model.sample(batch, init_sc=golden["init_sc"], return_trajectory=True)
    assert traj.shape == golden["traj"].shape
    mask = batch.SC_D_mask[0].numpy() > 0
    for s in range(traj.shape[0]):
        d = _wrapdiff(traj[s, 0].numpy(), golden["traj"][s, 0])[mask]
        assert d.max() < 5e-4, f"step {s}: {d.max()}"
    assert _wrapdiff(sc[0].numpy(), golden["final_sc"][0])[mask].max() < 5e-4


def test_sampler_noise_is_seeded_masked_and_wrapped(batch, model):
    g = lambda s: torch.Generator().manual_seed(s)
    a = model.init_noise(batch, g(0))
    np.testing.assert_array_equal(a.numpy(), model.init_noise(batch, g(0)).numpy())
    assert not np.array_equal(a.numpy(), model.init_noise(batch, g(1)).numpy())
    assert a.min() >= -np.pi and a.max() < np.pi
    absent = (batch.SC_D_mask == 0).numpy()
    np.testing.assert_array_equal(a.numpy()[absent], 0.0)
    sc = model.sample(batch, g(0), n_steps=2)
    assert sc.shape == batch.SC_D.shape and torch.isfinite(sc).all()
    np.testing.assert_array_equal(sc.numpy()[absent], 0.0)


def test_corrector_steps_are_refused(batch, model):
    """Langevin corrector sub-steps draw noise: they are refused without a
    generator (a replayed ``init_sc`` alone is not enough), and with one
    they run, move the present chis and leave the absent ones at 0."""
    init = model.init_noise(batch, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="generator"):
        model.sample(batch, None, n_steps=1, corrector_steps=1, init_sc=init)
    plain = model.sample(batch, None, n_steps=1, init_sc=init)
    sc = model.sample(batch, torch.Generator().manual_seed(1), n_steps=1, corrector_steps=1,
                      init_sc=init)
    assert torch.isfinite(sc).all() and not torch.equal(sc, plain)
    np.testing.assert_array_equal(sc.numpy()[batch.SC_D_mask.numpy() == 0], 0.0)


@pytest.mark.parametrize("pi_periodic", [True, False])
@pytest.mark.parametrize("n_steps", [1, 7, 30])
def test_ode_step_from_the_table_matches_the_float_step(batch, model, pi_periodic, n_steps):
    """Each step's scalars as ``ode_table`` holds them (computed in float64,
    rounded to float32 once) give the bits of the step computed from the
    step's time and length as Python floats, in either schedule."""
    from packppi_torch.models.torsional_diffusion import _step_times

    sched = model.schedule_pi if pi_periodic else model.schedule_2pi
    col = 1 if pi_periodic else 3
    table = model.ode_table(n_steps, "cpu")
    assert table.dtype == torch.float32 and table.shape == (n_steps, 5)
    mask = batch.chi_1pi_periodic_mask if pi_periodic else batch.chi_2pi_periodic_mask
    g = torch.Generator().manual_seed(n_steps)
    for i, (time, dt) in enumerate(zip(*_step_times(n_steps))):
        x = torch.rand(batch.SC_D.shape, generator=g) * 2 * np.pi - np.pi
        score = torch.randn(batch.SC_D.shape, generator=g) * 10
        want = sched.step(x, score, float(time), float(dt), mask)
        got = sched.step(x, score, None, None, mask, ode=(table[i, col], table[i, col + 1]))
        assert torch.equal(got, want), f"step {i}"
        assert table[i, 0].item() == float(time)


def test_steps_as_a_graph_runs_them_give_the_eager_samples_bits(batch, model):
    """The step a CUDA graph captures (the time broadcast from the table's
    slot, the ODE scalars as float32 tensors), run eagerly here from the
    same start, gives every trajectory row and the final chis of the eager
    loop bit for bit."""
    n = 2
    init = model.init_noise(batch, torch.Generator().manual_seed(5))
    sc_eager, traj_eager = model.sample(batch, init_sc=init, n_steps=n, return_trajectory=True)
    static = model.net.encode_static(batch)
    table = model.ode_table(n, "cpu")
    sc = init
    with torch.no_grad():
        for i in range(n):
            assert torch.equal(traj_eager[i], sc), f"step {i}"
            s = table[i]
            sc = model._step(batch, static, sc, s[0].expand(sc.shape[:2]), None, None,
                             ode=((s[1], s[2]), (s[3], s[4])))
    assert torch.equal(sc, sc_eager)
