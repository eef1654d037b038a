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

PIPELINE_GOLDEN = os.path.join(GOLDEN, "pipeline_golden.npz")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    """xdist workers share the machine's cores: two torch threads each."""
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(min(2, torch.get_num_threads()))


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
