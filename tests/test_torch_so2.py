"""The port's SO(2) tables, lookups and reverse steps against the JAX
package's, on the CPU.

Tables by value. The two float32 image sums run the same operations, but
XLA may contract a multiply-add and sums in another order, so:
``score`` and ``p`` agree to relative 1e-5; where a table entry is the
small remainder of image terms that cancel (|score| < 6e-3 at large sigma,
against a table maximum above 4e3) an absolute 1e-7 is allowed instead;
``score_norm`` to relative 1e-5 plus absolute 1e-12 (its entries at the
largest sigmas are cancellation noise below 3e-9; the loss adds 1e-6 to
them). Entries zeroed for float64 underflow are zero in both; a density at
the edge of the subnormal range (1.2e-38) may be flushed by one and kept by
the other, hence ``p``'s absolute 1e-37.

Lookups: an index is ``round`` of a float32 logarithm, so where the
argument sits on ``.5`` the two frameworks may pick neighbouring bins. The
tests count such flips (at most 1% of the draws, the neighbouring bin
only) and hold the rest exactly.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from packppi_tpu.diffusion import so2 as jax_so2
from packppi_tpu.diffusion.so2 import SO2Schedule as JaxSchedule
from packppi_tpu.diffusion.so2 import SO2Tables as JaxTables
from packppi_torch.diffusion import so2
from packppi_torch.diffusion.so2 import SO2Schedule, SO2Tables

from conftest import GOLDEN
from torch_threads import _threads  # noqa: F401 (autouse fixture)

PERIODS = [("pi", True), ("2pi", False)]


def _settle_jax_table_cache():
    """Put the JAX package's two SO(2) table files in place before any test
    runs. That package writes a missing file where it reads it, so under
    xdist a JAX test in one worker could read a file another worker was
    still writing (``BadZipFile``, ``EOFError``). Every worker imports this
    module while collecting, before the first test: one at a time, under a
    lock, a worker builds each missing file as the JAX package would write
    it and renames it into place; the others then find it complete."""
    import fcntl

    cache = jax_so2._cache_dir()
    with open(cache / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for PI in (np.pi / 2, np.pi):
            path = cache / f"so2_{PI:.6f}.npz"
            if path.exists():
                continue
            p, s, sn = jax_so2._build_tables(PI)
            part = path.with_name(f"{path.name}.{os.getpid()}.part")
            with open(part, "wb") as f:
                np.savez_compressed(f, p=p, score=s, score_norm=sn)
            os.replace(part, path)


_settle_jax_table_cache()


@pytest.fixture(scope="module", autouse=True)
def _table_cache(tmp_path_factory):
    """The port's tables are cached under pytest's temporary directory, one
    directory for all workers of a run (a file appears there by a rename, so
    workers can share it), and never under the home directory."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    os.environ.setdefault("PACKPPI_TORCH_CACHE", str(base / "packppi_torch_cache"))


def jax_tables(PI):
    """The JAX package's tables, read from the files put in place above."""
    return JaxTables.build(PI)


def jax_schedule(pi_periodic, **kw):
    return JaxSchedule(jax_tables(np.pi / 2 if pi_periodic else np.pi), **kw)


@pytest.fixture(scope="module")
def tables():
    return {name: (SO2Schedule(pi_periodic=pp).tables("cpu"),
                   jax_tables(np.pi / 2 if pp else np.pi))
            for name, pp in PERIODS}


@pytest.mark.parametrize("name", ["pi", "2pi"])
def test_tables_match_jax_tables_by_value(tables, name):
    ours, ref = tables[name]
    assert ours.PI == pytest.approx(ref.PI)
    x = 10 ** np.linspace(np.log10(so2.X_MIN), 0, so2.X_N + 1) * ours.PI
    sigma = 10 ** np.linspace(np.log10(so2.SIGMA_MIN), np.log10(so2.SIGMA_MAX),
                              so2.SIGMA_N + 1) * ours.PI
    underflow = 0.5 * (x[None, :] / sigma[:, None]) ** 2 > 745.0
    assert underflow.any()
    for key, atol in (("score", 1e-7), ("p", 1e-37), ("score_norm", 1e-12)):
        a, r = getattr(ours, key).numpy(), np.asarray(getattr(ref, key), np.float32)
        assert a.shape == r.shape and a.dtype == np.float32
        if a.ndim == 2:
            assert not a[underflow].any() and not r[underflow].any(), key
        np.testing.assert_allclose(a, r, rtol=1e-5, atol=atol, err_msg=key)


def test_table_cache_is_written_atomically_and_reloaded(tmp_path, monkeypatch):
    """A small stand-in build: the file appears under its final name only,
    no temporary file is left, and the second call reads it back."""
    monkeypatch.setenv("PACKPPI_TORCH_CACHE", str(tmp_path))
    calls = []

    def fake_build(PI):
        calls.append(PI)
        return (np.full((3, 3), 1.0, np.float32), np.full((3, 3), 2.0, np.float32),
                np.full(3, 3.0, np.float32))

    monkeypatch.setattr(so2, "_build_tables", fake_build)
    a = SO2Tables.build(1.25)
    b = SO2Tables.build(1.25)
    assert calls == [1.25]
    assert sorted(p.name for p in (tmp_path / "so2").iterdir()) == ["so2_1.250000.npz"]
    assert torch.equal(a.score, b.score) and float(b.score_norm[0]) == 3.0


def _flips(got, want, neighbours):
    """Entries that differ, each of which must equal one of ``neighbours``
    (the lookups at the adjacent bins)."""
    differ = got != want
    for i in np.nonzero(differ)[0]:
        assert any(got[i] == n[i] for n in neighbours), (i, got[i], want[i])
    return int(differ.sum())


@pytest.mark.parametrize("name,pp", PERIODS)
def test_lookups_match_jax_lookups(tables, name, pp):
    ours, ref = tables[name]
    rng = np.random.default_rng(0)
    n = 4096
    x = rng.uniform(-2 * np.pi, 2 * np.pi, n).astype(np.float32)
    sigma = np.exp(rng.uniform(np.log(0.01 * np.pi), np.log(np.pi), n)).astype(np.float32)
    tx, ts = torch.from_numpy(x), torch.from_numpy(sigma)

    xi, xr = ours._x_index(tx).numpy(), np.asarray(ref._x_index(jnp.asarray(x)))
    si, sr = ours._sigma_index(ts).numpy(), np.asarray(ref._sigma_index(jnp.asarray(sigma)))
    assert np.abs(xi - xr).max() <= 1 and np.abs(si - sr).max() <= 1
    flipped = int((xi != xr).sum() + (si != sr).sum())
    assert flipped <= 0.01 * n, flipped

    same = (xi == xr) & (si == sr)
    for fn in ("lookup_score", "lookup_p"):
        got = getattr(ours, fn)(tx, ts).numpy()
        want = np.asarray(getattr(ref, fn)(jnp.asarray(x), jnp.asarray(sigma)))
        # the wrap of x into [-PI, PI) may itself move x by an ulp and the bin with it
        close = np.isclose(got, want, rtol=1e-5, atol=1e-7)
        assert (~close & same).sum() <= 0.01 * n, fn
    got = ours.lookup_score_norm(ts).numpy()
    want = np.asarray(ref.lookup_score_norm(jnp.asarray(sigma)))
    assert (~np.isclose(got, want, rtol=1e-5, atol=1e-12) & (si == sr)).sum() == 0


@pytest.mark.parametrize("name,pp", PERIODS)
def test_lookups_match_reference_golden(tables, name, pp):
    """The reference's own table construction and log-binned lookups on
    identical (x, sigma): the limits the JAX package holds itself to."""
    ours, _ = tables[name]
    z = np.load(os.path.join(GOLDEN, "so2_lookup_golden.npz"))
    x = torch.from_numpy(z["x"].astype(np.float32))
    sigma = torch.from_numpy(z[f"sigma_{name}"].astype(np.float32))
    got = ours.lookup_score(x, sigma).numpy().astype(np.float64)
    want = z[f"score_{name}"]
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    assert np.quantile(rel, 0.95) < 0.01 and np.median(rel) < 1e-3
    # the reference's score_norm is an unseeded 10k-sample Monte Carlo
    # estimate; the tables' is quadrature: agreement within its noise
    got_n = ours.lookup_score_norm(sigma).numpy().astype(np.float64)
    reln = np.abs(got_n - z[f"score_norm_{name}"]) / np.maximum(np.abs(z[f"score_norm_{name}"]), 1e-9)
    assert np.median(reln) < 0.03 and np.quantile(reln, 0.95) < 0.08


@pytest.fixture(scope="module")
def draws():
    rng = np.random.default_rng(1)
    shape = (2, 24, 4)
    return dict(x=rng.uniform(-np.pi, np.pi, shape).astype(np.float32),
                t=np.repeat(rng.uniform(0.05, 0.95, (2, 1)), 24, 1).astype(np.float32),
                noise=rng.normal(size=shape).astype(np.float32),
                score=rng.normal(size=shape).astype(np.float32),
                mask=rng.uniform(size=shape) > 0.3)


class _FixedNormal:
    """``jax.random.normal`` replaced by the test's own draw, so both
    packages see the same noise."""

    def __init__(self, monkeypatch, noise):
        monkeypatch.setattr(jax.random, "normal",
                            lambda key, shape, dtype=jnp.float32: jnp.asarray(noise, dtype))


@pytest.mark.parametrize("name,pp", PERIODS)
def test_add_noise_matches_jax(draws, monkeypatch, name, pp):
    d = draws
    _FixedNormal(monkeypatch, d["noise"])
    want_x, want_s = jax_schedule(pp).add_noise(
        jax.random.key(0), jnp.asarray(d["x"]), jnp.asarray(d["t"]), jnp.asarray(d["mask"]))
    got_x, got_s = SO2Schedule(pi_periodic=pp).add_noise(
        torch.from_numpy(d["x"]), torch.from_numpy(d["t"]), None, torch.from_numpy(d["mask"]),
        noise=torch.from_numpy(d["noise"]))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=2e-6, rtol=0)
    # the true score is a table lookup: equal but for rare neighbouring-bin flips
    close = np.isclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5, atol=1e-6)
    assert (~close).sum() <= 0.02 * close.size, (~close).sum()
    assert (got_s.numpy()[~d["mask"]] == 0).all()


@pytest.mark.parametrize("mode", ["ode", "sde"])
def test_step_matches_jax_in_both_modes(draws, monkeypatch, mode):
    d = draws
    _FixedNormal(monkeypatch, d["noise"])
    for pp in (True, False):
        want = jax_schedule(pp, mode=mode).step(
            jax.random.key(0), jnp.asarray(d["x"]), jnp.asarray(d["score"]), 0.4, 1.0 / 30,
            jnp.asarray(d["mask"]))
        got = SO2Schedule(pi_periodic=pp, mode=mode).step(
            torch.from_numpy(d["x"]), torch.from_numpy(d["score"]), 0.4, 1.0 / 30,
            torch.from_numpy(d["mask"]), noise=torch.from_numpy(d["noise"]))
        # float32 products in another order: a few ulps of |x| <= pi + |delta|
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-6, rtol=0)
    with pytest.raises(ValueError, match="generator"):
        SO2Schedule(mode="sde").step(torch.from_numpy(d["x"]), torch.from_numpy(d["score"]),
                                     0.4, 0.1)


def test_step_correct_matches_jax(draws, monkeypatch):
    d = draws
    _FixedNormal(monkeypatch, d["noise"])
    want = jax_schedule(False).step_correct(
        jax.random.key(0), jnp.asarray(d["x"]), jnp.asarray(d["score"]), jnp.asarray(d["mask"]))
    got = SO2Schedule().step_correct(torch.from_numpy(d["x"]), torch.from_numpy(d["score"]),
                                     torch.from_numpy(d["mask"]),
                                     noise=torch.from_numpy(d["noise"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-6, rtol=0)
    np.testing.assert_array_equal(got.numpy()[~d["mask"]], d["x"][~d["mask"]])


def test_draws_come_from_the_generator_and_repeat():
    s = SO2Schedule()
    x, t = torch.zeros(2, 8, 4), torch.full((2, 8), 0.5)
    a, _ = s.add_noise(x, t, torch.Generator().manual_seed(3), with_score=False)
    b, score = s.add_noise(x, t, torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and score.shape == x.shape
    u = s.sample_train_t((5,), torch.Generator().manual_seed(3), "cpu")
    assert u.shape == (5,) and bool(((u >= 0) & (u < 1)).all())
