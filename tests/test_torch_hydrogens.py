"""The port's hydrogen placement and H-bond network optimization against the
JAX package's on 1BRS and 2FTL: heavy-atom graph, placed hydrogens, and the
joint flip and rotor decisions."""
import dataclasses
import os

import numpy as np
import pytest

from packppi_torch.structure import from_pdb_file
from packppi_torch.structure import hbond_networks as hn
from packppi_torch.structure import hydrogens as hy

from conftest import FIXTURES
from torch_threads import _threads  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module", params=["1brs", "2ftl"])
def pair(request):
    """The port's parse, and the same arrays as the JAX package's ``Protein``."""
    from packppi_tpu.structure import Protein as JaxProtein

    prot = from_pdb_file(os.path.join(FIXTURES, f"{request.param}.pdb"), mse_to_met=True)
    return prot, JaxProtein(**{f.name: getattr(prot, f.name) for f in dataclasses.fields(prot)})


def test_heavy_graph_equals_jax(pair):
    from packppi_tpu.structure import hydrogens as jh

    ours, theirs = pair
    g, w = hy.heavy_graph(ours), jh.heavy_graph(theirs)
    np.testing.assert_array_equal(g[0], w[0])
    assert list(g[1]) == list(w[1])
    np.testing.assert_array_equal(np.asarray(g[2]), np.asarray(w[2]))
    np.testing.assert_array_equal(g[3], w[3])
    assert g[4] == w[4]
    assert hy.SERIOUS_OVERLAP == jh.SERIOUS_OVERLAP
    assert hy.HBOND_OVERLAP_CAP == jh.HBOND_OVERLAP_CAP


def test_bond_sep_lookup_equals_jax(pair):
    from packppi_tpu.structure import hydrogens as jh

    ours, _ = pair
    _, _, _, _, sep = hy.heavy_graph(ours)
    n = len(hy.heavy_graph(ours)[1])
    keys, vals = hy.encode_bond_sep(sep, n)
    jkeys, jvals = jh.encode_bond_sep(sep, n)
    np.testing.assert_array_equal(keys, jkeys)
    np.testing.assert_array_equal(vals, jvals)
    rng = np.random.default_rng(0)
    lo = rng.integers(0, n, 500)
    hi = np.minimum(lo + rng.integers(0, 6, 500), n - 1)
    np.testing.assert_array_equal(hy.lookup_bond_sep(keys, vals, lo, hi, n),
                                  jh.lookup_bond_sep(jkeys, jvals, lo, hi, n))


@pytest.mark.parametrize("optimize", [False, True], ids=["ideal", "rotors"])
def test_add_hydrogens_equals_jax(pair, optimize):
    from packppi_tpu.structure import hydrogens as jh

    ours, theirs = pair
    got = hy.add_hydrogens(ours, optimize_rotors=optimize)
    want = jh.add_hydrogens(theirs, optimize_rotors=optimize)
    assert set(got) == set(want)
    for k in ("parent_res", "parent_slot", "polar", "rotor_h"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["positions"], want["positions"], rtol=0, atol=1e-9)
    assert len(got["positions"]) > len(ours.aaindex)


def test_static_hydrogen_probes_equal_jax(pair):
    from packppi_tpu.structure import hydrogens as jh

    ours, theirs = pair
    got, want = hy.static_hydrogen_probes(ours), jh.static_hydrogen_probes(theirs)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-9, err_msg=k)


def test_optimize_hbond_networks_equals_jax(pair):
    from packppi_tpu.structure import hbond_networks as jn

    ours, theirs = pair
    prot, n_flipped, phases, info = hn.optimize_hbond_networks(ours)
    jprot, jn_flipped, jphases, jinfo = jn.optimize_hbond_networks(theirs)
    assert n_flipped == jn_flipped
    assert phases == jphases
    assert info == jinfo
    np.testing.assert_allclose(np.nan_to_num(prot.atom_positions),
                               np.nan_to_num(jprot.atom_positions), rtol=0, atol=1e-9)
