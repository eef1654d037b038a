"""Port geometry: torsions -> atom14 against the reference golden and the
JAX package, backbone dihedrals against their golden, rigid algebra."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from packppi_tpu.geometry import atom14_coords_from_torsions as jax_atom14
from packppi_tpu.geometry import dihedral_from_four_points as jax_dihedral4
from packppi_tpu.geometry import rigid_from_3_points as jax_rigid3
from packppi_torch.geometry import (atom14_coords_from_torsions, compose,
                                    dihedral_from_four_points, dihedrals_along_chain,
                                    invert, invert_apply, rigid_apply,
                                    rigid_from_3_points, wrap_angle)
from packppi_torch.structure import featurize, from_pdb_file
from packppi_torch.structure.featurize import bb_dihedrals

from conftest import FIXTURES, GOLDEN
from torch_threads import _threads  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def t1124():
    return featurize(from_pdb_file(os.path.join(FIXTURES, "t1124.pdb"), mse_to_met=True))


def _t(a):
    """numpy -> torch, floats as float32 (as ``stack_batch`` stores them)."""
    a = np.asarray(a)
    return torch.as_tensor(a.astype(np.float32) if a.dtype.kind == "f" else a)


def test_atom14_matches_reference_golden(t1124):
    golden = np.load(os.path.join(GOLDEN, "geometry_golden.npz"))
    coords = atom14_coords_from_torsions(_t(t1124["X"]), _t(t1124["residue_type"]),
                                         _t(t1124["BB_D"]), _t(t1124["SC_D"]))
    np.testing.assert_allclose(coords.numpy(), golden["atom14_coords"], atol=2e-4)


def test_atom14_matches_jax_package(t1124):
    rng = np.random.default_rng(0)
    sc = (t1124["SC_D"] + rng.normal(size=t1124["SC_D"].shape)).astype(np.float32)
    ours = atom14_coords_from_torsions(_t(t1124["X"]), _t(t1124["residue_type"]),
                                       _t(t1124["BB_D"]), _t(sc)).numpy()
    ref = np.asarray(jax_atom14(jnp.asarray(t1124["X"]), jnp.asarray(t1124["residue_type"]),
                                jnp.asarray(t1124["BB_D"]), jnp.asarray(sc)))
    np.testing.assert_allclose(ours, ref, atol=1e-4)


def test_bb_dihedrals_match_golden(t1124):
    """Pre-omega column order and mask, as the JAX package's own golden test
    reads them (on modelled residues)."""
    golden = np.load(os.path.join(GOLDEN, "bb_dihedrals_golden.npz"))
    rm = t1124["residue_mask"][:, None]
    np.testing.assert_allclose(np.nan_to_num(t1124["BB_D"]) * rm, golden["bb_d"] * rm,
                               atol=1e-4)
    np.testing.assert_array_equal(t1124["BB_D_mask"] * rm, golden["bb_mask"] * rm)


def test_torch_dihedrals_along_chain_match_featurization(t1124):
    L = len(t1124["residue_type"])
    chain = _t(t1124["X"][:, :3].reshape(3 * L, 3))
    d = dihedrals_along_chain(chain).numpy()             # psi_0, omega_0, phi_1, ...
    ref, _ = bb_dihedrals(t1124["X"])                    # (pre-omega, phi, psi)
    ok = t1124["residue_mask"][1:] > 0
    np.testing.assert_allclose(np.nan_to_num(d[2::3][ok]), np.nan_to_num(ref[1:, 1][ok]),
                               atol=1e-4)


def test_rigid_algebra_and_jax_frames():
    rng = np.random.default_rng(0)
    p = rng.normal(size=(6, 3, 3)).astype(np.float32)
    r = rigid_from_3_points(_t(p[:, 0]), _t(p[:, 1]), _t(p[:, 2]))
    ref = jax_rigid3(jnp.asarray(p[:, 0]), jnp.asarray(p[:, 1]), jnp.asarray(p[:, 2]))
    np.testing.assert_allclose(r.rot.numpy(), np.asarray(ref.rot), atol=1e-6)
    np.testing.assert_allclose(r.trans.numpy(), np.asarray(ref.trans), atol=1e-6)
    pts = _t(rng.normal(size=(6, 3)).astype(np.float32))
    np.testing.assert_allclose(invert_apply(r, rigid_apply(r, pts)).numpy(), pts.numpy(),
                               atol=1e-5)
    ident = compose(r, invert(r))
    np.testing.assert_allclose(ident.rot.numpy(), np.broadcast_to(np.eye(3), (6, 3, 3)),
                               atol=1e-5)
    np.testing.assert_allclose(ident.trans.numpy(), 0.0, atol=1e-5)


def test_pairwise_dihedral_and_wrap_match_jax():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(4, 50, 3)).astype(np.float32)
    q[3, :5] = q[2, :5] + (q[2, :5] - q[1, :5])        # degenerate: collinear
    ours = dihedral_from_four_points(*(_t(x) for x in q)).numpy()
    ref = np.asarray(jax_dihedral4(*(jnp.asarray(x) for x in q)))
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    x = np.array([0.0, np.pi, -np.pi, 3 * np.pi, -2.5 * np.pi], np.float32)
    w = wrap_angle(_t(x)).numpy()
    assert np.all(w >= -np.pi) and np.all(w < np.pi)
    np.testing.assert_allclose(np.cos(w), np.cos(x), atol=1e-6)
