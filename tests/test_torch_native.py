"""The port's native host library (``packppi_torch.native``: its own copy of
``pdbio.cpp``, built with g++ at first use with the JAX package's flags),
the delta-SASA interface, the atom14 <-> atom37 layout and
``sc_atom14_mask``, against the JAX package on the CPU: parsed arrays, SASA
and masks equal bit for bit, the layout conversions equal, the masks equal
to the reference's ``tests/golden/chem_golden.npz``."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from packppi_tpu import native as jax_native
from packppi_tpu.chem import tables as jax_tables
from packppi_tpu.structure import atom_layout as jax_layout
from packppi_tpu.structure import from_pdb_file as jax_from_pdb_file
from packppi_tpu.structure import interface as jax_interface
from packppi_torch import native
from packppi_torch.chem import sc_atom14_mask
from packppi_torch.structure import atom_layout, from_pdb_file, interface
from packppi_torch.structure.protein import from_pdb_string, from_pdb_string_python

from conftest import FIXTURES, GOLDEN
from torch_threads import _threads  # noqa: F401 (autouse fixture)

CASES = [("t1124.pdb", {"mse_to_met": True}), ("1brs.pdb", {"mse_to_met": True}),
         ("2ftl.pdb", {}), ("1brs.pdb", {"chain_id": "A"})]
IDS = ["t1124", "1brs", "2ftl", "1brs-A"]


@pytest.fixture(scope="module", autouse=True)
def _libraries():
    """Both packages' native libraries are built here (g++ is on the box)."""
    assert native.get_lib() is not None and jax_native.get_lib() is not None
    assert native.library_path().parent.name == "_build"


@pytest.mark.parametrize("name,kw", CASES, ids=IDS)
def test_native_parse_equals_jax_native_parse(name, kw):
    """Positions (parsed into float32), masks, b-factors, indices and chain
    ids equal, bit for bit; ``from_pdb_string`` returns them."""
    text = open(os.path.join(FIXTURES, name)).read()
    ours, theirs = native.parse_pdb_native(text, **kw), jax_native.parse_pdb_native(text, **kw)
    assert sorted(ours) == sorted(theirs)
    for field in ours:
        np.testing.assert_array_equal(ours[field], theirs[field], err_msg=field)
    prot = from_pdb_string(text, **kw)
    np.testing.assert_array_equal(prot.atom_positions, ours["atom_positions"])
    # float32 coordinates, where the pure-Python parser keeps the file's
    # three decimals in float64
    python = from_pdb_string_python(text, **kw)
    m = python.atom_mask.astype(bool)
    assert np.array_equal(prot.atom_positions[m].astype(np.float32),
                          python.atom_positions[m].astype(np.float32))
    assert not np.array_equal(prot.atom_positions[m], python.atom_positions[m])


def test_native_can_be_switched_off(monkeypatch):
    """With the library unavailable the parser and SASA fall back to the
    pure-Python paths (the JAX package's fallbacks)."""
    text = open(os.path.join(FIXTURES, "2ftl.pdb")).read()
    monkeypatch.setenv("PACKPPI_NATIVE", "0")
    monkeypatch.setattr(native, "_lib", None)
    assert native.parse_pdb_native(text) is None
    assert np.array_equal(from_pdb_string(text).atom_positions,
                          from_pdb_string_python(text).atom_positions, equal_nan=True)
    pos = np.random.default_rng(0).normal(size=(12, 3)).astype(np.float32) * 3
    radii = np.full(12, 1.7, np.float32)
    assert native.sasa_native(pos, radii) is None
    np.testing.assert_array_equal(interface._sasa_per_atom(pos, radii),
                                  _jax_numpy_sasa(pos, radii))


def _jax_numpy_sasa(pos, radii):
    """The JAX package's numpy SASA (its native library patched away)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "sasa_native", lambda *a, **k: None)
        return jax_interface._sasa_per_atom(pos, radii)


@pytest.mark.parametrize("name", ["1brs", "2ftl"])
def test_delta_sasa_interface_equals_jax(name):
    path = os.path.join(FIXTURES, f"{name}.pdb")
    ours, theirs = from_pdb_file(path, mse_to_met=True), jax_from_pdb_file(path, mse_to_met=True)
    np.testing.assert_array_equal(interface.residue_relative_sasa(ours),
                                  jax_interface.residue_relative_sasa(theirs))
    chain = np.asarray(ours.chain_id) == ours.chain_id[0]
    np.testing.assert_array_equal(interface.residue_relative_sasa(ours, chain),
                                  jax_interface.residue_relative_sasa(theirs, chain))
    mask = interface.interface_by_delta_sasa(ours)
    np.testing.assert_array_equal(mask, jax_interface.interface_by_delta_sasa(theirs))
    assert mask.dtype == np.float32 and 0 < mask.sum() < len(mask)
    one = from_pdb_file(path, chain_id=ours.chain_id[0])
    assert not interface.interface_by_delta_sasa(one).any()


def test_atom_layout_equals_jax():
    prot = from_pdb_file(os.path.join(FIXTURES, "1brs.pdb"), mse_to_met=True)
    rt = prot.aaindex[None]
    x14 = np.nan_to_num(prot.atom_positions)[None].astype(np.float32)
    x37 = atom_layout.atom14_to_atom37(torch.from_numpy(x14), torch.from_numpy(rt))
    j37 = jax_layout.atom14_to_atom37(jnp.asarray(x14), jnp.asarray(rt))
    np.testing.assert_array_equal(x37.numpy(), np.asarray(j37))
    back = atom_layout.atom37_to_atom14(x37, rt)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jax_layout.atom37_to_atom14(j37, rt)))
    masks, jmasks = atom_layout.atom14_masks(rt), jax_layout.atom14_masks(rt)
    assert sorted(masks) == sorted(jmasks)
    for k in masks:
        np.testing.assert_array_equal(masks[k], jmasks[k], err_msg=k)
    m = (masks["atom14_mask"] * prot.atom_mask[None]).astype(bool)
    np.testing.assert_array_equal(back.numpy()[m], x14[m])      # the round trip


def test_sc_atom14_mask_equals_jax_and_golden():
    golden = np.load(os.path.join(GOLDEN, "chem_golden.npz"))
    for chi in range(4):
        np.testing.assert_array_equal(sc_atom14_mask(chi), jax_tables.sc_atom14_mask(chi))
        np.testing.assert_array_equal(sc_atom14_mask(chi), golden[f"sc_atom14_mask_{chi}"])
    np.testing.assert_array_equal(sc_atom14_mask(4), jax_tables.sc_atom14_mask(4))
