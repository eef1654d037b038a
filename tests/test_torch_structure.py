"""The port's PDB parser, featurization and batching equal the JAX
package's on the repository's three fixtures."""
import os

import numpy as np
import pytest
import torch

from packppi_tpu import native as jax_native
from packppi_tpu.data import stack_batch as jax_stack_batch
from packppi_tpu.structure import from_pdb_file as jax_from_pdb_file
from packppi_tpu.structure import to_pdb as jax_to_pdb
from packppi_tpu.structure.featurize import featurize as jax_featurize
from packppi_torch.data import ProteinBatch, bucket_length, stack_batch
from packppi_torch import native as port_native
from packppi_torch.structure import featurize, from_pdb_file, to_pdb
from packppi_torch.structure.protein import from_pdb_string_python

from conftest import FIXTURES
from torch_threads import _threads  # noqa: F401 (autouse fixture)

PDBS = ["1brs.pdb", "2ftl.pdb", "t1124.pdb"]


@pytest.fixture(scope="module")
def parsed():
    """(port, JAX package) parses, each package parsing the file itself:
    both through their native parsers (float32 coordinates), which this
    machine builds."""
    assert port_native.get_lib() is not None and jax_native.get_lib() is not None
    return {name: (from_pdb_file(os.path.join(FIXTURES, name), mse_to_met=True),
                   jax_from_pdb_file(os.path.join(FIXTURES, name), mse_to_met=True))
            for name in PDBS}


def test_pure_python_parser_matches_jax_package():
    """The pure-Python parsers, the behavioural spec, agree too (the JAX
    side's native parser patched away; float64 coordinates)."""
    path = os.path.join(FIXTURES, "1brs.pdb")
    text = open(path).read()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "parse_pdb_native", lambda *args, **kwargs: None)
        ref = jax_from_pdb_file(path, mse_to_met=True)
    ours = from_pdb_string_python(text, mse_to_met=True)
    assert ours.atom_positions.dtype == np.float64
    for field in ("atom_positions", "aaindex", "atom_mask", "residue_index",
                  "chain_id", "b_factors"):
        np.testing.assert_array_equal(getattr(ours, field), getattr(ref, field),
                                      err_msg=field)


@pytest.mark.parametrize("name", PDBS)
def test_parser_matches_jax_package(parsed, name):
    ours, ref = parsed[name]
    for field in ("atom_positions", "aaindex", "atom_mask", "residue_index",
                  "chain_id", "b_factors"):
        np.testing.assert_array_equal(getattr(ours, field), getattr(ref, field),
                                      err_msg=field)
    assert to_pdb(ours) == jax_to_pdb(ref)


@pytest.mark.parametrize("name", PDBS)
def test_featurize_matches_jax_package(parsed, name):
    ours, ref = parsed[name]
    f, g = featurize(ours), jax_featurize(ref)
    assert sorted(f) == sorted(g)
    for k in f:
        np.testing.assert_array_equal(f[k], g[k], err_msg=k)


def test_stack_batch_matches_jax_package(parsed):
    feats = [featurize(parsed[n][0]) for n in ("1brs.pdb", "2ftl.pdb")]
    ours = stack_batch(feats, "cpu")
    ref = jax_stack_batch([jax_featurize(parsed[n][1]) for n in ("1brs.pdb", "2ftl.pdb")])
    assert ours._fields == ref._fields == ProteinBatch._fields
    assert ours.X.shape[1] == bucket_length(max(len(f["residue_type"]) for f in feats))
    for name in ProteinBatch._fields:
        a, b = getattr(ours, name), np.asarray(getattr(ref, name))
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        if b.dtype.kind == "f":
            assert a.dtype == torch.float32
        elif b.dtype.kind in "iu":
            assert a.dtype == torch.int64
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


def test_stack_batch_exact_length(parsed):
    f = featurize(parsed["t1124.pdb"][0])
    assert stack_batch([f], "cpu").X.shape[1] == 768
    assert stack_batch([f], "cpu", target_len=741).X.shape[1] == 741
