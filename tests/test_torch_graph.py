"""Port kNN graph and gathers against the JAX package: neighbour sets per
row, and the tables index for index (the port orders equal distances by
column, as ``lax.top_k`` does)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from packppi_tpu.ops.graph import gather_nodes as jax_gather_nodes
from packppi_tpu.ops.graph import masked_knn as jax_masked_knn
from packppi_torch.data import stack_batch
from packppi_torch.ops.graph import gather_nodes, masked_knn
from packppi_torch.structure import featurize, from_pdb_file

from conftest import FIXTURES
from torch_threads import _threads  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def batch():
    feats = [featurize(from_pdb_file(os.path.join(FIXTURES, n), mse_to_met=True))
             for n in ("1brs.pdb", "2ftl.pdb")]
    return stack_batch(feats, "cpu")   # padded to a bucket: masked rows too


def _sets(idx):
    return [[frozenset(row) for row in b] for b in np.asarray(idx)]


@pytest.mark.parametrize("k", [32, 8])
def test_knn_neighbour_sets_match_jax(batch, k):
    ca, mask = batch.X[:, :, 1], batch.residue_mask
    D, idx = masked_knn(ca, mask, k)
    D_ref, idx_ref = jax_masked_knn(jnp.asarray(ca.numpy()), jnp.asarray(mask.numpy()), k)
    assert idx.shape == tuple(idx_ref.shape) and idx.dtype == torch.int64
    valid = mask.numpy() > 0
    ours, ref = _sets(idx), _sets(idx_ref)
    for b in range(idx.shape[0]):
        for i in np.nonzero(valid[b])[0]:
            assert ours[b][i] == ref[b][i], (b, i)
    np.testing.assert_allclose(D.numpy(), np.asarray(D_ref), rtol=1e-5, atol=1e-4)


def test_knn_blocked_equals_dense(batch):
    ca, mask = batch.X[:, :, 1], batch.residue_mask
    D, idx = masked_knn(ca, mask, 16)
    D_b, idx_b = masked_knn(ca, mask, 16, block=48)
    np.testing.assert_array_equal(idx_b.numpy(), idx.numpy())
    np.testing.assert_array_equal(D_b.numpy(), D.numpy())


def test_gather_nodes_matches_jax(batch):
    rng = np.random.default_rng(0)
    B, L = batch.residue_mask.shape
    idx = rng.integers(0, L, size=(B, L, 5))
    for shape in [(B, L), (B, L, 7), (B, L, 5, 3)]:
        nodes = rng.normal(size=shape).astype(np.float32)
        ours = gather_nodes(torch.from_numpy(nodes), torch.from_numpy(idx))
        ref = jax_gather_nodes(jnp.asarray(nodes), jnp.asarray(idx, jnp.int32))
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("block", [None, 100])
def test_knn_orders_ties_as_jax_and_returns_contiguous_tables(batch, block):
    """Equal distances come in column order, as ``lax.top_k`` gives them, so
    the tables equal the JAX package's index for index, padded rows (all
    ties) included; the kernels take the tables as they come (contiguous)."""
    ca, mask = batch.X[:, :, 1], batch.residue_mask
    D, idx = masked_knn(ca, mask, 32, block=block)
    assert D.is_contiguous() and idx.is_contiguous()
    _, jidx = jax_masked_knn(jnp.asarray(ca.numpy()), jnp.asarray(mask.numpy()), 32, block=block)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert (mask == 0).any()
