"""Port clash losses (``packppi_torch.ops.clash``, the plain versions the
CUDA kernels are held to on the card) against the JAX package: the
row-blocked scan, the interpreted Pallas kernels and their custom VJP, and
the reference's per-atom golden on T1124. Inputs are the fixtures' own
arrays and chis perturbed by seeded numpy noise, fed to both sides.

Tolerances: float32 sums in another order agree to 1e-4 against the scan
(2e-4 for gradients); against the interpreted Pallas kernel the bounds are
the JAX package's own (``tests/test_pallas_clash.py``)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from packppi_tpu import chem as jax_chem
from packppi_tpu.data import stack_batch as jax_stack_batch
from packppi_tpu.geometry import atom14_coords_from_torsions as jax_atom14
from packppi_tpu.ops import clash as jax_clash
from packppi_tpu.ops import pallas_clash as jax_pallas
from packppi_tpu.structure import from_pdb_file as jax_from_pdb_file
from packppi_tpu.structure.featurize import featurize as jax_featurize
from packppi_torch import chem
from packppi_torch.data import ProteinBatch, stack_batch
from packppi_torch.geometry import atom14_coords_from_torsions
from packppi_torch.ops import clash
from packppi_torch.structure import featurize, from_pdb_file

from conftest import FIXTURES, GOLDEN
from torch_threads import _threads  # noqa: F401 (autouse fixture)

TOL = 0.5


def _both_batches(name, padded=False):
    path = os.path.join(FIXTURES, name)
    f = featurize(from_pdb_file(path, mse_to_met=True))
    fj = jax_featurize(jax_from_pdb_file(path, mse_to_met=True))
    n = None if padded else len(f["residue_type"])
    return stack_batch([f], "cpu", target_len=n), jax_stack_batch([fj], target_len=n)


@pytest.fixture(scope="module")
def brs():
    return _both_batches("1brs.pdb")


def _chis(batch, kind):
    """The fixture's chis, or a clash-heavy perturbation of them (numpy)."""
    sc = batch.SC_D.numpy()
    if kind == "perturbed":
        rng = np.random.default_rng(0)
        sc = sc + rng.normal(0, 0.8, sc.shape).astype(np.float32) * batch.SC_D_mask.numpy()
    return sc.astype(np.float32)


def _operands(brs, kind):
    """(torch operands, jax operands) of the between-residue term."""
    b, bj = brs
    sc = _chis(b, kind)
    pos = atom14_coords_from_torsions(b.X, b.residue_type, b.BB_D, torch.as_tensor(sc))
    rad = torch.as_tensor(chem.CHEM.vdw_radius_atom14)[b.residue_type] * b.atom_mask
    t = (pos, b.atom_mask, rad, b.residue_index)
    j = (jnp.asarray(pos.numpy()), jnp.asarray(bj.atom_mask), jnp.asarray(rad.numpy()),
         jnp.asarray(bj.residue_index))
    return t, j


def _weights(shape, exists):
    rng = np.random.default_rng(1)
    return rng.uniform(0.1, 1.0, shape).astype(np.float32) * exists


def test_chem_tables_equal_the_jax_package():
    np.testing.assert_array_equal(chem.CHEM.vdw_radius_atom14, jax_chem.CHEM.vdw_radius_atom14)
    for args in ((0.5, 12.0), (1.5, 15.0)):
        ours, ref = chem.make_atom14_dists_bounds(*args), jax_chem.make_atom14_dists_bounds(*args)
        for k in ("lower_bound", "upper_bound"):
            np.testing.assert_array_equal(ours[k], ref[k])


@pytest.mark.parametrize("kind", ["native", "perturbed"])
def test_plain_matches_scan(brs, kind):
    t, j = _operands(brs, kind)
    ours = clash.between_residue_clash_plain(*t, tol_soft=TOL)
    ref = jax_clash.between_residue_clash(*j, tol_soft=TOL, block=64)
    if kind == "perturbed":
        assert float(ref["per_atom_loss_sum"].sum()) > 1.0
    np.testing.assert_allclose(ours["per_atom_loss_sum"].numpy(),
                               np.asarray(ref["per_atom_loss_sum"]), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(ours["mean_loss"]), float(ref["mean_loss"]),
                               atol=1e-7, rtol=1e-4)


@pytest.mark.parametrize("kind", ["native", "perturbed"])
def test_plain_matches_interpreted_kernel(brs, kind):
    t, j = _operands(brs, kind)
    ours = clash.between_residue_clash_plain(*t, tol_soft=TOL)["per_atom_loss_sum"]
    ref = jax_pallas.between_residue_clash_pallas(*j, tol_soft=TOL, blk=512, interpret=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=5e-3, rtol=1e-3)


def test_block_size_does_not_matter(brs):
    t, _ = _operands(brs, "perturbed")
    a = clash.between_residue_clash_plain(*t, tol_soft=TOL, block=37)
    b = clash.between_residue_clash_plain(*t, tol_soft=TOL, block=1024)
    np.testing.assert_allclose(a["per_atom_loss_sum"].numpy(), b["per_atom_loss_sum"].numpy(),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(a["mean_loss"]), float(b["mean_loss"]), rtol=1e-5)


@pytest.mark.parametrize("via", ["scan", "interpreted_kernel"])
def test_position_gradient_matches_jax(brs, via):
    """d(sum(w * per_atom))/d positions under a non-uniform cotangent, through
    the dispatching wrapper (plain version plus autograd on the CPU)."""
    t, j = _operands(brs, "perturbed")
    w = _weights(tuple(t[1].shape), t[1].numpy())
    pos = t[0].clone().requires_grad_(True)
    before = (clash.between_residue_clash.launches_fwd, clash.between_residue_clash.launches_bwd)
    (clash.between_residue_clash(pos, *t[1:], TOL) * torch.as_tensor(w)).sum().backward()
    assert (clash.between_residue_clash.launches_fwd,
            clash.between_residue_clash.launches_bwd) == before   # no kernel on the CPU

    def loss(p):
        if via == "scan":
            out = jax_clash.between_residue_clash(p, *j[1:], tol_soft=TOL,
                                                  block=64)["per_atom_loss_sum"]
        else:
            out = jax_pallas.between_residue_clash_diff(p, *j[1:], tol_soft=TOL, interpret=True)
        return (jnp.asarray(w) * out).sum()

    ref = np.asarray(jax.grad(loss)(j[0]))
    assert np.abs(ref).sum() > 1e-3
    np.testing.assert_allclose(pos.grad.numpy(), ref, atol=2e-4, rtol=1e-3)


def test_gradient_flows_to_positions_only(brs):
    t, _ = _operands(brs, "perturbed")
    pos = t[0].clone().requires_grad_(True)
    rad = t[2].clone().requires_grad_(True)
    out = clash.between_residue_clash_plain(pos, t[1], rad, t[3], TOL)["per_atom_loss_sum"]
    assert out.shape == t[1].shape and out.requires_grad
    # the wrapper's contract on the card (positions only) is the plain
    # version's too when the radius is a constant, as on every caller's path
    (g,) = torch.autograd.grad(out.sum(), pos)
    assert torch.isfinite(g).all() and g.abs().sum() > 1e-3


def test_within_residue_violations_match_jax(brs):
    t, j = _operands(brs, "perturbed")
    b = brs[0]
    bounds = chem.make_atom14_dists_bounds(0.5, 12.0)
    lo, up = (bounds[k][b.residue_type.numpy()] for k in ("lower_bound", "upper_bound"))
    ours = clash.within_residue_violations(t[0], t[1], torch.as_tensor(lo), torch.as_tensor(up))
    ref = jax_clash.within_residue_violations(j[0], j[1], jnp.asarray(lo), jnp.asarray(up))
    assert float(ref.sum()) > 0.1
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_sc_violation_loss_matches_reference_golden():
    """T1124 per-atom clash of the reference's own code, at the bound the JAX
    package is held to (``tests/test_clash.py``)."""
    golden = np.load(os.path.join(GOLDEN, "geometry_golden.npz"))
    b, _ = _both_batches("t1124.pdb")
    coords = atom14_coords_from_torsions(b.X, b.residue_type, b.BB_D, b.SC_D)
    per_atom = clash.sc_violation_loss(coords, b.atom_mask, b.residue_type, b.residue_index,
                                       12.0, 0.5)
    np.testing.assert_allclose(per_atom[0].numpy(), golden["per_atom_clash"],
                               atol=2e-3, rtol=1e-3)


def test_sc_violation_loss_matches_jax(brs):
    t, j = _operands(brs, "perturbed")
    b, bj = brs
    ours = clash.sc_violation_loss(t[0], b.atom_mask, b.residue_type, b.residue_index, 12.0, 0.5)
    ref = jax_clash.sc_violation_loss(j[0], bj.atom_mask, bj.residue_type, bj.residue_index,
                                      12.0, 0.5)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_sc_clash_screen_matches_jax(brs):
    t, j = _operands(brs, "perturbed")
    b, bj = brs
    pos = t[0].clone().requires_grad_(True)
    ours = clash.sc_clash_screen(pos, b.atom_mask, b.residue_type, b.residue_index)
    assert not ours.requires_grad                       # forward only
    ref = jax_pallas.sc_clash_screen(j[0], bj.atom_mask, bj.residue_type, bj.residue_index,
                                     interpret=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=5e-3, rtol=1e-3)


def test_compute_residue_clash_value_and_torsion_gradient_match_jax(brs):
    b, bj = brs
    sc = _chis(b, "perturbed")
    x = torch.as_tensor(sc).requires_grad_(True)
    ours = clash.compute_residue_clash(b, x)
    ours.sum().backward()
    ref = jax_clash.compute_residue_clash(bj, jnp.asarray(sc))
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=1e-4)
    ref_g = np.asarray(jax.grad(lambda s: jax_clash.compute_residue_clash(bj, s).sum())(
        jnp.asarray(sc)))
    assert np.abs(ref_g).sum() > 1e-3
    np.testing.assert_allclose(x.grad.numpy(), ref_g, atol=5e-4, rtol=2e-3)
    # backbone slots carry no loss and residues without side chains read 0
    no_sc = (b.atom_mask[..., 4:].sum(-1) == 0).numpy()
    np.testing.assert_array_equal(ours.detach().numpy()[no_sc], 0.0)


def test_clash_invariant_to_padding():
    unpadded, _ = _both_batches("1brs.pdb")
    padded, _ = _both_batches("1brs.pdb", padded=True)
    L = unpadded.X.shape[1]
    assert padded.X.shape[1] > L
    a = clash.compute_residue_clash(unpadded, unpadded.SC_D)
    b = clash.compute_residue_clash(padded, padded.SC_D)
    np.testing.assert_allclose(a.numpy(), b[:, :L].numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(b[:, L:].numpy(), 0.0)


def test_batch_rows_are_independent(brs):
    b = brs[0]
    chis = [torch.as_tensor(_chis(b, k)) for k in ("native", "perturbed")]
    two = ProteinBatch(*(torch.cat([t, t]) for t in b))
    both = clash.compute_residue_clash(two, torch.cat(chis))
    for row, sc in enumerate(chis):
        np.testing.assert_allclose(both[row].numpy(), clash.compute_residue_clash(b, sc)[0].numpy(),
                                   atol=1e-6, rtol=1e-6)
    assert not np.allclose(both[0].numpy(), both[1].numpy())


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(brs):
    t, _ = _operands(brs, "native")
    with pytest.raises(TypeError, match="float32"):
        clash._check(t[0].double(), *t[1:])
    with pytest.raises(ValueError, match=r"\[B, L, 14, 3\]"):
        clash._check(t[0][..., :2], *t[1:])
    with pytest.raises(TypeError, match="residue_index"):
        clash._check(t[0], t[1], t[2], t[3].int())
    with pytest.raises(ValueError, match="atom_radius"):
        clash._check(t[0], t[1], t[2][:, :-1], t[3])


# ---------------------------------------------------------------- culling
# The kernels walk, for each row tile of 32 flat atoms, only the column tiles
# that ``clash.clash_tiles_plain`` lists. These tests hold that list on real
# structures: native 1BRS and a clash-heavy T1124 (chis perturbed by a seeded
# N(0, 0.8), as ``chip_smoke.py`` perturbs them).


def _culling_case(name):
    b, _ = _both_batches(f"{name}.pdb", padded=True)
    kind = "perturbed" if name == "t1124" else "native"
    pos = atom14_coords_from_torsions(b.X, b.residue_type, b.BB_D, torch.as_tensor(_chis(b, kind)))
    rad = torch.as_tensor(chem.CHEM.vdw_radius_atom14)[b.residue_type] * b.atom_mask
    ops = (pos, b.atom_mask, rad, b.residue_index)
    boxes, tiles, counts = clash.clash_tiles_plain(*ops[:3], TOL)
    full, overlap = clash.tiled_clash_plain(*ops, TOL)
    return dict(ops=ops, boxes=boxes, tiles=tiles, counts=counts, full=full, overlap=overlap,
                listed=clash.listed_tile_pairs(tiles, counts))


@pytest.fixture(scope="module", params=["1brs", "t1124"])
def culled(request):
    return _culling_case(request.param)


def test_culling_lists_every_overlapping_tile_pair(culled):
    overlap, listed, counts, tiles = (culled[k] for k in ("overlap", "listed", "counts", "tiles"))
    T = counts.shape[-1]
    assert overlap.sum() > 10                              # the check is not empty
    assert not (overlap & ~listed).any()
    assert counts.sum() < T * T / 4                        # and the culling culls
    for r in range(T):                                     # each list ascending, -1 after it
        row = tiles[0, r].long()
        n = int(counts[0, r])
        assert (row[:n].diff() > 0).all() and (row[n:] == -1).all()


def test_sum_over_listed_tiles_equals_the_full_sum(culled):
    """Bit for bit: every pair left out is an exact zero; and the tiled sum
    is the row-blocked plain version's."""
    listed_sum, _ = clash.tiled_clash_plain(*culled["ops"], TOL, culled["tiles"], culled["counts"])
    assert torch.equal(listed_sum, culled["full"])
    ref = clash.between_residue_clash_plain(*culled["ops"], TOL)["per_atom_loss_sum"]
    assert culled["full"].sum() > 1.0
    torch.testing.assert_close(culled["full"], ref, atol=1e-5, rtol=1e-5)


def test_culling_control_a_needed_tile_pair_dropped_fails(culled):
    """The control: the list of the row tile with the most overlapping tile
    pairs loses one of them; the coverage check and the sum must both see it."""
    overlap, tiles, counts = culled["overlap"], culled["tiles"].clone(), culled["counts"].clone()
    r = int(overlap[0].sum(1).argmax())
    c = int(overlap[0, r].nonzero()[-1])
    row = tiles[0, r, :counts[0, r]].long()
    kept = row[row != c]
    tiles[0, r] = -1
    tiles[0, r, :len(kept)] = kept.to(torch.int16)
    counts[0, r] = len(kept)
    assert (overlap & ~clash.listed_tile_pairs(tiles, counts)).any()
    dropped, _ = clash.tiled_clash_plain(*culled["ops"], TOL, tiles, counts)
    assert (dropped - culled["full"]).abs().max() > 1e-3


def test_culling_off_lists_every_tile(brs):
    t, _ = _operands(brs, "perturbed")
    _, tiles, counts = clash.clash_tiles_plain(*t[:3], TOL, cull=False)
    T = counts.shape[-1]
    assert (counts == T).all()
    assert torch.equal(tiles.long(), torch.arange(T).expand_as(tiles))


def test_tile_boxes_bound_their_existing_atoms(brs):
    t, _ = _operands(brs, "perturbed")
    pos, ex, rad = t[0], t[1], t[2]
    boxes = clash.tile_boxes_plain(pos, ex, rad)
    A = pos.shape[1] * 14
    tile = torch.arange(A) // clash.TILE
    p, e, r = pos.reshape(A, 3), ex.reshape(A) > 0, rad.reshape(A)
    box = boxes[0, tile]
    assert ((box[:, :3] <= p) & (p <= box[:, 3:6])).all(-1)[e].all()
    assert (r[e] <= box[e, 6]).all() and (box[e, 7] == 1).all()
    assert torch.equal(boxes[0, :, 7] > 0, torch.zeros(len(boxes[0]), dtype=torch.bool)
                       .index_put_((tile[e],), torch.tensor(True)))
