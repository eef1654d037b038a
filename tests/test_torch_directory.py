"""Directory mode of the port's pack and prox CLIs on the CPU, against the JAX
CLIs' ``summary.json`` layout on the same corpus; the chunk loop; and a
mixed-length batch's network evaluation against each complex alone."""
import dataclasses
import json
import os
from argparse import Namespace

import numpy as np
import pytest
import torch

from packppi_torch.cli import _directory, pack, prox
from packppi_torch.data.crops import spatial_crops, take_residues
from packppi_torch.structure import from_pdb_file, to_pdb

from conftest import FIXTURES, GOLDEN
from torch_threads import _threads  # noqa: F401 (autouse fixture)

CKPT = os.path.join(GOLDEN, "pipeline_golden.npz")
PROXIMAL_KEYS = {"proximal_accepted", "proximal_objective_initial", "proximal_objective_final"}


def _crop(name, size, stride=10):
    prot = from_pdb_file(os.path.join(FIXTURES, f"{name}.pdb"), mse_to_met=True)
    return take_residues(prot, next(iter(spatial_crops(prot, size, stride)))[1])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Crops of 1BRS and 2FTL of two lengths in bucket 96: four members, so
    with three a chunk the second chunk is padded."""
    d = tmp_path_factory.mktemp("corpus")
    for name, size in (("1brs", 72), ("1brs", 96), ("2ftl", 72), ("2ftl", 96)):
        (d / f"{name}_{size}.pdb").write_text(to_pdb(_crop(name, size)))
    return d


def _pack_args(corpus, out, *extra):
    return pack.build_parser().parse_args(
        ["--input", str(corpus), "--outdir", str(out), "--device", "cpu", "--n_steps", "1",
         "--precision", "float32", "--ckpt", CKPT, *extra])


def _summary(out):
    return json.loads((out / "summary.json").read_text())


@pytest.fixture(scope="module")
def pack_runs(corpus, tmp_path_factory):
    """The port's directory pack with the refinement and the metric suite,
    and the JAX CLI's on the same corpus (without the refinement)."""
    from packppi_tpu.cli import pack as jax_pack

    ours = tmp_path_factory.mktemp("ours")
    results = pack.run_directory(_pack_args(corpus, ours, "--batch_size", "3",
                                            "--use_proximal", "--metrics"))
    theirs = tmp_path_factory.mktemp("theirs")
    jax_pack.run_directory(jax_pack.build_parser().parse_args(
        ["--input", str(corpus), "--outdir", str(theirs), "--n_steps", "1", "--batch_size",
         "3", "--n_devices", "1", "--precision", "float32", "--metrics"]))
    return results, _summary(ours), _summary(theirs)


def test_directory_pack_summary_has_the_jax_layout(pack_runs, corpus):
    results, ours, theirs = pack_runs
    assert set(ours) == set(theirs)
    assert ours["n"] == theirs["n"] == len(list(corpus.glob("*.pdb")))
    assert ours["use_proximal"] is True and ours["n_devices"] == 1
    assert ours["results"] == results
    # the same records in the same order (bucket, then name), no tail duplicates
    names = lambda s: [os.path.basename(r["input"]) for r in s["results"]]
    assert names(ours) == names(theirs)
    assert len(set(r["output"] for r in ours["results"])) == ours["n"]
    for o, t in zip(ours["results"], theirs["results"]):
        assert set(o) == set(t) | PROXIMAL_KEYS
        assert set(o["metrics"]) == set(t["metrics"])
        assert all(np.isfinite(v) for k, v in o["metrics"].items() if k != "clashscore_is_exact")
        assert type(o["metrics"]["clashscore_is_exact"]) is float
        assert o["metrics"]["clashscore_is_exact"] == 0.0


def test_directory_pack_keeps_residues_and_accepts_per_row(pack_runs):
    _, ours, _ = pack_runs
    for r in ours["results"]:
        inp, out = from_pdb_file(r["input"], mse_to_met=True), from_pdb_file(r["output"])
        np.testing.assert_array_equal(out.aaindex, inp.aaindex)
        np.testing.assert_array_equal(out.atom_mask, inp.atom_mask)
        assert np.isfinite(out.atom_positions[out.atom_mask > 0]).all()
        # each row's accept is its own objective's
        assert r["proximal_accepted"] == (r["proximal_objective_final"]
                                          < r["proximal_objective_initial"])


def test_refinement_accepts_each_row_on_its_own_trajectory(corpus):
    """The batched refinement's row r is complex r's own: its accept and
    objective equal the refinement of that complex alone, and a row whose
    objective does not fall keeps its chis while the others move."""
    from packppi_torch.data import stack_batch
    from packppi_torch.models import NetworkConfig, SampleConfig, TorsionalDiffusion
    from packppi_torch.structure import featurize

    feats = [featurize(from_pdb_file(p, mse_to_met=True)) for p in sorted(corpus.glob("*.pdb"))]
    model = TorsionalDiffusion(NetworkConfig(compute_dtype="float32"),
                               SampleConfig(num_steps=10))
    batch = stack_batch(feats, "cpu", target_len=96)
    # row 1 starts from its own input chis, the others from a perturbation
    gen = torch.Generator().manual_seed(0)
    noise = 0.6 * torch.randn(batch.SC_D.shape, generator=gen) * batch.SC_D_mask
    noise[1] = 0.0
    sc0 = batch.SC_D + noise
    sc, accept, first, last = pack._refine(model, batch, sc0)
    for r, f in enumerate(feats):
        alone = stack_batch([f], "cpu", target_len=96)
        _, acc1, f1, _ = pack._refine(model, alone, sc0[r:r + 1])
        np.testing.assert_allclose(first[r].item(), f1.item(), rtol=1e-6)
        assert bool(accept[r]) == bool(acc1[0]) == bool(last[r] < first[r])
        if not accept[r]:
            assert torch.equal(sc[r], sc0[r])
    assert accept.any()


@pytest.mark.parametrize("batch_size,n_samples", [(1, 1), (2, 2)], ids=["one_row", "best_of_2"])
def test_one_structure_directory_equals_single_mode(tmp_path, batch_size, n_samples):
    """With one complex a chunk (--batch_size 1; with two samples, 2), a
    directory of one structure draws and writes what single mode does."""
    d = tmp_path / "one"
    d.mkdir()
    (d / "c.pdb").write_text(to_pdb(_crop("2ftl", 72)))
    extra = ("--n_samples", str(n_samples), "--seed", "5")
    pack.run_directory(_pack_args(d, tmp_path / "dir", "--batch_size", str(batch_size), *extra))
    args = _pack_args(d / "c.pdb", tmp_path / "single", *extra)
    pack.run(args)
    assert ((tmp_path / "dir" / "c.pdb").read_text()
            == (tmp_path / "single" / "structure.pdb").read_text())


@pytest.fixture(scope="module")
def prox_runs(corpus, tmp_path_factory):
    """The port's and the JAX CLI's directory prox on the corpus plus a
    backbone-only structure (skipped by both)."""
    from packppi_tpu.cli import prox as jax_prox

    d = tmp_path_factory.mktemp("prox_corpus")
    for p in corpus.glob("*.pdb"):
        (d / p.name).write_text(p.read_text())
    bb = _crop("1brs", 72)
    bb_mask = np.zeros_like(bb.atom_mask)
    bb_mask[:, :4] = bb.atom_mask[:, :4]
    (d / "bb_only.pdb").write_text(to_pdb(dataclasses.replace(bb, atom_mask=bb_mask)))
    common = ["--input", str(d), "--num_steps", "2", "--batch_size", "3"]
    ours = tmp_path_factory.mktemp("prox_ours")
    prox.run_directory(prox.build_parser().parse_args(
        common + ["--outdir", str(ours), "--device", "cpu"]))
    theirs = tmp_path_factory.mktemp("prox_theirs")
    jax_prox.run_directory(jax_prox.build_parser().parse_args(
        common + ["--outdir", str(theirs), "--n_devices", "1"]))
    return d, _summary(ours), _summary(theirs)


def test_directory_prox_summary_has_the_jax_layout(prox_runs):
    d, ours, theirs = prox_runs
    assert set(ours) == set(theirs)
    assert ours["skipped"] == theirs["skipped"] == [str(d / "bb_only.pdb")]
    assert ours["n"] == theirs["n"] == 4
    for o, t in zip(ours["results"], theirs["results"]):
        assert o["input"] == t["input"]
        assert set(o) == set(t)
        assert o["accepted"] == (o["objective_final"] < o["objective_initial"])
        assert np.isfinite(o["clashscore_before"]) and np.isfinite(o["clashscore_after"])
        # the same input chis and objective
        np.testing.assert_allclose(o["objective_initial"], t["objective_initial"], rtol=1e-4)
        assert o["clashscore_before"] == t["clashscore_before"]


def test_directory_prox_writes_raw_input_on_reject(corpus, tmp_path):
    """With one step the objective cannot fall, so every row is rejected:
    --no_strict_parity writes each input as parsed, without clashscores
    under --no_clashscore."""
    prox.run_directory(prox.build_parser().parse_args(
        ["--input", str(corpus), "--outdir", str(tmp_path), "--device", "cpu", "--num_steps",
         "1", "--batch_size", "2", "--no_strict_parity", "--no_clashscore"]))
    summary = _summary(tmp_path)
    assert summary["n"] == 4
    for r in summary["results"]:
        assert r["accepted"] is False and "clashscore_before" not in r
        assert (open(r["output"]).read()
                == to_pdb(from_pdb_file(r["input"], mse_to_met=True)))


@pytest.mark.parametrize("cli", [pack, prox], ids=["pack", "prox"])
def test_more_than_one_device_raises(cli, corpus, tmp_path):
    """Several ranks run (tests/test_torch_multidevice.py); what raises is a
    device count below 1, and ranks on a card this machine does not have
    (no silent fallback to the CPU). ``--n_devices`` defaults to every
    visible card, one on the CPU."""
    args = cli.build_parser().parse_args(["--input", str(corpus), "--outdir", str(tmp_path),
                                          "--device", "cpu", "--n_devices", "-1"])
    with pytest.raises(SystemExit, match=">= 1"):
        cli.run_directory(args)
    assert _directory.resolve_n_devices(Namespace(n_devices=None, device="cpu")) == 1
    assert _directory.resolve_n_devices(Namespace(n_devices=3, device="cpu")) == 3
    if not torch.cuda.is_available():
        args = cli.build_parser().parse_args(["--input", str(corpus), "--outdir",
                                              str(tmp_path), "--n_devices", "2"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.run_directory(args)


def test_run_chunks_pads_the_tail_and_records_writer_failures():
    seen = []

    def dispatch(padded, bucket):
        seen.append((bucket, list(padded)))
        return padded

    def submit(pool, futures, chunk, out):
        for i in chunk:
            futures.append(pool.submit(lambda i=i: {"i": i} if i != 3 else 1 / 0))

    results = _directory.run_chunks({96: [0, 1, 2, 3], 64: [4]}, 3, dispatch, submit)
    assert seen == [(64, [4, 4, 4]), (96, [0, 1, 2]), (96, [3, 3, 3])]
    assert results[:4] == [{"i": 4}, {"i": 0}, {"i": 1}, {"i": 2}]
    assert results[4] == {"error": "ZeroDivisionError: division by zero"}


def test_mixed_length_batch_rows_equal_each_complex_alone(corpus):
    """One network evaluation of a bucket's chunk (rows of 72 and 96
    residues and a repeated tail row) equals each complex evaluated alone,
    padded to the same bucket, row by row."""
    from packppi_torch.data import stack_batch
    from packppi_torch.models import ChiScoreNetwork, NetworkConfig
    from packppi_torch.structure import featurize
    from packppi_torch.weights import load_weights

    feats = [featurize(from_pdb_file(p, mse_to_met=True)) for p in sorted(corpus.glob("*.pdb"))]
    assert sorted({len(f["residue_type"]) for f in feats}) == [72, 96]
    rows = feats + [feats[-1]]
    net = ChiScoreNetwork(NetworkConfig(compute_dtype="float32")).eval()
    load_weights(net, CKPT)
    batch = stack_batch(rows, "cpu", target_len=96)
    gen = torch.Generator().manual_seed(0)
    sc = (torch.rand(batch.SC_D.shape, generator=gen) * 6 - 3) * batch.SC_D_mask
    sc[-1] = sc[-2]
    t = torch.full(batch.residue_mask.shape, 0.4)
    with torch.no_grad():
        out, _ = net(batch, sc, t, skip_last_edge_update=True)
        for r, f in enumerate(rows):
            one = stack_batch([f], "cpu", target_len=96)
            alone, _ = net(one, sc[r:r + 1], t[r:r + 1], skip_last_edge_update=True)
            np.testing.assert_allclose(out[r].numpy(), alone[0].numpy(), rtol=0, atol=1e-5)
    assert torch.isfinite(out).all()
