"""esm mode over a dataset on the CPU at a tiny width (3 layers, hidden 64, 4
heads, FFN 128): the port's ESM-2 against the benchmark's plain reference
(``perfbench/reference/esm2.py``), the batched extractor against one
sequence at a time, ``cli.ddg --eval_csv --mode esm`` against the
single-mutation path, and the spans of the esm path.

Tolerances: 1e-5 of max|ref| for the forward (float32 both; the port pads
and masks a batch, the reference runs each sequence alone, so the sums run
in another order), 1e-5 kcal/mol for a prediction.
"""
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from conftest import FIXTURES
from torch_threads import _threads  # noqa: F401 (autouse fixture)

REPO = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, REPO)

TINY = dict(hidden_size=64, num_layers=3, num_heads=4, intermediate_size=128)


@pytest.fixture(scope="module")
def model():
    """The port's tiny ESM-2 on seeded weights with LayerNorm scales and
    offsets away from 1 and 0."""
    from packppi_torch.models.esm2 import ESM2, ESM2Config

    m = ESM2(ESM2Config(**TINY, attention_impl="dense")).eval()
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for name, p in m.named_parameters():
            r = torch.randn(p.shape, generator=g)
            p.copy_(1.0 + 0.1 * r if "LayerNorm.weight" in name or "norm_after.weight" in name
                    else (0.1 * r if p.ndim == 1 else r / np.sqrt(p.shape[-1])))
    return m


@pytest.fixture(scope="module")
def esm_file(model, tmp_path_factory):
    path = tmp_path_factory.mktemp("esm") / "esm_tiny.pt"
    torch.save({"config": {**TINY, "layer_norm_eps": 1e-5}, "state_dict": model.state_dict()},
               path)
    return path


def test_port_esm2_matches_the_plain_reference(model):
    """Two chains (ids out of order, one residue of its own chain 0), a
    mutant row and a shorter third row: the port's padded batch, row by
    row, against the reference on each sequence alone; and the two
    tokenizations equal."""
    from packppi_torch.data.esm import residue_tokens
    from packppi_torch.models.esm2 import pad_tokens
    from perfbench.reference import esm2 as rx

    rng = np.random.default_rng(3)
    chains = np.array([2, 2, 2, 1, 1, 0, 1, 2, 1, 1, 2, 2, 1], np.int64)
    wt = rng.integers(0, 20, len(chains))
    mt = wt.copy()
    mt[4] = (wt[4] + 5) % 20
    short = rng.integers(0, 20, 6)
    seqs = [(wt, chains), (mt, chains), (short, np.ones(6, np.int64))]
    tokens = []
    for aatype, ch in seqs:
        ids, rows = residue_tokens(aatype, ch)
        want_ids, want_rows = rx.tokens(aatype, ch)
        assert np.array_equal(ids, want_ids) and np.array_equal(rows, want_rows)
        tokens.append(ids)
    ids, mask = pad_tokens(tokens)
    assert ids.shape == (3, 128) and mask[2].sum() == len(tokens[2]) < len(tokens[0])
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask))
        p = rx.Params(dict(model.state_dict()))
        for b, t in enumerate(tokens):
            want = rx.forward(p, torch.from_numpy(t), TINY["num_heads"], TINY["num_layers"])
            d = (got[b, :len(t)] - want).abs().max()
            assert d <= 1e-5 * want.abs().max(), (b, float(d))


def test_batched_extractor_equals_one_sequence_at_a_time(esm_file):
    """``stack_esm_batch`` and ``embed_rows``: three mutations of three
    complexes (chain ids out of order, one residue without a chain, one
    sequence long enough to set T = 256) in one forward, each residue row
    of the wild type and of the mutant as its mutation gives it alone."""
    from packppi_torch.data.esm import load_esm_model, residue_tokens
    from packppi_torch.data.skempi import stack_esm_batch
    from packppi_torch.models.esm2 import embed_rows

    model = load_esm_model(esm_file, "cpu")
    rng = np.random.default_rng(5)
    items = []
    for chains in (np.array([1, 1, 1, 0, 1, 1, 2, 2, 2, 2]), np.array([2, 2, 1, 1, 1, 2, 1]),
                   np.repeat([1, 2], 80)):
        wt = rng.integers(0, 20, len(chains))
        mt = wt.copy()
        mt[1] = (wt[1] + 3) % 20
        (wt_tokens, rows), (mt_tokens, _) = (residue_tokens(r, chains) for r in (wt, mt))
        items.append({"residue_type": wt, "wt_tokens": wt_tokens, "mt_tokens": mt_tokens,
                      "token_rows": rows, "ddg": np.float32(0.0)})

    def embed(its):
        b = stack_esm_batch(its, "cpu")
        with torch.no_grad():
            return embed_rows(model, b.input_ids, b.attention_mask, b.rows), b

    together, batch = embed(items)
    assert batch.input_ids.shape == (6, 256)
    for k, it in enumerate(items):
        alone, _ = embed([it])
        n = len(it["token_rows"])
        assert together.shape[-1] == TINY["hidden_size"] and not together[:, k, n:].any()
        for side in range(2):
            np.testing.assert_allclose(together[side, k, :n], alone[side, 0],
                                       atol=1e-5 * alone.abs().max(), rtol=0)


def _esm_head(dim):
    rng = np.random.default_rng(6)
    return {f"ddg_predictor.{i}.{p}": torch.from_numpy(
        (rng.normal(size=(n, dim) if p == "weight" else n) / 8).astype(np.float32))
        for i, n in ((0, dim), (2, dim), (4, 1)) for p in ("weight", "bias")}


def test_eval_csv_esm_matches_the_single_mutation_path(tmp_path, esm_file):
    """Eight mutations, the two complexes interleaved, batch 4: one forward a
    batch; each prediction as ``cli.ddg --mode esm`` gives it alone; the
    files in the CSV's order."""
    from packppi_torch.cli.ddg import run_cli
    from packppi_torch.data.skempi import load_skempi_entries

    src = os.path.join(FIXTURES, "skempi_mini")
    lines = open(os.path.join(src, "skempi_v2.csv")).read().splitlines()
    brs = [r for r in lines[1:] if r.startswith("1BRS")]
    ftl = [r for r in lines[1:] if r.startswith("2FTL")]
    data = tmp_path / "skempi"
    (data / "PDBs").mkdir(parents=True)
    (data / "skempi_v2.csv").write_text(
        "\n".join([lines[0]] + [r for pair in zip(brs[:4], ftl[:4]) for r in pair]) + "\n")
    for name in ("1BRS", "2FTL"):
        shutil.copy(os.path.join(src, "PDBs", f"{name}.pdb"), data / "PDBs" / f"{name}.pdb")
    torch.save(_esm_head(TINY["hidden_size"]), tmp_path / "head.pt")
    esm = ["--mode", "esm", "--esm_ckpt", str(esm_file), "--ckpt", str(tmp_path / "head.pt"),
           "--device", "cpu"]

    out = run_cli(["--eval_csv", str(data), "--outdir", str(tmp_path / "out"), *esm])
    got = [json.loads(line) for line in open(tmp_path / "out" / "ddg_eval.jsonl")]
    entries = load_skempi_entries(str(data), "PDBs")
    assert out["n"] == 8 and [(r["complex"], r["mutstr"]) for r in got] == [
        (e["complex"], e["mutstr"]) for e in entries]
    assert json.loads((tmp_path / "out" / "ddg_eval_summary.json").read_text()) == out
    for r, e in zip(got, entries):
        alone = run_cli(["--input", e["pdb_path"], "--mutstr", e["mutstr"],
                         "--outdir", str(tmp_path / "one"), *esm])
        assert r["ddg_pred"] == pytest.approx(alone, abs=1e-5), e["mutstr"]


def test_esm_spans_live_only_under_the_profiler(model):
    """``esm.embed`` (the one forward) and ``affinity.esm_head`` once a batch
    under a recording profiler; without one nothing is recorded."""
    from packppi_torch.data.skempi import esm_item, parse_mutation, stack_esm_batch
    from packppi_torch.models import NetworkConfig
    from packppi_torch.models.affinity import AffinityNet, EsmAffinityModel
    from packppi_torch.structure import from_pdb_file
    from packppi_torch.utils import trace

    prot = from_pdb_file(os.path.join(FIXTURES, "1brs.pdb"), mse_to_met=True)
    batch = stack_esm_batch([esm_item(prot, [parse_mutation(m)]) for m in ("KA25A", "DD35A")],
                            "cpu")
    assert batch.input_ids.shape[0] == 3                      # one wild type, two mutants
    net = AffinityNet(NetworkConfig(), "esm", esm_dim=TINY["hidden_size"])
    net.load_state_dict(_esm_head(TINY["hidden_size"]))
    esm = EsmAffinityModel(model, net)
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("kept"):
            pass
    before = trace.records()
    esm.predict(batch)
    assert trace.records() == before
    with profile(activities=[ProfilerActivity.CPU]):
        ddg, inv = esm.predict(batch)
    names = [(s.name, s.parent) for s in trace.records()]
    assert names == [("esm.embed", None), ("affinity.esm_head", None)]
    assert ddg.shape == inv.shape == (2,) and trace.report()["counters"]["attention"] == 0
