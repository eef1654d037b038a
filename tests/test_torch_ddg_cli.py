"""``packppi_torch.cli.ddg`` on the CPU against the JAX package.

``network`` mode runs on the shipped PackPPI-AP checkpoints converted to
torch (``docs/ckpts/affinity_skempi_mini_pretrained/torch_*.pt``). Its
reference is ``ddg_eval.jsonl`` beside them: the JAX CLI's predictions with
the orbax checkpoints, which ``tools/check_jax_ddg_eval.py`` shows the JAX
package still reproduces within 1.5e-6 kcal/mol. Reading the file spares
each test run the JAX network's compilation.
Limit: 1e-4 kcal/mol per mutation (float32; the port runs the plain
versions of its kernels, the JAX package its unfused path).

``esm`` mode: from a precomputed ``.npz`` and from a tiny ESM-2 ``.pt``,
against the JAX ESM-2 forward, sequence layout and head on the same
weights: 1e-4.
"""
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FIXTURES
from torch_threads import _threads  # noqa: F401 (autouse fixture)

REPO = os.path.join(os.path.dirname(__file__), "..")
CKPTS = os.path.join(REPO, "docs", "ckpts", "affinity_skempi_mini_pretrained")
SHIPPED = {"--ckpt": os.path.join(CKPTS, "torch_affinity.pt"),
           "--pre_ckpt": os.path.join(CKPTS, "torch_backbone.pt")}
TOL = 1e-4


@pytest.fixture(scope="module")
def jax_predictions():
    with open(os.path.join(CKPTS, "ddg_eval.jsonl")) as f:
        return {(r["complex"], r["mutstr"]): r["ddg_pred"] for r in map(json.loads, f)}


def _shipped():
    return [a for kv in SHIPPED.items() for a in kv]


def test_network_mode_matches_jax_on_shipped_checkpoints(tmp_path, jax_predictions):
    from packppi_torch.cli.ddg import run_cli

    value = run_cli(["--input", os.path.join(FIXTURES, "2ftl.pdb"), "--mutstr", "KI15G",
                  "--device", "cpu", "--outdir", str(tmp_path), *_shipped()])
    assert value == pytest.approx(jax_predictions[("2FTL_E_I", "KI15G")], abs=TOL)
    written = json.loads((tmp_path / "ddg.json").read_text())
    assert written["ddg_pred"] == value and written["mutstr"] == "KI15G"


def test_eval_csv_matches_jax_per_mutation(tmp_path, jax_predictions):
    """Eight mutations, the two complexes interleaved (bucketed batches
    permute them; the output keeps the CSV's order), batch 4."""
    from packppi_torch.cli.ddg import run_cli
    from packppi_torch.data.skempi import load_skempi_entries

    src = os.path.join(FIXTURES, "skempi_mini")
    lines = open(os.path.join(src, "skempi_v2.csv")).read().splitlines()
    header, rows = lines[0], lines[1:]
    brs = [r for r in rows if r.startswith("1BRS")]
    ftl = [r for r in rows if r.startswith("2FTL")]
    picked = [r for pair in zip(brs[:4], ftl[5:9]) for r in pair]
    data = tmp_path / "skempi"
    (data / "PDBs").mkdir(parents=True)
    (data / "skempi_v2.csv").write_text("\n".join([header] + picked) + "\n")
    for name in ("1BRS", "2FTL"):
        shutil.copy(os.path.join(src, "PDBs", f"{name}.pdb"), data / "PDBs" / f"{name}.pdb")

    out = run_cli(["--eval_csv", str(data), "--batch_size", "4", "--device", "cpu",
                "--outdir", str(tmp_path / "out"), *_shipped()])
    got = [json.loads(line) for line in open(tmp_path / "out" / "ddg_eval.jsonl")]
    entries = load_skempi_entries(str(data), "PDBs")
    assert out["n"] == 8 and [(r["complex"], r["mutstr"]) for r in got] == [
        (e["complex"], e["mutstr"]) for e in entries]
    assert [r["complex"][:4] for r in got] == ["1BRS", "2FTL"] * 4
    for r, e in zip(got, entries):
        assert r["ddg_pred"] == pytest.approx(jax_predictions[(r["complex"], r["mutstr"])], abs=TOL)
        assert r["ddg_exp"] == pytest.approx(e["ddG"], abs=1e-6)
    p = np.array([r["ddg_pred"] for r in got])
    y = np.array([r["ddg_exp"] for r in got])
    assert out["rmse"] == pytest.approx(float(np.sqrt(np.mean((p - y) ** 2))), rel=1e-6)
    from scipy.stats import spearmanr

    assert out["spearman"] == pytest.approx(spearmanr(p, y).statistic, abs=1e-12)
    summary = json.loads((tmp_path / "out" / "ddg_eval_summary.json").read_text())
    assert summary == out


def _esm_head(rng, dim):
    return {f"ddg_predictor.{i}.{p}": torch.from_numpy(
        (rng.normal(size=(n, dim) if p == "weight" else n) / 8).astype(np.float32))
        for i, n in ((0, dim), (2, dim), (4, 1)) for p in ("weight", "bias")}


def _jax_head(head, wt, mt):
    """The JAX package's esm-mode net on the same head weights."""
    from packppi_tpu.models import NetworkConfig
    from packppi_tpu.models.affinity import AffinityNet

    dense = {f"Dense_{i}": {"kernel": head[f"ddg_predictor.{2 * i}.weight"].numpy().T,
                            "bias": head[f"ddg_predictor.{2 * i}.bias"].numpy()}
             for i in range(3)}
    ddg, _ = AffinityNet(NetworkConfig(), "esm").apply(
        {"params": {"DdgHead_0": dense}}, None, None, jnp.asarray(wt)[None],
        jnp.asarray(mt)[None], None)
    return float(ddg[0])


def test_esm_mode_from_precomputed_embeddings(tmp_path):
    from packppi_torch.cli.ddg import run_cli

    rng = np.random.default_rng(4)
    L, E = 195, 32
    wt, mt = (rng.normal(size=(L, E)).astype(np.float32) for _ in range(2))
    np.savez(tmp_path / "brs.npz", wt=wt, mut=mt)
    head = _esm_head(rng, E)
    torch.save(head, tmp_path / "head.pt")
    value = run_cli(["--input", os.path.join(FIXTURES, "1brs.pdb"), "--mutstr", "KA25A",
                  "--mode", "esm", "--esm_dir", str(tmp_path), "--esm_key", "brs",
                  "--ckpt", str(tmp_path / "head.pt"), "--device", "cpu",
                  "--outdir", str(tmp_path / "out")])
    assert value == pytest.approx(_jax_head(head, wt, mt), abs=TOL)
    np.savez(tmp_path / "bad.npz", wt=wt)
    with pytest.raises(SystemExit, match="'wt' and 'mut'"):
        run_cli(["--input", os.path.join(FIXTURES, "1brs.pdb"), "--mutstr", "KA25A", "--mode",
              "esm", "--esm_dir", str(tmp_path), "--esm_key", "bad", "--device", "cpu",
              "--outdir", str(tmp_path / "out")])


def test_esm_mode_from_esm_weights_matches_jax(tmp_path):
    """The whole esm path: chain-separated sequence of the wild type and of
    the mutant, a tiny ESM-2 (written as the converter writes it), cls/eos
    and inter-chain pads dropped, the head."""
    from packppi_tpu.data import esm as jax_esm
    from packppi_tpu.data import skempi as jax_skempi
    from packppi_tpu.models import esm2 as jax_esm2
    from packppi_tpu.structure import from_pdb_file
    from packppi_torch.cli.ddg import run_cli
    from packppi_torch.models.esm2 import ESM2, ESM2Config, init_esm_weights

    tiny = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64)
    model = ESM2(ESM2Config(**tiny))
    init_esm_weights(model, 5)
    sd = model.state_dict()
    torch.save({"config": {**tiny, "layer_norm_eps": 1e-5}, "state_dict": sd},
               tmp_path / "esm.pt")
    head = _esm_head(np.random.default_rng(6), 32)
    torch.save(head, tmp_path / "head.pt")
    pdb = os.path.join(FIXTURES, "1brs.pdb")
    value = run_cli(["--input", pdb, "--mutstr", "KA25A,DD35A", "--mode", "esm",
                  "--esm_ckpt", str(tmp_path / "esm.pt"), "--ckpt", str(tmp_path / "head.pt"),
                  "--device", "cpu", "--outdir", str(tmp_path / "out")])

    jcfg = jax_esm2.ESM2Config(**tiny)
    extract = jax_esm2.make_extractor(jax_esm2.convert_hf_esm(sd, jcfg), jcfg)
    prot = from_pdb_file(pdb, mse_to_met=True)
    muts = [jax_skempi.parse_mutation(m) for m in ("KA25A", "DD35A")]
    feats = jax_skempi.skempi_features(prot, muts)
    rt_mut, _ = jax_skempi.apply_mutations(prot, muts)
    ci = feats["chain_indices"]
    keep = jax_esm.residue_keep_indices(ci)

    def embed(rt):
        reps = extract(jax_esm2.tokenize(jax_esm.build_chain_separated_sequence(rt, ci)))[1:-1]
        out = np.empty((len(ci), reps.shape[-1]), np.float32)
        out[jax_esm.chain_grouped_order(ci)] = reps[keep]
        return out

    assert value == pytest.approx(_jax_head(head, embed(feats["residue_type"]), embed(rt_mut)),
                                  abs=TOL)
    with pytest.raises(SystemExit, match="--esm_ckpt"):
        run_cli(["--input", pdb, "--mutstr", "KA25A", "--mode", "esm", "--device", "cpu",
              "--esm_ckpt", str(tmp_path / "absent.pt"), "--outdir", str(tmp_path / "out")])


def test_refusals(tmp_path):
    from packppi_torch.cli.ddg import run_cli

    pdb = os.path.join(FIXTURES, "1brs.pdb")
    with pytest.raises(SystemExit, match="single mutation"):
        run_cli(["--eval_csv", str(tmp_path), "--mode", "esm", "--esm_dir", str(tmp_path),
                 "--device", "cpu"])
    with pytest.raises(ValueError, match="inconsistent"):
        run_cli(["--input", pdb, "--mutstr", "KA26A", "--device", "cpu", "--mode", "linear",
              "--outdir", str(tmp_path)])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-GPU refusal cannot be shown")
    for argv in (["--input", pdb, "--mutstr", "KA25A"],
                 ["--eval_csv", os.path.join(FIXTURES, "skempi_mini")]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_cli(argv + ["--outdir", str(tmp_path)])
