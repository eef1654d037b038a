"""The port on several gloo ranks of the CPU against one device and the JAX
package: the data-parallel loss (ranks with unequal chi counts), an AdamW
step under DP x FSDP, sequence-parallel refinement, the GPipe schedule
against the JAX package's (a cut of ``tests/test_pipeline_parallel.py`` to
four ranks), ESM-2 under tensor and pipeline parallelism, the sharded pack
and directory CLIs, both trainers on a (data, model) mesh with resume, and
the multi-rank dry run.

Every test that starts ranks is in this file, so ``--dist loadfile`` keeps
them on one worker: at most four ranks at a time, one torch thread each,
running ``tests/torch_rank_fns.py`` (no JAX) or the port's entry points.
Tolerances: the loss 2e-5 relative (``tests/test_multichip.py``'s limit);
parameters after the step 1e-6 (see the test for the exception); the
pipeline 1e-6; ESM-2 in float32 1e-5 absolute and relative; the
sharded CLIs' chis 1e-5 rad and their ``summary.json`` numbers 1e-5; the
refinement's chis 2e-5 and losses 2e-5 relative (``test_multichip.py``'s).
"""
import contextlib
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from packppi_tpu.data import stack_batch as jax_stack_batch
from packppi_tpu.models import NetworkConfig as JaxNetworkConfig
from packppi_tpu.models import SampleConfig as JaxSampleConfig
from packppi_tpu.models import TorsionalDiffusion as JaxTorsionalDiffusion
from packppi_tpu.models.diffusion_net import ChiScoreNetwork as JaxChiScoreNetwork
from packppi_tpu.models.esm2 import esm2_forward, esm2_param_shardings, esm2_pipeline_forward
from packppi_tpu.parallel import batch_sharding, make_mesh, replicated
from packppi_tpu.parallel import pipeline_apply as jax_pipeline_apply
from packppi_torch.data import stack_batch
from packppi_torch.data.crops import spatial_crops, take_residues
from packppi_torch.models import NetworkConfig, TorsionalDiffusion
from packppi_torch.parallel.launch import launch
from packppi_torch.structure import featurize, from_pdb_file, to_pdb
from packppi_torch.train.diffusion_task import init_state, make_train_step
from packppi_torch.weights import esm_from_jax_params, from_flax_params

import torch_rank_fns
from conftest import FIXTURES
from test_torch_parallel import ESM, esm_case  # noqa: F401 (fixture)
from test_torch_so2 import _table_cache, jax_schedule  # noqa: F401 (autouse fixture)
from test_torch_trainer import corpus  # noqa: F401 (fixture)
from torch_threads import _threads  # noqa: F401 (autouse fixture)

pytestmark = pytest.mark.skipif(jax.device_count() < 4, reason="needs 4 virtual devices")

REPO = Path(__file__).resolve().parent.parent
CFG = dict(dropout=0.0, top_k=16)


@contextlib.contextmanager
def one_thread_per_rank():
    """Ranks share out this process's torch threads: one each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def run_ranks(fn, n, *args):
    with one_thread_per_rank():
        return launch(fn, n, "cpu", *args)


# ---- the loss, one AdamW step, sequence-parallel refinement ------------------

@pytest.fixture(scope="module")
def feats():
    """Four rows of 1BRS of unequal length and chi count: two ranks of two
    rows each hold different numbers of chis."""
    a = featurize(from_pdb_file(os.path.join(FIXTURES, "1brs.pdb"), chain_id="A",
                                mse_to_met=True))
    d = featurize(from_pdb_file(os.path.join(FIXTURES, "1brs.pdb"), chain_id="D",
                                mse_to_met=True))
    cut = lambda f, s: {k: v[s] for k, v in f.items()}
    return [cut(a, slice(0, 52)), cut(d, slice(10, 50)), cut(a, slice(30, 60)),
            cut(d, slice(0, 58))]


@pytest.fixture(scope="module")
def jax_side(feats):
    """The JAX network's weights, its draws from one key, its loss on one
    device and on a 4-device data mesh."""
    jb = jax_stack_batch(feats)
    model = JaxTorsionalDiffusion(
        net=JaxChiScoreNetwork(JaxNetworkConfig(**CFG)),
        schedule_pi=jax_schedule(True, mode="ode"), schedule_2pi=jax_schedule(False, mode="ode"),
        sample_cfg=JaxSampleConfig())
    params = model.init(jax.random.key(0), jb)
    key = jax.random.key(7)
    kt, kn, _ = jax.random.split(key, 3)
    k1, k2 = jax.random.split(kn)
    B = jb.residue_mask.shape[0]
    draws = dict(t=np.asarray(jax.random.uniform(kt, (B,))),
                 noise_pi=np.asarray(jax.random.normal(k1, jb.SC_D.shape)),
                 noise_2pi=np.asarray(jax.random.normal(k2, jb.SC_D.shape)))
    mesh = make_mesh(4, model_parallel=1)
    b_shard = jax.tree_util.tree_map(lambda _: batch_sharding(mesh), jb)
    sharded = jax.jit(model.loss, in_shardings=(replicated(mesh), replicated(mesh), b_shard),
                      out_shardings=replicated(mesh))
    sd = from_flax_params(jax.tree_util.tree_map(np.asarray, params))
    return sd, draws, float(sharded(params, key, jb)), jb.residue_mask.shape[1]


def _seq_case():
    from packppi_torch.parallel.dryrun import synthetic_batch

    arrays = synthetic_batch(B=2, L=64, seed=5)
    rng = np.random.default_rng(3)
    bad = (arrays["SC_D"] + rng.normal(0, 0.7, arrays["SC_D"].shape).astype(np.float32)
           * arrays["SC_D_mask"]).astype(np.float32)
    return arrays, bad, 5


def _mlp(nl=4, d=16, dp=2, M=2, seed=0):
    rng = np.random.default_rng(seed)
    B = dp * M * 2
    return (M, (rng.normal(size=(nl, d, d)) * d ** -0.5).astype(np.float32),
            (rng.normal(size=(nl, d)) * 0.1).astype(np.float32),
            rng.normal(size=(B, 5, d)).astype(np.float32),
            rng.normal(size=(B, 5, d)).astype(np.float32), np.arange(B) % 3 != 0)


def _jax_pipeline(mesh, M, w, b, x, bias, keep):
    def apply_layer(lp, c):
        x, bias, keep = c
        return jnp.tanh(x @ lp["w"] + lp["b"] + bias) * keep[:, None, None], bias, keep

    return jax_pipeline_apply(mesh, {"w": jnp.asarray(w), "b": jnp.asarray(b)},
                              (jnp.asarray(x), jnp.asarray(bias), jnp.asarray(keep)),
                              apply_layer, n_microbatches=M)


@pytest.fixture(scope="module")
def ranks_2x2(feats, jax_side, esm_case):
    """Four ranks (data 2, model 2), one launch: the AdamW step under DP x
    FSDP, sequence-parallel refinement, the pipeline of ``_mlp()`` and
    ESM-2."""
    sd, draws, _, L = jax_side
    cfg, params, ids, mask = esm_case
    esm_sd = esm_from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    return run_ranks(torch_rank_fns.mesh_2x2, 4, (sd, CFG, feats, L, draws, 2, _seq_case()),
                     _mlp(), (esm_sd, ESM, ids, mask, 2, 2))


@pytest.fixture(scope="module")
def fsdp_ranks(ranks_2x2):
    return [r["fsdp"] for r in ranks_2x2]


@pytest.fixture(scope="module")
def ranks_1x4():
    """Four ranks (data 1, model 4): the pipeline of ``_mlp(dp=1)`` and its
    two divisibility errors."""
    return run_ranks(torch_rank_fns.pipeline, 4, 4, *_mlp(dp=1), True)


def _rows_of(reports, key):
    """The global batch from the ranks of model index 0, in data order."""
    seen, parts = set(), []
    for r in reports:
        if (r["rows"].start, r["rows"].stop) not in seen:
            seen.add((r["rows"].start, r["rows"].stop))
            parts.append((r["rows"].start, r[key]))
    return np.concatenate([p for _, p in sorted(parts, key=lambda x: x[0])])


def test_dp_loss_matches_jax_and_one_device_with_unequal_chi_counts(feats, jax_side):
    sd, draws, jax_loss, L = jax_side
    reports = run_ranks(torch_rank_fns.dp_loss, 2, sd, CFG, feats, L, draws)
    assert reports[0]["chis"] != reports[1]["chis"]
    assert reports[0]["loss"] == reports[1]["loss"]
    model = TorsionalDiffusion(NetworkConfig(**CFG))
    model.net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    one = model.loss(stack_batch(feats, "cpu", target_len=L), None,
                     **{k: torch.from_numpy(v) for k, v in draws.items()}).item()
    np.testing.assert_allclose(reports[0]["loss"], jax_loss, rtol=2e-5)
    np.testing.assert_allclose(reports[0]["loss"], one, rtol=2e-5)
    # a mean of the ranks' own losses would be another number, further off
    # than the tolerance
    chis = [r["chis"] for r in reports]
    assert abs(np.mean([reports[0]["loss"] * sum(chis) / c / 2 for c in chis])
               - reports[0]["loss"]) > 1e-4 * reports[0]["loss"]


def test_adamw_step_under_dp_and_fsdp_matches_one_device(feats, jax_side, fsdp_ranks):
    sd, draws, _, L = jax_side
    model = TorsionalDiffusion(NetworkConfig(**CFG))
    state = init_state(model, 0, "cpu")
    model.net.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    loss = make_train_step(model, state.optimizer)(
        state, stack_batch(feats, "cpu", target_len=L),
        **{k: torch.from_numpy(v) for k, v in draws.items()})
    one_opt = state.optimizer.state_dict()
    lr = state.optimizer.param_groups[0]["lr"]
    for r in fsdp_ranks:
        np.testing.assert_allclose(r["loss"], loss.item(), rtol=2e-5)
        assert len(r["sharded"]) >= 20                     # FSDP sharded the large tensors
        # the gathered optimizer state is one device's, moment for moment: the
        # gradients agree to float32 summation order
        for i, s in one_opt["state"].items():
            for name in ("exp_avg", "exp_avg_sq"):
                np.testing.assert_allclose(r["opt_state"]["state"][i][name].numpy(),
                                           s[name].numpy(), atol=1e-7, rtol=1e-4)
        # every parameter within 1e-6, but where one device's gradient is
        # below 1e-6 (100 x Adam's eps): there the first step's update,
        # lr * g / (|g| + eps), moves by up to lr when the gradient's last
        # float32 bits move (on the CPU a -6.98e-9 gradient read -6.52e-9 over
        # the ranks, 1.2e-9 of its tensor's max: 1.66e-6 on the parameter)
        for i, (k, v) in enumerate(state.params.items()):
            g = one_opt["state"][i]["exp_avg"].numpy() / 0.1 if i in one_opt["state"] else 0
            tol = np.where(np.abs(g) < 1e-6, lr, 1e-6)
            d = np.abs(r["params"][k] - v.numpy())
            assert (d <= tol).all(), (k, d.max())
            assert (d > 1e-6).sum() <= max(1, d.size // 1000), k


def test_proximal_sequence_parallel_matches_one_device(fsdp_ranks):
    from packppi_torch.parallel.dryrun import to_batch
    from packppi_torch.sampling import proximal_optimize

    arrays, bad, steps = _seq_case()
    single = proximal_optimize(to_batch(arrays, "cpu"), torch.from_numpy(bad), num_steps=steps)
    rows = {(r["rows"].start, r["rows"].stop): r["seq_sc"] for r in fsdp_ranks}
    got = np.concatenate([v for _, v in sorted(rows.items())])
    np.testing.assert_allclose(got, single.SC_D.numpy(), atol=2e-5)
    for r in fsdp_ranks:
        np.testing.assert_allclose(r["seq_losses"], single.losses.numpy(), rtol=2e-5)


# ---- the pipeline and ESM-2 ------------------------------------------------------

@pytest.mark.parametrize("dp,pp", [(2, 2), (1, 4)], ids=["dp2_pp2", "dp1_pp4"])
def test_pipeline_matches_jax_pipeline(dp, pp, ranks_2x2, ranks_1x4):
    """(dp, pp, M) = (2, 2, 2) and (1, 4, 2), four layers, with a pytree
    carry (x and a per-example bias that every layer reads) and a bool
    leaf."""
    case = _mlp(dp=dp)
    reports = [r["pipeline"] for r in ranks_2x2] if dp == 2 else ranks_1x4
    ref = _jax_pipeline(make_mesh(4, model_parallel=pp), *case)
    np.testing.assert_allclose(_rows_of(reports, "x"), np.asarray(ref[0]), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(_rows_of(reports, "bias"), case[4])
    # every stage of a row holds the last stage's outputs
    for r in reports:
        np.testing.assert_array_equal(r["x"], _rows_of(reports, "x")[r["rows"]])


def test_pipeline_keeps_a_bool_carry_bool(ranks_2x2, ranks_1x4):
    for reports, dp in (([r["pipeline"] for r in ranks_2x2], 2), (ranks_1x4, 1)):
        assert {r["keep_dtype"] for r in reports} == {"torch.bool"}
        np.testing.assert_array_equal(_rows_of(reports, "keep"), _mlp(dp=dp)[5])


def test_pipeline_raises_both_divisibility_errors(ranks_1x4):
    with pytest.raises(ValueError, match="not divisible") as jax_layers:
        _jax_pipeline(make_mesh(4, model_parallel=4), *_mlp(nl=3, dp=1))
    for r in ranks_1x4:
        layers, batch = r["errors"]
        assert layers == "num_layers=3 not divisible by 4 stages" == str(jax_layers.value)
        assert batch == "global batch 3 not divisible by data=1 x microbatches=2"


# ---- ESM-2 -------------------------------------------------------------------

def test_esm2_tensor_parallel_matches_jax(esm_case, ranks_2x2):
    cfg, params, ids, mask = esm_case
    mesh = make_mesh(4, model_parallel=2)
    rows = batch_sharding(mesh)
    fwd = jax.jit(lambda p, i, m: esm2_forward(p, i, m, cfg),
                  in_shardings=(esm2_param_shardings(mesh, params), rows, rows),
                  out_shardings=rows)
    ref = np.asarray(fwd(params, ids.astype(np.int32), mask))
    got = _rows_of([r["esm"] for r in ranks_2x2], "tp")
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[valid], ref[valid], atol=1e-5, rtol=1e-5)


def test_esm2_pipeline_matches_jax(esm_case, ranks_2x2):
    cfg, params, ids, mask = esm_case
    mesh = make_mesh(4, model_parallel=2)
    rep, rows = replicated(mesh), batch_sharding(mesh)
    fwd = jax.jit(lambda p, i, m: esm2_pipeline_forward(p, i, m, cfg, mesh, n_microbatches=2),
                  in_shardings=(jax.tree_util.tree_map(lambda _: rep, params), rows, rows),
                  out_shardings=rows)
    ref = np.asarray(fwd(params, ids.astype(np.int32), mask))
    got = _rows_of([r["esm"] for r in ranks_2x2], "pp")
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[valid], ref[valid], atol=1e-5, rtol=1e-5)


# ---- ranks -------------------------------------------------------------------

def test_rank_workers_import_no_jax(ranks_2x2):
    assert [r["jax_modules"] for r in ranks_2x2] == [[]] * 4


def test_nccl_with_more_ranks_than_cards_raises():
    if torch.cuda.is_available() and torch.cuda.device_count() >= 2:
        pytest.skip("two or more cards: NCCL has one a rank")
    with pytest.raises(RuntimeError, match="no CUDA device|share_device=True"):
        launch(torch_rank_fns.loaded_jax_modules, 2, "cuda")


def test_a_failing_rank_fails_the_launch():
    with one_thread_per_rank(), pytest.raises(RuntimeError, match="raised:"):
        launch(torch_rank_fns.pipeline, 2, "cpu", 2, *_mlp(nl=3, dp=1))


# ---- the CLIs ------------------------------------------------------------------

@pytest.fixture(scope="module")
def crop_dir(tmp_path_factory):
    """Four 48-residue crops of 1BRS (directory mode's corpus), and one of
    them alone (the single-structure input)."""
    prot = from_pdb_file(os.path.join(FIXTURES, "1brs.pdb"), mse_to_met=True)
    d = tmp_path_factory.mktemp("crops")
    for k, (_, sel) in enumerate(list(spatial_crops(prot, 48, 40))[:4]):
        (d / f"crop{k}.pdb").write_text(to_pdb(take_residues(prot, sel)))
    return d


def _chis(path):
    f = featurize(from_pdb_file(str(path), mse_to_met=True))
    return f["SC_D"], f["SC_D_mask"]


def _chi_diff(a, b):
    (x, m), (y, _) = _chis(a), _chis(b)
    return float((np.abs(np.angle(np.exp(1j * (x - y)))) * m).max())


@pytest.fixture(scope="module")
def cli_runs(crop_dir, tmp_path_factory):
    """cli.pack best-of-4 on one crop and both directory modes, on two ranks
    (rank 0's results) and on one device with the same global rows."""
    from packppi_torch.cli import pack, prox

    out = tmp_path_factory.mktemp("cli")
    one_pdb = str(sorted(crop_dir.glob("*.pdb"))[0])
    p_common = ["--device", "cpu", "--n_steps", "3", "--precision", "float32"]
    pack_argv = lambda o, n: ["--input", one_pdb, "--outdir", str(out / o), "--n_samples", "4",
                              "--use_proximal", "--n_devices", str(n), *p_common]
    dpack = lambda o, n, b: ["--input", str(crop_dir), "--outdir", str(out / o), "--n_samples",
                             "2", "--use_proximal", "--batch_size", str(b), "--n_devices",
                             str(n), *p_common]
    dprox = lambda o, n, b: ["--input", str(crop_dir), "--outdir", str(out / o), "--device",
                             "cpu", "--num_steps", "3", "--batch_size", str(b), "--n_devices",
                             str(n), "--no_clashscore"]
    ranks = run_ranks(torch_rank_fns.cli_paths, 2, pack_argv("pack2", 2),
                      dpack("dpack2", 2, 1), dprox("dprox2", 2, 1))
    one = {"pack": pack.run(pack.build_parser().parse_args(pack_argv("pack1", 1))),
           "dir_pack": pack.run_directory(pack.build_parser().parse_args(dpack("dpack1", 1, 2))),
           "dir_prox": prox.run_directory(prox.build_parser().parse_args(dprox("dprox1", 1, 2)))}
    return out, ranks[0], one


def test_pack_best_of_n_over_ranks_matches_one_device(cli_runs):
    out, ranks, one = cli_runs
    assert _chi_diff(out / "pack2" / "structure.pdb", out / "pack1" / "structure.pdb") <= 1e-5
    for k in ("proximal_objective_initial", "proximal_objective_final"):
        np.testing.assert_allclose(ranks["pack"][k], one["pack"][k], rtol=1e-5)
    assert ranks["pack"]["proximal_accepted"] == one["pack"]["proximal_accepted"]


@pytest.mark.parametrize("cli", ["pack", "prox"])
def test_directory_mode_over_ranks_matches_one_device(cli, cli_runs):
    out, ranks, one = cli_runs
    keys = (("proximal_objective_initial", "proximal_objective_final") if cli == "pack"
            else ("objective_initial", "objective_final"))
    two = json.loads((out / f"d{cli}2" / "summary.json").read_text())
    ref = json.loads((out / f"d{cli}1" / "summary.json").read_text())
    assert two["n_devices"] == 2 and ref["n_devices"] == 1 and two["n"] == ref["n"] == 4
    assert len(ranks[f"dir_{cli}"]) == len(one[f"dir_{cli}"]) == 4
    for a, b in zip(two["results"], ref["results"]):
        assert Path(a["input"]).name == Path(b["input"]).name
        for k in keys:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
        assert _chi_diff(a["output"], b["output"]) <= 1e-5


def test_directory_mode_entry_point_starts_its_ranks(crop_dir, tmp_path):
    """``cli.prox --input dir --device cpu --n_devices 2`` through its entry
    point: two ranks, rank 0 writes ``summary.json``."""
    from packppi_torch.cli import prox

    args = prox.build_parser().parse_args([
        "--input", str(crop_dir), "--outdir", str(tmp_path), "--device", "cpu",
        "--num_steps", "1", "--n_devices", "2", "--no_clashscore"])
    with one_thread_per_rank():
        results = prox.run_directory(args)
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert len(results) == summary["n"] == 4 and summary["n_devices"] == 2


# ---- the trainers ----------------------------------------------------------------

def test_train_diffusion_on_a_2x2_mesh_resumes_across_device_counts(corpus, tmp_path):  # noqa: F811
    """dp 2 x fsdp 2 for two epochs (test_multichip.py's run, cut to four
    ranks); its checkpoint (whole tensors) resumed on one device for a third
    epoch, and that one's on four ranks again for a fourth. The global batch
    is two rows throughout (one a data shard on the mesh)."""
    from packppi_torch.train.loop import train_diffusion
    from packppi_torch.utils.config import load_config

    config = str(REPO / "configs" / "train_diffusion.yaml")
    base = ["trainer=debug", f"data.data_dir={corpus}", "data.split_fractions=[0.6,0.3,0.1]",
            f"output_dir={tmp_path / 'out'}", "logger=[jsonl]", "model.top_k=16",
            "trainer.ema_decay=0.9", "sample.n_diffusion_steps=2", "seed=0"]
    mesh = ["data.batch_size=1", "trainer.n_devices=4", "trainer.model_parallel=2"]
    one = ["data.batch_size=2", "trainer.n_devices=1"]
    runs = []
    with one_thread_per_rank():
        for devices, epochs in ((mesh, 2), (one, 3), (mesh, 4)):
            cfg = load_config(config, base + devices + [f"trainer.max_epochs={epochs}"])
            runs.append(train_diffusion(cfg, device="cpu"))
    assert [r["epochs_run"] for r in runs] == [2, 3, 4]
    assert all(np.isfinite(r["best_val_loss"]) for r in runs)
    assert np.isfinite(runs[-1]["test_loss"])
    steps = [int(Path(r["last_ckpt"]).stem.split("_")[1]) for r in runs]
    assert steps[0] > 0 and steps == [steps[0], steps[0] * 3 // 2, steps[0] * 2]
    records = [json.loads(ln) for ln in
               (tmp_path / "out" / "logs" / "metrics.jsonl").read_text().splitlines()]
    train_steps = [r["step"] for r in records if "train/loss" in r]
    assert train_steps == list(range(1, len(train_steps) + 1))       # no step run twice
    assert any("val/chi_0_acc" in r for r in records)


@pytest.mark.parametrize("mode", ["network", "esm"])
def test_train_affinity_on_a_2x2_mesh(mode, tmp_path):
    """``trainer.model_parallel=2`` on four ranks (test_multichip.py's runs):
    the network's large tensors and the frozen backbone FSDP-sharded, or the
    ESM head's; mutation rows over data."""
    from test_torch_train_affinity import _data_dir

    from packppi_torch.data.skempi import load_skempi_entries
    from packppi_torch.train.loop import train_affinity
    from packppi_torch.utils.config import load_config

    data = _data_dir(tmp_path / "skempi", rows=(("1BRS", 4), ("2FTL", 4)))
    extra = ["model.hidden_dim=64", "model.node_features=64", "model.edge_features=64",
             "model.top_k=16", "trainer.max_epochs=1"]
    if mode == "esm":
        cache = data / "dataset_cache"
        cache.mkdir()
        rng = np.random.default_rng(0)
        for e in load_skempi_entries(str(data), "PDBs"):
            L = 195 if e["pdb_id"] == "1BRS" else 280
            np.savez_compressed(cache / f"esm_{e['pdb_id']}_{e['id']}.npz",
                                wt=rng.normal(size=(L, 1280)).astype(np.float32),
                                mut=rng.normal(size=(L, 1280)).astype(np.float32))
        extra = ["model.mode=esm", "trainer.max_epochs=2"]
    cfg = load_config(str(REPO / "configs" / "train_affinity.yaml"), [
        f"output_dir={tmp_path / 'out'}", f"data.data_dir={data}", "data.num_cvfolds=2",
        "data.batch_size=1", "trainer.n_devices=4", "trainer.model_parallel=2", "seed=0",
        "logger=[jsonl]", *extra])
    with one_thread_per_rank():
        result = train_affinity(cfg, device="cpu")
    assert np.isfinite(result["best_val_loss"])
    assert result["best_ckpt"] is not None and Path(result["best_ckpt"]).exists()


# ---- the dry run -----------------------------------------------------------------

def test_dryrun_multichip_runs_every_stage_on_four_ranks():
    from packppi_torch.parallel.dryrun import dryrun_multichip

    with one_thread_per_rank():
        report = dryrun_multichip(4, "cpu")
    stages = [line.split("(")[1].split(")")[0] for line in report["lines"]]
    assert stages == ["dp x fsdp", "dp x sp", "sharded inference", "select+refine chunk",
                      "local-geometry inference", "affinity dp x fsdp", "esm2 dp x tp",
                      "esm2 dp x pp"]
    assert len(report["launches"]) == 4
