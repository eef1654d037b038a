"""The port's PackPPI-AP trainer (``train.loop.train_affinity``) on the CPU
against the JAX package's, and its contract around the runs.

Both trainers run on ``skempi_mini`` cut to three 1BRS and four 2FTL
mutations (``num_cvfolds=2``: 1BRS trains, 2FTL validates in two batches),
at narrow widths, ``dropout=0.0``, two epochs of one step each. They start from the
same backbone and the same affinity parameters, initialised once by the JAX
package and carried across with ``weights.py``. Limits: every record of
``metrics.jsonl`` within 1e-5 relative (float32); the final parameters
within the Adam bound below.

The Adam bound. An early AdamW step moves each parameter by about
``lr * sign(g)`` whatever the size of ``g``. Where the two packages'
gradients of an entry are both near 0 (float32 rounding decides the sign),
the entry can move in opposite directions, so after ``n`` steps it may
differ by up to ``2 * lr * n``; everywhere else the parameters agree to
float32 rounding. The test holds every entry to ``2 * lr * n`` and all but
one in a thousand to 1e-6.
"""
import json
import logging
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from packppi_torch.utils.config import load_config

from conftest import FIXTURES
from test_torch_so2 import _table_cache  # noqa: F401 (autouse fixture)
from torch_threads import _threads  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parent.parent
CONFIG = str(REPO / "configs" / "train_affinity.yaml")
SKEMPI_MINI = Path(FIXTURES) / "skempi_mini"
NARROW = ["model.hidden_dim=32", "model.node_features=32", "model.edge_features=32",
          "model.num_mpnn_layers=1", "model.top_k=8", "model.dropout=0.0",
          "model.mxu_gather_grad=false"]
LR, EPOCHS = 1e-4, 2
ESM_WIDTH = 16


def _data_dir(path: Path, rows=(("1BRS", 3), ("2FTL", 4))) -> Path:
    """``skempi_mini`` with the first rows of each complex: ``rows`` gives
    how many."""
    path.mkdir(parents=True)
    (path / "PDBs").mkdir()
    for pdb in ("1BRS", "2FTL"):
        shutil.copy(SKEMPI_MINI / "PDBs" / f"{pdb}.pdb", path / "PDBs" / f"{pdb}.pdb")
    lines = (SKEMPI_MINI / "skempi_v2.csv").read_text().splitlines()
    keep = []
    for pdb, n in rows:
        keep += [ln for ln in lines[1:] if ln.startswith(pdb)][:n]
    (path / "skempi_v2.csv").write_text("\n".join([lines[0], *keep]) + "\n")
    return path


def _overrides(data_dir, out, *extra):
    return [f"data.data_dir={data_dir}", "data.num_cvfolds=2", "trainer.n_devices=1",
            f"trainer.max_epochs={EPOCHS}", f"trainer.lr={LR}", f"output_dir={out}",
            "logger=[jsonl]", *extra]


def _records(out):
    return [json.loads(ln)
            for ln in (Path(out) / "logs" / "metrics.jsonl").read_text().splitlines()]


def _jax_init(mode, data_dir, cfg_overrides, tmp):
    """Initial parameters from the JAX package: orbax directories for its
    trainer, the same converted to the port's ``.pt`` files."""
    import jax
    import jax.numpy as jnp

    from packppi_tpu.data.skempi import load_skempi_entries, skempi_features, stack_affinity_batch
    from packppi_tpu.models import NetworkConfig as JaxNetworkConfig
    from packppi_tpu.models.affinity import AffinityModel as JaxAffinityModel
    from packppi_tpu.structure import from_pdb_file
    from packppi_tpu.train.checkpoints import save_params
    from packppi_tpu.utils.config import load_config as jax_load_config
    from packppi_torch.weights import affinity_from_flax_params, from_flax_params

    cfg = jax_load_config(CONFIG, cfg_overrides)
    paths = {}
    if mode == "esm":
        from packppi_tpu.models.affinity import AffinityNet as JaxAffinityNet

        x = jnp.zeros((1, 10, ESM_WIDTH))
        params = JaxAffinityNet(JaxNetworkConfig(), "esm").init(jax.random.key(5), None, None,
                                                               x, x, None)
    else:
        net_cfg = JaxNetworkConfig(**{k: cfg.model[k] for k in JaxNetworkConfig.__dataclass_fields__
                                      if k in cfg.model})
        model = JaxAffinityModel.create(net_cfg, mode="network")
        e = load_skempi_entries(str(data_dir), "PDBs")[0]
        batch = stack_affinity_batch([skempi_features(from_pdb_file(e["pdb_path"], mse_to_met=True),
                                                      e["mutations"], ddg=e["ddG"])])
        # compiled: flax's eager initialisation takes longer than compiling it
        backbone = jax.jit(model.backbone.init)(jax.random.key(3), batch.wild())
        params = jax.jit(model.init)(jax.random.key(4), batch, backbone)
        save_params(tmp / "jax_backbone", backbone)
        torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in from_flax_params(
            jax.tree.map(np.asarray, backbone)).items()}, tmp / "backbone.pt")
        paths["backbone"] = (str(tmp / "jax_backbone"), str(tmp / "backbone.pt"))
    save_params(tmp / "jax_init", params)
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in affinity_from_flax_params(
        jax.tree.map(np.asarray, params)).items()}, tmp / "init.pt")
    paths["init"] = (str(tmp / "jax_init"), str(tmp / "init.pt"))
    return paths


def _both(tmp, mode, extra=(), **rows):
    """Both trainers on their own copy of the data from the same start:
    ``(port result, port output, JAX result, JAX output)``."""
    from packppi_tpu.train.loop import train_affinity as jax_train_affinity
    from packppi_tpu.utils.config import load_config as jax_load_config
    from packppi_torch.train.loop import train_affinity

    dirs = {side: _data_dir(tmp / f"data_{side}", **rows) for side in ("port", "jax")}
    extra = list(extra) + ([f"model.mode={mode}"] if mode == "esm" else NARROW)
    paths = _jax_init(mode, dirs["jax"], _overrides(dirs["jax"], tmp, *extra), tmp)
    if mode == "esm":
        # synthetic cached embeddings of each mutation, the same in both copies
        from packppi_torch.data.skempi import load_skempi_entries
        from packppi_torch.structure import from_pdb_file

        rng = np.random.default_rng(0)
        for e in load_skempi_entries(str(dirs["port"]), "PDBs"):
            L = len(from_pdb_file(e["pdb_path"], mse_to_met=True).aaindex)
            arrays = {k: rng.normal(size=(L, ESM_WIDTH)).astype(np.float32) for k in ("wt", "mut")}
            for d in dirs.values():
                (d / "dataset_cache").mkdir(exist_ok=True)
                np.savez(d / "dataset_cache" / f"esm_{e['pdb_id']}_{e['id']}.npz", **arrays)
    runs = {}
    for side in ("port", "jax"):
        i = 0 if side == "jax" else 1
        ov = _overrides(dirs[side], tmp / f"out_{side}", *extra,
                        f"ckpt_path={paths['init'][i]}")
        if "backbone" in paths:
            ov.append(f"pre_checkpoint_path={paths['backbone'][i]}")
        if side == "port":
            runs[side] = train_affinity(load_config(CONFIG, ov), device="cpu")
        else:
            runs[side] = jax_train_affinity(jax_load_config(CONFIG, ov))
    return runs["port"], tmp / "out_port", runs["jax"], tmp / "out_jax"


def _jax_final(result, mode):
    from packppi_tpu.train.checkpoints import load_params
    from packppi_torch.weights import affinity_from_flax_params

    last = max(Path(result["best_ckpt"]).parent.glob("step_*[0-9]"))
    return affinity_from_flax_params(load_params(str(last)))


def _check_records_and_params(port, port_out, jax_result, jax_out, mode):
    ours, theirs = _records(port_out), _records(jax_out)
    assert len(ours) == len(theirs) == EPOCHS
    for o, t in zip(ours, theirs):
        assert set(o) == set(t)
        assert o["step"] == t["step"]
        for k in t:
            np.testing.assert_allclose(o[k], t[k], rtol=1e-5, err_msg=k)
    want = _jax_final(jax_result, mode)
    got = torch.load(port["last_ckpt"], weights_only=True)
    assert set(got) == set(want)
    d = np.concatenate([np.abs(got[k].numpy() - want[k]).ravel() for k in want])
    steps = ours[-1]["step"]
    assert d.max() <= 2 * LR * steps + 1e-6
    assert np.mean(d > 1e-6) <= 1e-3, f"{np.mean(d > 1e-6):.4f} of entries beyond 1e-6"


def test_network_mode_matches_jax(tmp_path):
    port, port_out, jax_result, jax_out = _both(tmp_path, "network")
    _check_records_and_params(port, port_out, jax_result, jax_out, "network")
    assert {"val/pearson", "val/spearman", "val/rmse"} <= set(_records(port_out)[0])
    # the port read and wrote the JAX package's cache files: the same arrays
    for f in sorted((tmp_path / "data_jax" / "dataset_cache").glob("*.npz")):
        with np.load(f) as a, np.load(tmp_path / "data_port" / "dataset_cache" / f.name) as b:
            assert a.files == b.files
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{f.name}:{k}")


def test_esm_mode_matches_jax(tmp_path):
    port, port_out, jax_result, jax_out = _both(tmp_path, "esm")
    _check_records_and_params(port, port_out, jax_result, jax_out, "esm")


def test_esm_mode_extracts_uncached_embeddings(tmp_path):
    """esm mode with no cached embeddings and a tiny ESM-2 file: each
    mutation's cached pair equals the one-sequence extractor's rows over
    the featurized wild type and the mutant (``make_extractor``, read at
    ``residue_tokens``' rows, zeroed where the backbone is incomplete)."""
    from packppi_torch.data.esm import load_esm_model, residue_tokens
    from packppi_torch.data.skempi import apply_mutations, load_skempi_entries
    from packppi_torch.models.esm2 import ESM2, ESM2Config, init_esm_weights, make_extractor
    from packppi_torch.structure import featurize, from_pdb_file
    from packppi_torch.train.loop import train_affinity

    tiny = dict(hidden_size=ESM_WIDTH, num_layers=2, num_heads=2, intermediate_size=32)
    model = ESM2(ESM2Config(**tiny, attention_impl="dense"))
    init_esm_weights(model, 3)
    esm_file = tmp_path / "esm_tiny.pt"
    torch.save({"config": tiny, "state_dict": model.state_dict()}, esm_file)
    data = _data_dir(tmp_path / "data", rows=(("1BRS", 1), ("2FTL", 1)))
    train_affinity(load_config(CONFIG, _overrides(
        data, tmp_path / "out", "model.mode=esm", f"esm_weights={esm_file}",
        "trainer.max_epochs=1", "data.batch_size=1")), device="cpu")

    extract = make_extractor(load_esm_model(esm_file, "cpu"))
    entries = load_skempi_entries(str(data), "PDBs")
    assert len(entries) == 2
    for e in entries:
        prot = from_pdb_file(e["pdb_path"], mse_to_met=True)
        feats = featurize(prot)
        rt_mut, _ = apply_mutations(prot, e["mutations"])
        with np.load(data / "dataset_cache" / f"esm_{e['pdb_id']}_{e['id']}.npz") as z:
            for key, rt in (("wt", feats["residue_type"]), ("mut", rt_mut)):
                ids, rows = residue_tokens(rt, feats["chain_indices"])
                want = extract([ids])[0][rows] * feats["residue_mask"][:, None]
                np.testing.assert_allclose(z[key], want, atol=1e-5 * np.abs(want).max(),
                                           rtol=0, err_msg=f"{e['id']} {key}")


def test_empty_validation_fold_matches_jax(tmp_path):
    """A fold with no complex leaves validation empty: ``skempi_mini`` at
    ``num_cvfolds=3, cvfold_index=2`` in both packages, and in the runs
    (one complex, at ``num_cvfolds=2, cvfold_index=1``, so that one shape
    is compiled) both packages train on the rest, record val/loss NaN and
    save the checkpoints without a metric."""
    from packppi_tpu.data.skempi import cv_split as jax_cv_split
    from packppi_tpu.data.skempi import load_skempi_entries as jax_entries
    from packppi_torch.data.skempi import cv_split, load_skempi_entries

    split = cv_split(load_skempi_entries(str(SKEMPI_MINI), "PDBs"), 3, 2, 42)
    assert split == jax_cv_split(jax_entries(str(SKEMPI_MINI), "PDBs"), 3, 2, 42)
    assert len(split["train"]) == 126 and split["valid"] == []
    port, port_out, jax_result, jax_out = _both(
        tmp_path, "network", ["data.cvfold_index=1"], rows=(("1BRS", 4),))
    indices = []
    for out, result in ((port_out, port), (jax_out, jax_result)):
        recs = _records(out)
        assert [set(r) for r in recs] == [{"step", "train/loss", "val/loss"}] * EPOCHS
        assert all(np.isnan(r["val/loss"]) and np.isfinite(r["train/loss"]) for r in recs)
        indices.append(json.loads((Path(result["best_ckpt"]).parent / "index.json").read_text()))
        assert result["best_val_loss"] == float("inf")
    # unscored checkpoints are pruned down to the last one
    assert indices[0] == indices[1] == {"step_00000004": {"step": 4, "metric": None}}
    for o, t in zip(_records(port_out), _records(jax_out)):
        np.testing.assert_allclose(o["train/loss"], t["train/loss"], rtol=1e-5)


@pytest.fixture(scope="module")
def full_width_run(tmp_path_factory):
    """One epoch of the port at the published widths of
    ``configs/model/affinity.yaml`` (EMA on), and its output directory."""
    from packppi_torch.train.loop import train_affinity

    tmp = tmp_path_factory.mktemp("full")
    data = _data_dir(tmp / "data")
    out = tmp / "out"
    cfg = load_config(CONFIG, _overrides(data, out, "trainer.max_epochs=1",
                                         "trainer.ema_decay=0.5", "model.dropout=0.0"))
    return train_affinity(cfg, device="cpu"), data, out


def test_backbone_artifact_reproduces_validation_through_cli_ddg(full_width_run, tmp_path):
    """``cli.ddg --pre_ckpt <out>/backbone.pt --ckpt <best>_ema.pt`` gives
    the run's validation RMSE on the 2FTL mutations (the EMA weights are
    what validation evaluated)."""
    from packppi_torch.cli.ddg import run_cli
    from packppi_torch.train.loop import ema_path

    result, data, out = full_width_run
    backbone = out / "backbone.pt"
    assert Path(result["backbone"]) == backbone and backbone.exists()
    run_cli(["--eval_csv", str(data), "--ckpt", str(ema_path(result["best_ckpt"])),
             "--pre_ckpt", str(backbone), "--device", "cpu", "--outdir", str(tmp_path)])
    rows = [json.loads(ln) for ln in (tmp_path / "ddg_eval.jsonl").read_text().splitlines()]
    val = [r for r in rows if r["complex"].startswith("2FTL")]
    rmse = float(np.sqrt(np.mean([(r["ddg_pred"] - r["ddg_exp"]) ** 2 for r in val])))
    (rec,) = _records(out)
    np.testing.assert_allclose(rmse, rec["val/rmse"], rtol=1e-5)


def test_ema_sidecars_and_params_level_resume(full_width_run, tmp_path):
    """Each checkpoint has an ``_ema`` sidecar that differs from it; a run
    with ``ckpt_path`` starts from those parameters (at lr 0 it ends on
    them exactly), and its EMA starts from the sidecar."""
    from packppi_torch.train.loop import ema_path, train_affinity

    result, data, out = full_width_run
    last = Path(result["last_ckpt"])
    params, ema = (torch.load(p, weights_only=True) for p in (last, ema_path(last)))
    assert set(params) == set(ema) and any(not torch.equal(params[k], ema[k]) for k in params)
    cfg = load_config(CONFIG, _overrides(data, tmp_path / "again", "trainer.max_epochs=1",
                                         "trainer.lr=0.0", "trainer.ema_decay=1.0",
                                         "model.dropout=0.0", f"ckpt_path={last}"))
    again = train_affinity(cfg, device="cpu")
    resumed = torch.load(again["last_ckpt"], weights_only=True)
    resumed_ema = torch.load(ema_path(again["last_ckpt"]), weights_only=True)
    for k in params:
        assert torch.equal(resumed[k], params[k]), k
        assert torch.equal(resumed_ema[k], ema[k]), k
    # a fresh run directory: no automatic resume from its own checkpoints
    assert json.loads((Path(again["last_ckpt"]).parent / "index.json").read_text()).keys() == {
        Path(again["last_ckpt"]).stem}


def test_dropout_draws_in_training_and_not_in_validation(full_width_run):
    """At dropout 0.1 a training loss draws dropout in the mutation stack
    while the frozen backbone stays in eval(); the validation forward is
    repeatable."""
    from packppi_torch.data.skempi import (load_skempi_entries, skempi_features,
                                           stack_affinity_batch)
    from packppi_torch.models import NetworkConfig
    from packppi_torch.models.affinity import AffinityModel
    from packppi_torch.structure import from_pdb_file
    from packppi_torch.weights import load_weights

    result, data, out = full_width_run
    model = AffinityModel(NetworkConfig(dropout=0.1))
    load_weights(model.backbone.net, out / "backbone.pt")
    load_weights(model.net, result["last_ckpt"])
    entries = load_skempi_entries(str(data), "PDBs")[:2]
    batch = stack_affinity_batch([skempi_features(from_pdb_file(e["pdb_path"], mse_to_met=True),
                                                  e["mutations"], ddg=e["ddG"]) for e in entries],
                                 "cpu")
    modes = []
    hook = lambda m, i, o: modes.append((m.training, model.net.mutation_mpnn.training))
    model.backbone.net.mpnn.register_forward_hook(hook)
    torch.manual_seed(0)
    with torch.no_grad():
        a, b = (model.loss(batch, deterministic=False) for _ in range(2))
        c, d = (model.loss(batch, deterministic=True) for _ in range(2))
    assert a.item() != b.item() and c.item() == d.item()
    assert modes[:2] == [(False, True)] * 2 and modes[-1] == (False, False)


def test_dropped_model_keys_are_named():
    """``network_config`` builds the same ``NetworkConfig`` as the fields it
    keeps and names the keys it drops: ``configs/model/affinity.yaml``
    drops none (``k_neighbors`` is a field; ``mode`` and ``strict_parity``
    are the trainer's), and an unknown key given on the command line is
    named."""
    import dataclasses

    from packppi_torch.models import NetworkConfig
    from packppi_torch.utils.config import network_config

    def build(overrides):
        model = load_config(CONFIG, overrides).model
        records = []
        handler = logging.Handler()
        handler.emit = records.append
        logger = logging.getLogger("packppi_torch.utils.config")
        logger.addHandler(handler)
        try:
            cfg = network_config(model)
        finally:
            logger.removeHandler(handler)
        fields = {f.name for f in dataclasses.fields(NetworkConfig)}
        assert cfg == NetworkConfig(**{k: model[k] for k in fields if k in model})
        return cfg, [r.getMessage() for r in records]

    cfg, messages = build([])
    assert messages == [] and cfg.k_neighbors == load_config(CONFIG, []).model.k_neighbors
    _, messages = build(["model.foo=1"])
    assert messages == ["model config keys not used by the port's network: foo"]


def test_card_shapes_are_refused_before_any_data_is_read(tmp_path, monkeypatch):
    """A width the kernels are not built for is refused for a CUDA device
    (before the trainer reads its data), naming it, and accepted on the CPU;
    so is a device count the mesh cannot split (several devices train:
    tests/test_torch_multidevice.py). The kernels take hidden_dim and
    edge_features every multiple of 32 from 32 to 256, n_points 1 to 16 and
    any top_k."""
    from packppi_torch.models import NetworkConfig
    from packppi_torch.train import loop

    NetworkConfig(hidden_dim=64, node_features=64, edge_features=64).check_device("cuda")
    NetworkConfig(top_k=96).check_device("cuda")
    NetworkConfig(hidden_dim=256, node_features=256, edge_features=32, n_points=16,
                  top_k=128).check_device("cuda")
    cfg = NetworkConfig(hidden_dim=320, node_features=320, edge_features=320)
    with pytest.raises(ValueError, match="hidden_dim=320"):
        cfg.check_device("cuda")
    cfg.check_device("cpu")
    NetworkConfig(hidden_dim=320, node_features=320, edge_features=320, fused_messages=False,
                  fused_chain=False).check_device("cuda")
    NetworkConfig().check_device("cuda")
    for bad, field in ((dict(edge_features=48), "edge_features=48"),
                       (dict(n_points=17), "n_points=17"),
                       (dict(hidden_dim=16, node_features=16), "hidden_dim=16")):
        with pytest.raises(ValueError, match=field):
            NetworkConfig(**bad).check_device("cuda")

    import packppi_torch.data.skempi as skempi
    import packppi_torch.device as device_mod

    read = []
    monkeypatch.setattr(skempi, "load_skempi_entries", lambda *a, **k: read.append(a))
    with pytest.raises(ValueError, match="not divisible by model_parallel=2"):
        loop.train_affinity(load_config(CONFIG, _overrides(
            tmp_path, tmp_path / "out", "trainer.n_devices=3", "trainer.model_parallel=2")),
            device="cpu")
    assert read == []
    monkeypatch.setattr(device_mod, "resolve_device", lambda d: torch.device("cuda"))
    ov = _overrides(tmp_path, tmp_path / "out", "model.hidden_dim=320",
                    "model.node_features=320", "model.edge_features=320")
    with pytest.raises(ValueError, match="hidden_dim=320"):
        loop.train_affinity(load_config(CONFIG, ov), device="cuda")
    assert read == []
