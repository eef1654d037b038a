"""The port's trainer on the CPU: its host-side pieces against the JAX
package's on the same inputs (splits, batch plans, checkpoint retention,
configuration, crop corpus), and a two-epoch ``train_diffusion`` on twelve
crops that resumes and whose checkpoint ``cli.pack`` loads."""
import json
import os
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from packppi_tpu.data.complex import split_entries as jax_split_entries
from packppi_tpu.data.loader import BucketedLoader as JaxBucketedLoader
from packppi_tpu.train import loop as jax_loop
from packppi_tpu.utils.config import load_config as jax_load_config
from packppi_tpu.utils.metrics import chi_metrics as jax_chi_metrics
from packppi_torch.data import crops
from packppi_torch.data.complex import ComplexDataset, scan_complex_dir, split_entries
from packppi_torch.data.loader import BucketedLoader
from packppi_torch.train.loop import CheckpointManager, EarlyStopper, train_diffusion
from packppi_torch.utils.config import Config, expand_multirun, load_config
from packppi_torch.utils.logging import MetricLogger
from packppi_torch.utils.metrics import chi_metrics

from conftest import FIXTURES
from test_torch_so2 import _table_cache  # noqa: F401 (autouse fixture)
from torch_threads import _threads  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parent.parent
CONFIG = str(REPO / "configs" / "train_diffusion.yaml")
KNOB_OVERRIDES = ["model.dropout=0.0", "model.fused_messages=true",
                  "model.fused_messages_train=true", "model.fused_chain_train=true"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Twelve 64-residue crops of 1BRS."""
    out = tmp_path_factory.mktemp("crops")
    crops.build([os.path.join(FIXTURES, "1brs.pdb")], str(out), sizes=(64,), stride=16,
                window_stride=64)
    files = sorted(out.glob("*_rc.pdb"))
    assert len(files) >= 12
    for f in files[12:]:
        f.unlink()
    return out


def test_crop_corpus_equals_the_reference_script(tmp_path):
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        import make_crop_corpus
    finally:
        sys.path.pop(0)
    src = [os.path.join(FIXTURES, "2ftl.pdb")]
    n_ours = crops.build(src, str(tmp_path / "ours"), sizes=(64, 96), stride=40)
    n_ref = make_crop_corpus.build(src, str(tmp_path / "ref"), sizes=(64, 96), stride=40)
    ours = {f.name: f.read_text() for f in (tmp_path / "ours").iterdir()}
    ref = {f.name: f.read_text() for f in (tmp_path / "ref").iterdir()}
    assert n_ours == n_ref == len(ours) and ours == ref


def test_split_entries_matches_jax(tmp_path):
    codes = [f"c{i:03d}" for i in range(37)]
    ours = split_entries(codes, (0.8, 0.1, 0.1), 42, split_file=str(tmp_path / "a.json"))
    ref = jax_split_entries(codes, (0.8, 0.1, 0.1), 42, split_file=str(tmp_path / "b.json"))
    assert ours == ref and json.loads((tmp_path / "a.json").read_text()) == ours
    # a persisted split is reused; vanished codes are pruned, new ones stay out
    again = split_entries(codes[3:] + ["new"], (0.8, 0.1, 0.1), 0, split_file=str(tmp_path / "a.json"))
    assert again == jax_split_entries(codes[3:] + ["new"], (0.8, 0.1, 0.1), 0,
                                      split_file=str(tmp_path / "b.json"))
    assert "new" not in sum(again.values(), []) and "c000" not in sum(again.values(), [])


class _Lengths:
    """A dataset of which only the lengths matter."""

    def __init__(self, lengths):
        self.lengths = lengths

    def __len__(self):
        return len(self.lengths)


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (True, False), (False, False)])
def test_loader_plan_matches_jax(shuffle, drop_last):
    lengths = list(np.random.default_rng(0).integers(20, 400, 57))
    kw = dict(shuffle=shuffle, seed=11, drop_last=drop_last)
    ours = BucketedLoader(_Lengths(lengths), 4, **kw)
    ref = JaxBucketedLoader(_Lengths(lengths), 4, **kw)
    for epoch in range(3):
        ours.epoch = ref.epoch = epoch
        assert ours.plan() == ref.plan() and len(ours) == len(ref)


def _live_prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "packppi-prefetch"]


def test_loader_batches_arrive_as_protein_batches_and_leave_no_thread(corpus):
    from packppi_torch.data import ProteinBatch

    ds = ComplexDataset(str(corpus), scan_complex_dir(str(corpus)),
                        cache_dir=str(corpus / "cache")).filtered()
    assert len(ds) == 12 and (corpus / "cache" / "lengths.json").exists()
    loader = BucketedLoader(ds, 4, "cpu", shuffle=True, seed=0, drop_last=True, prefetch=2)
    first = loader.first_batch()
    assert isinstance(first, ProteinBatch) and first.X.shape == (4, 64, 14, 3)
    assert first.residue_type.dtype == torch.int64 and not _live_prefetch_threads()
    batches = list(loader)
    assert len(batches) == 3 and not _live_prefetch_threads()
    # an abandoned iterator: its worker ends when the iterator is closed
    it = iter(loader)
    next(it)
    assert _live_prefetch_threads()
    it.close()
    assert not _live_prefetch_threads()

    # a failure in the worker surfaces in the consumer
    def broken(feats, target_len):
        raise RuntimeError("stacking failed")

    with pytest.raises(RuntimeError, match="stacking failed"):
        list(BucketedLoader(ds, 4, stack_fn=broken, prefetch=1))
    assert not _live_prefetch_threads()


def test_checkpoint_retention_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_loop, "save_params",
                        lambda path, state: Path(path).mkdir(parents=True, exist_ok=True))
    ours = CheckpointManager(tmp_path / "ours", top_k=2)
    ref = jax_loop.CheckpointManager(tmp_path / "ref", top_k=2)
    ema = {"w": torch.zeros(2)}
    for step, metric in [(10, 0.9), (20, 0.5), (30, None), (40, 0.7), (50, 0.4), (60, 0.8)]:
        ours.save(step, {"params": {"w": torch.ones(2)}, "step": step}, metric, ema=ema)
        ref.save(step, {"step": step}, metric, ema={})
        assert ours.index == ref.index
        assert Path(ours.latest()).stem == Path(ref.latest()).name
        assert Path(ours.best()).stem == Path(ref.best()).name
        on_disk = sorted(p.name for p in (tmp_path / "ours").iterdir())
        assert on_disk == sorted([f"{n}.pt" for n in ours.index]
                                 + [f"{n}_ema.pt" for n in ours.index] + ["index.json"])
    assert sorted(ours.index) == ["step_00000020", "step_00000050", "step_00000060"]
    reopened = CheckpointManager(tmp_path / "ours", top_k=2)
    assert reopened.index == ours.index and reopened.best() == ours.best()


def test_config_loader_matches_jax_on_the_repository_configs():
    overrides = ["trainer=debug", "data.batch_size=16", "trainer.lr=3e-4",
                 "data.len_region=[10, 500]", "tags=[a, b]"] + KNOB_OVERRIDES
    ours, ref = load_config(CONFIG, overrides), jax_load_config(CONFIG, overrides)
    assert ours.to_dict() == ref.to_dict()
    assert ours.trainer.max_epochs == 1 and ours.trainer.lr == 3e-4
    assert ours.model.fused_messages is True and ours.model.hidden_dim == 128
    for cfg_file in sorted((REPO / "configs").glob("*.yaml")):
        assert load_config(str(cfg_file)).to_dict() == jax_load_config(str(cfg_file)).to_dict()
    assert expand_multirun(["trainer.lr=1e-4,3e-4", "seed=0"]) == [
        ["trainer.lr=1e-4", "seed=0"], ["trainer.lr=3e-4", "seed=0"]]


def test_chi_metrics_match_jax():
    rng = np.random.default_rng(0)
    true = rng.uniform(-np.pi, np.pi, (2, 30, 4))
    pred = true + rng.normal(0, 0.4, true.shape)
    mask = (rng.uniform(size=true.shape) > 0.3).astype(np.float32)
    pi_mask = rng.uniform(size=true.shape) > 0.8
    ours = chi_metrics(torch.from_numpy(true), torch.from_numpy(pred), torch.from_numpy(mask),
                       torch.from_numpy(pi_mask))
    ref = jax_chi_metrics(true, pred, mask, pi_mask)
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k] == pytest.approx(ref[k], abs=1e-12), k


def test_metric_logger_without_tensorboard_keeps_the_jsonl_record(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)    # the import fails
    logger = MetricLogger(tmp_path, backends=("tensorboard", "wandb"))
    assert logger.tb is None
    logger.log(3, {"loss": torch.tensor(0.5)}, prefix="train/")
    logger.close()
    assert json.loads((tmp_path / "metrics.jsonl").read_text()) == {"step": 3, "train/loss": 0.5}


def test_early_stopper_counts_validation_checks():
    stop = EarlyStopper(Config.wrap(dict(early_stopping_patience=2, min_epochs=4)))
    ref = jax_loop.EarlyStopper(Config.wrap(dict(early_stopping_patience=2, min_epochs=4)))
    losses = [1.0, 0.9, float("nan"), 0.95, 0.91, 0.92, 0.5]
    assert [stop.should_stop(e, v) for e, v in enumerate(losses)] == \
        [ref.should_stop(e, v) for e, v in enumerate(losses)] == \
        [False, False, False, False, True, True, False]


def _train_cfg(corpus, out, *extra):
    return load_config(CONFIG, [
        "trainer=debug", f"data.data_dir={corpus}", "data.batch_size=2",
        "sample.n_diffusion_steps=2", f"output_dir={out}", "logger=[jsonl]",
        "trainer.ema_decay=0.9", "model.top_k=16", *KNOB_OVERRIDES, *extra])


def test_more_than_one_device_is_refused(corpus, tmp_path):
    """Several ranks train (tests/test_torch_multidevice.py); what is refused
    is a device count the mesh cannot split, before anything is written."""
    with pytest.raises(ValueError, match="not divisible by model_parallel=2"):
        train_diffusion(_train_cfg(corpus, tmp_path, "trainer.n_devices=3",
                                   "trainer.model_parallel=2"), device="cpu")
    assert not (tmp_path / "split.json").exists()


def test_two_epoch_training_resumes_and_its_checkpoint_packs(corpus, tmp_path):
    out = tmp_path / "run"
    first = train_diffusion(_train_cfg(corpus, out, "trainer.max_epochs=1"), device="cpu")
    assert first["epochs_run"] == 1 and np.isfinite(first["best_val_loss"])
    assert not torch.is_anomaly_enabled() and not _live_prefetch_threads()
    split = json.loads((out / "split.json").read_text())
    assert sorted(map(len, split.values())) == [1, 2, 9]
    index = json.loads((out / "checkpoints" / "index.json").read_text())
    (name, entry), = index.items()
    assert entry["step"] == 4 and np.isfinite(entry["metric"])          # 9 crops, batches of 2
    assert (out / "checkpoints" / f"{name}_ema.pt").exists()

    # the second invocation finds the checkpoint, takes up at epoch 1 and runs one more
    second = train_diffusion(_train_cfg(corpus, out, "trainer.max_epochs=2"), device="cpu")
    assert second["epochs_run"] == 2 and second["last_ckpt"].endswith("step_00000008.pt")
    records = [json.loads(l) for l in (out / "logs" / "metrics.jsonl").read_text().splitlines()]
    steps = [r["step"] for r in records if "train/loss" in r]
    assert steps == list(range(1, 9))                                     # no step run twice
    assert all(np.isfinite(r[k]) for r in records for k in r)
    assert sum("val/loss" in r for r in records) == 2
    assert any("val/chi_0_acc" in r for r in records) and any("test/loss" in r for r in records)
    assert np.isfinite(second["test_loss"])

    from packppi_torch.cli import pack

    for ckpt in (second["last_ckpt"], second["last_ckpt"].replace(".pt", "_ema.pt")):
        args = pack.build_parser().parse_args([
            "--input", str(sorted(corpus.glob("*_rc.pdb"))[0]), "--outdir", str(tmp_path / "packed"),
            "--ckpt", ckpt, "--device", "cpu", "--n_steps", "2", "--precision", "float32"])
        metrics = pack.run(args)
        assert metrics["sampling_seconds"] > 0 and (tmp_path / "packed" / "structure.pdb").exists()
