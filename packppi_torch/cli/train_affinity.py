"""packppi-torch-train-affinity: PackPPI-AP training (PyTorch/CUDA).

    python -m packppi_torch.cli.train_affinity [--config configs/train_affinity.yaml]
        [--device cuda|cpu] [-m] pre_checkpoint_path=<backbone.pt> [section.key=value ...]

e.g. ``data.data_dir=tests/fixtures/skempi_mini data.num_cvfolds=2
pre_checkpoint_path=docs/ckpts/diffusion_crops/torch_state.pt``. The frozen
backbone is written to ``<run>/backbone.pt`` beside ``checkpoints/``, so
``cli.ddg --pre_ckpt <run>/backbone.pt --ckpt <checkpoint>`` predicts with
the trained model. ``model.mode=esm`` trains the head over ESM-2
embeddings (cached ``esm_<pdb>_<id>.npz`` under the data's cache directory,
or extracted with ``esm_weights=<file.pt>``). Run directories and ``-m``
sweeps as ``cli.train_diffusion``; ``ckpt_path=<checkpoint>`` starts from
an affinity checkpoint. Runs on the CUDA device unless ``--device cpu`` is
given.
"""
from __future__ import annotations

from packppi_torch.cli._runner import run_training


def _loader():
    from packppi_torch.train.loop import train_affinity
    return train_affinity


def main(argv=None):
    return run_training(_loader, "train_affinity.yaml",
                        "Train the ddG affinity model (PyTorch/CUDA)", argv)


if __name__ == "__main__":
    main()
