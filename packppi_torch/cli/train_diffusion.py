"""packppi-torch-train-diffusion: PackPPI-MSC training (PyTorch/CUDA).

    python -m packppi_torch.cli.train_diffusion [--config configs/train_diffusion.yaml]
        [--device cuda|cpu] [-m] [section.key=value ...]

e.g. ``trainer=debug data.data_dir=data/crops data.batch_size=16``, or a
sweep: ``-m trainer.lr=1e-4,3e-4 seed=0,1``. The configuration that trains
through the kernels (the differentiable feature-message and chain passes):

    model.dropout=0.0 model.fused_messages=true \\
    model.fused_messages_train=true model.fused_chain_train=true

Each run writes into a fresh ``<output_dir>/runs/<timestamp>`` directory
(``multiruns/<timestamp>/<job>`` under ``-m``); ``ckpt_path=<checkpoint>``
resumes a run from a checkpoint of an earlier one. ``optimized_metric`` in
the config selects which returned metric a sweep minimises. Runs on the CUDA device unless
``--device cpu`` is given.
"""
from __future__ import annotations

from packppi_torch.cli._runner import run_training


def _loader():
    from packppi_torch.train.loop import train_diffusion
    return train_diffusion


def main(argv=None):
    return run_training(_loader, "train_diffusion.yaml",
                        "Train the torsional diffusion model (PyTorch/CUDA)", argv)


if __name__ == "__main__":
    main()
