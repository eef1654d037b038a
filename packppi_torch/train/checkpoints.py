"""Checkpoint I/O: ``torch.save`` of tensors and plain containers only.

A checkpoint is either a params-only state dict (reference-named network
weights; what ``cli.pack --ckpt`` loads) or a full train state (``params``,
``opt_state``, ``step``, ``opt_steps``, ``generator``). Both load with
``weights_only=True``. ``load_model_params`` takes either and returns the
network's state dict.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Mapping, Optional, Union

import torch

from packppi_torch.weights import read_state_dict


def save_params(path: Union[str, Path], params: Mapping) -> None:
    """Write ``params`` (nested dicts/lists of tensors and numbers) to
    ``path``, under a temporary name first so a reader never sees half a
    file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + f".{os.getpid()}.tmp")
    torch.save(params, tmp)
    os.replace(tmp, path)


def load_params(path: Union[str, Path], map_location="cpu"):
    return torch.load(Path(path), map_location=map_location, weights_only=True)


def load_model_params(path: Union[str, Path],
                      template: Optional[Mapping[str, torch.Tensor]] = None) -> dict:
    """Network weights from a params-only file or a full train state (which
    is unwrapped). With a ``template`` state dict, names and shapes must
    match it."""
    raw = read_state_dict(path)
    if template is not None:
        want = {k: tuple(v.shape) for k, v in template.items()}
        got = {k: tuple(v.shape) for k, v in raw.items()}
        if want != got:
            raise ValueError(f"checkpoint at {path} does not match the expected parameters "
                             "(checkpoint for a different model or configuration?)")
    return raw
