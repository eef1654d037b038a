#!/usr/bin/env python3
"""Convert orbax checkpoints of packppi_tpu into torch state dicts that
packppi_torch loads (``weights.load_weights``).

    python tools/convert_orbax_to_torch.py diffusion \\
        [--src docs/ckpts/diffusion_crops/params] \\
        [--dst docs/ckpts/diffusion_crops/torch_state.pt]
    python tools/convert_orbax_to_torch.py affinity \\
        [--src docs/ckpts/affinity_skempi_mini_pretrained]

``diffusion`` converts a diffusion network (``cli.pack --ckpt``); names follow
the reference checkpoints (``encoder.*``, ``mpnn.mpnn_layers.N.*``,
``decoder_score.{0,2}.*``) through ``packppi_torch.weights.from_flax_params``.
``affinity`` converts the ``backbone`` and ``affinity`` checkpoints of a
PackPPI-AP directory into ``torch_backbone.pt`` and ``torch_affinity.pt``
beside them (``cli.ddg --pre_ckpt`` and ``--ckpt``, network mode; the
affinity names through ``affinity_from_flax_params``). A
source may be a params-only checkpoint or a full train state (its ``params``
are taken); every tensor is float32. Each result is loaded back strictly
into the port's network before it is kept.
"""
import argparse
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def restore_numpy_tree(path: Path):
    """Every leaf as a host numpy array, whatever devices wrote the file."""
    import jax
    import orbax.checkpoint as ocp

    ckptr = ocp.PyTreeCheckpointer()
    tree = ckptr.metadata(path).item_metadata.tree
    restore_args = jax.tree.map(lambda _: ocp.RestoreArgs(restore_type=np.ndarray), tree)
    raw = ckptr.restore(path, restore_args=restore_args)
    if isinstance(raw, dict) and "params" in raw and "step" in raw:
        raw = raw["params"]
    return raw


def _save(state, module, dst: Path) -> dict:
    from packppi_torch.weights import load_weights

    state = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in state.items()}
    load_weights(module, state)          # strict: names and shapes
    dst.parent.mkdir(parents=True, exist_ok=True)
    torch.save(state, dst)
    n = sum(v.numel() for v in state.values())
    print(f"{dst}: {len(state)} tensors, {n} parameters, {dst.stat().st_size / 2 ** 20:.2f} MiB")
    return state


def convert(src: Path, dst: Path) -> dict:
    """A diffusion network's parameters -> ``dst``."""
    from packppi_torch.models import ChiScoreNetwork, NetworkConfig
    from packppi_torch.weights import from_flax_params

    return _save(from_flax_params(restore_numpy_tree(src.absolute())),
                 ChiScoreNetwork(NetworkConfig()), dst)


def convert_affinity(src: Path) -> tuple[dict, dict]:
    """``src/backbone`` and ``src/affinity`` (a network-mode affinity net) ->
    ``src/torch_backbone.pt`` and ``src/torch_affinity.pt``."""
    from packppi_torch.models import NetworkConfig
    from packppi_torch.models.affinity import AffinityNet
    from packppi_torch.weights import affinity_from_flax_params

    backbone = convert(src / "backbone", src / "torch_backbone.pt")
    tree = affinity_from_flax_params(restore_numpy_tree((src / "affinity").absolute()))
    return backbone, _save(tree, AffinityNet(NetworkConfig(), "network"),
                           src / "torch_affinity.pt")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="what", required=True)
    d = sub.add_parser("diffusion", help="a diffusion network")
    d.add_argument("--src", default=str(REPO / "docs/ckpts/diffusion_crops/params"))
    d.add_argument("--dst", default=str(REPO / "docs/ckpts/diffusion_crops/torch_state.pt"))
    a = sub.add_parser("affinity", help="a PackPPI-AP directory (backbone + affinity)")
    a.add_argument("--src", default=str(REPO / "docs/ckpts/affinity_skempi_mini_pretrained"))
    args = ap.parse_args()
    if args.what == "diffusion":
        convert(Path(args.src), Path(args.dst))
    else:
        convert_affinity(Path(args.src))


if __name__ == "__main__":
    main()
