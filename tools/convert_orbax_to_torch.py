#!/usr/bin/env python3
"""Convert an orbax diffusion checkpoint of packppi_tpu into a torch state
dict that packppi_torch loads (``cli.pack --ckpt``, ``weights.load_weights``).

    python tools/convert_orbax_to_torch.py \\
        [--src docs/ckpts/diffusion_crops/params] \\
        [--dst docs/ckpts/diffusion_crops/torch_state.pt]

The source may be a params-only checkpoint or a full train state (its
``params`` are taken). Names follow the reference checkpoints
(``encoder.*``, ``mpnn.mpnn_layers.N.*``, ``decoder_score.{0,2}.*``) through
``packppi_torch.weights.from_flax_params``; every tensor is float32. The
result is loaded back strictly into the port's network before it is kept.
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


def convert(src: Path, dst: Path) -> dict:
    from packppi_torch.models import ChiScoreNetwork, NetworkConfig
    from packppi_torch.weights import from_flax_params, load_weights

    state = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
             for k, v in from_flax_params(restore_numpy_tree(src.absolute())).items()}
    load_weights(ChiScoreNetwork(NetworkConfig()), state)          # strict: names and shapes
    dst.parent.mkdir(parents=True, exist_ok=True)
    torch.save(state, dst)
    return state


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(REPO / "docs/ckpts/diffusion_crops/params"))
    ap.add_argument("--dst", default=str(REPO / "docs/ckpts/diffusion_crops/torch_state.pt"))
    args = ap.parse_args()
    state = convert(Path(args.src), Path(args.dst))
    n = sum(v.numel() for v in state.values())
    print(f"{args.dst}: {len(state)} tensors, {n} parameters, "
          f"{Path(args.dst).stat().st_size / 2 ** 20:.2f} MiB")


if __name__ == "__main__":
    main()
