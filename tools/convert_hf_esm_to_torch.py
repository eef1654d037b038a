#!/usr/bin/env python3
"""Write the ESM-2 file that ``packppi_torch`` reads (``cli.ddg --esm_ckpt``)
from a local HuggingFace copy of an ESM-2 checkpoint.

    python tools/convert_hf_esm_to_torch.py --hf <directory or model name> \\
        --dst esm2_t33_650M_UR50D.pt

Run it where ``transformers`` is installed; it reads local files only
(``local_files_only=True``). The file holds ``{"config": {...}, "state_dict":
{...}}``: the ``ESM2Config`` fields taken from the HuggingFace config (the
number of heads cannot be read from the shapes) and the ``EsmModel`` state
dict under its own names, float32. It is loaded back strictly into the
port's ``ESM2`` before it is kept.
"""
import argparse
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def esm_config_fields(hf_config) -> dict:
    """The ``ESM2Config`` fields of a HuggingFace ``EsmConfig``."""
    return {"vocab_size": hf_config.vocab_size, "hidden_size": hf_config.hidden_size,
            "num_layers": hf_config.num_hidden_layers,
            "num_heads": hf_config.num_attention_heads,
            "intermediate_size": hf_config.intermediate_size,
            "layer_norm_eps": hf_config.layer_norm_eps,
            "token_dropout": bool(hf_config.token_dropout),
            "mask_token_id": hf_config.mask_token_id,
            "pad_token_id": hf_config.pad_token_id}


def convert_model(model, dst: Path) -> dict:
    """Write the file for a loaded HuggingFace ``EsmModel``; returns it."""
    from packppi_torch.models.esm2 import ESM2, ESM2Config
    from packppi_torch.weights import load_esm_state_dict

    blob = {"config": esm_config_fields(model.config),
            "state_dict": {k: (v.float() if v.is_floating_point() else v).detach().cpu()
                           .contiguous() for k, v in model.state_dict().items()}}
    load_esm_state_dict(ESM2(ESM2Config(**blob["config"])), blob["state_dict"])
    dst.parent.mkdir(parents=True, exist_ok=True)
    torch.save(blob, dst)
    return blob


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--hf", required=True, help="local HuggingFace directory or cached name")
    ap.add_argument("--dst", required=True, help="the .pt file to write")
    args = ap.parse_args()
    from transformers import EsmModel

    model = EsmModel.from_pretrained(args.hf, local_files_only=True).eval()
    blob = convert_model(model, Path(args.dst))
    n = sum(v.numel() for v in blob["state_dict"].values())
    print(f"{args.dst}: {len(blob['state_dict'])} tensors, {n} values, config {blob['config']}")


if __name__ == "__main__":
    main()
