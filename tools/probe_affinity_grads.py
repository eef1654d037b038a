"""Where the affinity loss's gradients differ between routes and devices.

One PackPPI-AP loss at batch 2 (the first two ``skempi_mini`` mutations,
1BRS, float32, dropout 0), the backbone from
``docs/ckpts/diffusion_crops/torch_state.pt`` and the affinity network's
weights from seed 7, under the configuration that trains through the
kernels (``dropout=0.0, fused_messages=True, fused_messages_train=True,
fused_chain_train=True``) and under the unfused route, on the card and on
the CPU (where the kernels' plain versions run). For each pair it prints
the three parameters whose gradients differ most relative to their own
maximum, and the largest difference relative to the largest gradient
maximum: the readings ``chip_smoke.py``'s affinity gradient check is held
to.

    python tools/probe_affinity_grads.py        # needs a CUDA device
"""
from __future__ import annotations

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

KNOBS = dict(dropout=0.0, fused_messages=True, fused_messages_train=True,
             fused_chain_train=True)
UNFUSED = dict(dropout=0.0, fused_messages=False, fused_chain=False)


def grads(cfg, device, batch):
    from packppi_torch.models import NetworkConfig
    from packppi_torch.models.affinity import AffinityModel
    from packppi_torch.weights import init_weights, load_weights

    model = AffinityModel(NetworkConfig(**cfg))
    load_weights(model.backbone.net, REPO / "docs/ckpts/diffusion_crops/torch_state.pt")
    init_weights(model.net, 7)
    model.to(device)
    loss = model.loss(type(batch)(*(t.to(device) for t in batch)), deterministic=False)
    loss.backward()
    return loss.item(), {k: p.grad.detach().cpu() for k, p in model.net.named_parameters()
                         if p.grad is not None}


def worst(a, b):
    largest = max(w.abs().max().item() for w in b.values())
    rel = sorted(((a[k] - w).abs().max().item() / max(w.abs().max().item(), 1e-3), k)
                 for k, w in b.items())[-3:]
    glob = max((a[k] - w).abs().max().item() for k, w in b.items()) / largest
    return f"per parameter {[(f'{r:.3e}', k) for r, k in rel]}, of the largest {glob:.3e}"


def main():
    from packppi_torch.data.skempi import (load_skempi_entries, skempi_features,
                                           stack_affinity_batch)
    from packppi_torch.structure import from_pdb_file

    entries = load_skempi_entries(REPO / "tests/fixtures/skempi_mini", "PDBs")[:2]
    batch = stack_affinity_batch([skempi_features(from_pdb_file(e["pdb_path"], mse_to_met=True),
                                                  e["mutations"], ddg=e["ddG"])
                                  for e in entries], "cpu")
    runs = {(r, d): grads(cfg, d, batch) for r, cfg in (("kernels", KNOBS), ("unfused", UNFUSED))
            for d in ("cuda", "cpu")}
    print("losses", {f"{r} {d}": v[0] for (r, d), v in runs.items()})
    for a, b in ((("unfused", "cuda"), ("unfused", "cpu")), (("kernels", "cpu"), ("unfused", "cpu")),
                 (("kernels", "cuda"), ("unfused", "cuda")), (("kernels", "cuda"), ("kernels", "cpu"))):
        print(f"{' '.join(a)} vs {' '.join(b)}: {worst(runs[a][1], runs[b][1])}")


if __name__ == "__main__":
    main()
