"""Sampling-time machinery: reverse diffusion lives on the model; proximal
clash-removal optimization lives here."""
from packppi_torch.sampling.proximal import (  # noqa: F401
    ProximalResult,
    find_clash_mask,
    proximal_optimize,
)
