"""SO(2) diffusion schedule for torsion angles: tables, lookups, reverse steps."""
from packppi_torch.diffusion.so2 import SO2Schedule, SO2Tables  # noqa: F401
