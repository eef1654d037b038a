"""SO(2) diffusion schedule."""
from packppi_torch.diffusion.so2 import SO2Schedule  # noqa: F401
