"""Score network and sampler: encoder, IPMP stack, decoder, ODE sampling."""
from packppi_torch.models.diffusion_net import (  # noqa: F401
    ChiScoreNetwork,
    NetworkConfig,
    StaticGraph,
)
from packppi_torch.models.torsional_diffusion import (  # noqa: F401
    SampleConfig,
    TorsionalDiffusion,
)
