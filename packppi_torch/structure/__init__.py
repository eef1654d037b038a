"""Structure I/O and featurization (host-side numpy)."""
from packppi_torch.structure.featurize import featurize  # noqa: F401
from packppi_torch.structure.protein import (  # noqa: F401
    Protein,
    from_pdb_file,
    from_pdb_string,
    to_pdb,
)
