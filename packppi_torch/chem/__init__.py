"""Chemical constants: residue types, atom14 names, rigid groups, chi tables."""
from packppi_torch.chem.tables import (  # noqa: F401
    ATOM14_NAMES,
    ATOM37_ORDER,
    ATOM37_TYPES,
    CHEM,
    NUM_ATOM14,
    NUM_ATOM37,
    NUM_RESTYPES,
    RESTYPE_1TO3,
    RESTYPE_3TO1,
    RESTYPE_ORDER,
    RESTYPES,
    ChemTables,
    make_atom14_dists_bounds,
    sc_atom14_mask,
)
