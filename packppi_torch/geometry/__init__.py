"""Rigid frames, dihedrals and the torsions -> atom14 chain."""
from packppi_torch.geometry.dihedrals import (  # noqa: F401
    dihedral_from_four_points,
    dihedrals_along_chain,
    wrap_angle,
)
from packppi_torch.geometry.frames import (  # noqa: F401
    atom14_coords_from_torsions,
    frames_to_atom14_positions,
    torsion_angles_to_frames,
)
from packppi_torch.geometry.rigid import (  # noqa: F401
    Rigid,
    bb_frames_from_atom14,
    compose,
    from_4x4,
    invert,
    invert_apply,
    rigid_apply,
    rigid_from_3_points,
    scale_translation,
)
