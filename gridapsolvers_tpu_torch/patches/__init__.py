from .topology import (  # noqa: F401
    PatchTopology,
    coarse_cell_patches,
    concat_patches,
    vertex_star_patches,
)
from .smoothers import PatchSolver  # noqa: F401
from .vanka import BlockJacobiSolver, VankaSolver, vanka_patches  # noqa: F401
from .materialized import MaterializedVankaSmoother, materialize_vanka  # noqa: F401
from .transfer import PatchProlongation, PatchRestriction, setup_patch_transfers  # noqa: F401

# Reference-facing aliases (GridapSolvers exports PatchDecomposition /
# PatchBasedLinearSolver, src/GridapSolvers.jl:46-49)
PatchDecomposition = PatchTopology
PatchBasedLinearSolver = PatchSolver
