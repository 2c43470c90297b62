from .hierarchy import (  # noqa: F401
    GridHierarchy,
    cartesian_hierarchy,
    compute_hierarchy_matrices,
    hierarchy_from_coarse,
    octree_cartesian_hierarchy,
)
from .adaptive import (  # noqa: F401
    AdaptiveHierarchy,
    adaptive_hierarchy,
    adaptive_solve,
    composite_solve,
    composite_system,
)
from .transfer import (  # noqa: F401
    StructuredProlongation,
    StructuredRestriction,
    TensorTransfer,
    fe_grid_interpolation,
    fe_interpolation_1d,
    fe_transfer_pair,
    fe_transfer_pair_dense,
    free_mask,
    setup_transfer_operators,
)
from .multifield import MultiFieldTransfer  # noqa: F401
from .projection_transfer import (  # noqa: F401
    L2ProjectionRestriction,
    setup_projection_restrictions,
)
from .local_projection import (  # noqa: F401
    LocalProjectionMap,
    SpaceProjectionMap,
)
from .spaces import (  # noqa: F401
    FESpace,
    FESpaceHierarchy,
    MultiFieldFESpace,
    TriangulationHierarchy,
    fe_space_hierarchy,
    multifield_hierarchy,
)

# Reference-facing aliases (GridapSolvers exports ProlongationOperator /
# RestrictionOperator; src/GridapSolvers.jl:17-51)
ProlongationOperator = StructuredProlongation
RestrictionOperator = StructuredRestriction
MultiFieldTransferOperator = MultiFieldTransfer
P4estCartesianModelHierarchy = octree_cartesian_hierarchy
