from .hierarchy import GridHierarchy, cartesian_hierarchy  # noqa: F401
from .transfer import (  # noqa: F401
    StructuredProlongation,
    StructuredRestriction,
    free_mask,
    setup_transfer_operators,
)
