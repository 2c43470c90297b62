from .cg import CGSolver, condition_estimate  # noqa: F401
from .direct import DenseInverseSolver, DenseLUSolver  # noqa: F401
from .smoothers import (  # noqa: F401
    ChebyshevSmoother,
    JacobiSolver,
    RichardsonSmoother,
    estimate_dinv_a_lmax,
    gershgorin_dinv_a_lmax,
)
from .gmg import GMGSolver, gmg_from_hierarchy  # noqa: F401
from .amg import AMGSolver  # noqa: F401
