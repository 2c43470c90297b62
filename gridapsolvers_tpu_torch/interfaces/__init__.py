from .tolerances import ConvergenceFlag, SolverTolerances  # noqa: F401
from .logs import ConvergenceLog, SolverStats, VerboseLevel  # noqa: F401
from .logs import init_history, make_stats, record  # noqa: F401
from .protocol import LinearSolver, Smoother, as_preconditioner, precond_apply  # noqa: F401
from .info import children, format_solver_tree, get_solver_info  # noqa: F401
from .nullspaces import (  # noqa: F401
    NullSpace,
    constant_nullspace,
    make_orthogonal,
    make_orthonormal,
    project,
    reconstruct,
    rigid_body_modes,
)
