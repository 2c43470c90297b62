from .tolerances import ConvergenceFlag, SolverTolerances  # noqa: F401
from .logs import ConvergenceLog, SolverStats, VerboseLevel  # noqa: F401
from .logs import init_history, make_stats  # noqa: F401
from .protocol import LinearSolver, Smoother  # noqa: F401
