from .newton import NewtonSolver, NonlinearOperator  # noqa: F401
from .continuation import (  # noqa: F401
    ContinuationOperator,
    ContinuationSwitch,
)
