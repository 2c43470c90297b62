from .poisson import poisson_const_gmg, solve_poisson, solve_poisson_const  # noqa: F401
from .darcy import solve_darcy  # noqa: F401
from .stokes import solve_stokes  # noqa: F401
from .navier_stokes import solve_navier_stokes  # noqa: F401
from .elasticity import solve_elasticity  # noqa: F401
