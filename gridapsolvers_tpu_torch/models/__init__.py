from .poisson import solve_poisson, solve_poisson_const  # noqa: F401
