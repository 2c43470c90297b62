from .poisson import poisson_const_gmg, solve_poisson, solve_poisson_const  # noqa: F401
