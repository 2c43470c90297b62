from .mesh import CartesianMesh  # noqa: F401
from .assembly import (  # noqa: F401
    assemble_poisson_stencil,
    assemble_q1_stencil,
    dirichlet_rhs,
    eliminate_dirichlet,
    laplacian,
    laplacian_const,
    mass,
    q1_element_matrices,
)
from .poisson import PoissonProblem, poisson_problem  # noqa: F401
