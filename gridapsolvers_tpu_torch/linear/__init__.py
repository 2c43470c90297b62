from .cg import CGSolver, condition_estimate  # noqa: F401
from .gmres import AdaptiveGMRESSolver, FGMRESSolver, GMRESSolver  # noqa: F401
from .minres import MINRESSolver  # noqa: F401
from .direct import (  # noqa: F401
    DenseCholeskySolver,
    DenseInverseSolver,
    DenseLUSolver,
    MatrixSolver,
)
from .smoothers import (  # noqa: F401
    ChebyshevSmoother,
    ColoredGaussSeidel,
    IdentitySolver,
    JacobiSolver,
    PreconditionedChebyshevSmoother,
    RichardsonLinearSolver,
    RichardsonSmoother,
    SymGaussSeidelSmoother,
    estimate_dinv_a_lmax,
    gershgorin_dinv_a_lmax,
    stencil_coloring,
)
from .gmg import GMGSolver, gmg_from_hierarchy  # noqa: F401
from .refinement import IterativeRefinementSolver, comp_residual  # noqa: F401
from .wrappers import (  # noqa: F401
    AugmentedNullspaceOperator,
    CallbackSolver,
    LinearSolverFromSmoother,
    NullspaceSolver,
)
from .amg import AMGSolver  # noqa: F401
from .schur import SchurComplementSolver  # noqa: F401
from .schwarz import (  # noqa: F401
    SchwarzLinearSolver,
    TwoLevelSchwarzSolver,
    slab_neumann_matrices,
)

# Reference-facing aliases (src/GridapSolvers.jl re-exports;
# SymGaussSeidelSmoother already aliased in smoothers.py)
JacobiLinearSolver = JacobiSolver
GMGLinearSolver = GMGSolver
IdentityLinearSolver = IdentitySolver
