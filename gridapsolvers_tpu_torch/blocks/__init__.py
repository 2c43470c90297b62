from .block_solvers import (  # noqa: F401
    BiformBlock,
    BlockDiagonalSolver,
    BlockTriangularSolver,
    LinearSystemBlock,
    MatrixBlock,
    NonlinearSystemBlock,
    SolverBlock,
    TriformBlock,
)

# Reference-facing alias (GridapSolvers exports BlockDiagonalSmoother,
# src/GridapSolvers.jl:37 — a block-diagonal solver used as a smoother)
BlockDiagonalSmoother = BlockDiagonalSolver
