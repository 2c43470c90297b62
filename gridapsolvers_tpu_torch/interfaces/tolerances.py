"""Solver tolerances and convergence flags.

Port of `gridapsolvers_tpu/interfaces/tolerances.py`. The flag values are
the JAX package's, so statistics compare field by field. The solvers of
the port loop in Python and read each residual norm once on the host, so
the predicates here take Python floats (or 0-d tensors, converted).
"""
from __future__ import annotations

import dataclasses
import enum
import math


class ConvergenceFlag(enum.IntEnum):
    """Why a solve finished (reference SolverConvergenceFlag,
    SolverTolerances.jl:1-9)."""

    ITERATING = 0
    CONVERGED_ATOL = 1
    CONVERGED_RTOL = 2
    DIVERGED_MAXITER = 3
    DIVERGED_BREAKDOWN = 4
    # finer than the reference's 4-flag enum: dtol blow-up is reported
    # distinctly from a true breakdown (non-finite residual)
    DIVERGED_DTOL = 5


@dataclasses.dataclass(frozen=True)
class SolverTolerances:
    """Static solver stopping criteria.

    maxiter : max number of iterations (sizes the residual history).
    atol    : absolute tolerance on the residual norm.
    rtol    : relative tolerance w.r.t. the initial residual norm.
    dtol    : divergence tolerance (residual growth factor); <=0 disables.
    """

    maxiter: int = 1000
    atol: float = 0.0
    rtol: float = 1.0e-5
    dtol: float = 0.0

    def target(self, r0norm) -> float:
        """Target residual norm: max(atol, rtol * ||r0||)."""
        return max(self.atol, self.rtol * float(r0norm))

    def converged(self, rnorm, r0norm) -> bool:
        return float(rnorm) <= self.target(r0norm)

    def diverged(self, rnorm, r0norm) -> bool:
        if self.dtol > 0:
            return float(rnorm) > self.dtol * float(r0norm)
        return False

    def finished(self, niter: int, rnorm, r0norm) -> bool:
        """Stop condition (reference SolverTolerances.jl:46-49)."""
        return (
            niter >= self.maxiter
            or self.converged(rnorm, r0norm)
            or self.diverged(rnorm, r0norm)
            or not math.isfinite(float(rnorm))
        )

    def finished_flag(self, niter: int, rnorm, r0norm) -> ConvergenceFlag:
        """ConvergenceFlag of a finished solve, with the reference's
        priority order rtol > atol > maxiter > divergence (reference
        SolverTolerances.jl:97-110); dtol blow-up reports DIVERGED_DTOL and
        BREAKDOWN is reserved for a non-finite residual."""
        rnorm, r0norm = float(rnorm), float(r0norm)
        if rnorm <= self.rtol * r0norm:
            return ConvergenceFlag.CONVERGED_RTOL
        if rnorm <= self.atol:
            return ConvergenceFlag.CONVERGED_ATOL
        if niter >= self.maxiter:
            return ConvergenceFlag.DIVERGED_MAXITER
        if self.diverged(rnorm, r0norm) and math.isfinite(rnorm):
            return ConvergenceFlag.DIVERGED_DTOL
        return ConvergenceFlag.DIVERGED_BREAKDOWN
