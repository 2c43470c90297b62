"""The solver protocol.

Port of `gridapsolvers_tpu/interfaces/protocol.py`, with the same method
names (reference GridapExtras.jl:4-14):

    solver.setup(A, x=None)         -> state        (symbolic+numerical setup)
    solver.update(state, A, x=None) -> state        (numerical_setup!)
    solver.solve(state, b, x0)      -> (x, stats)   (solve!)
    solver.apply(state, r)          -> z            (preconditioner action)

`state` is a plain dict of tensors and operators. Smoothers additionally
implement the (x, r) contract used by GMG (reference
RichardsonSmoothers.jl:84-98):

    smoother.smooth(state, x, r)    -> (x, r)
"""
from __future__ import annotations

from typing import Any, Optional, Tuple


class LinearSolver:
    """Base class (duck-typed; subclasses override setup/solve)."""

    def setup(self, A, x: Optional[Any] = None):
        raise NotImplementedError

    def update(self, state, A, x: Optional[Any] = None):
        """Refresh the setup for a new matrix with the same sparsity.
        Default: full re-setup (reference numerical_setup!)."""
        return self.setup(A, x)

    def solve(self, state, b, x0: Optional[Any] = None):
        raise NotImplementedError

    def apply(self, state, r):
        """Preconditioner action z = M^{-1} r (solve from zero init)."""
        z, _ = self.solve(state, r, None)
        return z


class Smoother(LinearSolver):
    """Solvers that also expose the GMG smoothing contract: update the
    iterate x AND keep the residual r consistent (r -= A dx)."""

    def smooth(self, state, x, r) -> Tuple[Any, Any]:
        raise NotImplementedError


def as_preconditioner(solver: Optional[LinearSolver], A, x=None):
    """Setup helper tolerating `None` (identity preconditioning), like the
    reference's nothing-preconditioner dispatch (Krylov/KrylovUtils.jl)."""
    if solver is None:
        return None
    return solver.setup(A, x)


def precond_apply(solver: Optional[LinearSolver], state, r):
    if solver is None:
        return r
    return solver.apply(state, r)
