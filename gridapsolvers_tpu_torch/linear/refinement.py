"""Linear iterative refinement with a double-f32 iterate.

Port of `gridapsolvers_tpu/linear/refinement.py`. A plain f32 Krylov
solve bottoms out near eps32 times the conditioning, because both the
iterate's representation and the residual evaluation are f32. Wilkinson
refinement with (a) the solution stored as an unevaluated (hi, lo) pair
of f32 vectors and (b) the residual r = b - A(x_hi (+) x_lo) evaluated
through error-free transforms (`utils/compensated`) recovers f64-grade
residuals while every inner solve stays the unchanged f32 preconditioned
Krylov method. Works for `StencilMatrix` and `ELLMatrix` operators. The
JAX package's three `jax.jit` closures are plain methods here.
"""
from __future__ import annotations

import dataclasses

import torch

from ..algebra.ell import ELLMatrix
from ..algebra.stencil import StencilMatrix
from ..utils.compensated import (
    comp_ell_matvec,
    comp_stencil_matvec,
    fast_two_sum,
    two_sum,
)


def comp_residual(A, b, x_hi, x_lo):
    """b - A (x_hi + x_lo) with a compensated matvec; returns a vector in
    the working precision (small near convergence, so the final rounding
    is free)."""
    if isinstance(A, StencilMatrix):
        hi, lo = comp_stencil_matvec(A, x_hi, x_lo)
    elif isinstance(A, ELLMatrix):
        hi, lo = comp_ell_matvec(A.values, A.cols, x_hi, x_lo)
    else:
        raise TypeError(f"comp_residual: unsupported operator {type(A).__name__}")
    s, e = two_sum(b.reshape(hi.shape), -hi)
    s, e2 = fast_two_sum(s, e - lo)
    return s + e2


@dataclasses.dataclass(frozen=True)
class IterativeRefinementSolver:
    """solve(A x = b): inner solve + `niter` compensated refinement steps
    on a double-f32 iterate. Returns ((x_hi, x_lo), (inner stats of the
    first solve, compensated residual norm of the final iterate))."""

    inner: object
    niter: int = 2

    def setup(self, A, x=None):
        return {"A": A, "inner": self.inner.setup(A, x)}

    def update(self, state, A, x=None):
        return {"A": A, "inner": self.inner.update(state["inner"], A, x)}

    def _step(self, A, st, b, x_hi, x_lo):
        r = comp_residual(A, b, x_hi, x_lo)
        dx, _ = self.inner.solve(st, r.reshape(b.shape))
        s, e = two_sum(x_hi, dx.reshape(x_hi.shape))
        x_hi, x_lo = fast_two_sum(s, e + x_lo)
        return x_hi, x_lo

    def solve(self, state, b, x0=None):
        A = state["A"]
        x_hi, stats = self.inner.solve(state["inner"], b)
        x_lo = torch.zeros_like(x_hi)
        for _ in range(self.niter):
            x_hi, x_lo = self._step(A, state["inner"], b, x_hi, x_lo)
        # the compensated residual of the final iterate
        rnorm = torch.linalg.vector_norm(comp_residual(A, b, x_hi, x_lo))
        return (x_hi, x_lo), (stats, rnorm)
