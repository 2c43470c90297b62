"""Wrapper / composite solvers.

Port of `gridapsolvers_tpu/linear/wrappers.py`:

- NullspaceSolver   ← src/LinearSolvers/NullspaceSolvers.jl:30-43,59-120:
  solve with a kernel constraint, either by augmenting the system
  [A K'; K 0] (constrain_matrix=True) or by orthogonalizing against K
  around an inner solve.
- CallbackSolver    ← src/LinearSolvers/CallbackSolver.jl:16-25,62-66:
  run a callback on the iterate after every inner solve.
- LinearSolverFromSmoother ← src/LinearSolvers/LinearSolverFromSmoothers.jl:
  adapt the (x, r) smoothing contract to the standard (x, b) solve.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..interfaces import LinearSolver, NullSpace, Smoother, make_orthogonal
from ..interfaces.nullspaces import make_orthonormal
from ..utils import pytrees as pt
from .direct import DenseLUSolver, _ravel, _unravel


@dataclasses.dataclass
class AugmentedNullspaceOperator:
    """Matrix-free augmented saddle operator [A K'; K 0] acting on flat
    (n+k,) vectors. A stays in whatever compact format it has and only its
    matvec is composed, so the constrained path scales to large singular
    systems (the reference materializes it, NullspaceSolvers.jl:59-75)."""

    A: object                 # any operator with matvec on its own vectors
    K: torch.Tensor           # (k, n) orthonormal nullspace rows (flat)
    template: object          # a vector of A's space (its structure)

    @property
    def shape(self):
        m = self.K.shape[1] + self.K.shape[0]
        return (m, m)

    @property
    def dtype(self):
        return self.K.dtype

    def matvec(self, v):
        n = self.K.shape[1]
        xn, lam = v[:n], v[n:]
        Ax, _ = _ravel(self.A.matvec(_unravel(xn, self.template)))
        return torch.cat([Ax + self.K.T @ lam, self.K @ xn])

    def diag(self):
        d, _ = _ravel(self.A.diag())
        # unit placeholder on the multiplier block so Jacobi-type
        # preconditioners of the inner Krylov stay well-defined
        return torch.cat([d, torch.ones(self.K.shape[0], dtype=d.dtype, device=d.device)])


@dataclasses.dataclass
class _DenseOperator:
    """A dense (n, n) matrix as an operator (the densified augmented
    system handed to the inner solver)."""

    M: torch.Tensor

    @property
    def shape(self):
        return tuple(self.M.shape)

    def matvec(self, x):
        return self.M @ x

    def diag(self):
        return torch.diagonal(self.M)

    def todense(self):
        return self.M


def _stack_nullspace(ns):
    """(k, n) tensor of flattened orthonormal nullspace vectors + template."""
    flat_vecs, template = [], None
    for v in ns.vectors:
        fv, template = _ravel(v)
        flat_vecs.append(fv)
    return torch.stack(flat_vecs), template


@dataclasses.dataclass(frozen=True)
class NullspaceSolver(LinearSolver):
    """Solve A x = b where A is singular with known nullspace K.

    constrain_matrix=True: solve the augmented saddle system
        [A  K'] [x]   [b]
        [K  0 ] [l] = [0]
    with the inner solver (reference NullspaceSolvers.jl:92-111),
    densified for direct inner solvers (coarse grids, the reference's
    usage) or matrix-free (`matrix_free=True`) for iterative inner solvers
    (MINRES/GMRES) on large systems. Otherwise: orthogonalize b against K,
    solve, re-orthogonalize x (reference :113-120).
    """

    solver: LinearSolver = dataclasses.field(default_factory=DenseLUSolver)
    nullspace: NullSpace = None
    constrain_matrix: bool = True
    matrix_free: bool = False

    def setup(self, A, x=None):
        ns = make_orthonormal(self.nullspace)
        if not self.constrain_matrix:
            return {"inner": self.solver.setup(A, x), "ns": ns}
        K, template = _stack_nullspace(ns)
        if self.matrix_free:
            aug_op = AugmentedNullspaceOperator(A, K, template)
            return {"inner": self.solver.setup(aug_op, None), "ns": ns}
        # dense augmented system (small/coarse problems)
        D = A.todense()
        k, n = K.shape
        aug = torch.zeros((n + k, n + k), dtype=D.dtype, device=D.device)
        aug[:n, :n] = D
        aug[:n, n:] = K.T
        aug[n:, :n] = K
        return {"inner": self.solver.setup(_DenseOperator(aug), None), "ns": ns}

    def solve(self, state, b, x0=None):
        ns = state["ns"]
        if not self.constrain_matrix:
            b_orth, _ = make_orthogonal(ns, b)
            x, stats = self.solver.solve(state["inner"], b_orth, x0)
            x, _ = make_orthogonal(ns, x)
            return x, stats
        flat, template = _ravel(b)
        n = flat.shape[0]
        k = len(ns.vectors)
        rhs = torch.cat([flat, torch.zeros(k, dtype=flat.dtype, device=flat.device)])
        sol, stats = self.solver.solve(state["inner"], rhs, None)
        return _unravel(sol[:n], template), stats

    def apply(self, state, r):
        x, _ = self.solve(state, r, None)
        return x


@dataclasses.dataclass(frozen=True)
class CallbackSolver(LinearSolver):
    """Run callback(x) after each solve (logging/correction hook); a
    callback that returns a vector replaces x."""

    solver: LinearSolver
    callback: Callable

    def setup(self, A, x=None):
        return self.solver.setup(A, x)

    def update(self, state, A, x=None):
        return self.solver.update(state, A, x)

    def solve(self, state, b, x0=None):
        x, stats = self.solver.solve(state, b, x0)
        out = self.callback(x)
        if out is not None:
            x = out
        return x, stats

    def apply(self, state, r):
        x, _ = self.solve(state, r, None)
        return x


@dataclasses.dataclass(frozen=True)
class LinearSolverFromSmoother(LinearSolver):
    """Smoother (x, r in/out) -> standard solver (x, b)."""

    smoother: Smoother

    def setup(self, A, x=None):
        return {"A": A, "sm": self.smoother.setup(A, x)}

    def update(self, state, A, x=None):
        return {"A": A, "sm": self.smoother.update(state["sm"], A, x)}

    def solve(self, state, b, x0=None):
        x = pt.zeros_like(b) if x0 is None else x0
        r = pt.sub(b, state["A"].matvec(x))
        x, _ = self.smoother.smooth(state["sm"], x, r)
        return x, None

    def apply(self, state, r):
        x, _ = self.smoother.smooth(state["sm"], pt.zeros_like(r), r)
        return x
