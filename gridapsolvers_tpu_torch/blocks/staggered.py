"""Staggered (one-directional-coupling) multiphysics operators.

Port of `gridapsolvers_tpu/blocks/staggered.py` (reference
StaggeredFEOperators, src/BlockSolvers/StaggeredFEOperators.jl:20,64-100,
123-303): variable k is solved with the already-solved variables
u_1..u_{k-1}; affine and nonlinear variants; the solver hands back its
per-stage set-ups for re-solves (reference :89-100). Host logic only: the
stages' operators run their own kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

from ..nonlinear.newton import NonlinearOperator
from ..utils import pytrees as pt


@dataclasses.dataclass
class StaggeredAffineOperator:
    """Stage k: A_k(u_prev) x_k = b_k(u_prev) with u_prev = (x_1..x_{k-1}).

    operators[k] : callable u_prev -> linear operator
    rhs[k]       : callable u_prev -> rhs vector
    (reference StaggeredAffineFEOperator, StaggeredFEOperators.jl:123-204)
    """

    operators: Sequence[Callable]
    rhs: Sequence[Callable]

    @property
    def num_stages(self) -> int:
        return len(self.operators)


@dataclasses.dataclass
class StaggeredNonlinearOperator:
    """Stage k: nonlinear operator factory u_prev -> NonlinearOperator
    (reference StaggeredNonlinearFEOperator, StaggeredFEOperators.jl:223-303)."""

    stages: Sequence[Callable]
    initial_guesses: Optional[Sequence] = None

    @property
    def num_stages(self) -> int:
        return len(self.stages)


@dataclasses.dataclass
class StaggeredSolver:
    """One linear (or nonlinear) solver per stage (reference
    StaggeredFESolver, StaggeredFEOperators.jl:64-70)."""

    solvers: Sequence

    def solve(self, op, x0: Optional[Tuple] = None, cache=None):
        """(tuple of per-stage solutions, cache). Passing the cache back
        re-uses the stage set-ups through `update` (reference
        StaggeredFEOperators.jl:89-100)."""
        xs: List = []
        new_cache = []
        if isinstance(op, StaggeredAffineOperator):
            for k in range(op.num_stages):
                u_prev = tuple(xs)
                A = op.operators[k](u_prev)
                b = op.rhs[k](u_prev)
                solver = self.solvers[k]
                state = solver.update(cache[k], A) if cache is not None else solver.setup(A)
                xk, _ = solver.solve(state, b, None if x0 is None else x0[k])
                xs.append(xk)
                new_cache.append(state)
            return tuple(xs), new_cache

        if not isinstance(op, StaggeredNonlinearOperator):
            raise TypeError(f"StaggeredSolver: unsupported operator {type(op).__name__}")
        for k in range(op.num_stages):
            nlop = op.stages[k](tuple(xs))
            if x0 is not None:
                guess = x0[k]
            elif op.initial_guesses is not None:
                guess = op.initial_guesses[k]
            else:
                raise ValueError("StaggeredSolver: nonlinear stages need an initial guess")
            xk, _ = self.solvers[k].solve(nlop, guess)
            xs.append(xk)
            new_cache.append(None)
        return tuple(xs), new_cache


@dataclasses.dataclass
class BlockFEOperator(NonlinearOperator):
    """Nonlinear operator assembled blockwise with per-block linearity:
    linear blocks are kept, nonlinear blocks are re-assembled at the
    current iterate (reference BlockFEOperators.jl:2-7,44-60,92-128).

    blocks[i][j]: None | operator (linear) | callable x -> operator
                  (nonlinear, called with the whole block iterate)
    rhs: tuple of per-field rhs vectors (residual = A(x) x - rhs)."""

    blocks: Sequence[Sequence]
    rhs: Tuple

    def _assemble(self, x):
        from ..algebra import BlockOperator

        return BlockOperator(tuple(
            tuple(b(x) if callable(b) else b for b in row) for row in self.blocks))

    def jacobian(self, x):
        return self._assemble(x)

    def residual(self, x):
        return pt.sub(self._assemble(x).matvec(x), self.rhs)
