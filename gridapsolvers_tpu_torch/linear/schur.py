"""Exact Schur-complement block solver.

Port of `gridapsolvers_tpu/linear/schur.py`. Analog of the reference's SchurComplementSolver
(src/LinearSolvers/SchurComplementSolvers.jl:11-26,55-74): given solvers for
the (0,0) block A and an approximation S̃ ≈ D - C A⁻¹ B of the Schur
complement, applies the exact block-2x2 inverse:

    x_u = A⁻¹ y_u
    x_p = S̃⁻¹ (y_p - C x_u)
    x_u = x_u - A⁻¹ B x_p
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..interfaces import LinearSolver
from ..utils import pytrees as pt


@dataclasses.dataclass(frozen=True)
class SchurComplementSolver(LinearSolver):
    A_solver: LinearSolver
    S_solver: LinearSolver
    S_op: Optional[object] = None  # operator for S̃; None -> system (1,1)

    def setup(self, A, x=None):
        A00 = A.block(0, 0)
        B = A.block(0, 1)
        C = A.block(1, 0)
        S = self.S_op if self.S_op is not None else A.block(1, 1)
        return {
            "A": self.A_solver.setup(A00, None if x is None else x[0]),
            "S": self.S_solver.setup(S, None if x is None else x[1]),
            "B": B,
            "C": C,
        }

    def update(self, state, A, x=None):
        new = dict(state)
        new["A"] = self.A_solver.update(
            state["A"], A.block(0, 0), None if x is None else x[0]
        )
        S = self.S_op if self.S_op is not None else A.block(1, 1)
        new["S"] = self.S_solver.update(
            state["S"], S, None if x is None else x[1]
        )
        new["B"], new["C"] = A.block(0, 1), A.block(1, 0)
        return new

    def apply(self, state, r):
        y_u, y_p = r
        x_u = self.A_solver.apply(state["A"], y_u)
        rp = pt.sub(y_p, state["C"].matvec(x_u))
        x_p = self.S_solver.apply(state["S"], rp)
        x_u = pt.sub(x_u, self.A_solver.apply(state["A"], state["B"].matvec(x_p)))
        return (x_u, x_p)

    def solve(self, state, b, x0=None):
        return self.apply(state, b), None
