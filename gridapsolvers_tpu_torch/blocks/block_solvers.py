"""Block preconditioners for multiphysics saddle-point systems.

Port of `gridapsolvers_tpu/blocks/block_solvers.py`, unchanged but for
the vectors (tuples of tensors, mapped by `utils/pytrees.py`). Functional
redesign of the reference's BlockSolvers module
(src/BlockSolvers/): block *specs* say how each preconditioner block is
obtained from the system and whether it must be rebuilt per Newton iterate
(reference SolverBlock hierarchy, BlockSolverInterfaces.jl:8-25):

- LinearSystemBlock     ← BlockSolverInterfaces.jl:191  (A_ij, never updated)
- NonlinearSystemBlock  ← BlockSolverInterfaces.jl:206-236 (A_ij, re-extracted
                          at the current iterate on update)
- MatrixBlock           ← BlockSolverInterfaces.jl:162-180 (external operator)
- BiformBlock           ← BlockSolverInterfaces.jl:262-275 (assembled once
                          from a callable)
- TriformBlock          ← BlockSolverInterfaces.jl:292-321 (reassembled from
                          a callable of the current solution on update)

Block vectors are tuples of tensors, so the solvers compose with every Krylov
driver unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

from ..interfaces import LinearSolver
from ..utils import pytrees as pt


class SolverBlock:
    nonlinear: bool = False

    def get(self, A, i: int, j: int, x):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class LinearSystemBlock(SolverBlock):
    nonlinear: bool = dataclasses.field(default=False, init=False)

    def get(self, A, i, j, x):
        return A.block(i, j)


@dataclasses.dataclass(frozen=True)
class NonlinearSystemBlock(SolverBlock):
    nonlinear: bool = dataclasses.field(default=True, init=False)

    def get(self, A, i, j, x):
        return A.block(i, j)


@dataclasses.dataclass(frozen=True)
class MatrixBlock(SolverBlock):
    op: object
    nonlinear: bool = dataclasses.field(default=False, init=False)

    def get(self, A, i, j, x):
        return self.op


@dataclasses.dataclass(frozen=True)
class BiformBlock(SolverBlock):
    """Operator assembled once from a zero-argument callable (the analog of
    assembling a bilinear form at setup)."""

    form: Callable[[], object]
    nonlinear: bool = dataclasses.field(default=False, init=False)

    def get(self, A, i, j, x):
        return self.form()


@dataclasses.dataclass(frozen=True)
class TriformBlock(SolverBlock):
    """Operator reassembled from the current solution on every update
    (trilinear form c(u, ., .) at the Newton iterate)."""

    form: Callable[[object], object]  # x -> operator
    nonlinear: bool = dataclasses.field(default=True, init=False)

    def get(self, A, i, j, x):
        return self.form(x)


def _canon_block(spec) -> SolverBlock:
    if isinstance(spec, SolverBlock):
        return spec
    if spec is None:
        return LinearSystemBlock()
    # raw operator
    return MatrixBlock(spec)


@dataclasses.dataclass(frozen=True)
class BlockDiagonalSolver(LinearSolver):
    """One solver per diagonal block (reference BlockDiagonalSolvers.jl:
    22-45,165-177): z_i = solver_i^{-1} r_i."""

    solvers: Tuple[LinearSolver, ...]
    blocks: Optional[Tuple[SolverBlock, ...]] = None

    def _specs(self):
        if self.blocks is None:
            return tuple(LinearSystemBlock() for _ in self.solvers)
        return tuple(_canon_block(b) for b in self.blocks)

    def setup(self, A, x=None):
        specs = self._specs()
        ops = [
            spec.get(A, i, i, x) for i, spec in enumerate(specs)
        ]
        states = [
            s.setup(op, None if x is None else x[i])
            for i, (s, op) in enumerate(zip(self.solvers, ops))
        ]
        return {"ops": ops, "states": states}

    def update(self, state, A, x=None):
        specs = self._specs()
        ops = list(state["ops"])
        states = list(state["states"])
        for i, spec in enumerate(specs):
            if spec.nonlinear:
                ops[i] = spec.get(A, i, i, x)
                states[i] = self.solvers[i].update(
                    states[i], ops[i], None if x is None else x[i]
                )
        return {"ops": ops, "states": states}

    def apply(self, state, r):
        return tuple(
            s.apply(st, ri)
            for s, st, ri in zip(self.solvers, state["states"], r)
        )

    def solve(self, state, b, x0=None):
        return self.apply(state, b), None


@dataclasses.dataclass(frozen=True)
class BlockTriangularSolver(LinearSolver):
    """Upper/lower block-triangular preconditioner with off-diagonal
    coefficient scaling (reference BlockTriangularSolvers.jl:26-58,188-242):

        upper:  for i = N-1..0:  w = r_i - sum_{j>i} c_ij A_ij z_j
                                 z_i = solver_i^{-1} w
        lower:  same with j < i, i ascending.
    """

    solvers: Tuple[LinearSolver, ...]
    blocks: Optional[Tuple[Tuple[SolverBlock, ...], ...]] = None
    coeffs: Optional[Tuple[Tuple[float, ...], ...]] = None
    half: str = "upper"

    def __post_init__(self):
        assert self.half in ("upper", "lower")

    @property
    def nblocks(self):
        return len(self.solvers)

    def _specs(self):
        N = self.nblocks
        if self.blocks is None:
            return [[LinearSystemBlock()] * N for _ in range(N)]
        return [[_canon_block(b) for b in row] for row in self.blocks]

    def _coef(self, i, j):
        if self.coeffs is None:
            return 1.0
        return self.coeffs[i][j]

    def _offdiag_indices(self):
        N = self.nblocks
        for i in range(N):
            for j in range(N):
                if (self.half == "upper" and j > i) or (
                    self.half == "lower" and j < i
                ):
                    yield i, j

    def setup(self, A, x=None):
        specs = self._specs()
        N = self.nblocks
        diag_ops = [specs[i][i].get(A, i, i, x) for i in range(N)]
        states = [
            s.setup(op, None if x is None else x[i])
            for i, (s, op) in enumerate(zip(self.solvers, diag_ops))
        ]
        off_ops = {
            (i, j): specs[i][j].get(A, i, j, x)
            for i, j in self._offdiag_indices()
        }
        return {"diag_ops": diag_ops, "states": states, "off_ops": off_ops}

    def update(self, state, A, x=None):
        specs = self._specs()
        N = self.nblocks
        diag_ops = list(state["diag_ops"])
        states = list(state["states"])
        off_ops = dict(state["off_ops"])
        for i in range(N):
            if specs[i][i].nonlinear:
                diag_ops[i] = specs[i][i].get(A, i, i, x)
                states[i] = self.solvers[i].update(
                    states[i], diag_ops[i], None if x is None else x[i]
                )
        for i, j in self._offdiag_indices():
            if specs[i][j].nonlinear:
                off_ops[(i, j)] = specs[i][j].get(A, i, j, x)
        return {"diag_ops": diag_ops, "states": states, "off_ops": off_ops}

    def apply(self, state, r):
        N = self.nblocks
        z = [None] * N
        order = range(N - 1, -1, -1) if self.half == "upper" else range(N)
        for i in order:
            w = r[i]
            for ii, j in self._offdiag_indices():
                if ii != i or z[j] is None:
                    continue
                contrib = state["off_ops"][(i, j)].matvec(z[j])
                w = pt.axpy(-self._coef(i, j), contrib, w)
            z[i] = self.solvers[i].apply(state["states"][i], w)
        return tuple(z)

    def solve(self, state, b, x0=None):
        return self.apply(state, b), None
