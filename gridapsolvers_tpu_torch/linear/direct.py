"""Dense direct solvers for small (coarse) systems.

Port of `gridapsolvers_tpu/linear/direct.py`: `DenseLUSolver`,
`DenseCholeskySolver`, `DenseInverseSolver` and `MatrixSolver`. GMG keeps
the coarsest system small by construction, so its solve is a dense
factorization on the device
(library LU, inverse and matmul, as the JAX package leaves them to XLA).
On a CUDA card in f32, keep `torch.backends.cuda.matmul.allow_tf32` and
`torch.backends.cudnn.allow_tf32` False, as `chip_smoke.py` sets them, so
the factorizations and solves cannot drift to TF32's ~3 digits.

A reduced-precision GMG (`compute_dtype`, not `mixed`) casts the factors
to bf16. PyTorch's triangular solves do not take bf16, so the LU and
Cholesky solvers then solve in f32 from the bf16-rounded factors and
round the result once; the JAX package solves in bf16 there.
"""
from __future__ import annotations

import dataclasses

import torch

from ..interfaces import LinearSolver
from ..utils import pytrees as pt


def _dense(A) -> torch.Tensor:
    return A.todense() if hasattr(A, "todense") else torch.as_tensor(A)


def _ravel(r):
    """Flatten a vector to 1D (tuple vectors -> one dense solve)."""
    if isinstance(r, torch.Tensor) and r.ndim == 1:
        return r, None
    return pt.ravel(r), r


def _unravel(flat, template):
    return flat if template is None else pt.unflatten_like(flat, template)


# factor dtypes the triangular solves do not take, and the one they run in
_SOLVE_DTYPE = {torch.bfloat16: torch.float32}


def _triangular_solve(solve, factor, flat):
    """solve(factor, rhs) on a (n, 1) rhs; a bf16 factor is solved in f32
    and the result rounded to the rhs's dtype."""
    wide = _SOLVE_DTYPE.get(factor.dtype)
    if wide is None:
        return solve(factor, flat.unsqueeze(-1)).squeeze(-1)
    z = solve(factor.to(wide), flat.to(wide).unsqueeze(-1)).squeeze(-1)
    return z.to(flat.dtype)


@dataclasses.dataclass(frozen=True)
class DenseLUSolver(LinearSolver):
    """Direct solve via dense LU (reference LUSolver() for coarse grids,
    e.g. test/LinearSolvers/GMGTests.jl)."""

    def setup(self, A, x=None):
        lu, piv = torch.linalg.lu_factor(_dense(A))
        return {"lu": lu, "piv": piv}

    def apply(self, state, r):
        flat, template = _ravel(r)
        z = _triangular_solve(
            lambda lu, rhs: torch.linalg.lu_solve(lu, state["piv"], rhs), state["lu"], flat
        )
        return _unravel(z, template)

    def solve(self, state, b, x0=None):
        return self.apply(state, b), None


@dataclasses.dataclass(frozen=True)
class DenseCholeskySolver(LinearSolver):
    """Direct solve via dense Cholesky (SPD systems)."""

    def setup(self, A, x=None):
        return {"c": torch.linalg.cholesky(_dense(A))}

    def apply(self, state, r):
        flat, template = _ravel(r)
        return _unravel(_triangular_solve(
            lambda c, rhs: torch.cholesky_solve(rhs, c), state["c"], flat), template)

    def solve(self, state, b, x0=None):
        return self.apply(state, b), None


@dataclasses.dataclass(frozen=True)
class DenseInverseSolver(LinearSolver):
    """Direct solve via the precomputed explicit inverse: apply is one
    matrix-vector product instead of two triangular solves. The multigrid
    coarse system is small and well-conditioned by construction, so the
    explicit inverse is numerically safe."""

    def setup(self, A, x=None):
        return {"inv": torch.linalg.inv(_dense(A))}

    def apply(self, state, r):
        flat, template = _ravel(r)
        return _unravel(state["inv"] @ flat, template)

    def solve(self, state, b, x0=None):
        return self.apply(state, b), None


@dataclasses.dataclass(frozen=True)
class MatrixSolver(LinearSolver):
    """Solve with a fixed external matrix regardless of the passed A
    (reference MatrixSolvers.jl:2-8,20-37)."""

    M: object  # operator
    solver: LinearSolver = dataclasses.field(default_factory=DenseLUSolver)

    def setup(self, A, x=None):
        return self.solver.setup(self.M, x)

    def apply(self, state, r):
        return self.solver.apply(state, r)

    def solve(self, state, b, x0=None):
        return self.solver.solve(state, b, x0)
