"""Dense direct solvers for small (coarse) systems.

Port of `DenseLUSolver` and `DenseInverseSolver` of
`gridapsolvers_tpu/linear/direct.py`. GMG keeps the coarsest system small
by construction, so its solve is a dense factorization on the device
(library LU, inverse and matmul, as the JAX package leaves them to XLA).
On a CUDA card in f32, keep `torch.backends.cuda.matmul.allow_tf32` and
`torch.backends.cudnn.allow_tf32` False, as `chip_smoke.py` sets them, so
the factorizations and solves cannot drift to TF32's ~3 digits.
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


@dataclasses.dataclass(frozen=True)
class DenseLUSolver(LinearSolver):
    """Direct solve via dense LU (reference LUSolver() for coarse grids,
    e.g. test/LinearSolvers/GMGTests.jl)."""

    def setup(self, A, x=None):
        lu, piv = torch.linalg.lu_factor(_dense(A))
        return {"lu": lu, "piv": piv}

    def apply(self, state, r):
        flat, template = _ravel(r)
        z = torch.linalg.lu_solve(state["lu"], state["piv"], flat.unsqueeze(-1))
        return _unravel(z.squeeze(-1), template)

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
