"""External nonlinear-solver wrapper (SciPy).

Port of `gridapsolvers_tpu/nonlinear/external.py` (reference
NLsolveNonlinearSolver, src/NonlinearSolvers/NLsolve.jl:13-28,55-98):
drive an external nonlinear library (hybr, krylov, anderson, broyden, ...)
with the port's linear solver stack as the inner preconditioned solve.
Host-side and serial only, as the reference's wrapper is
(NLsolve.jl:10-11): every residual goes through the host as a NumPy
vector.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..interfaces import LinearSolver
from ..utils import pytrees as pt


def _flatten(x):
    """(flat NumPy vector in the leaves' dtype, template) of a vector."""
    return pt.ravel(x).detach().cpu().numpy(), x


def _unflatten(flat, template):
    leaf = pt.tree_leaves(template)[0]
    t = torch.from_numpy(np.ascontiguousarray(flat)).to(device=leaf.device, dtype=leaf.dtype)
    return pt.unflatten_like(t, template)


@dataclasses.dataclass
class ScipyNonlinearSolver:
    """scipy.optimize.root over the NonlinearOperator protocol.

    method='krylov' with a `linear` solver uses it as the inner
    preconditioner (set up at the current iterate's Jacobian); other
    methods ('hybr', 'anderson', 'broyden1', 'df-sane') pass through.
    Returns (x, scipy's OptimizeResult)."""

    method: str = "krylov"
    linear: Optional[LinearSolver] = None
    maxiter: int = 50
    tol: float = 1e-8

    def solve(self, op, x0):
        import scipy.optimize as sopt

        flat0, info = _flatten(x0)
        state = {"x": x0}

        def fun_tracking(z):
            x = _unflatten(z, info)
            state["x"] = x
            return _flatten(op.residual(x))[0]

        kwargs = {}
        if self.method == "krylov" and self.linear is not None:
            from scipy.sparse.linalg import LinearOperator

            def precond_mv(rhs):
                x = state["x"]
                A = op.jacobian(x)
                st = self.linear.setup(A, x)
                z, _ = self.linear.solve(st, _unflatten(rhs, info))
                return _flatten(z)[0]

            inner_M = LinearOperator((flat0.size, flat0.size), matvec=precond_mv,
                                     dtype=flat0.dtype)
            kwargs["options"] = {"jac_options": {"inner_M": inner_M}, "maxiter": self.maxiter}
        sol = sopt.root(fun_tracking, flat0, method=self.method, tol=self.tol, **kwargs)
        return _unflatten(sol.x, info), sol
