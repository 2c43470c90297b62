"""Navier-Stokes entry point: Newton + block-preconditioned FGMRES with the
nonlinear blocks refreshed at each iterate (reference
test/Applications/NavierStokesGMG.jl:132-176).

Port of `gridapsolvers_tpu/models/navier_stokes.py`.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..blocks import BlockTriangularSolver, MatrixBlock, NonlinearSystemBlock
from ..fem.navier_stokes import navier_stokes_problem, ns_velocity_gmg
from ..linear import CGSolver, DenseLUSolver, FGMRESSolver, JacobiSolver
from ..nonlinear import ContinuationOperator, ContinuationSwitch, NewtonSolver


class _Picard:
    """The problem with its Picard (convection-only) Jacobian."""

    def __init__(self, prob):
        self.prob = prob

    def residual(self, x):
        return self.prob.residual(x)

    def jacobian(self, x):
        return self.prob.picard_jacobian(x)


def solve_navier_stokes(
    ncells: Tuple[int, int],
    nu: float = 1.0,
    rtol: float = 1e-9,
    newton_maxiter: int = 15,
    picard_first: int = 0,
    graddiv_alpha: float = 0.0,
    num_levels: int = 2,
    dtype=torch.float64,
    device=None,
):
    """Newton from zero on the manufactured-solution problem, each step an
    FGMRES(40) solve with the upper block-triangular preconditioner.

    graddiv_alpha = 0: a dense LU of the velocity block and the pressure
    mass. graddiv_alpha > 0: the reference's NavierStokesGMG configuration
    (augmented Lagrangian, the nonlinear patch-smoothed velocity GMG on
    `num_levels` levels, -(1/alpha) Mp and coefficients ((1, 1), (0, 1))).
    picard_first > 0 runs that many Picard Jacobians first
    (ContinuationOperator). Operators in `dtype` on `device` (None: the
    card). Returns (x, stats, {"velocity_error", "problem"})."""
    prob = navier_stokes_problem(ncells, nu=nu, graddiv_alpha=graddiv_alpha, dtype=dtype,
                                 device=device)
    if graddiv_alpha > 0.0:
        u_solver = ns_velocity_gmg(ncells, num_levels=num_levels, nu=nu,
                                   graddiv_alpha=graddiv_alpha, dtype=dtype, device=device)
        Mp_pc = dataclasses.replace(prob.Mp, values=prob.Mp.values * (-1.0 / graddiv_alpha))
        coeffs = ((1.0, 1.0), (0.0, 1.0))
    else:
        u_solver, Mp_pc, coeffs = DenseLUSolver(), prob.Mp, None
    P = BlockTriangularSolver(
        solvers=(u_solver, CGSolver(Pl=JacobiSolver(), rtol=1e-10, maxiter=60)),
        blocks=((NonlinearSystemBlock(), None), (None, MatrixBlock(Mp_pc))),
        coeffs=coeffs,
        half="upper",
    )
    fgmres = FGMRESSolver(m=40, Pr=P, rtol=1e-10, maxiter=150)
    newton = NewtonSolver(fgmres, maxiter=newton_maxiter, rtol=rtol)
    op = prob
    if picard_first > 0:
        op = ContinuationOperator(_Picard(prob), prob, ContinuationSwitch(niter=picard_first))
    x, stats = newton.solve(op, prob.zero_guess())
    return x, stats, {"velocity_error": prob.velocity_error(x[0]), "problem": prob}
