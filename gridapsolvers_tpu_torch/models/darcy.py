"""Mixed Darcy driver: block-preconditioned GMRES/FGMRES
(reference test/Applications/DarcyGMG.jl analog).

Port of `gridapsolvers_tpu/models/darcy.py`, all three branches. The RT0
branches build the pressure block's dense n_p x n_p scaled identity as the
JAX package does (`DenseMatrix`, 134 MB at 64^2 cells in f64), so they are
meant for small grids; the RT1 branch (order 2) is the reference's own
DarcyGMG configuration and runs at any size.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..algebra import DenseMatrix
from ..blocks import BlockDiagonalSolver, MatrixBlock
from ..fem.darcy import darcy_problem
from ..linear import DenseLUSolver, GMRESSolver, JacobiSolver
from ..utils import resolve_device


def solve_darcy(
    ncells: Tuple[int, int],
    rtol: float = 1e-9,
    maxiter: int = 400,
    graddiv_alpha: float = 0.0,
    num_levels: int = 3,
    order: int = 1,
    dtype=torch.float64,
    device=None,
):
    """graddiv_alpha > 0 selects the reference's DarcyGMG configuration
    (DarcyGMG.jl:70-115): div-div augmented velocity block, FGMRES +
    upper block-triangular [H(div) GMG, -(1/alpha) Mp].

    order=2 is the reference's ACTUAL DarcyGMG order (DarcyGMG.jl:52-56):
    RT1 x P1disc with alpha = 1e2 (pass graddiv_alpha; 0 defaults to 1e2
    for order 2 since the reference always augments there). Returns
    (x, stats, info) with info {"residual", "problem"} and
    "velocity_error" (order 2) or "pressure_error" (order 1)."""
    dev = resolve_device(device)
    if order == 2:
        from ..fem.rt1 import darcy_rt1_problem, darcy_rt1_solver

        alpha = graddiv_alpha if graddiv_alpha > 0.0 else 1.0e2
        prob = darcy_rt1_problem(ncells, alpha=alpha, dtype=dtype, device=dev)
        solver = darcy_rt1_solver(
            ncells, num_levels=num_levels, alpha=alpha,
            rtol=rtol, maxiter=min(maxiter, 40), dtype=dtype, device=dev,
        )
        state = solver.setup(prob.A)
        x, stats = solver.solve(state, prob.b)
        return x, stats, {
            "residual": prob.residual_norm(x),
            "velocity_error": prob.velocity_error(x[0]),
            "problem": prob,
        }
    assert order == 1
    prob = darcy_problem(ncells, graddiv_alpha=graddiv_alpha, dtype=dtype, device=dev)
    n_p = prob.p_exact.shape[0]
    eye = torch.eye(n_p, dtype=dtype, device=dev)
    if graddiv_alpha > 0.0:
        from ..blocks import BlockTriangularSolver
        from ..fem.hdiv import hdiv_gmg
        from ..linear import FGMRESSolver

        gmg, _, _ = hdiv_gmg(
            ncells, num_levels=num_levels, alpha=graddiv_alpha, dtype=dtype, device=dev
        )
        Mp_pc = DenseMatrix(eye * (-prob.cell_volume / graddiv_alpha))
        P = BlockTriangularSolver(
            solvers=(gmg, JacobiSolver()),
            blocks=((None, None), (None, MatrixBlock(Mp_pc))),
            coeffs=((1.0, 1.0), (0.0, 1.0)),
            half="upper",
        )
        solver = FGMRESSolver(m=20, Pr=P, rtol=rtol, maxiter=maxiter)
    else:
        P = BlockDiagonalSolver(
            solvers=(JacobiSolver(), DenseLUSolver()),
            blocks=(None, MatrixBlock(DenseMatrix(eye * prob.cell_volume))),
        )
        solver = GMRESSolver(m=80, Pr=P, rtol=rtol, maxiter=maxiter)
    state = solver.setup(prob.A)
    x, stats = solver.solve(state, prob.b)
    u, p = x
    return x, stats, {
        "residual": prob.residual_norm(x),
        "pressure_error": prob.pressure_error(p),
        "problem": prob,
    }
