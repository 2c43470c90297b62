"""Stokes entry point: FGMRES + upper block-triangular preconditioner with
velocity GMG and pressure mass CG, the reference's headline configuration
(test/Applications/StokesGMG.jl:79-166).

Port of `gridapsolvers_tpu/models/stokes.py`, the plain configuration
(BASELINE config 3). The augmented-Lagrangian configuration
(`graddiv_alpha > 0`) comes with slice 3b.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..blocks import BlockTriangularSolver, MatrixBlock
from ..fem.stokes import _not_ported, stokes_problem, velocity_gmg
from ..linear import CGSolver, FGMRESSolver, JacobiSolver


def solve_stokes(
    ncells: Tuple[int, ...],
    num_levels: int = 3,
    nu: float = 1.0,
    rtol: float = 1e-9,
    maxiter: int = 120,
    graddiv_alpha: float = 0.0,
    bc: str = "mms",
    dtype=torch.float64,
    device=None,
):
    """Taylor-Hood Q2/Q1 Stokes solved by FGMRES(40) with the upper
    block-triangular preconditioner (velocity GMG with two V-cycles,
    pressure mass by Jacobi-CG). bc='cavity' solves the reference's
    lid-driven cavity (StokesGMG.jl:69-76,93-96); errors against the
    manufactured solution are then not reported. Returns (x, stats, info)
    with info {"residual", "problem", "solver", "state"} and, for
    bc='mms', "velocity_error" and "pressure_error"."""
    if graddiv_alpha > 0.0:
        raise _not_ported("solve_stokes(graddiv_alpha > 0)")
    prob = stokes_problem(ncells, nu=nu, bc=bc, dtype=dtype, device=device)
    gmg = velocity_gmg(ncells, num_levels=num_levels, nu=nu, ncycles=2, dtype=dtype,
                       device=device)
    P = BlockTriangularSolver(
        solvers=(gmg, CGSolver(Pl=JacobiSolver(), rtol=1e-8, maxiter=50)),
        blocks=((None, None), (None, MatrixBlock(prob.Mp))),
        half="upper",
    )
    solver = FGMRESSolver(m=40, Pr=P, rtol=rtol, maxiter=maxiter)
    state = solver.setup(prob.A)
    x, stats = solver.solve(state, prob.b)
    u, p = x
    info = {"residual": prob.residual_norm(x), "problem": prob, "solver": solver,
            "state": state}
    if prob.u_exact is not None:
        info["velocity_error"] = prob.velocity_error(u)
        info["pressure_error"] = prob.pressure_error(p)
    return x, stats, info
