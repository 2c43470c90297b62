"""Stokes entry point: FGMRES + upper block-triangular preconditioner with
velocity GMG and pressure mass CG, the reference's headline configuration
(test/Applications/StokesGMG.jl:79-166).

Port of `gridapsolvers_tpu/models/stokes.py`: the plain configuration
(BASELINE config 3) and the augmented-Lagrangian one (`graddiv_alpha > 0`).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..blocks import BlockTriangularSolver, MatrixBlock
from ..fem.stokes import stokes_problem, velocity_gmg
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
    """Stokes solved by FGMRES(40) with the upper block-triangular
    preconditioner, pressure block by Jacobi-CG.

    graddiv_alpha = 0: Taylor-Hood Q2/Q1, velocity GMG with two V-cycles,
    the pressure mass. graddiv_alpha > 0: the reference's augmented-
    Lagrangian configuration (StokesGMG.jl:105-160): Q2/P1disc, the
    grad-div augmented velocity block with patch-smoothed, patch-prolongated
    GMG (block engine, Richardson(10, 0.2) Vanka), coefficients
    ((1, 1), (0, 1)) and the -(1/alpha) Mp pressure block; FGMRES then
    converges in ~10 iterations independent of alpha and h.

    bc='cavity' solves the reference's lid-driven cavity
    (StokesGMG.jl:69-76,93-96); errors against the manufactured solution
    are then not reported. Returns (x, stats, info) with info {"residual",
    "problem", "solver", "state"} and, for bc='mms', "velocity_error" and
    "pressure_error"."""
    prob = stokes_problem(ncells, nu=nu, graddiv_alpha=graddiv_alpha, bc=bc, dtype=dtype,
                          device=device)
    if graddiv_alpha > 0.0:
        gmg = velocity_gmg(ncells, num_levels=num_levels, nu=nu, graddiv_alpha=graddiv_alpha,
                           dtype=dtype, device=device)
        Mp_pc = dataclasses.replace(prob.Mp, values=prob.Mp.values * (-1.0 / graddiv_alpha))
        coeffs = ((1.0, 1.0), (0.0, 1.0))
    else:
        gmg = velocity_gmg(ncells, num_levels=num_levels, nu=nu, ncycles=2, dtype=dtype,
                           device=device)
        Mp_pc, coeffs = prob.Mp, None
    P = BlockTriangularSolver(
        solvers=(gmg, CGSolver(Pl=JacobiSolver(), rtol=1e-8, maxiter=50)),
        blocks=((None, None), (None, MatrixBlock(Mp_pc))),
        coeffs=coeffs,
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
