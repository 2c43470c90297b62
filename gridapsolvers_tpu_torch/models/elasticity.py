"""Elasticity driver: GMG-preconditioned CG on the vector system
(the native replacement for the reference's PETScElasticitySolver,
ext/GridapPETScExt/ElasticitySolvers.jl: KSPCG + GAMG with rigid-body
near-nullspace).

Port of `gridapsolvers_tpu/models/elasticity.py`.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..fem.elasticity import elasticity_gmg, elasticity_problem
from ..linear import CGSolver


def solve_elasticity(
    ncells: Tuple[int, ...],
    num_levels: int = 3,
    mu: float = 1.0,
    lam: float = 1.0,
    rtol: float = 1e-8,
    maxiter: int = 60,
    dtype=torch.float64,
    device=None,
):
    """Clamped cantilever under a unit downward body force, CG + GMG
    (Chebyshev(4, ratio 40), structured Q1 transfers per component).
    Returns (x, stats, info) with info {"residual", "problem"}."""
    prob = elasticity_problem(ncells, mu=mu, lam=lam, dtype=dtype, device=device)
    gmg = elasticity_gmg(ncells, num_levels=num_levels, mu=mu, lam=lam, dtype=dtype,
                         device=device)
    solver = CGSolver(Pl=gmg, rtol=rtol, maxiter=maxiter)
    state = solver.setup(prob.A)
    x, stats = solver.solve(state, prob.b)
    return x, stats, {
        "residual": prob.residual_norm(x),
        "problem": prob,
    }
