"""Poisson entry points: GMG-preconditioned CG on a structured grid.

Port of `gridapsolvers_tpu/models/poisson.py` (reference GMGTests.jl
poisson suite), plus `solve_poisson_const`, the port's twin of the
configuration of the JAX package's flagship step
(`__graft_entry__._build`/`entry`), and `poisson_const_gmg`, its
preconditioner (also in the JAX bench's mixed-precision variant).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..fem import poisson_problem
from ..fem.assembly import eliminate_dirichlet, laplacian, laplacian_const
from ..linear import CGSolver, ChebyshevSmoother, DenseInverseSolver
from ..linear.gmg import gmg_from_hierarchy
from ..multilevel import cartesian_hierarchy


def solve_poisson(
    ncells: Tuple[int, ...],
    num_levels: int = 3,
    rtol: float = 1e-8,
    maxiter: int = 30,
    cycle: str = "v",
    exact: str = "linear",
    dtype=torch.float64,
    device=None,
):
    """Banded operators on every level (kernel K2), Chebyshev(3) smoothing
    with a Lanczos λmax, explicit-inverse coarse solve, CG to `rtol`.
    Returns (x, stats, info) with info
    {"l2_error", "problem", "solver", "state"}."""
    prob = poisson_problem(ncells, exact=exact, dtype=dtype, device=device)
    hierarchy = cartesian_hierarchy(ncells, num_levels)

    def assemble(mesh):
        return eliminate_dirichlet(
            laplacian(mesh, dtype, device), mesh.boundary_vertex_mask()
        )

    gmg = gmg_from_hierarchy(
        hierarchy,
        assemble,
        smoother=ChebyshevSmoother(degree=3),
        coarsest_solver=DenseInverseSolver(),
        cycle=cycle,
        dtype=dtype,
        device=device,
    )
    solver = CGSolver(Pl=gmg, rtol=rtol, maxiter=maxiter)
    state = solver.setup(prob.A)
    x, stats = solver.solve(state, prob.b)
    return x, stats, _info(prob, x, solver, state)


def _info(prob, x, solver, state):
    """The JAX entry points' info dict, plus the solver and its set-up state so
    a caller can repeat or time the solve."""
    return {
        "l2_error": float(prob.l2_error(x)),
        "problem": prob,
        "solver": solver,
        "state": state,
    }


def poisson_const_gmg(
    ncells: Tuple[int, ...],
    num_levels: int,
    degree: int = 3,
    coarsest_solver=None,
    dtype=torch.float32,
    device=None,
    **kw,
):
    """GMG with matrix-free constant stencils on every level (kernel K1)
    and Chebyshev(degree) smoothing with the Gershgorin λmax; the coarse
    solve is dense LU unless `coarsest_solver` is given. `kw` goes to
    GMGSolver: `compute_dtype=torch.bfloat16, mixed=True` makes the JAX
    bench's `gmg_cg_mixed` preconditioner."""
    return gmg_from_hierarchy(
        cartesian_hierarchy(ncells, num_levels),
        lambda mesh: laplacian_const(mesh, dtype, device),
        smoother=ChebyshevSmoother(degree=degree, eig_method="gershgorin"),
        coarsest_solver=coarsest_solver,
        dtype=dtype,
        device=device,
        **kw,
    )


def solve_poisson_const(
    ncells: Tuple[int, ...],
    num_levels: int,
    device=None,
    dtype=torch.float32,
):
    """The flagship configuration: matrix-free constant stencils on every
    level (kernel K1), Chebyshev(3) smoothing with the Gershgorin λmax, the
    default dense-LU coarse solve, CG with rtol 1e-5, atol 0, maxiter 25.
    Returns (x, stats, info) with info
    {"l2_error", "problem", "solver", "state"}."""
    prob = poisson_problem(ncells, dtype=dtype, device=device)
    gmg = poisson_const_gmg(ncells, num_levels, dtype=dtype, device=device)
    solver = CGSolver(Pl=gmg, rtol=1e-5, atol=0.0, maxiter=25)
    state = solver.setup(laplacian_const(prob.mesh, dtype, device))
    x, stats = solver.solve(state, prob.b)
    return x, stats, _info(prob, x, solver, state)
