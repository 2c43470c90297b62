"""Distributed Stokes: the flagship multi-rank configuration (1-D axis).

Port of the plain half of `gridapsolvers_tpu/fem/dist_stokes.py`. The
reference's headline scalability benchmark is 2D Stokes solved with
FGMRES + upper block-triangular preconditioning (velocity GMG, pressure
mass CG; joss_paper/scalability/src/stokes_gmg.jl). A 1-D process axis is
the (p,) case of the box-partition design of `fem/dist_stokes_nd.py`, so
these entry points are thin delegations that keep a one-axis spelling.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..parallel.mesh import ProcessMesh
from .dist_stokes_nd import (
    dist_pressure_mass_nd,
    dist_velocity_gmg_nd,
    distributed_stokes_solver_nd,
    distributed_stokes_system_nd,
    unshard_stokes_solution_nd,
)


def _ms1(mesh: ProcessMesh, axis: str) -> tuple:
    """1-D box-partition shape from a one-axis process mesh."""
    return (int(mesh.shape[axis]),)


def distributed_stokes_system(ncells, mesh: ProcessMesh, axis: str = "p", nu: float = 1.0,
                              dtype=torch.float64, device=None):
    """Serially assembled Stokes problem sharded over the process axis
    (leading-grid-axis slabs: a 1-D box partition).
    Returns (prob, A_dist, b_dist, part_v, part_p)."""
    return distributed_stokes_system_nd(ncells, mesh, _ms1(mesh, axis), nu=nu, dtype=dtype,
                                        device=device)


def dist_velocity_gmg(ncells, num_levels: int, mesh: ProcessMesh, axis: str = "p", **kw):
    """Sharded GMG for the Stokes velocity block on the 1-D slab
    partition (coarse levels replicated)."""
    gmg, _ = dist_velocity_gmg_nd(ncells, num_levels, mesh, _ms1(mesh, axis), **kw)
    return gmg


def dist_pressure_mass(ncells, mesh: ProcessMesh, axis: str = "p", dtype=torch.float64,
                       device=None):
    """Sharded pressure (Q1) mass matrix aligned with the Stokes layout."""
    return dist_pressure_mass_nd(ncells, mesh, _ms1(mesh, axis), dtype=dtype, device=device)


def distributed_stokes_solver(ncells, num_levels: int, mesh: ProcessMesh, axis: str = "p",
                              nu: float = 1.0, rtol: float = 1e-8, maxiter: int = 60,
                              gmg_kw: Optional[dict] = None, dtype=torch.float64, device=None):
    """The flagship configuration (reference StokesGMG.jl:129-155): FGMRES
    + upper block-triangular P with velocity GMG and Jacobi-CG on the
    pressure mass. Returns (solver, gmg): call solver.setup(A_dist)."""
    return distributed_stokes_solver_nd(ncells, num_levels, mesh, _ms1(mesh, axis), nu=nu,
                                        rtol=rtol, maxiter=maxiter, gmg_kw=gmg_kw, dtype=dtype,
                                        device=device)


def unshard_stokes_solution(x, ncells, mesh: ProcessMesh, n_u: int, n_p: int, axis: str = "p",
                            pressure: str = "q1"):
    """Sharded block solution -> host ((u_x, ...), p) in global order."""
    return unshard_stokes_solution_nd(x, ncells, _ms1(mesh, axis), n_u, n_p, pressure=pressure)
