"""L2-projection grid transfer (the reference's :projection transfer
method, GridTransferOperators.jl:242-314).

Port of `gridapsolvers_tpu/multilevel/projection_transfer.py`:

  solution restriction (projection):  u_H = M_H^{-1} P^T M_h u_h

composed from the per-level Q1 mass stencils (`StencilMatrix`, kernel K2),
the full-weighting restriction P^T and a Jacobi-CG mass solve (mass
matrices are spectrally uniform, so a handful of CG iterations is exact to
round-off).
"""
from __future__ import annotations

import dataclasses

import torch

from ..fem.assembly import mass
from ..linear.cg import CGSolver
from ..linear.smoothers import JacobiSolver


@dataclasses.dataclass
class L2ProjectionRestriction:
    """u_H = M_H^{-1} (P^T (M_h u_h)): true L2 projection of a solution
    field to the coarse space (reference :projection mode)."""

    Mh: object          # fine mass operator
    MH_state: dict      # CG state for the coarse mass solve
    adjoint: object     # P^T (StructuredRestriction, residual mode)
    solver: CGSolver

    def matvec(self, u_h):
        w = self.adjoint.matvec(self.Mh.matvec(u_h))
        u_H, _ = self.solver.solve(self.MH_state, w)
        return u_H


def setup_projection_restrictions(hierarchy, dtype=torch.float64, device=None):
    """Per-level-pair L2 projection restrictions (solution mode), mass
    operators in the torch `dtype` on `device`."""
    from .transfer import StructuredRestriction

    out = []
    solver = CGSolver(Pl=JacobiSolver(), rtol=1e-12, maxiter=60)
    for l in range(hierarchy.num_levels - 1):
        fine, coarse = hierarchy[l], hierarchy[l + 1]
        adj = StructuredRestriction(
            fine.vertex_shape, coarse.vertex_shape, "residual", None, None
        )
        out.append(
            L2ProjectionRestriction(
                Mh=mass(fine, dtype, device),
                MH_state=solver.setup(mass(coarse, dtype, device)),
                adjoint=adj,
                solver=solver,
            )
        )
    return out
