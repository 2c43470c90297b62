"""Patch-corrected transfer operators.

Port of `gridapsolvers_tpu/patches/transfer.py` (reference
PatchProlongationOperator / PatchRestrictionOperator /
BlockJacobiProlongationOperator,
src/PatchBasedSmoothers/PatchTransferOperators.jl:15-31,54-314,
BlockJacobiTransferOperators.jl:4-60): a standard grid transfer augmented
with a subspace correction from local patch solves,

    prolongation:  xh = Ih xH - S_patch(A_h · Ih xH)
    restriction:   rH = R (r - A_h · S_patch r)

where S_patch is the batched overlapping patch solver (matrix-extracted,
so the nonlinear update path is re-extraction only). Patches default to
coarse-cell footprints (topology.coarse_cell_patches, reference
CoarsePatchTopologies.jl).
"""
from __future__ import annotations

import dataclasses

from ..utils import pytrees as pt
from .smoothers import PatchSolver


@dataclasses.dataclass
class PatchProlongation:
    """Wraps a base prolongation with a patch subspace correction.

    Build with `setup_patch_transfers` (needs the fine operator); the
    object is used like any transfer inside GMG. `update(A)` re-extracts
    the patch matrices at a new fine operator (Newton path, reference
    PatchTransferOperators.jl:153-199)."""

    base: object                 # underlying prolongation
    A: object                    # fine-level operator
    solver: object               # PatchSolver, VankaSolver or a materialized one
    state: dict = dataclasses.field(default_factory=dict)
    # optional separate right-hand-side operator (reference lhs/rhs split,
    # PatchTransferOperators.jl:44-52: the local solves use the full lhs
    # biform but the right-hand side applies only e.g. the grad-div term to
    # the interpolant). None: use A.
    rhs_op: object = None

    def matvec(self, xc):
        x0 = self.base.matvec(xc)
        op = self.A if self.rhs_op is None else self.rhs_op
        dx = self.solver.apply(self.state, op.matvec(x0))
        return pt.sub(x0, dx)

    def update(self, A):
        return PatchProlongation(self.base, A, self.solver,
                                 self.solver.update(self.state, A), self.rhs_op)


@dataclasses.dataclass
class PatchRestriction:
    """Dual: patch correction of the residual, then base restriction
    (reference PatchTransferOperators.jl:225-314, reusing the
    prolongation's patch set-up)."""

    base: object
    A: object
    solver: object
    state: dict = dataclasses.field(default_factory=dict)

    def matvec(self, rf):
        dx = self.solver.apply(self.state, rf)
        r = pt.sub(rf, self.A.matvec(dx))
        return self.base.matvec(r)

    def update(self, A):
        return PatchRestriction(self.base, A, self.solver, self.solver.update(self.state, A))


def setup_patch_transfers(prolongations, restrictions, level_ops, level_topos,
                          omega: float = 1.0, spd: bool = True):
    """Augment per-level transfer pairs with patch corrections.

    level_ops   : operators per level (finest first), len L
    level_topos : PatchTopology per FINE level of each pair, len L-1
    Returns (patch_prolongations, patch_restrictions)."""
    Ps, Rs = [], []
    for l, (P, R) in enumerate(zip(prolongations, restrictions)):
        solver = PatchSolver(level_topos[l], omega=omega, weighting="overlap", spd=spd)
        state = solver.setup(level_ops[l])
        Ps.append(PatchProlongation(P, level_ops[l], solver, state))
        Rs.append(PatchRestriction(R, level_ops[l], solver, state))
    return Ps, Rs
