"""Two-float Newton endgame: push f32 residual floors toward f64.

Port of `gridapsolvers_tpu/nonlinear/refinement.py`. The alpha-scaled
augmented Navier-Stokes residual plateaus in f32: the iterate's f32
representation and the cancelling alpha-scaled matvec sums both
contribute O(||J|| eps32 ||x||). Iterative refinement with a double-f32
iterate and an error-free-transform residual removes that floor:

  x = x_hi + x_lo (two f32 vectors)
  r = R_comp(x_hi (+) x_lo)     compensated matvecs (utils/compensated.py)
  solve J(x_hi) dx = -r          the same f32 preconditioned Krylov solver
  (x_hi, x_lo) <- two_sum renormalized update

The compensated matvecs are plain PyTorch elementwise code, as the JAX
package computes them in XLA outside any Pallas kernel; the inner solve's
operators run their kernels as everywhere else.
"""
from __future__ import annotations

import dataclasses

import torch

from ..utils import pytrees as pt
from ..utils.compensated import comp_ell_matvec, df_add, fast_two_sum, two_sum


def residual_cavity_df(prob, x_hi, x_lo):
    """Compensated cavity Navier-Stokes residual at the two-float iterate.

    The structure of `NavierStokesProblem._residual_cavity`, with every
    alpha-scaled, stiffness and coupling matvec through comp_ell_matvec
    (exact products and slot sums, first-order x_lo term). The convection
    values are assembled at u_hi + u_lo in plain f32: their O(1)
    magnitudes contribute ~eps32 absolutely, far below the alpha-scaled
    floor being removed. Returns an f32 residual (small by construction,
    so its final rounding is harmless)."""
    if getattr(prob, "lift_g", None) is None:
        raise ValueError("residual_cavity_df: cavity problems only")
    (u_hi, p_hi), (u_lo, p_lo) = x_hi, x_lo
    d = len(u_hi)
    u_eval = tuple(ui + li for ui, li in zip(u_hi, u_lo))
    N1, _ = prob._convection_elems(u_eval, newton=False)
    vals = prob.res_vals + prob._scatter(N1, mask=prob.row_mask_ell)
    gd = getattr(prob, "gd_res_vals", None)
    bdry = 1.0 - prob.free_u
    r_u = []
    for a in range(d):
        hi, lo = comp_ell_matvec(vals, prob.cols_ell, u_hi[a], u_lo[a])
        if gd is not None:
            for b in range(d):
                ghi, glo = comp_ell_matvec(gd[a][b], prob.cols_ell, u_hi[b], u_lo[b])
                hi, lo = df_add(hi, lo, ghi, glo)
        BT = prob.BTs[a]
        thi, tlo = comp_ell_matvec(BT.values, BT.cols, p_hi, p_lo)
        hi, lo = df_add(hi, lo, thi, tlo)
        hi, lo = df_add(hi, lo, -prob.f[a])
        # constrained rows: exact (u - g) at two-float precision
        bc_hi, bc_e = two_sum(u_hi[a], -prob.lift_g[a])
        bc_hi, bc_lo = fast_two_sum(bc_hi, bc_e + u_lo[a])
        r_u.append(torch.where(bdry > 0, bc_hi + bc_lo, hi + lo))
    rp_hi = torch.zeros_like(p_hi)
    rp_lo = torch.zeros_like(p_hi)
    for c in range(d):
        B = prob.res_Bs[c]
        bhi, blo = comp_ell_matvec(B.values, B.cols, u_hi[c], u_lo[c])
        rp_hi, rp_lo = df_add(rp_hi, rp_lo, bhi, blo)
    return (tuple(r_u), rp_hi + rp_lo)


def _df_update(x_hi, x_lo, dx):
    """(x_hi, x_lo) + dx with two_sum renormalization, leafwise."""

    def upd(hi, lo, d):
        s, e = two_sum(hi, d)
        return fast_two_sum(s, e + lo)

    out = [upd(h, l, d) for h, l, d in zip(pt.tree_leaves(x_hi), pt.tree_leaves(x_lo),
                                            pt.tree_leaves(dx))]
    return (pt.tree_unflatten(x_hi, [o[0] for o in out]),
            pt.tree_unflatten(x_hi, [o[1] for o in out]))


@dataclasses.dataclass(frozen=True)
class NewtonRefinement:
    """Refinement loop around a converged f32 Newton solve.

    linear: the same preconditioned Krylov solver the Newton loop used (its
    state is refreshed at the refinement iterate through the 3-argument
    update protocol, no new set-up). Returns (x_hi, x_lo, rnorms) with
    rnorms[k] the compensated residual norm after k steps (rnorms[0] the
    entry floor)."""

    linear: object
    niter: int = 3

    def refine(self, prob, x, ls_state):
        """Refine from the f32 iterate x with the linear solver's state
        `ls_state`, on the device where the problem, x and the state live
        (the JAX package's `device=`, a device_put target, has no use here)."""
        x_hi, x_lo = x, pt.zeros_like(x)
        st = ls_state
        r = residual_cavity_df(prob, x_hi, x_lo)
        rnorms = [float(pt.norm(r))]
        for _ in range(self.niter):
            A = prob.jacobian(pt.add(x_hi, x_lo))
            st = self.linear.update(st, A, x_hi)
            dx, _ = self.linear.solve(st, pt.scale(-1.0, r))
            x_hi, x_lo = _df_update(x_hi, x_lo, dx)
            r = residual_cavity_df(prob, x_hi, x_lo)
            rnorms.append(float(pt.norm(r)))
        return x_hi, x_lo, rnorms
