"""Preconditioned Conjugate Gradient.

Port of `gridapsolvers_tpu/linear/cg.py` (reference CGSolvers.jl:10-23,
73-138). The JAX `lax.while_loop` becomes a Python loop; the stopping test
reads the residual norm to the host once per iteration (the one host sync
of an iteration). On sharded vectors an iteration makes two all-reduces:
<p, A p>, then <r, z> and ||r||² together (`pt.dots`). Supports:
  - flexible CG (Polak-Ribière beta, reference CGSolvers.jl:93-100),
  - Lanczos diagnostics: the (alpha, beta) histories that define the
    Lanczos tridiagonal for condition-number estimation (reference
    Krylov/KrylovUtils.jl:58-90), post-processed by `condition_estimate`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..interfaces import (
    LinearSolver,
    SolverStats,
    SolverTolerances,
    init_history,
    make_stats,
)
from ..utils import pytrees as pt


@dataclasses.dataclass(frozen=True)
class CGSolver(LinearSolver):
    Pl: Optional[LinearSolver] = None
    maxiter: int = 1000
    atol: float = 1e-12
    rtol: float = 1e-8
    flexible: bool = False
    lanczos: bool = False
    # print the residual of every iteration (reference ConvergenceLog
    # verbose=HIGH); name labels the output
    verbose: bool = False
    name: str = "CG"
    depth: int = 0

    @property
    def tols(self) -> SolverTolerances:
        return SolverTolerances(self.maxiter, self.atol, self.rtol)

    def setup(self, A, x=None):
        pl_state = self.Pl.setup(A, x) if self.Pl is not None else None
        return {"A": A, "Pl": pl_state}

    def update(self, state, A, x=None):
        pl_state = self.Pl.update(state["Pl"], A, x) if self.Pl is not None else None
        return {"A": A, "Pl": pl_state}

    def solve(self, state, b, x0=None):
        A = state["A"]
        tols = self.tols

        def precond(r):
            if self.Pl is None:
                return r
            return self.Pl.apply(state["Pl"], r)

        x = pt.zeros_like(b) if x0 is None else x0
        r = pt.sub(b, A.matvec(x))
        z = precond(r)
        p = z
        # one reduction (one all-reduce on sharded vectors) for both
        gamma, rr = pt.dots((r, z), (r, r))
        rnorm0 = torch.sqrt(rr)
        hist = init_history(tols.maxiter, rnorm0)
        alphas = torch.zeros((tols.maxiter,), dtype=rnorm0.dtype, device=rnorm0.device)
        betas = torch.zeros_like(alphas)

        r0 = float(rnorm0)
        rn = r0
        it = 0
        while not tols.finished(it, rn, r0):
            w = A.matvec(p)
            alpha = gamma / pt.dot(p, w)
            x = pt.axpy(alpha, p, x)
            r_new = pt.axpy(-alpha, w, r)
            z_new = precond(r_new)
            if self.flexible:
                # Polak-Ribière: beta = z_new · (r_new - r) / gamma
                gamma_new, zr, rr = pt.dots((r_new, z_new), (z_new, r), (r_new, r_new))
                beta = (gamma_new - zr) / gamma
            else:
                gamma_new, rr = pt.dots((r_new, z_new), (r_new, r_new))
                beta = gamma_new / gamma
            p = pt.axpy(beta, p, z_new)
            rnorm = torch.sqrt(rr)
            hist[it + 1] = rnorm
            alphas[it] = alpha
            betas[it] = beta
            r, z, gamma = r_new, z_new, gamma_new
            it += 1
            rn = float(rnorm)  # host sync: the stopping test
            if self.verbose:
                print(f"{'  ' * self.depth}{self.name}: iteration {it:4d}  r = {rn:.6e}")
        stats = make_stats(tols, it, rn, r0, hist)
        stats.extra = {"alphas": alphas, "betas": betas} if self.lanczos else None
        return x, stats


def condition_estimate(stats: SolverStats) -> float:
    """Condition-number estimate from the CG Lanczos tridiagonal
    (host-side; reference KrylovUtils.jl:58-90 builds SymTridiagonal(δ, γ)
    and takes extreme eigenvalues)."""
    import scipy.linalg as sla

    if stats.extra is None:
        raise ValueError("run CGSolver(lanczos=True)")
    k = int(stats.niter)
    alphas = stats.extra["alphas"].cpu().numpy()[:k]
    betas = stats.extra["betas"].cpu().numpy()[:k]
    if k == 0:
        return 1.0
    # delta_1 = 1/alpha_1 ; delta_j = 1/alpha_j + beta_{j-1}/alpha_{j-1}
    # gamma_j = sqrt(beta_j)/alpha_j
    delta = np.empty(k)
    delta[0] = 1.0 / alphas[0]
    for j in range(1, k):
        delta[j] = 1.0 / alphas[j] + betas[j - 1] / alphas[j - 1]
    off = np.sqrt(np.maximum(betas[: k - 1], 0.0)) / alphas[: k - 1]
    ev = sla.eigh_tridiagonal(delta, off, eigvals_only=True)
    ev = ev[ev > 0]
    return float(ev.max() / ev.min()) if len(ev) else 1.0
