"""GMRES and FGMRES.

Port of `gridapsolvers_tpu/linear/gmres.py` (reference
Krylov/GMRESSolvers.jl:16-29,132-210; Krylov/FGMRESSolvers.jl:17-30,
130-199):

- Restarted GMRES with a fixed restart length m; the basis of a cycle is
  allocated once.
- Orthogonalization is block classical Gram-Schmidt with one
  re-orthogonalization pass (CGS2): all basis dots of a pass are one
  (j+1, n) @ (n,) product against the stacked basis.
- The Givens QR of the Hessenberg column, the residual estimate and the
  final triangular solve are O(m^2) scalar work on the host. An iteration
  reads its Hessenberg column and the new basis norm to the host in one
  transfer; that read is the stopping test, the one host sync of an
  iteration.

FGMRES additionally stores the preconditioned basis Z[j], so the right
preconditioner may change between iterations (GMG with a reduced-precision
smoother, an inner Krylov solve) — reference FGMRESSolvers.jl:58-70.
`AdaptiveGMRESSolver` doubles the restart length on stagnation (the
reference's `expand_krylov_caches!`). `update` refreshes the outer
operator through `algebra.ell.kernelize_system`: its ELL leaves keep their
set-up pattern tensors and take the new values; the preconditioners get
the operator as given. `kernelize` takes the JAX package's values and is
otherwise ignored.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..algebra.ell import check_kernelize, kernelize_system
from ..interfaces import LinearSolver, SolverTolerances, make_stats
from ..utils import pytrees as pt
from .krylov_utils import (
    basis_combine,
    basis_dots,
    basis_get,
    basis_set,
    basis_zeros,
    givens,
    krylov_residual,
)


@dataclasses.dataclass(frozen=True)
class GMRESSolver(LinearSolver):
    """Restarted GMRES with optional left/right preconditioning."""

    m: int = 30
    Pl: Optional[LinearSolver] = None
    Pr: Optional[LinearSolver] = None
    maxiter: int = 1000
    atol: float = 1e-12
    rtol: float = 1e-8
    reorth: bool = True
    flexible: bool = False  # store the Z basis (FGMRES behaviour)
    # print the residual of every iteration (reference ConvergenceLog
    # verbose=HIGH); name labels the output
    verbose: bool = False
    name: str = "GMRES"
    depth: int = 0
    kernelize: str = "off"

    def __post_init__(self):
        check_kernelize(self.kernelize)

    @property
    def tols(self) -> SolverTolerances:
        return SolverTolerances(self.maxiter, self.atol, self.rtol)

    def setup(self, A, x=None):
        return {
            "A": A,
            "Pl": self.Pl.setup(A, x) if self.Pl is not None else None,
            "Pr": self.Pr.setup(A, x) if self.Pr is not None else None,
        }

    def update(self, state, A, x=None):
        return {
            "A": kernelize_system(A, state["A"]),
            "Pl": self.Pl.update(state["Pl"], A, x) if self.Pl is not None else None,
            "Pr": self.Pr.update(state["Pr"], A, x) if self.Pr is not None else None,
        }

    def _cycle(self, state, b, x, it0, r0, hist):
        """One restart cycle from x. Returns (x, it, rnorm)."""
        A = state["A"]
        m = self.m
        tols = self.tols

        def Pl_apply(v):
            return self.Pl.apply(state["Pl"], v) if self.Pl else v

        def Pr_apply(v):
            return self.Pr.apply(state["Pr"], v) if self.Pr else v

        r = krylov_residual(A, Pl_apply, x, b)
        beta_t = pt.norm(r)
        beta = float(beta_t)  # host sync: the cycle's first stopping test
        V = basis_zeros(b, m + 1)
        basis_set(V, 0, pt.scale(1.0 / beta if beta > 0 else 1.0, r))
        Z = basis_zeros(b, m) if self.flexible else None
        H = np.zeros((m + 1, m))
        cs = np.zeros(m)
        sn = np.zeros(m)
        g = np.zeros(m + 1)
        g[0] = beta
        j, it = 0, it0
        while j < m and not tols.finished(it, abs(g[j]), r0):
            zj = Pr_apply(basis_get(V, j))
            if self.flexible:
                basis_set(Z, j, zj)
            w = Pl_apply(A.matvec(zj))
            dots = basis_dots(V, w, j + 1)
            w = pt.sub(w, basis_combine(V, dots, j + 1))
            hcol = dots
            if self.reorth:
                dots2 = basis_dots(V, w, j + 1)
                w = pt.sub(w, basis_combine(V, dots2, j + 1))
                hcol = hcol + dots2
            # host sync: the Hessenberg column and its subdiagonal entry
            col = torch.cat([hcol, pt.norm(w).reshape(1)]).cpu().double().numpy()
            hc, hj1 = col[: j + 1].copy(), float(col[j + 1])
            basis_set(V, j + 1, pt.scale(1.0 / hj1 if hj1 > 0 else 1.0, w))
            # the previous rotations, then the new one
            for k in range(j):
                hc[k], hc[k + 1] = (cs[k] * hc[k] + sn[k] * hc[k + 1],
                                    -sn[k] * hc[k] + cs[k] * hc[k + 1])
            c_new, s_new = givens(hc[j], hj1)
            hc[j] = c_new * hc[j] + s_new * hj1
            cs[j], sn[j] = c_new, s_new
            g[j], g[j + 1] = c_new * g[j], -s_new * g[j]
            H[: j + 1, j] = hc
            hist[it + 1] = abs(g[j + 1])
            j += 1
            it += 1
            if self.verbose:
                print(f"{'  ' * self.depth}{self.name}: iteration {it:4d}  r = {abs(g[j]):.6e}")

        # back substitution on the j x j triangular system R y = g
        y = np.zeros(m)
        for k in range(j - 1, -1, -1):
            num = g[k] - H[k, :] @ y
            y[k] = num / H[k, k] if H[k, k] != 0 else 0.0
        y_t = torch.as_tensor(y, dtype=beta_t.dtype).to(beta_t.device)
        if self.flexible:
            dx = basis_combine(Z, y_t, j)
        else:
            dx = Pr_apply(basis_combine(V, y_t, j))
        return pt.add(x, dx), it, abs(g[j])

    def solve(self, state, b, x0=None):
        A = state["A"]
        tols = self.tols

        def Pl_apply(v):
            return self.Pl.apply(state["Pl"], v) if self.Pl else v

        x = pt.zeros_like(b) if x0 is None else x0
        rnorm0 = pt.norm(krylov_residual(A, Pl_apply, x, b))
        r0 = float(rnorm0)
        hist = np.full(tols.maxiter + 1, np.nan)
        hist[0] = r0
        it, rn = 0, r0
        while not tols.finished(it, rn, r0):
            x, it, rn = self._cycle(state, b, x, it, r0, hist)
        hist_t = torch.as_tensor(hist, dtype=rnorm0.dtype).to(rnorm0.device)
        return x, make_stats(tols, it, rn, r0, hist_t)


def FGMRESSolver(
    m: int = 30,
    Pr: Optional[LinearSolver] = None,
    Pl: Optional[LinearSolver] = None,
    **kw,
) -> GMRESSolver:
    """Flexible GMRES: the right preconditioner may change per iteration
    (reference FGMRESSolvers.jl:17-30). GMRES storing the preconditioned
    basis Z."""
    return GMRESSolver(m=m, Pl=Pl, Pr=Pr, flexible=True, **kw)


@dataclasses.dataclass(frozen=True)
class AdaptiveGMRESSolver(LinearSolver):
    """Restarted GMRES with basis growth on stagnation: the analog of the
    reference's `expand_krylov_caches!` (Krylov/GMRESSolvers.jl:76-92),
    which doubles its Krylov caches whenever the iteration hits the
    allocated basis size without converging. One restart cycle of
    fixed-m GMRES at a time; where a cycle shrinks the residual by less
    than `stall_factor`, m doubles (up to m_max) and the next cycle starts
    from the current iterate."""

    m: int = 10
    m_max: int = 160
    Pl: Optional[LinearSolver] = None
    Pr: Optional[LinearSolver] = None
    maxiter: int = 1000
    atol: float = 1e-12
    rtol: float = 1e-8
    reorth: bool = True
    flexible: bool = False
    stall_factor: float = 0.9  # grow unless a cycle shrinks r by >= 10%
    verbose: bool = False
    name: str = "AdaptiveGMRES"
    depth: int = 0

    def _inner(self, m, maxiter):
        return GMRESSolver(
            m=m, Pl=self.Pl, Pr=self.Pr, maxiter=maxiter,
            atol=self.atol, rtol=self.rtol, reorth=self.reorth,
            flexible=self.flexible, verbose=self.verbose,
            name=self.name, depth=self.depth,
        )

    @property
    def tols(self) -> SolverTolerances:
        return SolverTolerances(self.maxiter, self.atol, self.rtol)

    def setup(self, A, x=None):
        return self._inner(self.m, self.maxiter).setup(A, x)

    def update(self, state, A, x=None):
        return self._inner(self.m, self.maxiter).update(state, A, x)

    def solve(self, state, b, x0=None):
        x = pt.zeros_like(b) if x0 is None else x0
        m = self.m
        total_it = 0
        r0norm = None
        hist_all = []
        rnorm = None
        while total_it < self.maxiter:
            # one restart cycle (maxiter = m)
            x, stats = self._inner(m, m).solve(state, b, x)
            niter = stats.niter
            res = stats.residuals.cpu().numpy()
            if r0norm is None:
                r0norm = float(res[0])
                hist_all.append(r0norm)
            prev = rnorm if rnorm is not None else r0norm
            hist_all.extend(res[1 : niter + 1].tolist())
            rnorm = float(res[min(niter, len(res) - 1)])
            total_it += max(niter, 1)
            if rnorm <= max(self.atol, self.rtol * r0norm):
                break
            if rnorm > self.stall_factor * prev and m < self.m_max:
                m = min(2 * m, self.m_max)  # expand_krylov_caches! analog
        hist = np.full(self.maxiter + 1, np.nan)
        hist[: min(len(hist_all), self.maxiter + 1)] = hist_all[: self.maxiter + 1]
        leaf = pt.tree_leaves(b)[0]
        hist_t = torch.as_tensor(hist, dtype=leaf.dtype).to(leaf.device)
        return x, make_stats(self.tols, min(total_it, self.maxiter), rnorm, r0norm, hist_t)
