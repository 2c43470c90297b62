"""MINRES with left SPD preconditioning.

Port of `gridapsolvers_tpu/linear/minres.py` (reference
Krylov/MINRESSolvers.jl:11-20,75-149): the classic Paige-Saunders
recurrence, a 3-term preconditioned Lanczos recurrence with Givens QR,
in a Python loop. The recurrence's scalars live on the host: an iteration
reads its two inner products (α and the new β) in one transfer, the one
host sync of an iteration, and the stopping test reads φ̄, the
M^{-1/2}-preconditioned residual norm, from them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..interfaces import LinearSolver, SolverTolerances, make_stats
from ..utils import pytrees as pt


@dataclasses.dataclass(frozen=True)
class MINRESSolver(LinearSolver):
    Pl: Optional[LinearSolver] = None
    maxiter: int = 1000
    atol: float = 1e-12
    rtol: float = 1e-8
    # print the residual of every iteration (reference ConvergenceLog
    # verbose=HIGH); name labels the output
    verbose: bool = False
    name: str = "MINRES"
    depth: int = 0

    @property
    def tols(self) -> SolverTolerances:
        return SolverTolerances(self.maxiter, self.atol, self.rtol)

    def setup(self, A, x=None):
        return {"A": A, "Pl": self.Pl.setup(A, x) if self.Pl is not None else None}

    def update(self, state, A, x=None):
        return {"A": A, "Pl": self.Pl.update(state["Pl"], A, x) if self.Pl is not None else None}

    def solve(self, state, b, x0=None):
        A = state["A"]
        tols = self.tols

        def M_apply(v):
            return self.Pl.apply(state["Pl"], v) if self.Pl else v

        x = pt.zeros_like(b) if x0 is None else x0
        r1 = pt.sub(b, A.matvec(x))
        y = M_apply(r1)
        leaf = pt.tree_leaves(b)[0]
        tiny = torch.finfo(leaf.dtype).tiny
        beta1 = math.sqrt(float(pt.dot(r1, y)))  # host sync
        hist = np.full(tols.maxiter + 1, np.nan)
        hist[0] = beta1
        r2 = r1
        w = w2 = pt.zeros_like(b)
        oldb, beta, dbar, epsln, phibar, cs, sn = 0.0, beta1, 0.0, 0.0, beta1, -1.0, 0.0
        it = 0
        while not tols.finished(it, phibar, beta1):
            v = pt.scale(1.0 / beta, y)
            y = A.matvec(v)
            if it >= 1:
                y = pt.axpy(-(beta / (oldb if oldb != 0 else 1.0)), r1, y)
            alfa_t = pt.dot(v, y)
            y = pt.axpy(-alfa_t / beta, r2, y)
            r1, r2 = r2, y
            y = M_apply(r2)
            # host sync: alpha and the new beta^2 in one transfer
            alfa, beta2 = torch.stack([alfa_t, pt.dot(r2, y)]).cpu().double().tolist()
            oldb, beta = beta, math.sqrt(beta2)

            oldeps = epsln
            delta = cs * dbar + sn * alfa
            gbar = sn * dbar - cs * alfa
            epsln = sn * beta
            dbar = -cs * beta
            gamma = max(math.sqrt(gbar ** 2 + beta ** 2), tiny)
            cs = gbar / gamma
            sn = beta / gamma
            phi = cs * phibar
            phibar = sn * phibar

            w1, w2 = w2, w
            w = pt.scale(1.0 / gamma, pt.sub(pt.sub(v, pt.scale(oldeps, w1)),
                                             pt.scale(delta, w2)))
            x = pt.axpy(phi, w, x)
            hist[it + 1] = phibar
            it += 1
            if self.verbose:
                print(f"{'  ' * self.depth}{self.name}: iteration {it:4d}  r = {phibar:.6e}")
        hist_t = torch.as_tensor(hist, dtype=leaf.dtype).to(leaf.device)
        return x, make_stats(tols, it, phibar, beta1, hist_t)
