"""Geometric multigrid (GMG).

Port of `gridapsolvers_tpu/linear/gmg.py` (reference GMGLinearSolvers.jl):
per-level operators + transfer operators + smoothers + coarsest solver,
with cycle ∈ {v, w, f} (reference gmg_v/w/f_cycle!, :468-610) and
mode ∈ {preconditioner, solver} (reference :612-645). The level recursion
is a Python recursion over the level count; every level operator runs its
own kernel through its `matvec`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Union

import torch

from ..interfaces import (
    LinearSolver,
    Smoother,
    SolverTolerances,
    init_history,
    make_stats,
)
from ..utils import pytrees as pt
from .direct import DenseLUSolver
from .smoothers import JacobiSolver, RichardsonSmoother


def _per_level(spec, nlevels):
    """Broadcast a single smoother/solver spec to a per-level list."""
    if isinstance(spec, (list, tuple)):
        if len(spec) != nlevels:
            raise ValueError(f"need {nlevels} smoothers, got {len(spec)}")
        return list(spec)
    return [spec] * nlevels


@dataclasses.dataclass(frozen=True)
class GMGSolver(LinearSolver):
    """Multigrid preconditioner/solver from per-level operators.

    coarse_ops      : operators for levels 1..L-1 (the finest level's
                      operator comes from setup(A))
    prolongations   : [L-1] ops, level l+1 -> l
    restrictions    : [L-1] ops, level l -> l+1 (residual mode)
    smoother        : Smoother or per-level list (used pre+post unless
                      post_smoother given)
    coarsest_solver : solver for the coarsest level
    """

    coarse_ops: tuple = ()
    prolongations: tuple = ()
    restrictions: tuple = ()
    smoother: Union[Smoother, Sequence[Smoother]] = None
    post_smoother: Optional[Union[Smoother, Sequence[Smoother]]] = None
    coarsest_solver: LinearSolver = dataclasses.field(default_factory=DenseLUSolver)
    cycle: str = "v"
    mode: str = "preconditioner"
    ncycles: int = 1
    maxiter: int = 100
    atol: float = 1e-12
    rtol: float = 1e-8

    def __post_init__(self):
        if self.smoother is None:
            object.__setattr__(
                self, "smoother", RichardsonSmoother(JacobiSolver(), 2, 0.67)
            )
        if self.cycle not in ("v", "w", "f"):
            raise ValueError(f"unknown cycle {self.cycle!r}")
        if self.mode not in ("preconditioner", "solver"):
            raise ValueError(f"unknown mode {self.mode!r}")

    @property
    def tols(self) -> SolverTolerances:
        return SolverTolerances(self.maxiter, self.atol, self.rtol)

    @property
    def num_levels(self) -> int:
        return len(self.prolongations) + 1

    def _smoothers(self):
        L = self.num_levels
        pre = _per_level(self.smoother, L - 1)
        post = _per_level(
            self.post_smoother if self.post_smoother is not None else self.smoother,
            L - 1,
        )
        return pre, post

    def _smoother_states(self, mats, old=None):
        """Smoother states per level: set up, or updated from `old` (a
        GMG state). Without a post_smoother the post smoothers are the
        pre smoothers and share their states, since a second setup would
        repeat the same deterministic work."""
        pre, post = self._smoothers()

        def states(smoothers, key):
            if old is None:
                return [s.setup(m) for s, m in zip(smoothers, mats)]
            return [s.update(st, m) for s, st, m in zip(smoothers, old[key], mats)]

        pre_states = states(pre, "pre")
        if self.post_smoother is None:
            return pre_states, pre_states
        return pre_states, states(post, "post")

    def setup(self, A, x=None):
        mats = [A] + list(self.coarse_ops)
        pre_states, post_states = self._smoother_states(mats)
        return {
            "mats": mats,
            "pre": pre_states,
            "post": post_states,
            "coarse": self.coarsest_solver.setup(mats[-1]),
            "P": tuple(self.prolongations),
            "R": tuple(self.restrictions),
        }

    def update(self, state, A, x=None):
        """Re-setup for a new fine matrix (reference numerical_setup!,
        GMGLinearSolvers.jl:260-297)."""
        mats = [A] + list(self.coarse_ops)
        pre_states, post_states = self._smoother_states(mats, old=state)
        return {
            **state,
            "mats": mats,
            "pre": pre_states,
            "post": post_states,
            "coarse": self.coarsest_solver.update(state["coarse"], mats[-1]),
        }

    # -- cycles ------------------------------------------------------------

    def _cycle(self, state, lev: int, x, r, kind: str):
        """One multigrid cycle at level `lev`, improving x and keeping the
        residual r consistent (the (x, r) smoothing contract). Mirrors
        gmg_v_cycle!/w/f (GMGLinearSolvers.jl:468-610)."""
        mats = state["mats"]
        if lev == self.num_levels - 1:
            dx = self.coarsest_solver.apply(state["coarse"], r)
            return pt.add(x, dx), pt.sub(r, mats[lev].matvec(dx))

        pre, post = self._smoothers()
        x, r = pre[lev].smooth(state["pre"][lev], x, r)
        for sub_kind in {"v": ("v",), "w": ("w", "w"), "f": ("f", "v")}[kind]:
            rH = state["R"][lev].matvec(r)
            dxH, _ = self._cycle(state, lev + 1, pt.zeros_like(rH), rH, sub_kind)
            dx = state["P"][lev].matvec(dxH)
            x = pt.add(x, dx)
            r = pt.sub(r, mats[lev].matvec(dx))
        return post[lev].smooth(state["post"][lev], x, r)

    # -- solver protocol ---------------------------------------------------

    def smooth(self, state, x, r):
        """GMG itself honours the smoothing contract, so it can serve as a
        smoother inside an outer method."""
        for _ in range(self.ncycles):
            x, r = self._cycle(state, 0, x, r, self.cycle)
        return x, r

    def apply(self, state, r):
        x, _ = self.smooth(state, pt.zeros_like(r), r)
        return x

    def solve(self, state, b, x0=None):
        A = state["mats"][0]
        x = pt.zeros_like(b) if x0 is None else x0
        r = pt.sub(b, A.matvec(x))
        if self.mode == "preconditioner":
            x, r = self.smooth(state, x, r)
            return x, None

        tols = self.tols
        rnorm0 = pt.norm(r)
        hist = init_history(tols.maxiter, rnorm0)
        r0 = float(rnorm0)
        rn, it = r0, 0
        while not tols.finished(it, rn, r0):
            x, r = self._cycle(state, 0, x, r, self.cycle)
            rnorm = pt.norm(r)
            hist[it + 1] = rnorm
            it += 1
            rn = float(rnorm)  # host sync: the stopping test
        return x, make_stats(tols, it, rn, r0, hist)


def gmg_from_hierarchy(
    hierarchy,
    assemble: Callable,
    smoother=None,
    coarsest_solver: Optional[LinearSolver] = None,
    cycle: str = "v",
    mode: str = "preconditioner",
    dtype=torch.float64,
    device=None,
    **kw,
) -> GMGSolver:
    """Geometric GMG on a structured-grid hierarchy with rediscretized
    level operators (the GMGLinearSolverFromWeakform linear path,
    GMGLinearSolvers.jl:125-158). assemble(mesh) -> operator for that
    level; the finest operator is the A passed to setup(). `dtype` and
    `device` are those of the transfer masks."""
    from ..multilevel.transfer import setup_transfer_operators

    prolongs, restricts = setup_transfer_operators(
        hierarchy, dtype=dtype, device=device
    )
    return GMGSolver(
        coarse_ops=tuple(assemble(m) for m in hierarchy.meshes[1:]),
        prolongations=tuple(prolongs),
        restrictions=tuple(restricts),
        smoother=smoother,
        coarsest_solver=coarsest_solver or DenseLUSolver(),
        cycle=cycle,
        mode=mode,
        **kw,
    )
