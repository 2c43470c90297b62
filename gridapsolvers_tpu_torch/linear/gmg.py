"""Geometric multigrid (GMG).

Port of `gridapsolvers_tpu/linear/gmg.py` (reference GMGLinearSolvers.jl):
per-level operators + transfer operators + smoothers + coarsest solver,
with cycle ∈ {v, w, f} (reference gmg_v/w/f_cycle!, :468-610) and
mode ∈ {preconditioner, solver} (reference :612-645). The level recursion
is a Python recursion over the level count; every level operator runs its
own kernel through its `matvec`.

`matrices_fn` is the reference's GMGLinearSolverFromWeakform nonlinear
hook (:78-94, 260-297): at setup/update the current iterate is restricted
down the hierarchy by `solution_restrictions` and every level operator is
reassembled from it.

Mixed precision (`compute_dtype`, e.g. torch.bfloat16): with
`mixed=False` the whole cycle runs in `compute_dtype` (the state is cast
down after the full-precision set-up); with `mixed=True` only the smoother
applications do (bf16 twins of the smoother states, `pre16`/`post16`),
while residuals, corrections, transfers and the coarse solve stay in the
working precision. A reduced-precision preconditioner varies slightly
between applications: pair it with CGSolver(flexible=True) or FGMRES.

At `update`, every level operator but the coarsest is refreshed through
`algebra.ell.kernelize_system`, so each ELL leaf keeps its set-up `cols`,
`row_len` and `group` and takes the new values only. `kernelize_levels`
takes the JAX package's values and is otherwise ignored (the refresh
always runs). The JAX package's `kernel_interpret` (Pallas's interpret
mode) has no counterpart: on a CPU tensor an ELL leaf runs its plain
version.
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
from ..algebra.ell import check_kernelize, kernelize_system
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
                      operator comes from setup(A)); alternatively give
                      `matrices_fn`
    prolongations   : [L-1] ops, level l+1 -> l
    restrictions    : [L-1] ops, level l -> l+1 (residual mode)
    smoother        : Smoother or per-level list (used pre+post unless
                      post_smoother given)
    coarsest_solver : solver for the coarsest level
    matrices_fn     : optional (A, x) -> list of L operators, for
                      solution-dependent (Newton) reassembly; overrides
                      coarse_ops
    solution_restrictions : [L-1] solution-mode restrictions that carry the
                      iterate to the coarser levels for `matrices_fn`
                      (reference gmg_project_solutions!)
    compute_dtype, mixed : reduced-precision cycle (module docstring)
    kernelize_levels : the JAX package's values, accepted and ignored
                      (module docstring)
    """

    coarse_ops: Optional[tuple] = None
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
    matrices_fn: Optional[Callable] = None
    solution_restrictions: Optional[tuple] = None
    compute_dtype: Optional[torch.dtype] = None
    mixed: bool = False
    kernelize_levels: str = "off"

    def __post_init__(self):
        if self.smoother is None:
            object.__setattr__(
                self, "smoother", RichardsonSmoother(JacobiSolver(), 2, 0.67)
            )
        if self.cycle not in ("v", "w", "f"):
            raise ValueError(f"unknown cycle {self.cycle!r}")
        if self.mode not in ("preconditioner", "solver"):
            raise ValueError(f"unknown mode {self.mode!r}")
        check_kernelize(self.kernelize_levels)

    @property
    def tols(self) -> SolverTolerances:
        return SolverTolerances(self.maxiter, self.atol, self.rtol)

    @property
    def num_levels(self) -> int:
        return len(self.prolongations) + 1

    def _level_mats(self, A, x, old=None):
        """The level operators at (A, x); given an earlier state's `old`
        operators, every level but the coarsest is `old`'s with the new
        values (kernelize_system)."""
        if self.matrices_fn is not None:
            mats = list(self.matrices_fn(A, x))
        elif self.coarse_ops is None:
            raise ValueError("GMGSolver needs coarse_ops or matrices_fn")
        else:
            mats = [A] + list(self.coarse_ops)
        if old is None:
            return mats
        return [kernelize_system(m, o) for m, o in zip(mats[:-1], old[:-1])] + mats[-1:]

    def _smoothers(self):
        L = self.num_levels
        pre = _per_level(self.smoother, L - 1)
        post = _per_level(
            self.post_smoother if self.post_smoother is not None else self.smoother,
            L - 1,
        )
        return pre, post

    def project_solutions(self, x):
        """Restrict the current iterate to every level (reference
        gmg_project_solutions!, GMGLinearSolvers.jl:299-334)."""
        if x is None or self.solution_restrictions is None:
            return [x] + [None] * (self.num_levels - 1)
        xs = [x]
        for R in self.solution_restrictions:
            xs.append(R.matvec(xs[-1]))
        return xs

    def _smoother_states(self, mats, xs, old=None):
        """Smoother states per level: set up, or updated from `old` (a
        GMG state). Without a post_smoother the post smoothers are the
        pre smoothers and share their states, since a second setup would
        repeat the same deterministic work."""
        pre, post = self._smoothers()

        def states(smoothers, key):
            if old is None:
                return [s.setup(m, xl) for s, m, xl in zip(smoothers, mats, xs)]
            return [s.update(st, m, xl) for s, st, m, xl in zip(smoothers, old[key], mats, xs)]

        pre_states = states(pre, "pre")
        if self.post_smoother is None:
            return pre_states, pre_states
        return pre_states, states(post, "post")

    def reduced_state(self, state):
        """The state's reduced-precision copies: bf16 twins of the smoother
        states (mixed), or the whole state cast down (the factorizations
        above ran in full precision). Shared pre/post states stay shared."""
        cd = self.compute_dtype
        if cd is None:
            return state
        shared = state["post"] is state["pre"]
        if self.mixed:
            pre16 = pt.tree_cast(state["pre"], cd)
            post16 = pre16 if shared else pt.tree_cast(state["post"], cd)
            return {**state, "pre16": pre16, "post16": post16}
        out = pt.tree_cast({k: v for k, v in state.items() if k != "post"}, cd)
        out["post"] = out["pre"] if shared else pt.tree_cast(state["post"], cd)
        return out

    def setup(self, A, x=None):
        mats = self._level_mats(A, x)
        xs = self.project_solutions(x)
        pre_states, post_states = self._smoother_states(mats, xs)
        return self.reduced_state({
            "mats": mats,
            "pre": pre_states,
            "post": post_states,
            "coarse": self.coarsest_solver.setup(mats[-1], xs[-1]),
            "P": tuple(self.prolongations),
            "R": tuple(self.restrictions),
        })

    def update(self, state, A, x=None):
        """Re-setup for a new fine matrix / Newton iterate (reference
        numerical_setup!, GMGLinearSolvers.jl:260-297). Transfers that
        carry operator-dependent state re-extract at the new level
        operators through their `update` (reference
        update_transfer_operator!)."""
        mats = self._level_mats(A, x, state["mats"])
        xs = self.project_solutions(x)
        pre_states, post_states = self._smoother_states(mats, xs, old=state)
        return self.reduced_state({
            "mats": mats,
            "pre": pre_states,
            "post": post_states,
            "coarse": self.coarsest_solver.update(state["coarse"], mats[-1], xs[-1]),
            "P": tuple(p.update(m) if hasattr(p, "update") else p
                       for p, m in zip(state["P"], mats[:-1])),
            "R": tuple(r.update(m) if hasattr(r, "update") else r
                       for r, m in zip(state["R"], mats[:-1])),
        })

    # -- cycles ------------------------------------------------------------

    def _smooth_level(self, smoother, state, key, lev, x, r):
        """One pre or post smoothing at `lev`. mixed: the correction comes
        from a compute_dtype sweep at x = 0 against the residual cast down,
        and the residual is recomputed in full precision (the smoother's
        own reduced-precision residual is discarded)."""
        if not (self.mixed and self.compute_dtype is not None):
            return smoother.smooth(state[key][lev], x, r)
        out_dtype = pt.tree_leaves(r)[0].dtype
        r16 = pt.tree_cast(r, self.compute_dtype)
        dx16, _ = smoother.smooth(state[key + "16"][lev], pt.zeros_like(r16), r16)
        dx = pt.tree_cast(dx16, out_dtype)
        return pt.add(x, dx), pt.sub(r, state["mats"][lev].matvec(dx))

    def _cycle(self, state, lev: int, x, r, kind: str):
        """One multigrid cycle at level `lev`, improving x and keeping the
        residual r consistent (the (x, r) smoothing contract). Mirrors
        gmg_v_cycle!/w/f (GMGLinearSolvers.jl:468-610)."""
        mats = state["mats"]
        if lev == self.num_levels - 1:
            dx = self.coarsest_solver.apply(state["coarse"], r)
            return pt.add(x, dx), pt.sub(r, mats[lev].matvec(dx))

        pre, post = self._smoothers()
        x, r = self._smooth_level(pre[lev], state, "pre", lev, x, r)
        for sub_kind in {"v": ("v",), "w": ("w", "w"), "f": ("f", "v")}[kind]:
            rH = state["R"][lev].matvec(r)
            dxH, _ = self._cycle(state, lev + 1, pt.zeros_like(rH), rH, sub_kind)
            dx = state["P"][lev].matvec(dxH)
            x = pt.add(x, dx)
            r = pt.sub(r, mats[lev].matvec(dx))
        return self._smooth_level(post[lev], state, "post", lev, x, r)

    # -- solver protocol ---------------------------------------------------

    def smooth(self, state, x, r):
        """GMG itself honours the smoothing contract, so it can serve as a
        smoother inside an outer method."""
        for _ in range(self.ncycles):
            x, r = self._cycle(state, 0, x, r, self.cycle)
        return x, r

    def apply(self, state, r):
        if self.compute_dtype is not None and not self.mixed:
            out_dtype = pt.tree_leaves(r)[0].dtype
            r_lo = pt.tree_cast(r, self.compute_dtype)
            x, _ = self.smooth(state, pt.zeros_like(r_lo), r_lo)
            return pt.tree_cast(x, out_dtype)
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
    `device` are those of the transfer masks; `kw` goes to GMGSolver
    (`compute_dtype`, `mixed`, ...)."""
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
