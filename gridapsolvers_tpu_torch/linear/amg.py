"""Algebraic multigrid (smoothed aggregation).

Port of `gridapsolvers_tpu/linear/amg.py` (the reference's PETSc GAMG
usage: coarse solves in the scalability study, elasticity AMG): when no
geometric hierarchy is available, build one algebraically.

Set-up (host, scipy), copied from the JAX package as it is: strength
graph -> aggregation -> tentative piecewise-constant prolongation
(optionally with near-nullspace candidate vectors) -> Jacobi-smoothed P ->
Galerkin coarse operator P^T A P, recursing until the coarse system is
small enough to invert densely.

Solve (device): a V-cycle with Chebyshev smoothing. The level operators
1..L-1 and every P and R are `ELLMatrix`es, so each of their applies runs
kernel K3 on the card; a `StencilMatrix` system stays the finest cycle
operator (kernel K2). The smoothers are set up directly on the cycle
operators, so level 0's Lanczos runs on the stencil.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..algebra.convert import to_scipy
from ..algebra.ell import ell_from_scipy
from ..algebra.stencil import StencilMatrix
from ..interfaces import LinearSolver
from ..utils import pytrees as pt
from .direct import DenseInverseSolver
from .smoothers import ChebyshevSmoother


def _strength_graph(S: sp.csr_matrix, theta: float) -> sp.csr_matrix:
    """Symmetric strength-of-connection: keep |a_ij| >= theta *
    sqrt(|a_ii a_jj|) (Vanek SA criterion), PLUS a per-row rescue that
    always keeps edges within 2x of the row's strongest off-diagonal.

    The rescue matters on perfectly isotropic operators: the 3D Q1 hex
    Laplacian has EVERY off-diagonal at |a_ij|/sqrt(a_ii a_jj) = 1/16 —
    just under the standard theta=0.08 — so the bare criterion returns an
    EMPTY graph, aggregation degenerates to singletons and the coarsening
    ratio collapses (measured: 1.16x/level instead of ~8x on 17^3
    Poisson). Keeping each row's near-maximal edges guarantees the graph
    stays connected wherever the matrix is, while anisotropic filtering
    (the criterion's purpose) is unaffected: weak-direction edges are far
    below half the strong-direction maximum."""
    d = np.abs(S.diagonal())
    d[d == 0] = 1.0
    C = S.tocoo()
    off = C.row != C.col
    absdata = np.abs(C.data)
    rowmax = np.zeros(S.shape[0])
    np.maximum.at(rowmax, C.row[off], absdata[off])
    keep = absdata >= theta * np.sqrt(d[C.row] * d[C.col])
    keep |= absdata >= 0.5 * rowmax[C.row]
    keep &= off
    keep &= absdata > 0
    return sp.csr_matrix(
        (np.ones(keep.sum()), (C.row[keep], C.col[keep])), shape=S.shape
    )

@dataclasses.dataclass(frozen=True, eq=False)
class _HostPattern:
    """Host-side aggregation pattern (tentative-P matrices) carried inside
    the state, not on the frozen solver instance, so two systems sharing
    one AMGSolver do not cross-contaminate."""

    P0s: tuple  # scipy tentative prolongations, finest -> coarsest


def _row_max(C: sp.csr_matrix, vals: np.ndarray) -> np.ndarray:
    """Per-row max of vals over the column pattern (vectorized)."""
    counts = np.diff(C.indptr)
    out = np.full(C.shape[0], -np.inf)
    if C.nnz == 0:
        return out
    rows = np.repeat(np.arange(C.shape[0]), counts)
    np.maximum.at(out, rows, vals[C.indices])
    return out


def _match_pass(W: sp.csr_matrix, seed: int = 0) -> np.ndarray:
    """One round of mutual matching on a weighted graph (vectorized
    pairwise aggregation): each node proposes along its highest-priority
    STRONG edge (weight >= half the row max); mutual proposals merge.

    Priorities are random PER (undirected) EDGE, not per node: an edge
    that is locally maximal at both endpoints is always mutual, so a
    constant fraction of nodes matches every pass (~40-50% measured).
    Random node priorities fail here — every neighbor of a high-priority
    node proposes to IT, and it reciprocates only one of them (~2%
    matched per pass measured on contracted Poisson graphs); heaviest-
    edge proposals fail the same way by chaining along weight gradients.
    Returns the node->group map (compacted, contiguous ids)."""
    n = W.shape[0]
    counts = np.diff(W.indptr)
    rows = np.repeat(np.arange(n), counts)
    data = np.abs(W.data)
    row_max = np.zeros(n)
    np.maximum.at(row_max, rows, data)
    strong = data >= 0.5 * row_max[rows]
    cols = W.indices.astype(np.int64)
    # deterministic symmetric per-edge priority: hash the unordered pair
    # (same value for (i,j) and (j,i)), mixed with the pass seed
    lo = np.minimum(rows, cols)
    hi = np.maximum(rows, cols)
    key = (lo * n + hi + np.int64(seed) * np.int64(0x9E3779B1)).astype(
        np.uint64
    )
    key = (key ^ (key >> 33)) * np.uint64(0xFF51AFD7ED558CCD)
    key = (key ^ (key >> 33)) * np.uint64(0xC4CEB9FE1A85EC53)
    eprio = (key ^ (key >> 33)).astype(np.float64)
    best = np.full(n, -1, dtype=np.int64)
    best_p = np.full(n, -1.0)
    np.maximum.at(best_p, rows[strong], eprio[strong])
    # recover the argmax: entries whose edge priority equals row best
    sel = strong.copy()
    sel[strong] = eprio[strong] >= best_p[rows[strong]]
    np.maximum.at(best, rows[sel], cols[sel])
    best[best < 0] = np.where(best < 0)[0]  # isolated -> self
    mutual = (best != np.arange(n)) & (best[best] == np.arange(n))
    canon = np.arange(n)
    canon[mutual] = np.minimum(np.arange(n)[mutual], best[mutual])
    # compact ids
    uniq, out = np.unique(canon, return_inverse=True)
    return out


def _aggregate_target(
    C: sp.csr_matrix, W: sp.csr_matrix, target: float
) -> np.ndarray:
    """Aggregation with a controlled coarsening ratio: a Luby MIS pass
    (distance-1 aggregates, ~3-5x) composed with pairwise matching passes
    on the contracted weighted graph until aggregates reach ~`target`
    nodes. Single-pass MIS coarsens slower than smoothed-aggregation
    fill-in grows, which densifies coarse operators catastrophically;
    ~8x per level keeps the Galerkin stencils bounded (the same reason
    PETSc GAMG squares its graph and AGMG composes pairwise passes)."""
    n = C.shape[0]
    agg = _aggregate(C)
    # Diagonal-only rows (Dirichlet identity rows kept in the system by
    # framework convention) have no graph edges: left as singletons they
    # FREEZE coarsening once they dominate a coarse level (e.g. 256 of
    # 293 dofs on a 64x64 Poisson L2). Bucket them into ~target-size
    # aggregates — A is diagonal there, so Galerkin stays diagonal and
    # any diagonal smoother solves them exactly; grouping is free.
    iso = np.diff(W.indptr) == 0
    if iso.any():
        ids = np.where(iso)[0]
        # CONSECUTIVE ids per bucket (// size, not % nbuckets): ids are
        # sorted, so round-robin would scatter each bucket across the
        # whole boundary — every bucket's mean position collapses to the
        # center and the position-renumbered coarse operator loses its
        # bandedness (and P0 rows their locality)
        agg = agg.copy()
        agg[ids] = int(agg.max()) + 1 + (
            np.arange(len(ids)) // int(max(target, 2))
        )
        _, agg = np.unique(agg, return_inverse=True)
    for it in range(8):
        na = int(agg.max()) + 1
        if na <= 1 or n / na >= target:
            break
        sizes = np.bincount(agg, minlength=na).astype(np.float64)
        Q = sp.csr_matrix(
            (np.ones(n), (np.arange(n), agg)), shape=(n, na)
        )
        Wc = (Q.T @ W @ Q).tocsr()
        Wc.setdiag(0)
        Wc.eliminate_zeros()
        # SIZE-NORMALIZED coupling + a hard pair-size cap: raw contracted
        # weights scale with the shared boundary, so big aggregates
        # out-prioritize small ones and matching compounds them into
        # mega-aggregates (measured 24^3: sizes p50=3, max=177) — giants
        # then blow padded-ELL widths of R and the Galerkin stencil.
        # Normalizing by |A||B| ranks edges by per-node coupling; the cap
        # keeps every merge below 2*target.
        coo = Wc.tocoo()
        wdat = coo.data / (sizes[coo.row] * sizes[coo.col])
        wdat = wdat * (sizes[coo.row] + sizes[coo.col] <= 2 * target)
        Wn = sp.csr_matrix(
            (wdat, (coo.row, coo.col)), shape=Wc.shape
        )
        Wn.eliminate_zeros()
        m = _match_pass(Wn, seed=it)
        if int(m.max()) + 1 == na:
            # no mutual pairs under the cap — drop the cap (still
            # normalized) for guaranteed progress on connected graphs
            wdat = coo.data / (sizes[coo.row] * sizes[coo.col])
            Wn = sp.csr_matrix(
                (wdat, (coo.row, coo.col)), shape=Wc.shape
            )
            m = _match_pass(Wn, seed=it + 17)
            if int(m.max()) + 1 >= na:
                break  # genuinely disconnected
        agg = m[agg]
    return agg


def _rowcap(
    M: sp.csr_matrix, cap: int, keep_diag: bool
) -> sp.csr_matrix:
    """Cap every row at its `cap` largest-|.| entries (vectorized top-k
    over a padded array). Dropped mass is LUMPED back: onto the diagonal
    for square operators (keep_diag — preserves row sums, hence the
    action on constants), onto the largest kept entry for transfers
    (preserves interpolation of constants without assuming a diagonal).

    Why: padded-ELL storage pays for the WIDEST row; smoothed-aggregation
    levels/transfers have p95 widths ~5x below their max (a few
    mega-aggregate rows from MIS-escalation passes), so the tail alone
    multiplies stored traffic (measured 24^3 Poisson: R0 max 609 vs p95
    135). PETSc GAMG filters the same way (-pc_gamg_filter)."""
    M = M.tocsr()
    w = np.diff(M.indptr)
    if w.max() <= cap:
        return M
    n = M.shape[0]
    maxw = int(w.max())
    rows = np.repeat(np.arange(n), w)
    pos = np.arange(M.nnz) - np.repeat(M.indptr[:-1], w)
    vals = np.zeros((n, maxw), dtype=M.data.dtype)
    cols = np.full((n, maxw), -1, dtype=np.int64)
    vals[rows, pos] = M.data
    cols[rows, pos] = M.indices
    key = np.abs(vals)
    key[cols < 0] = -1.0
    if keep_diag:
        key[cols == np.arange(n)[:, None]] = np.inf
    # top-`cap` per row
    idx = np.argpartition(-key, cap - 1, axis=1)[:, :cap]
    keepmask = np.zeros((n, maxw), dtype=bool)
    np.put_along_axis(keepmask, idx, True, axis=1)
    keepmask &= cols >= 0
    if keep_diag:
        # SQUARE operators must stay symmetric after capping (the AMG
        # V-cycle preconditions CG): intersect the kept pattern with its
        # transpose, take ORIGINAL values there, lump the symmetric
        # remainder onto the diagonal (row sums -> action on constants
        # preserved; symmetric drop -> symmetric lump)
        rr, cc = np.nonzero(keepmask)
        patt = sp.csr_matrix(
            (np.ones(len(rr), dtype=np.int8), (rr, cols[rr, cc])),
            shape=M.shape,
        )
        patt = patt.multiply(patt.T)  # AND with transpose
        patt = (patt + sp.eye(n, dtype=np.int8, format="csr")).astype(
            bool
        )
        out = M.multiply(patt).tocsr()
        lump = np.asarray((M - out).sum(axis=1)).ravel()
        return (out + sp.diags(lump)).tocsr()
    dropped = np.where(keepmask, 0.0, vals).sum(axis=1)
    big = np.argmax(np.where(keepmask, np.abs(vals), -1.0), axis=1)
    vals[np.arange(n), big] += dropped
    out_counts = keepmask.sum(axis=1)
    indptr = np.concatenate([[0], np.cumsum(out_counts)])
    rr, cc = np.nonzero(keepmask)
    return sp.csr_matrix(
        (vals[rr, cc], cols[rr, cc], indptr), shape=M.shape
    )


def _cap_p98(M: sp.csr_matrix, keep_diag: bool) -> sp.csr_matrix:
    """p98 width-tail cap (shared by the serial and distributed
    packers)."""
    w = np.diff(M.tocsr().indptr)
    cap = max(8, int(np.percentile(w, 98)))
    return _rowcap(M, cap, keep_diag)


def _cap_transfer(P: sp.csr_matrix) -> sp.csr_matrix:
    """Width-tail cap for a smoothed prolongation: cap P's rows (fine
    side), then P^T's rows (bounding coarse-row widths of R = P^T).
    MUST be applied BEFORE the Galerkin triple product (PETSc GAMG's
    truncate-then-RAP): capping P after the levels are built leaves the
    transfers inconsistent with the level operators, which measurably
    degrades the V-cycle (AMS node-AMG at alpha=100: 26 -> 74 CG
    iterations when the cap was applied post-hoc in _pack_state)."""
    return _cap_p98(_cap_p98(P, False).T.tocsr(), False).T.tocsr()


def _filtered(Ac: sp.csr_matrix, theta: float) -> sp.csr_matrix:
    """Strength-filtered matrix for prolongation smoothing: weak
    off-diagonals are dropped and LUMPED onto the diagonal (preserving
    the action on constants — the near-nullspace SA must interpolate
    exactly). Smoothing P with the full matrix spreads every tentative
    column over the complete stencil, and the Galerkin triple product
    then densifies catastrophically at depth (measured: 494 nnz/row on
    level 2 of a 24^3 Poisson, costlier than the fine SpMV); filtering
    is the standard SA fill-control (PyAMG's `filter_entries`, PETSc
    GAMG's threshold-filtered smoothing)."""
    C = _strength_graph(Ac, theta)
    patt = C.copy()
    patt.data = np.ones_like(patt.data)
    AF = Ac.multiply(patt).tocsr()
    lump = np.asarray((Ac - AF).sum(axis=1)).ravel()
    AF = (AF + sp.diags(lump)).tocsr()
    return AF


def _aggregate(C: sp.csr_matrix, seed: int = 0) -> np.ndarray:
    """Vectorized MIS-style aggregation (no Python row loops — usable at
    1e6+ dofs, unlike the reference's per-row PETSc-side loops we replace):

    rounds of Luby's maximal-independent-set over the strength graph pick
    seed nodes (locally-maximal random priority among unaggregated
    neighbors); each seed absorbs its unaggregated neighborhood. Leftovers
    attach to an adjacent aggregate; isolated nodes become singletons."""
    n = C.shape[0]
    rng = np.random.default_rng(seed)
    prio = rng.permutation(n).astype(np.float64) + 1.0  # > 0
    agg = -np.ones(n, dtype=np.int64)
    na = 0
    for _ in range(64):  # O(log n) rounds suffice; bound defensively
        un = agg < 0
        if not un.any():
            break
        # neighbor max priority among unaggregated nodes
        nb_prio = _row_max(C, np.where(un, prio, -np.inf))
        seeds = un & (prio > nb_prio)  # incl. isolated (nb = -inf)
        if not seeds.any():
            break
        ids = np.where(seeds)[0]
        agg[ids] = na + np.arange(len(ids))
        # absorb unaggregated neighbors: max (agg id + 1) over seed nbrs
        seed_tag = np.where(seeds, agg + 1.0, 0.0)
        grab = _row_max(C, seed_tag)
        take = (agg < 0) & (grab > 0)
        agg[take] = grab[take].astype(np.int64) - 1
        na += len(ids)
    # attach leftovers to any adjacent aggregate
    for _ in range(4):
        un = agg < 0
        if not un.any():
            break
        tag = _row_max(C, np.where(agg >= 0, agg + 1.0, 0.0))
        take = un & (tag > 0)
        agg[take] = tag[take].astype(np.int64) - 1
    # isolated leftovers become singletons
    un = np.where(agg < 0)[0]
    agg[un] = na + np.arange(len(un))
    return agg


def _tentative_prolongation(
    agg: np.ndarray, candidates: Optional[np.ndarray]
) -> sp.csr_matrix:
    """P0 from aggregates; with k candidate vectors the coarse space gets
    up to k dofs per aggregate (per-aggregate orthonormalization,
    GAMG-style). Fully vectorized: the per-aggregate Gram-Schmidt runs as
    k^2 segment reductions (bincount) instead of a Python QR loop."""
    n = len(agg)
    na = int(agg.max()) + 1
    if candidates is None:
        return sp.csr_matrix(
            (np.ones(n), (np.arange(n), agg)), shape=(n, na)
        )
    B = np.array(candidates, dtype=np.float64)
    k = B.shape[1]
    keep = np.ones((na, k), dtype=bool)
    for j in range(k):
        # project out previous (normalized) columns, segment-wise
        for i in range(j):
            dots = np.bincount(agg, weights=B[:, i] * B[:, j], minlength=na)
            B[:, j] -= dots[agg] * B[:, i]
        nrm2 = np.bincount(agg, weights=B[:, j] ** 2, minlength=na)
        ok = nrm2 > 1e-20
        keep[:, j] = ok
        inv = np.where(ok, 1.0 / np.sqrt(np.maximum(nrm2, 1e-300)), 0.0)
        B[:, j] *= inv[agg]
    # compact coarse columns: aggregate a, candidate j -> coarse dof
    col_of = -np.ones((na, k), dtype=np.int64)
    col_of[keep] = np.arange(int(keep.sum()))
    rows = np.repeat(np.arange(n), k)
    cols = col_of[agg].reshape(-1)
    vals = B.reshape(-1)
    m = cols >= 0
    return sp.csr_matrix(
        (vals[m], (rows[m], cols[m])), shape=(n, int(keep.sum()))
    )


@dataclasses.dataclass(frozen=True)
class AMGSolver(LinearSolver):
    """Smoothed-aggregation AMG preconditioner/solver. The state's level
    operators and transfers live on the system operator's device."""

    theta: float = 0.08
    omega: float = 0.57  # 4/7-ish Jacobi smoothing weight for P
    max_levels: int = 10
    coarse_size: int = 400
    coarsen_ratio: float = 8.0  # target nodes per aggregate
    smoother: object = None
    near_nullspace: Optional[object] = None  # (n, k) candidate vectors
    ncycles: int = 1

    def _smoother(self):
        return self.smoother or ChebyshevSmoother(degree=3)

    def _smoothed_prolongation(self, Ac, P0):
        """Jacobi-smoothed, width-capped P from the tentative P0. The
        filter uses the undecayed theta: the per-row strongest-edge rescue
        in _strength_graph already keeps the graph connected, and a
        decayed filter threshold re-densifies coarse levels."""
        AF = _filtered(Ac, self.theta)
        Dinv = sp.diags(1.0 / AF.diagonal())
        return _cap_transfer((P0 - self.omega * (Dinv @ (AF @ P0))).tocsr())

    def _build(self, A):
        S = to_scipy(A).tocsr()
        candidates = (
            np.asarray(self.near_nullspace)
            if self.near_nullspace is not None
            else None
        )
        mats_sp: List[sp.csr_matrix] = [S]
        Ps: List[sp.csr_matrix] = []
        P0s: List[sp.csr_matrix] = []
        while (
            mats_sp[-1].shape[0] > self.coarse_size
            and len(mats_sp) < self.max_levels
        ):
            Ac = mats_sp[-1]
            # theta decays with depth (GAMG-style): coarse Galerkin
            # operators have genuinely weaker off-diagonals and a fixed
            # threshold disconnects them
            theta_l = self.theta * (0.5 ** (len(mats_sp) - 1))
            C = _strength_graph(Ac, theta_l)
            W = Ac.copy().tocsr()
            W.setdiag(0)
            W.eliminate_zeros()
            W.data = np.abs(W.data)  # mixed-sign entries cancel under
            # graph contraction (Q^T W Q) and fake disconnection
            agg = _aggregate_target(C, W, self.coarsen_ratio)
            # renumber aggregates by mean fine-node index: keeps Galerkin
            # coarse operators banded in a bandwidth-preserving dof order
            nagg = int(agg.max()) + 1
            mean_pos = np.bincount(
                agg, weights=np.arange(agg.shape[0]), minlength=nagg
            ) / np.maximum(np.bincount(agg, minlength=nagg), 1)
            perm = np.empty(nagg, dtype=agg.dtype)
            perm[np.argsort(mean_pos, kind="stable")] = np.arange(nagg)
            agg = perm[agg]
            P0 = _tentative_prolongation(agg, candidates)
            P = self._smoothed_prolongation(Ac, P0)
            Anew = (P.T @ Ac @ P).tocsr()
            if Anew.shape[0] >= 0.67 * Ac.shape[0]:
                break  # coarsening stalled (graph disconnecting): the
                # dense coarse solver takes what is left
            Ps.append(P)
            P0s.append(P0)
            mats_sp.append(Anew)
            # candidate vectors steer only the finest aggregation (the
            # GAMG near-nullspace hook); coarser levels use constants
            candidates = None
        if mats_sp[-1].shape[0] > max(8192, 4 * self.coarse_size):
            # refuse to densify a barely-coarsened level: the dense
            # inverse would allocate O(n^2)
            raise ValueError(
                f"AMG coarsening stalled at n={mats_sp[-1].shape[0]} "
                f"(coarse_size={self.coarse_size}); the coarsest level is "
                "too large to factorize densely — check the strength "
                "graph/aggregation or raise max_levels"
            )
        return mats_sp, Ps, P0s

    def _pack_state(self, mats_sp, Ps, A):
        """Device state from the host hierarchy. Level operators and
        transfers are ELL in the system's dtype (the scipy Galerkin
        products promote to f64); levels 1.. are width-capped before the
        conversion (padded ELL pays for the widest row), transfers arrive
        capped from `_smoothed_prolongation`, and R is the capped P
        transposed (V-cycle symmetry, which CG needs). A StencilMatrix
        system stays the finest cycle operator."""
        vdt, dev = A.dtype, A.device
        mats_sp = [mats_sp[0]] + [_cap_p98(m, True) for m in mats_sp[1:]]
        keep_stencil = len(mats_sp) > 1 and isinstance(A, StencilMatrix)
        mats = [A if lev == 0 and keep_stencil else ell_from_scipy(m, dtype=vdt, device=dev)
                for lev, m in enumerate(mats_sp)]
        sm = self._smoother()
        return {
            "mats": mats,
            "P": [ell_from_scipy(P, dtype=vdt, device=dev) for P in Ps],
            "R": [ell_from_scipy(P.T.tocsr(), dtype=vdt, device=dev) for P in Ps],
            "sm": [sm.setup(m) for m in mats[:-1]],
            "coarse": DenseInverseSolver().setup(mats[-1]),
        }

    def setup(self, A, x=None):
        mats_sp, Ps, P0s = self._build(A)
        state = self._pack_state(mats_sp, Ps, A)
        # the aggregation pattern rides in the state so update() can
        # reuse it (the reference's numerical_setup!)
        state["pattern"] = _HostPattern(tuple(P0s))
        return state

    def update(self, state, A, x=None):
        """numerical_setup!: reuse the aggregation/tentative-P pattern from
        setup; only the P smoothing and Galerkin triple products rerun."""
        pattern = state.get("pattern")
        if pattern is None:
            return self.setup(A, x)
        mats_sp = [to_scipy(A).tocsr()]
        Ps = []
        for P0 in pattern.P0s:
            Ac = mats_sp[-1]
            P = self._smoothed_prolongation(Ac, P0)
            Ps.append(P)
            mats_sp.append((P.T @ Ac @ P).tocsr())
        new = self._pack_state(mats_sp, Ps, A)
        new["pattern"] = pattern
        return new

    def _vcycle(self, state, lev, x, r):
        mats = state["mats"]
        if lev == len(mats) - 1:
            dx = DenseInverseSolver().apply(state["coarse"], r)
            return x + dx, r - mats[lev].matvec(dx)
        sm = self._smoother()
        x, r = sm.smooth(state["sm"][lev], x, r)
        rH = state["R"][lev].matvec(r)
        dxH, _ = self._vcycle(state, lev + 1, torch.zeros_like(rH), rH)
        dx = state["P"][lev].matvec(dxH)
        x = x + dx
        r = r - mats[lev].matvec(dx)
        return sm.smooth(state["sm"][lev], x, r)

    def apply(self, state, r):
        """ncycles V-cycles from zero on flat vectors; a tuple vector is
        raveled and unraveled at the boundary."""
        flat = r.reshape(-1) if isinstance(r, torch.Tensor) else pt.ravel(r)
        x = torch.zeros_like(flat)
        for _ in range(self.ncycles):
            x, flat = self._vcycle(state, 0, x, flat)
        return pt.unflatten_like(x, r)

    def solve(self, state, b, x0=None):
        return self.apply(state, b), None
