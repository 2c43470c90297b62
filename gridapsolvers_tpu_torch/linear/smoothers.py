"""Smoothers and simple preconditioners.

Port of `gridapsolvers_tpu/linear/smoothers.py`:

- IdentitySolver          ← IdentityLinearSolvers.jl (z = r)
- JacobiSolver            ← JacobiLinearSolvers.jl (diag⁻¹)
- RichardsonSmoother      ← RichardsonSmoothers.jl:20-38,84-98 (the GMG
                            (x, r)-updating smoothing contract)
- RichardsonLinearSolver  ← RichardsonLinearSolvers.jl (scalar or per-dof ω)
- ChebyshevSmoother       : matvec-only polynomial smoother on D⁻¹A, with
                            λmax from Gershgorin or Lanczos.

The spectral bounds are read to the host once at setup, so the smoothing
recurrence runs on Python floats and launches no scalar kernels. The JAX
package keeps them as 0-d arrays of the operator's dtype and computes the
recurrence's scalars in that dtype; the port rounds them the same way, on
the host (`_chebyshev_coefficients`).

- PreconditionedChebyshevSmoother : Chebyshev acceleration of an SPD
                            preconditioner M (the Vanka patch smoothers),
                            λmax of M·A by power iteration through M.
- ColoredGaussSeidel      : multicolor Gauss-Seidel / SOR (alias
                            SymGaussSeidelSmoother), parity colours on a
                            StencilMatrix, greedy colours (`native`) on an
                            ELLMatrix.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..interfaces import (
    LinearSolver,
    Smoother,
    SolverTolerances,
    init_history,
    make_stats,
)
from ..utils import pytrees as pt
from ..utils.pytrees import round_scalar


@dataclasses.dataclass(frozen=True)
class IdentitySolver(LinearSolver):
    """z = r (reference IdentityLinearSolvers.jl)."""

    def setup(self, A, x=None):
        return {}

    def apply(self, state, r):
        return r

    def solve(self, state, b, x0=None):
        return b, None


@dataclasses.dataclass(frozen=True)
class JacobiSolver(LinearSolver):
    """Diagonal (point Jacobi) preconditioner
    (reference JacobiLinearSolvers.jl:6-7,20-41)."""

    def setup(self, A, x=None):
        return {"inv_diag": pt.tree_map(lambda d: 1.0 / d, A.diag())}

    def apply(self, state, r):
        return pt.mul(state["inv_diag"], r)

    def solve(self, state, b, x0=None):
        return self.apply(state, b), None


@dataclasses.dataclass(frozen=True)
class RichardsonSmoother(Smoother):
    """niter damped iterations x += ω M⁻¹ r; r -= A dx, updating x AND r —
    the contract GMG pre/post-smoothing relies on
    (reference RichardsonSmoothers.jl:20-38,84-98)."""

    M: LinearSolver
    niter: int = 1
    omega: float = 1.0

    def setup(self, A, x=None):
        return {"A": A, "M": self.M.setup(A, x)}

    def update(self, state, A, x=None):
        return {"A": A, "M": self.M.update(state["M"], A, x)}

    def smooth(self, state, x, r):
        A = state["A"]
        for _ in range(self.niter):
            dx = pt.scale(self.omega, self.M.apply(state["M"], r))
            x = pt.add(x, dx)
            r = pt.sub(r, A.matvec(dx))
        return x, r

    def apply(self, state, r):
        x, _ = self.smooth(state, pt.zeros_like(r), r)
        return x

    def solve(self, state, b, x0=None):
        x = pt.zeros_like(b) if x0 is None else x0
        r = pt.sub(b, state["A"].matvec(x))
        x, _ = self.smooth(state, x, r)
        return x, None


@dataclasses.dataclass(frozen=True)
class RichardsonLinearSolver(LinearSolver):
    """Standalone Richardson iteration with scalar or per-dof ω
    (reference RichardsonLinearSolvers.jl:13-23,79-106)."""

    omega: object = 1.0  # float or per-dof vector
    Pl: Optional[LinearSolver] = None
    maxiter: int = 1000
    atol: float = 1e-12
    rtol: float = 1e-8

    @property
    def tols(self) -> SolverTolerances:
        return SolverTolerances(self.maxiter, self.atol, self.rtol)

    def setup(self, A, x=None):
        return {"A": A, "Pl": self.Pl.setup(A, x) if self.Pl is not None else None}

    def solve(self, state, b, x0=None):
        A = state["A"]
        tols = self.tols

        def damp(z):
            if isinstance(self.omega, (int, float)):
                return pt.scale(self.omega, z)
            return pt.mul(self.omega, z)

        x = pt.zeros_like(b) if x0 is None else x0
        r = pt.sub(b, A.matvec(x))
        rnorm0 = pt.norm(r)
        hist = init_history(tols.maxiter, rnorm0)
        r0 = float(rnorm0)
        rn, it = r0, 0
        while not tols.finished(it, rn, r0):
            z = self.Pl.apply(state["Pl"], r) if self.Pl is not None else r
            dx = damp(z)
            x = pt.add(x, dx)
            r = pt.sub(r, A.matvec(dx))
            rnorm = pt.norm(r)
            hist[it + 1] = rnorm
            it += 1
            rn = float(rnorm)  # host sync: the stopping test
        return x, make_stats(tols, it, rn, r0, hist)


def gershgorin_dinv_a_lmax(A, inv_diag) -> torch.Tensor:
    """Guaranteed upper bound on lmax(D⁻¹A): max_i sum_j |a_ij| / a_ii.
    Never underestimates, so it is safe for Chebyshev; typically ~30-40%
    loose on FEM Laplacians."""
    return pt.max_abs(pt.mul(inv_diag, A.abs_row_sum()))


def estimate_dinv_a_lmax(A, inv_diag, iters: int = 20) -> torch.Tensor:
    """Largest eigenvalue of D⁻¹A via Lanczos on the symmetrized operator
    M = D^{-1/2} A D^{-1/2} (same spectrum): a fixed-k Lanczos recurrence
    plus eigvalsh of the small tridiagonal. The caller applies a safety
    factor (Chebyshev amplifies catastrophically if lmax is
    underestimated)."""
    sq = pt.tree_map(torch.sqrt, inv_diag)

    def Mop(v):
        return pt.mul(sq, A.matvec(pt.mul(sq, v)))

    leaves = pt.tree_leaves(inv_diag)
    dtype, device = leaves[0].dtype, leaves[0].device
    k = min(iters, max(2, pt.size(inv_diag) - 1))

    # deterministic pseudo-random start, the JAX package's exactly (on a
    # sharded vector, the global vector's entries of this rank's block)
    v = pt.seeded_like(inv_diag)
    v = pt.scale(1.0 / pt.norm(v), v)
    v_prev = pt.zeros_like(v)
    beta_prev = torch.zeros((), dtype=dtype, device=device)
    alphas = torch.zeros((k,), dtype=dtype, device=device)
    betas = torch.zeros((k,), dtype=dtype, device=device)
    for j in range(k):
        w = Mop(v)
        alpha = pt.dot(v, w)
        w = pt.axpy(-alpha, v, pt.axpy(-beta_prev, v_prev, w))
        beta = pt.norm(w)
        safe = torch.where(beta > 0, beta, 1.0)
        v, v_prev = pt.scale(1.0 / safe, w), v
        beta_prev = beta
        alphas[j] = alpha
        betas[j] = beta
    T = (
        torch.diag(alphas)
        + torch.diag(betas[: k - 1], 1)
        + torch.diag(betas[: k - 1], -1)
    )
    return torch.max(torch.linalg.eigvalsh(T))


@dataclasses.dataclass(frozen=True)
class ChebyshevSmoother(Smoother):
    """Chebyshev polynomial smoother on the Jacobi-preconditioned operator,
    targeting the spectrum [lmax/ratio, lmax] of D⁻¹A (lmax from Lanczos
    times `safety`, or the Gershgorin bound)."""

    degree: int = 3
    ratio: float = 30.0
    safety: float = 1.1
    lanczos_iters: int = 20
    eig_method: str = "lanczos"  # 'lanczos' | 'gershgorin'

    def setup(self, A, x=None):
        inv_diag = pt.tree_map(lambda d: 1.0 / d, A.diag())
        dtype = pt.tree_leaves(inv_diag)[0].dtype
        if self.eig_method == "gershgorin":
            lmax = float(gershgorin_dinv_a_lmax(A, inv_diag))
        elif self.eig_method == "lanczos":
            est = float(estimate_dinv_a_lmax(A, inv_diag, self.lanczos_iters))
            lmax = round_scalar(est * round_scalar(self.safety, dtype), dtype)
        else:
            raise ValueError(f"unknown eig_method {self.eig_method!r}")
        lmin = round_scalar(lmax / round_scalar(self.ratio, dtype), dtype)
        return {"A": A, "inv_diag": inv_diag, "lmax": lmax, "lmin": lmin}

    def update(self, state, A, x=None):
        return self.setup(A, x)

    def apply(self, state, r):
        x, _ = self.smooth(state, pt.zeros_like(r), r)
        return x

    def smooth(self, state, x, r):
        """Chebyshev iteration (three-term recurrence on the residual form;
        see e.g. Adams et al., 'Parallel multigrid smoothing')."""
        A, inv_diag = state["A"], state["inv_diag"]
        inv_theta, steps = _chebyshev_coefficients(
            state["lmax"], state["lmin"], self.degree, pt.tree_leaves(inv_diag)[0].dtype
        )
        z = pt.mul(inv_diag, r)
        d = pt.scale(inv_theta, z)
        for d_coef, d_scale in steps:
            x = pt.add(x, d)
            r = pt.sub(r, A.matvec(d))
            z = pt.mul(inv_diag, r)
            d = pt.axpby(d_coef, z, d_scale, d)
        return x, r

    def solve(self, state, b, x0=None):
        x = pt.zeros_like(b) if x0 is None else x0
        r = pt.sub(b, state["A"].matvec(x))
        x, _ = self.smooth(state, x, r)
        return x, None


@dataclasses.dataclass(frozen=True)
class PreconditionedChebyshevSmoother(Smoother):
    """Chebyshev acceleration of an SPD-preconditioned iteration: the
    recurrence runs on M·A with z = M(r), where M is any symmetric
    smoother/solver (e.g. the additive-Schwarz Vanka with 'unit'
    weighting; degree d then replaces a Richardson(n) sweep at d/n of the
    SpMV cost for the same smoothing class). Generalizes the reference's
    Richardson-wrapped patch smoothers (RichardsonSmoothers.jl:20-38 around
    PatchSolvers.jl): same M, Chebyshev weights instead of a fixed damping.

    λmax of M·A comes from `power_iters` steps of power iteration through
    M.apply and A.matvec, from the JAX package's start vector
    sin(12.9898·(1..n)) shaped like A's diagonal, times `safety`. The JAX
    package runs that iteration through a second, batched Vanka set up for
    the estimate, because its materialized M applies only on the TPU; the
    port's M applies on every device, so the iteration runs through M
    itself (the same linear map, one set-up instead of two). `update`
    keeps the set-up estimate."""

    M: object = None  # inner preconditioner (solver/smoother protocol)
    degree: int = 4
    ratio: float = 8.0  # patch-preconditioned spectra are tight
    safety: float = 1.05
    power_iters: int = 12

    def _lmax(self, Mst, A) -> float:
        v = pt.seeded_like(A.diag())
        v = pt.scale(1.0 / pt.norm(v), v)
        lam = None
        for _ in range(self.power_iters):
            w = self.M.apply(Mst, A.matvec(v))
            lam = pt.norm(w)
            v = pt.scale(1.0 / torch.where(lam > 0, lam, 1.0), w)
        dtype = pt.tree_leaves(v)[0].dtype
        lam = 1.0 if lam is None else float(lam)
        return round_scalar(lam * round_scalar(self.safety, dtype), dtype)

    def setup(self, A, x=None):
        Mst = self.M.setup(A, x)
        return {"A": A, "M": Mst, "lmax": self._lmax(Mst, A)}

    def update(self, state, A, x=None):
        return {"A": A, "M": self.M.update(state["M"], A, x), "lmax": state["lmax"]}

    def apply(self, state, r):
        x, _ = self.smooth(state, pt.zeros_like(r), r)
        return x

    def smooth(self, state, x, r):
        A, Mst, lmax = state["A"], state["M"], state["lmax"]
        dtype = pt.tree_leaves(r)[0].dtype
        lmin = round_scalar(lmax / round_scalar(self.ratio, dtype), dtype)
        inv_theta, steps = _chebyshev_coefficients(lmax, lmin, self.degree, dtype)
        z = self.M.apply(Mst, r)
        d = pt.scale(inv_theta, z)
        for d_coef, d_scale in steps:
            x = pt.add(x, d)
            r = pt.sub(r, A.matvec(d))
            z = self.M.apply(Mst, r)
            d = pt.axpby(d_coef, z, d_scale, d)
        return x, r

    def solve(self, state, b, x0=None):
        x = pt.zeros_like(b) if x0 is None else x0
        r = pt.sub(b, state["A"].matvec(x))
        x, _ = self.smooth(state, x, r)
        return x, None


@functools.lru_cache(maxsize=None)
def _chebyshev_coefficients(lmax: float, lmin: float, degree: int, dtype):
    """The Chebyshev recurrence's scalars: 1/θ, and for each of the `degree`
    steps the pair (2ρ'/δ, ρ'ρ). Computed as the JAX package computes them
    from its 0-d bounds: every operation rounded to `dtype` (exact in f64)."""
    def r(v):
        return round_scalar(v, dtype)

    theta = r(0.5 * r(lmax + lmin))
    delta = r(0.5 * r(lmax - lmin))
    sigma1 = r(theta / delta)
    rho = r(1.0 / sigma1)
    steps = []
    for _ in range(degree):
        rho_new = r(1.0 / r(r(2.0 * sigma1) - rho))
        steps.append((r(r(2.0 * rho_new) / delta), r(rho_new * rho)))
        rho = rho_new
    return r(1.0 / theta), tuple(steps)


def _greedy_coloring(cols: np.ndarray, n: int) -> np.ndarray:
    """Greedy graph coloring of the sparsity graph (host-side, native C++
    with NumPy twin). cols: (n, K) ELL column indices."""
    from ..native import greedy_color

    return greedy_color(np.asarray(cols))


def stencil_coloring(grid_shape) -> np.ndarray:
    """2^d coloring by coordinate parity — exact GS decoupling for any
    3^d-point stencil on a structured grid."""
    grids = np.meshgrid(*[np.arange(m) % 2 for m in grid_shape], indexing="ij")
    color = np.zeros(grid_shape, dtype=np.int32)
    for k, g in enumerate(grids):
        color += g << k
    return color.reshape(-1)


def _cshift_to(xq: torch.Tensor, t, out_shape) -> torch.Tensor:
    """out[k] = xq[k + t] on compact subgrids (zero outside) with an
    explicit output shape — parity subgrids of an odd-sized axis differ in
    length by one."""
    out = xq
    for k in range(out.ndim):
        n_in, n_out = out.shape[k], out_shape[k]
        start = max(t[k], 0)
        stop = min(n_in, n_out + t[k])
        length = max(stop - start, 0)
        left = max(-t[k], 0)
        out = out.narrow(k, start, length)
        pads = [0] * (2 * out.ndim)
        j = 2 * (out.ndim - 1 - k)  # F.pad lists the last axis first
        pads[j], pads[j + 1] = left, n_out - left - length
        out = F.pad(out, pads)
    return out


@dataclasses.dataclass(frozen=True)
class ColoredGaussSeidel(Smoother):
    """Multicolor Gauss-Seidel: one sweep = sequential pass over colors,
    simultaneous update within each color (exact GS for a coloring of the
    adjacency graph). sweep ∈ ('forward','backward','symmetric').

    Replacement for the reference's processor-block SymGaussSeidelSmoother
    (SymGaussSeidelSmoothers.jl:147-208). impl='masked' applies a full
    matvec per color (the operator's kernel, K2 or K3, on a vector that is
    zero off the color); impl='compact' works on the parity-compact
    subgrids of a non-periodic 3^d-point StencilMatrix, reading each band
    once per color pass (plain tensor operations), and falls back to
    'masked' for any other operator, as the JAX package does."""

    niter: int = 1
    sweep: str = "symmetric"
    # SOR relaxation factor (omega=1 -> plain GS; symmetric sweep with
    # omega != 1 gives SSOR, the reference's IterativeSolversExt IS_SSOR)
    omega: float = 1.0
    impl: str = "masked"

    def setup(self, A, x=None):
        from ..algebra.stencil import StencilMatrix

        d = A.diag()
        if isinstance(A, StencilMatrix):
            colors = stencil_coloring(A.grid_shape)
        else:
            colors = _greedy_coloring(A.cols.cpu().numpy(), A.shape[0])
        ncolors = int(colors.max()) + 1
        masks = torch.from_numpy(np.stack([(colors == c) for c in range(ncolors)])).to(
            device=d.device, dtype=d.dtype)
        return {"A": A, "inv_diag": 1.0 / d, "masks": masks}

    def update(self, state, A, x=None):
        return {"A": A, "inv_diag": 1.0 / A.diag(), "masks": state["masks"]}

    def _color_order(self, ncolors):
        fwd = list(range(ncolors))
        if self.sweep == "forward":
            return fwd
        if self.sweep == "backward":
            return fwd[::-1]
        return fwd + fwd[::-1]

    def smooth(self, state, x, r):
        from ..algebra.stencil import StencilMatrix

        A = state["A"]
        if (
            self.impl == "compact"
            and isinstance(A, StencilMatrix)
            and not any(A._periodic())
            and all(all(abs(o) <= 1 for o in off) for off in A.offsets)
        ):
            return self._smooth_stencil_fast(state, x, r)
        return self._smooth_generic(state, x, r)

    def _smooth_generic(self, state, x, r):
        A = state["A"]
        inv_diag, masks = state["inv_diag"], state["masks"]
        for _ in range(self.niter):
            for c in self._color_order(masks.shape[0]):
                dx = self.omega * masks[c] * inv_diag * r
                x = x + dx
                r = r - A.matvec(dx)
        return x, r

    def _smooth_stencil_fast(self, state, x, r):
        """Banded fast path: one sweep costs ~1 matvec of band traffic
        instead of 2^d. Works on the parity-compact subgrids: per color
        visit, the current residual at that color's rows is recomputed
        lazily from the accumulated compact deltas, so each band is read
        only at the visited color's rows. One trailing matvec yields the
        final residual. The same updates in the same order as the generic
        path, exact for any 3^d-point stencil on an open grid."""
        A = state["A"]
        gs = A.grid_shape
        d = len(gs)
        rg = r.reshape(gs)
        xg = x.reshape(gs)
        invd = state["inv_diag"].reshape(gs)
        colors = list(itertools.product((0, 1), repeat=d))

        # stencil_coloring packs dim-k parity into bit k
        def parity(c):
            return tuple((c >> k) & 1 for k in range(d))

        subs = {p: tuple(slice(p[k], None, 2) for k in range(d)) for p in colors}
        DX = {p: torch.zeros_like(rg[subs[p]]) for p in colors}
        r0c = {p: rg[subs[p]] for p in colors}
        seq = [parity(c) for _ in range(self.niter) for c in self._color_order(2 ** d)]
        for p in seq:
            rp = r0c[p]
            for s, off in enumerate(A.offsets):
                q = tuple((p[k] + off[k]) % 2 for k in range(d))
                t = tuple((p[k] + off[k]) // 2 for k in range(d))
                contrib = _cshift_to(DX[q], t, rp.shape)
                rp = rp - A.bands[(s,) + subs[p]] * contrib
            DX[p] = DX[p] + self.omega * invd[subs[p]] * rp
        dxg = torch.zeros_like(rg)
        for p in colors:
            dxg[subs[p]] = DX[p]
        x_new = (xg + dxg).reshape(x.shape)
        r_new = r - A.matvec(dxg.reshape(-1)).reshape(r.shape)
        return x_new, r_new

    def apply(self, state, r):
        x, _ = self.smooth(state, torch.zeros_like(r), r)
        return x

    def solve(self, state, b, x0=None):
        x = pt.zeros_like(b) if x0 is None else x0
        r = b - state["A"].matvec(x)
        x, _ = self.smooth(state, x, r)
        return x, None


# Reference naming alias
SymGaussSeidelSmoother = ColoredGaussSeidel
