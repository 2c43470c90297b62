"""One- and two-level additive Schwarz.

Port of `gridapsolvers_tpu/linear/schwarz.py`, the analog of the
reference's SchwarzLinearSolver (src/LinearSolvers/SchwarzLinearSolvers.jl)
and, with the GenEO coarse space, of its HPDDMLinearSolver
(ext/GridapPETScExt/HPDDMLinearSolvers.jl: PCHPDDM fed with local
overlapping Neumann matrices). The subdomains are contiguous overlapping
slabs of the leading grid axis; each slab operator is factorized densely
and all slab solves apply batched (the port's `patches.PatchSolver`), the
combine a scatter-add.

The two-level solver's per-subdomain generalized eigenproblems

    N_i z = lambda (D_i A_i D_i) z

are one batched Cholesky, two batched triangular solves and one batched
`eigh` over all subdomains (library calls, as the JAX package leaves them
to XLA). The coarse operator A0 = Zᵀ A Z takes one operator apply (kernel
K2 for a `StencilMatrix`) per coarse vector, ns * nev in all.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..interfaces import LinearSolver
from ..patches.smoothers import PatchSolver
from ..patches.topology import PatchTopology
from ..utils import numpy_dtype


def slab_bounds(n0: int, n_subdomains: int, overlap: int = 1):
    """Overlapping [lo, hi) leading-axis row ranges of the subdomains."""
    bounds = np.linspace(0, n0, n_subdomains + 1).astype(int)
    return [
        (max(bounds[s] - overlap, 0), min(bounds[s + 1] + overlap, n0))
        for s in range(n_subdomains)
    ]


def slab_patches(grid_shape, n_subdomains: int, overlap: int = 1) -> PatchTopology:
    """Overlapping slabs of the leading grid axis as subdomains."""
    n0 = grid_shape[0]
    rest = int(np.prod(grid_shape[1:])) if len(grid_shape) > 1 else 1
    n = n0 * rest
    rows = [np.arange(lo * rest, hi * rest) for lo, hi in slab_bounds(n0, n_subdomains, overlap)]
    width = max(len(r) for r in rows)
    table = np.full((n_subdomains, width), n, dtype=np.int32)
    for i, dofs in enumerate(rows):
        table[i, : len(dofs)] = dofs
    return PatchTopology(dofs=table, dummy=n, n_dofs=n)


@dataclasses.dataclass(frozen=True)
class SchwarzLinearSolver(LinearSolver):
    """Additive Schwarz over overlapping row-slab subdomains."""

    n_subdomains: int = 4
    overlap: int = 2
    omega: float = 1.0

    def setup(self, A, x=None):
        topo = slab_patches(A.grid_shape, self.n_subdomains, self.overlap)
        inner = PatchSolver(topo, omega=self.omega, weighting="overlap", spd=False)
        return {"inner": inner, "state": inner.setup(A, x)}

    def update(self, state, A, x=None):
        inner = state["inner"]
        return {"inner": inner, "state": inner.update(state["state"], A, x)}

    def apply(self, state, r):
        return state["inner"].apply(state["state"], r)

    def solve(self, state, b, x0=None):
        return self.apply(state, b), None


def slab_neumann_matrices(
    mesh,
    n_subdomains: int,
    overlap: int = 2,
    kappa=None,
    dirichlet="boundary",
    dtype=torch.float64,
) -> np.ndarray:
    """Local overlapping NEUMANN matrices of the slab subdomains of a
    CartesianMesh (the reference's ghost-including subassembly,
    HPDDMLinearSolvers.jl:60-96): each slab's operator is assembled on the
    slab's own sub-mesh with natural boundaries at the interfaces, then
    the global Dirichlet rows inside the slab are symmetric-eliminated.
    Returns a host (n_subdomains, k, k) array padded with unit diagonals,
    aligned with `slab_patches` dof order."""
    from ..fem.assembly import q1_bands_host, q1_element_matrices, q1_stencil, q1_var_bands_host

    np_dtype = numpy_dtype(dtype)
    vshape = mesh.vertex_shape
    n0 = vshape[0]
    rest = int(np.prod(vshape[1:])) if len(vshape) > 1 else 1
    assert not mesh.periodic[0], "slab subdomains need an open leading axis"
    gmask = (
        mesh.boundary_vertex_mask(dirichlet)
        if dirichlet is not None
        else np.zeros(vshape, dtype=bool)
    )
    bounds = slab_bounds(n0, n_subdomains, overlap)
    kmax = max(hi - lo for lo, hi in bounds) * rest
    kap = None if kappa is None else np.asarray(kappa).reshape(mesh.ncells)
    Ke, _ = q1_element_matrices(mesh.h)
    out = np.zeros((n_subdomains, kmax, kmax), dtype=np_dtype)
    for s, (lo, hi) in enumerate(bounds):
        ncells_s = (hi - lo - 1,) + tuple(mesh.ncells[1:])
        dom = list(mesh.domain)
        dom[0], dom[1] = 0.0, mesh.h[0] * ncells_s[0]
        smesh = dataclasses.replace(
            mesh, ncells=ncells_s, domain=tuple(dom),
            periodic=(False,) + tuple(mesh.periodic[1:]),
        )
        if kap is None:
            bands = q1_bands_host(smesh, Ke, np_dtype)
        else:
            bands = q1_var_bands_host(smesh, Ke, kap[lo : hi - 1], np_dtype)
        D = q1_stencil(smesh, bands, torch.float64, "cpu").todense().numpy()
        dmask = gmask[lo:hi].reshape(-1)
        if dmask.any():
            idx = np.nonzero(dmask)[0]
            D[idx, :] = 0.0
            D[:, idx] = 0.0
            D[idx, idx] = 1.0
        k = D.shape[0]
        out[s, :k, :k] = D
        if k < kmax:
            out[s, k:, k:] = np.eye(kmax - k, dtype=np_dtype)
    return out


@dataclasses.dataclass(frozen=True)
class TwoLevelSchwarzSolver(LinearSolver):
    """Additive two-level Schwarz with a GenEO spectral coarse space (the
    reference's HPDDM/PCHPDDM analog).

    Level 1: the one-level slab Schwarz (batched dense local solves, unit
    weighting). Level 2: per subdomain i, the `nev` smallest eigenpairs of
        N_i z = lambda (D_i A_i D_i) z
    (N_i: the local Neumann matrix if given, else the extracted local
    Dirichlet matrix A_i), lifted by the partition of unity:
    Z[:, (i,a)] = R_iᵀ D_i z_ia. Coarse correction Z (Zᵀ A Z)⁻¹ Zᵀ, dense
    LU unless `coarse_solver` is given (the PCHPDDM nesting pattern).

    `neumann_matrices`: optional host (n_subdomains, k, k) array from
    `slab_neumann_matrices` (true GenEO).
    """

    n_subdomains: int = 4
    overlap: int = 2
    nev: int = 2
    omega: float = 1.0
    neumann_matrices: object = None
    coarse_solver: object = None

    def _inner(self, A):
        topo = slab_patches(A.grid_shape, self.n_subdomains, self.overlap)
        # unit weighting keeps the two-level operator symmetric, so CG is a
        # safe outer solver; the PoU weights enter only the GenEO pencil
        # and the coarse-space lift
        return PatchSolver(topo, omega=1.0, weighting="unit", spd=False), topo

    def setup(self, A, x=None):
        inner, topo = self._inner(A)
        st1 = inner.setup(A, x)
        dev, dt = st1["dofs"].device, A.dtype
        # partition-of-unity weights in patch-local layout (0 on padding)
        w = 1.0 / np.maximum(topo.overlap_counts(), 1.0)
        wp = w[np.minimum(topo.dofs, topo.n_dofs)]
        wp[~topo.valid_mask()] = 0.0
        state = {
            "solver": inner,
            "topo": topo,
            "inner": st1,
            "valid": torch.as_tensor(topo.valid_mask(), device=dev),
            "wp": torch.as_tensor(wp, device=dev, dtype=dt),
            "neumann": None
            if self.neumann_matrices is None
            else torch.as_tensor(np.asarray(self.neumann_matrices), device=dev, dtype=dt),
        }
        return self._refresh_coarse(state, A)

    def update(self, state, A, x=None):
        """numerical_setup! analog: re-extract the local matrices, re-run
        the batched eigensolves and rebuild the coarse operator."""
        new = dict(state)
        new["inner"] = state["solver"].update(state["inner"], A, x)
        return self._refresh_coarse(new, A)

    def _refresh_coarse(self, state, A):
        from ..algebra.dense import DenseMatrix
        from ..algebra.ell import ELLMatrix
        from ..algebra.ell_view import ell_values
        from ..patches.smoothers import extract_patch_matrices_ell

        st1, topo = state["inner"], state["topo"]
        meta = st1["meta"]
        ell = ELLMatrix(ell_values(A, meta, st1["leaf_masks"]), st1["ell_cols"], meta.n_cols)
        Ap = extract_patch_matrices_ell(ell, st1["dofs"], topo.dummy)

        wp, valid = state["wp"], state["valid"]          # (ns, k)
        eye = torch.eye(topo.width, dtype=Ap.dtype, device=Ap.device)[None]
        # B = D A D with unit diagonal on padding (keeps it SPD)
        B = wp[:, :, None] * Ap * wp[:, None, :]
        B = torch.where(valid[:, :, None] & valid[:, None, :], B, eye) + 1e-12 * eye
        N = state["neumann"] if state["neumann"] is not None else Ap
        del Ap
        # push padding modes to lambda = 1e8 so they are never selected
        pad_diag = torch.where(valid, 0.0, 1e8).to(N.dtype)
        N = N + pad_diag[:, :, None] * eye

        # generalized eigh of the pencil (N, B): whiten by chol(B), one
        # batched eigh over all subdomains, un-whiten, take nev smallest
        L = torch.linalg.cholesky(B)
        del B
        Ct = torch.linalg.solve_triangular(L, N, upper=False)
        del N
        C = torch.linalg.solve_triangular(L, Ct.transpose(-1, -2), upper=False)
        del Ct
        C = 0.5 * (C + C.transpose(-1, -2))
        lam, Q = torch.linalg.eigh(C)                    # ascending eigenvalues
        del C
        Zl = torch.linalg.solve_triangular(
            L.transpose(-1, -2), Q[:, :, : self.nev], upper=True
        )                                                # (ns, k, nev)
        del L, Q
        # coarse vectors: partition-of-unity lift, zero on padding
        Zp = wp[:, :, None] * Zl * valid[:, :, None]

        # A0 = Zᵀ A Z from ns * nev operator applies (the coarse space is
        # tiny: m = n_subdomains * nev)
        n = topo.n_dofs
        ns, _, nev = Zp.shape
        dofs = st1["dofs"]
        m = ns * nev
        cols = torch.zeros((m, n + 1), dtype=Zp.dtype, device=Zp.device)
        rows = torch.arange(m, device=Zp.device).reshape(ns, nev, 1)
        cols.index_put_(
            (rows.expand(ns, nev, dofs.shape[1]), dofs[:, None, :].expand(ns, nev, -1)),
            Zp.transpose(1, 2), accumulate=True,
        )
        cols = cols[:, :n]
        Acols = torch.stack([A.matvec(cols[j]) for j in range(m)])
        A0 = cols @ Acols.T
        del cols, Acols
        A0 = A0 + 1e-10 * torch.trace(A0) / m * torch.eye(m, dtype=A0.dtype, device=A0.device)

        new = dict(state)
        new["Zp"] = Zp
        new["eigenvalues"] = lam[:, : self.nev + 1]
        if self.coarse_solver is None:
            new["A0_lu"] = torch.linalg.lu_factor(A0)
        else:
            new["A0_state"] = self.coarse_solver.setup(DenseMatrix(A0))
        return new

    def apply(self, state, r):
        # level 1: batched overlapping local solves (symmetric combine)
        z1 = state["solver"].apply(state["inner"], r)
        # level 2: coarse correction Z A0⁻¹ Zᵀ r, gathers and einsums
        dofs, Zp = state["inner"]["dofs"], state["Zp"]
        ns, _, nev = Zp.shape
        re = torch.cat([r, torch.zeros((1,), dtype=r.dtype, device=r.device)])
        rp = re[dofs]                                    # (ns, k)
        rc = torch.einsum("ska,sk->sa", Zp, rp).reshape(-1)
        if self.coarse_solver is None:
            lu, piv = state["A0_lu"]
            c = torch.linalg.lu_solve(lu, piv, rc[:, None])[:, 0]
        else:
            c, _ = self.coarse_solver.solve(state["A0_state"], rc)
        dxp = torch.einsum("ska,sa->sk", Zp, c.reshape(ns, nev))
        z2 = torch.zeros_like(re).index_add_(0, dofs.reshape(-1), dxp.reshape(-1))[: r.shape[0]]
        return self.omega * (z1 + z2)

    def solve(self, state, b, x0=None):
        return self.apply(state, b), None
