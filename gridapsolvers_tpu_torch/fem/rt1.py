"""Higher-order Raviart-Thomas (RT1) on structured grids — the reference's
actual Darcy configuration (test/Applications/DarcyGMG.jl:52-56: order=2,
reffe_u = raviart_thomas order 1, reffe_p = P1 discontinuous, alpha=1e2
grad-div augmented velocity block, vertex-star patch smoothers).

Port of `gridapsolvers_tpu/fem/rt1.py`. On rectangles/boxes RT1 component d
is the tensor space (C0-P2 along axis d) x (discontinuous P1 transverse),
so every operator block is an exact Kronecker chain of tiny 1D matrices,
assembled on the host in scipy as in the JAX package:

    dof grid, comp d :  (2 n_d + 1) along d  x  (2 n_a) transverse
    mass             :  kron( C0P2-mass | DGP1-mass )
    grad-div G_cd    :  kron chains of 1D d/dx couplings
    B (P1disc rows)  :  kron chains of 1D moment integrals
    transfers        :  per-axis 1D embeddings applied as tensordots
                        (plain dense products; C0P2 and DGP1 refinements
                        are NESTED, so R = P^T gives exact Galerkin coarse
                        corrections with rediscretized level operators)

On the device the diagonal velocity blocks are `StencilMatrix`es on the
mixed C0/DG dof grids (kernel K2's general kernel, a 5 x 3 offset
envelope), the cross blocks, B, Bᵀ and the pressure mass `ELLMatrix`es
(kernel K3). All 1D element integrals are computed by 3-point Gauss
quadrature (exact for the degree-<=4 integrands).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ..algebra import BlockOperator
from ..algebra.block import ColumnStack, RowStack
from ..algebra.ell import ell_from_scipy
from ..algebra.stencil import stencil_from_scipy
from ..patches.topology import PatchTopology
from ..utils import pytrees as pt
from ..utils import resolve_device
from . import assembly2 as asm

# -- 1D element machinery (local coordinate xi in [0,1]) --------------------

_GAUSS_X = np.array(
    [0.5 - np.sqrt(15) / 10, 0.5, 0.5 + np.sqrt(15) / 10]
)
_GAUSS_W = np.array([5.0 / 18.0, 8.0 / 18.0, 5.0 / 18.0])


def _p2_shapes(xi):
    """C0-P2 shape functions (nodes at xi = 0, 1/2, 1) and derivatives."""
    N = np.stack(
        [(1 - xi) * (1 - 2 * xi), 4 * xi * (1 - xi), xi * (2 * xi - 1)]
    )
    dN = np.stack([4 * xi - 3, 4 - 8 * xi, 4 * xi - 1])
    return N, dN


def _p1_shapes(xi):
    """DG-P1 shape functions (nodes at xi = 0, 1)."""
    return np.stack([1 - xi, xi]), np.stack(
        [-np.ones_like(xi), np.ones_like(xi)]
    )


def _quad(fi, fj, w=None):
    """Element matrix ∫ fi_a(xi) fj_b(xi) [w(xi)] dxi by Gauss quadrature.
    fi/fj: (n_shapes, n_quad) arrays evaluated at _GAUSS_X."""
    ww = _GAUSS_W if w is None else _GAUSS_W * w
    return np.einsum("aq,bq,q->ab", fi, fj, ww)


def _c0p2_assemble(n: int, elem: np.ndarray) -> sp.csr_matrix:
    """Assemble a per-cell 3x3 element matrix into the (2n+1) C0-P2 grid."""
    conn = 2 * np.arange(n)[:, None] + np.arange(3)[None, :]
    rows = np.repeat(conn, 3, axis=1).reshape(-1)
    cols = np.tile(conn, (1, 3)).reshape(-1)
    vals = np.tile(elem.reshape(-1), n)
    return sp.coo_matrix(
        (vals, (rows, cols)), shape=(2 * n + 1, 2 * n + 1)
    ).tocsr()


def _dgp1_assemble(n: int, elem: np.ndarray) -> sp.csr_matrix:
    """Assemble a per-cell 2x2 element matrix into the (2n) DG-P1 grid."""
    return sp.block_diag([sp.csr_matrix(elem)] * n, format="csr")


def _mixed_1d(n: int, elem: np.ndarray, rows_dg: bool) -> sp.csr_matrix:
    """Rectangular 1D coupling: per-cell (2x3) [DG rows x P2 cols] when
    rows_dg else (3x2)."""
    conn_p2 = 2 * np.arange(n)[:, None] + np.arange(3)[None, :]
    conn_dg = 2 * np.arange(n)[:, None] + np.arange(2)[None, :]
    cr, cc = (conn_dg, conn_p2) if rows_dg else (conn_p2, conn_dg)
    ni, nj = elem.shape
    rows = np.repeat(cr, nj, axis=1).reshape(-1)
    cols = np.tile(cc, (1, ni)).reshape(-1)
    vals = np.tile(elem.reshape(-1), n)
    shape = (2 * n, 2 * n + 1) if rows_dg else (2 * n + 1, 2 * n)
    return sp.coo_matrix((vals, (rows, cols)), shape=shape).tocsr()


def _moment_1d(n: int, shapes, moment: int, h: float, deriv: bool
               ) -> sp.csr_matrix:
    """(cells x dofs) 1D moment integrals: row c = ∫_cell f_j(x) m(xi) dx
    with m in {1, xi - 1/2}. For deriv=True, f_j = d/dx of C0-P2 shapes
    (the h factors cancel: ∫ Nj' m dxi); else f_j = DG-P1 (factor h)."""
    xi = _GAUSS_X
    m = np.ones_like(xi) if moment == 0 else (xi - 0.5)
    if deriv:
        _, dN = _p2_shapes(xi)
        elem = np.einsum("aq,q,q->a", dN, m, _GAUSS_W)  # dimensionless
        conn = 2 * np.arange(n)[:, None] + np.arange(3)[None, :]
        width, ndof = 3, 2 * n + 1
    else:
        b, _ = _p1_shapes(xi)
        elem = h * np.einsum("aq,q,q->a", b, m, _GAUSS_W)
        conn = 2 * np.arange(n)[:, None] + np.arange(2)[None, :]
        width, ndof = 2, 2 * n
    rows = np.repeat(np.arange(n)[:, None], width, axis=1).reshape(-1)
    cols = conn.reshape(-1)
    vals = np.tile(elem, n)
    return sp.coo_matrix((vals, (rows, cols)), shape=(n, ndof)).tocsr()


def _kron_chain(mats) -> sp.csr_matrix:
    out = mats[0]
    for m in mats[1:]:
        out = sp.kron(out, m)
    return out.tocsr()


# -- RT1 component dof grids and blocks --------------------------------------


def rt1_dof_shape(ncells, d) -> Tuple[int, ...]:
    return tuple(
        2 * n + 1 if a == d else 2 * n for a, n in enumerate(ncells)
    )


def rt1_blocks(ncells: Tuple[int, ...], alpha: float = 1.0):
    """Kron-chain RT1 blocks on the unit box (host scipy).

    Returns dict with per-component M (mass), per-(c,d) G (alpha grad-div
    couplings ∫ ∂_c v_c ∂_d u_d), per-component B list-of-moment rows
    (n_cells x ndof_d for each of the dim+1 P1disc moments), Mp diagonal,
    dof shapes, h."""
    dim = len(ncells)
    h = tuple(1.0 / n for n in ncells)
    xi = _GAUSS_X
    N, dN = _p2_shapes(xi)
    b, _ = _p1_shapes(xi)

    def p2_mass(n, ha):
        return _c0p2_assemble(n, ha * _quad(N, N))

    def p2_stiff(n, ha):
        return _c0p2_assemble(n, (1.0 / ha) * _quad(dN, dN))

    def dg_mass(n, ha):
        return _dgp1_assemble(n, ha * _quad(b, b))

    def p2d_dg(n):
        # ∫ (d/dx Ni) bj dx = ∫ Ni' bj dxi (h cancels); rows P2, cols DG
        return _mixed_1d(n, _quad(dN, b), rows_dg=False)

    M, G, B, shapes = [], {}, [], []
    for c in range(dim):
        shapes.append(rt1_dof_shape(ncells, c))
        M.append(
            _kron_chain(
                [
                    p2_mass(ncells[a], h[a])
                    if a == c
                    else dg_mass(ncells[a], h[a])
                    for a in range(dim)
                ]
            )
        )
        # B rows: one (n_cells x ndof_c) matrix per P1disc moment
        Bm = []
        for m in range(dim + 1):
            parts = []
            for a in range(dim):
                mom = 1 if (m == a + 1) else 0
                parts.append(_moment_1d(ncells[a], None, mom, h[a], deriv=(a == c)))
            Bm.append(_kron_chain(parts))
        B.append(Bm)
    for c in range(dim):
        for d in range(dim):
            parts = []
            for a in range(dim):
                if c == d:
                    parts.append(
                        p2_stiff(ncells[a], h[a])
                        if a == c
                        else dg_mass(ncells[a], h[a])
                    )
                else:
                    if a == c:      # test derivative axis: rows P2', cols DG
                        parts.append(p2d_dg(ncells[a]))
                    elif a == d:    # trial derivative axis: rows DG, cols P2'
                        parts.append(p2d_dg(ncells[a]).T.tocsr())
                    else:
                        parts.append(dg_mass(ncells[a], h[a]))
            G[(c, d)] = (alpha * _kron_chain(parts)).tocsr()

    vol = float(np.prod(h))
    n_cells = int(np.prod(ncells))
    mp_cell = vol * np.array([1.0] + [1.0 / 12.0] * dim)
    Mp = sp.diags(np.tile(mp_cell, n_cells)).tocsr()
    return dict(
        M=M, G=G, B=B, Mp=Mp, shapes=shapes, h=h, ncells=tuple(ncells)
    )


def rt1_pressure_rows(Bm_list, dim: int) -> sp.csr_matrix:
    """Stack per-moment (n_cells x ndof) rows into cell-major P1disc
    ordering (dof = cell*(dim+1) + moment, constant first — the repo's
    pdisc convention)."""
    n_cells = Bm_list[0].shape[0]
    out = []
    for m, Bm in enumerate(Bm_list):
        rows = np.arange(n_cells) * (dim + 1) + m
        P = sp.csr_matrix(
            (np.ones(n_cells), (rows, np.arange(n_cells))),
            shape=(n_cells * (dim + 1), n_cells),
        )
        out.append(P @ Bm)
    return sum(out[1:], out[0]).tocsr()


def rt1_boundary_masks(ncells: Tuple[int, ...]):
    """Essential (normal-flux) masks: comp-d dofs on the d-normal
    boundary faces (first/last C0-P2 node layer along d)."""
    dim = len(ncells)
    masks = []
    for d in range(dim):
        shape = rt1_dof_shape(ncells, d)
        m = np.zeros(shape, dtype=bool)
        idx = [slice(None)] * dim
        idx[d] = 0
        m[tuple(idx)] = True
        idx[d] = shape[d] - 1
        m[tuple(idx)] = True
        masks.append(m.reshape(-1))
    return masks


def rt1_velocity_operator(ncells, alpha: float = 1.0e2, blocks=None,
                          banded: bool = True, dtype=torch.float64, device=None):
    """Augmented velocity block M + alpha ∫ div div with essential BCs
    eliminated (reference biform_u, DarcyGMG.jl:70-72). Diagonal component
    blocks band to `StencilMatrix` on the mixed C0/DG dof grids (K2);
    cross blocks stay `ELLMatrix` (K3: different row/col grids). Returns
    (BlockOperator, masks); operators in the torch `dtype` on `device`."""
    dev = resolve_device(device)
    dim = len(ncells)
    S = blocks if blocks is not None else rt1_blocks(ncells, 1.0)
    masks = rt1_boundary_masks(ncells)
    rows = []
    for c in range(dim):
        row = []
        for d in range(dim):
            A = alpha * S["G"][(c, d)]
            if c == d:
                A = (A + S["M"][c]).tocsr()
            A = asm.zero_rows(A, masks[c])
            A = asm.zero_columns(A, masks[d])
            if c == d:
                A = (A + sp.diags(masks[c].astype(float))).tocsr()
                row.append(
                    stencil_from_scipy(A, S["shapes"][c], dtype=dtype, device=dev)
                    if banded
                    else ell_from_scipy(A, dtype=dtype, device=dev)
                )
            else:
                A.eliminate_zeros()
                row.append(ell_from_scipy(A.tocsr(), dtype=dtype, device=dev))
        rows.append(tuple(row))
    return BlockOperator(tuple(rows)), masks


# -- transfers: per-axis 1D nested embeddings as tensordots ------------------


def _p2_1d_embedding(nc: int) -> np.ndarray:
    """C0-P2 coarse (nc cells) -> fine (2nc cells): evaluate the coarse
    quadratic at the fine node positions (exact nested embedding)."""
    P = np.zeros((4 * nc + 1, 2 * nc + 1))
    loc = np.array([0.0, 0.25, 0.5, 0.75, 1.0])
    Nv, _ = _p2_shapes(loc)         # (3, 5)
    for c in range(nc):
        P[4 * c : 4 * c + 5, 2 * c : 2 * c + 3] = Nv.T
    return P


def _dg_1d_embedding(nc: int) -> np.ndarray:
    """DG-P1 coarse (nc cells) -> fine (2nc cells): evaluate the coarse
    linear at fine nodes xi = {0, 1/2} and {1/2, 1}."""
    E = np.array([[1.0, 0.0], [0.5, 0.5], [0.5, 0.5], [0.0, 1.0]])
    P = np.zeros((4 * nc, 2 * nc))
    for c in range(nc):
        P[4 * c : 4 * c + 4, 2 * c : 2 * c + 2] = E
    return P


def _axis_matmul(M: torch.Tensor, x: torch.Tensor, axis: int) -> torch.Tensor:
    y = torch.tensordot(M, x, dims=([1], [axis]))
    return torch.movedim(y, 0, axis)


@dataclasses.dataclass
class RT1Prolongation:
    """Exact RT1 embedding coarse -> fine, applied as per-axis dense
    tensordots (small 1D factor matrices; plain matrix products)."""

    mats: tuple                       # per comp: tuple of per-axis matrices
    coarse_cells: Tuple[int, ...]
    mask_fine: tuple = None           # per-comp flat free masks

    def matvec(self, u):
        dim = len(self.coarse_cells)
        out = []
        for d in range(dim):
            g = u[d].reshape(rt1_dof_shape(self.coarse_cells, d))
            for a in range(dim):
                g = _axis_matmul(self.mats[d][a], g, a)
            g = g.reshape(-1)
            if self.mask_fine is not None:
                g = g * self.mask_fine[d]
            out.append(g)
        return tuple(out)


@dataclasses.dataclass
class RT1Restriction:
    """Adjoint of RT1Prolongation (residual restriction; exact Galerkin
    pairing with the nested embedding)."""

    mats: tuple
    coarse_cells: Tuple[int, ...]
    mask_coarse: tuple = None
    mask_fine: tuple = None

    def matvec(self, r):
        dim = len(self.coarse_cells)
        fine_cells = tuple(2 * n for n in self.coarse_cells)
        out = []
        for d in range(dim):
            g = r[d]
            if self.mask_fine is not None:
                g = g * self.mask_fine[d]
            g = g.reshape(rt1_dof_shape(fine_cells, d))
            for a in range(dim):
                g = _axis_matmul(self.mats[d][a].T, g, a)
            g = g.reshape(-1)
            if self.mask_coarse is not None:
                g = g * self.mask_coarse[d]
            out.append(g)
        return tuple(out)


def rt1_transfer_pair(coarse_cells, mask_fine=None, mask_coarse=None, dtype=torch.float64,
                      device=None):
    """(RT1Prolongation, RT1Restriction) on `coarse_cells`; the 1D factors
    in the torch `dtype` on `device`."""
    dev = resolve_device(device)
    dim = len(coarse_cells)
    mats = []
    for d in range(dim):
        per_axis = []
        for a in range(dim):
            nc = coarse_cells[a]
            M = _p2_1d_embedding(nc) if a == d else _dg_1d_embedding(nc)
            per_axis.append(torch.from_numpy(M).to(dev, dtype))
        mats.append(tuple(per_axis))
    mats = tuple(mats)
    P = RT1Prolongation(mats, tuple(coarse_cells), mask_fine)
    R = RT1Restriction(mats, tuple(coarse_cells), mask_coarse, mask_fine)
    return P, R


# -- vertex-star patches ------------------------------------------------------


def rt1_vertex_patches(ncells: Tuple[int, ...]) -> PatchTopology:
    """One patch per interior vertex holding the RT1 velocity dofs interior
    to its 2^d-cell star (the reference's PatchTopology(ReferenceFE{0})
    star assembly): per comp d, the 3 interior C0-P2 layers along d times
    all 4 DG nodes per transverse axis."""
    dim = len(ncells)
    shapes = [rt1_dof_shape(ncells, d) for d in range(dim)]
    sizes = [int(np.prod(s)) for s in shapes]
    offs = np.cumsum([0] + sizes)
    n_total = int(offs[-1])
    dummy = n_total

    interior = [np.arange(1, n) for n in ncells]
    verts = np.stack(
        np.meshgrid(*interior, indexing="ij"), axis=-1
    ).reshape(-1, dim)

    cols = []
    for d in range(dim):
        strides = np.cumprod([1] + list(shapes[d][::-1]))[:-1][::-1]
        ranges = []
        for a in range(dim):
            if a == d:
                ranges.append(np.array([-1, 0, 1]))      # around 2 v_d
            else:
                ranges.append(np.array([-2, -1, 0, 1]))  # both cells' DG
        for combo in itertools.product(*[range(len(r)) for r in ranges]):
            coords = np.empty_like(verts)
            for a in range(dim):
                coords[:, a] = 2 * verts[:, a] + ranges[a][combo[a]]
            cols.append(offs[d] + coords @ strides)
    table = np.stack(cols, axis=1).astype(np.int32)
    return PatchTopology(dofs=table, dummy=dummy, n_dofs=n_total)


# -- GMG ----------------------------------------------------------------------


def rt1_gmg(ncells, num_levels: int, alpha: float = 1.0e2, niter: int = 10,
            omega: float = 0.2, dtype=torch.float64, device=None, **kw):
    """GMG for the augmented RT1 velocity block: vertex-star Vanka
    smoothers (Richardson niter x omega, the reference's
    RichardsonSmoother(PatchSolver, 10, 0.2)) and exact nested RT1
    transfers. Returns (GMGSolver, A_fine, free_masks); `kw` goes to
    GMGSolver."""
    from ..linear.gmg import GMGSolver
    from ..linear.smoothers import RichardsonSmoother
    from ..patches.vanka import VankaSolver

    dev = resolve_device(device)
    levels = [
        tuple(n // (2 ** l) for n in ncells) for l in range(num_levels)
    ]
    ops, frees = [], []
    for lc in levels:
        A, masks = rt1_velocity_operator(lc, alpha, dtype=dtype, device=dev)
        ops.append(A)
        frees.append(tuple(torch.from_numpy((~m).astype(np.float64)).to(dev, dtype)
                           for m in masks))

    prolongs, restricts, smoothers = [], [], []
    for l in range(num_levels - 1):
        P, R = rt1_transfer_pair(
            levels[l + 1], mask_fine=frees[l], mask_coarse=frees[l + 1], dtype=dtype,
            device=dev,
        )
        prolongs.append(P)
        restricts.append(R)
        topo = rt1_vertex_patches(levels[l])
        smoothers.append(
            RichardsonSmoother(
                VankaSolver(topo=topo, omega=1.0, weighting="unit"),
                niter=niter,
                omega=omega,
            )
        )
    return GMGSolver(
        coarse_ops=tuple(ops[1:]),
        prolongations=tuple(prolongs),
        restrictions=tuple(restricts),
        smoother=smoothers,
        **kw,
    ), ops[0], frees[0]


# -- Darcy RT1 x P1disc problem ----------------------------------------------


@dataclasses.dataclass
class DarcyRT1Problem:
    ncells: Tuple[int, ...]
    A: BlockOperator
    b: tuple
    x_exact: tuple
    Mp: object
    alpha: float

    def residual_norm(self, x) -> float:
        return float(pt.norm(pt.sub(self.b, self.A.matvec(x))))

    def velocity_error(self, u) -> float:
        e = 0.0
        for ud, ue in zip(u, self.x_exact[0]):
            e += float(torch.max(torch.abs(ud - ue)))
        return e


def darcy_rt1_problem(
    ncells: Tuple[int, ...], alpha: float = 1.0e2, dtype=torch.float64, device=None
) -> DarcyRT1Problem:
    """The reference DarcyGMG problem at order 2: RT1 x P1disc with
    u = (x+y, -y[, 0]), p = 2x - 1 (both exactly representable, so the
    discrete solution IS their interpolant), essential flux BCs on the
    whole boundary, augmented system

        [ M + alpha G   -B^T ] [u]   [g]
        [      B          0  ] [p] = [F]

    RHS built consistently as the constrained operator applied to the
    interpolated exact pair plus BC lifting (DarcyGMG.jl:62-79). Operators
    and vectors in the torch `dtype` on `device` (None: the card)."""
    dev = resolve_device(device)
    dim = len(ncells)
    S = rt1_blocks(ncells, 1.0)
    masks = rt1_boundary_masks(ncells)
    Kv, _ = rt1_velocity_operator(ncells, alpha, blocks=S, dtype=dtype, device=dev)

    # B per component (cell-major P1disc rows), velocity BC columns zeroed
    Bs, BTs = [], []
    for d in range(dim):
        B_full = rt1_pressure_rows(S["B"][d], dim)
        Bc = asm.zero_columns(B_full, masks[d])
        Bs.append(ell_from_scipy(Bc.tocsr(), dtype=dtype, device=dev))
        BTs.append(ell_from_scipy((-Bc.T).tocsr(), dtype=dtype, device=dev))

    A = BlockOperator(
        (
            (Kv, ColumnStack(tuple(BTs))),
            (RowStack(tuple(Bs)), None),
        )
    )

    # exact pair interpolants on the dof grids
    h = S["h"]
    u_ex = []
    for d in range(dim):
        shape = rt1_dof_shape(ncells, d)
        axes = []
        for a in range(dim):
            if a == d:  # C0-P2 node positions
                axes.append(np.linspace(0, 1, shape[a]))
            else:       # DG-P1 node positions (cell endpoints, duplicated)
                e = np.empty(shape[a])
                e[0::2] = np.arange(ncells[a]) * h[a]
                e[1::2] = (np.arange(ncells[a]) + 1) * h[a]
                axes.append(e)
        X = np.meshgrid(*axes, indexing="ij")
        if d == 0:
            vals = X[0] + X[1]
        elif d == 1:
            vals = -X[1]
        else:
            vals = np.zeros_like(X[0])
        u_ex.append(vals.reshape(-1))
    # p = 2x - 1 in the cell-monomial basis {1, xi_a - 1/2}: per cell,
    # constant = 2 x_center - 1, slope_x = 2 h_x, other slopes 0
    n_cells = int(np.prod(ncells))
    centers = np.meshgrid(
        *[(np.arange(n) + 0.5) * hh for n, hh in zip(ncells, h)],
        indexing="ij",
    )
    p_ex = np.zeros((n_cells, dim + 1))
    p_ex[:, 0] = (2.0 * centers[0] - 1.0).reshape(-1)
    p_ex[:, 1] = 2.0 * h[0]
    p_ex = p_ex.reshape(-1)

    def vec(v):
        return torch.from_numpy(np.ascontiguousarray(v)).to(dev, dtype)

    x_exact = (tuple(vec(u) for u in u_ex), vec(p_ex))
    b = A.matvec(x_exact)  # consistent RHS (identity rows carry BC values)
    return DarcyRT1Problem(
        ncells=tuple(ncells),
        A=A,
        b=b,
        x_exact=x_exact,
        Mp=ell_from_scipy(S["Mp"], dtype=dtype, device=dev),
        alpha=alpha,
    )


def darcy_rt1_solver(ncells, num_levels: int, alpha: float = 1.0e2,
                     rtol: float = 1e-10, maxiter: int = 30,
                     gmg_cycles: int = 3, dtype=torch.float64, device=None):
    """The reference's full DarcyGMG solver (DarcyGMG.jl:96-118): FGMRES +
    upper block-triangular [velocity GMG, -(1/alpha) Mp Jacobi-CG],
    coeffs [[1,1],[0,1]]. `gmg_cycles` is passed on as the GMG's `maxiter`,
    as the JAX package passes it; a GMG in preconditioner mode runs
    `ncycles` (1) V-cycles an apply and reads no `maxiter`."""
    from ..blocks import BlockTriangularSolver, MatrixBlock
    from ..linear import CGSolver, FGMRESSolver, JacobiSolver

    dev = resolve_device(device)
    gmg, _, _ = rt1_gmg(
        ncells, num_levels, alpha, mode="preconditioner",
        maxiter=gmg_cycles, dtype=dtype, device=dev,
    )
    S = rt1_blocks(ncells, 1.0)
    Mp = ell_from_scipy((-1.0 / alpha) * S["Mp"], dtype=dtype, device=dev)
    prec = BlockTriangularSolver(
        solvers=(gmg, CGSolver(Pl=JacobiSolver(), rtol=1e-6, maxiter=20)),
        blocks=((None, None), (None, MatrixBlock(Mp))),
        coeffs=((1.0, 1.0), (0.0, 1.0)),
        half="upper",
    )
    return FGMRESSolver(m=20, Pr=prec, rtol=rtol, maxiter=maxiter)
