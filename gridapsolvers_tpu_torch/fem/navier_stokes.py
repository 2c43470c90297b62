"""Steady incompressible Navier-Stokes (2D, Taylor-Hood Q2/Q1 or Q2/P1disc).

Port of `gridapsolvers_tpu/fem/navier_stokes.py` (reference
test/Applications/NavierStokes.jl, NavierStokesGMG.jl:80-176): Newton on

    R(u, p) = [ nu K u + C(u) u + Bᵀ p - f ;  B u ]

with velocity Dirichlet BCs: homogeneous with a manufactured solution
(bc='mms') or the lid-driven cavity (bc='cavity'). The host assembles once
(NumPy/scipy, as in the JAX package) the Q2 sparsity pattern, its ELL
layout and the slot of every (cell, i, j) pair in it; each Newton step's
convection reassembly then runs on the operator's device: a contraction of
the cell velocities with precontracted quadrature tables (plain tensor
algebra, as the JAX package's einsums are) and one `index_add_` into the
ELL values (on CUDA its sums run in no fixed order). Every velocity block
is an `ELLMatrix` over the pattern's `cols`, `row_len` and `group` (rows
of 25, 15 or 9 entries by node class), so each apply is one kernel K3
launch that reads each row to its length.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ..algebra import BlockOperator, ELLMatrix
from ..algebra.block import ColumnStack, RowStack
from ..algebra.ell import ell_from_scipy
from ..nonlinear import NonlinearOperator
from ..ops.ell_spmv import group_size
from ..utils import pytrees as pt
from ..utils import resolve_device
from . import assembly2 as asm
from .elements import TensorElement, graddiv_element
from .mesh import CartesianMesh
from .stokes import _A_POLY, _poly_eval, cavity_lift, exact_pressure, exact_velocity
from .stokes import forcing as stokes_forcing


def _csr_slot_map(S: sp.csr_matrix, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """slot[e] such that ELL(values)[rows[e], slot[e]] is entry
    (rows[e], cols[e]) of S, on rows' device (int32, rows' shape); relies
    on CSR and ELL storing each row's entries in ascending column order."""
    dev = rows.device
    indptr = torch.from_numpy(S.indptr.astype(np.int64)).to(dev)
    all_keys = (torch.repeat_interleave(torch.arange(S.shape[0], device=dev), indptr.diff())
                * S.shape[1] + torch.from_numpy(S.indices.astype(np.int64)).to(dev))
    keys = (rows.to(torch.int64) * S.shape[1] + cols.to(torch.int64)).reshape(-1)
    pos = torch.searchsorted(all_keys, keys).clamp_(max=all_keys.numel() - 1)
    if not bool((all_keys[pos] == keys).all()):
        raise ValueError("_csr_slot_map: an entry is not in the pattern")
    slots = pos - indptr[rows.reshape(-1).to(torch.int64)]
    return slots.reshape(rows.shape).to(torch.int32)


def ns_forcing(xy: np.ndarray, nu: float) -> np.ndarray:
    """f = -nu lap(u) + (u.grad)u + grad(p) for the Stokes manufactured u, p."""
    f = stokes_forcing(xy, nu)  # -nu lap u + grad p
    x, y = xy[:, 0], xy[:, 1]
    a = _A_POLY
    av = _poly_eval(a, x)
    a1 = _poly_eval(a, x, 1)
    a2 = _poly_eval(a, x, 2)
    bv = _poly_eval(a, y)
    b1 = _poly_eval(a, y, 1)
    b2 = _poly_eval(a, y, 2)
    # u = (a b', -a' b)
    f[:, 0] += av * a1 * b1 * b1 - av * a1 * bv * b2
    f[:, 1] += -av * a2 * bv * b1 + a1 * a1 * bv * b1
    return f


def _q2_tables(mesh: CartesianMesh, nu: float, dtype, dev) -> dict:
    """The Q2 convection machinery of one mesh, shared by the problem and
    every `Q2ConvectionAssembler`: the stiffness sparsity pattern (zeros
    kept) and its ELL layout, the constrained nu K values with an identity
    diagonal on Dirichlet rows, the free masks, the quadrature tables, the
    connectivity and each (cell, i, j) pair's slot in the pattern. The host
    assembles; the slot search runs on `dev`."""
    mask_u = asm.boundary_node_mask(mesh, 2)
    free = (~mask_u).astype(np.float64)
    n_u = asm.num_nodes(mesh, 2)
    pattern = asm.assemble_bilinear(mesh, 2, "stiffness", scale=1.0)
    pattern.sort_indices()
    ell_pat = ell_from_scipy(pattern, device=dev)
    rows_nnz = np.repeat(np.arange(n_u), np.diff(pattern.indptr))
    cols_nnz = pattern.indices
    kdata = nu * pattern.data * free[rows_nnz] * free[cols_nnz]
    kdata = kdata + ((rows_nnz == cols_nnz) & mask_u[rows_nnz])
    K_con = sp.csr_matrix((kdata, pattern.indices, pattern.indptr), pattern.shape)
    free_t = torch.from_numpy(free).to(dev, dtype)
    elem = TensorElement(2, mesh.h, nquad=4)
    conn = torch.from_numpy(asm.connectivity(mesh, 2).astype(np.int64)).to(dev)

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    nn = conn.shape[1]
    return {
        "mask_u": mask_u, "free": free, "pattern": pattern, "rows_nnz": rows_nnz,
        "n_u": n_u, "cols_ell": ell_pat.cols, "row_len": ell_pat.row_len, "group": ell_pat.group,
        "base_vals": ell_from_scipy(K_con, dtype=dtype, device=dev).values,
        "mask_ell": free_t[:, None] * free_t[ell_pat.cols.long()],
        "free_u": free_t,
        "phi": tensor(elem._phi_table(None)),
        "dphi": tensor(np.stack([elem._phi_table(d) for d in range(mesh.dim)])),
        "wq": tensor(elem.quad_weights()),
        "conn": conn,
        "slots": _csr_slot_map(pattern, conn[:, :, None].expand(-1, nn, nn),
                               conn[:, None, :].expand(-1, nn, nn)),
    }


def _scatter_index(conn: torch.Tensor, slots: torch.Tensor, K: int) -> torch.Tensor:
    """Flat position in the (n_u, K) ELL values of every (cell, i, j) pair."""
    return (conn[:, :, None] * K + slots.to(torch.int64)).reshape(-1)


@dataclasses.dataclass
class NavierStokesProblem(NonlinearOperator):
    """Nonlinear operator and exact-solution record."""

    mesh: CartesianMesh
    nu: float
    # pattern and values
    cols_ell: torch.Tensor           # (n_u, K) shared ELL pattern (Q2), int32
    n_u: int
    base_vals: torch.Tensor          # constrained nu*K values + identity diag
    mask_ell: torch.Tensor           # rowfree * colfree per (row, slot)
    free_u: torch.Tensor             # (n_u,) 1/0 free velocity dof mask
    # quadrature tables
    phi: torch.Tensor                # (nn, nq)
    dphi: torch.Tensor               # (d, nn, nq)
    wq: torch.Tensor                 # (nq,)
    conn: torch.Tensor               # (ncells, nn) int64
    slots: torch.Tensor              # (ncells, nn, nn) int32
    # Stokes coupling blocks + rhs + exact solution
    BTs: tuple
    Bs: tuple
    Mp: ELLMatrix
    Mu: ELLMatrix
    f: tuple
    u_exact: Optional[tuple]
    p_exact: Optional[torch.Tensor]
    # constant grad-div values on the shared ELL pattern, (d, d) nested
    # tuple (augmented-Lagrangian NS, reference NavierStokesGMG.jl:108-125);
    # None for the plain formulation
    gd_vals: tuple = None
    # lid-driven cavity extras, None for MMS. lift_g: per-component
    # boundary values g (reference NavierStokesGMG.jl:101-106: u = (1, 0) on
    # the lid, Re = 1/nu); res_vals / gd_res_vals / res_Bs: row-masked-only
    # (columns kept, no identity) operator values for the residual action,
    # so couplings from boundary values into interior rows are kept; the
    # constrained rows are overwritten with u_i - g_i instead
    lift_g: tuple = None
    res_vals: torch.Tensor = None
    gd_res_vals: tuple = None
    res_Bs: tuple = None
    row_mask_ell: torch.Tensor = None
    # the pattern's real entries a row and K3's lanes a row: every velocity
    # ELLMatrix the problem builds carries them (the JAX package's ELL has
    # none; `convert.navier_stokes_problem` supplies them)
    row_len: Optional[torch.Tensor] = None
    group: Optional[int] = None

    def __post_init__(self):
        if self.group is None and self.row_len is not None:
            self.group = group_size(self.cols_ell.shape[1],
                                    float(self.row_len.double().mean()))
        self.scatter_index = _scatter_index(self.conn, self.slots, self.cols_ell.shape[1])

    # -- assembly -------------------------------------------------------

    def _ell(self, vals) -> ELLMatrix:
        """An ELLMatrix over the shared pattern (cols, row_len, group)."""
        return ELLMatrix(vals, self.cols_ell, self.n_u, self.row_len, self.group)

    def _u_cell(self, u) -> torch.Tensor:
        # MMS (g = 0): free-mask the velocity before gathering, keeping the
        # Jacobian (whose rows/cols are masked) consistent with the
        # residual's u-dependence. Cavity (g != 0): convection sees the true
        # iterate including the lid velocity; Newton consistency holds
        # because constrained dofs never move
        if getattr(self, "lift_g", None) is not None:
            return torch.stack([ui[self.conn] for ui in u], dim=-1)
        return torch.stack([(ui * self.free_u)[self.conn] for ui in u], dim=-1)

    def _convection_elems(self, u, newton: bool):
        """N1_e (c, i, j) = ∫ v_i (u·∇) w_j and, with `newton`, N2_e as a
        (d, d) nested tuple of (c, i, j) tensors: N2_ab = ∫ v_i w_j ∂_b u_a.
        The JAX package's einsums over quadrature points, with the
        quadrature weights and shape functions contracted first."""
        u_cell = self._u_cell(u)                                  # (c, nn, d)
        c, nn, d = u_cell.shape
        nq = self.wq.shape[0]
        u_q = torch.einsum("cnd,nq->cqd", u_cell, self.phi)      # (c, q, d)
        # T1[q, b, i, j] = w_q phi_i(q) ∂_b phi_j(q)
        T1 = torch.einsum("q,iq,bjq->qbij", self.wq, self.phi, self.dphi)
        N1 = (u_q.reshape(c, nq * d) @ T1.reshape(nq * d, nn * nn)).reshape(c, nn, nn)
        if not newton:
            return N1, None
        # T2[q, i, j] = w_q phi_i(q) phi_j(q); grad_u[c, q, a, b] = ∂_b u_a
        T2 = torch.einsum("q,iq,jq->qij", self.wq, self.phi, self.phi).reshape(nq, nn * nn)
        grad_u = torch.einsum("cna,bnq->cqab", u_cell, self.dphi)
        N2 = tuple(tuple((grad_u[:, :, a, b] @ T2).reshape(c, nn, nn) for b in range(d))
                   for a in range(d))
        return N1, N2

    def _scatter(self, elems: torch.Tensor, mask=None) -> torch.Tensor:
        """(ncells, nn, nn) element values -> masked ELL values (n_u, K).
        mask defaults to the row*col free mask (Jacobian); pass
        row_mask_ell for the residual action of the cavity problem."""
        vals = torch.zeros(self.base_vals.numel(), dtype=elems.dtype, device=elems.device)
        vals.index_add_(0, self.scatter_index, elems.reshape(-1))
        return vals.reshape(self.base_vals.shape) * (self.mask_ell if mask is None else mask)

    def velocity_block(self, u, newton: bool = True) -> BlockOperator:
        """d x d velocity Jacobian block δ_ab (nu K + N1) + N2_ab [+ G_ab];
        the grad-div term is linear in u, so the same values serve the
        residual action and the Jacobian."""
        N1, N2 = self._convection_elems(u, newton)
        vals_N1 = self._scatter(N1)
        gd = getattr(self, "gd_vals", None)
        d = len(u)
        blocks = []
        for a in range(d):
            row = []
            for b in range(d):
                terms = []
                if a == b:
                    terms += [self.base_vals, vals_N1]
                if gd is not None:
                    terms.append(gd[a][b])
                if N2 is not None:
                    terms.append(self._scatter(N2[a][b]))
                vals = terms[0] if terms else torch.zeros_like(self.base_vals)
                for t in terms[1:]:
                    vals = vals + t
                row.append(self._ell(vals))
            blocks.append(tuple(row))
        return BlockOperator(tuple(blocks))

    # -- NonlinearOperator protocol -------------------------------------

    def jacobian(self, x):
        u, _ = x
        return BlockOperator(((self.velocity_block(u, newton=True), ColumnStack(self.BTs)),
                              (RowStack(self.Bs), None)))

    def picard_jacobian(self, x):
        u, _ = x
        return BlockOperator(((self.velocity_block(u, newton=False), ColumnStack(self.BTs)),
                              (RowStack(self.Bs), None)))

    def residual(self, x):
        u, p = x
        if getattr(self, "lift_g", None) is not None:
            return self._residual_cavity(u, p)
        Auu = self.velocity_block(u, newton=False)  # action: (nu K + N1(u)) u
        r_u = Auu.matvec(u)
        grad_p = ColumnStack(self.BTs).matvec(p)
        r_u = tuple(ru + gp - fi for ru, gp, fi in zip(r_u, grad_p, self.f))
        return (r_u, RowStack(self.Bs).matvec(u))

    def _residual_cavity(self, u, p):
        """Inhomogeneous-Dirichlet residual: row-masked-only operators act
        on the full iterate (boundary-to-interior couplings kept), then the
        constrained rows are overwritten with the BC residual u_i - g_i.
        The Jacobian stays the masked velocity_block: constrained rows are
        identity with zero residual at the BC, so Newton keeps du_i = 0."""
        d = len(u)
        N1, _ = self._convection_elems(u, newton=False)
        Adiag = self._ell(self.res_vals + self._scatter(N1, mask=self.row_mask_ell))
        grad_p = ColumnStack(self.BTs).matvec(p)
        gd = getattr(self, "gd_res_vals", None)
        bdry = 1.0 - self.free_u
        r_u = []
        for a in range(d):
            ra = Adiag.matvec(u[a]) + grad_p[a] - self.f[a]
            if gd is not None:
                for b in range(d):
                    ra = ra + self._ell(gd[a][b]).matvec(u[b])
            r_u.append(ra + bdry * (u[a] - self.lift_g[a]))
        r_p = None
        for Bc, uc in zip(self.res_Bs, u):
            r_p = Bc.matvec(uc) if r_p is None else r_p + Bc.matvec(uc)
        return (tuple(r_u), r_p)

    def initial_guess(self):
        """BC-consistent start: the lift for the cavity, zero for MMS."""
        if getattr(self, "lift_g", None) is None:
            return self.zero_guess()
        return (tuple(self.lift_g), torch.zeros_like(self.Mp.values[:, 0]))

    # -- diagnostics ----------------------------------------------------

    def velocity_error(self, u) -> float:
        err = 0.0
        for ui, uei in zip(u, self.u_exact):
            e = ui - uei
            err += float(pt.dot(e, self.Mu.matvec(e)))
        return float(np.sqrt(err))

    def zero_guess(self):
        z = torch.zeros_like(self.free_u)
        return (tuple(torch.zeros_like(z) for _ in range(self.mesh.dim)),
                torch.zeros_like(self.Mp.values[:, 0]))


def _graddiv_ell_vals(obj, mesh: CartesianMesh, alpha: float, mask=None) -> tuple:
    """Constant grad-div values on obj's shared ELL pattern: the cell-local
    element blocks (elements.graddiv_element) scattered through the same
    slot tables the convection assembly uses. mask defaults to the
    Jacobian row*col free mask; pass the row-only mask for the cavity
    residual action."""
    Ge = graddiv_element(TensorElement(2, mesh.h, nquad=3), alpha)
    d = mesh.dim
    ncells = obj.conn.shape[0]
    dtype, dev = obj.base_vals.dtype, obj.base_vals.device
    return tuple(
        tuple(obj._scatter(torch.from_numpy(Ge[a][b]).to(dev, dtype)
                           .expand(ncells, *Ge[a][b].shape), mask=mask) for b in range(d))
        for a in range(d))


def navier_stokes_problem(
    ncells: Tuple[int, int],
    nu: float = 1.0,
    dtype=torch.float64,
    graddiv_alpha: float = 0.0,
    bc: str = "mms",
    device=None,
) -> NavierStokesProblem:
    """The Navier-Stokes problem in the torch `dtype` on `device` (None: the
    card); host assembly in f64, as in the JAX package.

    graddiv_alpha > 0 selects the augmented-Lagrangian formulation of the
    reference's NavierStokesGMG.jl:108-125 (alpha = 1e3 there): the
    residual and Jacobian gain the cell-local grad-div term and the
    pressure space becomes P1disc, so the augmentation is consistent and
    the Schur complement is spectrally -(1/alpha) Mp.

    bc='mms' (default): homogeneous Dirichlet + manufactured solution.
    bc='cavity': the lid-driven cavity with u = (1, 0) on the top-face
    interior, zero forcing, Re = 1/nu (NavierStokesGMG.jl:101-106 runs Re =
    10); start Newton from `initial_guess()` (or zero) and the residual
    acts through row-masked-only operators on the full iterate."""
    if len(ncells) != 2:
        raise ValueError(f"navier_stokes_problem: 2D only, got {len(ncells)}D")
    if bc not in ("mms", "cavity"):
        raise ValueError(f"navier_stokes_problem: unknown bc {bc!r}")
    dev = resolve_device(device)
    dim = 2
    mesh = CartesianMesh(tuple(ncells), (0.0, 1.0, 0.0, 1.0))
    t = _q2_tables(mesh, nu, dtype, dev)
    mask_u, n_u = t["mask_u"], t["n_u"]

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    def ell(S):
        return asm.to_ell(S, dtype=dtype, device=dev)

    # Stokes coupling blocks (velocity columns constrained); the
    # unconstrained B_fulls drive the cavity residual's constraint row
    Bs, BTs, B_fulls = [], [], []
    for c in range(dim):
        if graddiv_alpha > 0.0:
            B_full = asm.assemble_divergence_pdisc(mesh, 2, c)
        else:
            B_full = asm.assemble_divergence(mesh, 2, 1, c)
        B_fulls.append(B_full)
        B_csr = asm.zero_columns(B_full, mask_u)
        Bs.append(ell(B_csr))
        BTs.append(ell(B_csr.T.tocsr()))

    Mu = ell(asm.assemble_bilinear(mesh, 2, "mass"))
    if graddiv_alpha > 0.0:
        Mp = ell(asm.pdisc_mass_matrix(mesh))
        p_ex = asm.project_pdisc(mesh, exact_pressure)
    else:
        Mp = ell(asm.assemble_bilinear(mesh, 1, "mass"))
        p_ex = exact_pressure(asm.node_coords(mesh, 1))

    if bc == "mms":
        coords_u = asm.node_coords(mesh, 2)
        u_ex = exact_velocity(coords_u)
        f_nodal = ns_forcing(coords_u, nu)
        mask_t = torch.from_numpy(mask_u).to(dev)
        f = tuple(torch.where(mask_t, 0.0, Mu.matvec(tensor(f_nodal[:, c]))) for c in range(dim))
        u_exact = tuple(tensor(u_ex[:, c]) for c in range(dim))
        p_exact = tensor(p_ex)
    else:
        # lid-driven cavity: zero forcing, no exact solution
        f = tuple(torch.zeros(n_u, dtype=dtype, device=dev) for _ in range(dim))
        u_exact, p_exact = None, None

    prob = NavierStokesProblem(
        mesh=mesh, nu=nu, cols_ell=t["cols_ell"], n_u=n_u, base_vals=t["base_vals"],
        mask_ell=t["mask_ell"], free_u=t["free_u"], phi=t["phi"], dphi=t["dphi"], wq=t["wq"],
        conn=t["conn"], slots=t["slots"], BTs=tuple(BTs), Bs=tuple(Bs), Mp=Mp, Mu=Mu, f=f,
        u_exact=u_exact, p_exact=p_exact, row_len=t["row_len"], group=t["group"])
    if graddiv_alpha > 0.0:
        prob.gd_vals = _graddiv_ell_vals(prob, mesh, graddiv_alpha)
    if bc == "cavity":
        free, pattern, rows_nnz = t["free"], t["pattern"], t["rows_nnz"]
        prob.row_mask_ell = t["free_u"][:, None].expand_as(t["mask_ell"]).contiguous()
        # row-masked-only nu*K (columns kept, no identity diagonal)
        K_res = sp.csr_matrix((nu * pattern.data * free[rows_nnz], pattern.indices,
                               pattern.indptr), pattern.shape)
        prob.lift_g = tuple(tensor(g) for g in cavity_lift(mesh))
        prob.res_vals = ell_from_scipy(K_res, dtype=dtype, device=dev).values
        prob.res_Bs = tuple(ell(Bf) for Bf in B_fulls)
        if graddiv_alpha > 0.0:
            prob.gd_res_vals = _graddiv_ell_vals(prob, mesh, graddiv_alpha,
                                                 mask=prob.row_mask_ell)
    return prob


# ---------------------------------------------------------------------------
# Nonlinear GMG for the velocity block (reference GMGLinearSolverFromWeakform
# with is_nonlinear=true, GMGLinearSolvers.jl:78-94,125-158: per-level
# Jacobians reassembled at the solution iterate restricted down the
# hierarchy by solution-mode restrictions).
# ---------------------------------------------------------------------------


class Q2ConvectionAssembler:
    """Per-mesh Q2 convection machinery (the part of NavierStokesProblem's
    assembly a GMG level needs): velocity_block(u, newton) builds the d x d
    ELL Jacobian block at nodal velocity u, over the level's pattern
    (`cols_ell`, `row_len`, `group`)."""

    def __init__(self, mesh: CartesianMesh, nu: float, dtype=torch.float64,
                 graddiv_alpha: float = 0.0, bc: str = "mms", device=None):
        dev = resolve_device(device)
        self.mesh = mesh
        # cavity: _u_cell must see the full iterate (lid values included); a
        # non-None lift_g switches the shared _u_cell off free-masking
        self.lift_g = () if bc == "cavity" else None
        t = _q2_tables(mesh, nu, dtype, dev)
        for key in ("n_u", "cols_ell", "row_len", "group", "base_vals", "mask_ell", "free_u",
                    "phi", "dphi", "wq", "conn", "slots"):
            setattr(self, key, t[key])
        self.scatter_index = _scatter_index(self.conn, self.slots, self.cols_ell.shape[1])
        self.gd_vals = (_graddiv_ell_vals(self, mesh, graddiv_alpha)
                        if graddiv_alpha > 0.0 else None)

    # NavierStokesProblem's assembly methods, shared by duck typing
    _ell = NavierStokesProblem._ell
    _u_cell = NavierStokesProblem._u_cell
    _convection_elems = NavierStokesProblem._convection_elems
    _scatter = NavierStokesProblem._scatter
    velocity_block = NavierStokesProblem.velocity_block


def ns_velocity_gmg(
    ncells: Tuple[int, int],
    num_levels: int,
    nu: float = 1.0,
    smoother=None,
    dtype=torch.float64,
    graddiv_alpha: float = 0.0,
    vanka_engine: str = "batched",
    cheby_degree: int = 0,
    bc: str = "mms",
    device=None,
    **kw,
):
    """GMG preconditioner for the Navier-Stokes velocity block with
    nonlinear level reassembly: level Jacobians are rebuilt at the current
    Newton iterate, carried down the hierarchy by solution-mode (injection)
    restrictions (the reference's primal_restrictions +
    gmg_project_solutions!). Operators and transfers in `dtype` on
    `device` (None: the card); `kw` goes to `GMGSolver` (`ncycles`,
    `kernelize_levels`, ...).

    graddiv_alpha > 0: the augmented configuration of the reference's
    NavierStokesGMG.jl:131-150: per-level Jacobians gain the grad-div
    term, the smoothers are vertex-star patch Vanka (batched, or with any
    other `vanka_engine` materialized into one SpMV a field block),
    re-extracted at each Newton iterate through GMG's update, under
    Richardson(10, 0.2) or, with cheby_degree > 0, Chebyshev of that degree;
    the transfers are the exact Q2 FE embedding, and the prolongations
    carry a patch correction (batched Vanka on coarse-cell interiors)
    built on the Stokes part K + G of the Jacobian at u = 0 and
    re-extracted at each Newton iterate's level Jacobian by GMG's update
    (the reference's update_transfer_operator!)."""
    from ..linear.gmg import GMGSolver
    from ..linear.smoothers import ChebyshevSmoother
    from ..multilevel.hierarchy import cartesian_hierarchy
    from ..multilevel.multifield import MultiFieldTransfer
    from ..multilevel.transfer import StructuredProlongation, StructuredRestriction

    dim = len(ncells)
    dev = resolve_device(device)
    hierarchy = cartesian_hierarchy(ncells, num_levels)
    assemblers = [Q2ConvectionAssembler(m, nu, dtype, graddiv_alpha=graddiv_alpha, bc=bc,
                                        device=dev) for m in hierarchy.meshes]

    def free(mesh):
        return torch.from_numpy((~asm.boundary_node_mask(mesh, 2)).astype(np.float64)).to(
            dev, dtype)

    prolongs, restricts, sol_restricts = [], [], []
    for l in range(num_levels - 1):
        fine, coarse = hierarchy[l], hierarchy[l + 1]
        fshape = asm.node_grid_shape(fine, 2)
        cshape = asm.node_grid_shape(coarse, 2)
        Rsol = StructuredRestriction(fshape, cshape, "solution")
        sol_restricts.append(MultiFieldTransfer(tuple(Rsol for _ in range(dim))))
        if graddiv_alpha > 0.0:
            # geometry only: the separable dense lowering of the exact FE pair
            from ..multilevel.transfer import fe_transfer_pair_dense

            Pe, Re = fe_transfer_pair_dense(coarse.ncells, 2, asm.boundary_node_mask(fine, 2),
                                             asm.boundary_node_mask(coarse, 2), dtype=dtype,
                                             device=dev)
            prolongs.append(MultiFieldTransfer(tuple(Pe for _ in range(dim))))
            restricts.append(MultiFieldTransfer(tuple(Re for _ in range(dim))))
        else:
            mf, mc = free(fine), free(coarse)
            P = StructuredProlongation(fshape, cshape, mf)
            R = StructuredRestriction(fshape, cshape, "residual", mc, mf)
            prolongs.append(MultiFieldTransfer(tuple(P for _ in range(dim))))
            restricts.append(MultiFieldTransfer(tuple(R for _ in range(dim))))

    if graddiv_alpha > 0.0:
        from ..linear.smoothers import PreconditionedChebyshevSmoother, RichardsonSmoother
        from .stokes import graddiv_patch_prolongation, velocity_vanka_smoother

        if smoother is None:
            if cheby_degree > 0:
                # Chebyshev over the Vanka iteration ('unit' weighting: SPD)
                smoother = [PreconditionedChebyshevSmoother(
                    M=velocity_vanka_smoother(m, omega=1.0, engine=vanka_engine),
                    degree=cheby_degree) for m in hierarchy.meshes[:-1]]
            else:
                smoother = [RichardsonSmoother(
                    velocity_vanka_smoother(m, omega=1.0, engine=vanka_engine),
                    niter=10, omega=0.2) for m in hierarchy.meshes[:-1]]
        # the patch prolongations from the assemblers' own operators (K + G
        # at u = 0), so they share the convection pattern's ELL layout that
        # GMGSolver.update re-extracts them from at each Newton iterate
        for l in range(num_levels - 1):
            a_l = assemblers[l]
            zero_u = tuple(torch.zeros_like(a_l.free_u) for _ in range(dim))
            K0 = a_l.velocity_block(zero_u, newton=True)
            G_op = BlockOperator(tuple(tuple(a_l._ell(a_l.gd_vals[a][b]) for b in range(dim))
                                       for a in range(dim)))
            prolongs[l] = graddiv_patch_prolongation(hierarchy[l], hierarchy[l + 1],
                                                     prolongs[l], K0, G_op)

    def matrices_fn(A_fine, u):
        # A_fine: the fine-level velocity block at the current iterate;
        # coarser Jacobians are reassembled at the injected iterate
        if u is None:
            u = tuple(torch.zeros_like(assemblers[0].free_u) for _ in range(dim))
        mats = [A_fine]
        u_lev = u
        for l in range(1, num_levels):
            u_lev = sol_restricts[l - 1].matvec(u_lev)
            mats.append(assemblers[l].velocity_block(u_lev, newton=True))
        return mats

    return GMGSolver(
        matrices_fn=matrices_fn,
        solution_restrictions=tuple(sol_restricts),
        prolongations=tuple(prolongs),
        restrictions=tuple(restricts),
        smoother=smoother or ChebyshevSmoother(degree=3, ratio=50.0),
        **kw,
    )
