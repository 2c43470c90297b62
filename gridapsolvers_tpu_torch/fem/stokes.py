"""Stokes saddle-point systems (Taylor-Hood Q2/Q1 on structured grids).

Port of `gridapsolvers_tpu/fem/stokes.py`, its plain parts. Mirrors the
reference's Stokes application (test/Applications/Stokes.jl:60-112,
StokesGMG.jl:79-166): velocity in [Q2]^d with full Dirichlet BCs,
pressure in Q1 (zero-mean) or cell-local P1disc, block system

    [ K   Bᵀ ] [u]   [f]
    [ B   0  ] [p] = [0]

assembled on the host (fem/assembly2.py) into a 2x2 `BlockOperator` on the
requested device: the (0,0) entry is a `FieldwiseOperator` of one banded
Q2 stiffness (`StencilMatrix` on the Q2 node grid, 5^d offsets, kernel
K2) per component, the couplings are `ColumnStack`/`RowStack`s of
rectangular `ELLMatrix` blocks (kernel K3), and the Q1 pressure mass is a
banded 3^d `StencilMatrix` (K2). A manufactured divergence-free
polynomial solution gives L2-error validation.

The augmented-Lagrangian variant (`graddiv_alpha > 0`, Q2/P1disc, the
reference's StokesGMG.jl configuration) has a velocity block of banded
component blocks `K δ_cd + G_cd` (K2); engine='flat' runs every velocity
block as an `ELLMatrix` (K3, algebra/flat.py) and smooths with
materialized patch smoothers (patches/materialized.py). Its GMG smooths
with vertex-star Vanka and prolongates with coarse-cell patch
corrections over exact FE transfers.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..algebra import BlockOperator, ELLMatrix
from ..algebra.block import ColumnStack, FieldwiseOperator, RowStack
from ..algebra.stencil import stencil_from_scipy
from ..utils import pytrees as pt
from ..utils import resolve_device
from . import assembly2 as asm
from .mesh import CartesianMesh


# -- manufactured solution (2D): u = curl psi, psi = x^2(1-x)^2 y^2(1-y)^2 ---

_A_POLY = np.polynomial.Polynomial([0.0, 0.0, 1.0, -2.0, 1.0])  # x^2(1-x)^2


def _poly_eval(p, x, deriv=0):
    return p.deriv(deriv)(x) if deriv else p(x)


def exact_velocity(xy: np.ndarray) -> np.ndarray:
    """2D: u = (a(x) b'(y), -a'(x) b(y)); 3D: the same rotational field
    modulated by w(z) = a(z): u = (a b' w, -a' b w, 0). Divergence-free and
    zero on the unit-box boundary in both cases."""
    a = _A_POLY
    x, y = xy[:, 0], xy[:, 1]
    if xy.shape[1] == 2:
        ux = _poly_eval(a, x) * _poly_eval(a, y, 1)
        uy = -_poly_eval(a, x, 1) * _poly_eval(a, y)
        return np.stack([ux, uy], axis=1)
    z = xy[:, 2]
    w = _poly_eval(a, z)
    ux = _poly_eval(a, x) * _poly_eval(a, y, 1) * w
    uy = -_poly_eval(a, x, 1) * _poly_eval(a, y) * w
    return np.stack([ux, uy, np.zeros_like(ux)], axis=1)


def exact_pressure(xy: np.ndarray) -> np.ndarray:
    """p = sum(x_d) - dim/2 (zero mean on the unit box)."""
    return xy.sum(axis=1) - 0.5 * xy.shape[1]


def forcing(xy: np.ndarray, nu: float) -> np.ndarray:
    """f = -nu * lap(u) + grad(p)."""
    a = _A_POLY
    x, y = xy[:, 0], xy[:, 1]
    if xy.shape[1] == 2:
        lap_ux = _poly_eval(a, x, 2) * _poly_eval(a, y, 1) + _poly_eval(
            a, x
        ) * _poly_eval(a, y, 3)
        lap_uy = -(
            _poly_eval(a, x, 3) * _poly_eval(a, y)
            + _poly_eval(a, x, 1) * _poly_eval(a, y, 2)
        )
        fx = -nu * lap_ux + 1.0
        fy = -nu * lap_uy + 1.0
        return np.stack([fx, fy], axis=1)
    z = xy[:, 2]
    w, w2 = _poly_eval(a, z), _poly_eval(a, z, 2)
    lap_ux = (
        _poly_eval(a, x, 2) * _poly_eval(a, y, 1) * w
        + _poly_eval(a, x) * _poly_eval(a, y, 3) * w
        + _poly_eval(a, x) * _poly_eval(a, y, 1) * w2
    )
    lap_uy = -(
        _poly_eval(a, x, 3) * _poly_eval(a, y) * w
        + _poly_eval(a, x, 1) * _poly_eval(a, y, 2) * w
        + _poly_eval(a, x, 1) * _poly_eval(a, y) * w2
    )
    fx = -nu * lap_ux + 1.0
    fy = -nu * lap_uy + 1.0
    fz = np.full_like(fx, 1.0)
    return np.stack([fx, fy, fz], axis=1)


@dataclasses.dataclass
class StokesProblem:
    mesh: CartesianMesh
    A: BlockOperator            # [[K, B^T], [B, None]] (constrained)
    b: tuple                    # ((b_ux, b_uy), b_p)
    Mu: ELLMatrix               # Q2 mass (velocity components, unconstrained)
    Mp: object                  # pressure mass (banded Q1 / ELL P1disc)
    u_exact: Optional[tuple]
    p_exact: Optional[torch.Tensor]
    dirichlet_mask_u: np.ndarray
    nu: float
    # coefficient vector of the constant-1 pressure function (all-ones for
    # nodal Q1; cell-mean indicator for P1disc): the zero-mean direction
    const_p: Optional[torch.Tensor] = None

    @property
    def K(self) -> FieldwiseOperator:
        return self.A.block(0, 0)

    def velocity_error(self, u) -> float:
        """||u - u_exact|| in L2, through the Q2 mass."""
        err = 0.0
        for ui, uei in zip(u, self.u_exact):
            e = ui - uei
            err += float(pt.dot(e, self.Mu.matvec(e)))
        return float(np.sqrt(err))

    def pressure_error(self, p) -> float:
        """||p - p_exact|| in L2 up to the constant nullspace (both
        demeaned through the pressure mass)."""
        ones = self.const_p if self.const_p is not None else torch.ones_like(p)
        vol = pt.dot(ones, self.Mp.matvec(ones))

        def demean(q):
            return q - (pt.dot(ones, self.Mp.matvec(q)) / vol) * ones

        e = demean(p) - demean(self.p_exact)
        return float(torch.sqrt(pt.dot(e, self.Mp.matvec(e))))

    def residual_norm(self, x) -> float:
        """||b - A x||_2 over every block."""
        return float(pt.norm(pt.sub(self.b, self.A.matvec(x))))


def graddiv_velocity_block(
    mesh: CartesianMesh,
    nu: float,
    alpha: float,
    return_graddiv: bool = False,
    K_full=None,
    Gs=None,
    banded: bool = False,
    dtype=None,
    device=None,
):
    """Augmented-Lagrangian velocity block (reference StokesGMG.jl:107-110):

        a(u,v) = nu ∫∇u:∇v + alpha ∫(∇·v) Π_Q(∇·u)

    with Π_Q the CELL-LOCAL L2 projection onto discontinuous P1 (the
    reference's LocalProjectionMap), assembled as the component-block
    matrix K δ_cd + G_cd from one cell-local element block
    (elements.graddiv_element). Cell-locality makes ker(G) decompose over
    vertex patches, which the alpha-robustness of patch smoothers and
    patch prolongations rests on. The term vanishes on the discrete
    constraint manifold (Bp u = 0 for the P1disc pressure), so augmenting
    the system leaves its solution unchanged.

    banded=True packs every (c,d) block as a `StencilMatrix` on the Q2 node
    grid (5^d offsets, kernel K2); otherwise as an `ELLMatrix` (K3) with
    zeros dropped. Operators are in the torch `dtype` (None: f64) on
    `device` (None: the card). return_graddiv also returns the BlockOperator
    of the G_cd blocks alone."""
    dim = len(mesh.ncells)
    dev = resolve_device(device)
    mask_u = asm.boundary_node_mask(mesh, 2)
    if K_full is None:
        K_full = asm.assemble_bilinear(mesh, 2, "stiffness", scale=nu)
    K_csr = asm.dirichlet_square(K_full, mask_u)
    if Gs is None:
        Gs = asm.assemble_graddiv(mesh, 2, alpha)
    if banded:
        # every (c,d) block is grid-local on the SAME Q2 node grid, so it
        # bands to a StencilMatrix (5^d offset envelope) as the plain
        # velocity block does; Vanka/patch extraction reads stencil leaves
        # through algebra/ell_view.py
        gs_nodes = asm.node_grid_shape(mesh, 2)

        def _pack(S):
            return stencil_from_scipy(S.tocsr(), gs_nodes, dtype=dtype, device=dev)
    else:
        def _pack(S):
            S = S.tocsr()
            S.eliminate_zeros()
            return asm.to_ell(S, dtype=dtype, device=dev)

    rows, grows = [], []
    for c in range(dim):
        row, grow = [], []
        for d in range(dim):
            G = asm.zero_rows(asm.zero_columns(Gs[c][d], mask_u), mask_u)
            grow.append(_pack(G))
            row.append(_pack((G + K_csr).tocsr()) if c == d else grow[-1])
        rows.append(tuple(row))
        grows.append(tuple(grow))
    aug = BlockOperator(tuple(rows))
    if return_graddiv:
        return aug, BlockOperator(tuple(grows))
    return aug


def _vertex_star_topology(mesh: CartesianMesh):
    """Vertex-star patches of the Q2 velocity (all components): one patch
    per free mesh vertex, holding the free Q2 nodes of its open star
    (radius 1 on the Q2 node grid, stride 2)."""
    from ..patches.topology import concat_patches, vertex_star_patches

    dim = len(mesh.ncells)
    gs = asm.node_grid_shape(mesh, 2)
    free = ~asm.boundary_node_mask(mesh, 2).reshape(gs)
    t = vertex_star_patches(gs, free_mask=free, radius=1, stride=2)
    n_u = int(np.prod(gs))
    return concat_patches([t] * dim, [n_u] * dim)


def velocity_vanka_smoother(
    mesh: CartesianMesh, omega: float = 1.0, weighting: str = "unit",
    engine: str = "batched",
):
    """Vertex-star patch smoother on the (possibly grad-div augmented)
    velocity block: one patch per mesh vertex holding the Q2 velocity dofs
    (all components) INTERIOR to its 2^d surrounding cells (radius 1 on the
    Q2 node grid = the open star; including the patch-boundary nodes makes
    overlaps up to 3^d-fold and the additive iteration divergent), the
    reference's get_patch_smoothers Schöberl vertex-star decomposition
    (StokesGMG.jl:38-47). Matrix-extracted (BlockJacobiSolvers.jl).

    engine='batched': gather/solve/scatter VankaSolver. Anything else gives
    the MaterializedVankaSmoother (one SpMV a field block)."""
    from ..patches.vanka import VankaSolver

    topo = _vertex_star_topology(mesh)
    if engine != "batched":
        from ..patches.materialized import MaterializedVankaSmoother

        return MaterializedVankaSmoother(topo=topo, omega=omega, weighting=weighting)
    return VankaSolver(topo=topo, omega=omega, weighting=weighting)


def graddiv_patch_prolongation(
    fine_mesh, coarse_mesh, base, K_aug, G, engine: str = "block", band_dtype=None,
):
    """Coarse-cell-interior Vanka patch prolongation for grad-div augmented
    velocity GMG: xh = base(xH) - S_patch(G · base(xH)), the local LHS the
    full augmented operator restricted to DISJOINT coarse-cell interiors.

    engine='flat' materializes the patch solves into one SpMV a field
    block and runs the rhs operator G as a `BlockedKernelOperator`."""
    from ..patches.topology import coarse_cell_patches, concat_patches
    from ..patches.transfer import PatchProlongation
    from ..patches.vanka import VankaSolver

    dim = len(fine_mesh.ncells)
    gs = asm.node_grid_shape(fine_mesh, 2)
    free = ~asm.boundary_node_mask(fine_mesh, 2).reshape(gs)
    t = coarse_cell_patches(coarse_mesh.ncells, order=2, free_mask=free, interior=True)
    n_u = int(np.prod(gs))
    topo = concat_patches([t] * dim, [n_u] * dim)
    if engine == "flat":
        from ..algebra.flat import flat_kernel_operator
        from ..patches.materialized import MaterializedVankaSmoother

        vanka = MaterializedVankaSmoother(topo=topo, omega=1.0, weighting="unit",
                                          jacobi_uncovered=False, band_dtype=band_dtype)
        G = flat_kernel_operator(G, band_dtype=band_dtype)
    else:
        vanka = VankaSolver(topo=topo, omega=1.0, weighting="unit", jacobi_uncovered=False)
    return PatchProlongation(base, K_aug, vanka, vanka.setup(K_aug), rhs_op=G)


def cavity_lift(mesh: CartesianMesh, dtype=np.float64) -> tuple:
    """Lid-driven-cavity Dirichlet values on the Q2 node grid: u_x = 1 on
    the interior of the top face (the reference's `top` tag excludes the
    corners/edges, StokesGMG.jl:69-72,93-96), all other boundary values
    zero. Returns per-component flat NumPy arrays."""
    gs = asm.node_grid_shape(mesh, 2)
    dim = len(gs)
    ug = np.zeros(gs, dtype=dtype)
    idx = tuple([slice(1, -1)] * (dim - 1) + [gs[-1] - 1])
    ug[idx] = 1.0
    out = [ug.reshape(-1)]
    out.extend(np.zeros(int(np.prod(gs)), dtype=dtype) for _ in range(dim - 1))
    return tuple(out)


def stokes_problem(
    ncells: Tuple[int, ...],
    nu: float = 1.0,
    dtype=torch.float64,
    graddiv_alpha: float = 0.0,
    pressure: Optional[str] = None,
    bc: str = "mms",
    engine: str = "block",
    device=None,
) -> StokesProblem:
    """Taylor-Hood Q2/Q1 (pressure='q1', default) or the reference's
    Q2/P1disc pair (pressure='p1disc', StokesGMG.jl:91 `space=:P`), every
    operator and vector in the torch `dtype` on `device` (None: the
    card). Assembly runs on the host in f64, as in the JAX package.

    bc='mms' (default): homogeneous Dirichlet + manufactured solution.
    bc='cavity': the reference's actual StokesGMG problem, the lid-driven
    cavity with u = (1, 0, ..) on the top-face interior, zero forcing,
    inhomogeneous values lifted into the rhs (u_exact/p_exact are None).

    graddiv_alpha > 0 adds the augmented-Lagrangian grad-div term to the
    velocity block (implies the P1disc pressure: the term is the cell-local
    P1disc projection of the divergence, and the augmentation is consistent
    only with the matching constraint Bp u = 0). Its velocity block is a
    BlockOperator of banded component blocks (K2); engine='flat' turns it
    into a `BlockedKernelOperator` of ELL field blocks (K3). engine is
    ignored without the grad-div term, as in the JAX package."""
    dim = len(ncells)
    assert dim in (2, 3)
    assert bc in ("mms", "cavity")
    if pressure is None:
        pressure = "p1disc" if graddiv_alpha > 0.0 else "q1"
    assert pressure in ("q1", "p1disc")
    assert graddiv_alpha == 0.0 or pressure == "p1disc"
    dev = resolve_device(device)
    domain = tuple(x for _ in range(dim) for x in (0.0, 1.0))
    mesh = CartesianMesh(tuple(ncells), domain)

    def tensor(a):
        return torch.from_numpy(np.asarray(a)).to(device=dev, dtype=dtype)

    def ell(S):
        return asm.to_ell(S, dtype=dtype, device=dev)

    mask_u = asm.boundary_node_mask(mesh, 2)
    K_full = asm.assemble_bilinear(mesh, 2, "stiffness", scale=nu)
    K_csr = asm.dirichlet_square(K_full, mask_u)
    Mu_csr = asm.assemble_bilinear(mesh, 2, "mass")

    Bs, BTs, B_fulls = [], [], []
    for c in range(dim):
        if pressure == "p1disc":
            B_full = asm.assemble_divergence_pdisc(mesh, 2, c)
        else:
            B_full = asm.assemble_divergence(mesh, 2, 1, c)
        B_fulls.append(B_full)
        B_csr = asm.zero_columns(B_full, mask_u)      # velocity BCs
        Bs.append(ell(B_csr))
        BTs.append(ell(B_csr.T.tocsr()))

    Gs_full = asm.assemble_graddiv(mesh, 2, graddiv_alpha) if graddiv_alpha > 0.0 else None
    if graddiv_alpha > 0.0:
        # banded (StencilMatrix) component blocks K δ_cd + G_cd (kernel K2);
        # the Vanka/patch machinery reads them through algebra/ell_view.py
        Kv = graddiv_velocity_block(mesh, nu, graddiv_alpha, K_full=K_full, Gs=Gs_full,
                                    banded=True, dtype=dtype, device=dev)
        if engine == "flat":
            from ..algebra.flat import flat_kernel_operator

            Kv = flat_kernel_operator(Kv)
    else:
        # banded stencil on the Q2 node grid (5^d offset envelope), one
        # operator shared by every component: kernel K2
        K = stencil_from_scipy(K_csr, asm.node_grid_shape(mesh, 2), dtype=dtype, device=dev)
        Kv = FieldwiseOperator(tuple(K for _ in range(dim)))
    A = BlockOperator(((Kv, ColumnStack(tuple(BTs))), (RowStack(tuple(Bs)), None)))

    if pressure == "p1disc":
        Mp_csr = asm.pdisc_mass_matrix(mesh)
        p_ex = asm.project_pdisc(mesh, exact_pressure) if bc == "mms" else None
        n_p = asm.num_pdisc_dofs(mesh)
        # the constant function's coefficient vector (1 on the cell-mean
        # dof, 0 on the slopes): pressure_error demeans against it
        const_p = np.zeros(n_p)
        const_p[:: dim + 1] = 1.0
        Mp = ell(Mp_csr)
    else:
        Mp_csr = asm.assemble_bilinear(mesh, 1, "mass")
        p_ex = exact_pressure(asm.node_coords(mesh, 1)) if bc == "mms" else None
        n_p = asm.num_nodes(mesh, 1)
        const_p = np.ones(n_p)
        Mp = stencil_from_scipy(Mp_csr, asm.node_grid_shape(mesh, 1), dtype=dtype,
                                device=dev)  # banded Q1 mass (3^d)

    Mu = ell(Mu_csr)
    mask_t = torch.from_numpy(mask_u).to(dev)
    if bc == "mms":
        coords_u = asm.node_coords(mesh, 2)
        u_ex = exact_velocity(coords_u)
        f = forcing(coords_u, nu)
        # the load on the device (kernel K3), as the JAX package applies it
        b_u = tuple(
            torch.where(mask_t, 0.0, Mu.matvec(tensor(f[:, c]))) for c in range(dim)
        )
        u_exact = tuple(tensor(u_ex[:, c]) for c in range(dim))
        p_exact = tensor(p_ex)
        b_p = torch.zeros(n_p, dtype=dtype, device=dev)
    else:
        # lid-driven cavity: zero forcing, the inhomogeneous Dirichlet
        # values lifted into the rhs through the UNCONSTRAINED operators
        # on the host (identity rows carry the boundary values themselves)
        ug = cavity_lift(mesh)
        lift = []
        for c in range(dim):
            lc = K_full @ ug[c]
            if graddiv_alpha > 0.0:
                for d in range(dim):
                    lc = lc + Gs_full[c][d] @ ug[d]
            lift.append(lc)
        b_u = tuple(tensor(np.where(mask_u, ug[c], -lift[c])) for c in range(dim))
        b_p = tensor(-sum(B_fulls[c] @ ug[c] for c in range(dim)))
        u_exact, p_exact = None, None

    return StokesProblem(
        mesh=mesh,
        A=A,
        b=(b_u, b_p),
        Mu=Mu,
        Mp=Mp,
        u_exact=u_exact,
        p_exact=p_exact,
        dirichlet_mask_u=mask_u,
        nu=nu,
        const_p=tensor(const_p),
    )


def velocity_gmg(
    ncells: Tuple[int, ...],
    num_levels: int,
    nu: float = 1.0,
    smoother=None,
    graddiv_alpha: float = 0.0,
    engine: str = "block",
    flat_band_dtype=None,
    flat_vanka_dtype="same",
    cheby_degree: int = 0,
    dtype=torch.float64,
    device=None,
    **kw,
):
    """GMG preconditioner for the Stokes velocity block: per-level Q2 vector
    stiffness (a `FieldwiseOperator` of one banded `StencilMatrix`, kernel
    K2) with fieldwise factor-2 transfers on the Q2 node grids (the Q2 dof
    grid of mesh n IS the vertex grid of mesh 2n, so the structured
    transfer applies directly). Mirrors StokesGMG.jl:129-154, where GMG is
    built on the velocity FE-space hierarchy. Level operators and transfers
    are in `dtype` on `device` (None: the card); the finest level's
    operator is the one passed to `setup`. `kw` goes to `GMGSolver`
    (`ncycles`, `mode`, `coarsest_solver`, ...).

    graddiv_alpha > 0 assembles the augmented-Lagrangian velocity biform
    per level, smooths with vertex-star patch Vanka, Richardson(10, 0.2)
    (the reference's smoother, StokesGMG.jl:57) or, with cheby_degree > 0,
    Chebyshev of that degree over the Vanka (`PreconditionedChebyshevSmoother`),
    and transfers by exact Q2 FE embeddings (R = Pᵀ) with coarse-cell
    patch-corrected prolongations. engine='flat' runs every level operator
    as ELL field blocks (K3), materializes each level's Vanka into one SpMV
    a field block, and lowers the transfers to per-axis dense contractions
    (`fe_transfer_pair_dense`); the block engine keeps banded levels (K2),
    batched Vanka and ELL transfers (`fe_transfer_pair`, K3).

    flat_band_dtype: storage dtype of the flat level operators' values
    (bf16: f32 sums on K3). flat_vanka_dtype: that of the materialized
    Vanka matrices; "same" follows flat_band_dtype. The Vanka entries mix
    alpha-heavy (1e3) and O(1) scales inside each patch inverse, so bf16
    there can degrade convergence at fine h while bf16 level operators stay
    benign."""
    from ..linear.gmg import GMGSolver
    from ..linear.smoothers import ChebyshevSmoother
    from ..multilevel.hierarchy import cartesian_hierarchy
    from ..multilevel.multifield import MultiFieldTransfer
    from ..multilevel.transfer import StructuredProlongation, StructuredRestriction

    dim = len(ncells)
    dev = resolve_device(device)
    hierarchy = cartesian_hierarchy(ncells, num_levels)

    def free(mesh):
        m = (~asm.boundary_node_mask(mesh, 2)).astype(np.float64)
        return torch.from_numpy(m).to(device=dev, dtype=dtype)

    def assemble_K(mesh):
        m = asm.boundary_node_mask(mesh, 2)
        Kc = asm.dirichlet_square(asm.assemble_bilinear(mesh, 2, "stiffness", scale=nu), m)
        K1 = stencil_from_scipy(Kc, asm.node_grid_shape(mesh, 2), dtype=dtype, device=dev)
        return FieldwiseOperator(tuple(K1 for _ in range(dim)))

    if graddiv_alpha > 0.0 and smoother is None:
        from ..linear.smoothers import PreconditionedChebyshevSmoother, RichardsonSmoother

        def _vanka_for(m):
            if engine != "flat":
                return velocity_vanka_smoother(m, omega=1.0)
            from ..patches.materialized import MaterializedVankaSmoother

            vdt = flat_band_dtype if flat_vanka_dtype == "same" else flat_vanka_dtype
            return MaterializedVankaSmoother(topo=_vertex_star_topology(m), omega=1.0,
                                             weighting="unit", band_dtype=vdt)

        if cheby_degree > 0:
            # Chebyshev over the Vanka-preconditioned operator; Vanka with
            # 'unit' weighting is SPD, the Chebyshev requirement
            smoother = [PreconditionedChebyshevSmoother(M=_vanka_for(m), degree=cheby_degree)
                        for m in hierarchy.meshes[:-1]]
        else:
            smoother = [RichardsonSmoother(_vanka_for(m), niter=10, omega=0.2)
                        for m in hierarchy.meshes[:-1]]

    prolongs, restricts = [], []
    if graddiv_alpha > 0.0:
        # EXACT Q2 FE-embedding transfers (R = Pᵀ): with rediscretized level
        # operators the coarse correction is Galerkin on free dofs (the
        # linear node-grid transfer's embedding error is amplified by alpha).
        # Then patch-corrected prolongations (reference
        # setup_patch_prolongation_operators, StokesGMG.jl:127-130 +
        # PatchTransferOperators.jl:44-52): xh = Ih xH - S_patch(G_h Ih xH),
        # the local solves on DISJOINT coarse-cell interiors with the full
        # augmented operator, the right-hand side the grad-div term only.
        from ..multilevel.transfer import fe_transfer_pair, fe_transfer_pair_dense

        pairs = [graddiv_velocity_block(m, nu, graddiv_alpha, return_graddiv=True,
                                        banded=True, dtype=dtype, device=dev)
                 for m in hierarchy.meshes]
        level_ops = [p[0] for p in pairs]
        if engine == "flat":
            from ..algebra.flat import flat_kernel_operator

            level_ops = [flat_kernel_operator(op, band_dtype=flat_band_dtype)
                         for op in level_ops]
        coarse_ops = tuple(level_ops[1:])
        make_pair = fe_transfer_pair_dense if engine == "flat" else fe_transfer_pair
        for l in range(num_levels - 1):
            fine, coarse = hierarchy[l], hierarchy[l + 1]
            mask_f = asm.boundary_node_mask(fine, 2)
            mask_c = asm.boundary_node_mask(coarse, 2)
            Pe, Re = make_pair(coarse.ncells, 2, mask_f, mask_c, dtype=dtype, device=dev)
            base = MultiFieldTransfer(tuple(Pe for _ in range(dim)))
            restricts.append(MultiFieldTransfer(tuple(Re for _ in range(dim))))
            prolongs.append(graddiv_patch_prolongation(
                fine, coarse, base, level_ops[l], pairs[l][1], engine=engine,
                band_dtype=flat_band_dtype))
    else:
        for l in range(num_levels - 1):
            fine, coarse = hierarchy[l], hierarchy[l + 1]
            fshape = asm.node_grid_shape(fine, 2)
            cshape = asm.node_grid_shape(coarse, 2)
            mf, mc = free(fine), free(coarse)
            P = StructuredProlongation(fshape, cshape, mf)
            R = StructuredRestriction(fshape, cshape, "residual", mc, mf)
            prolongs.append(MultiFieldTransfer(tuple(P for _ in range(dim))))
            restricts.append(MultiFieldTransfer(tuple(R for _ in range(dim))))
        coarse_ops = tuple(assemble_K(m) for m in hierarchy.meshes[1:])

    return GMGSolver(
        coarse_ops=coarse_ops,
        prolongations=tuple(prolongs),
        restrictions=tuple(restricts),
        smoother=smoother or ChebyshevSmoother(degree=3),
        **kw,
    )
