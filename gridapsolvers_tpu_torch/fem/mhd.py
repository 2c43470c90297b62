"""3D multifield (MHD-like) system and its patch-smoothed GMG.

Port of `gridapsolvers_tpu/fem/mhd.py`, after the reference's hardest GMG
suite, gmg_multifield_driver (test/LinearSolvers/GMGTests.jl:325-359): the
3D coupled (u, j) system

    a((u,j),(v,w)) = ∫ β ∇u:∇v − γ (j×B)·v + j·w − (u×B)·w,   B = e_z

with u in [Q1]^3 (Dirichlet boundary) and j in RT0 (essential normal-flux
boundary), f = (1,1,1) forcing on u. On a uniform grid every block is a
Kronecker chain of 1D matrices, assembled on the host in scipy as in the
JAX package; each block becomes an `ELLMatrix` (kernel K3) on the
requested device. The GMG smoother is the batched Vanka over vertex
patches: the vertex's 3 nodal u-dofs and the 12 interior faces (j) of its
8-cell block, 15 dofs over the concatenated 6-field vector.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ..algebra import BlockOperator
from ..algebra.ell import ell_from_scipy
from ..patches.topology import PatchTopology
from ..utils import pytrees as pt
from ..utils import resolve_device
from . import assembly2 as asm2
from .darcy import _kron_chain, _rt0_mass_1d, rt0_blocks, rt0_boundary_masks
from .hdiv import RTComponentProlongation, RTComponentRestriction, _face_shape


def _hat_cell_1d(n: int, h: float) -> sp.csr_matrix:
    """(n+1, n) integrals of nodal hats over cells: ∫_cell φ_j = h/2 for
    the two cell-end nodes."""
    return sp.diags(
        [np.full(n, h / 2), np.full(n, h / 2)], [0, -1], shape=(n + 1, n)
    ).tocsr()


def _coupling(ncells, b: int) -> sp.csr_matrix:
    """C_b[node, b-face] = ∫ φ_node ψ_face — hat-hat mass along axis b,
    hat-cell integrals transverse (exact on the uniform grid)."""
    h = tuple(1.0 / n for n in ncells)
    parts = []
    for a, n in enumerate(ncells):
        if a == b:
            parts.append(_rt0_mass_1d(n + 1, h[a]))
        else:
            parts.append(_hat_cell_1d(n, h[a]))
    return _kron_chain(parts)


def _stiff_1d(n: int, h: float) -> sp.csr_matrix:
    main = np.full(n + 1, 2.0 / h)
    main[0] = main[-1] = 1.0 / h
    off = np.full(n, -1.0 / h)
    return sp.diags([off, main, off], [-1, 0, 1]).tocsr()


def _mass_1d(n: int, h: float) -> sp.csr_matrix:
    return _rt0_mass_1d(n + 1, h)


def _q1_stiffness(ncells) -> sp.csr_matrix:
    """Q1 nodal stiffness as a sum of Kronecker chains."""
    h = tuple(1.0 / n for n in ncells)
    K = None
    for d in range(len(ncells)):
        parts = [
            _stiff_1d(n, h[a]) if a == d else _mass_1d(n, h[a])
            for a, n in enumerate(ncells)
        ]
        term = _kron_chain(parts)
        K = term if K is None else (K + term).tocsr()
    return K


def _q1_mass(ncells) -> sp.csr_matrix:
    h = tuple(1.0 / n for n in ncells)
    return _kron_chain([_mass_1d(n, h[a]) for a, n in enumerate(ncells)])


@dataclasses.dataclass
class MHDProblem:
    ncells: Tuple[int, ...]
    A: BlockOperator               # 6x6 on (ux,uy,uz,jx,jy,jz)
    b: tuple
    free: tuple                    # per-field free masks (flat, float)

    def residual_norm(self, x) -> float:
        return float(pt.norm(pt.sub(self.b, self.A.matvec(x))))


def mhd_system(
    ncells: Tuple[int, int, int],
    beta: float = 1.0,
    gamma: float = 1.0,
    dtype=torch.float64,
    device=None,
) -> MHDProblem:
    """Assemble the 6-field (ux,uy,uz,jx,jy,jz) MHD block system with
    B = (0,0,1): j×B = (j_y, −j_x, 0), u×B = (u_y, −u_x, 0), in the torch
    `dtype` on `device` (None: the card)."""
    dev = resolve_device(device)
    dim = 3
    assert len(ncells) == dim
    n_node = int(np.prod([n + 1 for n in ncells]))
    node_shape = tuple(n + 1 for n in ncells)

    K = _q1_stiffness(ncells)
    rt = rt0_blocks(ncells)
    Cs = [_coupling(ncells, b) for b in range(dim)]

    # boundary masks
    mask_u = np.zeros(node_shape, dtype=bool)
    for d in range(dim):
        idx = [slice(None)] * dim
        idx[d] = 0
        mask_u[tuple(idx)] = True
        idx[d] = node_shape[d] - 1
        mask_u[tuple(idx)] = True
    mask_u = mask_u.reshape(-1)
    masks = [mask_u] * dim + list(rt0_boundary_masks(ncells))

    # 6x6 block grid; field order (ux, uy, uz, jx, jy, jz)
    blocks = [[None] * 6 for _ in range(6)]
    for a in range(dim):
        blocks[a][a] = beta * K
        blocks[3 + a][3 + a] = rt["M"][a]
    blocks[0][4] = -gamma * Cs[1]          # ux row: -γ ∫ j_y v_x
    blocks[1][3] = gamma * Cs[0]           # uy row: +γ ∫ j_x v_y
    blocks[3][1] = -Cs[0].T.tocsr()        # jx row: -∫ u_y w_x
    blocks[4][0] = Cs[1].T.tocsr()         # jy row: +∫ u_x w_y

    rows = []
    for a in range(6):
        row = []
        for b in range(6):
            S = blocks[a][b]
            if S is None:
                row.append(None)
                continue
            S = asm2.zero_rows(S.tocsr(), masks[a])
            S = asm2.zero_columns(S, masks[b])
            if a == b:
                S = (S + sp.diags(masks[a].astype(float))).tocsr()
            row.append(ell_from_scipy(S.tocsr(), dtype=dtype, device=dev))
        rows.append(tuple(row))
    A = BlockOperator(tuple(rows))

    def vec(v):
        return torch.from_numpy(np.ascontiguousarray(v)).to(device=dev, dtype=dtype)

    fu = _q1_mass(ncells) @ np.ones(n_node)
    b_u = [vec(np.where(mask_u, 0.0, fu)) for _ in range(dim)]
    b_j = [
        torch.zeros(int(np.prod(_face_shape(ncells, d))), dtype=dtype, device=dev)
        for d in range(dim)
    ]
    free = tuple(vec((~m).astype(np.float64)) for m in masks)
    return MHDProblem(ncells=tuple(ncells), A=A, b=tuple(b_u + b_j), free=free)


def mhd_vertex_patches(ncells: Tuple[int, int, int]) -> PatchTopology:
    """One patch per interior vertex over the concatenated 6-field vector:
    the vertex's 3 nodal u-dofs and the 12 interior faces of its 8-cell
    block (the dofs supported inside the vertex star)."""
    from .hdiv import hdiv_vertex_patches

    dim = 3
    node_shape = tuple(n + 1 for n in ncells)
    n_node = int(np.prod(node_shape))
    face_sizes = [int(np.prod(_face_shape(ncells, d))) for d in range(dim)]
    n_total = dim * n_node + sum(face_sizes)

    # interior vertices in the same order as hdiv_vertex_patches
    interior = [np.arange(1, n) for n in ncells]
    verts = np.stack(np.meshgrid(*interior, indexing="ij"), axis=-1).reshape(-1, dim)
    strides = np.cumprod([1] + list(node_shape[::-1]))[:-1][::-1]
    vflat = verts @ strides                      # (n_patches,)
    u_cols = np.stack([a * n_node + vflat for a in range(dim)], axis=1)

    jt = hdiv_vertex_patches(ncells)             # faces, offset by 3*n_node
    j_cols = jt.dofs.astype(np.int64) + dim * n_node
    table = np.concatenate([u_cols, j_cols], axis=1).astype(np.int32)
    return PatchTopology(dofs=table, dummy=n_total, n_dofs=n_total)


def mhd_gmg(
    ncells: Tuple[int, int, int],
    num_levels: int,
    beta: float = 1.0,
    gamma: float = 1.0,
    omega: float = 0.3,
    niter: int = 2,
    dtype=torch.float64,
    device=None,
    **kw,
):
    """GMG for the MHD multifield system: vertex-patch Vanka smoothing,
    per-field transfers (nodal Q1 for u, RT0 for j). Operators in the torch
    `dtype` on `device` (None: the card); `kw` goes to GMGSolver. Returns
    (gmg, problem)."""
    levels = [tuple(n // (2 ** l) for n in ncells) for l in range(num_levels)]
    probs = [mhd_system(lc, beta, gamma, dtype=dtype, device=device) for lc in levels]
    return mhd_gmg_from_problems(probs, omega, niter, **kw), probs[0]


def mhd_gmg_from_problems(probs, omega: float = 0.3, niter: int = 2, **kw):
    """The GMGSolver of `mhd_gmg` over given level problems (finest
    first, each level halving the cells)."""
    from ..linear.gmg import GMGSolver
    from ..linear.smoothers import RichardsonSmoother
    from ..multilevel.multifield import MultiFieldTransfer
    from ..multilevel.transfer import StructuredProlongation, StructuredRestriction
    from ..patches.vanka import VankaSolver

    prolongs, restricts, smoothers = [], [], []
    for pf, pc in zip(probs[:-1], probs[1:]):
        fine_c, coarse_c = pf.ncells, pc.ncells
        fns = tuple(n + 1 for n in fine_c)
        cns = tuple(n + 1 for n in coarse_c)
        ops_P, ops_R = [], []
        for a in range(3):
            ops_P.append(StructuredProlongation(fns, cns, pf.free[a]))
            ops_R.append(StructuredRestriction(fns, cns, "residual", pc.free[a], pf.free[a]))
        for d in range(3):
            ops_P.append(RTComponentProlongation(coarse_c, d, pf.free[3 + d]))
            ops_R.append(RTComponentRestriction(coarse_c, d, pc.free[3 + d], pf.free[3 + d]))
        prolongs.append(MultiFieldTransfer(tuple(ops_P)))
        restricts.append(MultiFieldTransfer(tuple(ops_R)))
        smoothers.append(
            RichardsonSmoother(
                VankaSolver(topo=mhd_vertex_patches(fine_c), omega=1.0, weighting="unit"),
                niter=niter,
                omega=omega,
            )
        )
    return GMGSolver(
        coarse_ops=tuple(p.A for p in probs[1:]),
        prolongations=tuple(prolongs),
        restrictions=tuple(restricts),
        smoother=smoothers,
        **kw,
    )
