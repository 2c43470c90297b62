"""Mixed Darcy flow (lowest-order Raviart-Thomas RT0 on structured quads).

Port of `gridapsolvers_tpu/fem/darcy.py`. Mirrors the reference's Darcy
applications (test/Applications/DarcyGMG.jl, RT elements): find (u, p) with

    u + k grad(p) = 0,   div u = f        (unit permeability here)

discretized RT0 x Q0:  [ M  -Bᵀ ] [u]   [g]
                       [ B   0  ] [p] = [F]

with u·n = exact flux on the boundary (essential in H(div)) and p defined
up to a constant. RT0 on a uniform quad grid is face-based: ux on vertical
faces (nx+1, ny), uy on horizontal faces (nx, ny+1), p on cells. The blocks
are assembled on the host in scipy as Kronecker chains of 1D pieces, as in
the JAX package, and every block becomes an `ELLMatrix` (kernel K3) on the
requested device.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ..algebra import BlockOperator
from ..algebra.block import ColumnStack, FieldwiseOperator, RowStack
from ..algebra.ell import ell_from_scipy
from ..utils import pytrees as pt
from ..utils import resolve_device
from . import assembly2 as asm


def _rt0_mass_1d(n_faces: int, h: float) -> sp.csr_matrix:
    """1D P1-hat mass matrix on face nodes (interior hats + boundary halves)."""
    main = np.full(n_faces, 2.0 * h / 3.0)
    main[0] = main[-1] = h / 3.0
    off = np.full(n_faces - 1, h / 6.0)
    return sp.diags([off, main, off], [-1, 0, 1]).tocsr()


def _dmat(n: int) -> sp.csr_matrix:
    """1D cell<-face difference (divergence) incidence."""
    return sp.diags(
        [np.full(n, -1.0), np.full(n, 1.0)], [0, 1], shape=(n, n + 1)
    ).tocsr()


def _kron_chain(mats) -> sp.csr_matrix:
    out = mats[0]
    for m in mats[1:]:
        out = sp.kron(out, m)
    return out.tocsr()


def rt0_blocks(ncells: Tuple[int, ...]):
    """Dimension-general RT0 blocks on a uniform unit-box grid.

    Component d lives on d-normal faces, grid shape = ncells with axis d
    bumped by one. Everything is a tensor (kron) product of 1D pieces:
    mass = hat-hat along the normal axis x cell measures transverse;
    divergence = 1D incidence along the normal axis x identities.
    Returns dict with per-component lists M (face masses), B (divergence
    contributions, rows = cells), face_shapes, h."""
    dim = len(ncells)
    h = tuple(1.0 / n for n in ncells)
    M, B, face_shapes = [], [], []
    for d in range(dim):
        m_parts, b_parts = [], []
        for a in range(dim):
            if a == d:
                m_parts.append(_rt0_mass_1d(ncells[a] + 1, h[a]))
                b_parts.append(_dmat(ncells[a]))
            else:
                m_parts.append(sp.identity(ncells[a]) * h[a])
                b_parts.append(sp.identity(ncells[a]))
        M.append(_kron_chain(m_parts))
        # scale divergence by the transverse face measure
        area = np.prod([h[a] for a in range(dim) if a != d])
        B.append(_kron_chain(b_parts) * area)
        face_shapes.append(
            tuple(n + 1 if a == d else n for a, n in enumerate(ncells))
        )
    return dict(M=M, B=B, face_shapes=face_shapes, h=h, ncells=tuple(ncells))


def rt0_boundary_masks(ncells: Tuple[int, ...]):
    """Essential (normal-flux) boundary masks per face family: faces lying
    ON the boundary normal to their axis."""
    dim = len(ncells)
    masks = []
    for d in range(dim):
        shape = tuple(n + 1 if a == d else n for a, n in enumerate(ncells))
        m = np.zeros(shape, dtype=bool)
        idx = [slice(None)] * dim
        idx[d] = 0
        m[tuple(idx)] = True
        idx[d] = shape[d] - 1
        m[tuple(idx)] = True
        masks.append(m.reshape(-1))
    return masks


def darcy_system(ncells: Tuple[int, int]):
    """Assemble the RT0/Q0 Darcy blocks (2D wrapper around rt0_blocks)."""
    nx, ny = ncells
    S = rt0_blocks(ncells)
    return dict(
        Mx=S["M"][0], My=S["M"][1], Bx=S["B"][0], By=S["B"][1],
        nx=nx, ny=ny, hx=S["h"][0], hy=S["h"][1],
    )


@dataclasses.dataclass
class DarcyProblem:
    ncells: Tuple[int, int]
    A: BlockOperator              # [[M, -B^T],[B, 0]] on ((ux,uy), p)
    b: tuple
    u_exact: tuple                # face-normal components
    p_exact: torch.Tensor         # cell values
    cell_volume: float

    def pressure_error(self, p) -> float:
        dp = (p - torch.mean(p)) - (self.p_exact - torch.mean(self.p_exact))
        return float(torch.sqrt(torch.sum(dp ** 2) * self.cell_volume))

    def residual_norm(self, x) -> float:
        return float(pt.norm(pt.sub(self.b, self.A.matvec(x))))


def darcy_problem(
    ncells: Tuple[int, int], graddiv_alpha: float = 0.0, dtype=torch.float64, device=None
) -> DarcyProblem:
    """Manufactured solution p = cos(pi x) cos(pi y), u = -grad p.

    graddiv_alpha > 0 augments the velocity block with the div-div term
    alpha Bᵀ D⁻¹ B (the reference DarcyGMG.jl:70-72 biform_u = mass +
    graddiv, alpha = 1e2): the solver-friendly formulation whose Schur
    complement is spectrally -(1/alpha) Mp. Here div u = f ≠ 0, so
    consistency requires the matching rhs shift alpha Bᵀ D⁻¹ F: the
    discrete solution is unchanged EXACTLY. Operators and vectors are in
    the torch `dtype` on `device` (None: the card)."""
    dev = resolve_device(device)
    S = darcy_system(ncells)
    nx, ny, hx, hy = S["nx"], S["ny"], S["hx"], S["hy"]

    def ell(M):
        return ell_from_scipy(M, dtype=dtype, device=dev)

    def vec(v):
        return torch.from_numpy(np.ascontiguousarray(v)).to(device=dev, dtype=dtype)

    # face centers
    xs_f = np.linspace(0, 1, nx + 1)
    yc = (np.arange(ny) + 0.5) * hy
    xc = (np.arange(nx) + 0.5) * hx
    ys_f = np.linspace(0, 1, ny + 1)

    def p_fn(x, y):
        return np.cos(np.pi * x) * np.cos(np.pi * y)

    def ux_fn(x, y):
        return np.pi * np.sin(np.pi * x) * np.cos(np.pi * y)

    def uy_fn(x, y):
        return np.pi * np.cos(np.pi * x) * np.sin(np.pi * y)

    def f_fn(x, y):
        return 2 * np.pi ** 2 * np.cos(np.pi * x) * np.cos(np.pi * y)

    UX = ux_fn(xs_f[:, None], yc[None, :])            # (nx+1, ny)
    UY = uy_fn(xc[:, None], ys_f[None, :])            # (nx, ny+1)
    P = p_fn(xc[:, None], yc[None, :])                # (nx, ny)
    F = f_fn(xc[:, None], yc[None, :]) * hx * hy      # cell integrals of f

    # essential BC: boundary normal fluxes pinned to the exact values via
    # identity rows + lifting
    mask_x = np.zeros((nx + 1, ny), bool)
    mask_x[0, :] = mask_x[-1, :] = True
    mask_y = np.zeros((nx, ny + 1), bool)
    mask_y[:, 0] = mask_y[:, -1] = True

    def constrain(M, mask):
        m = mask.reshape(-1)
        Mc = asm.zero_rows(M, m)
        Mc = asm.zero_columns(Mc, m)
        return (Mc + sp.diags(m.astype(float))).tocsr()

    Mx_full, My_full = S["Mx"], S["My"]
    Bx_full, By_full = S["Bx"], S["By"]
    Mx = constrain(Mx_full, mask_x)
    My = constrain(My_full, mask_y)
    Bx = asm.zero_columns(Bx_full, mask_x.reshape(-1))
    By = asm.zero_columns(By_full, mask_y.reshape(-1))

    if graddiv_alpha > 0.0:
        cellvol = hx * hy
        Dinv = sp.diags(
            np.full(nx * ny, graddiv_alpha / cellvol)
        )
        Bc, Ms = [Bx, By], [Mx, My]
        rows = []
        for a in range(2):
            row = []
            for c in range(2):
                G = (Bc[a].T @ (Dinv @ Bc[c])).tocsr()
                if a == c:
                    G = (G + Ms[a]).tocsr()
                row.append(ell(G))
            rows.append(tuple(row))
        u_block = BlockOperator(tuple(rows))
    else:
        u_block = FieldwiseOperator((ell(Mx), ell(My)))
    A = BlockOperator(
        (
            (u_block, ColumnStack((ell((-Bx.T).tocsr()), ell((-By.T).tocsr())))),
            (RowStack((ell(Bx), ell(By))), None),
        )
    )

    # RHS: g = 0 (no gravity) with lifting of the essential flux BCs
    uxg = np.where(mask_x, UX, 0.0).reshape(-1)
    uyg = np.where(mask_y, UY, 0.0).reshape(-1)
    g_x = -(Mx_full @ uxg)
    g_y = -(My_full @ uyg)
    g_x = np.where(mask_x.reshape(-1), UX.reshape(-1), g_x)
    g_y = np.where(mask_y.reshape(-1), UY.reshape(-1), g_y)
    F_lift = F.reshape(-1) - Bx_full @ uxg - By_full @ uyg
    # compatibility: free-face divergence sums to zero per construction, so
    # project the (quadrature-inconsistent) rhs onto the solvable range
    F_lift = F_lift - F_lift.mean()

    if graddiv_alpha > 0.0:
        # consistency shift: at the discrete solution B u = F_lift, so the
        # added alpha Bᵀ D⁻¹ B u equals alpha Bᵀ D⁻¹ F_lift exactly
        w = (graddiv_alpha / (hx * hy)) * F_lift
        g_x = g_x + Bx.T @ w
        g_y = g_y + By.T @ w

    return DarcyProblem(
        ncells=ncells,
        A=A,
        b=((vec(g_x), vec(g_y)), vec(F_lift)),
        u_exact=(vec(UX.reshape(-1)), vec(UY.reshape(-1))),
        p_exact=vec(P.reshape(-1)),
        cell_volume=hx * hy,
    )
