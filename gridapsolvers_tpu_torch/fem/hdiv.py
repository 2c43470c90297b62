"""H(div) machinery: RT0 grid transfers and H(div) GMG (2D and 3D).

Port of `gridapsolvers_tpu/fem/hdiv.py`. Mirrors the reference's hdiv GMG
suite (test/LinearSolvers/GMGTests.jl hdiv tests) — the H(div) model
operator

    a(u, v) = ∫ u·v + ∫ div u div v

on lowest-order Raviart-Thomas (RT0) face elements, preconditioned by GMG
with vertex-patch smoothers (the Arnold-Falk-Winther smoothing that makes
multigrid robust in H(div); plain Jacobi is NOT robust here).

- RT0 prolongation on structured quads factorizes per component into a 1D
  linear interpolation along the component's normal direction and nearest
  duplication transverse (`repeat_interleave`); restriction is its exact
  transpose (full weighting and pair sums). Both are plain tensor
  operations, as in the JAX package.
- vertex patches (the faces meeting each interior vertex) become one
  padded index table over the concatenated (ux | uy) vector and run as the
  batched Vanka solver. Every operator block is an `ELLMatrix` (kernel K3).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ..algebra import BlockOperator
from ..algebra.ell import ell_from_scipy
from ..multilevel.transfer import _expand_dim, _reduce_dim
from ..patches.topology import PatchTopology
from ..utils import resolve_device
from . import assembly2 as asm2


def _face_shape(ncells, d) -> Tuple[int, ...]:
    return tuple(n + 1 if a == d else n for a, n in enumerate(ncells))


def _repeat_axis(x: torch.Tensor, a: int) -> torch.Tensor:
    return torch.repeat_interleave(x, 2, dim=a)


def _pairsum_axis(x: torch.Tensor, a: int) -> torch.Tensor:
    """Transpose of _repeat_axis: sum adjacent pairs along axis a."""
    n2 = x.shape[a]
    shape = x.shape[:a] + (n2 // 2, 2) + x.shape[a + 1:]
    return x.reshape(shape).sum(dim=a + 1)


@dataclasses.dataclass
class RTComponentProlongation:
    """RT0 prolongation of ONE face family (coarse -> fine), any dimension:
    component `comp` interpolates linearly along its normal axis (face
    positions are node-like there) and duplicates across the transverse
    cell axes (normal-flux density is constant transverse)."""

    coarse_cells: Tuple[int, ...]
    comp: int
    mask_fine: Optional[torch.Tensor] = None  # optional flat free mask

    def matvec(self, u):
        d = self.comp
        f = _expand_dim(u.reshape(_face_shape(self.coarse_cells, d)), d)
        for a in range(len(self.coarse_cells)):
            if a != d:
                f = _repeat_axis(f, a)
        f = f.reshape(-1)
        if self.mask_fine is not None:
            f = f * self.mask_fine
        return f


@dataclasses.dataclass
class RTComponentRestriction:
    """Transpose of RTComponentProlongation (residual restriction)."""

    coarse_cells: Tuple[int, ...]
    comp: int
    mask_coarse: Optional[torch.Tensor] = None
    mask_fine: Optional[torch.Tensor] = None

    def matvec(self, r):
        d = self.comp
        fine_cells = tuple(2 * n for n in self.coarse_cells)
        x = r
        if self.mask_fine is not None:
            x = x * self.mask_fine
        x = x.reshape(_face_shape(fine_cells, d))
        for a in range(len(self.coarse_cells)):
            if a != d:
                x = _pairsum_axis(x, a)
        x = _reduce_dim(x, d).reshape(-1)
        if self.mask_coarse is not None:
            x = x * self.mask_coarse
        return x


@dataclasses.dataclass
class RTProlongation:
    """RT0 prolongation for the full face-vector tuple."""

    coarse_cells: Tuple[int, ...]
    mask_fine: Optional[tuple] = None  # optional per-component free masks (flat)

    def matvec(self, u):
        out = []
        for d in range(len(self.coarse_cells)):
            m = None if self.mask_fine is None else self.mask_fine[d]
            out.append(RTComponentProlongation(self.coarse_cells, d, m).matvec(u[d]))
        return tuple(out)


@dataclasses.dataclass
class RTRestriction:
    """Transpose of RTProlongation (residual restriction)."""

    coarse_cells: Tuple[int, ...]
    mask_coarse: Optional[tuple] = None
    mask_fine: Optional[tuple] = None

    def matvec(self, r):
        out = []
        for d in range(len(self.coarse_cells)):
            mc = None if self.mask_coarse is None else self.mask_coarse[d]
            mf = None if self.mask_fine is None else self.mask_fine[d]
            out.append(RTComponentRestriction(self.coarse_cells, d, mc, mf).matvec(r[d]))
        return tuple(out)


def hdiv_operator(ncells: Tuple[int, ...], alpha: float = 1.0, dtype=torch.float64,
                  device=None):
    """A = M + alpha * Bᵀ D^{-1} B (mass + div-div) on RT0 with essential
    (normal-flux) BCs eliminated, any dimension (reference hdiv GMG sweep
    runs 2D and 3D, GMGTests.jl:273-286). Returns (BlockOperator of
    `ELLMatrix` blocks, free_masks) in the torch `dtype` on `device`."""
    from .darcy import rt0_blocks, rt0_boundary_masks

    dev = resolve_device(device)
    dim = len(ncells)
    S = rt0_blocks(ncells)
    masks = rt0_boundary_masks(ncells)
    cellvol = float(np.prod(S["h"]))
    n_cells = int(np.prod(ncells))
    Dinv = sp.diags(np.full(n_cells, 1.0 / cellvol))
    rows = []
    for a in range(dim):
        row = []
        for b in range(dim):
            Sab = alpha * (S["B"][a].T @ Dinv @ S["B"][b]).tocsr()
            if a == b:
                Sab = Sab + S["M"][a]
            Sab = asm2.zero_rows(Sab, masks[a])
            Sab = asm2.zero_columns(Sab, masks[b])
            if a == b:
                Sab = (Sab + sp.diags(masks[a].astype(float))).tocsr()
            row.append(ell_from_scipy(Sab.tocsr(), dtype=dtype, device=dev))
        rows.append(tuple(row))
    free = tuple(torch.from_numpy((~m).astype(np.float64)).to(dev, dtype) for m in masks)
    return BlockOperator(tuple(rows)), free


def hdiv_vertex_patches(ncells: Tuple[int, ...]) -> PatchTopology:
    """One patch per interior vertex: all faces interior to the 2^d-cell
    block around it (Arnold-Falk-Winther vertex patches) — 4 faces in 2D,
    12 in 3D — indexed into the concatenated face vector."""
    dim = len(ncells)
    shapes = [_face_shape(ncells, d) for d in range(dim)]
    sizes = [int(np.prod(s)) for s in shapes]
    offs = np.cumsum([0] + sizes)
    n_total = int(offs[-1])
    dummy = n_total

    interior = [np.arange(1, n) for n in ncells]
    verts = np.stack(
        np.meshgrid(*interior, indexing="ij"), axis=-1
    ).reshape(-1, dim)  # (n_patches, dim)

    cols = []
    for d in range(dim):
        strides = np.cumprod([1] + list(shapes[d][::-1]))[:-1][::-1]
        # faces of family d interior to the block: normal index = vertex
        # coord on axis d; transverse cell coords in {v_a - 1, v_a}
        trans = [a for a in range(dim) if a != d]
        for combo in itertools.product((0, -1), repeat=dim - 1):
            coords = np.empty_like(verts)
            coords[:, d] = verts[:, d]
            for a, delta in zip(trans, combo):
                coords[:, a] = verts[:, a] + delta
            cols.append(offs[d] + coords @ strides)
    table = np.stack(cols, axis=1).astype(np.int32)
    return PatchTopology(dofs=table, dummy=dummy, n_dofs=n_total)


def hdiv_gmg(ncells: Tuple[int, ...], num_levels: int, alpha: float = 1.0,
             omega: float = None, dtype=torch.float64, device=None, **kw):
    """GMG for the H(div) operator with vertex-patch (Vanka) smoothers and
    RT0 transfers (2D and 3D). Default damping omega = 0.8 / 2^(d-1)
    scales with the patch overlap per face (2 patches in 2D, 4 in 3D).
    Returns (GMGSolver, A_fine, free_masks); `kw` goes to GMGSolver."""
    if omega is None:
        omega = 0.8 / 2 ** (len(ncells) - 1)
    from ..linear.gmg import GMGSolver
    from ..linear.smoothers import RichardsonSmoother
    from ..patches.vanka import VankaSolver

    levels = [
        tuple(n // (2 ** l) for n in ncells) for l in range(num_levels)
    ]
    ops, frees = [], []
    for lc in levels:
        A, free = hdiv_operator(lc, alpha, dtype=dtype, device=device)
        ops.append(A)
        frees.append(free)

    prolongs, restricts, smoothers = [], [], []
    for l in range(num_levels - 1):
        lc = levels[l + 1]
        prolongs.append(RTProlongation(lc, mask_fine=frees[l]))
        restricts.append(
            RTRestriction(lc, mask_coarse=frees[l + 1], mask_fine=frees[l])
        )
    for l in range(num_levels - 1):
        topo = hdiv_vertex_patches(levels[l])
        # weighting='unit' keeps the additive-Schwarz smoother SYMMETRIC
        # (the overlap-averaged variant left-multiplies by a diagonal and
        # would break CG); overlap <= 2 per face, so omega <= 1/2 damps it
        smoothers.append(
            RichardsonSmoother(
                VankaSolver(topo=topo, omega=1.0, weighting="unit"),
                niter=2,
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
