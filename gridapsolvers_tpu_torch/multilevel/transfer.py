"""Grid transfer operators (prolongation / restriction).

Port of the `impl="slices"` lowering of
`gridapsolvers_tpu/multilevel/transfer.py`, and of its exact FE-embedding
transfers (`fe_transfer_pair`: ELL P and R = Pᵀ on kernel K3;
`fe_transfer_pair_dense`: the same maps as per-axis dense contractions,
`TensorTransfer`, plain matrix products that the JAX package also computes
outside any kernel of its own). On structured vertex grids with
factor-2 refinement, Q1 interpolation is a per-axis interleave of values
and midpoint averages, and full-weighting restriction is its transpose;
both are slices, stacks and reshapes.

Modes (reference :interpolation / :dual_projection):
- Prolongation (solution mode)  = interpolation.
- Restriction (residual mode)   = R = P^T, full weighting.
- Restriction (solution mode)   = injection at coincident vertices.

Dirichlet masks: transfers act on full grids (constrained dofs kept with
identity rows); correction transfers zero constrained entries on the way
in and out.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..fem.mesh import CartesianMesh
from ..utils import check_same_device, resolve_device


def _expand_dim(cur: torch.Tensor, d: int, periodic: bool = False) -> torch.Tensor:
    """One-dimensional factor-2 linear interpolation along axis d:
    (n,) -> (2n-1,) with even = values, odd = midpoint averages, or
    (n,) -> (2n,) wrapping the last midpoint when periodic."""
    n = cur.shape[d]
    nxt = cur.narrow(d, 1, n - 1)
    last = cur.narrow(d, 0, 1) if periodic else cur.narrow(d, n - 1, 1)
    nxt = torch.cat([nxt, last], dim=d)
    odd = 0.5 * (cur + nxt)
    inter = torch.stack([cur, odd], dim=d + 1)
    inter = inter.reshape(cur.shape[:d] + (2 * n,) + cur.shape[d + 1 :])
    if periodic:
        return inter
    return inter.narrow(d, 0, 2 * n - 1)


def _reduce_dim(x: torch.Tensor, d: int, periodic: bool = False) -> torch.Tensor:
    """Transpose of _expand_dim: (2n-1,) -> (n,) full weighting
    z_i = x_{2i} + 0.5 x_{2i-1} + 0.5 x_{2i+1}; periodic wraps the last
    midpoint's right contribution onto z_0."""
    n2 = x.shape[d]
    n = (n2 + 1) // 2
    xp = x
    if 2 * n > n2:  # pad to even length 2n so (n, 2) splits [even | odd]
        xp = torch.cat([x, torch.zeros_like(x.narrow(d, 0, 2 * n - n2))], dim=d)
    xp = xp.reshape(x.shape[:d] + (n, 2) + x.shape[d + 1 :])
    even = xp.select(d + 1, 0)
    odd = xp.select(d + 1, 1)
    # odd contributes to its left (i) and right (i+1) coarse neighbours
    head = odd.narrow(d, n - 1, 1) if periodic else torch.zeros_like(odd.narrow(d, 0, 1))
    odd_right = torch.cat([head, odd.narrow(d, 0, n - 1)], dim=d)
    return even + 0.5 * odd + 0.5 * odd_right


def prolong_slices(xc: torch.Tensor, factors=None, periodic=None) -> torch.Tensor:
    out = xc
    for d in range(xc.ndim):
        if factors is not None and factors[d] == 1:
            continue
        out = _expand_dim(out, d, bool(periodic and periodic[d]))
    return out


def restrict_slices(xf: torch.Tensor, factors=None, periodic=None) -> torch.Tensor:
    out = xf
    for d in range(xf.ndim):
        if factors is not None and factors[d] == 1:
            continue
        out = _reduce_dim(out, d, bool(periodic and periodic[d]))
    return out


@dataclasses.dataclass
class StructuredProlongation:
    """P: coarse vertex grid -> fine vertex grid (factor-2), Q1 interpolation.

    mask_fine: optional flat {0,1} tensor zeroing constrained dofs of the
    correction (1 = free dof). factors: per-axis refinement factors in
    {1, 2} (None = all 2); periodic: per-axis wrap flags.
    """

    fine_shape: Tuple[int, ...]
    coarse_shape: Tuple[int, ...]
    mask_fine: Optional[torch.Tensor] = None
    factors: Optional[Tuple[int, ...]] = None
    periodic: Optional[Tuple[bool, ...]] = None

    def matvec(self, xc: torch.Tensor) -> torch.Tensor:
        y = prolong_slices(xc.reshape(self.coarse_shape), self.factors, self.periodic)
        if self.mask_fine is not None:
            check_same_device(xc, self.mask_fine)
            y = y * self.mask_fine.reshape(self.fine_shape)
        return y.reshape(-1)

    @property
    def shape(self):
        return (int(np.prod(self.fine_shape)), int(np.prod(self.coarse_shape)))


@dataclasses.dataclass
class StructuredRestriction:
    """R = P^T (full weighting) for residuals, or injection for solutions.

    mode: 'residual' (dual/full-weighting) | 'solution' (injection).
    mask_coarse zeros constrained coarse dofs (1 = free).
    """

    fine_shape: Tuple[int, ...]
    coarse_shape: Tuple[int, ...]
    mode: str = "residual"
    mask_coarse: Optional[torch.Tensor] = None
    mask_fine: Optional[torch.Tensor] = None
    factors: Optional[Tuple[int, ...]] = None
    periodic: Optional[Tuple[bool, ...]] = None

    def __post_init__(self):
        if self.mode not in ("residual", "solution"):
            raise ValueError(f"unknown restriction mode {self.mode!r}")

    def matvec(self, xf: torch.Tensor) -> torch.Tensor:
        xf = xf.reshape(self.fine_shape)
        if self.mask_fine is not None:
            check_same_device(xf, self.mask_fine)
            xf = xf * self.mask_fine.reshape(self.fine_shape)
        if self.mode == "solution":
            # injection: take coincident vertices (stride = factor)
            fac = self.factors or (2,) * len(self.fine_shape)
            y = xf[tuple(slice(0, None, f) for f in fac)].reshape(self.coarse_shape)
        else:
            y = restrict_slices(xf, self.factors, self.periodic)
        if self.mask_coarse is not None:
            check_same_device(xf, self.mask_coarse)
            y = y * self.mask_coarse.reshape(self.coarse_shape)
        return y.reshape(-1)

    @property
    def shape(self):
        return (int(np.prod(self.coarse_shape)), int(np.prod(self.fine_shape)))


def free_mask(mesh: CartesianMesh, dtype=torch.float64, device=None) -> torch.Tensor:
    """{0,1} flat mask of free (non-Dirichlet-boundary) vertex dofs."""
    m = (~mesh.boundary_vertex_mask()).astype(np.float64).reshape(-1)
    return torch.from_numpy(m).to(device=resolve_device(device), dtype=dtype)


def setup_transfer_operators(
    hierarchy,
    with_masks: bool = True,
    dtype=torch.float64,
    device=None,
):
    """Build (prolongations, restrictions) for all level pairs
    (reference GridTransferOperators.jl:350-380 setup_transfer_operators).

    prolongations[l] : level l+1 (coarse) -> level l (fine)
    restrictions[l]  : level l (fine) -> level l+1 (coarse), residual mode
    """
    meshes = hierarchy.meshes
    prolongations, restrictions = [], []
    for l in range(len(meshes) - 1):
        fine, coarse = meshes[l], meshes[l + 1]
        mf = free_mask(fine, dtype, device) if with_masks else None
        mc = free_mask(coarse, dtype, device) if with_masks else None
        factors = tuple(nf // nc for nf, nc in zip(fine.ncells, coarse.ncells))
        per = tuple(fine.periodic)
        kw = {}
        if any(f != 2 for f in factors) or any(per):
            kw = dict(factors=factors, periodic=per)
        prolongations.append(
            StructuredProlongation(fine.vertex_shape, coarse.vertex_shape, mf, **kw)
        )
        restrictions.append(
            StructuredRestriction(
                fine.vertex_shape, coarse.vertex_shape, "residual", mc, mf, **kw
            )
        )
    return prolongations, restrictions


# ---------------------------------------------------------------------------
# exact FE-embedding transfers (nested spaces, any order)
# ---------------------------------------------------------------------------


def fe_interpolation_1d(n_coarse_cells: int, order: int = 2):
    """1D nodal FE embedding matrix of the order-p Lagrange space on n
    uniform cells into the space on 2n cells: (2pn+1, pn+1) scipy CSR.

    EXACT for nested refinement: with R = Pᵀ the rediscretized coarse
    operator equals the Galerkin product RAP on free dofs, which two-level
    convergence needs for strongly anisotropic energies (e.g. the grad-div
    augmented velocity block, where the linear node-grid transfer's O(h²)
    embedding error is amplified by alpha)."""
    import scipy.sparse as sp

    n, p = n_coarse_cells, order
    mc, mf = p * n + 1, 2 * p * n + 1
    nodes = np.linspace(0.0, 1.0, p + 1)
    L = np.zeros((2 * p + 1, p + 1))
    for r in range(2 * p + 1):
        xi = r / (2.0 * p)
        for k in range(p + 1):
            w = 1.0
            for j in range(p + 1):
                if j != k:
                    w *= (xi - nodes[j]) / (nodes[k] - nodes[j])
            L[r, k] = w
    rows, cols, vals = [], [], []
    for i in range(n):
        for r in range(0 if i == 0 else 1, 2 * p + 1):
            f = 2 * p * i + r
            for k in range(p + 1):
                if L[r, k] != 0.0:
                    rows.append(f)
                    cols.append(p * i + k)
                    vals.append(L[r, k])
    return sp.coo_matrix((vals, (rows, cols)), shape=(mf, mc)).tocsr()


def fe_grid_interpolation(coarse_ncells, order: int = 2):
    """Tensor-product FE embedding on a Cartesian grid (C-order node
    numbering): kron of the per-axis 1D embeddings."""
    import scipy.sparse as sp

    P = None
    for n in coarse_ncells:
        P1 = fe_interpolation_1d(int(n), order)
        P = P1 if P is None else sp.kron(P, P1, format="csr")
    return P.tocsr()


def fe_transfer_pair(coarse_ncells, order, mask_f=None, mask_c=None, dtype=torch.float64,
                     device=None):
    """(prolongation, restriction) as ELLMatrix operators (kernel K3) in
    `dtype` on `device` (None: the card): P the exact FE embedding with
    Dirichlet rows/cols zeroed, R = Pᵀ (residual mode)."""
    from ..algebra.ell import ell_from_scipy
    from ..fem import assembly2 as _asm

    P = fe_grid_interpolation(coarse_ncells, order)
    if mask_f is not None:
        P = _asm.zero_rows(P, mask_f)
    if mask_c is not None:
        P = _asm.zero_columns(P, mask_c)
    P.eliminate_zeros()
    R = P.T.tocsr()
    return (ell_from_scipy(P, dtype=dtype, device=device),
            ell_from_scipy(R, dtype=dtype, device=device))


@dataclasses.dataclass
class TensorTransfer:
    """Separable (Kronecker) grid transfer as per-axis DENSE contractions.

    The FE embedding on a Cartesian grid is kron(P1d_0, ..., P1d_{D-1})
    (`fe_grid_interpolation`), and the Dirichlet masking is diagonal on
    both sides, so P_masked = diag(m_out) · kron(...) · diag(m_in). The
    matvec is D tensordots with small dense (m_f, m_c) factors.

    mats[d]: (out_d, in_d) dense factor for axis d. mask_in / mask_out:
    optional flat {0,1} tensors (free-dof masks). Works as prolongation
    (mats = P1d) or restriction (mats = P1dᵀ, masks swapped)."""

    mats: Tuple[torch.Tensor, ...]
    in_shape: Tuple[int, ...]
    out_shape: Tuple[int, ...]
    mask_in: Optional[torch.Tensor] = None
    mask_out: Optional[torch.Tensor] = None

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        if self.mask_in is not None:
            x = x.reshape(-1) * self.mask_in.reshape(-1)
        y = x.reshape(self.in_shape)
        for d, M in enumerate(self.mats):
            y = torch.movedim(torch.tensordot(M.to(y.dtype), y, dims=([1], [d])), 0, d)
        y = y.reshape(-1)
        if self.mask_out is not None:
            y = y * self.mask_out.reshape(-1)
        return y

    @property
    def shape(self):
        return (int(np.prod(self.out_shape)), int(np.prod(self.in_shape)))


def fe_transfer_pair_dense(coarse_ncells, order, mask_f=None, mask_c=None,
                           dtype=torch.float64, device=None):
    """`fe_transfer_pair` as `TensorTransfer`s in `dtype` on `device`: the
    same P and R = Pᵀ as per-axis dense contractions. masks are Dirichlet
    masks (True = constrained), as fe_transfer_pair takes them."""
    dev = resolve_device(device)
    p1ds = [torch.from_numpy(fe_interpolation_1d(int(n), order).toarray()).to(dev, dtype)
            for n in coarse_ncells]
    cshape = tuple(order * int(n) + 1 for n in coarse_ncells)
    fshape = tuple(2 * order * int(n) + 1 for n in coarse_ncells)

    def free(mask):
        if mask is None:
            return None
        return torch.from_numpy((~np.asarray(mask).reshape(-1)).astype(np.float64)).to(dev, dtype)

    mf, mc = free(mask_f), free(mask_c)
    P = TensorTransfer(mats=tuple(p1ds), in_shape=cshape, out_shape=fshape,
                       mask_in=mc, mask_out=mf)
    R = TensorTransfer(mats=tuple(m.T.contiguous() for m in p1ds), in_shape=fshape,
                       out_shape=cshape, mask_in=mf, mask_out=mc)
    return P, R
