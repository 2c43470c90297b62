"""Grid transfer operators (prolongation / restriction).

Port of the `impl="slices"` lowering of
`gridapsolvers_tpu/multilevel/transfer.py`. On structured vertex grids with
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
