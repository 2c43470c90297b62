"""Adaptive (locally refined) hierarchies + composite-grid solves.

Port of `gridapsolvers_tpu/multilevel/adaptive.py`: block-structured AMR
(Berger-Colella style), the analog of the reference's octree AMR
extension (ext/GridapP4estExt/GridapP4estExt.jl:25-39). Each level
refines ONE nested cell-aligned BOX of its parent by factor 2; every
level is a dense uniform Cartesian grid, so refinement changes only box
bounds (slice offsets), never array structure.

The composite FE space is the hanging-node-constrained one: coarse Q1
elements outside each box, fine Q1 elements inside, fine interface dofs
slaved to Q1 interpolation of the parent. Its Galerkin operator is the
sum of per-level stencils

    A_comp = sum_l  E_l^T A_l E_l

where A_l is the level-l stencil assembled only over level-l cells NOT
covered by the child box (one `assemble_q1_stencil_var` call with a
per-cell indicator; its matvec runs kernel K2 on the card), and E_l fills
the level-l interface ring from the parent by Q1 interpolation
(`prolong_slices` on the box slice; its exact transpose is
`restrict_slices`). The result is SPD, so the composite problem is solved
by CG on tuples of per-level vectors.

The host parts (the marker, the box masks) are NumPy, as in the JAX
package; the ring and pin masks an operator applies are built once, on
its device, when the operator is made.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..fem.assembly import assemble_q1_stencil_var, q1_element_matrices
from ..fem.mesh import CartesianMesh
from ..utils import numpy_dtype, resolve_device
from .transfer import prolong_slices, restrict_slices


@dataclasses.dataclass(frozen=True)
class AdaptiveLevel:
    """One level of a box hierarchy. `lo`/`hi` are the refined box in the
    PARENT level's cell indices ([lo, hi) per axis); None for the base."""

    mesh: CartesianMesh
    lo: Optional[Tuple[int, ...]] = None
    hi: Optional[Tuple[int, ...]] = None


def box_mesh(parent: CartesianMesh, lo, hi) -> CartesianMesh:
    """The mesh of parent cells [lo, hi) refined by 2."""
    h = parent.h
    dom = tuple(
        x
        for d in range(parent.dim)
        for x in (parent.domain[2 * d] + lo[d] * h[d], parent.domain[2 * d] + hi[d] * h[d])
    )
    return CartesianMesh(tuple(2 * (b - a) for a, b in zip(lo, hi)), dom)


@dataclasses.dataclass
class AdaptiveHierarchy:
    """Levels coarsest-first: levels[0] is the full-domain base mesh."""

    levels: List[AdaptiveLevel]

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    def __getitem__(self, l: int) -> AdaptiveLevel:
        return self.levels[l]

    def refine_box(self, lo: Sequence[int], hi: Sequence[int]) -> "AdaptiveHierarchy":
        """Append a level refining cells [lo, hi) of the current finest
        level by 2 (the p4est `refine!` analog, box-granular)."""
        parent = self.levels[-1].mesh
        lo, hi = tuple(int(x) for x in lo), tuple(int(x) for x in hi)
        assert all(0 <= a < b <= n for a, b, n in zip(lo, hi, parent.ncells)), (
            lo, hi, parent.ncells)
        return AdaptiveHierarchy(self.levels + [AdaptiveLevel(box_mesh(parent, lo, hi), lo, hi)])


def adaptive_hierarchy(base_mesh: CartesianMesh) -> AdaptiveHierarchy:
    return AdaptiveHierarchy([AdaptiveLevel(base_mesh)])


# ---------------------------------------------------------------- estimator


def _pad_dim(x: torch.Tensor, d: int) -> torch.Tensor:
    """One zero plane before and after x along axis d."""
    z = torch.zeros_like(x.narrow(d, 0, 1))
    return torch.cat([z, x, z], dim=d)


def estimate_cells(u: torch.Tensor, mesh: CartesianMesh) -> torch.Tensor:
    """Per-cell smoothness indicator: magnitude of the undivided second
    difference of u (≈ h² |∂²u|, the leading Q1 interpolation-error term),
    averaged onto cells; on u's device."""
    ug = u.reshape(mesh.vertex_shape)
    est = torch.zeros_like(ug)
    for d in range(mesh.dim):
        est = est + _pad_dim(torch.abs(torch.diff(ug, n=2, dim=d)), d)
    # vertex -> cell: average the 2^d corners
    for d in range(mesh.dim):
        n = est.shape[d]
        est = 0.5 * (est.narrow(d, 0, n - 1) + est.narrow(d, 1, n - 1))
    return est


def mark_box(est: np.ndarray, theta: float = 0.5, pad: int = 1, align: int = 2):
    """Bounding box (in cell indices) of cells with est > theta * max(est),
    padded by `pad` cells and aligned to `align` (host NumPy)."""
    est = np.asarray(est)
    marked = est > theta * est.max()
    lo, hi = [], []
    for d in range(est.ndim):
        axes = tuple(k for k in range(est.ndim) if k != d)
        idx = np.nonzero(marked.any(axis=axes))[0]
        a = max(int(idx[0]) - pad, 0)
        b = min(int(idx[-1]) + 1 + pad, est.shape[d])
        a = (a // align) * align
        b = min(-(-b // align) * align, est.shape[d])
        lo.append(a)
        hi.append(b)
    return tuple(lo), tuple(hi)


# ------------------------------------------------- composite Galerkin system


def _box_vertex_slice(lev: AdaptiveLevel):
    return tuple(slice(a, b + 1) for a, b in zip(lev.lo, lev.hi))


def _ring_mask(shape) -> np.ndarray:
    m = np.zeros(shape, dtype=bool)
    for d in range(len(shape)):
        idx = [slice(None)] * len(shape)
        idx[d] = 0
        m[tuple(idx)] = True
        idx[d] = shape[d] - 1
        m[tuple(idx)] = True
    return m


def _covered_interior_mask(shape, lev: AdaptiveLevel) -> np.ndarray:
    """Vertices of the PARENT grid strictly inside the child box (their
    composite values live on the child level; pinned to 0 here)."""
    m = np.zeros(shape, dtype=bool)
    m[tuple(slice(a + 1, b) for a, b in zip(lev.lo, lev.hi))] = True
    return m


def _vertex_slice(lo, hi):
    return tuple(slice(a, b + 1) for a, b in zip(lo, hi))


@dataclasses.dataclass
class CompositeOperator:
    """Exact composite-grid (hanging-node constrained) Galerkin operator
    on a box hierarchy; acts on tuples of per-level flat vectors.

    ops[l]   : level-l StencilMatrix assembled over UNCOVERED level-l
               cells only (child-box cells excluded by the indicator)
    active[l]: 1.0 on composite dofs of level l, 0.0 on pinned dofs
               (interface-ring slaves, covered interiors, Dirichlet)
    boxes    : (lo, hi) per level > 0 ((None, None) for the base)
    shapes   : vertex shapes
    ring     : per-level interface-ring masks on the operators' device,
               made from `shapes` when the operator is made

    matvec = sum_l E_l^T A_l E_l + identity on pinned dofs: one K2 launch
    a level, the rest slices and elementwise updates on the device. The
    adjoint hands each level's ring residual to its parent after the
    level has received its own child's, as `forest.ForestCompositeOperator`
    does. The JAX package's single-box operator passes on only the level's
    own apply, which differs where a box of level >= 2 touches its parent
    box's edge (there it is not symmetric); elsewhere the two agree.
    """

    ops: Tuple
    active: Tuple
    boxes: Tuple
    shapes: Tuple
    ring: Tuple = dataclasses.field(default=None, init=False)

    def __post_init__(self):
        dev = self.active[0].device
        self.ring = tuple(torch.from_numpy(_ring_mask(s)).to(dev) for s in self.shapes)

    @property
    def grid_shape(self):  # leading-level shape (solver introspection)
        return self.shapes[0]

    def _extend(self, u):
        """Per-level full grids: ring rows replaced by parent interp."""
        full = [u[0].reshape(self.shapes[0])]
        for l in range(1, len(self.ops)):
            lo, hi = self.boxes[l]
            g = prolong_slices(full[l - 1][_vertex_slice(lo, hi)])
            full.append(torch.where(self.ring[l], g, u[l].reshape(self.shapes[l])))
        return full

    def matvec(self, u):
        L = len(self.ops)
        full = self._extend(u)
        ys = [self.ops[l].matvec(full[l].reshape(-1)).reshape(self.shapes[l])
              for l in range(L)]
        out = [None] * L
        for l in range(L - 1, -1, -1):
            yg = ys[l]  # its own apply plus what its child handed down
            if l > 0:
                # transpose coupling: ring residual -> parent
                lo, hi = self.boxes[l]
                ys[l - 1][_vertex_slice(lo, hi)] += restrict_slices(
                    torch.where(self.ring[l], yg, 0.0))
            a = self.active[l].reshape(self.shapes[l])
            ug = u[l].reshape(self.shapes[l])
            out[l] = (a * yg + (1.0 - a) * ug).reshape(-1)
        return tuple(out)

    def diag(self):
        """Jacobi-grade composite diagonal (exact on non-interface dofs;
        the parent-interface coupling term uses the injected child
        diagonal, a benign approximation for preconditioning)."""
        L = len(self.ops)
        # copies: diag() is a view of the operator's centre band
        ds = [self.ops[l].diag().reshape(self.shapes[l]).clone() for l in range(L)]
        for l in range(L - 1, 0, -1):
            rc = torch.where(self.ring[l], ds[l], 0.0)
            # coincident (even-index) child ring nodes inject onto parent
            # box-face nodes with unit interpolation weight
            lo, hi = self.boxes[l]
            ds[l - 1][_vertex_slice(lo, hi)] += rc[
                tuple(slice(None, None, 2) for _ in self.shapes[l])]
        return tuple((a.reshape(d.shape) * d + (1.0 - a.reshape(d.shape))).reshape(-1)
                     for a, d in zip(self.active, ds))

    @property
    def n(self):
        return sum(int(np.prod(s)) for s in self.shapes)


def _level_rhs(mesh: CartesianMesh, f, ind: np.ndarray, dtype, dev) -> torch.Tensor:
    """The level's load M f on its uncovered cells (M on the card: K2)."""
    _, Me = q1_element_matrices(mesh.h)
    M = assemble_q1_stencil_var(mesh, Me, ind, dtype, dev)
    fv = torch.from_numpy(np.asarray(f(mesh.vertex_coords()), dtype=numpy_dtype(dtype)))
    return M.matvec(fv.reshape(-1).to(dev)).reshape(mesh.vertex_shape)


def composite_system(
    hier: AdaptiveHierarchy,
    f: Callable[[np.ndarray], np.ndarray],
    kappa: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    dtype=torch.float64,
    device=None,
):
    """Assemble the composite Poisson system -div(kappa grad u) = f with
    homogeneous Dirichlet on the true domain boundary, on `device` (None:
    the card).

    Returns (CompositeOperator, rhs tuple). Each level contributes its
    UNCOVERED cells to both stiffness and mass (indicator-weighted
    `assemble_q1_stencil_var`); child interface-ring loads transfer to the
    parent through the same transpose interpolation as the operator."""
    dev = resolve_device(device)
    np_dtype = numpy_dtype(dtype)
    L = hier.num_levels
    ops, actives, rhs, boxes, shapes = [], [], [], [(None, None)], []
    for l, lev in enumerate(hier.levels):
        mesh = lev.mesh
        Ke, _ = q1_element_matrices(mesh.h)
        ind = np.ones(mesh.ncells, dtype=np_dtype)
        if l + 1 < L:
            nxt = hier[l + 1]
            ind[tuple(slice(a, b) for a, b in zip(nxt.lo, nxt.hi))] = 0.0
            boxes.append((nxt.lo, nxt.hi))
        kap = ind if kappa is None else ind * kappa(_cell_centers(mesh)).reshape(mesh.ncells)
        shape = mesh.vertex_shape
        pin = mesh.boundary_vertex_mask() if l == 0 else _ring_mask(shape)
        if l + 1 < L:
            pin = pin | _covered_interior_mask(shape, hier[l + 1])
        # NO row/column elimination: ring COLUMNS must stay intact — the
        # interpolated parent data flows through them into active rows
        # (matvec masks pinned ROWS out and pins their values by identity)
        ops.append(assemble_q1_stencil_var(mesh, Ke, kap, dtype, dev))
        actives.append(torch.from_numpy((~pin).astype(np_dtype)).to(dev))
        rhs.append(_level_rhs(mesh, f, ind, dtype, dev))
        shapes.append(shape)

    # ring loads cascade to parents (finest first)
    for l in range(L - 1, 0, -1):
        rc = torch.where(torch.from_numpy(_ring_mask(shapes[l])).to(dev), rhs[l], 0.0)
        rhs[l - 1][_box_vertex_slice(hier[l])] += restrict_slices(rc)
    out_rhs = tuple((rhs[l] * actives[l]).reshape(-1) for l in range(L))
    op = CompositeOperator(ops=tuple(ops), active=tuple(actives), boxes=tuple(boxes),
                           shapes=tuple(shapes))
    return op, out_rhs


def _cell_centers(mesh: CartesianMesh) -> np.ndarray:
    axes = [
        mesh.domain[2 * d] + (np.arange(n) + 0.5) * mesh.h[d]
        for d, n in enumerate(mesh.ncells)
    ]
    grids = np.meshgrid(*axes, indexing="ij")
    return np.stack([g.reshape(-1) for g in grids], axis=1)


def composite_solve(
    hier: AdaptiveHierarchy,
    f,
    kappa=None,
    rtol: float = 1e-10,
    maxiter: int = 2000,
    dtype=torch.float64,
    device=None,
):
    """CG on the composite SPD system; returns per-level grids with slave
    ring values reconstructed (interpolated from the parent)."""
    from ..linear import CGSolver, JacobiSolver

    op, b = composite_system(hier, f, kappa, dtype, device)
    solver = CGSolver(Pl=JacobiSolver(), rtol=rtol, maxiter=maxiter)
    x, stats = solver.solve(solver.setup(op), b)
    return op._extend(x), stats


def composite_on_finest(hier: AdaptiveHierarchy, us):
    """The composite FE function sampled on the UNIFORMLY refined base
    grid (base refined 2^(L-1)): Q1-prolong the running field level by
    level and overlay each box's own field at its global position. On
    uncovered coarse cells Q1 prolongation is exact, so this IS the
    composite function's fine-grid interpolant."""
    u = us[0].reshape(hier[0].mesh.vertex_shape)
    mesh = hier[0].mesh
    offset = tuple(0 for _ in range(mesh.dim))
    for l in range(1, hier.num_levels):
        lev = hier[l]
        u = prolong_slices(u)
        mesh = mesh.refine(2)
        offset = tuple(2 * (o + a) for o, a in zip(offset, lev.lo))
        u[tuple(slice(o, o + n) for o, n in zip(offset, lev.mesh.vertex_shape))] = (
            us[l].reshape(lev.mesh.vertex_shape))
    return u, mesh


def adaptive_solve(
    base_mesh: CartesianMesh,
    f,
    kappa=None,
    num_levels: int = 2,
    theta: float = 0.25,
    rtol: float = 1e-10,
    dtype=torch.float64,
    device=None,
):
    """Full AMR driver: solve -> estimate -> mark -> refine-box -> re-solve,
    adding one nested level per round (the estimate/mark/adapt loop the
    reference runs through p4est's `adapt!`)."""
    hier = adaptive_hierarchy(base_mesh)
    us, _ = composite_solve(hier, f, kappa, rtol=rtol, dtype=dtype, device=device)
    for _ in range(num_levels - 1):
        est = estimate_cells(us[-1].reshape(-1), hier.levels[-1].mesh)
        lo, hi = mark_box(est.cpu().numpy(), theta=theta)
        hier = hier.refine_box(lo, hi)
        us, _ = composite_solve(hier, f, kappa, rtol=rtol, dtype=dtype, device=device)
    return hier, us
