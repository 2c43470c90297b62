"""Distributed (block-split) operators and the distributed Poisson GMG.

Port of `gridapsolvers_tpu/parallel/dist.py`. Vectors of a sharded level
are grid-shaped and split in equal blocks over the leading grid axes, one
block a rank (`utils.pytrees.Sharded`); coarse levels are replicated
(every rank holds the whole grid and solves it redundantly, as every JAX
device does). Where the JAX package leaves the moves to XLA's SPMD
partitioner, the port makes them itself:

- a stencil matvec on a sharded level is the halo-exchange matvec of
  `halo.HaloStencilMatrix`, whose local apply is kernel K2;
- dots, norms and the Gershgorin max reduce over the ranks
  (`BlockLayout.all_reduce`, reached through `utils.pytrees`);
- a transfer between levels whose blocks do not nest (`DistProlongation`,
  `DistRestriction`) all-gathers its input and applies the transfer to
  the whole grid; `Resharded` then keeps this rank's block (a local slice)
  or the whole grid;
- a coarsest level that is still sharded is gathered for its direct
  solve (`Gathered`), which JAX's dense factorization of a sharded
  operator does implicitly.

Sharded grid axes are padded to a multiple of their rank count with
identity rows (decoupled dofs pinned at zero), the JAX package's static
padding; nested level pads make the factor-2 transfers between sharded
levels one halo row (`halo.HaloProlongation`, `halo.HaloRestriction`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..algebra.stencil import StencilMatrix
from ..utils import resolve_device
from ..utils.pytrees import Sharded
from .mesh import P, ProcessMesh


def pad0(n: int, nprocs: int) -> int:
    """Padded size of a sharded grid axis: the next multiple of nprocs."""
    return ((n + nprocs - 1) // nprocs) * nprocs


def _procs_tuple(procs, ndim: int):
    """Per-axis rank counts: an int is the leading axis only (the 1-D
    mesh layout); a tuple gives the count per grid axis."""
    if isinstance(procs, int):
        return (procs,) + (1,) * (ndim - 1)
    procs = tuple(procs)
    assert len(procs) <= ndim
    return procs + (1,) * (ndim - len(procs))


def padded_shape_nd(grid_shape, procs) -> Tuple[int, ...]:
    pr = _procs_tuple(procs, len(grid_shape))
    return tuple(pad0(n, p) for n, p in zip(grid_shape, pr))


def pad_stencil(A: StencilMatrix, procs, target_shape=None) -> StencilMatrix:
    """Pad every sharded grid axis to a multiple of its rank count (or to
    `target_shape`): zero bands on pad rows except a unit diagonal, so
    pad dofs stay zero."""
    shape_p = (tuple(target_shape) if target_shape is not None
               else padded_shape_nd(A.grid_shape, procs))
    if shape_p == tuple(A.grid_shape):
        return A
    per = A._periodic()
    for d, (n, np_) in enumerate(zip(A.grid_shape, shape_p)):
        if np_ > n and per[d]:
            raise ValueError(
                f"periodic axis {d} ({n} dofs) cannot be zero-padded for sharding: the "
                f"wraparound would cross the pad rows; choose a grid size divisible by the "
                f"rank count (periodic axes have exactly ncells dofs, so powers of two work)")
    bands = A.bands.new_zeros((A.bands.shape[0],) + shape_p)
    bands[(slice(None),) + tuple(slice(0, n) for n in A.grid_shape)] = A.bands
    center = A.offsets.index(tuple(0 for _ in A.grid_shape))
    in_pad = torch.zeros(shape_p, dtype=torch.bool, device=bands.device)
    for d, (n, np_) in enumerate(zip(A.grid_shape, shape_p)):
        if np_ > n:
            idx = [slice(None)] * len(shape_p)
            idx[d] = slice(n, np_)
            in_pad[tuple(idx)] = True
    bands[center][in_pad] = 1.0
    return dataclasses.replace(A, bands=bands, grid_shape=shape_p)


def pad_grid_vector(x, grid_shape, procs, target_shape=None) -> torch.Tensor:
    xg = torch.as_tensor(x).reshape(grid_shape)
    shape_p = (tuple(target_shape) if target_shape is not None
               else padded_shape_nd(grid_shape, procs))
    if shape_p == tuple(grid_shape):
        return xg
    out = xg.new_zeros(shape_p)
    out[tuple(slice(0, n) for n in grid_shape)] = xg
    return out


def unpad_grid_vector(xg, grid_shape):
    return xg[tuple(slice(0, n) for n in grid_shape)]


def _axes_tuple(mesh: ProcessMesh, axis) -> Tuple[str, ...]:
    """A string names one mesh axis (1-D layout); None takes every mesh
    axis in order (multi-axis domain partition)."""
    if axis is None:
        return tuple(mesh.axis_names)
    if isinstance(axis, str):
        return (axis,)
    return tuple(axis)


def _grid_pspec(mesh: ProcessMesh, ndim: int, axes: Tuple[str, ...]) -> P:
    return P(*axes, *([None] * (ndim - len(axes))))


class BlockLayout:
    """The split of a grid of `global_shape` over `mesh`: grid axis k < len(axes)
    is cut into equal blocks along mesh axis axes[k], the other axes are
    whole. Equal layouts compare equal (same mesh object, axes and
    shape)."""

    def __init__(self, mesh: ProcessMesh, axes, global_shape):
        self.mesh = mesh
        self.axes = tuple(axes)
        self.global_shape = tuple(int(n) for n in global_shape)
        d = len(self.global_shape)
        self.procs = tuple(mesh.shape[a] for a in self.axes) + (1,) * (d - len(self.axes))
        for n, p in zip(self.global_shape, self.procs):
            if n % p:
                raise ValueError(f"grid {self.global_shape} does not split evenly over "
                                 f"{self.procs} ranks: pad it first")
        self.block_shape = tuple(n // p for n, p in zip(self.global_shape, self.procs))
        self.global_numel = int(np.prod(self.global_shape))
        self.starts = self._starts(mesh.coords) if mesh.member else None

    def _starts(self, coords):
        block = [coords[self.mesh.axis_index(a)] for a in self.axes]
        block += [0] * (len(self.global_shape) - len(self.axes))
        return tuple(b * m for b, m in zip(block, self.block_shape))

    def _key(self):
        return (id(self.mesh), self.axes, self.global_shape)

    def __eq__(self, other):
        return isinstance(other, BlockLayout) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def slices(self, starts=None):
        starts = self.starts if starts is None else starts
        return tuple(slice(s, s + m) for s, m in zip(starts, self.block_shape))

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        return self.mesh.all_reduce(t, op)

    def global_flat_index(self, device) -> torch.Tensor:
        """The C-order flat index in the global grid of every entry of this
        rank's block (int64)."""
        idx = torch.zeros((), dtype=torch.int64, device=device)
        for k, (s, m, n) in enumerate(zip(self.starts, self.block_shape, self.global_shape)):
            shape = [1] * len(self.block_shape)
            shape[k] = m
            idx = idx * n + torch.arange(s, s + m, device=device).reshape(shape)
        return idx

    def take(self, full: torch.Tensor, lead: int = 0) -> torch.Tensor:
        """This rank's block of a whole grid (after `lead` leading axes)."""
        return full[(slice(None),) * lead + self.slices()].contiguous()

    def shard(self, full: torch.Tensor) -> Sharded:
        return Sharded(self.take(full.reshape(self.global_shape)), self)

    def gather(self, local: torch.Tensor, lead: int = 0) -> torch.Tensor:
        """The whole grid from every rank's block (one all-gather)."""
        parts = self.mesh.all_gather(local)
        full = local.new_empty(tuple(local.shape[:lead]) + self.global_shape)
        for r, part in enumerate(parts):
            coords = np.unravel_index(r, self.mesh.devices_shape)
            full[(slice(None),) * lead + self.slices(self._starts(coords))] = part
        return full


@functools.lru_cache(maxsize=None)
def _layout(mesh, axes, global_shape) -> BlockLayout:
    return BlockLayout(mesh, axes, global_shape)


def block_layout(mesh: ProcessMesh, axis, global_shape) -> BlockLayout:
    return _layout(mesh, _axes_tuple(mesh, axis), tuple(int(n) for n in global_shape))


def gather(x):
    """The whole grid of a sharded vector (a plain tensor stays)."""
    return x.layout.gather(x.local) if isinstance(x, Sharded) else x


def shard_stencil(A: StencilMatrix, mesh: ProcessMesh, axis="p", pad: bool = True):
    """This rank's block of a stencil operator, split over the leading
    grid axes (one mesh axis per grid axis, in order), as a
    `HaloStencilMatrix` on grid-shaped sharded vectors. Pads the split
    axes to their rank counts if needed."""
    from .halo import HaloStencilMatrix

    axes = _axes_tuple(mesh, axis)
    if pad:
        A = pad_stencil(A, tuple(mesh.shape[a] for a in axes))
    return HaloStencilMatrix.from_global(A, mesh, axes)


def replicate_stencil(A: StencilMatrix, mesh: ProcessMesh) -> StencilMatrix:
    """The whole operator on every rank, on grid-shaped vectors."""
    return A.with_grid_vectors(True)


def shard_grid_vector(x, mesh: ProcessMesh, grid_shape, axis="p", pad: bool = True,
                      target_shape=None) -> Sharded:
    """This rank's block of a whole (flat or grid-shaped) vector, padded
    like the operator (`target_shape`: the operator's `.grid_shape` when it
    was built with nested level pads)."""
    axes = _axes_tuple(mesh, axis)
    xg = torch.as_tensor(x).reshape(grid_shape)
    if pad:
        xg = pad_grid_vector(xg, grid_shape, tuple(mesh.shape[a] for a in axes),
                             target_shape=target_shape)
    return block_layout(mesh, axes, xg.shape).shard(xg)


def _fit0(y: torch.Tensor, target) -> torch.Tensor:
    """Slice or zero-pad every axis to the target shape (an int is the
    leading axis only)."""
    if isinstance(target, int):
        target = (target,) + tuple(y.shape[1:])
    if tuple(y.shape) == tuple(target):
        return y
    y = y[tuple(slice(0, min(n, t)) for n, t in zip(y.shape, target))]
    out = y.new_zeros(tuple(target))
    out[tuple(slice(0, n) for n in y.shape)] = y
    return out


@dataclasses.dataclass
class DistProlongation:
    """Factor-2 Q1 interpolation between padded grids, on the whole grid:
    a sharded input is gathered first; the output is the whole fine grid
    (`Resharded` keeps this rank's block of it). Pad rows carry zeros and
    the mask zeroes any spill at the real/pad seam."""

    fine_shape: Tuple[int, ...]
    coarse_shape: Tuple[int, ...]
    mask_fine: Optional[torch.Tensor] = None
    periodic: Optional[Tuple[bool, ...]] = None

    def matvec(self, xc):
        from ..multilevel.transfer import prolong_slices

        y = _fit0(prolong_slices(gather(xc), periodic=self.periodic), self.fine_shape)
        if self.mask_fine is not None:
            y = y * self.mask_fine
        return y


@dataclasses.dataclass
class DistRestriction:
    """Full-weighting restriction between padded grids on the whole grid
    (transpose of `DistProlongation` on the real region)."""

    fine_shape: Tuple[int, ...]
    coarse_shape: Tuple[int, ...]
    mask_coarse: Optional[torch.Tensor] = None
    mask_fine: Optional[torch.Tensor] = None
    periodic: Optional[Tuple[bool, ...]] = None

    def matvec(self, xf):
        from ..multilevel.transfer import restrict_slices

        xf = gather(xf)
        if self.mask_fine is not None:
            xf = xf * self.mask_fine
        y = _fit0(restrict_slices(xf, periodic=self.periodic), self.coarse_shape)
        if self.mask_coarse is not None:
            y = y * self.mask_coarse
        return y


@dataclasses.dataclass
class Resharded:
    """An operator whose output takes the block layout `out_spec`: the
    redistribution stage after a grid transfer (reference
    GridTransferOperators.jl:316-347). A sharded output wanted whole is
    all-gathered; a whole output wanted sharded keeps this rank's block
    (a local slice, no message)."""

    op: object
    out_spec: P
    mesh: ProcessMesh

    def matvec(self, x):
        y = self.op.matvec(x)
        axes = tuple(a for a in self.out_spec if a is not None)
        if not axes:
            return gather(y)
        if isinstance(y, Sharded):
            return y
        return block_layout(self.mesh, axes, y.shape).shard(y)


def grid_spec(ndim: int, shard: bool, axis="p") -> P:
    if not shard:
        return P()
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    return P(*axes, *([None] * (ndim - len(axes))))


@dataclasses.dataclass(frozen=True)
class Gathered:
    """A direct solver for a coarsest level that is still sharded: its
    operator and right-hand side are gathered, every rank solves the whole
    system, and keeps its block of the answer."""

    solver: object

    def setup(self, A, x=None):
        return {"inner": self.solver.setup(A.gathered()), "A": A}

    def update(self, state, A, x=None):
        return self.setup(A, x)

    def apply(self, state, r):
        z = self.solver.apply(state["inner"], gather(r))
        return r.layout.shard(z) if isinstance(r, Sharded) else z

    def solve(self, state, b, x0=None):
        return self.apply(state, b), None


def distributed_poisson_gmg(
    hierarchy,
    mesh: ProcessMesh,
    smoother=None,
    min_sharded_rows: Optional[int] = None,
    axis="p",
    dtype=torch.float64,
    halo_exchange: bool = True,
    ca_smoother: bool = True,
    device=None,
    **kw,
):
    """Distributed GMG for Poisson on a process mesh: fine levels sharded,
    coarse levels replicated once a level has fewer than
    `min_sharded_rows` (default 2) rows of a sharded axis a rank. `axis`
    is one mesh-axis name (slab partition), a tuple of names, or None (all
    mesh axes: a box partition). Returns (gmg_solver, A_fine_sharded).
    Every rank of the mesh calls it.

    Every sharded level applies by halo exchange (`halo.HaloStencilMatrix`;
    the port has no SPMD partitioner to fall back to). `halo_exchange`
    keeps the JAX package's meaning for the rest: with it, a slab
    partition nests its level pads (one-halo-row transfers) and a
    Chebyshev smoother becomes the communication-avoiding
    `halo.HaloChebyshevSmoother` on the levels where the JAX package
    takes it (more than one rank, no periodic split axis, block height at
    least degree x reach). `device` holds the blocks (default: this rank's
    device)."""
    from ..fem.assembly import eliminate_dirichlet, laplacian
    from ..linear.direct import DenseLUSolver
    from ..linear.gmg import GMGSolver
    from ..linear.smoothers import ChebyshevSmoother
    from .halo import (
        HaloChebyshevSmoother,
        HaloProlongation,
        HaloRestriction,
        HaloStencilMatrix,
    )

    dev = resolve_device(mesh.device if device is None else device)
    axes = _axes_tuple(mesh, axis)
    ndim = hierarchy[0].dim
    procs = tuple(mesh.shape[a] for a in axes)
    min_rows = min_sharded_rows if min_sharded_rows is not None else 2

    def is_sharded(mesh_lev) -> bool:
        vs = mesh_lev.vertex_shape
        return all(vs[d] >= min_rows * p for d, p in enumerate(procs))

    sharded_flags = [is_sharded(m) for m in hierarchy.meshes]
    per0 = tuple(hierarchy[0].periodic)
    any_periodic0 = any(per0[: len(axes)])
    # nested level pads (slab partition): fine block = 2 x coarse block
    # along the split axis, so factor-2 transfers between sharded levels
    # need one halo row
    nested0 = {}
    use_nested = (halo_exchange and len(axes) == 1 and not any_periodic0
                  and any(sharded_flags) and procs[0] > 1)
    if use_nested:
        lc = max(i for i, s in enumerate(sharded_flags) if s)
        assert all(sharded_flags[: lc + 1]), "sharded prefix not contiguous"
        p0 = procs[0]
        m0 = pad0(hierarchy.meshes[lc].vertex_shape[0], p0) // p0
        for l in range(lc + 1):
            nested0[l] = p0 * m0 * (2 ** (lc - l))

    def padded_shape(lev):
        base = padded_shape_nd(hierarchy.meshes[lev].vertex_shape, procs)
        if lev in nested0:
            return (nested0[lev],) + base[1:]
        return base

    def padded_free_mask(lev):
        free = torch.from_numpy(~hierarchy.meshes[lev].boundary_vertex_mask()).to(dev, dtype)
        return pad_grid_vector(free, free.shape, procs, padded_shape(lev))

    ops = []
    for lev, m in enumerate(hierarchy.meshes):
        A = eliminate_dirichlet(laplacian(m, dtype, dev), m.boundary_vertex_mask())
        A = pad_stencil(A, procs, target_shape=padded_shape(lev))
        ops.append(HaloStencilMatrix.from_global(A, mesh, axes) if sharded_flags[lev]
                   else replicate_stencil(A, mesh))
    # where the JAX package wraps its sharded levels in its halo matvec
    # (more than one rank, no periodic split axis): the levels it may
    # smooth communication-avoidingly
    jax_halo = halo_exchange and max(procs) > 1 and not any_periodic0

    if ca_smoother and isinstance(smoother, ChebyshevSmoother) and len(axes) == 1:
        ca = HaloChebyshevSmoother(
            degree=smoother.degree, ratio=smoother.ratio, safety=smoother.safety,
            lanczos_iters=smoother.lanczos_iters, eig_method=smoother.eig_method)
        per_level = []
        for op in ops:
            ok = jax_halo and isinstance(op, HaloStencilMatrix)
            if ok:
                reach = max(abs(o[0]) for o in op.offsets)
                ok = op.grid_shape[0] // procs[0] >= smoother.degree * reach
            per_level.append(ca if ok else smoother)
        smoother = per_level[:-1] if len(per_level) > 1 else per_level

    prolongs, restricts = [], []
    for l in range(hierarchy.num_levels - 1):
        fine = hierarchy[l]
        per = tuple(fine.periodic) if any(fine.periodic) else None
        mf = padded_free_mask(l)
        mc = padded_free_mask(l + 1)
        if use_nested and l in nested0 and (l + 1) in nested0:
            prolongs.append(HaloProlongation(padded_shape(l), padded_shape(l + 1), mesh, axes,
                                             mf, per))
            restricts.append(HaloRestriction(padded_shape(l), padded_shape(l + 1), mesh, axes,
                                             mc, mf, per))
            continue
        Pop = DistProlongation(padded_shape(l), padded_shape(l + 1), mf, per)
        Rop = DistRestriction(padded_shape(l), padded_shape(l + 1), mc, mf, per)
        prolongs.append(Resharded(Pop, grid_spec(ndim, sharded_flags[l], axes), mesh))
        restricts.append(Resharded(Rop, grid_spec(ndim, sharded_flags[l + 1], axes), mesh))

    coarsest = kw.pop("coarsest_solver", None) or DenseLUSolver()
    if sharded_flags[-1]:
        coarsest = Gathered(coarsest)
    gmg = GMGSolver(
        coarse_ops=tuple(ops[1:]),
        prolongations=tuple(prolongs),
        restrictions=tuple(restricts),
        smoother=smoother or ChebyshevSmoother(degree=3),
        coarsest_solver=coarsest,
        **kw,
    )
    return gmg, ops[0]
