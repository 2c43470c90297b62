"""Halo-exchange stencil matvec, transfers and smoother.

Port of `gridapsolvers_tpu/parallel/halo.py`. A sharded level's matvec
exchanges, along each split grid axis in turn, the slabs its neighbours
need (one point-to-point batch an axis: the last `lo` rows up, the first
`hi` rows down), so the corners arrive through the earlier axes, as in
the JAX package (:233-260). The local apply then runs kernel K2 on the
halo-extended block and keeps the core rows.

K2 on the extended block: the bands are zero-padded in the halo rows once
at set-up (`bands_ext`) and the existing kernel runs over the extended
grid, open on the exchanged axes. This needs no new kernel entry and no
second plain version; it costs the halo rows' work (2 of m + 2 rows of a
block), which the core rows' exchange already moves. On a CUDA block the
apply launches K2 or raises; on a CPU block it runs K2's plain version
(`algebra.stencil` dispatch); neither gives way to the other.

A periodic split axis exchanges the wrap pairs too (rank 0 with rank
p - 1), where the JAX package falls back to its SPMD partitioner
(:139-142). An axis of one rank is not exchanged: K2 wraps it itself.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..algebra.stencil import StencilMatrix
from ..ops.banded_stencil import banded_stencil_apply
from ..utils import pytrees as pt
from ..utils.pytrees import Sharded
from .dist import BlockLayout, _axes_tuple, block_layout
from .mesh import ProcessMesh


def _halo_widths(offsets, k):
    lo = max(-min(o[k] for o in offsets), 0)
    hi = max(max(o[k] for o in offsets), 0)
    return lo, hi


def _extend(mesh: ProcessMesh, axis: str, k: int, t: torch.Tensor, lo: int, hi: int,
            wrap: bool) -> torch.Tensor:
    """`t` with `lo` rows of the previous rank and `hi` of the next one
    along grid axis k (zeros past an edge that does not wrap)."""
    n = t.shape[k]
    up = t.narrow(k, n - lo, lo) if lo else None
    down = t.narrow(k, 0, hi) if hi else None
    from_prev, from_next = mesh.exchange(axis, up=up, down=down, wrap=wrap)
    parts = [p for p in (from_prev, t, from_next) if p is not None]
    return torch.cat(parts, dim=k) if len(parts) > 1 else t


@dataclasses.dataclass
class HaloStencilMatrix:
    """A sharded level's stencil operator. `inner` holds this rank's block
    of the bands (grid_vectors=True, the global periodic flags); `layout`
    the split; `bands_ext` the bands zero-padded in the halo rows of the
    exchanged axes (`inner.bands` is a view of its core). `grid_shape`,
    `n` and `shape` are the global operator's, as in the JAX package."""

    inner: StencilMatrix
    mesh: ProcessMesh
    axes: Tuple[str, ...]
    layout: BlockLayout
    bands_ext: torch.Tensor
    exchanged: Tuple[int, ...]   # grid axes split over more than one rank
    core: Tuple[slice, ...]      # the block inside the extended block

    @classmethod
    def from_blocks(cls, local_bands, offsets, global_shape, periodic, mesh, axes):
        """From this rank's block of the bands (S, *block)."""
        axes = tuple(axes)
        layout = block_layout(mesh, axes, global_shape)
        d = len(global_shape)
        per = tuple(periodic) if periodic is not None else (False,) * d
        exchanged = tuple(k for k in range(len(axes))
                          if layout.procs[k] > 1 and any(_halo_widths(offsets, k)))
        ext, core = [], []
        for k, m in enumerate(layout.block_shape):
            lo, hi = _halo_widths(offsets, k) if k in exchanged else (0, 0)
            ext.append(m + lo + hi)
            core.append(slice(lo, lo + m))
        if exchanged:
            bands_ext = local_bands.new_zeros((local_bands.shape[0],) + tuple(ext))
            bands_ext[(slice(None),) + tuple(core)] = local_bands
            local_bands = bands_ext[(slice(None),) + tuple(core)]
        else:
            bands_ext = local_bands = local_bands.contiguous()
        inner = StencilMatrix(local_bands, tuple(map(tuple, offsets)), layout.block_shape,
                              periodic=None if periodic is None else per, grid_vectors=True)
        return cls(inner, mesh, axes, layout, bands_ext, exchanged, tuple(core))

    @classmethod
    def from_global(cls, A: StencilMatrix, mesh: ProcessMesh, axes):
        """From the whole (padded) operator: this rank keeps its block."""
        layout = block_layout(mesh, axes, A.grid_shape)
        return cls.from_blocks(layout.take(A.bands, lead=1), A.offsets, A.grid_shape,
                               A.periodic, mesh, axes)

    # -- pass-throughs --------------------------------------------------
    @property
    def grid_shape(self):
        return self.layout.global_shape

    @property
    def offsets(self):
        return self.inner.offsets

    @property
    def grid_vectors(self):
        return True

    @property
    def periodic(self):
        return self.inner.periodic

    @property
    def n(self):
        return self.layout.global_numel

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.inner.dtype

    @property
    def device(self):
        return self.inner.device

    @property
    def nnz(self):
        return len(self.offsets) * self.n

    @property
    def bands(self):
        """This rank's block of the bands."""
        return self.inner.bands

    def _per(self):
        return self.inner._periodic()

    def diag(self) -> Sharded:
        return Sharded(self.inner.diag(), self.layout)

    def abs_row_sum(self) -> Sharded:
        return Sharded(self.inner.abs_row_sum(), self.layout)

    def gathered(self) -> StencilMatrix:
        """The whole operator on every rank (one all-gather of the bands)."""
        bands = self.layout.gather(self.inner.bands.contiguous(), lead=1)
        return StencilMatrix(bands, self.offsets, self.grid_shape, self.periodic,
                             grid_vectors=True)

    def todense(self) -> torch.Tensor:
        return self.gathered().todense()

    def astype(self, dtype) -> "HaloStencilMatrix":
        return HaloStencilMatrix.from_blocks(self.inner.bands.to(dtype), self.offsets,
                                             self.grid_shape, self.periodic, self.mesh,
                                             self.axes)

    # -- matvec ---------------------------------------------------------
    def extend(self, xl: torch.Tensor) -> torch.Tensor:
        """The halo-extended block of x: one exchange a split axis, in
        order, each carrying the halos of the earlier ones (corners)."""
        per = self._per()
        for k in self.exchanged:
            lo, hi = _halo_widths(self.offsets, k)
            xl = _extend(self.mesh, self.axes[k], k, xl, lo, hi, per[k])
        return xl

    def matvec(self, x: Sharded) -> Sharded:
        if not (isinstance(x, Sharded) and x.layout == self.layout):
            raise TypeError("HaloStencilMatrix.matvec takes a Sharded vector of its layout")
        if not self.exchanged:
            y = banded_stencil_apply(self.bands_ext, self.offsets, self.layout.block_shape,
                                     self._per(), x.local.contiguous())
            return Sharded(y.reshape(self.layout.block_shape), self.layout)
        xe = self.extend(x.local).contiguous()
        per_ext = tuple(False if k in self.exchanged else p for k, p in enumerate(self._per()))
        ye = banded_stencil_apply(self.bands_ext, self.offsets, tuple(xe.shape), per_ext, xe)
        return Sharded(ye.reshape(xe.shape)[self.core].contiguous(), self.layout)


def _local(mask, layout: BlockLayout):
    if mask is None or isinstance(mask, Sharded):
        return mask
    return layout.shard(mask)


@dataclasses.dataclass
class HaloProlongation:
    """Factor-2 Q1 interpolation between nested-padded slab-sharded grids
    (fine block = 2 x coarse block along the split axis): one exchange
    (the next rank's first coarse row) and a local interleave,
    fine[2t] = c[t], fine[2t + 1] = (c[t] + c[t + 1]) / 2. `mask_fine` is
    the whole fine mask or this rank's block of it."""

    fine_shape: Tuple[int, ...]
    coarse_shape: Tuple[int, ...]
    mesh: ProcessMesh
    axes: Tuple[str, ...]
    mask_fine: object = None
    periodic: Optional[Tuple[bool, ...]] = None

    def __post_init__(self):
        self.axes = _axes_tuple(self.mesh, self.axes)
        per = self.periodic or (False,) * len(self.coarse_shape)
        assert len(self.axes) == 1 and not per[0]
        self.fine_layout = block_layout(self.mesh, self.axes, self.fine_shape)
        self.coarse_layout = block_layout(self.mesh, self.axes, self.coarse_shape)
        assert self.fine_layout.block_shape[0] == 2 * self.coarse_layout.block_shape[0]
        self.mask_fine = _local(self.mask_fine, self.fine_layout)

    def matvec(self, xc: Sharded) -> Sharded:
        from ..multilevel.transfer import _expand_dim

        per = self.periodic or (False,) * len(self.coarse_shape)
        cl = xc.local
        m = cl.shape[0]
        _, c_next = self.mesh.exchange(self.axes[0], down=cl[:1])
        nxt = torch.cat([cl[1:], c_next], dim=0)
        odd = 0.5 * (cl + nxt)
        out = torch.stack([cl, odd], dim=1).reshape((2 * m,) + tuple(cl.shape[1:]))
        for k in range(1, cl.ndim):
            out = _expand_dim(out, k, per[k])
        assert tuple(out.shape) == self.fine_layout.block_shape, out.shape
        if self.mask_fine is not None:
            out = out * self.mask_fine.local
        return Sharded(out, self.fine_layout)


@dataclasses.dataclass
class HaloRestriction:
    """Full-weighting restriction between nested-padded slab-sharded
    grids, z[t] = f[2t] + f[2t - 1] / 2 + f[2t + 1] / 2, with f[-1] the
    previous rank's last row (one exchange). Transpose of
    `HaloProlongation` on the real region."""

    fine_shape: Tuple[int, ...]
    coarse_shape: Tuple[int, ...]
    mesh: ProcessMesh
    axes: Tuple[str, ...]
    mask_coarse: object = None
    mask_fine: object = None
    periodic: Optional[Tuple[bool, ...]] = None

    def __post_init__(self):
        self.axes = _axes_tuple(self.mesh, self.axes)
        per = self.periodic or (False,) * len(self.fine_shape)
        assert len(self.axes) == 1 and not per[0]
        self.fine_layout = block_layout(self.mesh, self.axes, self.fine_shape)
        self.coarse_layout = block_layout(self.mesh, self.axes, self.coarse_shape)
        self.mask_fine = _local(self.mask_fine, self.fine_layout)
        self.mask_coarse = _local(self.mask_coarse, self.coarse_layout)

    def matvec(self, xf: Sharded) -> Sharded:
        from ..multilevel.transfer import _reduce_dim

        per = self.periodic or (False,) * len(self.fine_shape)
        fl = xf.local
        if self.mask_fine is not None:
            fl = fl * self.mask_fine.local
        m2 = fl.shape[0]
        m = m2 // 2
        h_prev, _ = self.mesh.exchange(self.axes[0], up=fl[m2 - 1:])
        pairs = fl.reshape((m, 2) + tuple(fl.shape[1:]))
        even, odd = pairs[:, 0], pairs[:, 1]
        odd_right = torch.cat([h_prev, odd[:-1]], dim=0)
        out = even + 0.5 * odd + 0.5 * odd_right
        for k in range(1, fl.ndim):
            out = _reduce_dim(out, k, per[k])
        assert tuple(out.shape) == self.coarse_layout.block_shape, out.shape
        if self.mask_coarse is not None:
            out = out * self.mask_coarse.local
        return Sharded(out, self.coarse_layout)


def halo_wrap(A, mesh: ProcessMesh, axes) -> HaloStencilMatrix:
    """The halo-exchange form of a stencil operator: a `HaloStencilMatrix`
    stays as it is; a whole (padded) `StencilMatrix` is split, this rank
    keeping its block. `axes` as in parallel.dist (one name, a tuple, or
    None for all)."""
    if isinstance(A, HaloStencilMatrix):
        return A
    return HaloStencilMatrix.from_global(A, mesh, _axes_tuple(mesh, axes))


def halo_spmv(A, mesh: ProcessMesh, axis: str = "p"):
    """Closure form of the halo matvec (the JAX package's round-2 API)."""
    return halo_wrap(A, mesh, axis).matvec


def _ghost_extend(mesh: ProcessMesh, axis: str, W: int, t: torch.Tensor, k: int):
    """`t` extended along grid axis k by W rows of each neighbour's data
    (zeros at the physical edges): the ghosted layout, made once at
    set-up."""
    return _extend(mesh, axis, k, t, W, W, False)


@dataclasses.dataclass(frozen=True)
class HaloChebyshevSmoother:
    """Communication-avoiding Chebyshev smoother for slab-sharded
    `HaloStencilMatrix` levels: one depth-W exchange of the residual a
    sweep (W = degree x stencil reach) instead of one a matvec. The whole
    degree-d recurrence runs on the W-extended block; the values in the
    core equal the per-matvec-exchange sweep's (`linear.ChebyshevSmoother`
    on the same operator: the same coefficients, the same operations in
    the same order), and the garbage of the shrinking margin never reaches
    the core. Set-up keeps ghost-extended copies of the bands and inverse
    diagonal (made with the same exchange) and needs a block height of at
    least W. Each sweep's matvec is K2 on the extended block."""

    degree: int = 3
    ratio: float = 30.0
    safety: float = 1.1
    lanczos_iters: int = 20
    eig_method: str = "gershgorin"

    def _base(self):
        from ..linear.smoothers import ChebyshevSmoother

        return ChebyshevSmoother(degree=self.degree, ratio=self.ratio, safety=self.safety,
                                 lanczos_iters=self.lanczos_iters, eig_method=self.eig_method)

    def _width(self, A) -> int:
        return self.degree * max(max(-o[0], o[0]) for o in A.offsets)

    def setup(self, A, x=None):
        assert isinstance(A, HaloStencilMatrix) and len(A.axes) == 1
        base = self._base().setup(A)
        W = self._width(A)
        m = A.layout.block_shape[0]
        assert m >= W, (m, W)
        axis = A.axes[0]
        return {
            "A": A, "lmax": base["lmax"], "lmin": base["lmin"],
            "bands_ext": _ghost_extend(A.mesh, axis, W, A.bands, 1).contiguous(),
            "invd_ext": _ghost_extend(A.mesh, axis, W, base["inv_diag"].local, 0),
        }

    def update(self, state, A, x=None):
        return self.setup(A, x)

    def apply(self, state, r):
        x, _ = self.smooth(state, pt.zeros_like(r), r)
        return x

    def smooth(self, state, x, r):
        from ..linear.smoothers import _chebyshev_coefficients

        A = state["A"]
        W = self._width(A)
        per = A._per()
        per_ext = (False,) + tuple(per[1:])
        be, de = state["bands_ext"], state["invd_ext"]
        inv_theta, steps = _chebyshev_coefficients(state["lmax"], state["lmin"], self.degree,
                                                    r.local.dtype)
        re = _ghost_extend(A.mesh, A.axes[0], W, r.local, 0)
        shape = tuple(re.shape)

        def local_mv(v):
            # zero-halo matvec on the extended block (K2): the margin rows
            # take garbage that stays in the shrinking margin
            return banded_stencil_apply(be, A.offsets, shape, per_ext, v).reshape(shape)

        core = slice(W, shape[0] - W)
        z = de * re
        d = inv_theta * z
        xe = torch.zeros_like(re)
        xe[core] = x.local
        for d_coef, d_scale in steps:
            xe = xe + d
            re = re - local_mv(d)
            z = de * re
            d = d_coef * z + d_scale * d
        return (Sharded(xe[core].contiguous(), x.layout),
                Sharded(re[core].contiguous(), r.layout))

    def solve(self, state, b, x0=None):
        x = pt.zeros_like(b) if x0 is None else x0
        r = pt.sub(b, state["A"].matvec(x))
        x, _ = self.smooth(state, x, r)
        return x, None
