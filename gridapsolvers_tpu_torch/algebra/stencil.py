"""Stencil (generalized-DIA) matrices on structured grids.

Port of `gridapsolvers_tpu/algebra/stencil.py`. On a structured grid every
dof couples only to neighbours at a static set of grid offsets, so an
operator is one dense band per offset:

    bands[s, i...] = A[i, i + offsets[s]]   (0 where the neighbour is
                                             outside the grid)

and SpMV is sum_s bands[s] * shift(x, offsets[s]). `StencilMatrix.matvec`
runs kernel K2 (`ops/banded_stencil.py`) on CUDA tensors and its plain
PyTorch version on CPU tensors; `ConstStencilMatrix.matvec` does the same
with kernel K1 (`ops/const_stencil.py`). Vectors are flat (prod(grid),)
tensors, or grid-shaped ones for a `StencilMatrix` built with
`grid_vectors=True` (the distributed path, `parallel/`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.banded_stencil import banded_stencil_apply
from ..ops.const_stencil import const_stencil_apply
from ..utils import resolve_device


def shift(
    xg: torch.Tensor, off: Sequence[int], periodic: Optional[Sequence[bool]] = None
) -> torch.Tensor:
    """shifted[i] = xg[i + off] with zero outside the grid on open axes
    and wraparound on periodic ones."""
    out = xg
    for d, o in enumerate(off):
        if o == 0:
            continue
        if periodic is not None and periodic[d]:
            out = torch.roll(out, -o, dims=d)
            continue
        n = out.shape[d]
        pads = [0] * (2 * out.ndim)
        k = 2 * (out.ndim - 1 - d)  # F.pad lists the last axis first
        if o > 0:
            out = out.narrow(d, o, max(n - o, 0))
            pads[k + 1] = o
        else:
            out = out.narrow(d, 0, max(n + o, 0))
            pads[k] = -o
        out = F.pad(out, pads)
    return out


def _neighbour_index(grid_shape, off, periodic):
    """(valid, flat neighbour index) of every grid point for one offset."""
    coords = np.meshgrid(*[np.arange(m) for m in grid_shape], indexing="ij")
    valid = np.ones(grid_shape, dtype=bool)
    nb = np.zeros(grid_shape, dtype=np.int64)
    for d, m in enumerate(grid_shape):
        c = coords[d] + off[d]
        if periodic[d]:
            c = c % m
        else:
            valid &= (c >= 0) & (c < m)
            c = np.clip(c, 0, m - 1)
        nb = nb * m + c
    return valid.reshape(-1), nb.reshape(-1)


@dataclasses.dataclass
class StencilMatrix:
    """Structured-grid operator with static neighbour offsets.

    bands      : (n_offsets, *grid_shape) tensor
    offsets    : tuple of d-tuples
    grid_shape : dof grid shape; vectors are flat (prod(grid),)
    periodic   : per-axis periodic wrap (None = all open)
    grid_vectors : vectors, diag() and abs_row_sum() are grid-shaped
                 instead of flat (the JAX package's flag of that name,
                 `algebra/stencil.py:76`, set by its distributed path)
    """

    bands: torch.Tensor
    offsets: Tuple[Tuple[int, ...], ...]
    grid_shape: Tuple[int, ...]
    periodic: Optional[Tuple[bool, ...]] = None
    grid_vectors: bool = False

    @property
    def n(self) -> int:
        return int(np.prod(self.grid_shape))

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.bands.dtype

    @property
    def device(self):
        return self.bands.device

    @property
    def nnz(self) -> int:
        return self.bands.shape[0] * self.n

    def _periodic(self):
        return self.periodic or tuple(False for _ in self.grid_shape)

    def _out(self, v: torch.Tensor) -> torch.Tensor:
        return v.reshape(self.grid_shape if self.grid_vectors else (-1,))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self._out(banded_stencil_apply(
            self.bands, self.offsets, self.grid_shape, self._periodic(), x
        ))

    def diag(self) -> torch.Tensor:
        center = self.offsets.index(tuple(0 for _ in self.grid_shape))
        return self._out(self.bands[center])

    def abs_row_sum(self) -> torch.Tensor:
        """sum_j |a_ij| per row (Gershgorin bounds)."""
        return self._out(torch.sum(torch.abs(self.bands), dim=0))

    def astype(self, dtype) -> "StencilMatrix":
        return dataclasses.replace(self, bands=self.bands.to(dtype))

    def with_grid_vectors(self, flag: bool = True) -> "StencilMatrix":
        return dataclasses.replace(self, grid_vectors=flag)

    def to_ell(self, device=None):
        """ELLMatrix of the same operator on `device` (default: the bands'
        device), converted on the host (AMG set-up, checks). Zero band
        entries are dropped, periodic axes wrap, and the row width is the
        number of offsets."""
        from .ell import ell_from_coo

        bands = self.bands.cpu().numpy()
        gs = self.grid_shape
        n = self.n
        idx = np.arange(n).reshape(gs)
        per = self._periodic()
        rows_all, cols_all, vals_all = [], [], []
        for s, off in enumerate(self.offsets):
            valid, nb = _neighbour_index(gs, off, per)
            v = bands[s].reshape(-1)
            m = valid & (v != 0)
            rows_all.append(idx.reshape(-1)[m])
            cols_all.append(nb[m])
            vals_all.append(v[m])
        return ell_from_coo(
            n, n, np.concatenate(rows_all), np.concatenate(cols_all),
            np.concatenate(vals_all), row_width=len(self.offsets),
            device=self.device if device is None else device,
        )

    def todense(self) -> torch.Tensor:
        """Dense (n, n) matrix on the bands' device, built straight from the
        bands (coarse solves, checks). Duplicate entries, from periodic
        wraps on tiny grids, are summed."""
        n = self.n
        per = self._periodic()
        flat = self.bands.reshape(len(self.offsets), n)
        dense = torch.zeros((n, n), dtype=self.dtype, device=self.device)
        rows = np.arange(n)
        for s, off in enumerate(self.offsets):
            valid, nb = _neighbour_index(self.grid_shape, off, per)
            r = torch.as_tensor(rows[valid], device=self.device)
            c = torch.as_tensor(nb[valid], device=self.device)
            dense.index_put_((r, c), flat[s][r], accumulate=True)
        return dense


def stencil_from_scipy(
    S, grid_shape, periodic=None, dtype=None, device=None
) -> StencilMatrix:
    """Host-side scipy sparse -> banded StencilMatrix on a dof grid.

    Works for any grid-local operator whose column offsets (in grid
    coordinates) form a small static set, e.g. Q2 stiffness on the Q2
    node grid has a 5^d offset envelope. Bands carry explicit zeros where
    a pair inside the envelope is uncoupled. `dtype` is a torch dtype
    (default: the matrix's own).
    """
    coo = S.tocoo()
    gs = tuple(int(m) for m in grid_shape)
    d = len(gs)
    n = int(np.prod(gs))
    if S.shape != (n, n):
        raise ValueError(f"matrix shape {S.shape} does not fit grid {gs}")
    per = tuple(periodic) if periodic is not None else (False,) * d
    # per-axis grid offsets of every entry (column coordinate - row
    # coordinate; periodic axes wrapped into [-m/2, m/2))
    delta = []
    for k, (ri, ci) in enumerate(zip(np.unravel_index(coo.row, gs),
                                     np.unravel_index(coo.col, gs))):
        dk = ci.astype(np.int64) - ri
        if per[k]:
            dk = (dk + gs[k] // 2) % gs[k] - gs[k] // 2
        delta.append(dk)
    lo = [int(dk.min()) for dk in delta]
    dims = tuple(int(dk.max()) - l + 1 for dk, l in zip(delta, lo))
    key = np.zeros(len(coo.row), dtype=np.int64)
    for dk, l, m in zip(delta, lo, dims):
        key = key * m + (dk - l)
    # the sorted distinct keys and each entry's rank among them (what
    # np.unique(key, return_inverse=True) gives), in time linear in the
    # entries: the keys range over the small offset envelope
    ukeys = np.flatnonzero(np.bincount(key, minlength=int(np.prod(dims))))
    rank = np.zeros(int(np.prod(dims)), dtype=np.int64)
    rank[ukeys] = np.arange(len(ukeys))
    inv = rank[key]
    offs = np.stack(np.unravel_index(ukeys, dims), axis=1) + np.asarray(lo)
    offsets = [tuple(int(v) for v in row) for row in offs]
    center = tuple(0 for _ in gs)
    if center not in offsets:  # diag() needs the center band
        offsets.append(center)
    # duplicates summed, as np.add.at sums them
    bands = np.bincount(inv * n + coo.row, weights=coo.data,
                        minlength=len(offsets) * n).astype(coo.data.dtype, copy=False)
    bands_t = torch.from_numpy(bands.reshape((len(offsets),) + gs))
    return StencilMatrix(
        bands_t.to(device=resolve_device(device), dtype=dtype or bands_t.dtype),
        tuple(offsets),
        gs,
        periodic=per if any(per) else None,
    )


@dataclasses.dataclass
class ConstStencilMatrix:
    """Matrix-free constant-coefficient stencil operator with Dirichlet
    elimination:

        y = free * (sum_s w_s * shift(free * x, s)) + (1 - free) * x

    which is exactly the Dirichlet-eliminated operator (identity on
    constrained dofs, zeroed constrained columns) whenever every free dof
    has a full cell neighbourhood, as in boundary-constrained problems.
    Device memory traffic is ~3 values a point against the (3^d + 2) of a
    banded SpMV.
    """

    weights: torch.Tensor  # (n_offsets,)
    free: torch.Tensor     # grid-shaped {0,1} mask
    offsets: Tuple[Tuple[int, ...], ...]
    grid_shape: Tuple[int, ...]

    @property
    def n(self) -> int:
        return int(np.prod(self.grid_shape))

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.weights.dtype

    @property
    def device(self):
        return self.weights.device

    @property
    def nnz(self) -> int:
        return self.weights.shape[0] * self.n

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return const_stencil_apply(
            self.weights, self.free, self.offsets, self.grid_shape, x
        )

    def diag(self) -> torch.Tensor:
        center = self.offsets.index(tuple(0 for _ in self.grid_shape))
        return (self.free * self.weights[center] + (1.0 - self.free)).reshape(-1)

    def abs_row_sum(self) -> torch.Tensor:
        s = self.free * torch.sum(torch.abs(self.weights)) + (1.0 - self.free)
        return s.reshape(-1)

    def expand(self) -> StencilMatrix:
        """Materialize as a banded StencilMatrix (checks, coarse solve)."""
        from ..fem.assembly import eliminate_dirichlet

        w = self.weights.reshape((-1,) + (1,) * len(self.grid_shape))
        bands = w.expand((w.shape[0],) + tuple(self.grid_shape)).contiguous()
        A = StencilMatrix(bands, self.offsets, self.grid_shape)
        mask = (self.free < 0.5).cpu().numpy()
        return eliminate_dirichlet(A, mask)

    def todense(self) -> torch.Tensor:
        return self.expand().todense()


def poisson_stencil(
    grid_shape: Tuple[int, ...],
    h: Sequence[float],
    dtype=torch.float64,
    dirichlet_mask: Optional[np.ndarray] = None,
    device=None,
) -> StencilMatrix:
    """Q1 FEM Laplacian bands on a uniform Cartesian vertex grid, assembled
    band-wise on the host (see `fem.assembly.assemble_poisson_stencil`).
    `dirichlet_mask` marks constrained dofs: their rows and columns become
    identity."""
    from ..fem.assembly import assemble_poisson_stencil

    return assemble_poisson_stencil(grid_shape, h, dtype, dirichlet_mask, device)
