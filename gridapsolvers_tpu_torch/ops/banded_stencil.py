"""Kernel K2: variable-coefficient banded stencil SpMV.

Port of the TPU kernel `gridapsolvers_tpu/ops/banded_pallas.py`. The CUDA
source is `csrc/banded_stencil.cu` (its note says what bounds it and what
its design does about that). `banded_stencil_apply` is the engine of
`StencilMatrix.matvec`:

    y = sum_s bands[s] * shift(x, off_s)

with zero contributions from outside the grid on open axes and wraparound
on periodic ones. On a CUDA tensor it launches one of the two CUDA kernels
or raises: the box kernel where `box_permutation` finds a 3D grid with
open axes and exactly the 27 offsets of {-1, 0, 1}^3 that fits its launch
grid (every operator of the Poisson paths), the general kernel for
anything else. On a
CPU tensor it runs `banded_stencil_plain`, the plain PyTorch version (pad
once, slice per offset, as `algebra/stencil.py:132-156` of the JAX package
does). The sum is taken in x's dtype in both.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools
import math

import torch

from ..utils import check_same_device
from . import build


@dataclasses.dataclass
class StencilLaunchCounts(build.LaunchCounts):
    """Launches of K2; `box` counts those of `kernel` that took the box
    kernel."""

    box: int = 0

    def reset(self) -> None:
        super().reset()
        self.box = 0


counts = StencilLaunchCounts()

_SUFFIX = {
    (torch.float32, torch.float32): "f32_f32",
    (torch.bfloat16, torch.float32): "bf16_f32",
    (torch.float64, torch.float64): "f64_f64",
}
# general: (bands, x, offsets, y, S, n0, n1, n2, per0, per1, per2, stream)
_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 7 + (ctypes.c_void_p,)
# box: (bands, x, y, perm, n0, n1, n2, stream)
_BOX_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)
# the box kernel's launch grid puts n1 / 8 (rows of a tile) and n0 (one
# plane of i a block at least) on gridDim.y and gridDim.z, each at most this
_BOX_TILE_J, _GRID_YZ_MAX = 8, 65535
_MAX_OFFSETS = 4096  # the (S, 3) int32 table is staged in 48 KB of shared memory


def pad_halo(xg, lo, hi, periodic):
    """Pad each axis k by lo[k]/hi[k]: zeros on open axes, wrapped values
    on periodic ones."""
    xp = xg
    for k in range(xg.ndim):
        if lo[k] == 0 and hi[k] == 0:
            continue
        n = xp.shape[k]
        parts = []
        if lo[k]:
            part = xp.narrow(k, n - lo[k], lo[k])
            parts.append(part if periodic[k] else torch.zeros_like(part))
        parts.append(xp)
        if hi[k]:
            part = xp.narrow(k, 0, hi[k])
            parts.append(part if periodic[k] else torch.zeros_like(part))
        xp = torch.cat(parts, dim=k)
    return xp


def banded_stencil_plain(bands, offsets, grid_shape, periodic, x):
    """Plain PyTorch version: any offsets, dtypes and device."""
    counts.plain += 1
    xg = x.reshape(grid_shape)
    d = xg.ndim
    lo = [max(-min(o[k] for o in offsets), 0) for k in range(d)]
    hi = [max(max(o[k] for o in offsets), 0) for k in range(d)]
    xp = pad_halo(xg, lo, hi, periodic)
    y = torch.zeros_like(xg)
    for s, off in enumerate(offsets):
        sl = tuple(
            slice(lo[k] + off[k], lo[k] + off[k] + xg.shape[k]) for k in range(d)
        )
        y = y + bands[s].to(x.dtype) * xp[sl]
    return y.reshape(-1)


_BOX = tuple(itertools.product((-1, 0, 1), repeat=3))


@functools.lru_cache(maxsize=None)
def box_permutation(offsets, grid_shape, periodic):
    """The box kernel's table, or None where it does not apply: for each
    box position (di, dj, dk) in {-1, 0, 1}^3, in lexicographic order, the
    index of its band. It applies to a 3D grid with no periodic axis whose
    offsets are exactly those 27, in any order, and whose n0 and n1 fit the
    kernel's launch grid."""
    offsets = tuple(tuple(int(v) for v in off) for off in offsets)
    if len(offsets) != 27 or any(len(o) != 3 for o in offsets) or any(periodic):
        return None
    if len(grid_shape) != 3 or grid_shape[0] > _GRID_YZ_MAX or (
            -(-grid_shape[1] // _BOX_TILE_J) > _GRID_YZ_MAX):
        return None
    if set(offsets) != set(_BOX):
        return None
    return tuple(offsets.index(b) for b in _BOX)


@functools.lru_cache(maxsize=None)
def _offset_table(offsets, device) -> torch.Tensor:
    """(S, 3) int32 offsets on `device`, leading axes padded with 0 for
    1D/2D grids (static per operator, so built once)."""
    d = len(offsets[0])
    rows = [(0,) * (3 - d) + tuple(int(v) for v in off) for off in offsets]
    return torch.tensor(rows, dtype=torch.int32, device=device)


def banded_stencil_cuda(bands, offsets, grid_shape, periodic, x, general=False):
    """Launch the box kernel where `box_permutation` applies and the
    general kernel otherwise, or always with `general` (to measure the two
    on one operator). Raises on anything the kernels do not take."""
    d = len(grid_shape)
    if not 1 <= d <= 3:
        raise ValueError(f"banded_stencil kernel takes 1D-3D grids, got {d}D")
    if x.device.type != "cuda":
        raise ValueError(f"banded_stencil kernel needs CUDA tensors, got {x.device}")
    check_same_device(x, bands)
    key = (bands.dtype, x.dtype)
    if key not in _SUFFIX:
        raise TypeError(
            f"banded_stencil kernel takes (bands, x) dtypes {list(_SUFFIX)}, "
            f"got {key}"
        )
    S = len(offsets)
    if not 1 <= S <= _MAX_OFFSETS or any(len(o) != d for o in offsets):
        raise ValueError(f"banded_stencil kernel: bad offset table ({S} offsets)")
    n = math.prod(grid_shape)
    if tuple(bands.shape) != (S, *grid_shape) or x.numel() != n:
        raise ValueError(
            f"banded_stencil kernel: bands {tuple(bands.shape)}, x "
            f"{tuple(x.shape)} for grid {tuple(grid_shape)} and {S} offsets"
        )
    if not (bands.is_contiguous() and x.is_contiguous()):
        raise ValueError("banded_stencil kernel needs contiguous tensors")
    gs = [1] * (3 - d) + list(grid_shape)
    per = [0] * (3 - d) + [int(bool(p)) for p in periodic]
    perm = None if general else box_permutation(tuple(map(tuple, offsets)), tuple(grid_shape),
                                                tuple(bool(p) for p in periodic))
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    if perm is not None:
        name = f"banded_box_{_SUFFIX[key]}"
        fn = build.function("banded_stencil", name, _BOX_ARGTYPES)
        table = (ctypes.c_int * 27)(*perm)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            status = fn(bands.data_ptr(), x.data_ptr(), y.data_ptr(), ctypes.addressof(table),
                        gs[0], gs[1], gs[2], stream)
    else:
        name = f"banded_stencil_{_SUFFIX[key]}"
        fn = build.function("banded_stencil", name, _ARGTYPES)
        table = _offset_table(tuple(map(tuple, offsets)), x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            status = fn(
                bands.data_ptr(), x.data_ptr(), table.data_ptr(), y.data_ptr(),
                S, gs[0], gs[1], gs[2], per[0], per[1], per[2], stream,
            )
    build.check_status(name, status)
    counts.kernel += 1
    counts.shapes[(S, *map(int, grid_shape))] += 1
    counts.box += perm is not None
    return y


def banded_stencil_apply(bands, offsets, grid_shape, periodic, x):
    """StencilMatrix.matvec engine: the kernel on CUDA, the plain version
    on the CPU, an error anywhere else."""
    if x.device.type == "cuda":
        return banded_stencil_cuda(bands, offsets, grid_shape, periodic, x)
    if x.device.type == "cpu":
        check_same_device(x, bands)
        return banded_stencil_plain(bands, offsets, grid_shape, periodic, x)
    raise ValueError(f"no banded_stencil engine for device {x.device}")
