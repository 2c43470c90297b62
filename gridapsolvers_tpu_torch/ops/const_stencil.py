"""Kernel K1: constant-coefficient 3^d-point stencil matvec.

Port of the TPU kernel `gridapsolvers_tpu/ops/stencil_pallas.py`. The CUDA
source is `csrc/const_stencil.cu` (its note says what bounds it and what
its design does about that). `const_stencil_apply` is the engine of
`ConstStencilMatrix.matvec`:

    y = free * sum_s w_s * shift(free * x, o_s) + (1 - free) * x

On a CUDA tensor it launches one of the two CUDA kernels or raises: the
plane-marching kernel where `march_tiles` gives a tiling (3D grids within
its launch limits: every operator of the Poisson paths), the general
kernel for anything else (2D grids among them). On a CPU tensor it runs
`const_stencil_plain`, the plain PyTorch version (pad once, slice per
offset, as `algebra/stencil.py:338-353` of the JAX package does).

Values are f32, f64 or bf16. bf16 x, mask and weights are summed in f32
and y is rounded to bf16 once (the port's contract for K1: bf16 values,
f32 sums), in the kernels and in the plain version alike. The TPU kernel
differs there by design: it sums in x's dtype (`stencil_pallas.py:45`),
so its bf16 result rounds at every add.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools
import math
import weakref

import torch
import torch.nn.functional as F

from ..utils import check_same_device
from . import build


@dataclasses.dataclass
class StencilLaunchCounts(build.LaunchCounts):
    """Launches of K1; `march` counts those of `kernel` that took the
    plane-marching kernel, `bf16` those on bf16 values (either kernel)."""

    march: int = 0
    bf16: int = 0

    def reset(self) -> None:
        super().reset()
        self.march = 0
        self.bf16 = 0


counts = StencilLaunchCounts()

_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}
# dtypes whose sums the kernels and the plain version take in a wider one
_SUM_DTYPE = {torch.bfloat16: torch.float32}
# general: (x, free, weights, y, dim, n0, n1, n2, stream)
_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)
# march: (x, free, y, host weights, n0, n1, n2, tk, groups, planes, stream)
_MARCH_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,)
# The marching kernel's tiling (csrc/const_stencil.cu): rows a thread (R),
# row groups a tile, most columns a tile. gridDim.y and gridDim.z are each
# at most _GRID_YZ_MAX, and in-plane byte offsets fit an int32; the kernel
# checks the rest and refuses a tiling it cannot launch.
_MARCH_ROWS = {torch.float32: 4, torch.float64: 2, torch.bfloat16: 4}
_MARCH_GROUPS = 3
_MARCH_TILE_K = 64
# blocks a launch should have at least: two an SM of an H100 in f32, four
# in f64 (PERF.md's run-length sweeps); bf16 sums in an f32 ring, as f32
_MARCH_BLOCKS = {torch.float32: 2 * 132, torch.float64: 4 * 132, torch.bfloat16: 2 * 132}
_GRID_YZ_MAX = 65535
_INT32_MAX = 2 ** 31 - 1


@functools.lru_cache(maxsize=None)
def march_tiles(grid_shape, dtype):
    """The marching kernel's tiling `(tk, groups, planes)` for a grid, or
    None where it does not apply (not 3D, or past its launch limits).

    The k extent is split into equal tiles of at most 64 columns, and the
    j extent into tiles of 3 row groups of R rows (4 in f32 and bf16, 2 in f64),
    one thread a column each. A block marches over `planes` planes of i:
    as many as leave the launch at least _MARCH_BLOCKS blocks (long runs
    sum fewer halo planes, more blocks hide more latency)."""
    if len(grid_shape) != 3 or dtype not in _MARCH_ROWS:
        return None
    n0, n1, n2 = (int(m) for m in grid_shape)
    if min(n0, n1, n2) < 1 or n1 * n2 * dtype.itemsize > _INT32_MAX:
        return None
    rows = _MARCH_ROWS[dtype]
    tk = -(-n2 // -(-n2 // _MARCH_TILE_K))
    groups = min(_MARCH_GROUPS, -(-n1 // rows))
    tiles_j = -(-n1 // (groups * rows))
    planes = max(1, n0 // -(-_MARCH_BLOCKS[dtype] // (-(-n2 // tk) * tiles_j)))
    if tiles_j > _GRID_YZ_MAX or -(-n0 // planes) > _GRID_YZ_MAX:
        return None
    return tk, groups, planes


_HOST_WEIGHTS: dict = {}


def _host_weights(weights):
    """`weights` as a host array for the marching kernel's by-value
    argument. Reading a CUDA tensor waits for the card, so the values are
    read once per tensor (and again after an in-place change), not once a
    launch. bf16 weights go as floats (exact): the kernel sums in f32."""
    key = id(weights)
    hit = _HOST_WEIGHTS.get(key)
    if hit is not None and hit[0]() is weights and hit[1] == weights._version:
        return hit[2]
    ctype = ctypes.c_double if weights.dtype == torch.float64 else ctypes.c_float
    values = (ctype * weights.numel())(*weights.double().tolist())
    _HOST_WEIGHTS[key] = (weakref.ref(weights, lambda _: _HOST_WEIGHTS.pop(key, None)),
                          weights._version, values)
    return values


def const_stencil_plain(weights, free, offsets, grid_shape, x):
    """Plain PyTorch version: any offsets, any device. bf16 inputs are
    widened to f32, summed there and y rounded to bf16 once."""
    counts.plain += 1
    wide = _SUM_DTYPE.get(x.dtype)
    if wide is not None:
        y = _plain_sum(weights.to(wide), free.to(wide), offsets, grid_shape, x.to(wide))
        return y.to(x.dtype)
    return _plain_sum(weights, free, offsets, grid_shape, x)


def _plain_sum(weights, free, offsets, grid_shape, x):
    xg = x.reshape(grid_shape)
    xm = free * xg
    d = xg.ndim
    lo = [max(-min(o[k] for o in offsets), 0) for k in range(d)]
    hi = [max(max(o[k] for o in offsets), 0) for k in range(d)]
    pads = [p for k in reversed(range(d)) for p in (lo[k], hi[k])]
    xp = F.pad(xm, pads)
    y = torch.zeros_like(xg)
    for s, off in enumerate(offsets):
        sl = tuple(
            slice(lo[k] + off[k], lo[k] + off[k] + xg.shape[k]) for k in range(d)
        )
        y = y + weights[s] * xp[sl]
    y = free * y + (1.0 - free) * xg
    return y.reshape(-1)


def const_stencil_cuda(weights, free, offsets, grid_shape, x, general=False, tiles=None):
    """Launch the marching kernel where `march_tiles` applies and the
    general kernel otherwise, or always with `general` (to measure the two
    on one operator); `tiles` overrides `march_tiles` (for a sweep). Raises
    on anything the kernels do not take."""
    d = len(grid_shape)
    if d not in (2, 3):
        raise ValueError(f"const_stencil kernel takes 2D or 3D grids, got {d}D")
    if tuple(map(tuple, offsets)) != tuple(itertools.product((-1, 0, 1), repeat=d)):
        raise ValueError(
            "const_stencil kernel takes the 3^d offsets in sorted order only"
        )
    if x.dtype not in _SUFFIX or weights.dtype != x.dtype or free.dtype != x.dtype:
        raise TypeError(
            f"const_stencil kernel dtypes: x {x.dtype}, weights "
            f"{weights.dtype}, free {free.dtype} (all f32, all f64 or all bf16)"
        )
    if x.device.type != "cuda":
        raise ValueError(f"const_stencil kernel needs CUDA tensors, got {x.device}")
    check_same_device(x, weights, free)
    n = math.prod(grid_shape)
    if x.numel() != n or free.numel() != n or weights.numel() != 3 ** d:
        raise ValueError("const_stencil kernel: shape mismatch")
    for t in (x, free, weights):
        if not t.is_contiguous():
            raise ValueError("const_stencil kernel needs contiguous tensors")
    if general:
        tiles = None
    elif tiles is None:
        tiles = march_tiles(tuple(grid_shape), x.dtype)
    elif d != 3:
        raise ValueError("const_stencil marching kernel takes 3D grids only")
    gs = list(grid_shape) + [1] * (3 - d)
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    if tiles is not None:
        name = f"const_march_{_SUFFIX[x.dtype]}"
        fn = build.function("const_stencil", name, _MARCH_ARGTYPES)
        w = _host_weights(weights)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            status = fn(x.data_ptr(), free.data_ptr(), y.data_ptr(), ctypes.addressof(w),
                        gs[0], gs[1], gs[2], *tiles, stream)
    else:
        name = f"const_stencil_{_SUFFIX[x.dtype]}"
        fn = build.function("const_stencil", name, _ARGTYPES)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            status = fn(
                x.data_ptr(), free.data_ptr(), weights.data_ptr(), y.data_ptr(),
                d, gs[0], gs[1], gs[2], stream,
            )
    build.check_status(name, status)
    counts.kernel += 1
    counts.shapes[tuple(map(int, grid_shape))] += 1
    counts.march += tiles is not None
    counts.bf16 += x.dtype == torch.bfloat16
    return y


def const_stencil_apply(weights, free, offsets, grid_shape, x):
    """ConstStencilMatrix.matvec engine: the kernel on CUDA, the plain
    version on the CPU, an error anywhere else."""
    if x.device.type == "cuda":
        return const_stencil_cuda(weights, free, offsets, grid_shape, x)
    if x.device.type == "cpu":
        check_same_device(x, weights, free)
        return const_stencil_plain(weights, free, offsets, grid_shape, x)
    raise ValueError(f"no const_stencil engine for device {x.device}")
