"""Kernel K1: constant-coefficient 3^d-point stencil matvec.

Port of the TPU kernel `gridapsolvers_tpu/ops/stencil_pallas.py`. The CUDA
source is `csrc/const_stencil.cu` (its note says what bounds it and what
its design does about that). `const_stencil_apply` is the engine of
`ConstStencilMatrix.matvec`:

    y = free * sum_s w_s * shift(free * x, o_s) + (1 - free) * x

On a CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
`const_stencil_plain`, the plain PyTorch version (pad once, slice per
offset, as `algebra/stencil.py:338-353` of the JAX package does).
"""
from __future__ import annotations

import ctypes
import itertools
import math

import torch
import torch.nn.functional as F

from ..utils import check_same_device
from . import build

counts = build.LaunchCounts()

_ENTRY = {torch.float32: "const_stencil_f32", torch.float64: "const_stencil_f64"}
# (x, free, weights, y, dim, n0, n1, n2, stream)
_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)


def const_stencil_plain(weights, free, offsets, grid_shape, x):
    """Plain PyTorch version: any offsets, any device."""
    counts.plain += 1
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


def const_stencil_cuda(weights, free, offsets, grid_shape, x):
    """Launch the CUDA kernel; raises on anything it does not take."""
    d = len(grid_shape)
    if d not in (2, 3):
        raise ValueError(f"const_stencil kernel takes 2D or 3D grids, got {d}D")
    if tuple(map(tuple, offsets)) != tuple(itertools.product((-1, 0, 1), repeat=d)):
        raise ValueError(
            "const_stencil kernel takes the 3^d offsets in sorted order only"
        )
    if x.device.type != "cuda":
        raise ValueError(f"const_stencil kernel needs CUDA tensors, got {x.device}")
    check_same_device(x, weights, free)
    if x.dtype not in _ENTRY or weights.dtype != x.dtype or free.dtype != x.dtype:
        raise TypeError(
            f"const_stencil kernel dtypes: x {x.dtype}, weights "
            f"{weights.dtype}, free {free.dtype} (all f32 or all f64)"
        )
    n = math.prod(grid_shape)
    if x.numel() != n or free.numel() != n or weights.numel() != 3 ** d:
        raise ValueError("const_stencil kernel: shape mismatch")
    for t in (x, free, weights):
        if not t.is_contiguous():
            raise ValueError("const_stencil kernel needs contiguous tensors")
    gs = list(grid_shape) + [1] * (3 - d)
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    fn = build.function("const_stencil", _ENTRY[x.dtype], _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(
            x.data_ptr(), free.data_ptr(), weights.data_ptr(), y.data_ptr(),
            d, gs[0], gs[1], gs[2], stream,
        )
    build.check_status(_ENTRY[x.dtype], status)
    counts.kernel += 1
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
