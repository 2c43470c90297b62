"""Kernel K3: padded-ELL SpMV, square or rectangular.

Port of the TPU kernel `gridapsolvers_tpu/ops/ell_pallas.py` (`_kernel`,
`_ell_apply`). The CUDA source is `csrc/ell_spmv.cu` (its note says what
bounds it and what its design does about that). `ell_spmv_apply` is the
engine of `ELLMatrix.matvec`:

    y[i] = sum_k values[i, k] * x[cols[i, k]]      i < nrows

for any int32 column pattern within [0, ncols). On a CUDA tensor it
launches the kernel or raises; on a CPU tensor it runs `ell_spmv_plain`,
the plain PyTorch version (`ELLMatrix.matvec` of the JAX package,
`algebra/ell.py:59-61`). Both sum in x's dtype; bf16 values are widened
to f32 first.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..utils import check_same_device
from . import build

counts = build.LaunchCounts()

_ENTRY = {
    (torch.float32, torch.float32): "ell_spmv_f32_f32",
    (torch.bfloat16, torch.float32): "ell_spmv_bf16_f32",
    (torch.float64, torch.float64): "ell_spmv_f64_f64",
}
# (values, cols, x, y, nrows, K, ncols, group, stream)
_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p)


def ell_spmv_plain(values, cols, x):
    """Plain PyTorch version: any dtypes and device."""
    counts.plain += 1
    return (values.to(x.dtype) * x[cols.long()]).sum(dim=1)


def group_size(K: int) -> int:
    """Lanes per row: the power of two nearest K/6, within 1..32, so each
    lane loads about six slots of its row (several loads in flight a
    thread, few idle lanes on short rows). A sweep over 1..32 on the AMG
    path's operators picked this (PERF.md, PR 2)."""
    if K <= 6:
        return 1
    return min(32, 2 ** round(math.log2(K / 6)))


def ell_spmv_cuda(values, cols, x, ncols=None, group=None):
    """Launch the CUDA kernel with `group` lanes per row (default
    `group_size(K)`); raises on anything it does not take, before any
    build or launch."""
    key = (values.dtype, x.dtype)
    if key not in _ENTRY:
        raise TypeError(f"ell_spmv kernel takes (values, x) dtypes {list(_ENTRY)}, got {key}")
    if cols.dtype != torch.int32:
        raise TypeError(f"ell_spmv kernel takes int32 columns, got {cols.dtype}")
    ncols = x.numel() if ncols is None else int(ncols)
    if values.ndim != 2 or cols.shape != values.shape or x.shape != (ncols,):
        raise ValueError(
            f"ell_spmv kernel: values {tuple(values.shape)}, cols {tuple(cols.shape)}, "
            f"x {tuple(x.shape)} for {ncols} columns"
        )
    if not (values.is_contiguous() and cols.is_contiguous() and x.is_contiguous()):
        raise ValueError("ell_spmv kernel needs contiguous tensors")
    nrows, K = values.shape
    group = group_size(K) if group is None else int(group)
    if group not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"ell_spmv kernel: group {group} is not a power of two <= 32")
    if x.device.type != "cuda":
        raise ValueError(f"ell_spmv kernel needs CUDA tensors, got {x.device}")
    check_same_device(x, values, cols)
    y = torch.empty(nrows, dtype=x.dtype, device=x.device)
    name = _ENTRY[key]
    fn = build.function("ell_spmv", name, _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(
            values.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(),
            nrows, K, ncols, group, stream,
        )
    build.check_status(name, status)
    counts.kernel += 1
    return y


def ell_spmv_apply(values, cols, ncols, x):
    """ELLMatrix.matvec engine: the kernel on CUDA, the plain version on
    the CPU, an error anywhere else."""
    if x.device.type == "cuda":
        return ell_spmv_cuda(values, cols, x, ncols)
    if x.device.type == "cpu":
        check_same_device(x, values, cols)
        if x.shape != (ncols,):
            raise ValueError(f"ell_spmv: x {tuple(x.shape)} for {ncols} columns")
        return ell_spmv_plain(values, cols, x)
    raise ValueError(f"no ell_spmv engine for device {x.device}")
