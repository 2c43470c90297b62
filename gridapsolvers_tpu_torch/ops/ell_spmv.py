"""Kernel K3: padded-ELL SpMV, square or rectangular.

Port of the TPU kernel `gridapsolvers_tpu/ops/ell_pallas.py` (`_kernel`,
`_ell_apply`). The CUDA source is `csrc/ell_spmv.cu` (its note says what
bounds it and what its design does about that). `ell_spmv_apply` is the
engine of `ELLMatrix.matvec`:

    y[i] = sum_{k < row_len[i]} values[i, k] * x[cols[i, k]]      i < nrows

for any int32 column pattern within [0, ncols); without `row_len` every
one of the K slots of a row counts. On a CUDA tensor it
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
# (values, cols, row_len, x, y, nrows, K, ncols, group, stream)
_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p)


def ell_spmv_plain(values, cols, x, row_len=None):
    """Plain PyTorch version: any dtypes and device. Slots at or past a
    row's `row_len` add nothing."""
    counts.plain += 1
    terms = values.to(x.dtype) * x[cols.long()]
    if row_len is not None:
        slot = torch.arange(values.shape[1], device=values.device)
        terms = torch.where(slot < row_len[:, None], terms, 0)
    return terms.sum(dim=1)


def group_size(K: int, mean_len: float | None = None) -> int:
    """Lanes per row, a power of two within 1..32. Rows read to their
    lengths (`mean_len`, the mean real row length): the one nearest
    mean_len/2, so each lane loads about two entries and most rows take one
    batch of the kernel's four loads a lane. Rows read in full (no
    `mean_len`): the one nearest K/7, about seven slots a lane. Sweeps over
    1..32 on the AMG path's operators picked both (PERF.md)."""
    per_lane = 7 if mean_len is None else 2
    slots = K if mean_len is None else mean_len
    if slots <= per_lane:
        return 1
    return min(32, 2 ** round(math.log2(slots / per_lane)))


def ell_spmv_cuda(values, cols, x, ncols=None, group=None, row_len=None):
    """Launch the CUDA kernel with `group` lanes per row (default
    `group_size(K)`; `ELLMatrix.matvec` passes the matrix's own); raises on
    anything it does not take, before any build or launch. `row_len`
    (int32, one a row) bounds the slots read in each row."""
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
    if row_len is not None and (row_len.dtype != torch.int32 or row_len.shape != (nrows,)
                                or not row_len.is_contiguous()):
        raise ValueError(f"ell_spmv kernel: row_len must be contiguous int32 of shape "
                         f"({nrows},), got {row_len.dtype} {tuple(row_len.shape)}")
    group = group_size(K) if group is None else int(group)
    if group not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"ell_spmv kernel: group {group} is not a power of two <= 32")
    if x.device.type != "cuda":
        raise ValueError(f"ell_spmv kernel needs CUDA tensors, got {x.device}")
    check_same_device(x, values, cols, row_len)
    y = torch.empty(nrows, dtype=x.dtype, device=x.device)
    name = _ENTRY[key]
    fn = build.function("ell_spmv", name, _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(
            values.data_ptr(), cols.data_ptr(),
            None if row_len is None else row_len.data_ptr(), x.data_ptr(), y.data_ptr(),
            nrows, K, ncols, group, stream,
        )
    build.check_status(name, status)
    counts.kernel += 1
    counts.shapes[(nrows, ncols)] += 1
    return y


def ell_spmv_apply(values, cols, ncols, x, row_len=None, group=None):
    """ELLMatrix.matvec engine: the kernel on CUDA, the plain version on
    the CPU, an error anywhere else."""
    if x.device.type == "cuda":
        return ell_spmv_cuda(values, cols, x, ncols, group, row_len)
    if x.device.type == "cpu":
        check_same_device(x, values, cols, row_len)
        if x.shape != (ncols,):
            raise ValueError(f"ell_spmv: x {tuple(x.shape)} for {ncols} columns")
        return ell_spmv_plain(values, cols, x, row_len)
    raise ValueError(f"no ell_spmv engine for device {x.device}")
