"""ELL (padded fixed-width) sparse matrices: general sparsity.

Port of `gridapsolvers_tpu/algebra/ell.py`. Every row is padded to a
fixed width K:

    values  : (n_rows, K) tensor, zero-padded
    cols    : (n_rows, K) int32, padding points at min(row, ncols - 1)
    row_len : optional (n_rows,) int32, the real entries of each row, which
              fill its slots 0..row_len-1 (None: every slot counts)

and SpMV is `(values * x[cols]).sum(1)` over the first row_len slots of
each row. `row_len` is pattern data like `cols`: the host conversions set
it from the pattern's row counts, never from the values, so a values-only
refresh that fills a slot holding 0 today keeps it. Slots at or past a
row's length hold value 0, as every host conversion lays them out: only
`matvec` skips them, every other method reads all K slots. `ELLMatrix.matvec`
runs kernel K3 (`ops/ell_spmv.py`) on CUDA tensors and its plain PyTorch
version on CPU tensors; any column pattern, square or rectangular, takes
the kernel.
The host conversions (`ell_from_coo`, `ell_from_scipy`, `ell_to_scipy`)
build the same arrays as the JAX package's, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.ell_spmv import ell_spmv_apply, group_size
from ..utils import resolve_device


@dataclasses.dataclass
class ELLMatrix:
    """Square-or-rectangular sparse matrix in padded ELL format. With
    `row_len`, every slot at or past a row's length must hold value 0."""

    values: torch.Tensor  # (n_rows, K)
    cols: torch.Tensor    # (n_rows, K) int32
    ncols: int
    row_len: Optional[torch.Tensor] = None  # (n_rows,) int32, on the same device
    # K3's lanes a row, set by the host conversions from the pattern's row
    # counts (None: the kernel's choice from K); any value gives the same y
    group: Optional[int] = None

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.values.shape[0], self.ncols)

    @property
    def nrows(self) -> int:
        return self.values.shape[0]

    @property
    def row_width(self) -> int:
        return self.values.shape[1]

    @property
    def nnz(self) -> int:
        """Stored slots, padding included."""
        return self.values.shape[0] * self.values.shape[1]

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self):
        return self.values.device

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x. x: (ncols,) -> y: (nrows,)."""
        return ell_spmv_apply(self.values, self.cols, self.ncols, x, self.row_len, self.group)

    def matvec_t(self, y: torch.Tensor) -> torch.Tensor:
        """x = A.T @ y by scatter-add."""
        contrib = (self.values.to(y.dtype) * y[:, None]).reshape(-1)
        out = torch.zeros(self.ncols, dtype=y.dtype, device=y.device)
        return out.index_add_(0, self.cols.reshape(-1).long(), contrib)

    def diag(self) -> torch.Tensor:
        """Diagonal (square A)."""
        rows = torch.arange(self.nrows, device=self.device)[:, None]
        return torch.where(self.cols == rows, self.values, 0.0).sum(dim=1)

    def abs_row_sum(self) -> torch.Tensor:
        """sum_j |a_ij| per row (Gershgorin bounds)."""
        return torch.abs(self.values).sum(dim=1)

    def scale_rows(self, d: torch.Tensor) -> "ELLMatrix":
        return dataclasses.replace(self, values=self.values * d[:, None])

    def astype(self, dtype) -> "ELLMatrix":
        return dataclasses.replace(self, values=self.values.to(dtype))

    def todense(self) -> torch.Tensor:
        """Dense (nrows, ncols) matrix (coarse solves, checks); duplicate
        columns in a row are summed."""
        n, K = self.values.shape
        dense = torch.zeros((n, self.ncols), dtype=self.dtype, device=self.device)
        rows = torch.arange(n, device=self.device).repeat_interleave(K)
        return dense.index_put_(
            (rows, self.cols.reshape(-1).long()), self.values.reshape(-1), accumulate=True
        )


def _ell(vals: np.ndarray, cols: np.ndarray, n_cols: int, counts: np.ndarray, dtype,
         device) -> ELLMatrix:
    dev = resolve_device(device)
    v = torch.from_numpy(vals)
    return ELLMatrix(v.to(device=dev, dtype=dtype or v.dtype), torch.from_numpy(cols).to(dev),
                     int(n_cols), torch.from_numpy(counts.astype(np.int32)).to(dev),
                     group_size(cols.shape[1], counts.mean() if len(counts) else 0.0))


def _padding_cols(n_rows: int, n_cols: int, K: int) -> np.ndarray:
    """Column of every padding slot: min(row, ncols - 1)."""
    return np.tile(np.minimum(np.arange(n_rows), n_cols - 1)[:, None], (1, K)).astype(np.int32)


def ell_from_coo(
    n_rows: int,
    n_cols: int,
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    row_width: Optional[int] = None,
    dtype=None,
    device=None,
) -> ELLMatrix:
    """Host COO -> ELL (duplicates summed); `dtype` is a torch dtype
    (default: the values' own)."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    # sum duplicates via lexicographic sort + segment reduce
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    key = rows.astype(np.int64) * n_cols + cols.astype(np.int64)
    uniq, inv = np.unique(key, return_inverse=True)
    summed = np.zeros(len(uniq), dtype=vals.dtype)
    np.add.at(summed, inv, vals)
    urows = (uniq // n_cols).astype(np.int64)
    ucols = (uniq % n_cols).astype(np.int64)

    counts = np.bincount(urows, minlength=n_rows)
    K = int(counts.max()) if row_width is None else int(row_width)
    if counts.max() > K:
        raise ValueError(f"row degree {counts.max()} exceeds row_width {K}")

    ell_vals = np.zeros((n_rows, K), dtype=vals.dtype)
    ell_cols = _padding_cols(n_rows, n_cols, K)
    # position of each entry within its row
    starts = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(len(urows)) - starts[urows]
    ell_vals[urows, slot] = summed
    ell_cols[urows, slot] = ucols.astype(np.int32)
    return _ell(ell_vals, ell_cols, n_cols, counts, dtype, device)


def ell_from_scipy(S, row_width: Optional[int] = None, dtype=None, device=None) -> ELLMatrix:
    """scipy.sparse -> padded ELL (host set-up path); `dtype` is a torch
    dtype (default: the matrix's own)."""
    S = S.tocsr()
    S.sum_duplicates()
    n_rows, n_cols = S.shape
    counts = np.diff(S.indptr)
    K = int(counts.max()) if row_width is None else int(row_width)
    if counts.max() > K:
        raise ValueError(f"row degree {counts.max()} exceeds row_width {K}")
    vals = np.zeros((n_rows, K), dtype=S.dtype)
    cols = _padding_cols(n_rows, n_cols, K)
    r = np.repeat(np.arange(n_rows), counts)
    slot = np.arange(S.nnz) - np.repeat(S.indptr[:-1], counts)
    vals[r, slot] = S.data
    cols[r, slot] = S.indices.astype(np.int32)
    return _ell(vals, cols, n_cols, counts, dtype, device)


def ell_to_scipy(A: ELLMatrix):
    """ELLMatrix -> scipy CSR (host; padding slots add explicit zeros)."""
    import scipy.sparse as sp

    n, K = A.values.shape
    vals = A.values.detach().cpu().numpy().reshape(-1)
    cols = A.cols.cpu().numpy().reshape(-1)
    rows = np.repeat(np.arange(n), K)
    return sp.coo_matrix((vals, (rows, cols)), shape=A.shape).tocsr()


# `kernelize=` / `kernelize_levels=` values of the JAX package, which
# chooses there between its Pallas kernel and its plain ELL path. Here an
# ELL leaf on a CUDA tensor always runs the kernel and a refresh always goes
# through kernelize_system, so the value is checked and otherwise ignored.
KERNELIZE_VALUES = ("auto", "pallas", "off", "ell")


def check_kernelize(value: str) -> None:
    """Raise on a `kernelize=` / `kernelize_levels=` value the JAX package
    does not accept."""
    if value not in KERNELIZE_VALUES:
        raise ValueError(f"kernelize: unknown value {value!r}, want one of "
                         f"{list(KERNELIZE_VALUES)}")


def kernelize_system(A, old=None):
    """Values-only refresh of a composite operator's ELL leaves.

    Port of `kernelize_system` (`gridapsolvers_tpu/ops/ell_pallas.py:597`).
    Walks a (possibly nested) BlockOperator / ColumnStack / RowStack /
    FieldwiseOperator over ELLMatrix leaves. Here an `ELLMatrix` on a CUDA
    tensor already is the kernel leaf, so `old=None` (set-up) returns A as
    it is. With `old`, a previous result of the same structure, every ELL
    leaf of A comes back as `old`'s leaf with A's `values`: the same `cols`,
    `row_len` and `group` tensors, nothing rebuilt, so a refresh cannot lose
    the pattern's row lengths (a leaf whose values did not change comes back
    as `old`'s own). A new leaf that carries other `cols` tensors than
    `old`'s must hold the same columns. Any other leaf (a StencilMatrix, a kernel
    operator) is A's own, as in the JAX package. A structure mismatch
    (another class, another number of blocks, another values shape, dtype,
    column count or columns) raises: there is no fallback."""
    from .block import BlockOperator, ColumnStack, FieldwiseOperator, RowStack

    if old is None:
        return A

    def mismatch(m, o, why):
        return ValueError(f"kernelize_system: {type(m).__name__} against "
                          f"{type(o).__name__}: {why}")

    def conv(m, o):
        if m is None or o is None:
            if m is not o:
                raise mismatch(m, o, "a block is None on one side only")
            return None
        if isinstance(m, ELLMatrix):
            if not isinstance(o, ELLMatrix):
                raise mismatch(m, o, "not an ELL leaf")
            if (m.values.shape, m.values.dtype, m.ncols) != (o.values.shape, o.values.dtype,
                                                             o.ncols):
                raise mismatch(m, o, f"values {tuple(m.values.shape)} {m.values.dtype} "
                                     f"x {m.ncols} against {tuple(o.values.shape)} "
                                     f"{o.values.dtype} x {o.ncols}")
            if m.cols is not o.cols and not torch.equal(m.cols, o.cols):
                raise mismatch(m, o, "other columns")
            return o if m.values is o.values else dataclasses.replace(o, values=m.values)
        for cls in (FieldwiseOperator, ColumnStack, RowStack):
            if isinstance(m, cls):
                if type(o) is not cls or len(o.ops) != len(m.ops):
                    raise mismatch(m, o, "another stack")
                return cls(tuple(conv(mm, oo) for mm, oo in zip(m.ops, o.ops)))
        if isinstance(m, BlockOperator):
            if not isinstance(o, BlockOperator) or [len(r) for r in m.blocks] != [
                    len(r) for r in o.blocks]:
                raise mismatch(m, o, "another block layout")
            return BlockOperator(tuple(
                tuple(conv(mm, oo) for mm, oo in zip(mrow, orow))
                for mrow, orow in zip(m.blocks, o.blocks)))
        if type(m) is not type(o):
            raise mismatch(m, o, "another leaf class")
        return m

    return conv(A, old)
