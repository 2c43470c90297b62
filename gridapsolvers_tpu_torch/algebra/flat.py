"""Blocked-kernel view of composite block operators.

Port of `gridapsolvers_tpu/algebra/flat.py`. `flat_kernel_operator(A)`
rebuilds a square composite (a `BlockOperator` / `FieldwiseOperator` of
ELL and stencil leaves) as a field-blocked operator whose every nonzero
field block, square or cross, is an `ELLMatrix`: one K3 launch per block
on the card, its plain version on the CPU. A field block couples one grid
to itself, so its column offsets stay within the stencil's bandwidth.

The blocks are cut on the operator's device from the flattened system's
COO entries (`ell_blocks_from_coo`): duplicates summed, explicit zeros
dropped unless the blocks must keep every stored slot for a values-only
refresh, rows packed in column order. The arrays are those that the JAX
package's host path (`to_scipy`, CSR block slices, `ell_from_scipy`)
builds from the same operator.

The JAX engine resolver (`_default_engine`, `resolve_engine`) and its
"pallas rejected a block" fallback are not ported: the kernel is chosen
inside `ELLMatrix.matvec` by the vector's device. `engine=` and `q=` are
accepted for API parity and ignored.

The original composite stays reachable as `.inner` for machinery that
reads block structure (Vanka patch extraction, coarse densification).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..ops.ell_spmv import group_size
from ..utils import pytrees as pt
from ..utils import resolve_device
from .ell import ELLMatrix


@dataclasses.dataclass
class BlockedKernelOperator:
    """Square composite operator with one ELL kernel per field block.

    Operates on the same tuple vectors as the wrapped composite (leaves in
    order == field order)."""

    kblocks: tuple        # nf x nf tuple-of-tuples of ELLMatrix or None
    inner: object         # the original composite operator
    sizes: tuple

    @property
    def shape(self):
        n = sum(self.sizes)
        return (n, n)

    def _first(self):
        for row in self.kblocks:
            for blk in row:
                if blk is not None:
                    return blk
        raise ValueError("empty BlockedKernelOperator")

    @property
    def dtype(self):
        if self.inner is not None and hasattr(self.inner, "dtype"):
            return self.inner.dtype
        return self._first().dtype

    @property
    def device(self):
        return self._first().device

    def matvec(self, x):
        leaves = pt.tree_leaves(x)
        out = []
        for i, row in enumerate(self.kblocks):
            acc = None
            for j, blk in enumerate(row):
                if blk is None:
                    continue
                c = blk.matvec(leaves[j].reshape(-1))
                acc = c if acc is None else acc + c
            if acc is None:
                acc = torch.zeros_like(leaves[i].reshape(-1))
            out.append(acc.reshape(leaves[i].shape))
        return pt.tree_unflatten(x, out)

    def diag(self):
        return self.inner.diag() if hasattr(self.inner, "diag") else None

    def block(self, i, j):
        return self.inner.block(i, j)

    def todense(self):
        return self.inner.todense()


def ell_blocks_from_coo(
    rows: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    sizes: Sequence[int],
    keep_zeros: bool = False,
    dtype=None,
    plan: bool = False,
):
    """Cut the square system given by COO entries (tensors on one device;
    duplicates summed) into nf x nf `ELLMatrix` blocks of the field `sizes`,
    each packed as `ell_from_scipy` packs its CSR block: entries of a row
    in column order, padding slots of value 0 pointing at min(row, ncols-1),
    `row_len` the row's entries, `group` from their mean. Summed zeros are
    dropped unless `keep_zeros` (the pattern-static refresh contract: every
    stored entry keeps its slot); a block with no entry is None. Values are
    stored in `dtype` (default: vals'). With `plan`, also returns the
    refresh plan: for each COO entry its position among the `n` summed
    entries (`inv`), and per block (i, j, n_b, K_b, sel, flat): the summed entries
    it holds and their flat slots in its (n_b, K_b) values."""
    dev = vals.device
    offs = np.cumsum([0] + [int(s) for s in sizes])
    n = int(offs[-1])
    key = rows.to(torch.int64) * n + cols.to(torch.int64)
    uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
    summed = torch.zeros(uniq.shape[0], dtype=vals.dtype, device=dev).index_add_(0, inv, vals)
    n_summed = int(uniq.shape[0])
    pos = torch.arange(n_summed, device=dev)
    if not keep_zeros:
        nz = summed != 0
        uniq, summed, pos = uniq[nz], summed[nz], pos[nz]
    r, c = uniq // n, uniq % n
    offs_t = torch.as_tensor(offs[1:-1], device=dev)
    bi = torch.bucketize(r, offs_t, right=True)
    bj = torch.bucketize(c, offs_t, right=True)
    nf = len(sizes)
    blocks, plans = [], []
    for i in range(nf):
        row = []
        for j in range(nf):
            sel = torch.nonzero((bi == i) & (bj == j)).reshape(-1)
            if sel.numel() == 0:
                row.append(None)
                continue
            n_i, n_j = int(sizes[i]), int(sizes[j])
            r_l, c_l = r[sel] - int(offs[i]), c[sel] - int(offs[j])
            counts = torch.bincount(r_l, minlength=n_i)
            K = int(counts.max())
            starts = torch.cumsum(counts, 0) - counts
            slot = torch.arange(sel.numel(), device=dev) - starts[r_l]
            values = torch.zeros((n_i, K), dtype=dtype or vals.dtype, device=dev)
            values[r_l, slot] = summed[sel].to(values.dtype)
            ecols = torch.minimum(torch.arange(n_i, device=dev), torch.tensor(n_j - 1, device=dev))
            ecols = ecols.to(torch.int32)[:, None].repeat(1, K)
            ecols[r_l, slot] = c_l.to(torch.int32)
            row.append(ELLMatrix(values, ecols, n_j, counts.to(torch.int32),
                                 group_size(K, float(counts.double().mean()))))
            if plan:
                plans.append((i, j, n_i, K, pos[sel], r_l * K + slot))
        blocks.append(tuple(row))
    if plan:
        return tuple(blocks), {"inv": inv, "n": n_summed, "blocks": tuple(plans)}
    return tuple(blocks)


def _leaf_coo(leaf, row_off: int, col_off: int):
    """(rows, cols, vals) tensors of one ELL or stencil leaf, shifted to its
    field offsets; stencil neighbours outside the grid left out."""
    from .ell_view import stencil_cols_valid, stencil_values

    if isinstance(leaf, ELLMatrix):
        n, K = leaf.values.shape
        rows = torch.arange(n, device=leaf.device).repeat_interleave(K)
        return rows + row_off, leaf.cols.reshape(-1).to(torch.int64) + col_off, \
            leaf.values.reshape(-1)
    cols, valid = stencil_cols_valid(leaf)
    vals = stencil_values(leaf, valid)
    rows = torch.arange(leaf.n, device=leaf.device)[:, None].expand_as(cols)
    return rows[valid] + row_off, cols[valid].to(torch.int64) + col_off, vals[valid]


def blocked_kernel_from_coo(rows, cols, vals, sizes, inner=None, dtype=None,
                            band_dtype=None, refreshable: bool = False, plan: bool = False):
    """`BlockedKernelOperator` of the square COO system (tensors on one
    device) cut into field blocks of `sizes`; `band_dtype` stores the block
    values in a narrower type (bf16: f32 sums on K3). With `plan`, returns
    (operator, refresh plan) as `ell_blocks_from_coo` gives it."""
    out = ell_blocks_from_coo(rows, cols, vals.to(dtype or vals.dtype), sizes,
                              keep_zeros=refreshable, dtype=band_dtype, plan=plan)
    blocks, pl = out if plan else (out, None)
    op = BlockedKernelOperator(kblocks=blocks, inner=inner,
                               sizes=tuple(int(s) for s in sizes))
    return (op, pl) if plan else op


def blocked_kernel_from_scipy(
    S, sizes, inner=None, engine: str = "auto", q: int = 4, dtype=None,
    band_dtype=None, refreshable: bool = False, device=None,
) -> BlockedKernelOperator:
    """Cut a square scipy matrix into field blocks (row/col offsets from
    `sizes`) and wrap every nonzero block in an ELL kernel on `device`
    (None: the card), values in the torch `dtype` (default: S's).
    refreshable=True keeps explicit zeros in the block patterns (the
    pattern-static refresh contract)."""
    coo = S.tocoo()
    dev = resolve_device(device)
    vals = torch.from_numpy(np.ascontiguousarray(coo.data)).to(dev)
    return blocked_kernel_from_coo(
        torch.from_numpy(coo.row.astype(np.int64)).to(dev),
        torch.from_numpy(coo.col.astype(np.int64)).to(dev),
        vals, sizes, inner=inner, dtype=dtype, band_dtype=band_dtype, refreshable=refreshable)


def flat_kernel_operator(
    A, engine: str = "auto", q: int = 4, band_dtype=None,
) -> BlockedKernelOperator:
    """Build a BlockedKernelOperator from a square composite operator, on
    the composite's device: its entries with zeros dropped, as the JAX
    package's `to_scipy` gives them."""
    from .ell_view import field_sizes, iter_field_leaves

    row_sizes, col_sizes = field_sizes(A)
    if row_sizes != col_sizes:
        raise ValueError(f"flat_kernel_operator: square composites only, got field rows "
                         f"{row_sizes} and columns {col_sizes}")
    offs = np.cumsum([0] + list(row_sizes))
    parts = [_leaf_coo(leaf, int(offs[fi]), int(offs[fj]))
             for fi, fj, leaf in iter_field_leaves(A)]
    rows, cols, vals = (torch.cat([p[k] for p in parts]) for k in range(3))
    return blocked_kernel_from_coo(rows, cols, vals, row_sizes, inner=A,
                                   band_dtype=band_dtype)

