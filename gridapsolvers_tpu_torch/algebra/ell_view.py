"""ELL views of composite operators.

Port of `gridapsolvers_tpu/algebra/ell_view.py`. Matrix-extracted patch
solvers (Vanka, `PatchSolver`) read a composite operator through one
global padded-ELL table of the flattened system, split the usual way:

  - `ell_pattern(A)` (once, at set-up): the SPARSITY of the flattened
    system, the global padded column table, field offsets and per-leaf
    widths. It depends only on the operator's structure, which is static
    across Newton steps.
  - `ell_values(A, meta, leaf_masks)` (each refresh): the global values
    from the current operator's tensors, by concatenation and padding
    only, on the operator's device.

Supported leaves: `ELLMatrix` and non-periodic `StencilMatrix` (through a
static-validity banded view); the traversal and `rebuild_with_leaves`
also walk `parallel.dist_ell_nd.DistGraphELL` leaves, as the JAX
package's do. Supported composites: `BlockOperator` (nested),
`FieldwiseOperator`, `ColumnStack`, `RowStack`, None blocks. The tables
are built on the leaves' device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from .block import BlockOperator, ColumnStack, FieldwiseOperator, RowStack
from .ell import ELLMatrix
from .stencil import StencilMatrix

# ---------------------------------------------------------------------------
# field-leaf traversal (deterministic order shared by pattern & values)
# ---------------------------------------------------------------------------


def _is_leaf(op) -> bool:
    from ..parallel.dist_ell_nd import DistGraphELL

    return isinstance(op, (ELLMatrix, StencilMatrix, DistGraphELL))


def _row_fields(op) -> int:
    if op is None:
        return 0
    if _is_leaf(op):
        return 1
    if isinstance(op, (FieldwiseOperator, ColumnStack)):
        return len(op.ops)
    if isinstance(op, RowStack):
        return 1
    if isinstance(op, BlockOperator):
        return sum(_block_row_fields(op))
    raise TypeError(f"ell_view: unsupported operator {type(op)}")


def _col_fields(op) -> int:
    if op is None:
        return 0
    if _is_leaf(op):
        return 1
    if isinstance(op, (FieldwiseOperator, RowStack)):
        return len(op.ops)
    if isinstance(op, ColumnStack):
        return 1
    if isinstance(op, BlockOperator):
        return sum(_block_col_fields(op))
    raise TypeError(f"ell_view: unsupported operator {type(op)}")


def _block_row_fields(op: BlockOperator) -> List[int]:
    n = len(op.blocks)
    out = []
    for i in range(n):
        c = max((_row_fields(b) for b in op.blocks[i] if b is not None), default=0)
        if c == 0:
            # empty diagonal row (e.g. Stokes pressure): look at the column
            c = max((_col_fields(op.blocks[j][i]) for j in range(n)
                     if op.blocks[j][i] is not None), default=1)
        out.append(c)
    return out


def _block_col_fields(op: BlockOperator) -> List[int]:
    n = len(op.blocks)
    out = []
    for j in range(n):
        c = max((_col_fields(op.blocks[i][j]) for i in range(n)
                 if op.blocks[i][j] is not None), default=0)
        if c == 0:
            c = max((_row_fields(op.blocks[j][i]) for i in range(n)
                     if op.blocks[j][i] is not None), default=1)
        out.append(c)
    return out


def iter_field_leaves(op, fi: int = 0, fj: int = 0):
    """Yield (field_row, field_col, leaf) in deterministic order."""
    if op is None:
        return
    if _is_leaf(op):
        yield (fi, fj, op)
        return
    if isinstance(op, FieldwiseOperator):
        for k, o in enumerate(op.ops):
            yield from iter_field_leaves(o, fi + k, fj + k)
        return
    if isinstance(op, ColumnStack):
        for k, o in enumerate(op.ops):
            yield from iter_field_leaves(o, fi + k, fj)
        return
    if isinstance(op, RowStack):
        for k, o in enumerate(op.ops):
            yield from iter_field_leaves(o, fi, fj + k)
        return
    if isinstance(op, BlockOperator):
        rf = np.cumsum([0] + _block_row_fields(op))
        cf = np.cumsum([0] + _block_col_fields(op))
        for i, row in enumerate(op.blocks):
            for j, b in enumerate(row):
                yield from iter_field_leaves(b, fi + int(rf[i]), fj + int(cf[j]))
        return
    raise TypeError(f"ell_view: unsupported operator {type(op)}")


def field_sizes(A) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(row sizes, column sizes) of the flattened system's fields."""
    leaves = list(iter_field_leaves(A))
    nf_r = max(fi for fi, _, _ in leaves) + 1
    nf_c = max(fj for _, fj, _ in leaves) + 1
    row_sizes, col_sizes = [0] * nf_r, [0] * nf_c
    for fi, fj, leaf in leaves:
        row_sizes[fi] = int(leaf.shape[0])
        col_sizes[fj] = int(leaf.shape[1])
    if not all(s > 0 for s in row_sizes + col_sizes):
        raise ValueError(f"ell_view: a field row or column holds no operator "
                         f"(rows {row_sizes}, columns {col_sizes})")
    return tuple(row_sizes), tuple(col_sizes)


# ---------------------------------------------------------------------------
# stencil banded view (static validity)
# ---------------------------------------------------------------------------


def stencil_cols_valid(A: StencilMatrix) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static (cols, valid) tables of a StencilMatrix's banded sparsity, on
    its device: cols[i, s] = flat index of grid point i + offsets[s], and
    the row itself where that neighbour falls outside the grid (marked
    invalid; such slots carry value 0 and must not point anywhere else,
    which keeps every column offset within the stencil's bandwidth)."""
    if A.periodic is not None and any(A.periodic):
        raise ValueError("ell_view: periodic stencils are not supported")
    gs = A.grid_shape
    dev = A.device
    idx = torch.arange(A.n, device=dev)
    strides = np.cumprod([1] + list(gs[::-1]))[:-1][::-1]
    coords = [(idx // int(strides[d])) % gs[d] for d in range(len(gs))]
    cols = torch.empty((A.n, len(A.offsets)), dtype=torch.int32, device=dev)
    valid = torch.empty((A.n, len(A.offsets)), dtype=torch.bool, device=dev)
    for s, off in enumerate(A.offsets):
        ok = torch.ones(A.n, dtype=torch.bool, device=dev)
        nb = torch.zeros(A.n, dtype=torch.int64, device=dev)
        for d in range(len(gs)):
            c = coords[d] + off[d]
            ok &= (c >= 0) & (c < gs[d])
            nb += c.clamp(0, gs[d] - 1) * int(strides[d])
        cols[:, s] = torch.where(ok, nb, idx)
        valid[:, s] = ok
    return cols, valid


def stencil_values(A: StencilMatrix, valid: torch.Tensor) -> torch.Tensor:
    """(n, n_offsets) banded values aligned with stencil_cols_valid."""
    vals = A.bands.reshape(A.bands.shape[0], -1).T
    return torch.where(valid, vals, 0.0)


# ---------------------------------------------------------------------------
# global pattern + values
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ELLPatternMeta:
    """Static structure of the flattened system."""

    n_rows: int
    n_cols: int
    width: int
    row_sizes: Tuple[int, ...]
    rows: Tuple[Tuple[int, ...], ...]   # leaf ids per field row (concat order)
    leaf_widths: Tuple[int, ...]
    leaf_kinds: Tuple[str, ...]          # 'ell' | 'stencil'


def ell_pattern(A):
    """Once, at set-up: returns (meta, cols, leaf_masks).

    cols       : (n_rows, width) int32 global padded column table, on the
                 leaves' device
    leaf_masks : tuple aligned with leaf order; the validity mask for
                 stencil leaves, None for ELL leaves
    """
    leaves = list(iter_field_leaves(A))
    row_sizes, col_sizes = field_sizes(A)
    nf_r = len(row_sizes)
    row_offs = np.cumsum([0] + list(row_sizes))
    col_offs = np.cumsum([0] + list(col_sizes))
    n_rows, n_cols = int(row_offs[-1]), int(col_offs[-1])

    leaf_kinds, leaf_widths, leaf_masks, leaf_cols = [], [], [], []
    for _, fj, leaf in leaves:
        if isinstance(leaf, ELLMatrix):
            leaf_kinds.append("ell")
            c = leaf.cols
            leaf_masks.append(None)
        else:
            leaf_kinds.append("stencil")
            c, valid = stencil_cols_valid(leaf)
            leaf_masks.append(valid)
        leaf_widths.append(int(c.shape[1]))
        leaf_cols.append(c.to(torch.int64) + int(col_offs[fj]))

    rows: List[Tuple[int, ...]] = [tuple() for _ in range(nf_r)]
    for lid, (fi, _, _) in enumerate(leaves):
        rows[fi] = rows[fi] + (lid,)
    widths = [sum(leaf_widths[lid] for lid in rows[fi]) for fi in range(nf_r)]
    K = max(widths)

    dev = leaf_cols[0].device
    parts_all = []
    for fi in range(nf_r):
        lo, hi = int(row_offs[fi]), int(row_offs[fi + 1])
        parts = [leaf_cols[lid] for lid in rows[fi]]
        if widths[fi] < K:
            # self-pointing padding (zero values added by ell_values)
            pad = (torch.arange(lo, hi, device=dev) % n_cols)[:, None]
            parts.append(pad.expand(hi - lo, K - widths[fi]))
        parts_all.append(torch.cat(parts, dim=1).to(torch.int32))
    cols = parts_all[0] if len(parts_all) == 1 else torch.cat(parts_all, dim=0)

    meta = ELLPatternMeta(
        n_rows=n_rows,
        n_cols=n_cols,
        width=K,
        row_sizes=tuple(row_sizes),
        rows=tuple(rows),
        leaf_widths=tuple(leaf_widths),
        leaf_kinds=tuple(leaf_kinds),
    )
    return meta, cols.contiguous(), tuple(leaf_masks)


def ell_values(A, meta: ELLPatternMeta, leaf_masks) -> torch.Tensor:
    """Global ELL values of the current operator A (same structure as at
    ell_pattern time)."""
    leaves = list(iter_field_leaves(A))
    vals = []
    for lid, (_, _, leaf) in enumerate(leaves):
        if meta.leaf_kinds[lid] == "ell":
            vals.append(leaf.values)
        else:
            vals.append(stencil_values(leaf, leaf_masks[lid]))
    out_rows = []
    for fi in range(len(meta.rows)):
        parts = [vals[lid] for lid in meta.rows[fi]]
        block = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        if block.shape[1] < meta.width:
            block = torch.nn.functional.pad(block, (0, meta.width - block.shape[1]))
        out_rows.append(block)
    out = out_rows[0] if len(out_rows) == 1 else torch.cat(out_rows, dim=0)
    return out.contiguous()


def rebuild_with_leaves(op, leaves_iter):
    """Reconstruct a composite operator with its leaves replaced, walking
    the same order as iter_field_leaves. leaves_iter yields replacements."""
    if op is None:
        return None
    if _is_leaf(op):
        return next(leaves_iter)
    for cls in (FieldwiseOperator, ColumnStack, RowStack):
        if isinstance(op, cls):
            return cls(tuple(rebuild_with_leaves(o, leaves_iter) for o in op.ops))
    if isinstance(op, BlockOperator):
        return BlockOperator(tuple(
            tuple(rebuild_with_leaves(b, leaves_iter) for b in row) for row in op.blocks))
    raise TypeError(f"ell_view: unsupported operator {type(op)}")


def ell_view(A) -> Tuple[ELLMatrix, ELLPatternMeta, tuple]:
    """One-call set-up helper: (flattened ELL, meta, leaf_masks)."""
    meta, cols, masks = ell_pattern(A)
    return ELLMatrix(ell_values(A, meta, masks), cols, meta.n_cols), meta, masks
