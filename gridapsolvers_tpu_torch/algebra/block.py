"""Block operators for multiphysics (saddle-point) systems.

Port of `gridapsolvers_tpu/algebra/block.py`. A block operator is an
N x N grid of per-field operators, and a block vector is a tuple of
per-field tensors, so the Krylov solvers of `linear/` work on it
unchanged (`utils/pytrees.py`). Every apply is the per-field operators'
own `matvec`: a `FieldwiseOperator` of d `StencilMatrix` fields launches
kernel K2 d times, a `ColumnStack` or `RowStack` of d `ELLMatrix` blocks
launches K3 d times.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ..utils import pytrees as pt


@dataclasses.dataclass
class BlockOperator:
    """N x N block matrix; entries are operators with .matvec or None."""

    blocks: Tuple[Tuple[Optional[object], ...], ...]

    @property
    def nblocks(self) -> int:
        return len(self.blocks)

    def matvec(self, x: Sequence) -> Tuple:
        out = []
        for i, row in enumerate(self.blocks):
            acc = None
            for j, blk in enumerate(row):
                if blk is None:
                    continue
                contrib = blk.matvec(x[j])
                acc = contrib if acc is None else pt.add(acc, contrib)
            if acc is None:
                acc = pt.zeros_like(x[i])
            out.append(acc)
        return tuple(out)

    def diag(self) -> Tuple:
        return tuple(row[i].diag() for i, row in enumerate(self.blocks))

    def block(self, i: int, j: int):
        return self.blocks[i][j]

    def _first(self):
        for row in self.blocks:
            for blk in row:
                if blk is not None:
                    return blk
        raise ValueError("empty BlockOperator")

    @property
    def dtype(self):
        return self._first().dtype

    @property
    def device(self):
        return self._first().device

    def todense(self) -> torch.Tensor:
        """Debug-only densification; a None block is zeros."""
        sizes = self._block_sizes()
        rows = []
        for i, row in enumerate(self.blocks):
            cols = []
            for j, blk in enumerate(row):
                if blk is None:
                    cols.append(torch.zeros((sizes[i], sizes[j]), dtype=self.dtype,
                                            device=self.device))
                else:
                    cols.append(blk.todense())
            rows.append(torch.cat(cols, dim=1))
        return torch.cat(rows, dim=0)

    def _block_sizes(self):
        sizes = [None] * self.nblocks
        for i, row in enumerate(self.blocks):
            for blk in row:
                if blk is not None:
                    sizes[i] = blk.shape[0]
                    break
        return sizes


@dataclasses.dataclass
class ColumnStack:
    """Maps one field to a tuple of fields: y_i = ops[i] @ x.
    Used for e.g. the pressure -> velocity-components gradient coupling."""

    ops: Tuple[object, ...]

    def matvec(self, x):
        return tuple(op.matvec(x) for op in self.ops)

    @property
    def shape(self):
        return (sum(op.shape[0] for op in self.ops), self.ops[0].shape[1])

    def todense(self) -> torch.Tensor:
        return torch.cat([op.todense() for op in self.ops], dim=0)


@dataclasses.dataclass
class RowStack:
    """Maps a tuple of fields to one field: y = sum_i ops[i] @ x_i.
    Used for e.g. the velocity-components -> pressure divergence coupling."""

    ops: Tuple[object, ...]

    def matvec(self, x):
        out = None
        for op, xi in zip(self.ops, x):
            c = op.matvec(xi)
            out = c if out is None else pt.add(out, c)
        return out

    @property
    def shape(self):
        return (self.ops[0].shape[0], sum(op.shape[1] for op in self.ops))

    def todense(self) -> torch.Tensor:
        return torch.cat([op.todense() for op in self.ops], dim=1)


@dataclasses.dataclass
class FieldwiseOperator:
    """Applies one operator per field of a tuple vector (block-diagonal with
    independent fields), e.g. a vector Laplacian as d scalar Laplacians."""

    ops: Tuple[object, ...]

    def matvec(self, x):
        return tuple(op.matvec(xi) for op, xi in zip(self.ops, x))

    def diag(self):
        return tuple(op.diag() for op in self.ops)

    def abs_row_sum(self):
        return tuple(op.abs_row_sum() for op in self.ops)

    @property
    def dtype(self):
        return self.ops[0].dtype

    @property
    def device(self):
        return self.ops[0].device

    @property
    def shape(self):
        n = sum(op.shape[0] for op in self.ops)
        m = sum(op.shape[1] for op in self.ops)
        return (n, m)

    def todense(self) -> torch.Tensor:
        return torch.block_diag(*[op.todense() for op in self.ops])
