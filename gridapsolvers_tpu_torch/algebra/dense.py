"""Dense operator wrapper (coarse grids, small tests).

Port of `gridapsolvers_tpu/algebra/dense.py`.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class DenseMatrix:
    A: torch.Tensor

    @property
    def shape(self):
        return tuple(self.A.shape)

    @property
    def dtype(self):
        return self.A.dtype

    @property
    def device(self):
        return self.A.device

    @property
    def nnz(self):
        return self.A.numel()

    def matvec(self, x):
        return self.A @ x

    def diag(self):
        return torch.diagonal(self.A)

    def abs_row_sum(self):
        return torch.sum(torch.abs(self.A), dim=1)

    def todense(self):
        return self.A

    def astype(self, dtype):
        return DenseMatrix(self.A.to(dtype))
