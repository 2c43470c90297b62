"""Multi-field transfer operators.

Port of `gridapsolvers_tpu/multilevel/multifield.py` (reference
MultiFieldTransferOperators.jl:4-29,45-100): one transfer operator per
field of a tuple (block) vector, applied fieldwise.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass
class MultiFieldTransfer:
    ops: Tuple[object, ...]

    def matvec(self, x):
        return tuple(op.matvec(xi) for op, xi in zip(self.ops, x))
