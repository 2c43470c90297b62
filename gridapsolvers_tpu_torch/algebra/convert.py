"""Host-side operator conversions (set-up paths, validation).

Port of `gridapsolvers_tpu/algebra/convert.py` for the operators this
package has.
"""
from __future__ import annotations

import scipy.sparse as sp

from .block import BlockOperator, ColumnStack, FieldwiseOperator, RowStack
from .dense import DenseMatrix
from .ell import ELLMatrix, ell_to_scipy
from .stencil import StencilMatrix

# operators the JAX package converts that this package does not have yet,
# and the part of the port that brings them (ROADMAP.md queue 1)
_LATER = {
    "DistELLMatrix": "the distributed slice",
}


def _block_operator(op: BlockOperator) -> sp.csr_matrix:
    """sp.bmat of the blocks, a None block as zeros sized from its row's
    and column's other blocks."""
    mats = [[None if b is None else to_scipy(b) for b in row] for row in op.blocks]
    n = len(mats)
    rs, cs = [None] * n, [None] * n
    for i in range(n):
        for j in range(n):
            if mats[i][j] is not None:
                rs[i] = rs[i] or mats[i][j].shape[0]
                cs[j] = cs[j] or mats[i][j].shape[1]
    for i in range(n):
        for j in range(n):
            if mats[i][j] is None:
                mats[i][j] = sp.csr_matrix((rs[i], cs[j]))
    return sp.bmat(mats, format="csr")


def to_scipy(op) -> sp.csr_matrix:
    """Any operator -> scipy CSR (explicit zeros eliminated)."""
    if isinstance(op, ELLMatrix):
        S = ell_to_scipy(op)
    elif isinstance(op, StencilMatrix):
        S = ell_to_scipy(op.to_ell(device="cpu"))
    elif isinstance(op, DenseMatrix):
        S = sp.csr_matrix(op.A.detach().cpu().numpy())
    elif isinstance(op, FieldwiseOperator):
        S = sp.block_diag([to_scipy(o) for o in op.ops], format="csr")
    elif isinstance(op, ColumnStack):
        S = sp.vstack([to_scipy(o) for o in op.ops], format="csr")
    elif isinstance(op, RowStack):
        S = sp.hstack([to_scipy(o) for o in op.ops], format="csr")
    elif isinstance(op, BlockOperator):
        S = _block_operator(op)
    elif type(op).__name__ == "DistGraphELL":
        from ..parallel.dist_ell_nd import dist_to_scipy_nd

        S = dist_to_scipy_nd(op)  # padded, shard-major box order; collective
    else:
        name = type(op).__name__
        later = _LATER.get(name)
        raise TypeError(
            f"to_scipy: unsupported {name}"
            + (f"; it comes with {later}" if later else "")
        )
    S = S.copy()
    S.eliminate_zeros()
    return S
