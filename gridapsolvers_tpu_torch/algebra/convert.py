"""Host-side operator conversions (set-up paths, validation).

Port of `gridapsolvers_tpu/algebra/convert.py` for the operators this
package has.
"""
from __future__ import annotations

import scipy.sparse as sp

from .ell import ELLMatrix, ell_to_scipy
from .stencil import StencilMatrix

# operators the JAX package converts that this package does not have yet,
# and the part of the port that brings them (ROADMAP.md queue 1)
_LATER = {
    "DenseMatrix": "the Stokes slice (dense and block algebra)",
    "FieldwiseOperator": "the Stokes slice (dense and block algebra)",
    "ColumnStack": "the Stokes slice (dense and block algebra)",
    "RowStack": "the Stokes slice (dense and block algebra)",
    "BlockOperator": "the Stokes slice (dense and block algebra)",
    "DistELLMatrix": "the distributed slice",
    "DistGraphELL": "the distributed slice",
}


def to_scipy(op) -> sp.csr_matrix:
    """ELLMatrix or StencilMatrix -> scipy CSR (explicit zeros eliminated)."""
    if isinstance(op, ELLMatrix):
        S = ell_to_scipy(op)
    elif isinstance(op, StencilMatrix):
        S = ell_to_scipy(op.to_ell(device="cpu"))
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
