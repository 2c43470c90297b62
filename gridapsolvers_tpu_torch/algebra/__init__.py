from .stencil import (  # noqa: F401
    ConstStencilMatrix,
    StencilMatrix,
    shift,
    stencil_from_scipy,
)
from .ell import ELLMatrix, ell_from_coo, ell_from_scipy, ell_to_scipy  # noqa: F401
from .dense import DenseMatrix  # noqa: F401
from .block import BlockOperator, ColumnStack, FieldwiseOperator, RowStack  # noqa: F401
from .convert import to_scipy  # noqa: F401
