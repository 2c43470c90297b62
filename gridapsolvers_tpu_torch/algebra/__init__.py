from .stencil import (  # noqa: F401
    ConstStencilMatrix,
    StencilMatrix,
    shift,
    stencil_from_scipy,
)
