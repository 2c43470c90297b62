"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version and its launch counts. Importing this package builds nothing."""
from .banded_stencil import banded_stencil_apply, banded_stencil_plain  # noqa: F401
from .const_stencil import const_stencil_apply, const_stencil_plain  # noqa: F401
from .ell_spmv import ell_spmv_apply, ell_spmv_plain  # noqa: F401
