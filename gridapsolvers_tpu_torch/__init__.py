"""gridapsolvers_tpu_torch — the PyTorch/CUDA port of gridapsolvers_tpu.

The JAX package `gridapsolvers_tpu` is the reference; this package mirrors
its layout and names so each module has an obvious counterpart:

- ``interfaces``  : solver protocol (setup/update/solve/apply/smooth),
                    tolerances, convergence flags, solver statistics,
                    solver-info trees and nullspaces.
- ``utils``       : vector algebra over tensors and tuples of tensors,
                    the dtype-cast walker, two-float arithmetic, device
                    resolution.
- ``fem``         : structured Cartesian meshes, Q1 and general
                    tensor-element assembly (host NumPy/scipy), the Poisson,
                    Taylor-Hood Stokes, Navier-Stokes, RT0/RT1 Darcy, H(div)
                    and linear elasticity model problems.
- ``multilevel``  : mesh hierarchies, structured grid transfers, per-field
                    transfers, FE-space hierarchies and L2 / cell-local
                    projections.
- ``algebra``     : banded (`StencilMatrix`) and matrix-free constant
                    (`ConstStencilMatrix`) stencil operators, padded-ELL
                    matrices, dense and block operators.
- ``blocks``      : block-diagonal and block-triangular preconditioners,
                    staggered and blockwise nonlinear operators.
- ``nonlinear``   : Newton, Picard-to-Newton continuation, the two-float
                    Newton endgame and a SciPy nonlinear-solver wrapper.
- ``ops``         : hand-written CUDA kernels for the stencil matvecs
                    (sources under ``csrc/``, built with nvcc at first use)
                    beside their plain PyTorch versions.
- ``linear``      : CG, GMRES/FGMRES, MINRES, Jacobi/Richardson/Chebyshev
                    and multicolor Gauss-Seidel smoothers, dense direct solvers, geometric multigrid
                    (with a bf16 smoother or cycle), algebraic multigrid,
                    iterative refinement, Schur-complement and wrapper
                    solvers.
- ``models``      : the Poisson GMG-CG, Stokes, Navier-Stokes, Darcy and
                    elasticity entry points.
- ``convert``     : carries the JAX package's operators (as numpy arrays
                    plus static fields) into this package's objects.

Every constructor of operators and problems takes an explicit ``device=``
and ``dtype=``. An operator's ``matvec`` launches its CUDA kernel on a
CUDA tensor and runs the plain PyTorch version on a CPU tensor; there is
no fallback between the two.
"""

__version__ = "0.1.0"
