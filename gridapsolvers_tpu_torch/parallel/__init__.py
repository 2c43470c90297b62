"""Distributed (block-split) layer: process meshes, sharded grid vectors,
halo-exchange operators and the distributed Poisson GMG.

Port of `gridapsolvers_tpu/parallel/` for its stencil path (`mesh`,
`dist`, `halo`, `weak_scaling`), with `launch` (no JAX counterpart) to
start the ranks. Its names are those of `gridapsolvers_tpu/parallel/
__init__.py:1-15`; the sharded ELL, graph and block layers come later.
"""
from .mesh import (  # noqa: F401
    axis_size,
    device_mesh,
    device_mesh_nd,
    replicated,
    row_sharding,
)
from .dist import (  # noqa: F401
    Resharded,
    distributed_poisson_gmg,
    grid_spec,
    replicate_stencil,
    shard_grid_vector,
    shard_stencil,
)
