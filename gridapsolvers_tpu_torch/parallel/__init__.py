"""Distributed (block-split) layer: process meshes, sharded grid vectors,
halo-exchange operators, the distributed Poisson GMG and box-partitioned
sparse operators.

Port of `gridapsolvers_tpu/parallel/` for its stencil path (`mesh`,
`dist`, `halo`, `weak_scaling`) and its box-partitioned graph layer
(`dist_ell_nd`), with `launch` (no JAX counterpart) to start the ranks.
Its names are those of `gridapsolvers_tpu/parallel/__init__.py`; the 1-D
window ELL (`dist_ell`) and block (`dist_block`) layers come later.
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
from .dist_ell_nd import (  # noqa: F401
    BoxPartition,
    DistGraphELL,
    PartitionLayout,
    box_partition,
    contiguous_partition,
    dense_padded_nd,
    dist_to_scipy_nd,
    redistribute_vector_nd,
    scipy_in_part_order,
    shard_csr_nd,
    shard_vector_nd,
    unshard_vector_nd,
)
