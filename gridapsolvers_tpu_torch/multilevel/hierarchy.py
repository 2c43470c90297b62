"""Structured mesh hierarchies.

Port of `gridapsolvers_tpu/multilevel/hierarchy.py` (host-side metadata,
carried over unchanged): an ordered list of Cartesian meshes finest-first,
each coarser level a factor-2 (or given factor) coarsening (reference
ModelHierarchies.jl:18-24,80-148).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

from ..fem.mesh import CartesianMesh


@dataclasses.dataclass
class GridHierarchy:
    """Meshes finest-first: meshes[0] is the fine grid."""

    meshes: List[CartesianMesh]

    @property
    def num_levels(self) -> int:
        return len(self.meshes)

    def __getitem__(self, lev: int) -> CartesianMesh:
        return self.meshes[lev]


def _level_factors(factor, num_levels: int):
    """Normalize `factor`: int | per-axis tuple | per-level list of either
    (the reference's anisotropic nrefs, ModelHierarchies.jl:85-87)."""
    if isinstance(factor, list):
        if len(factor) != num_levels - 1:
            raise ValueError(f"need {num_levels - 1} level factors, got {len(factor)}")
        return factor
    return [factor] * (num_levels - 1)


def cartesian_hierarchy(
    ncells_fine: Tuple[int, ...],
    num_levels: int,
    domain: Optional[Tuple[float, ...]] = None,
    factor=2,
    periodic: Optional[Tuple[bool, ...]] = None,
    labels=(),
) -> GridHierarchy:
    """Build by coarsening the fine mesh (requires divisibility). `factor`
    may be an int, a per-axis tuple, or a per-level list of either;
    `labels` = named boundary tags, inherited by every level."""
    dim = len(ncells_fine)
    if domain is None:
        domain = tuple(x for _ in range(dim) for x in (0.0, 1.0))
    meshes = [CartesianMesh(tuple(ncells_fine), domain, periodic, tuple(labels))]
    for f in _level_factors(factor, num_levels):
        meshes.append(meshes[-1].coarsen(f))
    return GridHierarchy(meshes)


def hierarchy_from_coarse(
    ncells_coarse: Tuple[int, ...],
    num_levels: int,
    domain: Optional[Tuple[float, ...]] = None,
    factor=2,
    periodic: Optional[Tuple[bool, ...]] = None,
    labels=(),
) -> GridHierarchy:
    """Build by refining a coarse seed (the reference's primary direction,
    ModelHierarchies.jl:127-146); `labels` are inherited by every level."""
    dim = len(ncells_coarse)
    if domain is None:
        domain = tuple(x for _ in range(dim) for x in (0.0, 1.0))
    meshes = [CartesianMesh(tuple(ncells_coarse), domain, periodic, tuple(labels))]
    for f in _level_factors(factor, num_levels):
        meshes.insert(0, meshes[0].refine(f))
    return GridHierarchy(meshes)


def octree_cartesian_hierarchy(
    ncells_coarse: Tuple[int, ...],
    num_levels: int,
    domain: Optional[Tuple[float, ...]] = None,
    num_refs_coarse: int = 0,
    periodic: Optional[Tuple[bool, ...]] = None,
    factor=2,
) -> GridHierarchy:
    """Uniform-octree hierarchy from a coarse Cartesian seed (the
    reference's P4estCartesianModelHierarchy,
    ext/GridapP4estExt/GridapP4estExt.jl:25-39): the seed is pre-refined
    `num_refs_coarse` times to form the coarsest level, then refined into
    `num_levels` levels."""
    seed = tuple(n * (2 ** num_refs_coarse) for n in ncells_coarse)
    return hierarchy_from_coarse(seed, num_levels, domain, factor, periodic)


def compute_hierarchy_matrices(
    hierarchy: GridHierarchy,
    assemble: Callable[[CartesianMesh], object],
) -> List[object]:
    """Per-level operator assembly (reference FESpaceHierarchies.jl:141-174
    compute_hierarchy_matrices): geometric rediscretization on every
    level."""
    return [assemble(mesh) for mesh in hierarchy.meshes]
