"""Patch topologies on structured grids (host-side index construction).

The port's own copy of `gridapsolvers_tpu/patches/topology.py` (NumPy only,
unchanged).

Analog of the reference's patch machinery (PatchTopology/PatchAssembler from
Gridap + CoarsePatchTopologies.jl): a patch topology is just a padded index
table — every patch lists its dof ids in a fixed-width int32 array, padded
with a dummy dof (one zero-pinned extra slot appended to the vector), so
all patch operations are batched dense kernels with static shapes
(SURVEY.md §7 stage 6: "patches padded to size classes").
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(eq=False)
class PatchTopology:
    """dofs: (n_patches, k) int32 indices into the (extended) dof vector;
    entries equal to `dummy` are padding. weights: (n_patches, k) scatter
    weights (0 on padding)."""

    dofs: np.ndarray
    dummy: int
    n_dofs: int  # real dof count (extended vector has n_dofs + 1)

    @property
    def n_patches(self) -> int:
        return self.dofs.shape[0]

    @property
    def width(self) -> int:
        return self.dofs.shape[1]

    def valid_mask(self) -> np.ndarray:
        return self.dofs != self.dummy

    def overlap_counts(self) -> np.ndarray:
        """How many patches touch each dof (for averaged scatter)."""
        counts = np.zeros(self.n_dofs + 1)
        np.add.at(counts, self.dofs.reshape(-1), self.valid_mask().reshape(-1))
        return counts

    def owner_slot_mask(self) -> np.ndarray:
        """(n_patches, k) 0/1 weights selecting exactly ONE writer per dof
        — the highest-indexed patch containing it (the reference's
        sequential nonoverlapping solve overwrites, so the last patch
        wins; PatchSolvers.jl solve_patch_nonoverlapping!:302-320)."""
        valid = self.valid_mask()
        owner = np.full(self.n_dofs + 1, -1, dtype=np.int64)
        pidx = np.broadcast_to(
            np.arange(self.n_patches)[:, None], self.dofs.shape
        )
        np.maximum.at(
            owner,
            self.dofs.reshape(-1)[valid.reshape(-1)],
            pidx.reshape(-1)[valid.reshape(-1)],
        )
        return (valid & (pidx == owner[self.dofs])).astype(np.float64)


def vertex_star_patches(
    grid_shape: Tuple[int, ...],
    free_mask: Optional[np.ndarray] = None,
    radius: int = 1,
    stride: int = 1,
) -> PatchTopology:
    """Vertex-star patches on a structured vertex grid: one patch per free
    vertex, containing the (2r+1)^d neighborhood intersected with the grid
    and the free dofs. The workhorse patch family of the reference
    (Schöberl/vertex-star smoothing for H(div)/Stokes GMG).

    stride > 1 restricts patch centers to nodes whose coordinates are all
    multiples of `stride` — e.g. on a Q2 node grid, stride=2 radius=2 gives
    one patch per MESH vertex covering the Q2 dofs of its 2^d surrounding
    cells (the Schöberl vertex star for higher-order elements)."""
    d = len(grid_shape)
    n = int(np.prod(grid_shape))
    dummy = n
    strides = np.cumprod([1] + list(grid_shape[::-1]))[:-1][::-1]

    if free_mask is None:
        free_mask = np.ones(grid_shape, dtype=bool)
    free_mask = free_mask.reshape(grid_shape)

    centers = np.stack(
        np.meshgrid(*[np.arange(m) for m in grid_shape], indexing="ij"),
        axis=-1,
    ).reshape(-1, d)
    keep = free_mask.reshape(-1)
    if stride > 1:
        keep = keep & np.all(centers % stride == 0, axis=1)
    centers = centers[keep]

    offsets = np.array(
        list(itertools.product(range(-radius, radius + 1), repeat=d))
    )
    # patch dof coordinates: (np, k, d)
    coords = centers[:, None, :] + offsets[None, :, :]
    valid = np.all((coords >= 0) & (coords < np.array(grid_shape)), axis=-1)
    flat = np.clip(coords, 0, np.array(grid_shape) - 1) @ strides
    # restrict to free dofs
    valid &= free_mask.reshape(-1)[flat]
    dofs = np.where(valid, flat, dummy).astype(np.int32)
    return PatchTopology(dofs=dofs, dummy=dummy, n_dofs=n)


def coarse_cell_patches(
    ncells_coarse: Tuple[int, ...],
    order: int,
    free_mask: Optional[np.ndarray] = None,
    factor: int = 2,
    interior: bool = False,
) -> PatchTopology:
    """Patches = coarse-cell footprints in the fine node grid (reference
    CoarsePatchTopologies.jl:8-34): for each coarse cell, all fine nodes of
    the `factor`-refined sub-grid it covers. Used by patch-corrected
    prolongation.

    interior=True keeps only the nodes strictly inside each footprint (the
    reference's PatchAssembler `assembly=:interior`) — these patches are
    DISJOINT, so a patch correction built on them is an exact block solve
    with no overlap amplification."""
    d = len(ncells_coarse)
    fine_shape = tuple(order * factor * c + 1 for c in ncells_coarse)
    n = int(np.prod(fine_shape))
    dummy = n
    strides = np.cumprod([1] + list(fine_shape[::-1]))[:-1][::-1]
    if free_mask is None:
        free_mask = np.ones(fine_shape, dtype=bool)
    free_mask = free_mask.reshape(fine_shape)

    cells = np.stack(
        np.meshgrid(*[np.arange(c) for c in ncells_coarse], indexing="ij"),
        axis=-1,
    ).reshape(-1, d)
    span = order * factor
    rng = range(1, span) if interior else range(span + 1)
    offsets = np.array(list(itertools.product(rng, repeat=d)))
    coords = cells[:, None, :] * span + offsets[None, :, :]
    flat = coords @ strides
    valid = free_mask.reshape(-1)[flat]
    dofs = np.where(valid, flat, dummy).astype(np.int32)
    return PatchTopology(dofs=dofs, dummy=dummy, n_dofs=n)


def concat_patches(
    topos: Sequence[PatchTopology], field_sizes: Sequence[int]
) -> PatchTopology:
    """Merge per-field patch tables into one over the concatenated dof
    vector (for mixed/Vanka patches): patch i of the result is the union of
    patch i of every field, with indices offset into the concatenation."""
    n_total = int(sum(field_sizes))
    dummy = n_total
    offs = np.cumsum([0] + list(field_sizes))[:-1]
    parts = []
    for t, off in zip(topos, offs):
        d = t.dofs.astype(np.int64).copy()
        d = np.where(d == t.dummy, dummy, d + off)
        parts.append(d)
    dofs = np.concatenate(parts, axis=1).astype(np.int32)
    return PatchTopology(dofs=dofs, dummy=dummy, n_dofs=n_total)
