"""Structured Cartesian meshes (host-side metadata).

Port of `gridapsolvers_tpu/fem/mesh.py`; the class is pure NumPy and is
carried over unchanged. Minimal substitute for the reference's external
Gridap.jl CartesianDiscreteModel (used via
MultilevelTools/ModelHierarchies.jl:119). Meshes are tiny host-side
metadata; all bulk data lives in the assembled device operators.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class CartesianMesh:
    """Uniform Cartesian mesh of a box.

    ncells : cells per dimension, e.g. (64, 64) or (16, 16, 16)
    domain : (min_0, max_0, min_1, max_1, ...) like the reference's domain
             tuples (test/LinearSolvers/GMGTests.jl uses (0,1,0,1)).
    """

    ncells: Tuple[int, ...]
    domain: Tuple[float, ...]
    # per-axis periodicity (reference CartesianModelHierarchy isperiodic,
    # ModelHierarchies.jl:85-87): a periodic axis has ncells vertices (no
    # duplicated endpoint) and no boundary there
    periodic: Tuple[bool, ...] = None
    # named boundary labels (the reference's add_labels! hook,
    # ModelHierarchies.jl:85-87 / Gridap add_tag_from_tags!): name -> tuple
    # of face specs like ('x0','y1'). Registered names are accepted anywhere
    # a `tags` argument is (boundary_vertex_mask and the assembly callbacks
    # built on it).
    labels: Tuple[Tuple[str, Tuple[str, ...]], ...] = ()

    def __post_init__(self):
        if self.periodic is None:
            object.__setattr__(
                self, "periodic", tuple(False for _ in self.ncells)
            )

    def with_labels(self, **named_faces) -> "CartesianMesh":
        """Register named boundary tags (reference `add_labels!`):
        `mesh.with_labels(walls=('x0','x1','y0'), lid=('y1',))`.

        Semantics note: a face spec always denotes the CLOSED face
        (corners/edges included). The reference's `add_tag_from_tags!`
        can tag a face interior (its 'top' = entity 6/22 excludes
        corners), so when two labels carry DIFFERENT Dirichlet values the
        shared corners here belong to every label that touches them —
        callers with conflicting corner values must lift the interior
        explicitly (see stokes.cavity_lift's slice(1,-1))."""
        new = tuple(
            (k, tuple(v) if not isinstance(v, str) else (v,))
            for k, v in named_faces.items()
        )
        return dataclasses.replace(self, labels=self.labels + new)

    def resolve_tags(self, tags) -> Tuple[Tuple[int, int], ...]:
        """Resolve named labels / face specs to canonical (axis, side)
        pairs (side 0 = min face, 1 = max face). Shared by every mask
        function so label semantics live in one place. Face specs on a
        periodic axis are rejected: a periodic axis has no boundary."""
        if isinstance(tags, str):
            tags = (tags,)
        label_map = dict(self.labels)
        resolved = []
        for t in tags:
            resolved.extend(label_map.get(t, (t,)))
        names = "xyz"
        out = []
        for t in resolved:
            d = names.index(t[0])
            side = int(t[1])
            if self.periodic[d]:
                raise ValueError(
                    f"face spec {t!r} lies on periodic axis {d} "
                    "(a periodic axis has no boundary faces)"
                )
            out.append((d, side))
        return tuple(out)

    @property
    def dim(self) -> int:
        return len(self.ncells)

    @property
    def h(self) -> Tuple[float, ...]:
        return tuple(
            (self.domain[2 * d + 1] - self.domain[2 * d]) / self.ncells[d]
            for d in range(self.dim)
        )

    @property
    def vertex_shape(self) -> Tuple[int, ...]:
        """Q1 dof grid shape (vertices per dim; periodic axes drop the
        duplicate endpoint)."""
        return tuple(
            n if p else n + 1 for n, p in zip(self.ncells, self.periodic)
        )

    @property
    def num_vertices(self) -> int:
        return int(np.prod(self.vertex_shape))

    @property
    def num_cells(self) -> int:
        return int(np.prod(self.ncells))

    def vertex_coords(self) -> np.ndarray:
        """(num_vertices, dim) vertex coordinates in C-order flat indexing."""
        axes = [
            np.linspace(self.domain[2 * d], self.domain[2 * d + 1], n + 1)
            for d, n in enumerate(self.ncells)
        ]
        grids = np.meshgrid(*axes, indexing="ij")
        return np.stack([g.reshape(-1) for g in grids], axis=1)

    def boundary_vertex_mask(self, tags: str = "boundary") -> np.ndarray:
        """Boolean mask (vertex grid shape) of Dirichlet vertices.

        tags: 'boundary' = whole boundary; 'dirichlet_d<k>' = faces normal to
        dim k; or a tuple of face specs like ('x0','x1','y0') meaning
        min/max faces per dim (reference uses Gridap face labels).
        """
        shape = self.vertex_shape
        mask = np.zeros(shape, dtype=bool)
        if tags == "boundary":
            for d in range(self.dim):
                if self.periodic[d]:
                    continue
                idx = [slice(None)] * self.dim
                idx[d] = 0
                mask[tuple(idx)] = True
                idx[d] = shape[d] - 1
                mask[tuple(idx)] = True
            return mask
        for d, side in self.resolve_tags(tags):
            idx = [slice(None)] * self.dim
            idx[d] = 0 if side == 0 else shape[d] - 1
            mask[tuple(idx)] = True
        return mask

    def _factors(self, factor) -> Tuple[int, ...]:
        """Per-axis refinement factors (the reference's anisotropic nrefs
        tuples, ModelHierarchies.jl:85-87)."""
        if isinstance(factor, int):
            return tuple(factor for _ in self.ncells)
        factor = tuple(factor)
        if len(factor) != self.dim:
            raise ValueError(f"{len(factor)} factors for a {self.dim}D mesh")
        return factor

    def refine(self, factor=2) -> "CartesianMesh":
        """Uniform or anisotropic refinement (reference
        Gridap.Adaptivity.refine, ModelHierarchies.jl:133)."""
        f = self._factors(factor)
        return CartesianMesh(
            tuple(n * k for n, k in zip(self.ncells, f)),
            self.domain,
            self.periodic,
            self.labels,
        )

    def coarsen(self, factor=2) -> "CartesianMesh":
        f = self._factors(factor)
        if any(n % k for n, k in zip(self.ncells, f)):
            raise ValueError(f"cells {self.ncells} not divisible by factors {f}")
        return CartesianMesh(
            tuple(n // k for n, k in zip(self.ncells, f)),
            self.domain,
            self.periodic,
            self.labels,
        )
