"""Explicit FE-space and triangulation hierarchies.

Port of `gridapsolvers_tpu/multilevel/spaces.py`. Reference analogs:
FESpaceHierarchy / FESpaceHierarchyLevel
(src/MultilevelTools/FESpaceHierarchies.jl:1-16,39-61,104-137) and
TriangulationHierarchy (TriangulationHierarchies.jl:2-34): first-class
spaces, so multifield hierarchies and generic drivers can be composed
without re-deriving masks and shapes per call site. The reference's
two-state levels (before/after redistribution) collapse to one state plus
an optional per-level sharding spec, which nothing on one device reads.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..fem import assembly2 as asm
from ..fem.mesh import CartesianMesh
from ..utils import resolve_device
from .hierarchy import GridHierarchy


@dataclasses.dataclass(frozen=True)
class FESpace:
    """Scalar Lagrangian Q_k space on a structured mesh (one field).

    dirichlet: 'boundary' (whole boundary), None (no constraints), or a
    tuple of face tags like ('x0', 'y1') — same vocabulary as
    CartesianMesh.boundary_vertex_mask.
    """

    mesh: CartesianMesh
    order: int = 1
    dirichlet: object = "boundary"

    @property
    def grid_shape(self) -> Tuple[int, ...]:
        return asm.node_grid_shape(self.mesh, self.order)

    @property
    def num_dofs(self) -> int:
        return int(np.prod(self.grid_shape))

    def dirichlet_mask(self) -> np.ndarray:
        if self.dirichlet is None:
            return np.zeros(self.num_dofs, dtype=bool)
        return asm.boundary_node_mask(self.mesh, self.order, self.dirichlet)

    def free_mask(self, dtype=torch.float64, device=None) -> torch.Tensor:
        """{0,1} flat free-dof mask in the torch `dtype` on `device`."""
        m = (~self.dirichlet_mask()).astype(np.float64)
        return torch.from_numpy(m).to(resolve_device(device), dtype)

    @property
    def num_free_dofs(self) -> int:
        return int((~self.dirichlet_mask()).sum())

    def node_coords(self) -> np.ndarray:
        return asm.node_coords(self.mesh, self.order)

    # -- assembly hooks (constrained square operators, ELL) ---------------

    def assemble(self, kind: str = "stiffness", scale: float = 1.0, dtype=None,
                 device=None):
        """The constrained operator as an `ELLMatrix` (K3) in the torch
        `dtype` (None: f64) on `device`."""
        S = asm.assemble_bilinear(self.mesh, self.order, kind, scale=scale)
        if self.dirichlet is not None:
            S = asm.dirichlet_square(S, self.dirichlet_mask())
        return asm.to_ell(S, dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class MultiFieldFESpace:
    """Tuple of fields (reference MultiFieldFESpace): vectors are tuples
    of per-field tensors, matching the framework-wide tuple convention."""

    fields: Tuple[FESpace, ...]

    @property
    def num_dofs(self) -> int:
        return sum(f.num_dofs for f in self.fields)

    def free_masks(self, dtype=torch.float64, device=None) -> tuple:
        return tuple(f.free_mask(dtype, device) for f in self.fields)


@dataclasses.dataclass(frozen=True)
class TriangulationHierarchy:
    """Per-level triangulations (reference TriangulationHierarchies.jl):
    here simply the mesh list plus optional per-level sharding specs."""

    hierarchy: GridHierarchy
    shardings: Optional[Tuple[object, ...]] = None

    @property
    def num_levels(self) -> int:
        return self.hierarchy.num_levels

    def __getitem__(self, lev: int) -> CartesianMesh:
        return self.hierarchy[lev]


@dataclasses.dataclass(frozen=True)
class FESpaceHierarchy:
    """Per-level FE spaces over a mesh hierarchy (finest first)."""

    spaces: Tuple[FESpace, ...]

    @property
    def num_levels(self) -> int:
        return len(self.spaces)

    def __getitem__(self, lev: int) -> FESpace:
        return self.spaces[lev]

    def compute_matrices(self, kind: str = "stiffness", scale: float = 1.0, dtype=None,
                         device=None):
        """Per-level constrained operators (reference
        compute_hierarchy_matrices, FESpaceHierarchies.jl:141-174)."""
        return [s.assemble(kind, scale, dtype=dtype, device=device) for s in self.spaces]

    def transfer_operators(self, dtype=torch.float64, mode: str = "residual", device=None):
        """(prolongations, restrictions) on the spaces' node grids — the
        FE-space-aware variant of setup_transfer_operators. Handles any
        order k: the Q_k node grid of mesh n IS the Q_1 vertex grid of mesh
        k*n, so the structured factor-2 transfers apply."""
        from .transfer import StructuredProlongation, StructuredRestriction

        P, R = [], []
        for l in range(self.num_levels - 1):
            fine, coarse = self.spaces[l], self.spaces[l + 1]
            factors = tuple(
                nf // nc
                for nf, nc in zip(fine.mesh.ncells, coarse.mesh.ncells)
            )
            per = tuple(fine.mesh.periodic)
            kw = {}
            if any(f != 2 for f in factors) or any(per):
                kw = dict(factors=factors, periodic=per)
            mf = fine.free_mask(dtype, device)
            mc = coarse.free_mask(dtype, device)
            P.append(StructuredProlongation(fine.grid_shape, coarse.grid_shape, mf, **kw))
            R.append(StructuredRestriction(fine.grid_shape, coarse.grid_shape, mode, mc, mf,
                                           **kw))
        return P, R


def fe_space_hierarchy(
    hierarchy: GridHierarchy,
    order: int = 1,
    dirichlet: object = "boundary",
) -> FESpaceHierarchy:
    """FESpace(mh, reffe) analog: one space per level
    (FESpaceHierarchies.jl:39-61)."""
    return FESpaceHierarchy(tuple(FESpace(m, order, dirichlet) for m in hierarchy.meshes))


def multifield_hierarchy(
    hierarchy: GridHierarchy,
    orders: Sequence[int],
    dirichlet: object = "boundary",
) -> List[MultiFieldFESpace]:
    """Per-level multifield spaces (reference MultiField FESpace(mh, ...))."""
    return [
        MultiFieldFESpace(tuple(FESpace(m, o, dirichlet) for o in orders))
        for m in hierarchy.meshes
    ]
