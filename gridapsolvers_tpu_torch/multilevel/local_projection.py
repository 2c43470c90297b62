"""Cell-local L2 projection maps.

Port of `gridapsolvers_tpu/multilevel/local_projection.py`. Analog of the
reference's LocalProjectionMap
(src/MultilevelTools/LocalProjectionMaps.jl:5,86-208): project a field onto
a (lower-order) local space cell by cell via small mass solves. On a
uniform mesh every cell shares one projection matrix P_e = M_to^{-1} B_e
(host NumPy), so the map is one gather, one batched small matmul and one
multiplicity-averaged scatter (`index_add_`, which sums in no fixed order
on CUDA) on the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..fem import assembly2 as asm
from ..fem.elements import TensorElement, mass_matrix
from ..fem.mesh import CartesianMesh
from ..utils import resolve_device


def _cell_maps(obj, conn_from, conn_to, n_to, dev, dtype):
    """Device tables shared by both maps: connectivities and the inverse
    multiplicity of every arrival node."""
    obj._conn_from = torch.from_numpy(np.asarray(conn_from, np.int64)).to(dev)
    obj._conn_to = torch.from_numpy(np.asarray(conn_to, np.int64)).to(dev)
    counts = np.zeros(n_to)
    np.add.at(counts, conn_to.reshape(-1), 1.0)
    obj._inv_counts = torch.from_numpy(1.0 / np.maximum(counts, 1.0)).to(dev, dtype)
    obj.n_to = n_to


def _scatter_mean(obj, p_cell: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(obj.n_to, dtype=p_cell.dtype, device=p_cell.device)
    out.index_add_(0, obj._conn_to.reshape(-1), p_cell.reshape(-1))
    return out * obj._inv_counts


@dataclasses.dataclass(eq=False)
class LocalProjectionMap:
    """Projects nodal fields of order `order_from` onto order `order_to`
    (continuous, cell-averaged) on the same mesh; tables in the torch
    `dtype` on `device`."""

    mesh: CartesianMesh
    order_from: int
    order_to: int
    dtype: torch.dtype = torch.float64
    device: object = None

    def __post_init__(self):
        mesh = self.mesh
        dev = resolve_device(self.device)
        e_from = TensorElement(self.order_from, mesh.h, nquad=self.order_from + 1)
        e_to = TensorElement(self.order_to, mesh.h, nquad=self.order_from + 1)
        # B_e[i_to, j_from] = int phi_to_i phi_from_j
        Vt = e_to._phi_table(None)
        Vf = e_from._phi_table(None)
        W = e_to.quad_weights()
        B = np.einsum("iq,jq,q->ij", Vt, Vf, W)
        M = mass_matrix(e_to)
        self._P = torch.from_numpy(np.linalg.solve(M, B)).to(dev, self.dtype)  # (n_to, n_from)
        conn_to = asm.connectivity(mesh, self.order_to)
        _cell_maps(self, asm.connectivity(mesh, self.order_from), conn_to,
                   asm.num_nodes(mesh, self.order_to), dev, self.dtype)
        self.n_from = asm.num_nodes(mesh, self.order_from)

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        """(n_from,) -> (n_to,): cell-local projection, averaged at shared
        nodes (the reference's assembled-projection behavior up to the
        averaging convention)."""
        u_cell = u[self._conn_from]                      # (ncells, n_from_e)
        return _scatter_mean(self, u_cell @ self._P.T)   # (ncells, n_to_e) scattered


@dataclasses.dataclass(eq=False)
class SpaceProjectionMap:
    """Cell-local L2 projection onto a CONSTRAINED FE space.

    Reference SpaceProjectionMap (LocalProjectionMaps.jl:172-279): per
    cell the local mass system is restricted to the cell's free dofs,
    solved, and the constrained slots get zeros. The mesh is uniform, so
    cells fall into a handful of constraint-pattern classes; the host
    solves one restricted system per class, and the device apply is one
    gather, one batched matmul over per-cell class matrices and one
    averaged scatter."""

    space_to: object          # FESpace (multilevel/spaces.py)
    order_from: int
    dtype: torch.dtype = torch.float64
    device: object = None

    def __post_init__(self):
        space = self.space_to
        mesh = space.mesh
        dev = resolve_device(self.device)
        order_to = space.order
        nq = max(self.order_from, order_to) + 1
        e_from = TensorElement(self.order_from, mesh.h, nquad=nq)
        e_to = TensorElement(order_to, mesh.h, nquad=nq)
        Vt = e_to._phi_table(None)
        Vf = e_from._phi_table(None)
        W = e_to.quad_weights()
        B = np.einsum("iq,jq,q->ij", Vt, Vf, W)     # (n_to_e, n_from_e)
        M = mass_matrix(e_to)                        # (n_to_e, n_to_e)

        conn_to = asm.connectivity(mesh, order_to)   # (ncells, n_to_e)
        free = ~np.asarray(space.dirichlet_mask())
        cell_free = free[conn_to]                    # (ncells, n_to_e) bool
        # constraint-pattern classes: one restricted solve per class
        classes, cls_idx = np.unique(cell_free, axis=0, return_inverse=True)
        Ps = np.zeros((len(classes), B.shape[0], B.shape[1]))
        for c, m in enumerate(classes):
            if not m.any():
                continue
            f = np.where(m)[0]
            Ps[c][f] = np.linalg.solve(M[np.ix_(f, f)], B[f])
        self._P = torch.from_numpy(Ps).to(dev, self.dtype)  # (ncls, n_to_e, n_from_e)
        self._cls = torch.from_numpy(np.asarray(cls_idx, np.int64).reshape(-1)).to(dev)
        _cell_maps(self, asm.connectivity(mesh, self.order_from), conn_to,
                   asm.num_nodes(mesh, order_to), dev, self.dtype)
        self.n_from = asm.num_nodes(mesh, self.order_from)

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        """(n_from,) -> (n_to,): constrained cell-local projection,
        averaged at shared free nodes, exact zeros at constrained dofs."""
        u_cell = u[self._conn_from]                  # (ncells, n_from_e)
        P_cell = self._P[self._cls]                  # (ncells, n_to_e, n_from_e)
        return _scatter_mean(self, torch.einsum("cij,cj->ci", P_cell, u_cell))
