"""General structured-grid assembly for arbitrary-order tensor elements.

Port of `gridapsolvers_tpu/fem/assembly2.py` (host NumPy/scipy, as in the
JAX package). On a uniform mesh every cell shares one element matrix, so
global assembly is a constant-block COO scatter over the vectorized
connectivity, with no element loop. `to_ell` makes the device operator
(an `ELLMatrix`, kernel K3) with an explicit dtype and device.

One step differs in form, not in result: `dirichlet_square` drops the
masked rows' and columns' entries from the COO triplets, where the JAX
package assigns rows and columns of a LIL matrix. Both give the same CSR
(pattern, values and sorted indices); the LIL form grows superlinearly
and would take minutes at 512^2 cells.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp


from ..algebra.ell import ELLMatrix, ell_from_scipy
from .elements import TensorElement, mass_matrix, mixed_divergence, stiffness
from .mesh import CartesianMesh


def node_grid_shape(mesh: CartesianMesh, order: int) -> Tuple[int, ...]:
    """Q_k node grid: order*n+1 nodes per axis; a periodic axis drops the
    duplicate endpoint (order*n nodes) and the connectivity wraps
    (reference CartesianModelHierarchy isperiodic with any reffe,
    ModelHierarchies.jl:85-87)."""
    return tuple(
        order * n if p else order * n + 1
        for n, p in zip(mesh.ncells, mesh.periodic)
    )


def num_nodes(mesh: CartesianMesh, order: int) -> int:
    return int(np.prod(node_grid_shape(mesh, order)))


def node_coords(mesh: CartesianMesh, order: int) -> np.ndarray:
    axes = [
        np.linspace(
            mesh.domain[2 * d],
            mesh.domain[2 * d + 1],
            order * n + 1,
        )[: order * n if p else order * n + 1]
        for d, (n, p) in enumerate(zip(mesh.ncells, mesh.periodic))
    ]
    grids = np.meshgrid(*axes, indexing="ij")
    return np.stack([g.reshape(-1) for g in grids], axis=1)


def connectivity(mesh: CartesianMesh, order: int) -> np.ndarray:
    """(n_cells, n_nodes_per_cell) global node indices, both C-order.
    Periodic axes wrap the per-axis node index modulo the grid extent."""
    d = mesh.dim
    shape = node_grid_shape(mesh, order)
    strides = np.cumprod([1] + list(shape[::-1]))[:-1][::-1]
    cells = np.meshgrid(
        *[np.arange(n) for n in mesh.ncells], indexing="ij"
    )
    elem = TensorElement(order, mesh.h)
    offs = elem.node_offsets()  # (n_nodes, d)
    conn = 0
    for k in range(d):
        idx = (order * cells[k]).reshape(-1)[:, None] + offs[None, :, k]
        if mesh.periodic[k]:
            idx = idx % shape[k]
        conn = conn + idx * strides[k]
    return conn


def boundary_node_mask(
    mesh: CartesianMesh, order: int, tags: str = "boundary"
) -> np.ndarray:
    """Boolean flat mask of boundary nodes of the order-`order` node grid."""
    shape = node_grid_shape(mesh, order)
    mask = np.zeros(shape, dtype=bool)
    if tags == "boundary":
        for d in range(mesh.dim):
            if mesh.periodic[d]:  # a periodic axis has no boundary
                continue
            idx = [slice(None)] * mesh.dim
            idx[d] = 0
            mask[tuple(idx)] = True
            idx[d] = shape[d] - 1
            mask[tuple(idx)] = True
    else:
        # named-label/face-spec resolution is centralized on the mesh
        # (periodic-axis face specs rejected there)
        for d, side in mesh.resolve_tags(tags):
            idx = [slice(None)] * mesh.dim
            idx[d] = 0 if side == 0 else shape[d] - 1
            mask[tuple(idx)] = True
    return mask.reshape(-1)


def scatter_coo(
    conn_rows: np.ndarray,
    conn_cols: np.ndarray,
    Ke: np.ndarray,
    shape: Tuple[int, int],
) -> sp.csr_matrix:
    """Assemble sum over cells of the constant element matrix Ke into CSR."""
    nc = conn_rows.shape[0]
    ni, nj = Ke.shape
    rows = np.repeat(conn_rows, nj, axis=1).reshape(-1)
    cols = np.tile(conn_cols, (1, ni)).reshape(-1)
    vals = np.tile(Ke.reshape(-1), nc)
    return sp.coo_matrix((vals, (rows, cols)), shape=shape).tocsr()


def assemble_bilinear(
    mesh: CartesianMesh,
    order: int,
    kind: str = "stiffness",
    scale: float = 1.0,
) -> sp.csr_matrix:
    """Scalar stiffness/mass for an order-`order` tensor element."""
    elem = TensorElement(order, mesh.h)
    Ke = stiffness(elem) if kind == "stiffness" else mass_matrix(elem)
    conn = connectivity(mesh, order)
    n = num_nodes(mesh, order)
    return scatter_coo(conn, conn, scale * Ke, (n, n))


def assemble_divergence(
    mesh: CartesianMesh, order_u: int, order_p: int, comp: int
) -> sp.csr_matrix:
    """B: (q, -div u_comp) coupling, rows = pressure nodes, cols = velocity
    nodes of component `comp`."""
    elem_u = TensorElement(order_u, mesh.h, nquad=order_u + 1)
    elem_p = TensorElement(order_p, mesh.h, nquad=order_u + 1)
    Be = mixed_divergence(elem_u, elem_p, comp)
    conn_p = connectivity(mesh, order_p)
    conn_u = connectivity(mesh, order_u)
    return scatter_coo(
        conn_p, conn_u, Be, (num_nodes(mesh, order_p), num_nodes(mesh, order_u))
    )


def pdisc_connectivity(mesh: CartesianMesh) -> np.ndarray:
    """(n_cells, dim+1) global P1disc pressure dof ids (cell-major: dof
    m of cell c is c*(dim+1)+m)."""
    nc = int(np.prod(mesh.ncells))
    d = mesh.dim
    return (np.arange(nc)[:, None] * (d + 1) + np.arange(d + 1)[None, :])


def num_pdisc_dofs(mesh: CartesianMesh) -> int:
    return int(np.prod(mesh.ncells)) * (mesh.dim + 1)


def assemble_divergence_pdisc(
    mesh: CartesianMesh, order_u: int, comp: int
) -> sp.csr_matrix:
    """B: (q, -div u_comp) with q in cell-local P1disc (reference
    `space=:P` pressure, StokesGMG.jl:91). Rows = P1disc dofs."""
    from .elements import mixed_divergence_pdisc

    elem_u = TensorElement(order_u, mesh.h, nquad=order_u + 1)
    Be = mixed_divergence_pdisc(elem_u, comp)
    conn_p = pdisc_connectivity(mesh)
    conn_u = connectivity(mesh, order_u)
    return scatter_coo(
        conn_p, conn_u, Be, (num_pdisc_dofs(mesh), num_nodes(mesh, order_u))
    )


def pdisc_mass_matrix(mesh: CartesianMesh) -> sp.csr_matrix:
    """Global P1disc pressure mass: block-diagonal with one (d+1)x(d+1)
    diagonal block per cell (the monomial basis is L2-orthogonal)."""
    from .elements import pdisc_mass

    elem = TensorElement(2, mesh.h, nquad=3)
    Me = pdisc_mass(elem)
    nc = int(np.prod(mesh.ncells))
    return sp.kron(sp.eye(nc), Me, format="csr")


def project_pdisc(mesh: CartesianMesh, fn) -> np.ndarray:
    """L2 projection of fn(x: (npts, dim)) -> (npts,) onto the P1disc
    space, as the flat coefficient vector (cell-major)."""
    from .elements import pdisc_mass, pdisc_table

    elem = TensorElement(2, mesh.h, nquad=3)
    psi = pdisc_table(elem)                       # (d+1, nq)
    W = elem.quad_weights()                       # (nq,)
    Minv = np.linalg.inv(pdisc_mass(elem))
    d = mesh.dim
    grids = np.meshgrid(*[elem.q] * d, indexing="ij")
    qpts = np.stack([g.reshape(-1) for g in grids], axis=1)  # (nq, d)
    cells = np.meshgrid(*[np.arange(n) for n in mesh.ncells], indexing="ij")
    origins = np.stack(
        [
            mesh.domain[2 * k] + cells[k].reshape(-1) * mesh.h[k]
            for k in range(d)
        ],
        axis=1,
    )                                              # (n_cells, d)
    pts = origins[:, None, :] + qpts[None, :, :] * np.asarray(mesh.h)
    vals = fn(pts.reshape(-1, d)).reshape(len(origins), -1)  # (n_cells, nq)
    rhs = np.einsum("mq,q,cq->cm", psi, W, vals)   # (n_cells, d+1)
    return (rhs @ Minv.T).reshape(-1)


def assemble_graddiv(
    mesh: CartesianMesh, order_u: int, alpha: float
) -> "list[list[sp.csr_matrix]]":
    """Global grad-div component blocks G_cd = alpha Bcᵀ M⁻¹ Bd assembled
    from the CELL-LOCAL element blocks (elements.graddiv_element)."""
    from .elements import graddiv_element

    elem_u = TensorElement(order_u, mesh.h, nquad=order_u + 1)
    Ge = graddiv_element(elem_u, alpha)
    conn = connectivity(mesh, order_u)
    n = num_nodes(mesh, order_u)
    return [
        [scatter_coo(conn, conn, Ge[c][d], (n, n)) for d in range(mesh.dim)]
        for c in range(mesh.dim)
    ]


def dirichlet_square(
    S: sp.csr_matrix, mask: np.ndarray
) -> sp.csr_matrix:
    """Symmetric elimination on a square CSR: identity rows, zeroed cols.
    Drops the stored entries of masked rows and columns, then adds the unit
    diagonal of the masked dofs: the same CSR as the JAX package's LIL
    assignment, explicit zeros at free entries kept as LIL keeps them, in
    time linear in the entries."""
    mask = np.asarray(mask, dtype=bool)
    coo = S.tocoo()
    keep = ~(mask[coo.row] | mask[coo.col])
    idx = np.flatnonzero(mask)
    out = sp.csr_matrix(
        (np.concatenate([coo.data[keep], np.ones(len(idx), dtype=S.dtype)]),
         (np.concatenate([coo.row[keep], idx]), np.concatenate([coo.col[keep], idx]))),
        shape=S.shape,
    )
    out.sort_indices()
    return out


def zero_columns(S: sp.csr_matrix, mask: np.ndarray) -> sp.csr_matrix:
    D = sp.diags((~mask).astype(S.dtype))
    return (S @ D).tocsr()


def zero_rows(S: sp.csr_matrix, mask: np.ndarray) -> sp.csr_matrix:
    D = sp.diags((~mask).astype(S.dtype))
    return (D @ S).tocsr()


def to_ell(
    S: sp.csr_matrix, pad_to: Optional[int] = None, dtype=None, device=None
) -> ELLMatrix:
    """`ELLMatrix` of S on `device` (None: the card) in the torch `dtype`
    (None: S's own)."""
    return ell_from_scipy(S, row_width=pad_to, dtype=dtype, device=device)
