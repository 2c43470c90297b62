"""Q1 FEM assembly on structured grids -> stencil operators.

Port of `gridapsolvers_tpu/fem/assembly.py`. Assembly is band-wise and
vectorized on the host in NumPy, exactly as in the JAX package: for each
pair of element corners (a, b) the element matrix entry Ke[a,b] is added
onto the band at offset b - a over a slab of the vertex grid. The bands
then move once to the requested device and dtype.
"""
from __future__ import annotations

import itertools
from typing import Sequence

import numpy as np
import torch

from ..algebra.stencil import ConstStencilMatrix, StencilMatrix, shift
from ..utils import numpy_dtype, resolve_device
from .mesh import CartesianMesh


def _k1(h: float) -> np.ndarray:
    """1D P1 element stiffness on [0,h]."""
    return np.array([[1.0, -1.0], [-1.0, 1.0]]) / h


def _m1(h: float) -> np.ndarray:
    """1D P1 element mass on [0,h]."""
    return np.array([[2.0, 1.0], [1.0, 2.0]]) * (h / 6.0)


def q1_element_matrices(h: Sequence[float]):
    """(Ke, Me): Q1 element stiffness/mass, shape (2,)*d + (2,)*d tensors
    flattened to (2^d, 2^d) with corner index = C-order over dims."""
    d = len(h)
    Ke = np.zeros((2 ** d, 2 ** d))
    Me = np.ones((1, 1))
    for dim in range(d):
        Me = np.kron(Me, _m1(h[dim]))
    for deriv_dim in range(d):
        term = np.ones((1, 1))
        for dim in range(d):
            term = np.kron(term, _k1(h[dim]) if dim == deriv_dim else _m1(h[dim]))
        Ke += term
    return Ke, Me


def _corner_offsets(d: int):
    """C-order corners of the unit cube: corner index -> offset tuple."""
    return list(itertools.product((0, 1), repeat=d))


def q1_offsets(d: int):
    """The 3^d stencil offsets in sorted order (the band order)."""
    return tuple(sorted(itertools.product((-1, 0, 1), repeat=d)))


def q1_bands_host(
    mesh: CartesianMesh, element_matrix: np.ndarray, dtype=np.float64
) -> np.ndarray:
    """Host (NumPy) bands of a Q1 operator from a (2^d, 2^d) element
    matrix, in `q1_offsets` order."""
    d = mesh.dim
    shape = mesh.vertex_shape
    corners = _corner_offsets(d)
    offsets = q1_offsets(d)
    off_index = {o: i for i, o in enumerate(offsets)}
    bands = np.zeros((len(offsets),) + shape, dtype=dtype)
    for ia, a in enumerate(corners):
        for ib, b in enumerate(corners):
            o = tuple(b[k] - a[k] for k in range(d))
            # element at cell c contributes Ke[a,b] to A[c+a, c+b];
            # vertices v = c + a span [a_k, ncells_k + a_k) per dim.
            # Periodic axes: cell indices wrap, so (c + a_k) mod n covers
            # every vertex exactly once -> whole-axis slab.
            sl = tuple(
                slice(None)
                if mesh.periodic[k]
                else slice(a[k], mesh.ncells[k] + a[k])
                for k in range(d)
            )
            bands[off_index[o]][sl] += element_matrix[ia, ib]
    return bands


def q1_var_bands_host(
    mesh: CartesianMesh,
    element_matrix: np.ndarray,
    cell_values: np.ndarray,
    dtype=np.float64,
) -> np.ndarray:
    """Host bands of a Q1 operator with a per-cell scalar coefficient: the
    element matrix of cell c is cell_values[c] * element_matrix. Each
    corner pair (a, b) adds Ke[a,b] * kappa over a whole slab (no per-cell
    loop); on a periodic axis the coefficient wraps by `np.roll`, as in
    the JAX package."""
    d = mesh.dim
    shape = mesh.vertex_shape
    kappa = np.asarray(cell_values, dtype=dtype).reshape(mesh.ncells)
    corners = _corner_offsets(d)
    offsets = q1_offsets(d)
    off_index = {o: i for i, o in enumerate(offsets)}
    bands = np.zeros((len(offsets),) + shape, dtype=dtype)
    for ia, a in enumerate(corners):
        for ib, b in enumerate(corners):
            o = tuple(b[k] - a[k] for k in range(d))
            # vertex v = c + a receives Ke[a,b] * kappa[c]; per axis the
            # target rows are [a_k, ncells_k + a_k) (open) or all rows with
            # kappa rolled by +a_k (periodic wrap)
            kap = kappa
            sl = []
            for k in range(d):
                if mesh.periodic[k]:
                    kap = np.roll(kap, a[k], axis=k)
                    sl.append(slice(None))
                else:
                    sl.append(slice(a[k], mesh.ncells[k] + a[k]))
            bands[off_index[o]][tuple(sl)] += element_matrix[ia, ib] * kap
    return bands


def matvec_host(bands, offsets, periodic, x) -> np.ndarray:
    """Pure-NumPy banded matvec for setup-time host paths (RHS lifting)."""
    xg = np.asarray(x).reshape(bands.shape[1:])
    d = xg.ndim
    lo = [max(-min(o[k] for o in offsets), 0) for k in range(d)]
    hi = [max(max(o[k] for o in offsets), 0) for k in range(d)]
    xp = xg
    for k in range(d):
        mode = "wrap" if periodic[k] else "constant"
        pw = [(0, 0)] * d
        pw[k] = (lo[k], hi[k])
        xp = np.pad(xp, pw, mode=mode)
    y = np.zeros_like(xg)
    for s, off in enumerate(offsets):
        sl = tuple(
            slice(lo[k] + off[k], lo[k] + off[k] + xg.shape[k]) for k in range(d)
        )
        y += bands[s] * xp[sl]
    return y.reshape(-1)


def q1_stencil(mesh, bands: np.ndarray, dtype, device) -> StencilMatrix:
    """Host Q1 bands of `mesh` -> StencilMatrix on `device` in `dtype`."""
    return StencilMatrix(
        torch.from_numpy(bands).to(device=resolve_device(device), dtype=dtype),
        q1_offsets(mesh.dim),
        mesh.vertex_shape,
        periodic=tuple(mesh.periodic),
    )


def assemble_q1_stencil(
    mesh: CartesianMesh,
    element_matrix: np.ndarray,
    dtype=torch.float64,
    device=None,
) -> StencilMatrix:
    """Assemble a Q1 operator band-wise from a (2^d, 2^d) element matrix."""
    bands = q1_bands_host(mesh, element_matrix, numpy_dtype(dtype))
    return q1_stencil(mesh, bands, dtype, device)


def assemble_q1_stencil_var(
    mesh: CartesianMesh,
    element_matrix: np.ndarray,
    cell_values: np.ndarray,
    dtype=torch.float64,
    device=None,
) -> StencilMatrix:
    """Q1 operator with a per-cell scalar coefficient (exact for
    piecewise-constant coefficients)."""
    bands = q1_var_bands_host(mesh, element_matrix, cell_values, numpy_dtype(dtype))
    return q1_stencil(mesh, bands, dtype, device)


def laplacian_var(
    mesh: CartesianMesh, kappa: np.ndarray, dtype=torch.float64, device=None
) -> StencilMatrix:
    """-div(kappa grad u) with piecewise-constant (per-cell) kappa."""
    Ke, _ = q1_element_matrices(mesh.h)
    return assemble_q1_stencil_var(mesh, Ke, kappa, dtype, device)


def assemble_poisson_stencil(
    grid_shape: Sequence[int],
    h: Sequence[float],
    dtype=torch.float64,
    dirichlet_mask: np.ndarray = None,
    device=None,
) -> StencilMatrix:
    """Q1 Laplacian bands on a uniform vertex grid of `grid_shape`, with
    the dofs of `dirichlet_mask` eliminated (identity rows, zeroed
    columns)."""
    ncells = tuple(n - 1 for n in grid_shape)
    domain = tuple(x for k in range(len(ncells)) for x in (0.0, h[k] * ncells[k]))
    mesh = CartesianMesh(ncells, domain)
    Ke, _ = q1_element_matrices(h)
    A = assemble_q1_stencil(mesh, Ke, dtype, device)
    if dirichlet_mask is not None:
        A = eliminate_dirichlet(A, np.asarray(dirichlet_mask))
    return A


def laplacian(mesh: CartesianMesh, dtype=torch.float64, device=None) -> StencilMatrix:
    Ke, _ = q1_element_matrices(mesh.h)
    return assemble_q1_stencil(mesh, Ke, dtype, device)


def mass(mesh: CartesianMesh, dtype=torch.float64, device=None) -> StencilMatrix:
    _, Me = q1_element_matrices(mesh.h)
    return assemble_q1_stencil(mesh, Me, dtype, device)


def laplacian_const(
    mesh: CartesianMesh, dtype=torch.float64, device=None
) -> ConstStencilMatrix:
    """Dirichlet-eliminated Q1 Laplacian as a matrix-free constant stencil
    (exact for full-boundary Dirichlet on a uniform mesh; see
    algebra.stencil.ConstStencilMatrix)."""
    np_dtype = numpy_dtype(dtype)
    dev = resolve_device(device)
    d = mesh.dim
    Ke, _ = q1_element_matrices(mesh.h)
    corners = _corner_offsets(d)
    offsets = q1_offsets(d)
    off_index = {o: i for i, o in enumerate(offsets)}
    weights = np.zeros(len(offsets), dtype=np_dtype)
    # interior row: every corner pair contributes once per shared cell
    for ia, a in enumerate(corners):
        for ib, b in enumerate(corners):
            o = tuple(b[k] - a[k] for k in range(d))
            weights[off_index[o]] += Ke[ia, ib]
    free = (~mesh.boundary_vertex_mask()).astype(np_dtype)
    return ConstStencilMatrix(
        torch.from_numpy(weights).to(dev),
        torch.from_numpy(free.reshape(mesh.vertex_shape)).to(dev),
        offsets,
        mesh.vertex_shape,
    )


def eliminate_dirichlet(A: StencilMatrix, mask: np.ndarray) -> StencilMatrix:
    """Constrain dofs in `mask` (host bool array): identity rows, zeroed
    columns. Runs on the bands' device; it only selects values, so the
    result equals the JAX package's host elimination bit for bit."""
    m = torch.as_tensor(
        np.asarray(mask, dtype=bool).reshape(A.grid_shape), device=A.device
    )
    center = A.offsets.index(tuple(0 for _ in A.grid_shape))
    per = A._periodic()
    bands = A.bands.clone()
    for s, off in enumerate(A.offsets):
        if s == center:
            # identity on constrained rows
            bands[s] = torch.where(m, 1.0, bands[s])
            continue
        # zero constrained rows, and columns pointing at constrained dofs:
        # band_s[v] multiplies x[v + off], so kill it where mask[v + off]
        bands[s] = torch.where(m | shift(m, off, per), 0.0, bands[s])
    return StencilMatrix(bands, A.offsets, A.grid_shape, A.periodic)


def dirichlet_rhs(
    A_full: StencilMatrix, b: torch.Tensor, mask: np.ndarray, g: torch.Tensor
) -> torch.Tensor:
    """Lift Dirichlet data into the RHS: b := b - A @ x_g off the boundary,
    b := g on the boundary (pairs with eliminate_dirichlet)."""
    maskf = torch.as_tensor(np.asarray(mask, dtype=bool).reshape(-1), device=b.device)
    xg = torch.where(maskf, g, 0.0)
    b = b - A_full.matvec(xg)
    return torch.where(maskf, g, b)
