"""Linear elasticity (vector Q1 on structured grids).

Port of `gridapsolvers_tpu/fem/elasticity.py`. Mirrors the reference's
elasticity application (test/Applications/Elasticity.jl + ext
PETScElasticitySolver, ElasticitySolvers.jl:15-44): a(u,v) = ∫ 2μ ε(u):ε(v)
+ λ div u div v with clamped-face Dirichlet BCs, solved by GMG-preconditioned
CG. The operator is a d x d `BlockOperator` of banded `StencilMatrix`
blocks on the Q1 vertex grid (3^d offsets, kernel K2's box kernel in 3D).

One step differs in form, not in result: the JAX package scatters each
block's element matrix into a scipy COO matrix and bands it
(`stencil_from_scipy`); at 128^3 cells that is 134 M COO entries a block.
Here each block's bands are summed straight from its element matrix
(`fem.assembly.q1_bands_host`), the Dirichlet rows and columns zeroed in
the bands, and the offsets kept as the JAX package keeps them: all 3^d
without an elimination; after one, those that hold a nonzero entry, in
sorted order, the centre appended last when it holds none. The operators agree with the JAX package's to round-off (the
sums run in another order).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..algebra import BlockOperator
from ..algebra.stencil import StencilMatrix
from ..utils import pytrees as pt
from ..utils import numpy_dtype, resolve_device
from . import assembly2 as asm
from .assembly import matvec_host, q1_bands_host, q1_element_matrices, q1_offsets
from .elements import TensorElement
from .mesh import CartesianMesh


def elastic_element_blocks(mesh: CartesianMesh, mu: float, lam: float):
    """Per-component-pair element matrices B_ab (n_nodes, n_nodes):
    B_ab[i,j] = mu δ_ab Σ_c ∫∂_c φ_i ∂_c φ_j + mu ∫ ∂_b φ_i ∂_a φ_j
                + lam ∫ ∂_a φ_i ∂_b φ_j ."""
    d = mesh.dim
    elem = TensorElement(1, mesh.h, nquad=2)
    W = elem.quad_weights()
    G = [elem._phi_table(c) for c in range(d)]
    Kcd = {}
    for a in range(d):
        for b in range(d):
            Kcd[(a, b)] = np.einsum("iq,jq,q->ij", G[a], G[b], W)
    blocks = {}
    for a in range(d):
        for b in range(d):
            B = mu * Kcd[(b, a)] + lam * Kcd[(a, b)]
            if a == b:
                B = B + mu * sum(Kcd[(c, c)] for c in range(d))
            blocks[(a, b)] = B
    return blocks


@dataclasses.dataclass
class ElasticityProblem:
    mesh: CartesianMesh
    A: BlockOperator            # d x d vector-elasticity operator
    b: Tuple[torch.Tensor, ...]
    dirichlet_mask: np.ndarray  # per-node (scalar grid) clamped mask
    mu: float
    lam: float

    def residual_norm(self, u) -> float:
        return float(pt.norm(pt.sub(self.b, self.A.matvec(u))))


def _eliminated_bands(bands: np.ndarray, offsets, mask: Optional[np.ndarray],
                      diagonal: bool) -> np.ndarray:
    """Zero the rows and columns of the masked dofs in host bands (in
    place); a diagonal block gets the identity on its masked rows."""
    if mask is None:
        return bands
    gs = bands.shape[1:]
    m = np.asarray(mask, dtype=bool).reshape(gs)
    for s, off in enumerate(offsets):
        # band_s[v] multiplies x[v + off]: zero it where v or v + off is masked
        hit = m.copy()
        src = tuple(slice(max(o, 0), n + min(o, 0)) for o, n in zip(off, gs))
        dst = tuple(slice(max(-o, 0), n + min(-o, 0)) for o, n in zip(off, gs))
        hit[dst] |= m[src]
        bands[s][hit] = 0.0
        if diagonal and not any(off):
            bands[s][m] = 1.0
    return bands


def elasticity_operator(
    mesh: CartesianMesh,
    mu: float,
    lam: float,
    dirichlet_mask: Optional[np.ndarray] = None,
    dtype=torch.float64,
    device=None,
) -> BlockOperator:
    """Assemble the d x d block operator in the torch `dtype` on `device`;
    if dirichlet_mask is given (scalar node mask, applied to every
    component), rows/cols are eliminated symmetrically (identity on
    diagonal blocks)."""
    dev = resolve_device(device)
    d = mesh.dim
    eb = elastic_element_blocks(mesh, mu, lam)
    offsets = q1_offsets(d)
    center = offsets.index((0,) * d)
    rows = []
    for a in range(d):
        row = []
        for b in range(d):
            bands = _eliminated_bands(q1_bands_host(mesh, eb[(a, b)]), offsets,
                                      dirichlet_mask, a == b)
            # every offset of the scattered pattern; after an elimination
            # (whose scipy products drop exact zeros) those that hold an entry
            keep = [s for s in range(len(offsets)) if s != center and (
                dirichlet_mask is None or np.any(bands[s] != 0.0))]
            if dirichlet_mask is None or np.any(bands[center] != 0.0):
                keep.insert(sum(s < center for s in keep), center)
            else:
                keep.append(center)
            row.append(StencilMatrix(
                torch.from_numpy(np.ascontiguousarray(bands[keep])).to(dev, dtype),
                tuple(offsets[s] for s in keep),
                mesh.vertex_shape,
            ))
        rows.append(tuple(row))
    return BlockOperator(tuple(rows))


def elasticity_problem(
    ncells: Tuple[int, ...],
    mu: float = 1.0,
    lam: float = 1.0,
    body_force: Optional[Tuple[float, ...]] = None,
    clamp: str = "x0",
    dtype=torch.float64,
    device=None,
) -> ElasticityProblem:
    """Cantilever-style problem: clamped on the `clamp` face, loaded by a
    constant body force (default: unit downward load)."""
    dev = resolve_device(device)
    dim = len(ncells)
    domain = tuple(x for _ in range(dim) for x in (0.0, 1.0))
    mesh = CartesianMesh(tuple(ncells), domain)
    mask = asm.boundary_node_mask(mesh, 1, tags=(clamp,))
    A = elasticity_operator(mesh, mu, lam, mask, dtype=dtype, device=dev)

    if body_force is None:
        body_force = tuple([0.0] * (dim - 1) + [-1.0])
    _, Me = q1_element_matrices(mesh.h)
    mass_bands = q1_bands_host(mesh, Me)
    per = tuple(mesh.periodic)
    n = asm.num_nodes(mesh, 1)
    b = []
    for c in range(dim):
        f = np.full(n, body_force[c])
        bc = matvec_host(mass_bands, q1_offsets(dim), per, f)
        b.append(torch.from_numpy(np.where(mask, 0.0, bc).astype(numpy_dtype(dtype)))
                 .to(dev))
    return ElasticityProblem(
        mesh=mesh, A=A, b=tuple(b), dirichlet_mask=mask, mu=mu, lam=lam
    )


def elasticity_gmg(
    ncells: Tuple[int, ...],
    num_levels: int,
    mu: float = 1.0,
    lam: float = 1.0,
    clamp: str = "x0",
    smoother=None,
    dtype=torch.float64,
    device=None,
    **kw,
):
    """GMG preconditioner with per-level reassembled elasticity operators
    and fieldwise structured transfers: the native replacement for the
    reference's PETSc GAMG elasticity solve. `kw` goes to GMGSolver."""
    from ..linear.gmg import GMGSolver
    from ..linear.smoothers import ChebyshevSmoother
    from ..multilevel.hierarchy import cartesian_hierarchy
    from ..multilevel.multifield import MultiFieldTransfer
    from ..multilevel.transfer import (
        StructuredProlongation,
        StructuredRestriction,
    )

    dev = resolve_device(device)
    dim = len(ncells)
    hierarchy = cartesian_hierarchy(ncells, num_levels)

    def level_op(mesh):
        mask = asm.boundary_node_mask(mesh, 1, tags=(clamp,))
        return elasticity_operator(mesh, mu, lam, mask, dtype=dtype, device=dev)

    def free(mesh):
        m = ~asm.boundary_node_mask(mesh, 1, tags=(clamp,))
        return torch.from_numpy(m.astype(np.float64)).to(dev, dtype)

    prolongs, restricts = [], []
    for l in range(num_levels - 1):
        fine, coarse = hierarchy[l], hierarchy[l + 1]
        mf, mc = free(fine), free(coarse)
        P = StructuredProlongation(fine.vertex_shape, coarse.vertex_shape, mf)
        R = StructuredRestriction(
            fine.vertex_shape, coarse.vertex_shape, "residual", mc, mf
        )
        prolongs.append(MultiFieldTransfer(tuple(P for _ in range(dim))))
        restricts.append(MultiFieldTransfer(tuple(R for _ in range(dim))))

    coarse_ops = tuple(level_op(m) for m in hierarchy.meshes[1:])
    return GMGSolver(
        coarse_ops=coarse_ops,
        prolongations=tuple(prolongs),
        restrictions=tuple(restricts),
        smoother=smoother or ChebyshevSmoother(degree=4, ratio=40.0),
        **kw,
    )
