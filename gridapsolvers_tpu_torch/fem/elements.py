"""Tensor-product reference elements and quadrature (host-side NumPy).

Port of `gridapsolvers_tpu/fem/elements.py`, carried over unchanged (the
module is pure NumPy): 1D Lagrange shape functions (P1: 2 nodes, P2: 3
nodes) tabulated at Gauss points, tensor products over dimensions, and
bilinear-form element matrices by quadrature. On a uniform mesh every cell
shares one element matrix, so global assembly is a constant-block scatter
(fem/assembly2.py).
"""
from __future__ import annotations

import itertools
from typing import Sequence, Tuple

import numpy as np


def gauss_1d(npts: int) -> Tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre points/weights on [0, 1]."""
    x, w = np.polynomial.legendre.leggauss(npts)
    return 0.5 * (x + 1.0), 0.5 * w


def lagrange_1d(order: int, pts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Values and derivatives of the order-`order` Lagrange basis on [0,1]
    (equispaced nodes) at `pts`. Returns (vals, derivs) of shape
    (n_nodes, n_pts)."""
    nodes = np.linspace(0.0, 1.0, order + 1)
    n = len(nodes)
    vals = np.ones((n, len(pts)))
    derivs = np.zeros((n, len(pts)))
    for i in range(n):
        for j in range(n):
            if j == i:
                continue
            vals[i] *= (pts - nodes[j]) / (nodes[i] - nodes[j])
        # derivative via sum-product rule
        s = np.zeros(len(pts))
        for k in range(n):
            if k == i:
                continue
            term = np.ones(len(pts)) / (nodes[i] - nodes[k])
            for j in range(n):
                if j in (i, k):
                    continue
                term *= (pts - nodes[j]) / (nodes[i] - nodes[j])
            s += term
        derivs[i] = s
    return vals, derivs


class TensorElement:
    """Tensor-product Lagrange element of per-dim `order` on a box cell.

    Node ordering: C-order over the per-dim node indices (matches the
    structured-grid global numbering used by fem/assembly2.py).
    """

    def __init__(self, order: int, h: Sequence[float], nquad: int = None):
        self.order = order
        self.h = tuple(h)
        self.dim = len(h)
        nq = nquad or (order + 1)
        self.q, self.w = gauss_1d(nq)
        # per-dim tabulations on the physical cell [0,h_d]
        self.vals, self.derivs, self.wq = [], [], []
        for d in range(self.dim):
            v, g = lagrange_1d(order, self.q)
            self.vals.append(v)                      # (nodes, q)
            self.derivs.append(g / self.h[d])        # d/dx on physical cell
            self.wq.append(self.w * self.h[d])
        self.nodes_per_dim = order + 1
        self.n_nodes = self.nodes_per_dim ** self.dim

    def node_offsets(self) -> np.ndarray:
        """(n_nodes, dim) per-dim node indices in C-order."""
        return np.array(
            list(itertools.product(range(self.nodes_per_dim), repeat=self.dim))
        )

    def _phi_table(self, grad_dim: int | None):
        """phi[node, q_multi] over the tensor quadrature grid; if grad_dim is
        not None, differentiate in that dimension."""
        tabs = []
        for d in range(self.dim):
            tabs.append(self.derivs[d] if d == grad_dim else self.vals[d])
        # tensor product over dims: result (n_nodes, nq^dim)
        out = None
        for d, t in enumerate(tabs):
            out = t if out is None else np.einsum("iq,jp->ijqp", out, t).reshape(
                out.shape[0] * t.shape[0], -1
            )
        return out

    def quad_weights(self) -> np.ndarray:
        out = None
        for wq in self.wq:
            out = wq if out is None else np.outer(out, wq).reshape(-1)
        return out


def stiffness(elem: TensorElement) -> np.ndarray:
    """∫ grad(u)·grad(v): (n_nodes, n_nodes)."""
    W = elem.quad_weights()
    K = np.zeros((elem.n_nodes, elem.n_nodes))
    for d in range(elem.dim):
        G = elem._phi_table(d)
        K += np.einsum("iq,jq,q->ij", G, G, W)
    return K


def mass_matrix(elem: TensorElement) -> np.ndarray:
    """∫ u v."""
    V = elem._phi_table(None)
    W = elem.quad_weights()
    return np.einsum("iq,jq,q->ij", V, V, W)


def mixed_divergence(
    elem_u: TensorElement, elem_p: TensorElement, comp: int
) -> np.ndarray:
    """B_e[p_node, u_node] = -∫ p * d(u_comp)/dx_comp over the cell
    (the (q, div u) coupling of Stokes/Darcy). Both elements must share the
    cell size and quadrature count."""
    Vp = elem_p._phi_table(None)
    Gu = elem_u._phi_table(comp)
    W = elem_u.quad_weights()
    return -np.einsum("iq,jq,q->ij", Vp, Gu, W)


def pdisc_table(elem_u: TensorElement) -> np.ndarray:
    """psi[m, q]: the discontinuous-P1 monomial basis {1, xi_1, .., xi_d}
    tabulated on elem_u's tensor quadrature grid, with xi_d = x_d/h_d - 1/2
    in [-1/2, 1/2] (the reference's `space=:P` cell-local linear pressure,
    StokesGMG.jl:91)."""
    dim = elem_u.dim
    grids = np.meshgrid(*[elem_u.q] * dim, indexing="ij")
    nq = grids[0].size
    psi = np.ones((dim + 1, nq))
    for a in range(dim):
        psi[1 + a] = grids[a].reshape(-1) - 0.5
    return psi


def mixed_divergence_pdisc(elem_u: TensorElement, comp: int) -> np.ndarray:
    """B_e[m, u_node] = -∫ psi_m d(u_comp)/dx_comp with psi the cell-local
    P1disc basis: the Stokes divergence coupling for discontinuous
    pressure."""
    psi = pdisc_table(elem_u)
    Gu = elem_u._phi_table(comp)
    W = elem_u.quad_weights()
    return -np.einsum("mq,jq,q->mj", psi, Gu, W)


def pdisc_mass(elem_u: TensorElement) -> np.ndarray:
    """(d+1, d+1) cell-local P1disc mass (diagonal: the monomials are
    L2-orthogonal on the box)."""
    psi = pdisc_table(elem_u)
    W = elem_u.quad_weights()
    return np.einsum("mq,nq,q->mn", psi, psi, W)


def graddiv_element(
    elem_u: TensorElement, alpha: float
) -> "list[list[np.ndarray]]":
    """Cell-local augmented-Lagrangian element blocks

        G_cd = alpha * B_cᵀ M⁻¹ B_d,   B_c = (psi, ∂_c φ),  M = (psi, psi)

    — the matrix of alpha ∫ (∇·v) Π_Q(∇·u) with Π_Q the cell-local L2
    projection onto P1disc (reference LocalProjectionMap / graddiv biform,
    StokesGMG.jl:107-109). Cell-locality is what makes ker(G) decompose
    over vertex patches, i.e. what makes patch smoothers alpha-robust."""
    Minv = np.linalg.inv(pdisc_mass(elem_u))
    Bs = [mixed_divergence_pdisc(elem_u, c) for c in range(elem_u.dim)]
    return [
        [alpha * (Bs[c].T @ (Minv @ Bs[d])) for d in range(elem_u.dim)]
        for c in range(elem_u.dim)
    ]


def convection(elem: TensorElement, w_nodal: np.ndarray) -> np.ndarray:
    """C_e[i,j] = ∫ (w·grad(u_j)) v_i with w the per-cell nodal velocity,
    w_nodal: (n_cells?, dim, n_nodes) — see fem/assembly2.py vectorized use.
    Here returns the per-quad tables needed: callers use einsum directly."""
    raise NotImplementedError("use assembly2.convection_matrices")
