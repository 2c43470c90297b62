"""Nullspace representation and orthogonalization utilities.

Port of `gridapsolvers_tpu/interfaces/nullspaces.py` (reference
SolverInterfaces/NullSpaces.jl:1-26,67-139): a span-of-vectors kernel
representation with classical/modified Gram-Schmidt orthonormalization
and projection/orthogonalization. Vectors are tensors or tuples of
tensors.
"""
from __future__ import annotations

import dataclasses

import torch

from ..utils.pytrees import axpy, dot, scale, tree_map


@dataclasses.dataclass
class NullSpace:
    """Kernel of an operator, spanned by `vectors` (a list of vectors).

    Reference: NullSpaces.jl:17-26.
    """

    vectors: list

    @property
    def num_vectors(self) -> int:
        return len(self.vectors)


def constant_nullspace(template) -> NullSpace:
    """Nullspace of operators defined up to a constant (pure-Neumann
    Poisson, Darcy pressure). `template` gives shape, dtype and device."""
    return NullSpace(vectors=[tree_map(torch.ones_like, template)])


def make_orthonormal(ns: NullSpace, method: str = "modified") -> NullSpace:
    """Gram-Schmidt orthonormalization of the spanning set.

    method: 'classical' | 'modified' (reference NullSpaces.jl:67-100).
    """
    out = []
    for v in ns.vectors:
        w = v
        if method == "classical":
            coefs = [dot(u, v) for u in out]
            for u, c in zip(out, coefs):
                w = axpy(-c, u, w)
        else:  # modified
            for u in out:
                w = axpy(-dot(u, w), u, w)
        out.append(scale(1.0 / torch.sqrt(dot(w, w)), w))
    return NullSpace(vectors=out)


def _stack(coefs, like):
    if coefs:
        return torch.stack(coefs)
    return torch.zeros((0,), dtype=like.dtype, device=like.device)


def make_orthogonal(ns: NullSpace, x):
    """Remove the nullspace components from x: x -= sum_i <q_i,x> q_i.

    Assumes `ns` orthonormal (reference NullSpaces.jl:121-139).
    Returns (x_orth, coefficients).
    """
    coefs = []
    for q in ns.vectors:
        c = dot(q, x)
        x = axpy(-c, q, x)
        coefs.append(c)
    return x, _stack(coefs, _leaf(x))


def project(ns: NullSpace, x):
    """Project x onto span(ns): returns sum_i <q_i,x> q_i and the
    coefficients (reference NullSpaces.jl:102-112)."""
    coefs = [dot(q, x) for q in ns.vectors]
    out = tree_map(torch.zeros_like, x)
    for q, c in zip(ns.vectors, coefs):
        out = axpy(c, q, out)
    return out, _stack(coefs, _leaf(x))


def reconstruct(ns: NullSpace, x, coefs):
    """Add back previously removed components: x + sum_i c_i q_i
    (reference NullSpaces.jl:114-119)."""
    for i, q in enumerate(ns.vectors):
        x = axpy(coefs[i], q, x)
    return x


def _leaf(x):
    return x if isinstance(x, torch.Tensor) else _leaf(x[0])


def rigid_body_modes(coords: torch.Tensor) -> NullSpace:
    """Near-nullspace for elasticity: translations and rotations from dof
    coordinates (reference PETScElasticitySolver,
    ext/GridapPETScExt/ElasticitySolvers.jl:83-108).

    coords: (n_nodes, dim) nodal coordinates; dofs ordered node-major with
    `dim` components per node. Returns an orthonormalized NullSpace of 3
    (2D) or 6 (3D) flat vectors of length n_nodes * dim.
    """
    n, dim = coords.shape
    modes = []
    for d in range(dim):  # translations
        m = torch.zeros((n, dim), dtype=coords.dtype, device=coords.device)
        m[:, d] = 1.0
        modes.append(m.reshape(-1))
    if dim == 2:
        modes.append(torch.stack([-coords[:, 1], coords[:, 0]], dim=1).reshape(-1))
    elif dim == 3:
        x, y, z = coords[:, 0], coords[:, 1], coords[:, 2]
        zero = torch.zeros_like(x)
        for rx, ry, rz in ((zero, -z, y), (z, zero, -x), (-y, x, zero)):
            modes.append(torch.stack([rx, ry, rz], dim=1).reshape(-1))
    return make_orthonormal(NullSpace(vectors=modes))
