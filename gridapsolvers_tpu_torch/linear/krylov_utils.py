"""Shared Krylov machinery.

Port of `gridapsolvers_tpu/linear/krylov_utils.py` (reference
Krylov/KrylovUtils.jl:17-54): preconditioned products and residuals, and
a Krylov basis over vectors stored leafwise with one leading axis of size
m (+1), so a restart cycle allocates its basis once. The small dense work
of a Krylov method (Givens rotations, the triangular solve) runs on the
host, on values read once an iteration (`givens`).
"""
from __future__ import annotations

import math

import torch

from ..utils import pytrees as pt


def krylov_mul(A, Pr_apply, Pl_apply, x):
    """y = Pl⁻¹ · A · Pr⁻¹ · x (reference KrylovUtils.jl:17-32)."""
    z = Pr_apply(x) if Pr_apply is not None else x
    w = A.matvec(z)
    return Pl_apply(w) if Pl_apply is not None else w


def krylov_residual(A, Pl_apply, x, b):
    """r = Pl⁻¹ (b - A x) (reference KrylovUtils.jl:46-54)."""
    r = pt.sub(b, A.matvec(x))
    return Pl_apply(r) if Pl_apply is not None else r


def basis_zeros(template, m: int):
    """A basis of m vectors shaped like `template` (leafwise leading axis)."""
    return pt.tree_map(lambda leaf: torch.zeros((m,) + leaf.shape, dtype=leaf.dtype,
                                                device=leaf.device), template)


def basis_get(basis, j: int):
    """V[j] as a vector (a view)."""
    return pt.tree_map(lambda leaf: leaf[j], basis)


def basis_set(basis, j: int, v):
    """V[j] = v, in place; returns the basis."""
    for leaf, vleaf in zip(pt.tree_leaves(basis), pt.tree_leaves(v)):
        leaf[j] = vleaf
    return basis


def basis_dots(basis, w, nvec: int):
    """dots[k] = <V[k], w> for k < nvec: one (nvec, n) @ (n,) product a
    leaf, summed over the leaves; the sharded leaves' local dots go over
    the ranks as one (nvec,) all-reduce a process mesh."""
    return pt.reduce_terms(
        [(lb[:nvec].reshape(nvec, -1) @ lw.reshape(-1), layout)
         for (lb, layout), (lw, _) in zip(pt.blocks(basis), pt.blocks(w))], "sum")


def basis_combine(basis, coefs: torch.Tensor, nvec: int):
    """sum_{k < nvec} coefs[k] * V[k]; coefs on the basis' device."""
    def comb(leaf):
        c = coefs[:nvec].to(leaf.dtype)
        return (c @ leaf[:nvec].reshape(nvec, -1)).reshape(leaf.shape[1:])

    return pt.tree_map(comb, basis)


def givens(a: float, b: float):
    """Givens rotation (c, s) with c*a + s*b = r, -s*a + c*b = 0."""
    denom = math.sqrt(a * a + b * b)
    if denom > 0:
        return a / denom, b / denom
    return 1.0, 0.0
