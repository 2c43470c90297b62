"""Poisson model problems with manufactured solutions.

Port of `gridapsolvers_tpu/fem/poisson.py`: -Δu = f on a box with
Dirichlet boundary and an exact polynomial/trig solution. The right-hand
side is assembled on the host in NumPy, as in the JAX package; the
operators and vectors then live on the requested device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..algebra.stencil import StencilMatrix
from ..utils import numpy_dtype, pytrees as pt, resolve_device
from .assembly import (
    eliminate_dirichlet,
    matvec_host,
    q1_bands_host,
    q1_element_matrices,
    q1_offsets,
    q1_stencil,
)
from .mesh import CartesianMesh


@dataclasses.dataclass
class PoissonProblem:
    """Assembled Dirichlet Poisson system on a structured grid."""

    mesh: CartesianMesh
    A: StencilMatrix          # constrained operator (identity on boundary)
    A_full: StencilMatrix     # unconstrained operator (for lifting/errors)
    M: StencilMatrix          # mass matrix (L2 norms)
    b: torch.Tensor
    u_exact: torch.Tensor
    dirichlet_mask: np.ndarray

    @property
    def n(self) -> int:
        return self.A.n

    def l2_error(self, u: torch.Tensor) -> torch.Tensor:
        """||u - u_exact||_L2 via the consistent mass matrix (matches the
        reference's `sqrt(sum(∫(e·e)dΩ))`, KrylovTests.jl:22-25)."""
        e = u - self.u_exact
        return torch.sqrt(pt.dot(e, self.M.matvec(e)))

    def residual_norm(self, u: torch.Tensor) -> torch.Tensor:
        return pt.norm(self.b - self.A.matvec(u))


def default_exact(dim: int) -> Tuple[Callable, Callable]:
    """Manufactured solution u = sum(x) (exactly representable in Q1, like
    the reference's `u(x) = x[1] + x[2]`, KrylovTests.jl:16) and f = 0."""

    def u(xs):
        return sum(xs)

    def f(xs):
        return np.zeros_like(xs[0])

    return u, f


def trig_exact(dim: int):
    ks = [1.0, 2.0, 3.0][:dim]

    def u(xs):
        out = np.ones_like(xs[0])
        for k, x in zip(ks, xs):
            out = out * np.sin(np.pi * k * x)
        return out

    def f(xs):
        return (np.pi ** 2) * sum(k ** 2 for k in ks) * u(xs)

    return u, f


def poisson_problem(
    ncells: Tuple[int, ...],
    domain: Optional[Tuple[float, ...]] = None,
    exact: str = "linear",
    dtype=torch.float64,
    device=None,
) -> PoissonProblem:
    """Build the full Dirichlet Poisson system with manufactured solution."""
    dev = resolve_device(device)
    np_dtype = numpy_dtype(dtype)
    dim = len(ncells)
    if domain is None:
        domain = tuple(x for _ in range(dim) for x in (0.0, 1.0))
    mesh = CartesianMesh(tuple(ncells), domain)
    u_fn, f_fn = trig_exact(dim) if exact == "trig" else default_exact(dim)

    coords = mesh.vertex_coords()
    xs = [coords[:, d] for d in range(dim)]
    u_ex = np.asarray(u_fn(xs), dtype=np_dtype)
    f_nodal = np.asarray(f_fn(xs), dtype=np_dtype)

    Ke, Me = q1_element_matrices(mesh.h)
    A_bands = q1_bands_host(mesh, Ke, np_dtype)
    M_bands = q1_bands_host(mesh, Me, np_dtype)
    mask = mesh.boundary_vertex_mask()

    # right-hand side on the host, the JAX package's arithmetic step by step
    offsets, per = q1_offsets(dim), mesh.periodic
    b_load = matvec_host(M_bands, offsets, per, f_nodal)
    maskf = mask.reshape(-1)
    xg = np.where(maskf, u_ex, 0.0)
    b = b_load - matvec_host(A_bands, offsets, per, xg)
    b = np.where(maskf, u_ex, b).astype(np_dtype)

    A_full = q1_stencil(mesh, A_bands, dtype, dev)
    return PoissonProblem(
        mesh=mesh,
        A=eliminate_dirichlet(A_full, mask),
        A_full=A_full,
        M=q1_stencil(mesh, M_bands, dtype, dev),
        b=torch.from_numpy(b).to(dev),
        u_exact=torch.from_numpy(u_ex).to(dev),
        dirichlet_mask=mask,
    )
