"""The port's two-float arithmetic (`utils/compensated`) and linear
iterative refinement (`linear/refinement`) against the JAX package.

The error-free transforms and compensated matvecs are elementwise f32
code in both packages, one operation at a time, so they must agree bit
for bit in f32 (JAX's x64 switch does not change f32 arithmetic). The
refinement solve is held to the JAX test's own bounds
(tests/test_refinement.py:176-177): the f64 relative residual of the
f32-stored system below 1e-10 and below 1e-2 of the plain f32 solve's.
"""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from gridapsolvers_tpu.algebra.stencil import StencilMatrix as JStencil
from gridapsolvers_tpu.utils import compensated as jc

from gridapsolvers_tpu_torch.algebra import ell_from_scipy
from gridapsolvers_tpu_torch.fem import CartesianMesh, poisson_problem
from gridapsolvers_tpu_torch.fem.assembly import eliminate_dirichlet, laplacian
from gridapsolvers_tpu_torch.linear import (
    CGSolver,
    ChebyshevSmoother,
    DenseInverseSolver,
    IterativeRefinementSolver,
    comp_residual,
)
from gridapsolvers_tpu_torch.linear.gmg import gmg_from_hierarchy
from gridapsolvers_tpu_torch.multilevel import cartesian_hierarchy
from gridapsolvers_tpu_torch.utils import compensated as tc

torch.set_num_threads(1)


def _f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _same(t, j):
    """A torch tensor and a JAX array hold the same f32 bits."""
    a, b = t.numpy(), np.asarray(j)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("fn", ["two_sum", "fast_two_sum", "two_prod"])
def test_error_free_transforms_bit_equal(fn):
    rng = np.random.default_rng(0)
    a, b = _f32(rng, 4096), _f32(rng, 4096, scale=1e-3)
    out = getattr(tc, fn)(torch.from_numpy(a), torch.from_numpy(b))
    jout = getattr(jc, fn)(jnp.asarray(a), jnp.asarray(b))
    for t, j in zip(out, jout):
        _same(t, j)


def test_error_free_transforms_are_exact():
    """s + e == a + b and p + e == a * b exactly (the JAX test's check)."""
    rng = np.random.default_rng(1)
    a, b = _f32(rng, 512), _f32(rng, 512)
    s, e = tc.two_sum(torch.from_numpy(a), torch.from_numpy(b))
    exact = a.astype(np.float64) + b.astype(np.float64)
    assert np.abs(s.double().numpy() + e.double().numpy() - exact).max() == 0.0
    p, e = tc.two_prod(torch.from_numpy(a), torch.from_numpy(b))
    exactp = a.astype(np.float64) * b.astype(np.float64)
    assert np.abs(p.double().numpy() + e.double().numpy() - exactp).max() < 1e-12
    hi, lo = tc.df_add(s, e, p, e)
    jhi, jlo = jc.df_add(jnp.asarray(s.numpy()), jnp.asarray(e.numpy()),
                         jnp.asarray(p.numpy()), jnp.asarray(e.numpy()))
    _same(hi, jhi)
    _same(lo, jlo)


@pytest.mark.parametrize("with_lo", [False, True])
def test_comp_ell_matvec_bit_equal_and_tight(with_lo):
    """α-scaled cancelling rows (the JAX test's case): bit-equal to JAX,
    and the (hi, lo) pair 1e-4 x closer to the f64 product than a plain
    f32 sum."""
    rng = np.random.default_rng(0)
    n, K, alpha = 2048, 16, 1e3
    cols = rng.integers(0, n, size=(n, K)).astype(np.int32)
    vals = rng.normal(size=(n, K)) * alpha
    vals[:, -1] = -vals[:, :-1].sum(1) + 1e-4 * rng.normal(size=n)
    vals = vals.astype(np.float32)
    x = _f32(rng, n)
    x_lo = _f32(rng, n, scale=1e-8) if with_lo else None
    hi, lo = tc.comp_ell_matvec(torch.from_numpy(vals), torch.from_numpy(cols),
                                torch.from_numpy(x),
                                None if x_lo is None else torch.from_numpy(x_lo))
    jhi, jlo = jc.comp_ell_matvec(jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(x),
                                  None if x_lo is None else jnp.asarray(x_lo))
    _same(hi, jhi)
    _same(lo, jlo)
    if not with_lo:
        y64 = (vals.astype(np.float64) * x.astype(np.float64)[cols]).sum(1)
        y_pl = (torch.from_numpy(vals) * torch.from_numpy(x)[torch.from_numpy(cols).long()]
                ).sum(1).double().numpy()
        err_df = np.abs(hi.double().numpy() + lo.double().numpy() - y64).max()
        assert err_df < 1e-4 * np.abs(y_pl - y64).max()


@pytest.mark.parametrize("periodic", [None, (True, False, False)])
def test_comp_stencil_matvec_bit_equal(periodic):
    """The compensated stencil matvec on random f32 bands (27 offsets),
    open and periodic axes, with a low word: bit-equal to JAX."""
    rng = np.random.default_rng(2)
    gs = (6, 5, 7)
    offsets = tuple((a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1))
    bands = _f32(rng, 27, *gs, scale=100.0)
    x, x_lo = _f32(rng, int(np.prod(gs))), _f32(rng, int(np.prod(gs)), scale=1e-8)
    from gridapsolvers_tpu_torch.algebra import StencilMatrix

    A = StencilMatrix(torch.from_numpy(bands), offsets, gs, periodic)
    jA = JStencil(jnp.asarray(bands), offsets, gs, periodic=periodic)
    for lo_in in (None, x_lo):
        hi, lo = tc.comp_stencil_matvec(A, torch.from_numpy(x),
                                        None if lo_in is None else torch.from_numpy(lo_in))
        jhi, jlo = jc.comp_stencil_matvec(jA, jnp.asarray(x),
                                          None if lo_in is None else jnp.asarray(lo_in))
        _same(hi, jhi)
        _same(lo, jlo)


def test_comp_dot_tighter_than_plain():
    rng = np.random.default_rng(3)
    a, b = _f32(rng, 100_003), _f32(rng, 100_003)
    hi, lo = tc.comp_dot(torch.from_numpy(a), torch.from_numpy(b))
    exact = float(np.dot(a.astype(np.float64), b.astype(np.float64)))
    plain = float(torch.dot(torch.from_numpy(a), torch.from_numpy(b)))
    assert abs(float(hi) + float(lo) - exact) < abs(plain - exact)


def test_comp_residual_on_ell_and_stencil():
    """comp_residual takes StencilMatrix and ELLMatrix operators of the same
    matrix, agrees between them to f32 roundoff of the residual, and
    refuses anything else."""
    mesh = CartesianMesh((6, 6, 6), (0.0, 1.0) * 3)
    A = eliminate_dirichlet(laplacian(mesh, torch.float64, "cpu"), mesh.boundary_vertex_mask())
    from gridapsolvers_tpu_torch.algebra import to_scipy

    A32 = A.astype(torch.float32)
    E = ell_from_scipy(to_scipy(A), dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(4)
    b, x = torch.from_numpy(_f32(rng, A.n)), torch.from_numpy(_f32(rng, A.n))
    r64 = b.double() - A.matvec(x.double())
    for op in (A32, E):
        r = comp_residual(op, b, x, torch.zeros_like(x))
        assert float((r.double() - r64).abs().max()) <= 1e-6 * float(r64.abs().max())
    with pytest.raises(TypeError):
        comp_residual(sp.eye(3), b, x, x)


def _refine_16():
    nc = 16
    prob = poisson_problem((nc,) * 3, dtype=torch.float32, device="cpu")
    gmg = gmg_from_hierarchy(
        cartesian_hierarchy((nc,) * 3, 3),
        lambda m: eliminate_dirichlet(laplacian(m, torch.float32, "cpu"),
                                      m.boundary_vertex_mask()),
        smoother=ChebyshevSmoother(degree=4, eig_method="gershgorin"),
        coarsest_solver=DenseInverseSolver(), dtype=torch.float32, device="cpu",
    )
    return prob, CGSolver(Pl=gmg, rtol=1e-6, maxiter=40)


def test_linear_iterative_refinement_f32_poisson():
    """tests/test_refinement.py's linear refinement at 16^3: the f64 true
    relative residual of the f32-stored system, from x_hi + x_lo, drops
    below 1e-10 and below 1e-2 of the plain f32 solve's; the reported
    compensated residual agrees with it."""
    prob, cg = _refine_16()
    A, b = prob.A, prob.b
    A64 = dataclasses.replace(A, bands=A.bands.double())

    def resid64(x):
        return float(torch.linalg.norm(b.double() - A64.matvec(x)) / torch.linalg.norm(b.double()))

    x32, _ = cg.solve(cg.setup(A), b)
    ref = IterativeRefinementSolver(cg, niter=2)
    (xh, xl), (stats, rnorm) = ref.solve(ref.setup(A), b)
    assert xh.dtype == xl.dtype == torch.float32
    assert stats.converged()
    plain, refined = resid64(x32.double()), resid64(xh.double() + xl.double())
    assert refined < 1e-10, (plain, refined)
    assert refined < 1e-2 * plain, (plain, refined)
    assert float(rnorm) / float(torch.linalg.norm(b.double())) < 1e-10
