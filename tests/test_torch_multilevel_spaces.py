"""The port's multicolor Gauss-Seidel, FE-space hierarchies and projection
maps against the JAX package.

- `ColoredGaussSeidel`: one smoothing from zero on the same seeded input,
  for every sweep (forward, backward, symmetric), (niter, omega) in
  {(1, 1), (2, 1.3)} and impl (masked, compact), on the odd-sized 9 x 11
  Poisson stencil of tests/test_interfaces.py, and on its ELL copy (greedy
  colours): x and r to 1e-12 of their largest entry; as the preconditioner
  of flexible CG (tests/test_krylov.py) and SSOR-preconditioned CG
  (tests/test_interfaces.py): iteration counts and flags equal, residual
  histories to rtol 1e-8.
- `fe_space_hierarchy` / `multifield_hierarchy` (Q1, Q2, face tags and a
  periodic axis, as tests/test_spaces.py and tests/test_periodic_qk.py use
  them): shapes, counts, masks and coordinates equal, level matrices' ELL
  columns equal and values to 1e-14, transfers applied to seeded vectors
  to 1e-13; the space-driven GMG-CG of tests/test_spaces.py (at 8^2, 2
  levels) with equal iterations, histories to rtol 1e-8 and x to 1e-10.
- `LocalProjectionMap`, `SpaceProjectionMap` (the cases of
  tests/test_staggered_projection.py) and `L2ProjectionRestriction`
  (tests/test_models.py) on seeded fields: to 1e-12 of max|y|.

This file holds its cases in two tests that loop over them: pytest-xdist's
loadfile scheduler queues test files by their number of tests, most first,
so a file of two tests runs after the suite's long files instead of
delaying them.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jax_reference_jit import jitted_jax_chebyshev_setups, jsolve
from gridapsolvers_tpu.fem import poisson_problem as j_poisson_problem
from gridapsolvers_tpu.fem.mesh import CartesianMesh as JMesh
from gridapsolvers_tpu.linear import CGSolver as JCGSolver
from gridapsolvers_tpu.linear import ChebyshevSmoother as JChebyshevSmoother
from gridapsolvers_tpu.linear import ColoredGaussSeidel as JColoredGaussSeidel
from gridapsolvers_tpu.linear.gmg import GMGSolver as JGMGSolver
from gridapsolvers_tpu.multilevel import cartesian_hierarchy as j_cartesian_hierarchy
from gridapsolvers_tpu.multilevel import fe_space_hierarchy as j_fe_space_hierarchy
from gridapsolvers_tpu.multilevel import multifield_hierarchy as j_multifield_hierarchy
from gridapsolvers_tpu.multilevel import setup_projection_restrictions as j_setup_projections
from gridapsolvers_tpu.multilevel.local_projection import LocalProjectionMap as JLocalProjection
from gridapsolvers_tpu.multilevel.local_projection import SpaceProjectionMap as JSpaceProjection
from gridapsolvers_tpu.multilevel.spaces import FESpace as JFESpace

from gridapsolvers_tpu_torch.fem import poisson_problem
from gridapsolvers_tpu_torch.fem.mesh import CartesianMesh
from gridapsolvers_tpu_torch.linear import CGSolver, ChebyshevSmoother, ColoredGaussSeidel
from gridapsolvers_tpu_torch.linear import SymGaussSeidelSmoother
from gridapsolvers_tpu_torch.linear.gmg import GMGSolver
from gridapsolvers_tpu_torch.multilevel import (
    FESpace,
    LocalProjectionMap,
    SpaceProjectionMap,
    TriangulationHierarchy,
    cartesian_hierarchy,
    fe_space_hierarchy,
    multifield_hierarchy,
    setup_projection_restrictions,
)
from gridapsolvers_tpu_torch.ops import banded_stencil, ell_spmv

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _compiled_jax_chebyshev_setups():
    """The JAX references' Chebyshev smoothers set up compiled
    (`jitted_jax_chebyshev_setups`)."""
    with jitted_jax_chebyshev_setups():
        yield


SMOOTH_RTOL = 1e-12
EXACT_RTOL = 1e-14
TRANSFER_RTOL = 1e-13
PROJ_RTOL = 1e-12
HIST_RTOL = 1e-8


def _assert_close(y, y_ref, rtol):
    y, y_ref = np.asarray(y, dtype=np.float64), np.asarray(y_ref, dtype=np.float64)
    scale = np.max(np.abs(y_ref))
    assert y.shape == y_ref.shape and scale > 0
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=rtol * scale)


def _assert_same_solve(stats, jstats):
    assert stats.niter == int(jstats.niter)
    assert int(stats.flag) == int(jstats.flag)
    k = stats.niter
    np.testing.assert_allclose(stats.residuals.numpy()[: k + 1],
                               np.asarray(jstats.residuals)[: k + 1], rtol=HIST_RTOL)


def _mesh_pair(ncells, periodic=None):
    domain = tuple(x for _ in ncells for x in (0.0, 1.0))
    return CartesianMesh(tuple(ncells), domain, periodic), JMesh(tuple(ncells), domain, periodic)


def _seeded(n, seed):
    v = np.random.default_rng(seed).normal(size=n)
    return torch.from_numpy(v), jnp.asarray(v)


# -- ColoredGaussSeidel ----------------------------------------------------------


def _check_colored_gs_sweep_equal_jax(A, jA, b, jb, sweep, niter, omega, impl):
    sm = ColoredGaussSeidel(niter=niter, sweep=sweep, omega=omega, impl=impl)
    jsm = JColoredGaussSeidel(niter=niter, sweep=sweep, omega=omega, impl=impl)
    st, jst = sm.setup(A), jsm.setup(jA)
    np.testing.assert_array_equal(st["masks"].numpy(), np.asarray(jst["masks"]))
    x, r = sm.smooth(st, torch.zeros_like(b), b)
    jx, jr = jsm.smooth(jst, jnp.zeros_like(jb), jb)
    _assert_close(x, jx, SMOOTH_RTOL)
    _assert_close(r, jr, SMOOTH_RTOL)


def _check_colored_gs_on_ell_equal_jax():
    """Greedy colours (native) on the ELL copy of the 10 x 10 Poisson
    stencil, five symmetric double sweeps, as tests/test_interfaces.py."""
    A = poisson_problem((10, 10), device="cpu").A.to_ell()
    jprob = j_poisson_problem((10, 10))
    jA = jprob.A.to_ell()
    sm, jsm = ColoredGaussSeidel(niter=2), JColoredGaussSeidel(niter=2)
    st, jst = sm.setup(A), jsm.setup(jA)
    np.testing.assert_array_equal(st["masks"].numpy(), np.asarray(jst["masks"]))
    r, jr = torch.from_numpy(np.asarray(jprob.b)), jprob.b
    x, jx = torch.zeros_like(r), jnp.zeros_like(jr)
    ell_spmv.counts.reset()
    for _ in range(5):
        x, r = sm.smooth(st, x, r)
        jx, jr = jsm.smooth(jst, jx, jr)
    _assert_close(x, jx, SMOOTH_RTOL)
    _assert_close(r, jr, SMOOTH_RTOL)
    # the masked sweep is one K3 apply a colour visit (plain on CPU tensors)
    ncol = st["masks"].shape[0]
    assert ell_spmv.counts.plain == 5 * 2 * 2 * ncol and ell_spmv.counts.kernel == 0


def _check_gs_preconditioned_cg_equal_jax(case):
    """Flexible CG + one symmetric GS sweep on 8 x 8 Poisson
    (tests/test_krylov.py KRYLOV_CASES), and CG + SSOR(1.3) on 10 x 10
    (tests/test_interfaces.py)."""
    if case == "flexible_gs":
        n, make = 8, lambda cg, gs: cg(Pl=gs(niter=1), rtol=1e-8, flexible=True)
    else:
        n, make = 10, lambda cg, gs: cg(Pl=gs(niter=1, sweep="symmetric", omega=1.3),
                                        rtol=1e-9, maxiter=100)
    prob, jprob = poisson_problem((n, n), device="cpu"), j_poisson_problem((n, n))
    banded_stencil.counts.reset()
    solver, jsolver = make(CGSolver, SymGaussSeidelSmoother), make(JCGSolver,
                                                                   JColoredGaussSeidel)
    x, stats = solver.solve(solver.setup(prob.A), prob.b)
    jx, jstats = jsolve(jsolver, jsolver.setup(jprob.A), jprob.b)
    _assert_same_solve(stats, jstats)
    _assert_close(x, jx, 1e-10)
    assert banded_stencil.counts.kernel == 0 and banded_stencil.counts.plain > 0


# -- FE-space hierarchies -------------------------------------------------------

SPACE_CASES = {
    "q1": dict(ncells=(8, 8), levels=3, order=1, dirichlet="boundary", periodic=None),
    "q2": dict(ncells=(8, 8), levels=2, order=2, dirichlet="boundary", periodic=None),
    "q1 tags": dict(ncells=(8, 6), levels=2, order=1, dirichlet=("x0", "y1"), periodic=None),
    "q2 periodic x": dict(ncells=(8, 8), levels=2, order=2, dirichlet="boundary",
                          periodic=(True, False)),
}


def _check_fe_space_hierarchy_equal_jax(case):
    c = SPACE_CASES[case]
    h = cartesian_hierarchy(c["ncells"], c["levels"], periodic=c["periodic"])
    jh = j_cartesian_hierarchy(c["ncells"], c["levels"], periodic=c["periodic"])
    sh = fe_space_hierarchy(h, order=c["order"], dirichlet=c["dirichlet"])
    jsh = j_fe_space_hierarchy(jh, order=c["order"], dirichlet=c["dirichlet"])
    assert sh.num_levels == jsh.num_levels == c["levels"]
    for s, js in zip(sh.spaces, jsh.spaces, strict=True):
        assert (s.grid_shape, s.num_dofs, s.num_free_dofs) == (
            js.grid_shape, js.num_dofs, js.num_free_dofs)
        np.testing.assert_array_equal(s.dirichlet_mask(), js.dirichlet_mask())
        np.testing.assert_array_equal(s.free_mask(device="cpu").numpy(),
                                      np.asarray(js.free_mask(np.float64)))
        np.testing.assert_array_equal(s.node_coords(), js.node_coords())
    for A, jA in zip(sh.compute_matrices("stiffness", device="cpu"),
                     jsh.compute_matrices("stiffness"), strict=True):
        np.testing.assert_array_equal(A.cols.numpy(), np.asarray(jA.cols))
        _assert_close(A.values, jA.values, EXACT_RTOL)
    P, R = sh.transfer_operators(device="cpu")
    jP, jR = jsh.transfer_operators()
    for lev, (p, r, jp, jr) in enumerate(zip(P, R, jP, jR, strict=True)):
        xc, jxc = _seeded(sh[lev + 1].num_dofs, 10 + lev)
        xf, jxf = _seeded(sh[lev].num_dofs, 20 + lev)
        _assert_close(p.matvec(xc), jp.matvec(jxc), TRANSFER_RTOL)
        _assert_close(r.matvec(xf), jr.matvec(jxf), TRANSFER_RTOL)
    th = TriangulationHierarchy(h)
    assert th.num_levels == c["levels"] and th[1].ncells == h[1].ncells


def _check_multifield_hierarchy_equal_jax():
    h, jh = cartesian_hierarchy((8, 8), 2), j_cartesian_hierarchy((8, 8), 2)
    mf, jmf = multifield_hierarchy(h, orders=(2, 1)), j_multifield_hierarchy(jh, orders=(2, 1))
    assert len(mf) == len(jmf) == 2
    for m, jm in zip(mf, jmf, strict=True):
        assert m.num_dofs == jm.num_dofs
        for f, jf in zip(m.free_masks(device="cpu"), jm.free_masks(), strict=True):
            np.testing.assert_array_equal(f.numpy(), np.asarray(jf))


def _check_space_hierarchy_gmg_equal_jax():
    """compute_matrices + transfer_operators into GMG-CG (tests/test_spaces.py's
    configuration at 8^2 on 2 levels)."""
    def run(cart, fes, gmg_cls, cheb, cg, prob, kw):
        sh = fes(cart((8, 8), 2), order=1)
        mats = sh.compute_matrices("stiffness", **kw)
        P, R = sh.transfer_operators(**kw)
        gmg = gmg_cls(coarse_ops=tuple(mats[1:]), prolongations=tuple(P),
                      restrictions=tuple(R), smoother=cheb(degree=3))
        solver = cg(Pl=gmg, rtol=1e-8, maxiter=30)
        if cg is JCGSolver:
            return jsolve(solver, solver.setup(mats[0]), prob.b)
        return solver.solve(solver.setup(mats[0]), prob.b)

    prob = poisson_problem((8, 8), device="cpu")
    x, stats = run(cartesian_hierarchy, fe_space_hierarchy, GMGSolver, ChebyshevSmoother,
                   CGSolver, prob, {"device": "cpu"})
    jx, jstats = run(j_cartesian_hierarchy, j_fe_space_hierarchy, JGMGSolver,
                     JChebyshevSmoother, JCGSolver, j_poisson_problem((8, 8)), {})
    _assert_same_solve(stats, jstats)
    _assert_close(x, jx, 1e-10)


# -- projections ---------------------------------------------------------------


def _check_projection_maps_equal_jax(case):
    from gridapsolvers_tpu.fem import assembly2 as jasm

    ncells = {"local": (6, 5), "space free": (5, 4), "space constrained": (4, 3)}[case]
    mesh, jmesh = _mesh_pair(ncells)
    if case == "local":
        proj = LocalProjectionMap(mesh, order_from=2, order_to=1, device="cpu")
        jproj = JLocalProjection(jmesh, order_from=2, order_to=1)
    else:
        bc = None if case == "space free" else "boundary"
        proj = SpaceProjectionMap(FESpace(mesh, 1, bc), order_from=2, device="cpu")
        jproj = JSpaceProjection(JFESpace(jmesh, 1, bc), order_from=2)
    u, ju = _seeded(jasm.num_nodes(jmesh, 2), 4)
    y = proj(u)
    _assert_close(y, jproj(ju), PROJ_RTOL)
    if case == "local":  # exact on globally linear fields
        xy2, xy1 = jasm.node_coords(jmesh, 2), jasm.node_coords(jmesh, 1)
        lin = proj(torch.from_numpy(1.0 + 2.0 * xy2[:, 0] - 3.0 * xy2[:, 1]))
        np.testing.assert_allclose(lin.numpy(), 1.0 + 2.0 * xy1[:, 0] - 3.0 * xy1[:, 1],
                                   atol=1e-12)
    if case == "space constrained":
        assert np.all(y.numpy()[jasm.boundary_node_mask(jmesh, 1)] == 0.0)


def _check_l2_projection_restriction_equal_jax():
    h, jh = cartesian_hierarchy((8, 8), 2), j_cartesian_hierarchy((8, 8), 2)
    R = setup_projection_restrictions(h, device="cpu")[0]
    jR = j_setup_projections(jh)[0]
    uf, juf = _seeded(int(np.prod(h[0].vertex_shape)), 5)
    _assert_close(R.matvec(uf), jR.matvec(juf), PROJ_RTOL)
    # exact on the coarse space's functions (tests/test_models.py)
    coords = h[1].vertex_coords()
    uc = torch.from_numpy(coords[:, 0] + 0.5 * coords[:, 1])
    from gridapsolvers_tpu_torch.multilevel import setup_transfer_operators

    P, _ = setup_transfer_operators(h, with_masks=False, device="cpu")
    np.testing.assert_allclose(R.matvec(P[0].matvec(uc)).numpy(), uc.numpy(), atol=1e-9)


def test_gauss_seidel_equal_jax():
    A = poisson_problem((9, 11), device="cpu").A  # odd sizes stress the parity subgrids
    jA = j_poisson_problem((9, 11)).A
    b, jb = _seeded(A.shape[0], 3)
    for sweep in ("forward", "backward", "symmetric"):
        for niter, omega in ((1, 1.0), (2, 1.3)):
            for impl in ("masked", "compact"):
                _check_colored_gs_sweep_equal_jax(A, jA, b, jb, sweep, niter, omega, impl)
    _check_colored_gs_on_ell_equal_jax()
    for case in ("flexible_gs", "ssor"):
        _check_gs_preconditioned_cg_equal_jax(case)


def test_spaces_and_projections_equal_jax():
    for case in SPACE_CASES:
        _check_fe_space_hierarchy_equal_jax(case)
    _check_multifield_hierarchy_equal_jax()
    _check_space_hierarchy_gmg_equal_jax()
    for case in ("local", "space free", "space constrained"):
        _check_projection_maps_equal_jax(case)
    _check_l2_projection_restriction_equal_jax()
