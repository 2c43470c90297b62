"""The port's GMG-CG Poisson main path as a whole, against the JAX package.

Both packages get literally the same operators (carried across by
`convert`) or build them with bit-equal host assembly; iteration counts
and flags must be equal, residual histories agree to rtol 1e-10 and
solutions to 1e-10 of the largest entry (f64; the two packages reduce dot
products in different orders, and JAX's and PyTorch's LU/inverse differ in
the last bits).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__
from jax_reference_jit import jitted_jax_dense, jitted_jax_solves, jsolve
from gridapsolvers_tpu.fem import poisson_problem as j_poisson_problem
from gridapsolvers_tpu.fem.assembly import eliminate_dirichlet as j_eliminate
from gridapsolvers_tpu.fem.assembly import laplacian as j_laplacian
from gridapsolvers_tpu.fem.assembly import laplacian_const as j_laplacian_const
from gridapsolvers_tpu.fem.mesh import CartesianMesh as JMesh
from gridapsolvers_tpu.linear import CGSolver as JCG
from gridapsolvers_tpu.linear import condition_estimate as j_condition_estimate
from gridapsolvers_tpu.linear import ChebyshevSmoother as JCheby
from gridapsolvers_tpu.linear.gmg import gmg_from_hierarchy as j_gmg_from_hierarchy
from gridapsolvers_tpu.linear.smoothers import estimate_dinv_a_lmax as j_lanczos
from gridapsolvers_tpu.linear.smoothers import gershgorin_dinv_a_lmax as j_gershgorin
from gridapsolvers_tpu.models import solve_poisson as j_solve_poisson
from gridapsolvers_tpu.multilevel import cartesian_hierarchy as j_hierarchy

from gridapsolvers_tpu_torch import convert
from gridapsolvers_tpu_torch.fem import poisson_problem
from gridapsolvers_tpu_torch.interfaces import ConvergenceFlag, SolverTolerances
from gridapsolvers_tpu_torch.linear import (
    CGSolver,
    ChebyshevSmoother,
    DenseInverseSolver,
    DenseLUSolver,
    GMGSolver,
    condition_estimate,
    estimate_dinv_a_lmax,
    gershgorin_dinv_a_lmax,
)
from gridapsolvers_tpu_torch.models import solve_poisson, solve_poisson_const
from gridapsolvers_tpu_torch.ops import banded_stencil, const_stencil

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _compiled_jax_dense():
    """The JAX package's `ELLMatrix.todense` runs compiled
    (`jitted_jax_dense`)."""
    with jitted_jax_dense():
        yield


HIST_RTOL = 1e-10
X_RTOL = 1e-10
LMAX_RTOL = 1e-12


def _unit_mesh(ncells):
    return JMesh(tuple(ncells), tuple(x for _ in ncells for x in (0.0, 1.0)))


def _conv(op):
    """Any JAX main-path operator -> the port's, via convert."""
    if hasattr(op, "weights"):
        return convert.const_stencil_matrix(
            np.asarray(op.weights), np.asarray(op.free), op.offsets, op.grid_shape,
            device="cpu",
        )
    return convert.stencil_matrix(np.asarray(op.bands), op.offsets, op.grid_shape, op.periodic,
                                   device="cpu")


def _conv_gmg(jgmg, **kw):
    """The JAX GMG's level operators and transfers, in a port GMGSolver."""
    P = tuple(
        convert.prolongation(p.fine_shape, p.coarse_shape, np.asarray(p.mask_fine),
                             p.factors, p.periodic, device="cpu")
        for p in jgmg.prolongations
    )
    R = tuple(
        convert.restriction(r.fine_shape, r.coarse_shape, r.mode, np.asarray(r.mask_coarse),
                            np.asarray(r.mask_fine), r.factors, r.periodic,
                            device="cpu")
        for r in jgmg.restrictions
    )
    return GMGSolver(coarse_ops=tuple(_conv(op) for op in jgmg.coarse_ops),
                     prolongations=P, restrictions=R, cycle=jgmg.cycle, mode=jgmg.mode, **kw)


def _conv_problem(jp):
    return convert.poisson_problem(
        jp.mesh, _conv(jp.A), _conv(jp.A_full), _conv(jp.M),
        np.asarray(jp.b), np.asarray(jp.u_exact), jp.dirichlet_mask, device="cpu",
    )


def _assert_same_solve(x, stats, jx, jstats):
    assert stats.niter == int(jstats.niter)
    assert int(stats.flag) == int(jstats.flag)
    h, jh = stats.residuals.numpy(), np.asarray(jstats.residuals)
    k = stats.niter
    np.testing.assert_allclose(h[: k + 1], jh[: k + 1], rtol=HIST_RTOL)
    assert np.isnan(h[k + 1 :]).all() and np.isnan(jh[k + 1 :]).all()
    jx = np.asarray(jx)
    np.testing.assert_allclose(x.numpy(), jx, rtol=0, atol=X_RTOL * np.abs(jx).max())


# -------------------------------------------------------------- λmax -----


@pytest.mark.parametrize("kind", ["banded", "const"])
def test_chebyshev_lmax_matches_jax(kind):
    mesh = _unit_mesh((8, 8, 8))
    jA = (j_eliminate(j_laplacian(mesh), mesh.boundary_vertex_mask())
          if kind == "banded" else j_laplacian_const(mesh))
    A = _conv(jA)
    jinv = 1.0 / jA.diag()
    inv = 1.0 / A.diag()
    np.testing.assert_allclose(float(gershgorin_dinv_a_lmax(A, inv)),
                               float(j_gershgorin(jA, jinv)), rtol=LMAX_RTOL)
    np.testing.assert_allclose(float(estimate_dinv_a_lmax(A, inv, 20)),
                               float(j_lanczos(jA, jinv, 20)), rtol=LMAX_RTOL)
    st = ChebyshevSmoother(degree=3).setup(A)
    jst = JCheby(degree=3).setup(jA)
    np.testing.assert_allclose(st["lmax"], float(jst["lmax"]), rtol=LMAX_RTOL)
    np.testing.assert_allclose(st["lmin"], float(jst["lmin"]), rtol=LMAX_RTOL)


# ----------------------------------------------------- the main path -----


def test_solve_poisson_matches_jax():
    """The README quick start: banded operators, Chebyshev with Lanczos,
    explicit-inverse coarse solve; port constructors and converted operators."""
    with jitted_jax_solves():
        jx, jstats, jinfo = j_solve_poisson((16, 16, 16), num_levels=3, rtol=1e-8)
    assert int(jstats.niter) == 7
    x, stats, info = solve_poisson((16, 16, 16), num_levels=3, rtol=1e-8, device="cpu")
    _assert_same_solve(x, stats, jx, jstats)
    assert stats.flag == ConvergenceFlag.CONVERGED_RTOL
    np.testing.assert_allclose(info["l2_error"], jinfo["l2_error"], rtol=1e-6)

    # the same operators as the JAX solve, carried across
    jgmg = j_gmg_from_hierarchy(
        j_hierarchy((16, 16, 16), 3),
        lambda m: j_eliminate(j_laplacian(m), m.boundary_vertex_mask()),
    )
    gmg = _conv_gmg(jgmg, smoother=ChebyshevSmoother(degree=3),
                    coarsest_solver=DenseInverseSolver())
    prob = _conv_problem(jinfo["problem"])
    solver = CGSolver(Pl=gmg, rtol=1e-8, maxiter=30)
    xc, sc = solver.solve(solver.setup(prob.A), prob.b)
    _assert_same_solve(xc, sc, jx, jstats)


def test_entry_config_matches_jax():
    """__graft_entry__'s configuration at 16^3, 3 levels, f64: constant
    stencils, Chebyshev with Gershgorin, dense LU, CG rtol 1e-5."""
    jprob, jsolver = __graft_entry__._build((16, 16, 16), 3, np.float64)
    jA = j_laplacian_const(jprob.mesh, np.float64)
    jx, jstats = jsolve(jsolver, jsolver.setup(jA), jnp.asarray(jprob.b))

    x, stats, info = solve_poisson_const((16, 16, 16), 3, device="cpu", dtype=torch.float64)
    _assert_same_solve(x, stats, jx, jstats)
    np.testing.assert_allclose(
        info["l2_error"], float(jprob.l2_error(jx)), rtol=1e-6
    )

    gmg = _conv_gmg(jsolver.Pl, smoother=ChebyshevSmoother(degree=3, eig_method="gershgorin"))
    assert isinstance(gmg.coarsest_solver, DenseLUSolver)
    solver = CGSolver(Pl=gmg, rtol=1e-5, atol=0.0, maxiter=25)
    prob = _conv_problem(jprob)
    xc, sc = solver.solve(solver.setup(_conv(jA)), prob.b)
    _assert_same_solve(xc, sc, jx, jstats)


def test_entry_config_f32_32cubed_converges_in_4():
    """Port only, true f32 (JAX with x64 off also takes 4 iterations). On
    CPU tensors every stencil apply runs the plain version, never the
    kernel, and the count follows the code: (n+1)((L-1)(2k+1)+2)."""
    counts = const_stencil.counts
    k0, p0 = counts.kernel, counts.plain
    b0 = banded_stencil.counts.kernel
    x, stats, info = solve_poisson_const((32, 32, 32), 3, device="cpu", dtype=torch.float32)
    assert x.dtype == torch.float32 and x.shape == (33 ** 3,)
    assert bool(torch.isfinite(x).all())
    assert stats.niter == 4 and stats.converged()
    assert info["l2_error"] < 2e-4
    assert counts.kernel == k0 and banded_stencil.counts.kernel == b0
    assert counts.plain - p0 == (4 + 1) * ((3 - 1) * (2 * 3 + 1) + 2)

    # update() re-runs the numerical setup: the same solve again
    solver, state = info["solver"], info["state"]
    state2 = solver.update(state, state["A"])
    x2, stats2 = solver.solve(state2, info["problem"].b)
    assert stats2.niter == stats.niter
    torch.testing.assert_close(x2, x, rtol=0, atol=0)


@pytest.mark.parametrize(
    "cycle, mode, flexible",
    [("w", "preconditioner", True), ("f", "preconditioner", False), ("v", "solver", False)],
)
def test_gmg_cycles_and_modes_match_jax(cycle, mode, flexible):
    """w/f cycles and flexible CG with Lanczos extras, and GMG as a
    standalone solver with the default Richardson-Jacobi smoother, on 2D."""
    ncells = (16, 16)
    jprob = j_poisson_problem(ncells)
    jgmg = j_gmg_from_hierarchy(
        j_hierarchy(ncells, 3),
        lambda m: j_eliminate(j_laplacian(m), m.boundary_vertex_mask()),
        cycle=cycle, mode=mode,
        **({"smoother": JCheby(degree=2)} if mode == "preconditioner" else {}),
    )
    gmg = _conv_gmg(jgmg, **({"smoother": ChebyshevSmoother(degree=2)}
                             if mode == "preconditioner" else {}))
    prob = _conv_problem(jprob)
    if mode == "solver":
        jx, jstats = jsolve(jgmg, jgmg.setup(jprob.A), jnp.asarray(jprob.b))
        x, stats = gmg.solve(gmg.setup(prob.A), prob.b)
    else:
        jcg = JCG(Pl=jgmg, rtol=1e-10, maxiter=40, flexible=flexible, lanczos=True)
        cg = CGSolver(Pl=gmg, rtol=1e-10, maxiter=40, flexible=flexible, lanczos=True)
        jx, jstats = jsolve(jcg, jcg.setup(jprob.A), jnp.asarray(jprob.b))
        x, stats = cg.solve(cg.setup(prob.A), prob.b)
        k = stats.niter
        for key in ("alphas", "betas"):
            np.testing.assert_allclose(stats.extra[key][:k].numpy(),
                                       np.asarray(jstats.extra[key])[:k], rtol=HIST_RTOL)
        np.testing.assert_allclose(condition_estimate(stats), j_condition_estimate(jstats),
                                   rtol=1e-8)
    _assert_same_solve(x, stats, jx, jstats)


def test_tolerances_flags_match_jax():
    from gridapsolvers_tpu.interfaces import SolverTolerances as JTols

    cases = [(3, 1e-9, 1.0), (3, 0.5, 1.0), (10, 0.5, 1.0), (2, float("nan"), 1.0),
             (2, 50.0, 1.0)]
    for tols in (SolverTolerances(10, 1e-6, 1e-3), SolverTolerances(10, 0.0, 1e-3, dtol=10.0)):
        jtols = JTols(tols.maxiter, tols.atol, tols.rtol, tols.dtol)
        for it, rn, r0 in cases:
            assert tols.finished(it, rn, r0) == bool(jtols.finished(it, rn, r0))
            assert int(tols.finished_flag(it, rn, r0)) == int(jtols.finished_flag(it, rn, r0))


def test_convergence_log_and_verbose_cg_match_jax(capsys):
    """ConvergenceLog reports the same text for the same history, and a
    verbose CG prints one depth-indented line per iteration in the JAX
    package's live format."""
    from gridapsolvers_tpu.interfaces import ConvergenceLog as JLog
    from gridapsolvers_tpu.interfaces import SolverStats as JStats
    from gridapsolvers_tpu.interfaces import SolverTolerances as JTols
    from gridapsolvers_tpu.interfaces import VerboseLevel as JVerbose
    from gridapsolvers_tpu_torch.interfaces import ConvergenceLog, SolverStats, VerboseLevel

    hist = np.array([1.0, 0.25, 3e-3, 4e-9, np.nan, np.nan])
    tols = SolverTolerances(5, 0.0, 1e-8)
    jtols = JTols(5, 0.0, 1e-8)
    stats = SolverStats(3, int(ConvergenceFlag.CONVERGED_RTOL), torch.from_numpy(hist))
    jstats = JStats(jnp.asarray(3), jnp.asarray(int(ConvergenceFlag.CONVERGED_RTOL)),
                    jnp.asarray(hist))
    for level, jlevel in zip(VerboseLevel, JVerbose):
        ours = ConvergenceLog("cg", tols, verbose=level, depth=1).report(stats)
        assert ours == JLog("cg", jtols, verbose=jlevel, depth=1).report(jstats)
    assert ours.count("\n") == 4 and ours.startswith("  cg: starting")

    capsys.readouterr()
    prob = poisson_problem((8, 8), device="cpu")
    cg = CGSolver(rtol=1e-6, maxiter=50, verbose=True, name="innerCG", depth=1)
    _, st = cg.solve(cg.setup(prob.A), prob.b)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == st.niter > 0
    for it, line in enumerate(lines, 1):
        assert line.startswith(f"  innerCG: iteration {it:4d}  r = ")
        np.testing.assert_allclose(float(line.rsplit("=", 1)[1]),
                                   float(st.residuals[it]), rtol=1e-6)


def test_vector_algebra_on_tuples_matches_jax():
    """Vectors may be tuples of tensors, where JAX has pytrees of blocks."""
    from gridapsolvers_tpu.utils import pytrees as jpt
    from gridapsolvers_tpu_torch.utils import pytrees as pt

    rng = np.random.default_rng(7)
    a = (rng.normal(size=5), (rng.normal(size=(2, 3)), rng.normal(size=4)))
    b = (rng.normal(size=5), (rng.normal(size=(2, 3)), rng.normal(size=4)))
    ta, tb = pt.tree_map(torch.from_numpy, a), pt.tree_map(torch.from_numpy, b)
    ja, jb = pt.tree_map(jnp.asarray, a), pt.tree_map(jnp.asarray, b)
    np.testing.assert_allclose(float(pt.dot(ta, tb)), float(jpt.dot(ja, jb)), rtol=1e-14)
    np.testing.assert_allclose(float(pt.norm(ta)), float(jpt.norm(ja)), rtol=1e-14)
    for ours, theirs in (
        (pt.axpy(0.3, ta, tb), jpt.axpy(0.3, ja, jb)),
        (pt.axpby(0.3, ta, -2.0, tb), jpt.axpby(0.3, ja, -2.0, jb)),
        (pt.mul(ta, tb), jpt.mul(ja, jb)),
        (pt.sub(ta, pt.scale(2.0, tb)), jpt.sub(ja, jpt.scale(2.0, jb))),
    ):
        np.testing.assert_array_equal(pt.ravel(ours).numpy(), np.asarray(jpt.ravel(theirs)))
    flat = pt.ravel(ta)
    back = pt.unflatten_like(flat, ta)
    assert [t.shape for t in pt.tree_leaves(back)] == [t.shape for t in pt.tree_leaves(ta)]
    np.testing.assert_array_equal(pt.ravel(back).numpy(), flat.numpy())


# ------------------------------------------------------ device rule ------


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the rule is for machines without it")
    with pytest.raises(RuntimeError, match="cuda"):
        poisson_problem((4, 4, 4), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        solve_poisson_const((4, 4, 4), 2, device="cuda", dtype=torch.float32)
