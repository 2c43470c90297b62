"""The port's Krylov family, direct and wrapper solvers, solver-info trees,
nullspaces and hierarchy constructors against the JAX package.

Cases follow tests/test_krylov.py (KRYLOV_CASES without ColoredGaussSeidel,
which is not ported yet), tests/test_gmres_adaptive.py,
tests/test_interfaces.py and tests/test_wrappers.py. Both packages solve
the same f64 problem (the port's host assembly is bit-equal to JAX's):
iteration counts and flags must be equal, residual histories agree to
rtol 1e-8 (entries under 1e-12 of the initial residual, round-off after
an exact step, to that) and solutions to 1e-8 of their largest entry (the two reduce
dot products in different orders; the port's Givens rotations run on the
host). Each case also keeps the JAX test's own bound (L2 < 1e-6).
"""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import gridapsolvers_tpu.linear as JL
from jax_reference_jit import jitted_jax_dense, jsolve
from gridapsolvers_tpu.algebra import DenseMatrix as JDense
from gridapsolvers_tpu.algebra.ell import ell_from_scipy as j_ell_from_scipy
from gridapsolvers_tpu.fem import poisson_problem as j_poisson_problem
from gridapsolvers_tpu.interfaces import NullSpace as JNullSpace
from gridapsolvers_tpu.interfaces import make_orthonormal as j_make_orthonormal
from gridapsolvers_tpu.multilevel import hierarchy_from_coarse as j_hierarchy_from_coarse
from gridapsolvers_tpu.multilevel import octree_cartesian_hierarchy as j_octree

import gridapsolvers_tpu_torch.linear as TL
from gridapsolvers_tpu_torch import convert
from gridapsolvers_tpu_torch.algebra import ell_from_scipy
from gridapsolvers_tpu_torch.fem import CartesianMesh, poisson_problem
from gridapsolvers_tpu_torch.fem.assembly import eliminate_dirichlet, laplacian
from gridapsolvers_tpu_torch.interfaces import (
    constant_nullspace,
    format_solver_tree,
    get_solver_info,
    make_orthogonal,
    make_orthonormal,
    project,
    reconstruct,
    rigid_body_modes,
)
from gridapsolvers_tpu_torch.linear.gmg import gmg_from_hierarchy
from gridapsolvers_tpu_torch.multilevel import (
    compute_hierarchy_matrices,
    hierarchy_from_coarse,
    octree_cartesian_hierarchy,
    setup_transfer_operators,
)
from gridapsolvers_tpu_torch.utils import pytrees as pt

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _compiled_jax_dense():
    """The JAX package's `ELLMatrix.todense` runs compiled
    (`jitted_jax_dense`)."""
    with jitted_jax_dense():
        yield


HIST_RTOL = 1e-8
HIST_ATOL = 1e-12  # of the initial residual: round-off once a solve is exact
X_RTOL = 1e-8


def _krylov_cases(L):
    """tests/test_krylov.py's KRYLOV_CASES without ColoredGaussSeidel,
    built from either package's `linear` module."""
    return {
        "cg": L.CGSolver(rtol=1e-8),
        "cg_jacobi": L.CGSolver(Pl=L.JacobiSolver(), rtol=1e-8),
        "cg_richardson": L.CGSolver(
            Pl=L.RichardsonSmoother(L.JacobiSolver(), niter=3, omega=0.8), rtol=1e-8),
        "cg_chebyshev": L.CGSolver(Pl=L.ChebyshevSmoother(degree=4), rtol=1e-8),
        "gmres": L.GMRESSolver(m=25, rtol=1e-8),
        "gmres_left_jacobi": L.GMRESSolver(m=25, Pl=L.JacobiSolver(), rtol=1e-8),
        "gmres_right_jacobi": L.GMRESSolver(m=25, Pr=L.JacobiSolver(), rtol=1e-8),
        "fgmres_right_jacobi": L.FGMRESSolver(m=25, Pr=L.JacobiSolver(), rtol=1e-8),
        "minres": L.MINRESSolver(rtol=1e-8),
        "minres_jacobi": L.MINRESSolver(Pl=L.JacobiSolver(), rtol=1e-8),
    }


def _krylov_3d(L):
    return {
        "cg": L.CGSolver(Pl=L.JacobiSolver(), rtol=1e-8),
        "gmres": L.GMRESSolver(m=30, Pl=L.JacobiSolver(), rtol=1e-8),
        "minres": L.MINRESSolver(Pl=L.JacobiSolver(), rtol=1e-8),
    }


def _problems(ncells):
    return j_poisson_problem(ncells), poisson_problem(ncells, device="cpu")


@pytest.fixture(scope="module")
def poisson2d():
    return _problems((8, 8))


@pytest.fixture(scope="module")
def poisson3d():
    return _problems((4, 4, 4))


def _assert_same_solve(x, stats, jx, jstats):
    assert stats.niter == int(jstats.niter)
    assert int(stats.flag) == int(jstats.flag)
    k = stats.niter
    h, jh = stats.residuals.numpy(), np.asarray(jstats.residuals)
    np.testing.assert_allclose(h[: k + 1], jh[: k + 1], rtol=HIST_RTOL, atol=HIST_ATOL * jh[0])
    assert np.isnan(h[k + 1 :]).all()
    jx = np.asarray(jx)
    np.testing.assert_allclose(x.numpy(), jx, rtol=0, atol=X_RTOL * np.abs(jx).max())


def _solve_both(probs, solver, jsolver):
    jp, p = probs
    jx, jstats = jsolve(jsolver, jsolver.setup(jp.A), jp.b)
    x, stats = solver.solve(solver.setup(p.A), p.b)
    _assert_same_solve(x, stats, jx, jstats)
    assert float(p.l2_error(x)) < 1e-6
    return x, stats


@pytest.mark.parametrize("case", list(_krylov_cases(TL)))
def test_krylov_2d(poisson2d, case):
    _solve_both(poisson2d, _krylov_cases(TL)[case], _krylov_cases(JL)[case])


@pytest.mark.parametrize("case", list(_krylov_3d(TL)))
def test_krylov_3d(poisson3d, case):
    _solve_both(poisson3d, _krylov_3d(TL)[case], _krylov_3d(JL)[case])


def test_direct_solvers(poisson2d):
    jp, p = poisson2d
    for solver, jsolver in ((TL.DenseLUSolver(), JL.DenseLUSolver()),
                            (TL.DenseCholeskySolver(), JL.DenseCholeskySolver()),
                            (TL.MatrixSolver(p.A), JL.MatrixSolver(jp.A))):
        x, _ = solver.solve(solver.setup(p.A), p.b)
        jx, _ = jsolve(jsolver, jsolver.setup(jp.A), jp.b)
        assert float(p.l2_error(x)) < 1e-10
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=1e-12)


def test_identity_solver(poisson2d):
    """The identity solver, and the reference-facing names the JAX package
    exports that the port carries too: the solver aliases, the interface
    helpers, `df_neg`, `pytrees.where` and every public name of
    `gridapsolvers_tpu.multilevel`."""
    import importlib

    import gridapsolvers_tpu.multilevel as JM
    import gridapsolvers_tpu_torch.multilevel as TM
    from gridapsolvers_tpu_torch.interfaces import as_preconditioner, precond_apply, record
    from gridapsolvers_tpu_torch.utils.compensated import df_neg

    _, p = poisson2d
    s = TL.IdentitySolver()
    st = s.setup(p.A)
    assert s.apply(st, p.b) is p.b and s.solve(st, p.b)[0] is p.b
    assert (TL.JacobiLinearSolver, TL.GMGLinearSolver, TL.IdentityLinearSolver) == (
        TL.JacobiSolver, TL.GMGSolver, TL.IdentitySolver)
    assert as_preconditioner(None, p.A) is None and precond_apply(None, None, p.b) is p.b
    jac = TL.JacobiSolver()
    jst = as_preconditioner(jac, p.A)
    assert torch.equal(precond_apply(jac, jst, p.b), (1.0 / p.A.diag()) * p.b)
    hist = record(torch.zeros(4, dtype=torch.float64), 2, torch.tensor(3.0, dtype=torch.float64))
    assert hist.tolist() == [0.0, 0.0, 3.0, 0.0]
    hi, lo = df_neg(torch.tensor([1.0, -2.0]), torch.tensor([0.25, 0.0]))
    assert hi.tolist() == [-1.0, 2.0] and lo.tolist() == [-0.25, -0.0]
    a, b = (torch.ones(2), torch.zeros(3)), (torch.zeros(2), torch.ones(3))
    assert all(torch.equal(u, v) for u, v in zip(pt.where(torch.tensor(False), a, b), b))
    assert all(torch.equal(u, v) for u, v in zip(pt.where(True, a, b), a))
    for name in (n for n in dir(JM) if not n.startswith("_")):
        assert hasattr(TM, name) or importlib.util.find_spec(
            f"gridapsolvers_tpu_torch.multilevel.{name}") is not None, name
    assert (TM.ProlongationOperator, TM.RestrictionOperator, TM.MultiFieldTransferOperator,
            TM.P4estCartesianModelHierarchy) == (
        TM.StructuredProlongation, TM.StructuredRestriction, TM.MultiFieldTransfer,
        TM.octree_cartesian_hierarchy)


def test_richardson_linear(poisson2d):
    kw = dict(omega=0.9, maxiter=2000, rtol=1e-9)
    _solve_both(poisson2d, TL.RichardsonLinearSolver(Pl=TL.JacobiSolver(), **kw),
                JL.RichardsonLinearSolver(Pl=JL.JacobiSolver(), **kw))


def test_flexible_cg_with_variable_preconditioner(poisson2d):
    """Flexible CG around an inner CG (tests/test_krylov.py)."""
    def make(L):
        inner = L.CGSolver(Pl=L.JacobiSolver(), maxiter=5, rtol=1e-2)
        return L.CGSolver(Pl=inner, flexible=True, rtol=1e-8, maxiter=300)

    _solve_both(poisson2d, make(TL), make(JL))


def test_gmres_nonsymmetric():
    """GMRES on a nonsymmetric dense system (tests/test_krylov.py)."""
    rng = np.random.default_rng(0)
    jp = j_poisson_problem((10, 10))
    D = np.asarray(jp.A.todense())
    n = D.shape[0]
    Dn = D + (rng.normal(size=(n, n)) * 0.05) @ np.diag(rng.uniform(0.0, 0.1, n))
    x_true = rng.normal(size=n)

    @dataclasses.dataclass
    class Dense:
        M: torch.Tensor

        def matvec(self, x):
            return self.M @ x

    A, jA = Dense(torch.from_numpy(Dn)), JDense(jnp.asarray(Dn))
    b = A.matvec(torch.from_numpy(x_true))
    kw = dict(m=40, rtol=1e-10, maxiter=400)
    solver, jsolver = TL.GMRESSolver(**kw), JL.GMRESSolver(**kw)
    x, stats = solver.solve(solver.setup(A), b)
    jx, jstats = jsolve(jsolver, jsolver.setup(jA), jnp.asarray(b.numpy()))
    _assert_same_solve(x, stats, jx, jstats)
    assert float(np.linalg.norm(x.numpy() - x_true) / np.linalg.norm(x_true)) < 1e-6


# -------------------------------------------------- adaptive GMRES -----


def _shift_system(n=32, eps=1e-3):
    """tests/test_gmres_adaptive.py's near-circulant shift operator, in
    f64 in both packages."""
    S = sp.eye(n, format="csr") * eps + sp.csr_matrix(
        (np.ones(n - 1), (np.arange(1, n), np.arange(n - 1))), shape=(n, n))
    S = (S + sp.csr_matrix(([1.0], ([0], [n - 1])), shape=(n, n))).tocsr()
    b = np.random.RandomState(0).randn(n)
    return (ell_from_scipy(S, dtype=torch.float64, device="cpu"), torch.from_numpy(b),
            j_ell_from_scipy(S, dtype=np.float64), jnp.asarray(b))


def test_fixed_restart_stagnates_adaptive_converges():
    A, b, jA, jb = _shift_system(32)
    kw = dict(m=5, rtol=1e-6, maxiter=60)
    fixed, jfixed = TL.GMRESSolver(**kw), JL.GMRESSolver(**kw)
    x_f, st_f = fixed.solve(fixed.setup(A), b)
    jx_f, jst_f = jsolve(jfixed, jfixed.setup(jA), jb)
    _assert_same_solve(x_f, st_f, jx_f, jst_f)
    assert float(st_f.residuals[st_f.niter]) > 0.5 * float(st_f.residuals[0])

    kw = dict(m=5, m_max=64, rtol=1e-6, maxiter=200)
    grow, jgrow = TL.AdaptiveGMRESSolver(**kw), JL.AdaptiveGMRESSolver(**kw)
    x_g, st_g = grow.solve(grow.setup(A), b)
    jx_g, jst_g = jgrow.solve(jgrow.setup(jA), jb)  # host-side restarts: not jittable
    assert st_g.converged()
    _assert_same_solve(x_g, st_g, jx_g, jst_g)
    r = b - A.matvec(x_g)
    assert float(torch.linalg.norm(r)) <= 1e-5 * float(torch.linalg.norm(b))


def test_adaptive_matches_fixed_on_easy_problem(poisson2d):
    _, p = poisson2d
    fixed = TL.GMRESSolver(m=30, rtol=1e-10, maxiter=200)
    grow = TL.AdaptiveGMRESSolver(m=30, m_max=60, rtol=1e-10, maxiter=200)
    x_f, _ = fixed.solve(fixed.setup(p.A), p.b)
    x_g, st_g = grow.solve(grow.setup(p.A), p.b)
    assert st_g.converged()
    assert float(torch.linalg.norm(x_g - x_f) / torch.linalg.norm(x_f)) < 1e-8


def test_live_verbose_nested_prints(poisson2d, capfd):
    """verbose=True prints depth-indented per-iteration lines during the
    solve for FGMRES (outer) around a verbose CG (inner); quiet solvers
    print nothing (tests/test_gmres_adaptive.py)."""
    _, p = poisson2d
    inner = TL.CGSolver(Pl=TL.JacobiSolver(), rtol=1e-10, maxiter=40, verbose=True,
                        name="innerCG", depth=1)
    outer = TL.GMRESSolver(m=30, Pr=inner, flexible=True, rtol=1e-9, maxiter=60,
                           verbose=True, name="outerFGMRES")
    _, stats = outer.solve(outer.setup(p.A), p.b)
    lines = capfd.readouterr().out.splitlines()
    assert stats.converged()
    outer_lines = [ln for ln in lines if ln.startswith("outerFGMRES:")]
    assert len(outer_lines) == stats.niter
    assert len([ln for ln in lines if ln.startswith("  innerCG:")]) > stats.niter
    assert "iteration" in outer_lines[0] and "r = " in outer_lines[0]
    silent = TL.GMRESSolver(m=30, Pr=dataclasses.replace(inner, verbose=False),
                            flexible=True, rtol=1e-9, maxiter=60)
    silent.solve(silent.setup(p.A), p.b)
    assert capfd.readouterr().out == ""

    mr = TL.MINRESSolver(rtol=1e-8, maxiter=200, verbose=True, name="MR")
    _, stats = mr.solve(mr.setup(p.A), p.b)
    out = capfd.readouterr().out
    assert stats.converged()
    assert sum(ln.startswith("MR: iteration") for ln in out.splitlines()) == stats.niter


def test_gmres_one_host_read_an_iteration(poisson2d, monkeypatch):
    """An iteration of (F)GMRES reads the device once: its Hessenberg
    column and basis norm, one `.cpu()` (the stopping test); a restart
    cycle reads its residual norm once more."""
    _, p = poisson2d
    reads = []
    real_cpu = torch.Tensor.cpu

    def counting_cpu(self, *a, **k):
        reads.append(self.numel())
        return real_cpu(self, *a, **k)

    solver = TL.FGMRESSolver(m=25, Pr=TL.JacobiSolver(), rtol=1e-8)
    state = solver.setup(p.A)
    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    _, stats = solver.solve(state, p.b)
    monkeypatch.undo()
    assert len(reads) == stats.niter


# ------------------------------------- interfaces, nullspaces, wrappers -----


def test_solver_info_and_tree(poisson2d):
    _, p = poisson2d
    solver = TL.CGSolver(Pl=TL.JacobiSolver(), rtol=1e-8)
    _, stats = solver.solve(solver.setup(p.A), p.b)
    info = get_solver_info(solver, stats)
    assert info["type"] == "CGSolver" and info["niter"] == stats.niter > 0
    assert "CONVERGED" in info["flag"] and info["tols"]["rtol"] == 1e-8
    assert info["r_final"] < 1e-8 * info["r0"]
    tree = format_solver_tree(solver)
    assert tree.splitlines() == ["CGSolver", "  JacobiSolver"]
    gmg_tree = format_solver_tree(TL.FGMRESSolver(Pr=TL.GMGSolver(coarse_ops=())))
    assert gmg_tree.splitlines() == ["GMRESSolver", "  GMGSolver", "    DenseLUSolver"]


def test_nullspace_roundtrip():
    """Orthonormalization equal to JAX's (both Gram-Schmidt variants);
    orthogonalize, project and reconstruct round-trip."""
    rng = np.random.default_rng(0)
    vs = [rng.normal(size=20) for _ in range(3)]
    for method in ("modified", "classical"):
        ns = make_orthonormal(convert.nullspace(vs, device="cpu"), method)
        jns = j_make_orthonormal(JNullSpace([jnp.asarray(v) for v in vs]), method)
        for q, jq in zip(ns.vectors, jns.vectors):
            np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=0, atol=1e-14)
        for i, q in enumerate(ns.vectors):
            for j, w in enumerate(ns.vectors):
                assert abs(float(pt.dot(q, w)) - (1.0 if i == j else 0.0)) < 1e-12
    x = torch.from_numpy(rng.normal(size=20))
    x_orth, coefs = make_orthogonal(ns, x)
    for q in ns.vectors:
        assert abs(float(pt.dot(q, x_orth))) < 1e-12
    torch.testing.assert_close(reconstruct(ns, x_orth, coefs), x, rtol=0, atol=1e-12)
    proj, pcoefs = project(ns, x)
    torch.testing.assert_close(proj + x_orth, x, rtol=0, atol=1e-12)
    torch.testing.assert_close(pcoefs, coefs, rtol=0, atol=1e-12)


def test_rigid_body_modes_orthonormal():
    coords = torch.from_numpy(np.random.default_rng(1).random((10, 3)))
    ns = rigid_body_modes(coords)
    K = torch.stack(ns.vectors)
    assert K.shape == (6, 30)
    torch.testing.assert_close(K @ K.T, torch.eye(6, dtype=K.dtype), rtol=0, atol=1e-12)


@pytest.mark.parametrize("constrain,matrix_free", [(True, False), (False, False), (True, True)])
def test_nullspace_solver_pure_neumann(constrain, matrix_free):
    """The singular pure-Neumann Laplacian with the constant nullspace
    (tests/test_wrappers.py): dense augmented LU, orthogonalized CG, and
    the matrix-free augmented system under MINRES."""
    A = laplacian(CartesianMesh((8, 8), (0.0, 1.0, 0.0, 1.0)), torch.float64, "cpu")
    rng = np.random.default_rng(0)
    x_true = torch.from_numpy(rng.normal(size=A.n))
    x_true = x_true - x_true.mean()
    b = A.matvec(x_true)
    inner = {(True, False): TL.DenseLUSolver(),
             (False, False): TL.CGSolver(rtol=1e-12, maxiter=500),
             (True, True): TL.MINRESSolver(rtol=1e-12, maxiter=800)}[(constrain, matrix_free)]
    solver = TL.NullspaceSolver(solver=inner, nullspace=constant_nullspace(b),
                                constrain_matrix=constrain, matrix_free=matrix_free)
    x, _ = solver.solve(solver.setup(A), b)
    assert float(torch.linalg.norm(x - x.mean() - x_true)) < 1e-7


def test_callback_solver(poisson2d):
    _, p = poisson2d
    seen = []
    solver = TL.CallbackSolver(TL.CGSolver(Pl=TL.JacobiSolver(), rtol=1e-10, maxiter=200),
                               lambda x: seen.append(1) or None)
    x, _ = solver.solve(solver.setup(p.A), p.b)
    assert seen == [1]
    assert float(p.l2_error(x)) < 1e-7
    shifted = TL.CallbackSolver(solver.solver, lambda x: x + 1.0)
    x1 = shifted.apply(shifted.setup(p.A), p.b)
    torch.testing.assert_close(x1, x + 1.0, rtol=0, atol=1e-12)


def test_linear_solver_from_smoother(poisson2d):
    _, p = poisson2d
    solver = TL.LinearSolverFromSmoother(TL.RichardsonSmoother(TL.JacobiSolver(), niter=5,
                                                               omega=0.8))
    state = solver.setup(p.A)
    x, _ = solver.solve(state, p.b)
    assert float(torch.linalg.norm(p.b - p.A.matvec(x))) < float(torch.linalg.norm(p.b))
    torch.testing.assert_close(solver.apply(state, p.b), x, rtol=0, atol=0)


# ------------------------------------------------------ hierarchies -----


def test_hierarchy_from_coarse_and_matrices():
    """tests/test_gmg.py::test_hierarchy_from_coarse_and_matrices: levels
    as JAX's, and a GMG on them converges."""
    h = hierarchy_from_coarse((4, 4), num_levels=3)
    assert [m.ncells for m in h.meshes] == [(16, 16), (8, 8), (4, 4)]
    assert [m.ncells for m in h.meshes] == \
        [m.ncells for m in j_hierarchy_from_coarse((4, 4), num_levels=3).meshes]
    o = octree_cartesian_hierarchy((2, 3), 3, num_refs_coarse=1)
    assert [m.ncells for m in o.meshes] == \
        [m.ncells for m in j_octree((2, 3), 3, num_refs_coarse=1).meshes]

    def assemble(m):
        return eliminate_dirichlet(laplacian(m, torch.float64, "cpu"), m.boundary_vertex_mask())

    mats = compute_hierarchy_matrices(h, assemble)
    assert len(mats) == 3 and mats[0].n == 17 * 17
    P, R = setup_transfer_operators(h, device="cpu")
    gmg = TL.GMGSolver(coarse_ops=tuple(mats[1:]), prolongations=tuple(P),
                       restrictions=tuple(R), smoother=TL.ChebyshevSmoother(degree=3),
                       coarsest_solver=TL.DenseLUSolver())
    prob = poisson_problem((16, 16), device="cpu")
    cg = TL.CGSolver(Pl=gmg, rtol=1e-8, maxiter=25)
    x, stats = cg.solve(cg.setup(prob.A), prob.b)
    assert stats.converged() and float(prob.l2_error(x)) < 1e-6


def test_gmg_update_and_matrices_fn():
    """GMG's update() re-sets up at a new fine operator (transfers without
    an update hook kept), and `matrices_fn` with solution restrictions
    reassembles every level from the restricted iterate."""
    h = hierarchy_from_coarse((4, 4), num_levels=2)

    def assemble(m, scale=1.0):
        A = eliminate_dirichlet(laplacian(m, torch.float64, "cpu"), m.boundary_vertex_mask())
        return dataclasses.replace(A, bands=A.bands * scale)

    P, R = setup_transfer_operators(h, device="cpu")
    gmg = gmg_from_hierarchy(h, assemble, smoother=TL.ChebyshevSmoother(degree=3),
                             device="cpu")
    A0, A2 = assemble(h.meshes[0]), assemble(h.meshes[0], 2.0)
    st = gmg.setup(A0)
    st2 = gmg.update(st, A2)
    assert st2["mats"][0] is A2 and st2["P"] == st["P"] and st2["pre"][0]["A"] is A2
    r = torch.ones(A0.n, dtype=torch.float64)
    torch.testing.assert_close(gmg.apply(st2, r), 0.5 * gmg.apply(gmg.setup(A2), 2.0 * r))
    seen = []

    def matrices_fn(A, x):
        seen.append(None if x is None else x.shape[0])
        return [A, assemble(h.meshes[1])]

    sol_R = tuple(dataclasses.replace(r_, mode="solution") for r_ in R)
    g2 = TL.GMGSolver(prolongations=tuple(P), restrictions=tuple(R),
                      smoother=TL.ChebyshevSmoother(degree=3), matrices_fn=matrices_fn,
                      solution_restrictions=sol_R)
    xs = g2.project_solutions(torch.arange(A0.n, dtype=torch.float64))
    assert [x.shape[0] for x in xs] == [9 * 9, 5 * 5]
    assert float(xs[1][6]) == 20.0  # injection: coarse vertex (1, 1) is fine (2, 2)
    g2.setup(A0, torch.zeros(A0.n, dtype=torch.float64))
    assert seen == [9 * 9]
