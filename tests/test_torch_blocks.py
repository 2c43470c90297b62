"""The port's element tables, general assembly, block operators and block
solvers against the JAX package.

Both packages build the same f64 systems on the host with the same NumPy
and scipy code, so element matrices agree to 1e-14 and assembled CSRs are
equal in pattern and values; the port's Dirichlet elimination (diagonal
scaling) is held equal to the JAX package's LIL assignment. Operator
applies and block-solver applies agree to 1e-12 of their largest entry
(the two reduce sums in different orders); a Krylov solve's iteration
count and flag are equal and its residual history agrees to rtol 1e-8
(entries under 1e-8 of the initial residual, where the inner CG's rtol
leaves the preconditioner defined only to that, to that floor).
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from jax_reference_jit import jitted_jax_dense, jsolve

import gridapsolvers_tpu.blocks as JB
import gridapsolvers_tpu.fem.assembly2 as jasm
import gridapsolvers_tpu.fem.elements as jel
import gridapsolvers_tpu.linear as JL
from gridapsolvers_tpu.algebra.convert import to_scipy as j_to_scipy
from gridapsolvers_tpu.algebra.dense import DenseMatrix as JDense
from gridapsolvers_tpu.algebra.ell import ell_to_scipy as j_ell_to_scipy
from gridapsolvers_tpu.fem.mesh import CartesianMesh as JMesh
from gridapsolvers_tpu.fem.stokes import stokes_problem as j_stokes_problem
from gridapsolvers_tpu.linear.schur import SchurComplementSolver as JSchur

import gridapsolvers_tpu_torch.blocks as TB
import gridapsolvers_tpu_torch.fem.assembly2 as asm
import gridapsolvers_tpu_torch.fem.elements as el
import gridapsolvers_tpu_torch.linear as TL
from gridapsolvers_tpu_torch.algebra import DenseMatrix, ell_to_scipy, to_scipy
from gridapsolvers_tpu_torch.fem import CartesianMesh
from gridapsolvers_tpu_torch.fem.stokes import stokes_problem
from gridapsolvers_tpu_torch.utils import pytrees as pt

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _compiled_jax_dense():
    """The JAX package's `ELLMatrix.todense` runs compiled
    (`jitted_jax_dense`)."""
    with jitted_jax_dense():
        yield


def _solve(solver, A, b, jax_side):
    """solver.solve from its set-up; the JAX package's compiled."""
    return (jsolve if jax_side else type(solver).solve)(solver, solver.setup(A), b)


ELEM_ATOL = 1e-14
APPLY_RTOL = 1e-12
HIST_RTOL = 1e-8
HIST_FLOOR = 1e-8   # of the initial residual: the inner CG's rtol
FINAL_RTOL = 1e-6   # the final residual ratio ||r_k|| / ||r_0||
SHAPES = [(8, 8), (16, 16), (4, 4, 4)]


def _meshes(ncells):
    domain = tuple(x for _ in ncells for x in (0.0, 1.0))
    return CartesianMesh(tuple(ncells), domain), JMesh(tuple(ncells), domain)


def _assert_close(y, y_ref, rtol=APPLY_RTOL):
    y = np.concatenate([np.ravel(np.asarray(v, dtype=np.float64)) for v in pt.tree_leaves(y)])
    y_ref = np.concatenate([np.ravel(np.asarray(v, dtype=np.float64))
                            for v in _jleaves(y_ref)])
    scale = np.max(np.abs(y_ref))
    assert y.shape == y_ref.shape and scale > 0
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=rtol * scale)


def _jleaves(x):
    if isinstance(x, (tuple, list)):
        return [leaf for xi in x for leaf in _jleaves(xi)]
    return [x]


def _eq_csr(S, jS):
    S, jS = S.tocsr(), jS.tocsr()
    S.sort_indices()
    jS.sort_indices()
    assert S.shape == jS.shape and S.dtype == jS.dtype
    np.testing.assert_array_equal(S.indptr, jS.indptr)
    np.testing.assert_array_equal(S.indices, jS.indices)
    np.testing.assert_array_equal(S.data, jS.data)


def _random_block(prob, seed):
    """A random block vector shaped like prob.b: (tuple(torch), tuple(jnp))."""
    rng = np.random.default_rng(seed)
    (bu, bp) = prob.b
    u = tuple(rng.normal(size=v.shape[0]) for v in bu)
    p = rng.normal(size=bp.shape[0])
    return ((tuple(torch.from_numpy(v) for v in u), torch.from_numpy(p)),
            (tuple(jnp.asarray(v) for v in u), jnp.asarray(p)))


# ------------------------------------------------------------ elements -----


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("h", [(0.5,), (0.25, 0.125), (0.5, 0.25, 0.125)])
def test_element_matrices_equal_jax(order, h):
    e, je = el.TensorElement(order, h), jel.TensorElement(order, h)
    np.testing.assert_array_equal(e.node_offsets(), je.node_offsets())
    for fn in ("stiffness", "mass_matrix"):
        np.testing.assert_allclose(getattr(el, fn)(e), getattr(jel, fn)(je), rtol=0,
                                   atol=ELEM_ATOL)
    ep = el.TensorElement(1, h, nquad=3)
    jep = jel.TensorElement(1, h, nquad=3)
    e2, je2 = el.TensorElement(2, h), jel.TensorElement(2, h)
    for c in range(len(h)):
        np.testing.assert_allclose(el.mixed_divergence(e2, ep, c),
                                   jel.mixed_divergence(je2, jep, c), rtol=0, atol=ELEM_ATOL)
        np.testing.assert_allclose(el.mixed_divergence_pdisc(e2, c),
                                   jel.mixed_divergence_pdisc(je2, c), rtol=0, atol=ELEM_ATOL)
    np.testing.assert_allclose(el.pdisc_mass(e2), jel.pdisc_mass(je2), rtol=0, atol=ELEM_ATOL)
    for row, jrow in zip(el.graddiv_element(e2, 1e3), jel.graddiv_element(je2, 1e3)):
        for G, jG in zip(row, jrow):
            np.testing.assert_allclose(G, jG, rtol=ELEM_ATOL, atol=ELEM_ATOL)


# ----------------------------------------------------------- assembly2 -----


@pytest.mark.parametrize("ncells", SHAPES)
def test_assembly2_csr_equal_jax(ncells):
    m, jm = _meshes(ncells)
    dim = len(ncells)
    for order in (1, 2):
        assert asm.node_grid_shape(m, order) == jasm.node_grid_shape(jm, order)
        np.testing.assert_array_equal(asm.connectivity(m, order), jasm.connectivity(jm, order))
        np.testing.assert_array_equal(asm.node_coords(m, order), jasm.node_coords(jm, order))
        np.testing.assert_array_equal(asm.boundary_node_mask(m, order),
                                      jasm.boundary_node_mask(jm, order))
        for kind in ("stiffness", "mass"):
            _eq_csr(asm.assemble_bilinear(m, order, kind, scale=0.7),
                    jasm.assemble_bilinear(jm, order, kind, scale=0.7))
    mask = jasm.boundary_node_mask(jm, 2)
    for c in range(dim):
        B = asm.assemble_divergence(m, 2, 1, c)
        _eq_csr(B, jasm.assemble_divergence(jm, 2, 1, c))
        _eq_csr(asm.zero_columns(B, mask), jasm.zero_columns(B, mask))
        _eq_csr(asm.zero_rows(B.T.tocsr(), mask), jasm.zero_rows(B.T.tocsr(), mask))
        _eq_csr(asm.assemble_divergence_pdisc(m, 2, c),
                jasm.assemble_divergence_pdisc(jm, 2, c))
    _eq_csr(asm.pdisc_mass_matrix(m), jasm.pdisc_mass_matrix(jm))
    np.testing.assert_array_equal(asm.pdisc_connectivity(m), jasm.pdisc_connectivity(jm))
    np.testing.assert_allclose(asm.project_pdisc(m, lambda x: np.sin(x.sum(axis=1))),
                               jasm.project_pdisc(jm, lambda x: np.sin(x.sum(axis=1))),
                               rtol=0, atol=ELEM_ATOL)
    for row, jrow in zip(asm.assemble_graddiv(m, 2, 10.0), jasm.assemble_graddiv(jm, 2, 10.0)):
        for G, jG in zip(row, jrow):
            _eq_csr(G, jG)
    # the diagonal-scaling elimination against the JAX package's LIL one
    K = jasm.assemble_bilinear(jm, 2, "stiffness")
    _eq_csr(asm.dirichlet_square(K, mask), jasm.dirichlet_square(K, mask))
    M1 = jasm.assemble_bilinear(jm, 1, "mass")
    mask1 = jasm.boundary_node_mask(jm, 1)
    _eq_csr(asm.dirichlet_square(M1, mask1), jasm.dirichlet_square(M1, mask1))
    # to_ell: the same padded arrays as the JAX package's, in the dtype asked
    Bz = asm.zero_columns(asm.assemble_divergence(m, 2, 1, 0), mask)
    for S in (Bz, Bz.T.tocsr()):
        E, jE = asm.to_ell(S, device="cpu"), jasm.to_ell(S)
        np.testing.assert_array_equal(E.values.numpy(), np.asarray(jE.values))
        np.testing.assert_array_equal(E.cols.numpy(), np.asarray(jE.cols))
        assert E.ncols == jE.ncols
        _eq_csr(ell_to_scipy(E), j_ell_to_scipy(jE))
        assert asm.to_ell(S, dtype=torch.float32, device="cpu").dtype == torch.float32


def test_dirichlet_square_random_masks():
    """Any mask, any square matrix with explicit zeros and unsorted
    duplicates: the same CSR as the LIL elimination."""
    rng = np.random.default_rng(0)
    for n in (1, 7, 60):
        S = sp.random(n, n, density=0.3, random_state=n, format="coo")
        S = sp.coo_matrix((np.concatenate([S.data, np.zeros(3)]),
                           (np.concatenate([S.row, rng.integers(0, n, 3)]),
                            np.concatenate([S.col, rng.integers(0, n, 3)]))), shape=(n, n))
        S = S.tocsr()
        for mask in (rng.random(n) < 0.3, np.zeros(n, bool), np.ones(n, bool)):
            _eq_csr(asm.dirichlet_square(S, mask), jasm.dirichlet_square(S, mask))


# ----------------------------------------------------- block operators -----


@pytest.fixture(scope="module")
def stokes16():
    return stokes_problem((16, 16), device="cpu"), j_stokes_problem((16, 16))


@pytest.fixture(scope="module")
def stokes8():
    return stokes_problem((8, 8), device="cpu"), j_stokes_problem((8, 8))


def test_block_operators_equal_jax(stokes16):
    prob, jprob = stokes16
    x, jx = _random_block(prob, 1)
    _assert_close(prob.A.matvec(x), jprob.A.matvec(jx))
    K, jK = prob.A.block(0, 0), jprob.A.block(0, 0)
    _assert_close(K.matvec(x[0]), jK.matvec(jx[0]))
    _assert_close(K.diag(), jK.diag(), 0)
    _assert_close(K.abs_row_sum(), jK.abs_row_sum(), APPLY_RTOL)
    np.testing.assert_array_equal(K.todense().numpy(), np.asarray(jK.todense()))
    assert K.shape == jK.shape and K.dtype == torch.float64 and K.device.type == "cpu"
    for (i, j) in ((0, 1), (1, 0)):
        blk, jblk = prob.A.block(i, j), jprob.A.block(i, j)
        assert blk.shape == jblk.shape
        _assert_close(blk.matvec(x[j]), jblk.matvec(jx[j]))
        _eq_csr(to_scipy(blk), j_to_scipy(jblk))
    assert prob.A.block(1, 1) is None and prob.A.nblocks == 2
    assert prob.A.dtype == torch.float64 and prob.A.device.type == "cpu"
    # the whole system: scipy CSR equal, dense equal to it, diag per block
    S = to_scipy(prob.A)
    _eq_csr(S, j_to_scipy(jprob.A))
    np.testing.assert_array_equal(prob.A.todense().numpy(), S.toarray())
    # a block-diagonal BlockOperator: diag per block, dense as JAX's
    from gridapsolvers_tpu.algebra import BlockOperator as JBlockOperator

    from gridapsolvers_tpu_torch.algebra import BlockOperator

    D = BlockOperator(((K, None), (None, prob.Mp)))
    jD = JBlockOperator(((jK, None), (None, jprob.Mp)))
    _assert_close(D.diag(), jD.diag(), 0)
    _assert_close(D.matvec(x), jD.matvec(jx))
    np.testing.assert_array_equal(D.todense().numpy(), np.asarray(jD.todense()))
    # the pressure mass (banded Q1) and the velocity mass (ELL)
    _assert_close(prob.Mp.matvec(x[1]), jprob.Mp.matvec(jx[1]))
    _assert_close(prob.Mu.matvec(x[0][0]), jprob.Mu.matvec(jx[0][0]))
    # problem data
    _assert_close(prob.b, jprob.b)
    _assert_close(prob.u_exact, jprob.u_exact, 0)
    _assert_close(prob.p_exact, jprob.p_exact, 0)
    assert prob.residual_norm(x) == pytest.approx(jprob.residual_norm(jx), rel=APPLY_RTOL)
    assert prob.velocity_error(x[0]) == pytest.approx(jprob.velocity_error(jx[0]),
                                                      rel=APPLY_RTOL)
    assert prob.pressure_error(x[1]) == pytest.approx(jprob.pressure_error(jx[1]),
                                                      rel=APPLY_RTOL)


def test_dense_matrix_equal_jax():
    a = np.random.default_rng(3).normal(size=(9, 9))
    D, jD = DenseMatrix(torch.from_numpy(a)), JDense(jnp.asarray(a))
    x = np.random.default_rng(4).normal(size=9)
    _assert_close(D.matvec(torch.from_numpy(x)), jD.matvec(jnp.asarray(x)))
    _assert_close(D.diag(), jD.diag(), 0)
    _assert_close(D.abs_row_sum(), jD.abs_row_sum())
    assert D.shape == jD.shape and D.nnz == jD.nnz and D.astype(torch.float32).dtype == torch.float32
    np.testing.assert_array_equal(to_scipy(D).toarray(), j_to_scipy(jD).toarray())


# ------------------------------------------------------- block solvers -----


def _block_solver_cases(prob, jprob):
    """(port solver, JAX solver) pairs with dense inner solvers, every
    SolverBlock kind among them."""
    Mp, jMp = prob.Mp, jprob.Mp
    return {
        "diag": (
            TB.BlockDiagonalSolver(solvers=(TL.DenseLUSolver(), TL.DenseLUSolver()),
                                   blocks=(None, TB.MatrixBlock(Mp))),
            JB.BlockDiagonalSolver(solvers=(JL.DenseLUSolver(), JL.DenseLUSolver()),
                                   blocks=(None, JB.MatrixBlock(jMp))),
        ),
        "upper": (
            TB.BlockTriangularSolver(solvers=(TL.DenseLUSolver(), TL.DenseLUSolver()),
                                     blocks=((None, None), (None, TB.MatrixBlock(Mp))),
                                     half="upper"),
            JB.BlockTriangularSolver(solvers=(JL.DenseLUSolver(), JL.DenseLUSolver()),
                                     blocks=((None, None), (None, JB.MatrixBlock(jMp))),
                                     half="upper"),
        ),
        "lower": (
            TB.BlockTriangularSolver(solvers=(TL.DenseLUSolver(), TL.DenseInverseSolver()),
                                     blocks=((TB.LinearSystemBlock(), None),
                                             (TB.NonlinearSystemBlock(),
                                              TB.BiformBlock(lambda: Mp))),
                                     half="lower"),
            JB.BlockTriangularSolver(solvers=(JL.DenseLUSolver(), JL.DenseInverseSolver()),
                                     blocks=((JB.LinearSystemBlock(), None),
                                             (JB.NonlinearSystemBlock(),
                                              JB.BiformBlock(lambda: jMp))),
                                     half="lower"),
        ),
        "coeffs": (
            TB.BlockTriangularSolver(solvers=(TL.DenseLUSolver(), TL.DenseLUSolver()),
                                     blocks=((None, TB.TriformBlock(lambda x: prob.A.block(0, 1))),
                                             (None, TB.MatrixBlock(Mp))),
                                     coeffs=((1.0, 0.5), (0.0, 1.0)), half="upper"),
            JB.BlockTriangularSolver(solvers=(JL.DenseLUSolver(), JL.DenseLUSolver()),
                                     blocks=((None, JB.TriformBlock(lambda x: jprob.A.block(0, 1))),
                                             (None, JB.MatrixBlock(jMp))),
                                     coeffs=((1.0, 0.5), (0.0, 1.0)), half="upper"),
        ),
    }


@pytest.mark.parametrize("kind", ["diag", "upper", "lower", "coeffs"])
def test_block_solver_applies_equal_jax(stokes8, kind):
    prob, jprob = stokes8
    solver, jsolver = _block_solver_cases(prob, jprob)[kind]
    r, jr = _random_block(prob, 5)
    x, jx = _random_block(prob, 6)
    state, jstate = solver.setup(prob.A, x), jsolver.setup(jprob.A, jx)
    _assert_close(solver.apply(state, r), jsolver.apply(jstate, jr))
    z, stats = solver.solve(state, r)
    assert stats is None
    _assert_close(z, jsolver.apply(jstate, jr))
    # update re-extracts the nonlinear blocks at the new iterate
    state = solver.update(state, prob.A, r)
    jstate = jsolver.update(jstate, jprob.A, jr)
    _assert_close(solver.apply(state, x), jsolver.apply(jstate, jx))
    assert TB.BlockDiagonalSmoother is TB.BlockDiagonalSolver


def test_schur_complement_fgmres_equal_jax(stokes16):
    """tests/test_stokes.py::test_stokes_schur_complement: FGMRES(40) with
    the exact Schur-complement solver (dense LU velocity, Jacobi-CG on the
    pressure mass as S̃)."""
    prob, jprob = stokes16

    def run(P_cls, p, Lmod):
        P = P_cls(A_solver=Lmod.DenseLUSolver(),
                  S_solver=Lmod.CGSolver(Pl=Lmod.JacobiSolver(), rtol=1e-8, maxiter=50),
                  S_op=p.Mp)
        solver = Lmod.FGMRESSolver(m=40, Pr=P, rtol=1e-9, maxiter=100)
        return _solve(solver, p.A, p.b, Lmod is JL)

    x, st = run(TL.SchurComplementSolver, prob, TL)
    jx, jst = run(JSchur, jprob, JL)
    assert st.niter == int(jst.niter) < 50 and int(st.flag) == int(jst.flag) == 2
    k = st.niter
    jh = np.asarray(jst.residuals)[: k + 1]
    h = st.residuals.numpy()[: k + 1]
    np.testing.assert_allclose(h, jh, rtol=HIST_RTOL, atol=HIST_FLOOR * jh[0])
    assert h[k] / h[0] == pytest.approx(jh[k] / jh[0], rel=FINAL_RTOL)
    _assert_close(x, jx, 1e-8)
    assert prob.residual_norm(x) < 1e-7
    # its update path re-reads every block
    state = TL.SchurComplementSolver(TL.DenseLUSolver(), TL.DenseLUSolver(), prob.Mp).setup(prob.A)
    state = TL.SchurComplementSolver(TL.DenseLUSolver(), TL.DenseLUSolver(), prob.Mp).update(
        state, prob.A)
    assert state["B"] is prob.A.block(0, 1) and state["C"] is prob.A.block(1, 0)


def test_stokes_3d_block_triangular_equal_jax():
    """tests/test_stokes.py::test_stokes_3d: FGMRES(40) with the upper
    block-triangular preconditioner (dense LU velocity, Jacobi-CG pressure
    mass) on a 4^3 Taylor-Hood system."""
    def run(prob, B, L):
        P = B.BlockTriangularSolver(
            solvers=(L.DenseLUSolver(), L.CGSolver(Pl=L.JacobiSolver(), rtol=1e-8, maxiter=60)),
            blocks=((None, None), (None, B.MatrixBlock(prob.Mp))),
            half="upper",
        )
        solver = L.FGMRESSolver(m=40, Pr=P, rtol=1e-9, maxiter=100)
        return _solve(solver, prob.A, prob.b, L is JL)

    prob, jprob = stokes_problem((4, 4, 4), device="cpu"), j_stokes_problem((4, 4, 4))
    x, stats = run(prob, TB, TL)
    jx, jstats = run(jprob, JB, JL)
    assert stats.niter == int(jstats.niter) and int(stats.flag) == int(jstats.flag) == 2
    k, jh = stats.niter, np.asarray(jstats.residuals)[: stats.niter + 1]
    np.testing.assert_allclose(stats.residuals.numpy()[: k + 1], jh, rtol=HIST_RTOL,
                               atol=HIST_FLOOR * jh[0])
    assert prob.residual_norm(x) < 1e-7
    assert prob.velocity_error(x[0]) < 5e-3
    assert prob.velocity_error(x[0]) == pytest.approx(jprob.velocity_error(jx[0]), rel=1e-6)


def test_block_diagonal_minres_equal_jax(stokes8):
    """tests/test_stokes.py::test_stokes_block_diagonal_minres at 8^2:
    MINRES with the block-diagonal preconditioner (dense LU velocity,
    Jacobi-CG pressure mass) on tuple vectors."""
    def run(prob, B, L):
        P = B.BlockDiagonalSolver(
            solvers=(L.DenseLUSolver(), L.CGSolver(Pl=L.JacobiSolver(), rtol=1e-8, maxiter=50)),
            blocks=(None, B.MatrixBlock(prob.Mp)),
        )
        solver = L.MINRESSolver(Pl=P, rtol=1e-9, maxiter=200)
        return _solve(solver, prob.A, prob.b, L is JL)

    prob, jprob = stokes8
    x, stats = run(prob, TB, TL)
    jx, jstats = run(jprob, JB, JL)
    assert stats.niter == int(jstats.niter) < 80 and int(stats.flag) == int(jstats.flag) == 2
    k, jh = stats.niter, np.asarray(jstats.residuals)[: stats.niter + 1]
    np.testing.assert_allclose(stats.residuals.numpy()[: k + 1], jh, rtol=HIST_RTOL,
                               atol=HIST_FLOOR * jh[0])
    _assert_close(x, jx, 1e-8)
    assert prob.velocity_error(x[0]) < 5e-4 and prob.pressure_error(x[1]) < 5e-2
