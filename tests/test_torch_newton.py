"""The port's Newton solver, continuation, staggered and external solvers
against the JAX package.

Newton on the 8^2 manufactured-solution problem (nu = 1) as
tests/test_navier_stokes.py runs it, plain (dense LU velocity block) and
Picard-first, by both packages in f64 on the CPU (the grad-div augmented
run with the nonlinear velocity GMG is tests/test_torch_ns_gmg.py's).
Iteration counts and flags are equal; residual histories agree to rtol
1e-8 down to 1e-8 of the initial residual (below it the inner solves'
round-off differs), velocity errors to 1e-6 relative. The staggered
solver, BlockFEOperator and the SciPy wrapper run tests/test_staggered_projection.py's
cases in both packages on the same seeded inputs: solutions equal to 1e-10.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jax_reference_jit import jitted_jax_solves
from gridapsolvers_tpu.algebra import DenseMatrix as JDenseMatrix
from gridapsolvers_tpu.blocks import BlockTriangularSolver as JBlockTriangular
from gridapsolvers_tpu.blocks import MatrixBlock as JMatrixBlock
from gridapsolvers_tpu.blocks import NonlinearSystemBlock as JNonlinearBlock
from gridapsolvers_tpu.blocks.staggered import BlockFEOperator as JBlockFE
from gridapsolvers_tpu.blocks.staggered import StaggeredAffineOperator as JStaggeredAffine
from gridapsolvers_tpu.blocks.staggered import StaggeredNonlinearOperator as JStaggeredNonlinear
from gridapsolvers_tpu.blocks.staggered import StaggeredSolver as JStaggeredSolver
from gridapsolvers_tpu.fem.navier_stokes import navier_stokes_problem as j_ns_problem
from gridapsolvers_tpu.linear import CGSolver as JCG
from gridapsolvers_tpu.linear import DenseLUSolver as JDenseLU
from gridapsolvers_tpu.linear import FGMRESSolver as JFGMRES
from gridapsolvers_tpu.linear import GMRESSolver as JGMRES
from gridapsolvers_tpu.linear import JacobiSolver as JJacobi
from gridapsolvers_tpu.nonlinear import ContinuationOperator as JContinuation
from gridapsolvers_tpu.nonlinear import ContinuationSwitch as JSwitch
from gridapsolvers_tpu.nonlinear import NewtonSolver as JNewton
from gridapsolvers_tpu.nonlinear.external import ScipyNonlinearSolver as JScipyNonlinear

from gridapsolvers_tpu_torch.algebra import DenseMatrix
from gridapsolvers_tpu_torch.blocks import BlockTriangularSolver, MatrixBlock, NonlinearSystemBlock
from gridapsolvers_tpu_torch.blocks.staggered import (
    BlockFEOperator,
    StaggeredAffineOperator,
    StaggeredNonlinearOperator,
    StaggeredSolver,
)
from gridapsolvers_tpu_torch.fem.navier_stokes import navier_stokes_problem
from gridapsolvers_tpu_torch.linear import (
    CGSolver,
    DenseLUSolver,
    FGMRESSolver,
    GMRESSolver,
    JacobiSolver,
)
from gridapsolvers_tpu_torch.models import solve_navier_stokes
from gridapsolvers_tpu_torch.nonlinear import (
    ContinuationOperator,
    ContinuationSwitch,
    NewtonSolver,
)
from gridapsolvers_tpu_torch.nonlinear.external import ScipyNonlinearSolver

torch.set_num_threads(1)


HIST_RTOL = 1e-8
HIST_FLOOR = 1e-8   # of the initial residual
ERR_RTOL = 1e-6

# the port's and JAX's constructors and solvers, by the same names
PORT = dict(problem=lambda *a, **k: navier_stokes_problem(*a, device="cpu", **k),
            BT=BlockTriangularSolver, MB=MatrixBlock, NB=NonlinearSystemBlock, CG=CGSolver,
            J=JacobiSolver, LU=DenseLUSolver, F=FGMRESSolver, N=NewtonSolver,
            C=ContinuationOperator, S=ContinuationSwitch)
JAX = dict(problem=j_ns_problem, BT=JBlockTriangular, MB=JMatrixBlock,
           NB=JNonlinearBlock, CG=JCG, J=JJacobi, LU=JDenseLU, F=JFGMRES, N=JNewton,
           C=JContinuation, S=JSwitch)


class _Picard:
    def __init__(self, prob):
        self.prob = prob

    def residual(self, x):
        return self.prob.residual(x)

    def jacobian(self, x):
        return self.prob.picard_jacobian(x)


def _run(P, kind):
    """tests/test_navier_stokes.py's Newton runs at 8^2 with nu = 1 in one
    package: 'plain' (_newton, dense LU velocity block) or 'picard' (two
    Picard Jacobians first). JAX runs the plain one in its device loop,
    which its own tests hold equal to its host loop
    (tests/test_navier_stokes.py:215), and the Picard-first one, whose
    switch counts on the host, in its host loop. (The grad-div augmented
    run is tests/test_torch_ns_gmg.py's.) Returns (stats, velocity
    error)."""
    prob = P["problem"]((8, 8), nu=1.0)
    pc = P["BT"](solvers=(P["LU"](), P["CG"](Pl=P["J"](), rtol=1e-10, maxiter=60)),
                 blocks=((P["NB"](), None), (None, P["MB"](prob.Mp))), half="upper")
    nw = dict(maxiter=20 if kind == "picard" else 15, rtol=1e-9, atol=1e-11)
    if P is JAX and kind != "picard":
        nw["loop"] = "device"
    newton = P["N"](P["F"](m=40, Pr=pc, rtol=1e-10, maxiter=120), **nw)
    op = P["C"](_Picard(prob), prob, P["S"](niter=2)) if kind == "picard" else prob
    x, stats = newton.solve(op, prob.zero_guess())
    return stats, prob.velocity_error(x[0])


@pytest.mark.parametrize("kind", ["plain", "picard"])
def test_newton_equal_jax(kind):
    # the plain run's JAX FGMRES solves are cheaper eager than compiled
    # (its Newton loop runs on the device, one FGMRES program a step)
    if kind == "plain":
        jstats, jerr = _run(JAX, kind)
    else:
        with jitted_jax_solves():
            jstats, jerr = _run(JAX, kind)
    stats, err = _run(PORT, kind)
    k = stats.niter
    assert (k, stats.flag) == (int(jstats.niter), int(jstats.flag)) and stats.converged()
    h, jh = stats.residuals.numpy(), np.asarray(jstats.residuals)
    assert np.isnan(h[k + 1:]).all() and h.shape == jh.shape
    np.testing.assert_allclose(h[: k + 1], jh[: k + 1], rtol=HIST_RTOL, atol=HIST_FLOOR * jh[0])
    assert err == pytest.approx(jerr, rel=ERR_RTOL) and err < 5e-4


def test_solve_navier_stokes_picard_first():
    """The model entry point: Newton from zero, plain and Picard-first, as
    the runs above (the same solvers) reach the manufactured solution."""
    for picard in (0, 2):
        x, stats, info = solve_navier_stokes((8, 8), picard_first=picard, device="cpu")
        assert stats.converged() and stats.niter <= 8 + picard
        assert info["velocity_error"] < 5e-4 and x[0][0].shape == (17 * 17,)


def test_newton_loops_and_refresh_count():
    """An unknown loop raises; the Jacobian is refreshed after every step
    but the last (and never after a step that reaches maxiter)."""
    prob = navier_stokes_problem((4, 4), nu=1.0, device="cpu")
    calls = {"jacobian": 0, "update": 0}

    class Counted:
        def residual(self, x):
            return prob.residual(x)

        def jacobian(self, x):
            calls["jacobian"] += 1
            return prob.jacobian(x)

    pc = BlockTriangularSolver(solvers=(DenseLUSolver(), CGSolver(Pl=JacobiSolver(), rtol=1e-12)),
                               blocks=((NonlinearSystemBlock(), None), (None, MatrixBlock(prob.Mp))))
    fg = FGMRESSolver(m=40, Pr=pc, rtol=1e-12, maxiter=100)

    class Linear:
        def setup(self, A, x=None):
            return fg.setup(A, x)

        def update(self, state, A, x=None):
            calls["update"] += 1
            return fg.update(state, A, x)

        def solve(self, state, b, x0=None):
            return fg.solve(state, b, x0)

    runs = []
    for maxiter in (20, 1):
        calls.update(jacobian=0, update=0)
        x, st = NewtonSolver(Linear(), maxiter=maxiter, rtol=1e-10).solve(
            Counted(), prob.zero_guess())
        runs.append(st)
        assert calls == {"jacobian": st.niter, "update": st.niter - 1}
    assert runs[0].niter == 2 and runs[0].converged()
    assert runs[1].niter == 1 and runs[1].flag == 3
    with pytest.raises(ValueError, match="loop"):
        NewtonSolver(fg, loop="jit")


def test_continuation_switch():
    """After `niter` Jacobians, or when the callback fires, for good."""
    sw = ContinuationSwitch(niter=2)
    assert [sw.should_switch(None) for _ in range(4)] == [False, False, True, True]
    seen = []
    sw = ContinuationSwitch(callback=lambda x, n: seen.append(n) or n == 3)
    assert [sw.should_switch(None) for _ in range(4)] == [False, False, True, True]
    assert seen == [1, 2, 3]


# the staggered, block and SciPy solvers' classes in each package, and how
# a package makes a vector from a numpy array
PORT_S = dict(vec=torch.from_numpy, diag=torch.diag, D=DenseMatrix, LU=DenseLUSolver,
              GMRES=GMRESSolver, N=NewtonSolver, SA=StaggeredAffineOperator,
              SN=StaggeredNonlinearOperator, SS=StaggeredSolver, BFE=BlockFEOperator,
              SCIPY=ScipyNonlinearSolver)
JAX_S = dict(vec=jnp.asarray, diag=jnp.diag, D=JDenseMatrix, LU=JDenseLU, GMRES=JGMRES, N=JNewton,
             SA=JStaggeredAffine, SN=JStaggeredNonlinear, SS=JStaggeredSolver, BFE=JBlockFE,
             SCIPY=JScipyNonlinear)
SOL_RTOL = 1e-10   # of the largest entry: dense LU and GMRES at rtol 1e-12


def _assert_same(x, jx, rtol=SOL_RTOL):
    x = np.concatenate([np.ravel(np.asarray(v)) for v in (x if isinstance(x, tuple) else (x,))])
    jx = np.concatenate([np.ravel(np.asarray(v)) for v in (jx if isinstance(jx, tuple) else (jx,))])
    np.testing.assert_allclose(x, jx, rtol=0, atol=rtol * np.max(np.abs(jx)))


def _staggered_affine(P):
    """tests/test_staggered_projection.py:22 in one package: stage 2 takes
    stage 1's solution. Returns (solution, cached re-solve, the monolithic
    block-triangular solution from numpy)."""
    rng = np.random.default_rng(0)
    n = 20
    A1n, A2n = (rng.normal(size=(n, n)) + 5 * np.eye(n) for _ in range(2))
    Cn = rng.normal(size=(n, n))
    b1n, b2n = (rng.normal(size=n) for _ in range(2))
    A1, A2, C, b1, b2 = (P["vec"](a) for a in (A1n, A2n, Cn, b1n, b2n))
    op = P["SA"](operators=[lambda up: P["D"](A1), lambda up: P["D"](A2)],
                 rhs=[lambda up: b1, lambda up: b2 - C @ up[0]])
    solver = P["SS"]([P["LU"](), P["LU"]()])
    x, cache = solver.solve(op)
    y, _ = solver.solve(op, cache=cache)
    x1 = np.linalg.solve(A1n, b1n)
    return x, y, (x1, np.linalg.solve(A2n, b2n - Cn @ x1))


def test_staggered_affine_two_stage():
    """The two-stage affine solve and its cached re-solve by both packages
    on the same seeded inputs: equal to each other to 1e-10, and to the
    monolithic block-triangular solve (JAX's test's own check)."""
    x, y, ref = _staggered_affine(PORT_S)
    jx, jy, _ = _staggered_affine(JAX_S)
    _assert_same(x, jx)
    _assert_same(y, jy)
    _assert_same(x, ref, 1e-9)


def _block_fe(P):
    """tests/test_staggered_projection.py:53 in one package (BlockFEOperator:
    the linear blocks kept, the nonlinear one re-assembled; Newton with
    GMRES), and the same system as two nonlinear stages through
    StaggeredSolver (the second stage takes the first's solution). Returns
    (Newton stats, solution, residual norm, staggered solution, cache)."""
    rng = np.random.default_rng(1)
    n = 12
    A, B = (P["vec"](a) for a in (rng.normal(size=(n, n)) + 6 * np.eye(n),
                                  0.1 * rng.normal(size=(n, n))))
    rhs = (P["vec"](rng.normal(size=n)), P["vec"](rng.normal(size=n)))
    zero = P["vec"](np.zeros(n))

    op = P["BFE"](blocks=[[P["D"](A), P["D"](B)],
                          [None, lambda x: P["D"](P["diag"](3.0 + x[1] ** 2))]], rhs=rhs)
    newton = P["N"](P["GMRES"](m=30, rtol=1e-12, maxiter=200), maxiter=30, rtol=1e-10)
    x, stats = newton.solve(op, (zero, zero))
    rnorm = float(np.linalg.norm(np.concatenate([np.asarray(v) for v in op.residual(x)])))

    class Stage:
        def __init__(self, fn, jac):
            self.fn, self.jac = fn, jac

        def residual(self, v):
            return self.fn(v)

        def jacobian(self, v):
            return P["D"](self.jac(v))

    stages = [
        lambda up: Stage(lambda v: (3.0 + v ** 2) * v - rhs[1],
                         lambda v: P["diag"](3.0 + 3 * v ** 2)),
        lambda up: Stage(lambda v: A @ v + B @ up[0] - rhs[0], lambda v: A),
    ]
    sop = P["SN"](stages, initial_guesses=[zero, zero])
    xs, cache = P["SS"]([newton, newton]).solve(sop)
    return stats, x, rnorm, xs, cache


def test_staggered_nonlinear_and_block_fe_operator_newton():
    """BlockFEOperator under Newton and the two nonlinear stages under
    StaggeredSolver, by both packages on the same seeded inputs: equal
    Newton counts and flags, solutions equal to 1e-10; the residual below
    JAX's test's 1e-8, and the staggered solve equal to the monolithic one.
    A nonlinear stage with no initial guess raises."""
    stats, x, rnorm, (x2, x1), cache = _block_fe(PORT_S)
    with jitted_jax_solves():
        jstats, jx, _, (jx2, jx1), _ = _block_fe(JAX_S)
    assert (stats.niter, stats.flag) == (int(jstats.niter), int(jstats.flag))
    assert stats.converged() and rnorm < 1e-8 and cache == [None, None]
    _assert_same(x, jx)
    _assert_same((x1, x2), (jx1, jx2))
    _assert_same((x1, x2), x, 1e-9)
    with pytest.raises(ValueError, match="initial guess"):
        StaggeredSolver([None, None]).solve(StaggeredNonlinearOperator([lambda up: None] * 2))


def _scipy_wrapper(P):
    """tests/test_staggered_projection.py:170 in one package: scipy's
    Newton-Krylov with the package's dense LU as the inner
    preconditioner. Returns (x, residual norm)."""
    n = 10
    rng = np.random.default_rng(0)
    A, b = P["vec"](rng.normal(size=(n, n)) + 4 * np.eye(n)), P["vec"](rng.normal(size=n))

    class Op:
        def residual(self, x):
            return A @ x + 0.1 * x ** 3 - b

        def jacobian(self, x):
            return P["D"](A + P["diag"](0.3 * x ** 2))

    x, _ = P["SCIPY"](method="krylov", linear=P["LU"](), tol=1e-10).solve(
        Op(), P["vec"](np.zeros(n)))
    return x, float(np.linalg.norm(np.asarray(Op().residual(x))))


def test_scipy_nonlinear_wrapper():
    """The SciPy wrapper by both packages on the same seeded inputs: the
    same iterate to 1e-10 of its largest entry, an f64 tensor on the port's
    side, and the residual under JAX's test's 1e-7."""
    x, rnorm = _scipy_wrapper(PORT_S)
    jx, _ = _scipy_wrapper(JAX_S)
    assert isinstance(x, torch.Tensor) and x.dtype == torch.float64
    assert rnorm < 1e-7
    _assert_same(x, jx)
