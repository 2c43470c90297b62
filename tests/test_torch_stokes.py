"""The port's plain Stokes path (BASELINE config 3) against the JAX package.

Both packages assemble the same f64 Taylor-Hood Q2/Q1 systems on the host
(tests/test_torch_blocks.py holds the assembly equal) and solve them with
FGMRES and the upper block-triangular preconditioner (velocity GMG,
pressure mass by Jacobi-CG). Iteration counts and flags are equal,
residual histories agree to rtol 1e-8, and velocity and pressure errors
to 1e-6 relative. The inner pressure CG stops at rtol 1e-8, so the
preconditioner, and with it the outer residual, is defined to 1e-8 of the
initial residual: below that the two histories differ by what the two
inner solves' round-off leaves (each package reduces its sums in its own
order), and entries under that floor are compared to it; the final
residual ratio is also held on its own, to 1e-6 relative.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gridapsolvers_tpu.blocks import BlockTriangularSolver as JBlockTriangularSolver
from gridapsolvers_tpu.blocks import MatrixBlock as JMatrixBlock
from gridapsolvers_tpu.fem.stokes import stokes_problem as j_stokes_problem
from gridapsolvers_tpu.fem.stokes import velocity_gmg as j_velocity_gmg
from gridapsolvers_tpu.linear import CGSolver as JCGSolver
from gridapsolvers_tpu.linear import FGMRESSolver as JFGMRESSolver
from gridapsolvers_tpu.linear import JacobiSolver as JJacobiSolver

import gridapsolvers_tpu_torch.blocks as TB
import gridapsolvers_tpu_torch.linear as TL
from gridapsolvers_tpu_torch import convert
from gridapsolvers_tpu_torch.fem import stokes as tstokes
from gridapsolvers_tpu_torch.fem.stokes import stokes_problem, velocity_gmg
from gridapsolvers_tpu_torch.models import solve_stokes
from gridapsolvers_tpu_torch.ops import banded_stencil, ell_spmv
from gridapsolvers_tpu_torch.utils import pytrees as pt

torch.set_num_threads(1)

HIST_RTOL = 1e-8
HIST_FLOOR = 1e-8   # of the initial residual: the inner CG's rtol
FINAL_RTOL = 1e-6   # the final residual ratio ||r_k|| / ||r_0||
ERR_RTOL = 1e-6


def _jleaves(x):
    if isinstance(x, (tuple, list)):
        return [leaf for xi in x for leaf in _jleaves(xi)]
    return [x]


def _flat(x):
    return np.concatenate([np.ravel(np.asarray(v, dtype=np.float64)) for v in _jleaves(x)])


def _assert_close(y, y_ref, rtol):
    y, y_ref = _flat(y), _flat(y_ref)
    scale = np.max(np.abs(y_ref))
    assert y.shape == y_ref.shape and scale > 0
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=rtol * scale)


def _assert_same_solve(stats, jstats):
    assert stats.niter == int(jstats.niter)
    assert int(stats.flag) == int(jstats.flag)
    k = stats.niter
    h, jh = stats.residuals.numpy()[: k + 1], np.asarray(jstats.residuals)[: k + 1]
    np.testing.assert_allclose(h, jh, rtol=HIST_RTOL, atol=HIST_FLOOR * jh[0])
    # the entries under the floor: the final residual ratio on its own
    assert h[k] / h[0] == pytest.approx(jh[k] / jh[0], rel=FINAL_RTOL)


def _spec(op):
    """The numpy fields of a JAX operator, for convert.operator."""
    name = type(op).__name__
    if name == "BlockOperator":
        return {"blocks": [[None if b is None else _spec(b) for b in row] for row in op.blocks]}
    if name in ("ColumnStack", "RowStack", "FieldwiseOperator"):
        key = {"ColumnStack": "column_stack", "RowStack": "row_stack",
               "FieldwiseOperator": "fieldwise"}[name]
        return {key: [_spec(o) for o in op.ops]}
    if name == "ELLMatrix":
        return {"values": np.asarray(op.values), "cols": np.asarray(op.cols), "ncols": op.ncols}
    return {"bands": np.asarray(op.bands), "offsets": op.offsets, "grid_shape": op.grid_shape,
            "periodic": op.periodic}


def _numpy(v):
    if v is None:
        return None
    if isinstance(v, (tuple, list)):
        return tuple(_numpy(vi) for vi in v)
    return np.asarray(v)


# ------------------------------------------------------- solve_stokes -----


def _j_solve_stokes(ncells, num_levels):
    """The JAX package's solve_stokes (models/stokes.py) for the plain
    problem, its FGMRES solve under `jax.jit` (solve_stokes runs it eagerly,
    op by op, which takes several times longer on the CPU): the same
    problem, preconditioner and solver, and the same returns."""
    prob = j_stokes_problem(ncells)
    gmg = j_velocity_gmg(ncells, num_levels=num_levels, nu=1.0, ncycles=2)
    P = JBlockTriangularSolver(
        solvers=(gmg, JCGSolver(Pl=JJacobiSolver(), rtol=1e-8, maxiter=50)),
        blocks=((None, None), (None, JMatrixBlock(prob.Mp))), half="upper")
    solver = JFGMRESSolver(m=40, Pr=P, rtol=1e-9, maxiter=120)
    state = solver.setup(prob.A)
    x, stats = jax.jit(lambda b: solver.solve(state, b))(prob.b)
    info = {"residual": prob.residual_norm(x), "velocity_error": prob.velocity_error(x[0]),
            "pressure_error": prob.pressure_error(x[1])}
    return x, stats, info


@pytest.fixture(scope="module")
def jax_solves():
    """The JAX package's solve_stokes, once per case."""
    return {
        ((8, 8), 2, "mms"): _j_solve_stokes((8, 8), 2),
        ((16, 16), 3, "mms"): _j_solve_stokes((16, 16), 3),
    }


@pytest.mark.parametrize("ncells, levels, its", [((8, 8), 2, 24), ((16, 16), 3, 27)])
def test_solve_stokes_equal_jax(jax_solves, ncells, levels, its):
    jx, jstats, jinfo = jax_solves[(ncells, levels, "mms")]
    banded_stencil.counts.reset()
    ell_spmv.counts.reset()
    x, stats, info = solve_stokes(ncells, num_levels=levels, device="cpu")
    assert stats.niter == its and stats.converged()
    _assert_same_solve(stats, jstats)
    for key in ("velocity_error", "pressure_error"):
        assert info[key] == pytest.approx(jinfo[key], rel=ERR_RTOL)
    assert info["residual"] < 1e-7 and jinfo["residual"] < 1e-7
    _assert_close(x, jx, 1e-6)
    # every operator apply ran the plain versions on the CPU
    assert banded_stencil.counts.kernel == ell_spmv.counts.kernel == 0
    assert banded_stencil.counts.plain > 0 and ell_spmv.counts.plain > 0
    assert not banded_stencil.counts.shapes and not ell_spmv.counts.shapes


# ------------------------------------------------------- carried state ----


def test_convert_carries_the_jax_problem():
    """convert.stokes_problem: the JAX problem's operators and vectors,
    carried across, apply and measure as the JAX ones do, and the port's
    preconditioned solve on them equals its solve on its own assembly."""
    jprob = j_stokes_problem((8, 8))
    prob = convert.stokes_problem(
        jprob.mesh, _spec(jprob.A), _numpy(jprob.b), _spec(jprob.Mu), _spec(jprob.Mp),
        _numpy(jprob.u_exact), _numpy(jprob.p_exact), jprob.dirichlet_mask_u, jprob.nu,
        _numpy(jprob.const_p), device="cpu")
    own = stokes_problem((8, 8), device="cpu")
    rng = np.random.default_rng(11)
    x = (tuple(torch.from_numpy(rng.normal(size=v.shape[0])) for v in own.b[0]),
         torch.from_numpy(rng.normal(size=own.b[1].shape[0])))
    jx = (tuple(jnp.asarray(v.numpy()) for v in x[0]), jnp.asarray(x[1].numpy()))
    _assert_close(prob.A.matvec(x), jprob.A.matvec(jx), 1e-12)
    _assert_close(prob.A.matvec(x), own.A.matvec(x), 1e-12)
    assert prob.residual_norm(x) == pytest.approx(jprob.residual_norm(jx), rel=1e-12)
    assert prob.velocity_error(x[0]) == pytest.approx(jprob.velocity_error(jx[0]), rel=1e-12)
    assert prob.pressure_error(x[1]) == pytest.approx(jprob.pressure_error(jx[1]), rel=1e-12)

    def solve(p):
        P = TB.BlockTriangularSolver(
            solvers=(TL.DenseLUSolver(), TL.CGSolver(Pl=TL.JacobiSolver(), rtol=1e-8)),
            blocks=((None, None), (None, TB.MatrixBlock(p.Mp))), half="upper")
        solver = TL.FGMRESSolver(m=40, Pr=P, rtol=1e-9)
        return solver.solve(solver.setup(p.A), p.b)

    (xc, sc), (xo, so) = solve(prob), solve(own)
    assert sc.niter == so.niter and int(sc.flag) == int(so.flag) == 2
    _assert_close(xc, xo, 1e-8)


# ------------------------------------------------- what is not ported -----


def test_augmented_parts_raise_and_builders_default_to_the_card():
    """The augmented builders (ported since) run where they are asked to and
    default to the card like the plain ones: without one, each raises."""
    mesh = tstokes.CartesianMesh((4, 4), (0.0, 1.0, 0.0, 1.0))
    calls = (lambda: stokes_problem((4, 4)),
             lambda: velocity_gmg((4, 4), 2),
             lambda: stokes_problem((4, 4), graddiv_alpha=1e3),
             lambda: stokes_problem((4, 4), graddiv_alpha=1e3, engine="flat"),
             lambda: velocity_gmg((4, 4), 2, graddiv_alpha=1e3),
             lambda: solve_stokes((4, 4), graddiv_alpha=1e3),
             lambda: tstokes.graddiv_velocity_block(mesh, 1.0, 1e3))
    if not torch.cuda.is_available():
        for call in calls:
            with pytest.raises(RuntimeError, match="cuda"):
                call()
    aug = stokes_problem((4, 4), graddiv_alpha=1e3, engine="flat", dtype=torch.float32,
                         device="cpu")
    assert aug.K.dtype == aug.Mp.dtype == torch.float32
    assert all(b.dtype == torch.float32 for row in aug.K.kblocks for b in row)
    prob = stokes_problem((4, 4), dtype=torch.float32, device="cpu")
    assert all(t.dtype == torch.float32 for t in pt.tree_leaves(prob.b))
    assert prob.K.dtype == prob.Mp.dtype == prob.Mu.dtype == torch.float32
    assert all(op.dtype == torch.float32 for op in prob.A.block(0, 1).ops + prob.A.block(1, 0).ops)
