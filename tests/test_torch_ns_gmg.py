"""The port's nonlinear velocity GMG and values-only refresh walker against
the JAX package.

`ns_velocity_gmg` on the 8^2 lid-driven cavity at Re = 10 (2 levels, f64,
CPU): set up at one Newton iterate, updated at another and applied, by
both packages (the bench's ns_newton smoother, and the grad-div augmented
Chebyshev(4) over the materialized Vanka with patch prolongations): the
V-cycles agree to 1e-10 of their largest entry. The walker
(`kernelize_system`, run by every GMG and FGMRES update) hands back each
refreshed ELL leaf with its set-up `cols`, `row_len` and `group` tensors,
and its refreshed operators apply as JAX's `kernelize="off"` path does. A
JAX augmented cavity problem and its GMG state carried across (`convert`)
solve the Newton system at the lift start in as many FGMRES iterations as
JAX, the velocity to 1e-10 and the pressure, up to its free constant, to
1e-7. The 16^2 cavity Newton run with the bench's ns_newton GMG and the
augmented manufactured-solution run hold their Newton histories to JAX's.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jax_reference_jit import jitted_jax_patch_setups, jitted_jax_solves
from gridapsolvers_tpu.blocks import BlockTriangularSolver as JBlockTriangular
from gridapsolvers_tpu.blocks import MatrixBlock as JMatrixBlock
from gridapsolvers_tpu.blocks import NonlinearSystemBlock as JNonlinearBlock
from gridapsolvers_tpu.fem.navier_stokes import navier_stokes_problem as j_ns_problem
from gridapsolvers_tpu.fem.navier_stokes import ns_velocity_gmg as j_ns_gmg
from gridapsolvers_tpu.linear import CGSolver as JCG
from gridapsolvers_tpu.linear import FGMRESSolver as JFGMRES
from gridapsolvers_tpu.linear import JacobiSolver as JJacobi
from gridapsolvers_tpu.linear import RichardsonSmoother as JRichardson
from gridapsolvers_tpu.patches import VankaSolver as JVanka

from gridapsolvers_tpu_torch import convert
from gridapsolvers_tpu_torch.algebra import BlockOperator, ELLMatrix
from gridapsolvers_tpu_torch.algebra.block import ColumnStack, FieldwiseOperator, RowStack
from gridapsolvers_tpu_torch.algebra.ell import kernelize_system
from gridapsolvers_tpu_torch.blocks import BlockTriangularSolver, MatrixBlock, NonlinearSystemBlock
from gridapsolvers_tpu_torch.fem.navier_stokes import navier_stokes_problem, ns_velocity_gmg
from gridapsolvers_tpu_torch.linear import (
    CGSolver,
    FGMRESSolver,
    GMGSolver,
    JacobiSolver,
    RichardsonSmoother,
)
from gridapsolvers_tpu_torch.nonlinear import NewtonSolver
from gridapsolvers_tpu_torch.patches import MaterializedVankaSmoother
from gridapsolvers_tpu_torch.utils import pytrees as pt

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _compiled_jax_setups():
    """The JAX references' Vanka value refreshes run compiled
    (`jitted_jax_patch_setups`)."""
    with jitted_jax_patch_setups():
        yield


NU = 0.1
ALPHA = 1e3
CYCLE_RTOL = 1e-10
X_RTOL = 1e-10
P_RTOL = 1e-7    # the pressure of an FGMRES solve at rtol 1e-8 (see its test)


def _flat(x):
    if isinstance(x, (tuple, list)):
        return np.concatenate([_flat(v) for v in x])
    return np.ravel(np.asarray(x, dtype=np.float64))


def _assert_close(y, y_ref, rtol):
    y, y_ref = _flat(y), _flat(y_ref)
    scale = np.max(np.abs(y_ref))
    assert y.shape == y_ref.shape and scale > 0
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=rtol * scale)


def _numpy(v):
    if v is None:
        return None
    if isinstance(v, (tuple, list)):
        return tuple(_numpy(vi) for vi in v)
    return np.asarray(v)


def _iterate(prob, seed):
    """The lift start plus a seeded random free-dof perturbation, in both
    packages' vectors (port, JAX)."""
    rng = np.random.default_rng(seed)
    free = prob.free_u.numpy()
    u = [np.asarray(g) + 0.2 * free * rng.normal(size=prob.n_u) for g in prob.lift_g]
    p = 0.1 * rng.normal(size=prob.Mp.shape[0])
    return ((tuple(torch.from_numpy(v) for v in u), torch.from_numpy(p)),
            (tuple(jnp.asarray(v) for v in u), jnp.asarray(p)))


def _gmg(kind, port: bool):
    """The problem and velocity GMG of one package: 'newton' (the bench's
    ns_newton smoother: Richardson(1, 0.8) over the materialized Vanka of
    the velocity rows, two cycles) or 'graddiv' (Chebyshev(4) over the
    materialized vertex-star Vanka, patch prolongations). The port's levels
    refresh through the walker (at every update); JAX's through its
    plain ELL path (its 'auto' on the CPU)."""
    alpha = ALPHA if kind == "graddiv" else 0.0
    if port:
        prob = navier_stokes_problem((8, 8), nu=NU, graddiv_alpha=alpha, bc="cavity",
                                     device="cpu")
        build, kw = ns_velocity_gmg, dict(device="cpu")
        sm = RichardsonSmoother(MaterializedVankaSmoother(omega=1.0, seed_field=-1), niter=1,
                                omega=0.8)
    else:
        prob = j_ns_problem((8, 8), nu=NU, graddiv_alpha=alpha, bc="cavity")
        build, kw = j_ns_gmg, {}
        sm = JRichardson(JVanka(omega=1.0, seed_field=-1), niter=1, omega=0.8)
    if kind == "graddiv":
        gmg = build((8, 8), 2, nu=NU, graddiv_alpha=alpha, bc="cavity",
                    vanka_engine="materialized", cheby_degree=4, **kw)
    else:
        gmg = build((8, 8), 2, nu=NU, smoother=sm, ncycles=2, bc="cavity", **kw)
    return prob, gmg


@pytest.mark.parametrize("kind", ["newton", "graddiv"])
def test_gmg_update_apply_equal_jax(kind):
    """Set up at one iterate, updated at another (level Jacobians
    re-assembled, Vanka re-extracted and re-materialized, patch
    prolongations refreshed), then one cycle: equal to JAX's; each level
    operator after the walker's refresh applies as JAX's."""
    prob, gmg = _gmg(kind, True)
    jprob, jgmg = _gmg(kind, False)
    (x0, jx0), (x1, jx1) = _iterate(prob, 0), _iterate(prob, 1)
    st = gmg.setup(prob.jacobian(x0).block(0, 0), x0[0])
    st = gmg.update(st, prob.jacobian(x1).block(0, 0), x1[0])
    jst = jgmg.setup(jprob.jacobian(jx0).block(0, 0), jx0[0])
    jst = jax.jit(jgmg.update)(jst, jprob.jacobian(jx1).block(0, 0), jx1[0])
    r, jr = _iterate(prob, 2)
    _assert_close(gmg.apply(st, r[0]), jax.jit(lambda v: jgmg.apply(jst, v))(jr[0]), CYCLE_RTOL)
    rng = np.random.default_rng(3)
    for m, jm in zip(st["mats"], jst["mats"]):
        v = [rng.normal(size=m.blocks[0][0].nrows) for _ in range(2)]
        _assert_close(m.matvec(tuple(torch.from_numpy(a) for a in v)),
                      jm.matvec(tuple(jnp.asarray(a) for a in v)), 1e-12)


def _leaves(op):
    if isinstance(op, ELLMatrix):
        return [op]
    if isinstance(op, BlockOperator):
        return [b for row in op.blocks for blk in row if blk is not None for b in _leaves(blk)]
    if isinstance(op, (ColumnStack, RowStack, FieldwiseOperator)):
        return [b for o in op.ops for b in _leaves(o)]
    return []


def _pattern(blk):
    return (blk.cols.data_ptr(), blk.row_len.data_ptr(), blk.group)


def test_refresh_keeps_the_setup_pattern():
    """After FGMRES's and GMG's update, every refreshed ELL leaf (the outer Jacobian's
    and each walked level's, every level but the coarsest) shares `cols`,
    `row_len` and `group` with its set-up leaf (data_ptr equal) and holds
    the new values."""
    prob, gmg = _gmg("graddiv", True)
    pc = BlockTriangularSolver(solvers=(gmg, CGSolver(Pl=JacobiSolver(), rtol=1e-6)),
                               blocks=((NonlinearSystemBlock(), None), (None, MatrixBlock(prob.Mp))),
                               coeffs=((1.0, 1.0), (0.0, 1.0)))
    fg = FGMRESSolver(m=20, Pr=pc)
    (x0, _), (x1, _) = _iterate(prob, 0), _iterate(prob, 1)
    A0, A1 = prob.jacobian(x0), prob.jacobian(x1)
    st0 = fg.setup(A0, x0)
    before = {"A": [_pattern(b) for b in _leaves(st0["A"])],
              "mats": [_pattern(b) for m in st0["Pr"]["states"][0]["mats"][:-1]
                       for b in _leaves(m)]}
    st1 = fg.update(st0, A1, x1)
    new_A = _leaves(st1["A"])
    assert [_pattern(b) for b in new_A] == before["A"] and len(new_A) == 8
    assert all(b.values is n.values for b, n in zip(new_A, _leaves(A1)))
    mats = st1["Pr"]["states"][0]["mats"]
    assert [_pattern(b) for m in mats[:-1] for b in _leaves(m)] == before["mats"]
    assert all(b.row_len is not None for m in mats for b in _leaves(m))


def _ell(n=6, m=6, K=3, dtype=torch.float64):
    return ELLMatrix(torch.zeros((n, K), dtype=dtype), torch.zeros((n, K), dtype=torch.int32), m,
                     torch.full((n,), K, dtype=torch.int32), 1)


@pytest.mark.parametrize("case", ["leaf class", "one side None", "values shape", "values dtype",
                                  "columns", "other columns", "stack", "block layout"])
def test_walker_raises_on_a_structure_mismatch(case):
    """kernelize_system has no fallback: any mismatch between the new
    operator and the set-up one raises. A leaf whose `cols` are other
    tensors holding the same columns refreshes."""
    a = _ell()
    new, old = {
        "leaf class": (a, FieldwiseOperator((a,))),
        "one side None": (BlockOperator(((a, None),)), BlockOperator(((a, a),))),
        "values shape": (a, _ell(K=4)),
        "values dtype": (a, _ell(dtype=torch.float32)),
        "columns": (a, _ell(m=7)),
        "other columns": (a, dataclasses.replace(_ell(), cols=torch.ones((6, 3), dtype=torch.int32))),
        "stack": (ColumnStack((a, a)), ColumnStack((a,))),
        "block layout": (BlockOperator(((a, a),)), BlockOperator(((a,), (a,)))),
    }[case]
    with pytest.raises(ValueError, match="kernelize_system"):
        kernelize_system(new, old)
    old = BlockOperator(((_ell(), ColumnStack((_ell(),))),))
    refreshed = kernelize_system(BlockOperator(((a, ColumnStack((a,))),)), old)
    assert refreshed.blocks[0][0].values is a.values
    assert refreshed.blocks[0][0].cols is old.blocks[0][0].cols


def test_kernelize_values():
    """The JAX package's values are accepted (and ignored: the refresh
    always runs); anything else raises."""
    for v in ("auto", "pallas", "off", "ell"):
        FGMRESSolver(kernelize=v)
        GMGSolver(kernelize_levels=v)
    with pytest.raises(ValueError, match="kernelize"):
        FGMRESSolver(kernelize="on")
    with pytest.raises(ValueError, match="kernelize"):
        GMGSolver(kernelize_levels="xla")


def _op_spec(op):
    name = type(op).__name__
    if name == "BlockOperator":
        return {"blocks": [[None if b is None else _op_spec(b) for b in row] for row in op.blocks]}
    if name == "BlockedKernelOperator":
        return {"kblocks": [[None if b is None else _op_spec(b) for b in row]
                            for row in op.kblocks], "inner": None, "sizes": op.sizes}
    return {"values": np.asarray(op.values), "cols": np.asarray(op.cols), "ncols": op.ncols}


def _transfer_spec(t):
    return {"mats": [np.asarray(m) for m in t.mats], "in_shape": t.in_shape,
            "out_shape": t.out_shape, "mask_in": _numpy(t.mask_in),
            "mask_out": _numpy(t.mask_out)}


def test_convert_state_fgmres_equal_jax():
    """A JAX augmented cavity problem and its ns_velocity_gmg state at the
    lift start, carried across: one FGMRES(20) solve (rtol 1e-8) of the
    Newton system J dx = -R there takes JAX's iterations, the velocity to
    1e-10, the pressure up to its constant to 1e-7."""
    jprob, jgmg = _gmg("graddiv", False)
    jx = jprob.initial_guess()
    jA = jprob.jacobian(jx)
    jst = jgmg.setup(jA.block(0, 0), jx[0])
    jMp = dataclasses.replace(jprob.Mp, values=jprob.Mp.values * (-1.0 / ALPHA))
    jpc = JBlockTriangular(solvers=(jgmg, JCG(Pl=JJacobi(), rtol=1e-10, maxiter=60)),
                           blocks=((JNonlinearBlock(), None), (None, JMatrixBlock(jMp))),
                           coeffs=((1.0, 1.0), (0.0, 1.0)), half="upper")
    jfg = JFGMRES(m=20, Pr=jpc, rtol=1e-8, maxiter=60)
    jfst = jfg.setup(jA, jx)
    jfst["Pr"]["states"][0] = jst
    jr = jprob.residual(jx)
    with jitted_jax_solves():
        jdx, jstats = jfg.solve(jfst, tuple_neg(jr))

    fields = {f.name: getattr(jprob, f.name) for f in dataclasses.fields(jprob)}
    for k, v in fields.items():
        if k in ("BTs", "Bs", "res_Bs"):
            fields[k] = [_op_spec(o) for o in v]
        elif k in ("Mp", "Mu"):
            fields[k] = _op_spec(v)
        elif k not in ("mesh", "nu", "n_u"):
            fields[k] = _numpy(v)
    prob = convert.navier_stokes_problem(fields, device="cpu")
    _, gmg = _gmg("graddiv", True)
    P = [{"base": [_transfer_spec(t) for t in p.base.ops], "A": _op_spec(p.A),
          "rhs_op": _op_spec(p.rhs_op), "dofs": np.asarray(p.state["dofs"]),
          "inv": np.asarray(p.state["inv"]),
          "uncovered_inv_diag": np.asarray(p.state["uncovered_inv_diag"])} for p in jst["P"]]
    st = convert.ns_gmg_state(
        gmg, [_op_spec(m) for m in jst["mats"]], [float(s["lmax"]) for s in jst["pre"]],
        [_op_spec(s["M"]["Mv"]) for s in jst["pre"]],
        {k: np.asarray(v) for k, v in jst["coarse"].items()}, P,
        [[_transfer_spec(t) for t in r.ops] for r in jst["R"]], device="cpu")
    Mp = dataclasses.replace(prob.Mp, values=prob.Mp.values * (-1.0 / ALPHA))
    pc = BlockTriangularSolver(solvers=(gmg, CGSolver(Pl=JacobiSolver(), rtol=1e-10, maxiter=60)),
                               blocks=((NonlinearSystemBlock(), None), (None, MatrixBlock(Mp))),
                               coeffs=((1.0, 1.0), (0.0, 1.0)))
    fg = FGMRESSolver(m=20, Pr=pc, rtol=1e-8, maxiter=60)
    x = prob.initial_guess()
    fst = fg.setup(prob.jacobian(x), x)
    fst["Pr"]["states"][0] = st
    dx, stats = fg.solve(fst, pt.scale(-1.0, prob.residual(x)))
    assert stats.niter == int(jstats.niter) and stats.flag == int(jstats.flag) == 2
    _assert_close(dx[0], jdx[0], X_RTOL)
    # the cavity's pressure is unpinned (Bᵀ annihilates the constant, 1 on
    # every cell-mean dof of P1disc), so each solve's constant component is
    # its own round-off; the rest, in this alpha-heavy system, is set only
    # to the solve's tolerance: the two packages' round-off orders part at
    # ~9e-9 of max|p|, at the lid's corner cells
    c = np.zeros(jdx[1].shape[0])
    c[::3] = 1.0

    def drop_constant(p):
        p = np.asarray(p, dtype=np.float64)
        return p - (p @ c) / (c @ c) * c

    _assert_close(drop_constant(dx[1]), drop_constant(jdx[1]), P_RTOL)


def tuple_neg(r):
    return (tuple(-v for v in r[0]), -r[1])


def _cavity_newton(port: bool):
    """tests/test_navier_stokes.py:321 in one package at its own size (16^2,
    3 levels): the bench's ns_newton configuration (Richardson(1, 0.8) over
    the batched Vanka of the velocity rows, two cycles) in f64, Newton from
    zero (JAX in its device loop, which its tests hold equal to its host
    loop). Returns (stats, velocity, centre u_x)."""
    from gridapsolvers_tpu.nonlinear import NewtonSolver as JNewton

    from gridapsolvers_tpu_torch.patches import VankaSolver

    nc = 16
    if port:
        prob = navier_stokes_problem((nc, nc), nu=NU, bc="cavity", device="cpu")
        sm = RichardsonSmoother(VankaSolver(omega=1.0, seed_field=-1), niter=1, omega=0.8)
        gmg = ns_velocity_gmg((nc, nc), 3, nu=NU, smoother=sm, ncycles=2, bc="cavity",
                              device="cpu")
        BT, MB, NB, CG, J, F, N = (BlockTriangularSolver, MatrixBlock, NonlinearSystemBlock,
                                   CGSolver, JacobiSolver, FGMRESSolver, NewtonSolver)
    else:
        prob = j_ns_problem((nc, nc), nu=NU, bc="cavity")
        sm = JRichardson(JVanka(omega=1.0, seed_field=-1), niter=1, omega=0.8)
        gmg = j_ns_gmg((nc, nc), 3, nu=NU, smoother=sm, ncycles=2, bc="cavity")
        BT, MB, NB, CG, J, F, N = (JBlockTriangular, JMatrixBlock, JNonlinearBlock, JCG, JJacobi,
                                   JFGMRES, JNewton)
    pc = BT(solvers=(gmg, CG(Pl=J(), rtol=1e-6, maxiter=30)),
            blocks=((NB(), None), (None, MB(prob.Mp))), half="upper")
    loop = {} if port else dict(loop="device")
    newton = N(F(m=40, Pr=pc, rtol=1e-8, maxiter=100), maxiter=20, rtol=1e-8, atol=1e-10, **loop)
    x, stats = newton.solve(prob, prob.zero_guess())
    u = _flat(x[0])
    return stats, u, float(u[: (2 * nc + 1) ** 2].reshape(2 * nc + 1, 2 * nc + 1)[nc, nc])


def test_cavity_newton_re10_gmg():
    """The cavity Newton run that path I2's ns_newton row scales up, by both
    packages: equal iterations and flag (four or more steps, converged, as
    JAX's test asks), residual histories to rtol 1e-8 down to 1e-8 of the
    initial residual, the velocity to 1e-8 of its largest entry, and the
    clockwise primary vortex (u_x < -0.05 at the cavity centre)."""
    with jitted_jax_solves():
        jstats, ju, jux = _cavity_newton(False)
    stats, u, ux = _cavity_newton(True)
    k = stats.niter
    assert (k, stats.flag) == (int(jstats.niter), int(jstats.flag))
    assert k >= 4 and stats.flag in (1, 2)
    h, jh = stats.residuals.numpy(), np.asarray(jstats.residuals)
    np.testing.assert_allclose(h[: k + 1], jh[: k + 1], rtol=1e-8, atol=1e-8 * jh[0])
    _assert_close(u, ju, 1e-8)
    assert ux < -0.05 and ux == pytest.approx(jux, rel=1e-8)


def _augmented_newton(port: bool):
    """tests/test_navier_stokes.py:180 in one package: the reference's
    NavierStokesGMG configuration on the manufactured solution at 8^2, nu =
    1 (Newton from zero with FGMRES(20) and the nonlinear patch-smoothed
    velocity GMG; JAX in its device loop, which its tests hold equal to its
    host loop). Returns (stats, velocity error)."""
    if port:
        prob = navier_stokes_problem((8, 8), nu=1.0, graddiv_alpha=ALPHA, device="cpu")
        gmg = ns_velocity_gmg((8, 8), 2, nu=1.0, graddiv_alpha=ALPHA, device="cpu")
        BT, MB, NB, CG, J, F = (BlockTriangularSolver, MatrixBlock, NonlinearSystemBlock,
                                CGSolver, JacobiSolver, FGMRESSolver)
        newton = dict(maker=NewtonSolver)
    else:
        from gridapsolvers_tpu.nonlinear import NewtonSolver as JNewton

        prob = j_ns_problem((8, 8), nu=1.0, graddiv_alpha=ALPHA)
        gmg = j_ns_gmg((8, 8), 2, nu=1.0, graddiv_alpha=ALPHA)
        BT, MB, NB, CG, J, F = (JBlockTriangular, JMatrixBlock, JNonlinearBlock, JCG, JJacobi,
                                JFGMRES)
        newton = dict(maker=JNewton, loop="device")
    Mp = dataclasses.replace(prob.Mp, values=prob.Mp.values * (-1.0 / ALPHA))
    pc = BT(solvers=(gmg, CG(Pl=J(), rtol=1e-10, maxiter=60)),
            blocks=((NB(), None), (None, MB(Mp))), coeffs=((1.0, 1.0), (0.0, 1.0)),
            half="upper")
    maker = newton.pop("maker")
    x, stats = maker(F(m=20, Pr=pc, rtol=1e-10, maxiter=40), maxiter=12, rtol=1e-9, atol=1e-11,
                     **newton).solve(prob, prob.zero_guess())
    return stats, prob.velocity_error(x[0])


def test_newton_augmented_equal_jax():
    """The augmented Newton run by both packages: equal iterations and flag
    (<= 4 from zero), residual histories to rtol 1e-8 down to 1e-8 of the
    initial residual, velocity errors to 1e-6 relative."""
    with jitted_jax_solves():
        jstats, jerr = _augmented_newton(False)
    stats, err = _augmented_newton(True)
    k = stats.niter
    assert (k, stats.flag) == (int(jstats.niter), int(jstats.flag)) and k <= 4
    h, jh = stats.residuals.numpy(), np.asarray(jstats.residuals)
    np.testing.assert_allclose(h[: k + 1], jh[: k + 1], rtol=1e-8, atol=1e-8 * jh[0])
    assert err == pytest.approx(jerr, rel=1e-6) and err < 5e-4
