"""The port's augmented-Lagrangian Stokes path against the JAX package.

The grad-div augmented problem (Q2/P1disc; manufactured solution and the
lid-driven cavity; block and flat engines), the augmented velocity GMG
(Richardson(10, 0.2) Vanka and Chebyshev(4) over the Vanka; block and flat
engines), `solve_stokes(graddiv_alpha=1e3)`, and a small 3D case: the same
problems assembled by both packages in f64 on the CPU. Single operator
applies agree to 1e-12 of their largest entry, a V-cycle to 1e-11;
iteration counts and flags are equal; residual histories agree to rtol
1e-8 down to the inner pressure CG's floor of 1e-8 of the initial
residual, the final residual ratio to 1e-6 relative.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jax_reference_jit import jitted_jax_solves
from gridapsolvers_tpu.fem.stokes import stokes_problem as j_stokes_problem
from gridapsolvers_tpu.fem.stokes import velocity_gmg as j_velocity_gmg
from gridapsolvers_tpu.models.stokes import solve_stokes as j_solve_stokes

from gridapsolvers_tpu_torch import convert
from gridapsolvers_tpu_torch.algebra.flat import BlockedKernelOperator
from gridapsolvers_tpu_torch.fem.stokes import stokes_problem, velocity_gmg
from gridapsolvers_tpu_torch.models import solve_stokes
from gridapsolvers_tpu_torch.ops import banded_stencil, ell_spmv

torch.set_num_threads(1)


ALPHA = 1e3
OP_RTOL = 1e-12
CYCLE_RTOL = 1e-11
HIST_RTOL = 1e-8
HIST_FLOOR = 1e-8   # of the initial residual: the inner CG's rtol
FINAL_RTOL = 1e-6
ERR_RTOL = 1e-6


def _jleaves(x):
    if isinstance(x, (tuple, list)):
        return [leaf for xi in x for leaf in _jleaves(xi)]
    return [x]


def _flat(x):
    return np.concatenate([np.ravel(np.asarray(v, dtype=np.float64)) for v in _jleaves(x)])


def _assert_close(y, y_ref, rtol=OP_RTOL):
    y, y_ref = _flat(y), _flat(y_ref)
    scale = np.max(np.abs(y_ref))
    assert y.shape == y_ref.shape and scale > 0
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=rtol * scale)


def _rand_block(rng, prob):
    """The same random block vector for both packages."""
    u = [rng.normal(size=t.shape[0]) for t in prob.b[0]]
    p = rng.normal(size=prob.b[1].shape[0])
    return ((tuple(torch.from_numpy(v) for v in u), torch.from_numpy(p)),
            (tuple(jnp.asarray(v) for v in u), jnp.asarray(p)))


def _spec(op):
    """The numpy fields of a JAX operator, for convert.operator."""
    name = type(op).__name__
    if name == "BlockOperator":
        return {"blocks": [[None if b is None else _spec(b) for b in row] for row in op.blocks]}
    if name in ("ColumnStack", "RowStack", "FieldwiseOperator"):
        key = {"ColumnStack": "column_stack", "RowStack": "row_stack",
               "FieldwiseOperator": "fieldwise"}[name]
        return {key: [_spec(o) for o in op.ops]}
    if name == "BlockedKernelOperator":
        return {"kblocks": [[None if b is None else _spec(b) for b in row] for row in op.kblocks],
                "inner": None if op.inner is None else _spec(op.inner), "sizes": op.sizes}
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


# ------------------------------------------------------------- problems ---


@pytest.mark.parametrize("bc", ["mms", "cavity"])
@pytest.mark.parametrize("engine", ["block", "flat"])
def test_augmented_problem_equal_jax(bc, engine):
    """A applied, b and Mp against JAX; the JAX problem carried across
    (convert.stokes_problem) applies as the port's own."""
    prob = stokes_problem((8, 8), graddiv_alpha=ALPHA, bc=bc, engine=engine, device="cpu")
    jprob = j_stokes_problem((8, 8), graddiv_alpha=ALPHA, bc=bc, engine=engine)
    assert isinstance(prob.K, BlockedKernelOperator) == (engine == "flat")
    rng = np.random.default_rng(0)
    x, jx = _rand_block(rng, prob)
    _assert_close(prob.A.matvec(x), jprob.A.matvec(jx))
    _assert_close(prob.b, jprob.b)
    _assert_close(prob.Mp.matvec(x[1]), jprob.Mp.matvec(jx[1]))
    assert prob.residual_norm(x) == pytest.approx(jprob.residual_norm(jx), rel=OP_RTOL)
    if bc == "mms":
        assert prob.pressure_error(x[1]) == pytest.approx(jprob.pressure_error(jx[1]),
                                                          rel=OP_RTOL)
        assert prob.velocity_error(x[0]) == pytest.approx(jprob.velocity_error(jx[0]),
                                                          rel=OP_RTOL)
    carried = convert.stokes_problem(
        jprob.mesh, _spec(jprob.A), _numpy(jprob.b), _spec(jprob.Mu), _spec(jprob.Mp),
        _numpy(jprob.u_exact), _numpy(jprob.p_exact), jprob.dirichlet_mask_u, jprob.nu,
        _numpy(jprob.const_p), device="cpu")
    _assert_close(carried.A.matvec(x), prob.A.matvec(x))
    assert carried.residual_norm(x) == pytest.approx(prob.residual_norm(x), rel=OP_RTOL)


# ---------------------------------------------------------- V-cycles ------


def _vcycle(engine, cheby, r):
    """One V-cycle of the port's augmented velocity GMG at 8^2 cells, 2
    levels: (output, GMG state)."""
    gmg = velocity_gmg((8, 8), 2, graddiv_alpha=ALPHA, engine=engine, cheby_degree=cheby,
                       device="cpu")
    prob = stokes_problem((8, 8), graddiv_alpha=ALPHA, engine=engine, device="cpu")
    st = gmg.setup(prob.K)
    return gmg.apply(st, r), st


def _rand_velocity(seed):
    n = 2 * (17 ** 2)
    v = np.random.default_rng(seed).normal(size=n)
    return (torch.from_numpy(v[: n // 2]), torch.from_numpy(v[n // 2:])), \
        (jnp.asarray(v[: n // 2]), jnp.asarray(v[n // 2:]))


@pytest.mark.parametrize("cheby", [0, 4])
def test_augmented_vcycle_equal_jax(cheby):
    """One V-cycle of the flat-engine augmented velocity GMG (exact FE
    transfers, patch prolongations; Richardson(10, 0.2) Vanka or
    Chebyshev(4)) against JAX."""
    r, jr = _rand_velocity(1)
    z, st = _vcycle("flat", cheby, r)
    jgmg = j_velocity_gmg((8, 8), 2, graddiv_alpha=ALPHA, engine="flat", cheby_degree=cheby)
    jprob = j_stokes_problem((8, 8), graddiv_alpha=ALPHA, engine="flat")
    jst = jgmg.setup(jprob.A.block(0, 0))
    if cheby:
        assert st["pre"][0]["lmax"] == pytest.approx(float(jst["pre"][0]["lmax"]), rel=1e-10)
    _assert_close(z, jgmg.apply(jst, jr), CYCLE_RTOL)


@pytest.mark.parametrize("cheby", [0, 4])
def test_augmented_vcycle_block_equals_flat(cheby):
    """The block engine's V-cycle (banded levels, batched Vanka, ELL
    transfers) equals the flat engine's (held against JAX above); with
    Richardson it is solve_stokes's, held against JAX through the whole
    solve by test_solve_stokes_graddiv_equal_jax."""
    r, _ = _rand_velocity(1)
    _assert_close(_vcycle("block", cheby, r)[0], _vcycle("flat", cheby, r)[0], CYCLE_RTOL)


# ------------------------------------------------------------ solve -------


@pytest.fixture(scope="module")
def jax_solve():
    with jitted_jax_solves():
        return j_solve_stokes((8, 8), num_levels=2, graddiv_alpha=ALPHA)


def test_solve_stokes_graddiv_equal_jax(jax_solve):
    jx, jstats, jinfo = jax_solve
    banded_stencil.counts.reset()
    ell_spmv.counts.reset()
    x, stats, info = solve_stokes((8, 8), num_levels=2, graddiv_alpha=ALPHA, device="cpu")
    assert stats.niter == int(jstats.niter) == 9 and int(stats.flag) == int(jstats.flag) == 2
    k = stats.niter
    h, jh = stats.residuals.numpy()[: k + 1], np.asarray(jstats.residuals)[: k + 1]
    np.testing.assert_allclose(h, jh, rtol=HIST_RTOL, atol=HIST_FLOOR * jh[0])
    assert h[k] / h[0] == pytest.approx(jh[k] / jh[0], rel=FINAL_RTOL)
    for key in ("velocity_error", "pressure_error"):
        assert info[key] == pytest.approx(jinfo[key], rel=ERR_RTOL)
    _assert_close(x, jx, 1e-6)
    assert info["residual"] < 1e-7
    # the block engine: banded velocity blocks (K2), ELL couplings,
    # pressure mass and FE transfers (K3), all on their plain versions here
    assert banded_stencil.counts.kernel == ell_spmv.counts.kernel == 0
    assert banded_stencil.counts.plain > 0 and ell_spmv.counts.plain > 0


def test_graddiv_3d():
    """3D at 2^3 cells: the flat augmented system against JAX, and its
    materialized vertex-star Vanka against the batched one."""
    from gridapsolvers_tpu_torch.fem.stokes import velocity_vanka_smoother
    from gridapsolvers_tpu_torch.patches import MaterializedVankaSmoother

    prob = stokes_problem((2, 2, 2), graddiv_alpha=ALPHA, engine="flat", device="cpu")
    jprob = j_stokes_problem((2, 2, 2), graddiv_alpha=ALPHA, engine="flat")
    rng = np.random.default_rng(2)
    x, jx = _rand_block(rng, prob)
    _assert_close(prob.A.matvec(x), jprob.A.matvec(jx))
    _assert_close(prob.b, jprob.b)
    v = velocity_vanka_smoother(prob.mesh)
    mat = MaterializedVankaSmoother(topo=v.topo, weighting=v.weighting)
    _assert_close(mat.apply(mat.setup(prob.K), x[0]), v.apply(v.setup(prob.K.inner), x[0]),
                  CYCLE_RTOL)


# ---------------------------------------------------- not ported yet ------


def test_not_yet_ported_pieces_raise():
    """What the port leaves for later: the distributed operators. (The
    colored Gauss-Seidel smoothers and the FE-space projection transfers,
    once checked here, are ported: tests/test_torch_multilevel_spaces.py;
    the GenEO Schwarz solvers and the H(curl) and MHD applications:
    tests/test_torch_{schwarz,hcurl,mhd}.py; AMR:
    tests/test_torch_amr.py.)"""
    from gridapsolvers_tpu_torch.algebra import to_scipy

    class DistELLMatrix:
        pass

    with pytest.raises(TypeError, match="distributed slice"):
        to_scipy(DistELLMatrix())
