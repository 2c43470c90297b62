"""The port's plain Stokes path against the JAX package, case by case: the
lid-driven cavity and one velocity-GMG V-cycle in 2D and 3D
(tests/test_torch_stokes.py holds the manufactured-solution solves,
tests/test_torch_blocks.py the block solvers).

Iteration counts and flags are equal and residual histories agree to
rtol 1e-8; the inner pressure CG stops at rtol 1e-8, so the outer residual
is defined to 1e-8 of the initial one, and entries under that floor are
compared to it (the two packages reduce their sums in different orders);
the final residual ratio is also held on its own, to 1e-6 relative.
Solutions agree to 1e-6 of their largest entry, and a GMG V-cycle to
1e-12 of its largest entry.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jax_reference_jit import (
    jitted_jax_chebyshev_setups,
    jitted_jax_dense,
    jitted_jax_patch_setups,
    jitted_jax_solves,
)
from gridapsolvers_tpu.fem.stokes import stokes_problem as j_stokes_problem
from gridapsolvers_tpu.fem.stokes import velocity_gmg as j_velocity_gmg
from gridapsolvers_tpu.models.stokes import solve_stokes as j_solve_stokes

from gridapsolvers_tpu_torch.fem.stokes import stokes_problem, velocity_gmg
from gridapsolvers_tpu_torch.models import solve_stokes

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _compiled_jax_patch_setups():
    """The JAX references' patch smoothers refresh their values, their
    Chebyshev smoothers set up and `ELLMatrix.todense` runs, compiled
    (`jitted_jax_patch_setups`, `jitted_jax_chebyshev_setups`,
    `jitted_jax_dense`)."""
    with jitted_jax_patch_setups(), jitted_jax_chebyshev_setups(), jitted_jax_dense():
        yield


HIST_RTOL = 1e-8
HIST_FLOOR = 1e-8   # of the initial residual: the inner CG's rtol
FINAL_RTOL = 1e-6   # the final residual ratio ||r_k|| / ||r_0||
VCYCLE_RTOL = 1e-12


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [leaf for xi in x for leaf in _leaves(xi)]
    return [x]


def _assert_close(y, y_ref, rtol):
    y, y_ref = (np.concatenate([np.ravel(np.asarray(v, dtype=np.float64)) for v in _leaves(t)])
                for t in (y, y_ref))
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


def test_solve_stokes_cavity_equal_jax():
    """bc='cavity' at 8^2 cells, 2 levels: the reference's lid-driven cavity."""
    with jitted_jax_solves():
        jx, jstats, jinfo = j_solve_stokes((8, 8), num_levels=2, bc="cavity")
    x, stats, info = solve_stokes((8, 8), num_levels=2, bc="cavity", device="cpu")
    assert stats.converged()
    _assert_same_solve(stats, jstats)
    assert "velocity_error" not in info and info["problem"].u_exact is None
    assert info["residual"] == pytest.approx(jinfo["residual"], rel=1e-3, abs=1e-12)
    _assert_close(x, jx, 1e-6)


@pytest.mark.parametrize("ncells, levels", [((16, 16), 3), ((4, 4, 4), 2)])
def test_velocity_gmg_vcycle_equal_jax(ncells, levels):
    prob, jprob = stokes_problem(ncells, device="cpu"), j_stokes_problem(ncells)
    gmg = velocity_gmg(ncells, levels, device="cpu")
    jgmg = j_velocity_gmg(ncells, levels)
    state, jstate = gmg.setup(prob.K), jgmg.setup(jprob.K)
    for s, js in zip(state["pre"], jstate["pre"]):
        assert s["lmax"] == pytest.approx(float(js["lmax"]), rel=1e-12)
    rng = np.random.default_rng(7)
    r = tuple(rng.normal(size=v.shape[0]) for v in prob.b[0])
    z = gmg.apply(state, tuple(torch.from_numpy(v) for v in r))
    # the 3D V-cycle runs eagerly: compiling it costs more than it saves
    japply = lambda v: jgmg.apply(jstate, v)  # noqa: E731
    jz = (japply if len(ncells) == 3 else jax.jit(japply))(tuple(jnp.asarray(v) for v in r))
    _assert_close(z, jz, VCYCLE_RTOL)
    assert all(t.dtype == torch.float64 for t in z)
