"""The port's 3D MHD multifield system and its patch-smoothed GMG against
the JAX package, in f64 on the CPU.

- `mhd_system` at 4^3 cells (beta 1, gamma 1) and at 4 x 3 x 2 cells
  (beta 2, gamma 10): the 6 x 6 block structure, every ELL block's
  columns equal and values to 1e-14 of their largest entry, the rhs and
  the free masks to 1e-14; `mhd_vertex_patches` tables equal exactly.
- One V-cycle and one W-cycle of `mhd_gmg((4, 4, 4), 2)` (Richardson(2,
  0.3) over the 15-dof vertex Vanka, dense LU at 2^3) on a seeded vector:
  on the port's own set-up, and on a GMG the port builds from the JAX
  package's level problems carried over by `convert.mhd_problem`, both to
  1e-10 of max|y| (the patch inverses' condition numbers part the two
  packages' applies at ~1e-13).
- FGMRES(30) + that GMG, rtol 1e-6, maxiter 40 (the reference tolerance,
  `tests/test_multifield.py`): 5 iterations in both packages, flags
  equal, residual histories to rtol 1e-8 above 1e-12 of the initial
  residual, x to 1e-8 of max|x|, `residual_norm` < 1e-5.

The JAX cycles and solve run under `jax.jit`.
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from gridapsolvers_tpu import linear as jl
from gridapsolvers_tpu.fem import mhd as jm

from gridapsolvers_tpu_torch import convert
from gridapsolvers_tpu_torch import linear as tl
from gridapsolvers_tpu_torch.fem import mhd as tm

torch.set_num_threads(1)

EXACT_RTOL = 1e-14
CYCLE_RTOL = 1e-10
HIST_RTOL = 1e-8
HIST_FLOOR = 1e-12   # of the initial residual
X_RTOL = 1e-8
NC = (4, 4, 4)


def _flat(x):
    if isinstance(x, (tuple, list)):
        return np.concatenate([_flat(v) for v in x])
    return np.ravel(np.asarray(x, dtype=np.float64))


def _close(y, y_ref, rtol):
    y, y_ref = _flat(y), _flat(y_ref)
    scale = np.max(np.abs(y_ref))
    assert y.shape == y_ref.shape and scale > 0
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=rtol * scale)


def _spec(A):
    """The numpy fields of a JAX block operator of ELL blocks."""
    return {"blocks": [[None if b is None else {"values": np.asarray(b.values),
                                                "cols": np.asarray(b.cols), "ncols": b.ncols}
                        for b in row] for row in A.blocks]}


def _converted(jprob):
    return convert.mhd_problem(jprob.ncells, _spec(jprob.A), [np.asarray(v) for v in jprob.b],
                               [np.asarray(v) for v in jprob.free], device="cpu")


def test_mhd_system_patches_and_cycles_equal_jax():
    for nc, beta, gamma in ((NC, 1.0, 1.0), ((4, 3, 2), 2.0, 10.0)):
        prob, jprob = tm.mhd_system(nc, beta, gamma, device="cpu"), jm.mhd_system(nc, beta, gamma)
        for row, jrow in zip(prob.A.blocks, jprob.A.blocks, strict=True):
            for b, jb in zip(row, jrow, strict=True):
                assert (b is None) == (jb is None)
                if b is not None:
                    assert b.ncols == jb.ncols
                    np.testing.assert_array_equal(b.cols.numpy(), np.asarray(jb.cols))
                    _close(b.values, jb.values, EXACT_RTOL)
        _close(prob.b, jprob.b, EXACT_RTOL)
        _close(prob.free, jprob.free, EXACT_RTOL)
        topo, jtopo = tm.mhd_vertex_patches(nc), jm.mhd_vertex_patches(nc)
        np.testing.assert_array_equal(topo.dofs, jtopo.dofs)
        assert (topo.dummy, topo.n_dofs) == (jtopo.dummy, jtopo.n_dofs)

    v = np.random.default_rng(5)
    for cycle in ("v", "w"):
        gmg, prob = tm.mhd_gmg(NC, 2, maxiter=1, cycle=cycle, device="cpu")
        jgmg, jprob = jm.mhd_gmg(NC, 2, maxiter=1, cycle=cycle)
        r = [v.normal(size=int(b.shape[0])) * np.asarray(f) for b, f in zip(jprob.b, jprob.free)]
        jst = jgmg.setup(jprob.A)
        jy = jax.jit(lambda x: jgmg.apply(jst, x))(tuple(jnp.asarray(x) for x in r))
        tr = tuple(torch.from_numpy(x) for x in r)
        _close(gmg.apply(gmg.setup(prob.A), tr), jy, CYCLE_RTOL)
        # the JAX package's level problems, carried over
        probs = [_converted(p) for p in (jprob, jm.mhd_system((2, 2, 2)))]
        cgmg = tm.mhd_gmg_from_problems(probs, maxiter=1, cycle=cycle)
        _close(cgmg.apply(cgmg.setup(probs[0].A), tr), jy, CYCLE_RTOL)


def test_mhd_fgmres_history_equal_jax():
    gmg, prob = tm.mhd_gmg(NC, 2, maxiter=1, device="cpu")
    s = tl.FGMRESSolver(m=30, Pr=gmg, rtol=1e-6, maxiter=40)
    x, stats = s.solve(s.setup(prob.A), prob.b)
    jgmg, jprob = jm.mhd_gmg(NC, 2, maxiter=1)
    js = jl.FGMRESSolver(m=30, Pr=jgmg, rtol=1e-6, maxiter=40)
    jst = js.setup(jprob.A)
    jx, jstats = jax.jit(lambda b: js.solve(jst, b))(jprob.b)
    assert stats.niter == int(jstats.niter) == 5
    assert int(stats.flag) == int(jstats.flag) and stats.converged()
    k = stats.niter
    h, jh = stats.residuals.numpy()[: k + 1], np.asarray(jstats.residuals)[: k + 1]
    np.testing.assert_allclose(h, jh, rtol=HIST_RTOL, atol=HIST_FLOOR * jh[0])
    _close(x, jx, X_RTOL)
    assert prob.residual_norm(x) < 1e-5
