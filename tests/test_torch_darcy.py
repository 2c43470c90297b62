"""The port's RT0 Darcy and H(div) paths against the JAX package, and the
port's independence of JAX: every module of `gridapsolvers_tpu_torch`
(and `chip_smoke.py`) imports with `jax` and `gridapsolvers_tpu`
unimportable.

The same RT0 blocks, boundary masks, Darcy problems (plain and grad-div
augmented), H(div) operators, vertex-patch tables and RT0 transfers are
built by both packages in f64 on the CPU: scipy blocks, masks, ELL columns
and patch tables equal exactly, ELL values and vectors to 1e-14 of their
largest entry (bit for bit in practice), transfers applied to seeded
vectors to 1e-13. One V-cycle of `hdiv_gmg` (8^2 cells, 2 levels) on the
port's own set-up and on the JAX state carried over by `convert` agrees
with JAX's to 1e-11 of max|y|: the vertex patches' matrices have condition
numbers up to 3.8e4 at alpha = 1e2, so the two packages' Vanka applies part
at ~1e-12 (read: 1.1e-12 own set-up, 8.7e-13 carried). `solve_darcy` in
both RT0 branches at 8^2: iteration counts and flags equal, residual
histories to rtol 1e-8 above 1e-12 of the initial residual (the plain
branch reaches 2.6e-15 of it in two iterations: entries there are
round-off), x to 1e-10 of max|x|.

This file holds its cases in two tests that loop over them: pytest-xdist's
loadfile scheduler queues test files by their number of tests, most first,
so a file of two tests runs after the suite's long files instead of
delaying them.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jax_reference_jit import jitted_jax_dense, jitted_jax_solves
from gridapsolvers_tpu.fem import darcy as j_darcy
from gridapsolvers_tpu.fem import hdiv as j_hdiv
from gridapsolvers_tpu.models.darcy import solve_darcy as j_solve_darcy

from gridapsolvers_tpu_torch import convert
from gridapsolvers_tpu_torch.fem import darcy, hdiv
from gridapsolvers_tpu_torch.models import solve_darcy
from gridapsolvers_tpu_torch.ops import banded_stencil, ell_spmv

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _compiled_jax_dense():
    """The JAX package's `ELLMatrix.todense` runs compiled
    (`jitted_jax_dense`)."""
    with jitted_jax_dense():
        yield


EXACT_RTOL = 1e-14
TRANSFER_RTOL = 1e-13
CYCLE_RTOL = 1e-11
HIST_RTOL = 1e-8
HIST_FLOOR = 1e-12   # of the initial residual
X_RTOL = 1e-10
REPO = Path(__file__).resolve().parents[1]


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


def _assert_same_solve(stats, jstats, x, jx):
    assert stats.niter == int(jstats.niter)
    assert int(stats.flag) == int(jstats.flag)
    k = stats.niter
    h, jh = stats.residuals.numpy()[: k + 1], np.asarray(jstats.residuals)[: k + 1]
    np.testing.assert_allclose(h, jh, rtol=HIST_RTOL, atol=HIST_FLOOR * jh[0])
    _assert_close(x, jx, X_RTOL)


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


def _assert_same_operator(op, jop):
    """Same composite structure; ELL leaves with equal columns and values."""
    name = type(jop).__name__
    assert type(op).__name__ == name
    if name == "BlockOperator":
        for row, jrow in zip(op.blocks, jop.blocks, strict=True):
            for b, jb in zip(row, jrow, strict=True):
                assert (b is None) == (jb is None)
                if b is not None:
                    _assert_same_operator(b, jb)
    elif name in ("ColumnStack", "RowStack", "FieldwiseOperator"):
        for o, jo in zip(op.ops, jop.ops, strict=True):
            _assert_same_operator(o, jo)
    elif name == "ELLMatrix":
        assert op.ncols == jop.ncols
        np.testing.assert_array_equal(op.cols.numpy(), np.asarray(jop.cols))
        _assert_close(op.values, jop.values, EXACT_RTOL)
    else:
        assert op.offsets == tuple(tuple(o) for o in jop.offsets)
        assert op.grid_shape == tuple(jop.grid_shape)
        _assert_close(op.bands, jop.bands, EXACT_RTOL)


def _rand_like(rng, x):
    """The same seeded vector, as (torch, jax), shaped like the tuple x."""
    if isinstance(x, (tuple, list)):
        pairs = [_rand_like(rng, xi) for xi in x]
        return tuple(p[0] for p in pairs), tuple(p[1] for p in pairs)
    v = rng.normal(size=int(x.shape[0]))
    return torch.from_numpy(v), jnp.asarray(v)


def _check_rt0_blocks_and_masks_equal_jax(ncells):
    S, jS = darcy.rt0_blocks(ncells), j_darcy.rt0_blocks(ncells)
    assert S["face_shapes"] == jS["face_shapes"] and S["h"] == jS["h"]
    for key in ("M", "B"):
        for a, b in zip(S[key], jS[key], strict=True):
            assert (a != b).nnz == 0
    for m, jm in zip(darcy.rt0_boundary_masks(ncells), j_darcy.rt0_boundary_masks(ncells),
                     strict=True):
        np.testing.assert_array_equal(m, jm)


def _check_darcy_problem_equal_jax(alpha):
    prob = darcy.darcy_problem((6, 5), graddiv_alpha=alpha, device="cpu")
    jprob = j_darcy.darcy_problem((6, 5), graddiv_alpha=alpha)
    _assert_same_operator(prob.A, jprob.A)
    for v, jv in ((prob.b, jprob.b), (prob.u_exact, jprob.u_exact),
                  (prob.p_exact, jprob.p_exact)):
        _assert_close(v, jv, EXACT_RTOL)
    assert prob.cell_volume == jprob.cell_volume
    x, jx = _rand_like(np.random.default_rng(1), prob.b)
    _assert_close(prob.A.matvec(x), jprob.A.matvec(jx), EXACT_RTOL)
    assert prob.residual_norm(x) == pytest.approx(jprob.residual_norm(jx), rel=1e-13)
    assert prob.pressure_error(x[1]) == pytest.approx(jprob.pressure_error(jx[1]), rel=1e-13)


def _check_hdiv_operator_and_patches_equal_jax(ncells):
    A, free = hdiv.hdiv_operator(ncells, 1e2, device="cpu")
    jA, jfree = j_hdiv.hdiv_operator(ncells, 1e2)
    _assert_same_operator(A, jA)
    for f, jf in zip(free, jfree, strict=True):
        np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    topo, jtopo = hdiv.hdiv_vertex_patches(ncells), j_hdiv.hdiv_vertex_patches(ncells)
    np.testing.assert_array_equal(topo.dofs, jtopo.dofs)
    assert (topo.dummy, topo.n_dofs) == (jtopo.dummy, jtopo.n_dofs)


def _check_rt0_transfers_equal_jax(coarse):
    fine = tuple(2 * n for n in coarse)
    _, free_f = hdiv.hdiv_operator(fine, 1.0, device="cpu")
    _, free_c = hdiv.hdiv_operator(coarse, 1.0, device="cpu")
    jfree_f = tuple(jnp.asarray(m.numpy()) for m in free_f)
    jfree_c = tuple(jnp.asarray(m.numpy()) for m in free_c)
    rng = np.random.default_rng(2)
    P, jP = hdiv.RTProlongation(coarse, free_f), j_hdiv.RTProlongation(coarse, jfree_f)
    R = hdiv.RTRestriction(coarse, free_c, free_f)
    jR = j_hdiv.RTRestriction(coarse, jfree_c, jfree_f)
    xc, jxc = _rand_like(rng, free_c)
    xf, jxf = _rand_like(rng, free_f)
    _assert_close(P.matvec(xc), jP.matvec(jxc), TRANSFER_RTOL)
    _assert_close(R.matvec(xf), jR.matvec(jxf), TRANSFER_RTOL)
    # R is P's transpose: <P xc, xf> = <xc, R xf> without masks
    P0, R0 = hdiv.RTProlongation(coarse), hdiv.RTRestriction(coarse)
    lhs = sum(float(a @ b) for a, b in zip(P0.matvec(xc), xf))
    rhs = sum(float(a @ b) for a, b in zip(xc, R0.matvec(xf)))
    assert lhs == pytest.approx(rhs, rel=1e-13)


def _check_solve_darcy_rt0_equal_jax(alpha):
    banded_stencil.counts.reset()
    ell_spmv.counts.reset()
    x, stats, info = solve_darcy((8, 8), rtol=1e-10, graddiv_alpha=alpha, num_levels=2,
                                 device="cpu")
    with jitted_jax_solves():
        jx, jstats, jinfo = j_solve_darcy((8, 8), rtol=1e-10, graddiv_alpha=alpha, num_levels=2)
    _assert_same_solve(stats, jstats, x, jx)
    assert info["pressure_error"] == pytest.approx(jinfo["pressure_error"], rel=1e-8)
    # on CPU tensors every ELL apply ran K3's plain version
    assert ell_spmv.counts.kernel == 0 and ell_spmv.counts.plain > 0
    assert banded_stencil.counts.kernel == 0


def _vanka_arrays(st):
    return {"dofs": np.asarray(st["dofs"]), "inv": np.asarray(st["inv"]),
            "uncovered_inv_diag": np.asarray(st["uncovered_inv_diag"])}


def _check_hdiv_vcycle_equal_jax():
    """One V-cycle of hdiv_gmg (8^2, 2 levels) on the same input: the
    port's own set-up, and JAX's state carried over by convert."""
    gmg, A, _ = hdiv.hdiv_gmg((8, 8), 2, alpha=1e2, device="cpu")
    jgmg, jA, _ = j_hdiv.hdiv_gmg((8, 8), 2, alpha=1e2)
    state, jstate = gmg.setup(A), jgmg.setup(jA)
    r, jr = _rand_like(np.random.default_rng(3), A.diag())
    jy = jax.jit(jgmg.apply)(jstate, jr)
    _assert_close(gmg.apply(state, r), jy, CYCLE_RTOL)
    carried = convert.patch_gmg_state(
        gmg, [_spec(m) for m in jstate["mats"]],
        [_vanka_arrays(s["M"]) for s in jstate["pre"]],
        {k: np.asarray(v) for k, v in jstate["coarse"].items()},
        [{"rt0": "P", "coarse_cells": p.coarse_cells,
          "mask_fine": [np.asarray(m) for m in p.mask_fine]} for p in jstate["P"]],
        [{"rt0": "R", "coarse_cells": q.coarse_cells,
          "mask_fine": [np.asarray(m) for m in q.mask_fine],
          "mask_coarse": [np.asarray(m) for m in q.mask_coarse]} for q in jstate["R"]],
        device="cpu")
    _assert_close(gmg.apply(carried, r), jy, CYCLE_RTOL)


# -- the port imports no JAX ----------------------------------------------------

_NO_JAX = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["gridapsolvers_tpu"] = None
import gridapsolvers_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "gridapsolvers_tpu")
       and sys.modules[m] is not None]
assert not bad, bad
print(len(names))
"""


def _check_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) > 60


def test_rt0_assembly_transfers_and_port_imports():
    for ncells in ((4, 5), (3, 4, 2)):
        _check_rt0_blocks_and_masks_equal_jax(ncells)
    for alpha in (0.0, 1e2):
        _check_darcy_problem_equal_jax(alpha)
    for ncells in ((6, 4), (4, 2, 2)):
        _check_hdiv_operator_and_patches_equal_jax(ncells)
    for coarse in ((3, 4), (2, 3, 2)):
        _check_rt0_transfers_equal_jax(coarse)
    _check_port_imports_no_jax()


def test_rt0_solves_and_hdiv_vcycle_equal_jax():
    # the grad-div solve first: the V-cycle's JAX set-up then reuses the
    # primitives it compiled (the same shapes)
    for alpha in (0.0, 1e2):
        _check_solve_darcy_rt0_equal_jax(alpha)
    _check_hdiv_vcycle_equal_jax()
