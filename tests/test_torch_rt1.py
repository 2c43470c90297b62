"""The port's RT1 x P1disc Darcy path (the reference's DarcyGMG at order 2)
against the JAX package.

The same RT1 Kronecker blocks, boundary masks, augmented velocity
operators (banded diagonal blocks on the mixed C0/DG grids, ELL cross
blocks), vertex-star patch tables, nested RT1 transfers and Darcy RT1
problems are built by both packages in f64 on the CPU: scipy blocks, masks,
offsets, ELL columns and patch tables equal exactly, bands, values and
vectors to 1e-14 of their largest entry, transfers applied to seeded
vectors to 1e-13. One V-cycle of `rt1_gmg` (8^2 cells, 2 levels) on the
port's own set-up and on the JAX state carried over by `convert` agrees
with JAX's to 1e-10 of max|y|: the vertex-star patch matrices have
condition numbers up to 7.2e5 at alpha = 1e2, so a patch solve's rounding
reaches ~7.2e5 x 2.2e-16 = 1.6e-10 of its output (read: 1.3e-11 on the
port's own set-up, whose patch inverses differ from JAX's by 1.4e-11, and
1.7e-11 on the carried state). `solve_darcy` at order 2 (8^2, 2 levels):
FGMRES iterations and flags equal, residual histories to rtol 1e-8, x to
1e-10 of max|x|, the velocity error to 2 x 1e-10 of max|x| (a sum of two
maxima of |u - u_exact|, each a difference of x).

This file holds its cases in two tests that loop over them: pytest-xdist's
loadfile scheduler queues test files by their number of tests, most first,
so a file of two tests runs after the suite's long files instead of
delaying them.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jax_reference_jit import jitted_jax_dense, jitted_jax_solves
from gridapsolvers_tpu.fem import rt1 as j_rt1
from gridapsolvers_tpu.models.darcy import solve_darcy as j_solve_darcy

from gridapsolvers_tpu_torch import convert
from gridapsolvers_tpu_torch.fem import rt1
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
CYCLE_RTOL = 1e-10
HIST_RTOL = 1e-8
X_RTOL = 1e-10


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
    """Same composite structure; equal offsets and ELL columns, bands and
    values to EXACT_RTOL."""
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


def _check_rt1_blocks_and_masks_equal_jax(ncells):
    S, jS = rt1.rt1_blocks(ncells, 2.0), j_rt1.rt1_blocks(ncells, 2.0)
    assert S["shapes"] == jS["shapes"] and S["h"] == jS["h"]
    mats = [(a, b) for a, b in zip(S["M"], jS["M"], strict=True)]
    mats += [(S["G"][k], jS["G"][k]) for k in jS["G"]]
    mats += [(a, b) for Bm, jBm in zip(S["B"], jS["B"], strict=True)
             for a, b in zip(Bm, jBm, strict=True)]
    mats += [(S["Mp"], jS["Mp"])]
    mats += [(rt1.rt1_pressure_rows(Bm, len(ncells)), j_rt1.rt1_pressure_rows(jBm, len(ncells)))
             for Bm, jBm in zip(S["B"], jS["B"])]
    for a, b in mats:
        assert a.shape == b.shape and (a != b).nnz == 0
    for m, jm in zip(rt1.rt1_boundary_masks(ncells), j_rt1.rt1_boundary_masks(ncells),
                     strict=True):
        np.testing.assert_array_equal(m, jm)


def _check_rt1_velocity_operator_and_patches_equal_jax(ncells):
    A, masks = rt1.rt1_velocity_operator(ncells, 1e2, device="cpu")
    jA, jmasks = j_rt1.rt1_velocity_operator(ncells, 1e2)
    _assert_same_operator(A, jA)
    # the diagonal blocks on K2 (the mixed C0/DG grids), the cross blocks on K3
    assert [type(b).__name__ for b in A.blocks[0]][:2] == ["StencilMatrix", "ELLMatrix"]
    assert A.blocks[0][0].grid_shape == rt1.rt1_dof_shape(ncells, 0)
    for m, jm in zip(masks, jmasks, strict=True):
        np.testing.assert_array_equal(m, jm)
    # every block as an ELL (banded=False)
    _assert_same_operator(rt1.rt1_velocity_operator(ncells, 1e2, banded=False, device="cpu")[0],
                          j_rt1.rt1_velocity_operator(ncells, 1e2, banded=False)[0])
    topo, jtopo = rt1.rt1_vertex_patches(ncells), j_rt1.rt1_vertex_patches(ncells)
    np.testing.assert_array_equal(topo.dofs, jtopo.dofs)
    assert (topo.dummy, topo.n_dofs) == (jtopo.dummy, jtopo.n_dofs)


def _check_rt1_transfers_equal_jax(coarse):
    fine = tuple(2 * n for n in coarse)
    free_f = tuple(torch.from_numpy((~m).astype(float)) for m in rt1.rt1_boundary_masks(fine))
    free_c = tuple(torch.from_numpy((~m).astype(float))
                   for m in rt1.rt1_boundary_masks(coarse))
    P, R = rt1.rt1_transfer_pair(coarse, mask_fine=free_f, mask_coarse=free_c, device="cpu")
    jP, jR = j_rt1.rt1_transfer_pair(coarse, mask_fine=tuple(jnp.asarray(m.numpy())
                                                             for m in free_f),
                                     mask_coarse=tuple(jnp.asarray(m.numpy()) for m in free_c))
    for mats, jmats in zip(P.mats, jP.mats, strict=True):
        for m, jm in zip(mats, jmats, strict=True):
            np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    rng = np.random.default_rng(4)
    xc, jxc = _rand_like(rng, free_c)
    xf, jxf = _rand_like(rng, free_f)
    _assert_close(P.matvec(xc), jP.matvec(jxc), TRANSFER_RTOL)
    _assert_close(R.matvec(xf), jR.matvec(jxf), TRANSFER_RTOL)


def _check_darcy_rt1_problem_equal_jax():
    prob = rt1.darcy_rt1_problem((4, 3), alpha=1e2, device="cpu")
    jprob = j_rt1.darcy_rt1_problem((4, 3), alpha=1e2)
    _assert_same_operator(prob.A, jprob.A)
    _assert_same_operator(prob.Mp, jprob.Mp)
    _assert_close(prob.b, jprob.b, EXACT_RTOL)
    _assert_close(prob.x_exact, jprob.x_exact, EXACT_RTOL)
    x, jx = _rand_like(np.random.default_rng(5), prob.b)
    assert prob.residual_norm(x) == pytest.approx(jprob.residual_norm(jx), rel=1e-13)
    assert prob.velocity_error(x[0]) == pytest.approx(jprob.velocity_error(jx[0]), rel=1e-13)
    # the discrete solution is the interpolant of the exact pair
    assert prob.residual_norm(prob.x_exact) < 1e-12 * float(
        max(v.abs().max() for v in _jleaves(prob.b)))


def _check_solve_darcy_rt1_equal_jax():
    banded_stencil.counts.reset()
    ell_spmv.counts.reset()
    x, stats, info = solve_darcy((8, 8), rtol=1e-10, order=2, num_levels=2, device="cpu")
    with jitted_jax_solves():
        jx, jstats, jinfo = j_solve_darcy((8, 8), rtol=1e-10, order=2, num_levels=2)
    assert stats.niter == int(jstats.niter) and int(stats.flag) == int(jstats.flag)
    k = stats.niter
    np.testing.assert_allclose(stats.residuals.numpy()[: k + 1],
                               np.asarray(jstats.residuals)[: k + 1], rtol=HIST_RTOL)
    _assert_close(x, jx, X_RTOL)
    assert info["residual"] == pytest.approx(jinfo["residual"], rel=1e-6)
    xmax = float(max(v.abs().max() for v in _jleaves(x)))
    assert abs(info["velocity_error"] - jinfo["velocity_error"]) <= 2 * X_RTOL * xmax
    # on CPU tensors every apply ran the plain versions: K2 on the diagonal
    # velocity blocks, K3 on the cross blocks, B, Bt and Mp
    assert banded_stencil.counts.kernel == 0 and banded_stencil.counts.plain > 0
    assert ell_spmv.counts.kernel == 0 and ell_spmv.counts.plain > 0


def _check_rt1_vcycle_equal_jax():
    """One V-cycle of rt1_gmg (8^2, 2 levels) on the same input: the port's
    own set-up, and JAX's state carried over by convert."""
    gmg, A, _ = rt1.rt1_gmg((8, 8), 2, alpha=1e2, device="cpu")
    jgmg, jA, _ = j_rt1.rt1_gmg((8, 8), 2, alpha=1e2)
    state, jstate = gmg.setup(A), jgmg.setup(jA)
    r, jr = _rand_like(np.random.default_rng(6), A.diag())
    jy = jax.jit(jgmg.apply)(jstate, jr)
    _assert_close(gmg.apply(state, r), jy, CYCLE_RTOL)
    carried = convert.patch_gmg_state(
        gmg, [_spec(m) for m in jstate["mats"]],
        [{k: np.asarray(s["M"][k]) for k in ("dofs", "inv", "uncovered_inv_diag")}
         for s in jstate["pre"]],
        {k: np.asarray(v) for k, v in jstate["coarse"].items()},
        [{"rt1": "P", "coarse_cells": p.coarse_cells,
          "mats": [[np.asarray(m) for m in per] for per in p.mats],
          "mask_fine": [np.asarray(m) for m in p.mask_fine]} for p in jstate["P"]],
        [{"rt1": "R", "coarse_cells": q.coarse_cells,
          "mats": [[np.asarray(m) for m in per] for per in q.mats],
          "mask_fine": [np.asarray(m) for m in q.mask_fine],
          "mask_coarse": [np.asarray(m) for m in q.mask_coarse]} for q in jstate["R"]],
        device="cpu")
    _assert_close(gmg.apply(carried, r), jy, CYCLE_RTOL)


def test_rt1_assembly_and_transfers_equal_jax():
    for ncells in ((3, 4), (2, 3, 2)):
        _check_rt1_blocks_and_masks_equal_jax(ncells)
    for ncells in ((4, 3), (2, 2, 2)):
        _check_rt1_velocity_operator_and_patches_equal_jax(ncells)
    for coarse in ((3, 2), (2, 1, 2)):
        _check_rt1_transfers_equal_jax(coarse)
    _check_darcy_rt1_problem_equal_jax()


def test_rt1_solve_and_vcycle_equal_jax():
    # the solve first: the V-cycle's JAX set-up then reuses the primitives
    # it compiled (the same shapes)
    _check_solve_darcy_rt1_equal_jax()
    _check_rt1_vcycle_equal_jax()
