"""The port's linear elasticity path against the JAX package.

Element blocks, the Dirichlet-eliminated d x d block operators and the
clamped cantilever problems are built by both packages in f64 on the CPU,
in 2D and at 4^3: offsets equal, element blocks, bands and right-hand sides
to 1e-14 of their largest entry (the port sums its bands straight from the
element matrices, the JAX package through a scipy COO scatter, so the sums
run in other orders). One V-cycle of `elasticity_gmg` (8^2, 2 levels) on
the port's own set-up and on the JAX state carried over by `convert`
agrees with JAX's to 1e-12 of max|y|. `solve_elasticity((8, 8),
num_levels=2)` and CG + AMG with rigid-body near-nullspace candidates at
12^2 (the PETSc GAMG recipe of tests/test_amg.py): iteration counts and
flags equal, residual histories to rtol 1e-8, x to 1e-10 of max|x|. No 3D
solve of the JAX package runs here (its jit takes minutes at 8^3).

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

from jax_reference_jit import jsolve, jitted_jax_solves
from gridapsolvers_tpu.fem import elasticity as j_el
from gridapsolvers_tpu.fem.mesh import CartesianMesh as JMesh
from gridapsolvers_tpu.interfaces import rigid_body_modes as j_rigid_body_modes
from gridapsolvers_tpu.linear import CGSolver as JCGSolver
from gridapsolvers_tpu.linear.amg import AMGSolver as JAMGSolver
from gridapsolvers_tpu.models.elasticity import solve_elasticity as j_solve_elasticity

from gridapsolvers_tpu_torch import convert
from gridapsolvers_tpu_torch.fem import elasticity as el
from gridapsolvers_tpu_torch.fem.mesh import CartesianMesh
from gridapsolvers_tpu_torch.interfaces import rigid_body_modes
from gridapsolvers_tpu_torch.linear import AMGSolver, CGSolver
from gridapsolvers_tpu_torch.models import solve_elasticity
from gridapsolvers_tpu_torch.ops import banded_stencil, ell_spmv

torch.set_num_threads(1)


EXACT_RTOL = 1e-14
CYCLE_RTOL = 1e-12
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


def _assert_same_solve(stats, jstats, x, jx):
    assert stats.niter == int(jstats.niter)
    assert int(stats.flag) == int(jstats.flag)
    k = stats.niter
    np.testing.assert_allclose(stats.residuals.numpy()[: k + 1],
                               np.asarray(jstats.residuals)[: k + 1], rtol=HIST_RTOL)
    _assert_close(x, jx, X_RTOL)


def _spec(op):
    """The numpy fields of a JAX operator, for convert.operator."""
    if type(op).__name__ == "BlockOperator":
        return {"blocks": [[None if b is None else _spec(b) for b in row] for row in op.blocks]}
    return {"bands": np.asarray(op.bands), "offsets": op.offsets, "grid_shape": op.grid_shape,
            "periodic": op.periodic}


def _assert_same_block_operator(A, jA):
    for row, jrow in zip(A.blocks, jA.blocks, strict=True):
        for b, jb in zip(row, jrow, strict=True):
            assert b.offsets == tuple(tuple(o) for o in jb.offsets)
            assert b.grid_shape == tuple(jb.grid_shape)
            _assert_close(b.bands, jb.bands, EXACT_RTOL)


def _rand_like(rng, x):
    """The same seeded tuple vector, as (torch, jax)."""
    vs = [rng.normal(size=int(v.shape[0])) for v in x]
    return tuple(torch.from_numpy(v) for v in vs), tuple(jnp.asarray(v) for v in vs)


def _mesh_pair(ncells):
    domain = tuple(x for _ in ncells for x in (0.0, 1.0))
    return CartesianMesh(tuple(ncells), domain), JMesh(tuple(ncells), domain)


def _check_element_blocks_equal_jax(ncells):
    mesh, jmesh = _mesh_pair(ncells)
    eb, jeb = el.elastic_element_blocks(mesh, 1.3, 0.7), j_el.elastic_element_blocks(jmesh, 1.3,
                                                                                       0.7)
    assert eb.keys() == jeb.keys()
    for k in eb:
        _assert_close(eb[k], jeb[k], EXACT_RTOL)


def _check_elasticity_operator_equal_jax(ncells, masked):
    from gridapsolvers_tpu.fem import assembly2 as jasm

    mesh, jmesh = _mesh_pair(ncells)
    mask = jasm.boundary_node_mask(jmesh, 1, tags=("x0",)) if masked else None
    A = el.elasticity_operator(mesh, 1.0, 2.0, mask, device="cpu")
    jA = j_el.elasticity_operator(jmesh, 1.0, 2.0, mask)
    _assert_same_block_operator(A, jA)


def _check_elasticity_problem_equal_jax(ncells):
    prob = el.elasticity_problem(ncells, device="cpu")
    jprob = j_el.elasticity_problem(ncells)
    _assert_same_block_operator(prob.A, jprob.A)
    np.testing.assert_array_equal(prob.dirichlet_mask, jprob.dirichlet_mask)
    _assert_close(prob.b, jprob.b, EXACT_RTOL)
    x, jx = _rand_like(np.random.default_rng(7), prob.b)
    _assert_close(prob.A.matvec(x), jprob.A.matvec(jx), EXACT_RTOL)
    assert prob.residual_norm(x) == pytest.approx(jprob.residual_norm(jx), rel=1e-13)


def _check_solve_elasticity_equal_jax():
    banded_stencil.counts.reset()
    x, stats, info = solve_elasticity((8, 8), num_levels=2, device="cpu")
    with jitted_jax_solves():
        jx, jstats, jinfo = j_solve_elasticity((8, 8), num_levels=2)
    _assert_same_solve(stats, jstats, x, jx)
    assert info["residual"] == pytest.approx(jinfo["residual"], rel=1e-6)
    # every block apply ran K2's plain version (CPU tensors)
    assert banded_stencil.counts.kernel == 0 and banded_stencil.counts.plain > 0


def _check_elasticity_vcycle_equal_jax():
    """One V-cycle of elasticity_gmg (8^2, 2 levels) on the same input: the
    port's own set-up, and JAX's state carried over by convert."""
    prob, jprob = el.elasticity_problem((8, 8), device="cpu"), j_el.elasticity_problem((8, 8))
    gmg = el.elasticity_gmg((8, 8), 2, device="cpu")
    jgmg = j_el.elasticity_gmg((8, 8), 2)
    state, jstate = gmg.setup(prob.A), jgmg.setup(jprob.A)
    r, jr = _rand_like(np.random.default_rng(8), prob.b)
    jy = jax.jit(jgmg.apply)(jstate, jr)
    _assert_close(gmg.apply(state, r), jy, CYCLE_RTOL)

    def fields(t, kind):
        spec = {"fine_shape": t.fine_shape, "coarse_shape": t.coarse_shape,
                "mask_fine": np.asarray(t.mask_fine)}
        if kind == "R":
            spec.update(mode=t.mode, mask_coarse=np.asarray(t.mask_coarse))
        return spec

    carried = convert.gmg_state(
        gmg, [_spec(m) for m in jstate["mats"]],
        [{"inv_diag": tuple(np.asarray(v) for v in s["inv_diag"]), "lmax": s["lmax"],
          "lmin": s["lmin"]} for s in jstate["pre"]],
        {k: np.asarray(v) for k, v in jstate["coarse"].items()},
        [{"fields": [fields(t, "P") for t in p.ops]} for p in jstate["P"]],
        [{"fields": [fields(t, "R") for t in q.ops]} for q in jstate["R"]],
        device="cpu")
    _assert_close(gmg.apply(carried, r), jy, CYCLE_RTOL)


def _candidates(coords, ns):
    """Node-major rigid-body modes as component-major columns (the block
    system's layout), as tests/test_amg.py builds them."""
    n = coords.shape[0]
    return np.stack([np.concatenate([np.asarray(q).reshape(n, 2)[:, 0],
                                     np.asarray(q).reshape(n, 2)[:, 1]])
                     for q in ns.vectors], axis=1)


def _check_amg_rigid_body_candidates_equal_jax():
    prob, jprob = el.elasticity_problem((12, 12), device="cpu"), j_el.elasticity_problem((12, 12))
    coords = prob.mesh.vertex_coords()
    cand = _candidates(coords, rigid_body_modes(torch.from_numpy(coords)))
    jcand = _candidates(coords, j_rigid_body_modes(jnp.asarray(coords)))
    np.testing.assert_allclose(cand, jcand, rtol=0, atol=1e-14)
    ell_spmv.counts.reset()
    solver = CGSolver(Pl=AMGSolver(coarse_size=80, near_nullspace=cand), rtol=1e-8, maxiter=80)
    x, stats = solver.solve(solver.setup(prob.A), prob.b)
    jsolver = JCGSolver(Pl=JAMGSolver(coarse_size=80, near_nullspace=jcand), rtol=1e-8,
                        maxiter=80)
    jx, jstats = jsolve(jsolver, jsolver.setup(jprob.A), jprob.b)
    _assert_same_solve(stats, jstats, x, jx)
    assert prob.residual_norm(x) == pytest.approx(jprob.residual_norm(jx), rel=1e-4)
    assert ell_spmv.counts.kernel == 0 and ell_spmv.counts.plain > 0


def test_elasticity_assembly_equal_jax():
    for ncells in ((3, 4), (2, 3, 2)):
        _check_element_blocks_equal_jax(ncells)
    for ncells, masked in (((8, 8), True), ((4, 4, 4), True), ((3, 4), False)):
        _check_elasticity_operator_equal_jax(ncells, masked)
    for ncells in ((6, 5), (4, 4, 4)):
        _check_elasticity_problem_equal_jax(ncells)


def test_elasticity_solves_and_vcycle_equal_jax():
    # the solve first: the V-cycle's JAX set-up then reuses the primitives
    # it compiled (the same shapes)
    _check_solve_elasticity_equal_jax()
    _check_elasticity_vcycle_equal_jax()
    _check_amg_rigid_body_candidates_equal_jax()
