"""The port's flat engine against the JAX package.

The ELL view of composites, the blocked-kernel operator (`flat_kernel_
operator`), the materialized Vanka smoother (its assembled matrix, its
values-only refresh, its overlap weighting), the preconditioned Chebyshev
smoother, the exact FE transfers, a V-cycle on bf16 operators, and the flat-engine
FGMRES flagship of the augmented Stokes configuration. On the CPU, JAX's
flat engine resolves to its XLA ELL path and the port runs K3's plain
version, so both compute the same maps in f64. Index tables are equal;
single operator applies agree to 1e-12 of their largest entry; iteration
counts are equal and residual histories agree to rtol 1e-8, with the
inner pressure CG's floor of 1e-8 of the initial residual.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jax_reference_jit import jitted_jax_patch_setups
from gridapsolvers_tpu.algebra.ell_view import ell_pattern as j_ell_pattern
from gridapsolvers_tpu.algebra.ell_view import ell_values as j_ell_values
from gridapsolvers_tpu.algebra.flat import blocked_kernel_from_scipy as j_blocked_from_scipy
from gridapsolvers_tpu.algebra.flat import flat_kernel_operator as j_flat
from gridapsolvers_tpu.blocks import BlockTriangularSolver as JBlockTriangular
from gridapsolvers_tpu.blocks import MatrixBlock as JMatrixBlock
from gridapsolvers_tpu.fem.mesh import CartesianMesh as JMesh
from gridapsolvers_tpu.fem.stokes import graddiv_velocity_block as j_graddiv_block
from gridapsolvers_tpu.fem.stokes import stokes_problem as j_stokes_problem
from gridapsolvers_tpu.fem.stokes import velocity_gmg as j_velocity_gmg
from gridapsolvers_tpu.fem.stokes import velocity_vanka_smoother as j_vanka_smoother
from gridapsolvers_tpu.linear import CGSolver as JCG
from gridapsolvers_tpu.linear import FGMRESSolver as JFGMRES
from gridapsolvers_tpu.linear import JacobiSolver as JJacobi
from gridapsolvers_tpu.linear.smoothers import PreconditionedChebyshevSmoother as JPCheb
from gridapsolvers_tpu.multilevel import transfer as jtransfer
from gridapsolvers_tpu.patches.materialized import MaterializedVankaSmoother as JMaterialized
from gridapsolvers_tpu.patches.materialized import materialize_vanka as j_materialize

from gridapsolvers_tpu_torch import convert
from gridapsolvers_tpu_torch.algebra import to_scipy
from gridapsolvers_tpu_torch.algebra.ell_view import (
    ell_pattern,
    ell_values,
    iter_field_leaves,
    rebuild_with_leaves,
    stencil_cols_valid,
)
from gridapsolvers_tpu_torch.algebra.flat import (
    BlockedKernelOperator,
    blocked_kernel_from_scipy,
    flat_kernel_operator,
)
from gridapsolvers_tpu_torch.blocks import BlockTriangularSolver, MatrixBlock
from gridapsolvers_tpu_torch.fem import assembly2 as asm
from gridapsolvers_tpu_torch.fem.assembly import laplacian
from gridapsolvers_tpu_torch.fem.mesh import CartesianMesh
from gridapsolvers_tpu_torch.fem.stokes import (
    graddiv_velocity_block,
    stokes_problem,
    velocity_gmg,
    velocity_vanka_smoother,
)
from gridapsolvers_tpu_torch.linear import CGSolver, FGMRESSolver, JacobiSolver
from gridapsolvers_tpu_torch.linear.smoothers import PreconditionedChebyshevSmoother
from gridapsolvers_tpu_torch.multilevel import transfer
from gridapsolvers_tpu_torch.ops import ell_spmv
from gridapsolvers_tpu_torch.patches import VankaSolver
from gridapsolvers_tpu_torch.patches.materialized import (
    MaterializedVankaSmoother,
    materialize_vanka,
)
from gridapsolvers_tpu_torch.utils import pytrees as pt

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _compiled_jax_patch_setups():
    """The JAX references' patch smoothers refresh their values compiled
    (`jitted_jax_patch_setups`)."""
    with jitted_jax_patch_setups():
        yield

OP_RTOL = 1e-12
HIST_RTOL = 1e-8
HIST_FLOOR = 1e-8   # of the initial residual: the inner CG's rtol
FINAL_RTOL = 1e-6
LMAX_RTOL = 1e-10
BF16_CYCLE_RTOL = 1e-12


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


def _rand_like(rng, template):
    leaves = [rng.normal(size=t.shape[0]) for t in template]
    return tuple(torch.from_numpy(v) for v in leaves), tuple(jnp.asarray(v) for v in leaves)


def _meshes(nc):
    dom = (0.0, 1.0) * len(nc)
    return CartesianMesh(nc, dom), JMesh(nc, dom)


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


def _assert_same_blocks(kb, jkb, rtol=OP_RTOL):
    """Equal ELL arrays block by block (JAX's ELL has no row lengths:
    its slots past a row's length hold 0, as the port's do)."""
    for row, jrow in zip(kb, jkb):
        for b, jb in zip(row, jrow):
            assert (b is None) == (jb is None)
            if b is None:
                continue
            np.testing.assert_array_equal(b.cols.numpy(), np.asarray(jb.cols))
            _assert_close(b.values, jb.values, rtol)


@pytest.fixture(scope="module")
def aug8():
    m, jm = _meshes((8, 8))
    return (m, jm, graddiv_velocity_block(m, 1.0, 1e3, banded=True, device="cpu"),
            j_graddiv_block(jm, 1.0, 1e3, banded=True))


# ------------------------------------------------------------- ell_view ---


@pytest.mark.parametrize("which", ["augmented", "plain_stokes"])
def test_ell_pattern_and_values_equal_jax(aug8, which):
    if which == "augmented":
        A, jA = aug8[2], aug8[3]
    else:
        A, jA = stokes_problem((4, 4), device="cpu").A, j_stokes_problem((4, 4)).A
    meta, cols, masks = ell_pattern(A)
    jmeta, jcols, jmasks = j_ell_pattern(jA)
    assert dataclasses.asdict(meta) == dataclasses.asdict(jmeta)
    np.testing.assert_array_equal(cols.numpy(), np.asarray(jcols))
    for m, jmk in zip(masks, jmasks):
        assert (m is None) == (jmk is None)
        if m is not None:
            np.testing.assert_array_equal(m.numpy(), np.asarray(jmk))
    np.testing.assert_array_equal(ell_values(A, meta, masks).numpy(),
                                  np.asarray(j_ell_values(jA, jmeta, jmasks)))
    # the same composite rebuilt around its own leaves applies as before
    B = rebuild_with_leaves(A, iter([leaf for _, _, leaf in iter_field_leaves(A)]))
    assert type(B) is type(A)
    assert [leaf for _, _, leaf in iter_field_leaves(B)] == [
        leaf for _, _, leaf in iter_field_leaves(A)]
    # a periodic stencil's wrap couplings have no place in the banded view:
    # it raises (the JAX package's view drops them without a word)
    per = laplacian(CartesianMesh((4, 3), (0.0, 1.0, 0.0, 1.0), (True, False)), device="cpu")
    with pytest.raises(ValueError, match="periodic"):
        stencil_cols_valid(per)


# ------------------------------------------------------------ flat ops ----


def test_flat_kernel_operator_equal_jax(aug8):
    m, jm, K, jK = aug8
    F, jF = flat_kernel_operator(K), j_flat(jK, engine="ell")
    assert F.sizes == tuple(jF.sizes) and F.inner is K
    for row, jrow in zip(F.kblocks, jF.kblocks):
        for b, jb in zip(row, jrow):
            np.testing.assert_array_equal(b.cols.numpy(), np.asarray(jb.cols))
            np.testing.assert_array_equal(b.values.numpy(), np.asarray(jb.values))
            assert b.row_len is not None and int(b.row_len.max()) == b.row_width
    rng = np.random.default_rng(0)
    x, jx = _rand_like(rng, K.diag())
    _assert_close(F.matvec(x), jF.matvec(jx))
    _assert_close(F.matvec(x), K.matvec(x))
    _assert_close(F.diag(), jF.diag())
    # JAX's blocks carried across apply as the port's own
    G = convert.operator(_spec(jF), device="cpu")
    assert isinstance(G, BlockedKernelOperator)
    _assert_close(G.matvec(x), F.matvec(x))


@pytest.mark.parametrize("refreshable", [False, True])
def test_blocked_kernel_from_scipy_equal_jax(aug8, refreshable):
    """From a CSR with explicit zeros: refreshable blocks keep them in
    their patterns (the values-only refresh contract), others drop them."""
    m, jm, K, jK = aug8
    S = to_scipy(K)
    S.data[::7] = 0.0                     # explicit zeros, kept in the CSR
    sizes = (S.shape[0] // 2,) * 2
    F = blocked_kernel_from_scipy(S, sizes, refreshable=refreshable, device="cpu")
    jF = j_blocked_from_scipy(S, sizes, engine="ell", refreshable=refreshable)
    for row, jrow in zip(F.kblocks, jF.kblocks):
        for b, jb in zip(row, jrow):
            np.testing.assert_array_equal(b.cols.numpy(), np.asarray(jb.cols))
            np.testing.assert_array_equal(b.values.numpy(), np.asarray(jb.values))
    stored = sum(int(b.row_len.sum()) for row in F.kblocks for b in row)
    assert stored == (S.nnz if refreshable else int((S.data != 0).sum()))


# ------------------------------------------------------- materialized -----


@pytest.fixture(scope="module")
def materialized8(aug8):
    m, jm, K, jK = aug8
    v = velocity_vanka_smoother(m, omega=0.7)
    mat = MaterializedVankaSmoother(topo=v.topo, omega=0.7, weighting=v.weighting)
    jv = j_vanka_smoother(jm, omega=0.7)
    jmat = JMaterialized(topo=jv.topo, omega=0.7, weighting=jv.weighting, engine="ell")
    return v, mat, mat.setup(K), jv, jmat, jmat.setup(jK)


def test_materialized_matrix_equal_jax(aug8, materialized8):
    """The assembled M_vanka: as a matrix (materialize_vanka) and as the
    smoother's ELL blocks (explicit zeros kept: equal patterns), against
    JAX's."""
    m, jm, K, jK = aug8
    v, mat, st, jv, jmat, jst = materialized8
    n = sum(st["Mv"].sizes)
    M = materialize_vanka(v, st["vst"], n)
    jM = j_materialize(jv, jst["vst"], n)
    # as dense matrices: the CSR sum drops entries that cancel to exactly
    # zero, which round-off decides in either package
    _assert_close(M.toarray(), jM.toarray())
    _assert_same_blocks(st["Mv"].kblocks, jst["Mv"].kblocks)


def test_materialized_matches_batched(aug8, materialized8):
    m, jm, K, jK = aug8
    v, mat, st, *_ = materialized8
    vst = v.setup(K)
    rng = np.random.default_rng(1)
    r, _ = _rand_like(rng, K.diag())
    _assert_close(mat.apply(st, r), v.apply(vst, r), 1e-11)
    x0 = pt.zeros_like(r)
    _assert_close(mat.smooth(st, x0, r), v.smooth(vst, x0, r), 1e-11)


def test_materialized_update_equal_jax(aug8, materialized8):
    """update() at a second viscosity: new values on the same patterns,
    equal to JAX's update and to a fresh set-up."""
    m, jm, K, jK = aug8
    v, mat, st, jv, jmat, jst = materialized8
    K2 = graddiv_velocity_block(m, 2.5, 1e3, banded=True, device="cpu")
    jK2 = j_graddiv_block(jm, 2.5, 1e3, banded=True)
    st2, jst2 = mat.update(st, K2), jmat.update(jst, jK2)
    for row, row2 in zip(st["Mv"].kblocks, st2["Mv"].kblocks):
        for b, b2 in zip(row, row2):
            assert b2.cols is b.cols and b2.row_len is b.row_len and b2.group == b.group
    _assert_same_blocks(st2["Mv"].kblocks, jst2["Mv"].kblocks)
    rng = np.random.default_rng(2)
    r, jr = _rand_like(rng, K.diag())
    _assert_close(mat.apply(st2, r), jmat.apply(jst2, jr))
    _assert_close(mat.apply(st2, r), mat.apply(mat.setup(K2), r))
    _assert_close(mat.apply(st2, r), v.apply(v.setup(K2), r), 1e-11)


def test_materialized_overlap_weighting_matches_batched():
    """Seed-field (pressure) patches on plain Stokes, overlap weighting:
    materialized == batched at set-up (and == JAX) and after update."""
    prob = stokes_problem((4, 4), device="cpu")
    jprob = j_stokes_problem((4, 4))
    v, mat = VankaSolver(omega=1.0), MaterializedVankaSmoother(omega=1.0)
    assert mat.weighting == v.weighting == "overlap"
    jmat = JMaterialized(omega=1.0, engine="ell")
    vst, mst, jmst = v.setup(prob.A), mat.setup(prob.A), jmat.setup(jprob.A)
    r, jr = prob.b, jprob.b
    _assert_close(mat.apply(mst, r), v.apply(vst, r), 1e-11)
    _assert_close(mat.apply(mst, r), jax.jit(lambda v: jmat.apply(jmst, v))(jr))
    prob2 = stokes_problem((4, 4), nu=2.0, device="cpu")
    mst2 = mat.update(mst, prob2.A)
    _assert_close(mat.apply(mst2, r), v.apply(v.update(vst, prob2.A), r), 1e-11)
    _assert_close(mat.apply(mst2, r), mat.apply(mat.setup(prob2.A), r))


# -------------------------------------------------------------- Chebyshev --


def test_preconditioned_chebyshev_equal_jax(aug8):
    """λmax of M·A through the port's materialized M itself equals JAX's
    (through its batched twin) to 1e-10; one smooth agrees to 1e-12."""
    m, jm, K, jK = aug8
    F, jF = flat_kernel_operator(K), j_flat(jK, engine="ell")
    v, jv = velocity_vanka_smoother(m), j_vanka_smoother(jm)
    cheb = PreconditionedChebyshevSmoother(
        M=MaterializedVankaSmoother(topo=v.topo, omega=1.0, weighting="unit"), degree=4)
    jcheb = JPCheb(M=JMaterialized(topo=jv.topo, omega=1.0, weighting="unit", engine="ell"),
                   degree=4)
    st, jst = cheb.setup(F), jcheb.setup(jF)
    assert st["lmax"] == pytest.approx(float(jst["lmax"]), rel=LMAX_RTOL)
    rng = np.random.default_rng(3)
    r, jr = _rand_like(rng, K.diag())
    x0, jx0 = pt.zeros_like(r), tuple(jnp.zeros_like(t) for t in jr)
    _assert_close(cheb.smooth(st, x0, r), jcheb.smooth(jst, jx0, jr))
    # the batched Vanka as M gives the same estimate
    bst = PreconditionedChebyshevSmoother(M=VankaSolver(topo=v.topo, weighting="unit"),
                                          degree=4).setup(K)
    assert bst["lmax"] == pytest.approx(st["lmax"], rel=LMAX_RTOL)


# ------------------------------------------------------------- transfers --


@pytest.mark.parametrize("ncells", [(4, 4), (2, 3, 2)])
def test_fe_transfers_equal_jax(ncells):
    """fe_transfer_pair (ELL, K3) and fe_transfer_pair_dense
    (TensorTransfer) against JAX's, with Dirichlet masks."""
    fine = CartesianMesh(tuple(2 * n for n in ncells), (0.0, 1.0) * len(ncells))
    coarse = CartesianMesh(ncells, (0.0, 1.0) * len(ncells))
    mask_f, mask_c = asm.boundary_node_mask(fine, 2), asm.boundary_node_mask(coarse, 2)
    np.testing.assert_array_equal(transfer.fe_grid_interpolation(ncells).toarray(),
                                  jtransfer.fe_grid_interpolation(ncells).toarray())
    P, R = transfer.fe_transfer_pair(ncells, 2, mask_f, mask_c, device="cpu")
    jP, jR = jtransfer.fe_transfer_pair(ncells, 2, mask_f, mask_c)
    Pd, Rd = transfer.fe_transfer_pair_dense(ncells, 2, mask_f, mask_c, device="cpu")
    jPd, jRd = jtransfer.fe_transfer_pair_dense(ncells, 2, mask_f, mask_c)
    for a, ja in ((P, jP), (R, jR)):
        np.testing.assert_array_equal(a.cols.numpy(), np.asarray(ja.cols))
        np.testing.assert_array_equal(a.values.numpy(), np.asarray(ja.values))
    rng = np.random.default_rng(4)
    xc, xf = rng.normal(size=P.ncols), rng.normal(size=R.ncols)
    for op, jop, dop, jdop, x in ((P, jP, Pd, jPd, xc), (R, jR, Rd, jRd, xf)):
        y = op.matvec(torch.from_numpy(x))
        _assert_close(y, jop.matvec(jnp.asarray(x)))
        _assert_close(dop.matvec(torch.from_numpy(x)), jdop.matvec(jnp.asarray(x)))
        _assert_close(dop.matvec(torch.from_numpy(x)), y)
        carried = convert.tensor_transfer([np.asarray(mm) for mm in jdop.mats], jdop.in_shape,
                                          jdop.out_shape, np.asarray(jdop.mask_in),
                                          np.asarray(jdop.mask_out), device="cpu")
        _assert_close(carried.matvec(torch.from_numpy(x)), y)


# --------------------------------------------------------------- bf16 -----


def _bf16_rounded(jF):
    """A JAX blocked-kernel operator with its values rounded through bf16
    (and back): the operator the port's bf16 blocks apply."""
    return dataclasses.replace(jF, kblocks=tuple(
        tuple(None if b is None else dataclasses.replace(
            b, values=b.values.astype(jnp.bfloat16).astype(b.values.dtype)) for b in row)
        for row in jF.kblocks))


def test_bf16_flat_band_vcycle_equal_jax_on_rounded_operators():
    """One V-cycle of the flat-engine augmented GMG with bf16 level
    operators and patch prolongations (f64 materialized Vanka smoothers):
    the port stores the block values in bf16 (K3 sums them in the vector's
    type); JAX's bf16 band dtype applies on the TPU only, so its cycle runs
    on the same operators rounded through bf16. The two agree to 1e-12 of
    the largest entry. (Against the f64 cycle the bf16 one differs by ~40%:
    rounding the alpha-weighted grad-div entries breaks their cancellation
    on divergence-free fields.)"""
    gmg = velocity_gmg((8, 8), 2, graddiv_alpha=1e3, engine="flat",
                       flat_band_dtype=torch.bfloat16, flat_vanka_dtype=torch.float64,
                       device="cpu")
    jgmg = j_velocity_gmg((8, 8), 2, graddiv_alpha=1e3, engine="flat")
    jgmg = dataclasses.replace(
        jgmg, coarse_ops=tuple(_bf16_rounded(op) for op in jgmg.coarse_ops),
        prolongations=tuple(dataclasses.replace(p, rhs_op=_bf16_rounded(p.rhs_op), state={
            **p.state, "Mv": _bf16_rounded(p.state["Mv"])}) for p in jgmg.prolongations))
    m, jm = _meshes((8, 8))
    K = flat_kernel_operator(graddiv_velocity_block(m, 1.0, 1e3, banded=True, device="cpu"),
                             band_dtype=torch.bfloat16)
    jK = _bf16_rounded(j_flat(j_graddiv_block(jm, 1.0, 1e3, banded=True)))
    assert all(b is None or b.dtype == torch.bfloat16 for row in K.kblocks for b in row)
    assert all(b is None or b.dtype == torch.bfloat16 for p in gmg.prolongations
               for op in (p.rhs_op, p.state["Mv"]) for row in op.kblocks for b in row)
    rng = np.random.default_rng(5)
    r, jr = _rand_like(rng, K.diag())
    z = gmg.apply(gmg.setup(K), r)
    jz = jgmg.apply(jgmg.setup(jK), jr)
    _assert_close(z, jz, BF16_CYCLE_RTOL)


# ---------------------------------------------------- flat FGMRES flagship --


def _flagship(pkg, engine, alpha=1e3):
    """The augmented Stokes flagship at 8^2 cells, 2 levels, Chebyshev(4)
    over the Vanka (the H100 path's configuration, small)."""
    if pkg == "jax":
        prob = j_stokes_problem((8, 8), graddiv_alpha=alpha, engine=engine)
        gmg = j_velocity_gmg((8, 8), 2, graddiv_alpha=alpha, engine=engine, cheby_degree=4)
        Mp = dataclasses.replace(prob.Mp, values=prob.Mp.values * (-1.0 / alpha))
        prec = JBlockTriangular(solvers=(gmg, JCG(Pl=JJacobi(), rtol=1e-8, maxiter=40)),
                                blocks=((None, None), (None, JMatrixBlock(Mp))),
                                coeffs=((1.0, 1.0), (0.0, 1.0)), half="upper")
        solver = JFGMRES(m=20, Pr=prec, rtol=1e-9, maxiter=30)
        x, stats = jax.jit(solver.solve)(solver.setup(prob.A), prob.b)
        return prob, x, stats
    prob = stokes_problem((8, 8), graddiv_alpha=alpha, engine=engine, device="cpu")
    gmg = velocity_gmg((8, 8), 2, graddiv_alpha=alpha, engine=engine, cheby_degree=4,
                       device="cpu")
    Mp = dataclasses.replace(prob.Mp, values=prob.Mp.values * (-1.0 / alpha))
    prec = BlockTriangularSolver(solvers=(gmg, CGSolver(Pl=JacobiSolver(), rtol=1e-8,
                                                        maxiter=40)),
                                 blocks=((None, None), (None, MatrixBlock(Mp))),
                                 coeffs=((1.0, 1.0), (0.0, 1.0)), half="upper")
    solver = FGMRESSolver(m=20, Pr=prec, rtol=1e-9, maxiter=30)
    x, stats = solver.solve(solver.setup(prob.A), prob.b)
    return prob, x, stats


def test_flat_flagship_equal_jax_and_block():
    ell_spmv.counts.reset()
    prob, x, stats = _flagship("torch", "flat")
    assert ell_spmv.counts.kernel == 0 and ell_spmv.counts.plain > 0
    jprob, jx, jstats = _flagship("jax", "flat")
    assert stats.niter == int(jstats.niter) and int(stats.flag) == int(jstats.flag) == 2
    k = stats.niter
    h, jh = stats.residuals.numpy()[: k + 1], np.asarray(jstats.residuals)[: k + 1]
    np.testing.assert_allclose(h, jh, rtol=HIST_RTOL, atol=HIST_FLOOR * jh[0])
    assert h[k] / h[0] == pytest.approx(jh[k] / jh[0], rel=FINAL_RTOL)
    _assert_close(x, jx, 1e-6)
    assert prob.residual_norm(x) < 1e-7
    # flat equals block in the port
    _, xb, sb = _flagship("torch", "block")
    assert sb.niter == stats.niter
    _assert_close(x, xb, 1e-7)
