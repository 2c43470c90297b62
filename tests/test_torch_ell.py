"""The port's ELL matrices and kernel K3 (ELL SpMV), through its plain
PyTorch version, against the JAX package's `ELLMatrix` and its Pallas ELL
kernels run in interpret mode.

The CUDA kernel itself needs the card; `chip_smoke.py` holds it against
this plain version there.

Tolerances: host conversions are bit-equal; f64 products agree to 1e-13
of the largest |y| (the same terms, summed in another order); f32 products
against the Pallas kernels, which regroup the sums by sorted slot, to 1e-6.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from gridapsolvers_tpu.algebra.ell import ell_from_coo as j_ell_from_coo
from gridapsolvers_tpu.algebra.ell import ell_from_scipy as j_ell_from_scipy
from gridapsolvers_tpu.algebra.ell import ell_to_scipy as j_ell_to_scipy
from gridapsolvers_tpu.fem import assembly2 as j_asm2
from gridapsolvers_tpu.fem.assembly import eliminate_dirichlet as j_eliminate
from gridapsolvers_tpu.fem.assembly import laplacian as j_laplacian
from gridapsolvers_tpu.fem.mesh import CartesianMesh as JMesh
from gridapsolvers_tpu.linear.amg import AMGSolver as JAMG
from gridapsolvers_tpu.ops.ell_pallas import pallas_ell, pallas_rect

from gridapsolvers_tpu_torch import convert
from gridapsolvers_tpu_torch.algebra import (
    ELLMatrix,
    ell_from_coo,
    ell_from_scipy,
    ell_to_scipy,
    to_scipy,
)
from gridapsolvers_tpu_torch.ops import ell_spmv

torch.set_num_threads(1)

F64_RTOL = 1e-13
F32_RTOL = 1e-6


def _assert_close(y, y_ref, rtol):
    y, y_ref = np.asarray(y, dtype=np.float64), np.asarray(y_ref, dtype=np.float64)
    scale = np.max(np.abs(y_ref))
    assert scale > 0
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=rtol * scale)


def _eq_ell(A, jA):
    assert A.shape == jA.shape and A.row_width == jA.row_width
    assert A.cols.dtype == torch.int32
    np.testing.assert_array_equal(A.values.numpy(), np.asarray(jA.values))
    np.testing.assert_array_equal(A.cols.numpy(), np.asarray(jA.cols))


def _eq_csr(S, jS):
    assert S.shape == jS.shape and S.dtype == jS.dtype
    np.testing.assert_array_equal(S.indptr, jS.indptr)
    np.testing.assert_array_equal(S.indices, jS.indices)
    np.testing.assert_array_equal(S.data, jS.data)


def _random_coo(n_rows, n_cols, nnz, seed):
    """Random COO triplets with duplicates (summed by the conversion)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows, size=nnz)
    cols = rng.integers(0, n_cols, size=nnz)
    return rows, cols, rng.normal(size=nnz)


def _unit_mesh(ncells, periodic=None):
    return JMesh(tuple(ncells), tuple(x for _ in ncells for x in (0.0, 1.0)), periodic)


# ---------------------------------------------------- host conversions -----


@pytest.mark.parametrize("shape, row_width", [((40, 40), None), ((37, 11), 12), ((9, 50), None)])
def test_ell_from_coo_and_scipy_bit_equal(shape, row_width):
    rows, cols, vals = _random_coo(*shape, nnz=4 * shape[0], seed=sum(shape))
    A = ell_from_coo(*shape, rows, cols, vals, row_width=row_width, device="cpu")
    _eq_ell(A, j_ell_from_coo(*shape, rows, cols, vals, row_width=row_width))
    S = sp.coo_matrix((vals, (rows, cols)), shape=shape).tocsr()
    B = ell_from_scipy(S, row_width=row_width, device="cpu")
    _eq_ell(B, j_ell_from_scipy(S, row_width=row_width))
    _eq_csr(ell_to_scipy(B), j_ell_to_scipy(j_ell_from_scipy(S, row_width=row_width)))
    # padding slots: value 0, column min(row, ncols - 1)
    pad = B.values.numpy() == 0
    expect = np.minimum(np.arange(shape[0]), shape[1] - 1)[:, None]
    assert (B.cols.numpy()[pad] == np.broadcast_to(expect, pad.shape)[pad]).all()


def test_ell_conversion_dtypes_and_width_check():
    S = sp.random(30, 20, density=0.2, random_state=3, format="csr")
    A = ell_from_scipy(S, dtype=torch.float32, device="cpu")
    jA = j_ell_from_scipy(S, dtype=np.float32)
    assert A.dtype == torch.float32
    np.testing.assert_array_equal(A.values.numpy(), np.asarray(jA.values))
    with pytest.raises(ValueError, match="row_width"):
        ell_from_scipy(S, row_width=1, device="cpu")
    rows, cols, vals = _random_coo(10, 10, 60, seed=1)
    with pytest.raises(ValueError, match="row_width"):
        ell_from_coo(10, 10, rows, cols, vals, row_width=2, device="cpu")


@pytest.mark.parametrize("ncells, periodic", [
    ((5, 4, 3), None), ((6, 5, 4), (True, False, True)), ((7, 6), (False, True)),
])
def test_stencil_to_ell_bit_equal(ncells, periodic):
    mesh = _unit_mesh(ncells, periodic)
    jA = j_laplacian(mesh)
    if periodic is None:
        jA = j_eliminate(jA, mesh.boundary_vertex_mask())
    A = convert.stencil_matrix(np.asarray(jA.bands), jA.offsets, jA.grid_shape, jA.periodic,
                               device="cpu")
    E = A.to_ell()
    assert E.row_width == len(A.offsets) and E.device == A.device
    _eq_ell(E, jA.to_ell())
    # to_scipy drops explicit zeros, as the JAX one does
    from gridapsolvers_tpu.algebra.convert import to_scipy as j_to_scipy

    _eq_csr(to_scipy(A), j_to_scipy(jA))
    _eq_csr(to_scipy(E), j_to_scipy(jA.to_ell()))
    x = np.random.default_rng(2).normal(size=A.n)
    _assert_close(E.matvec(torch.from_numpy(x)).numpy(),
                  A.matvec(torch.from_numpy(x)).numpy(), F64_RTOL)


def test_to_scipy_refuses_other_operators():
    A = convert.const_stencil_matrix(np.ones(27), np.ones((3, 3, 3)),
                                     [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                                      for k in (-1, 0, 1)], (3, 3, 3), device="cpu")
    with pytest.raises(TypeError, match="ConstStencilMatrix"):
        to_scipy(A)
    with pytest.raises(TypeError, match="later|slice"):
        to_scipy(type("DistELLMatrix", (), {})())


# ------------------------------------------------- ELLMatrix operations -----


@pytest.mark.parametrize("shape", [(60, 60), (45, 13), (13, 45)])
def test_ell_operations_match_jax_f64(shape):
    rows, cols, vals = _random_coo(*shape, nnz=5 * max(shape), seed=7)
    if shape[0] == shape[1]:  # a full diagonal for diag()
        rows = np.concatenate([rows, np.arange(shape[0])])
        cols = np.concatenate([cols, np.arange(shape[0])])
        vals = np.concatenate([vals, np.full(shape[0], 4.0)])
    jA = j_ell_from_coo(*shape, rows, cols, vals)
    A = convert.ell_matrix(np.asarray(jA.values), np.asarray(jA.cols), jA.ncols, device="cpu")
    assert A.shape == jA.shape and A.nnz == jA.nnz and A.nrows == shape[0]
    rng = np.random.default_rng(8)
    x, y = rng.normal(size=shape[1]), rng.normal(size=shape[0])
    _assert_close(A.matvec(torch.from_numpy(x)).numpy(), np.asarray(jA.matvec(jnp.asarray(x))),
                  F64_RTOL)
    _assert_close(A.matvec_t(torch.from_numpy(y)).numpy(),
                  np.asarray(jA.matvec_t(jnp.asarray(y))), F64_RTOL)
    _assert_close(A.abs_row_sum().numpy(), np.asarray(jA.abs_row_sum()), F64_RTOL)
    np.testing.assert_array_equal(A.todense().numpy(), np.asarray(jA.todense()))
    d = rng.normal(size=shape[0])
    np.testing.assert_array_equal(A.scale_rows(torch.from_numpy(d)).values.numpy(),
                                  np.asarray(jA.scale_rows(jnp.asarray(d)).values))
    assert A.astype(torch.float32).dtype == torch.float32
    if shape[0] == shape[1]:
        _assert_close(A.diag().numpy(), np.asarray(jA.diag()), F64_RTOL)


# ------------------------------------------- K3 against the Pallas kernel ---


@pytest.fixture(scope="module")
def j_amg_2d():
    """The JAX AMG hierarchy of test_amg.py's engine test: 2D Q1 stiffness
    on 24^2 cells, f32 values, coarse_size 60."""
    mesh = JMesh((24, 24), (0, 1, 0, 1))
    mask = j_asm2.boundary_node_mask(mesh, 1)
    K = j_asm2.dirichlet_square(j_asm2.assemble_bilinear(mesh, 1, "stiffness"), mask)
    return JAMG(coarse_size=60, engine="ell").setup(j_ell_from_scipy(K, dtype=np.float32))


@pytest.mark.parametrize("which", ["level 1", "P0"])
def test_ell_spmv_plain_matches_pallas_interpret(j_amg_2d, which):
    """A square AMG level and a rectangular AMG transfer, f32 values, as
    the JAX AMG hands them to `pallas_ell` and `pallas_rect`."""
    if which == "level 1":
        jA = j_amg_2d["mats"][1]
        op = pallas_ell(jA, max_total_span=20 * jA.row_width, interpret=True)
    else:
        jA = j_amg_2d["P"][0]
        assert jA.shape[0] > jA.shape[1]
        op = pallas_rect(jA, max_total_span=min(64 * jA.row_width, 2048), interpret=True)
    assert jA.values.dtype == jnp.float32
    x = np.random.default_rng(9).normal(size=jA.shape[1]).astype(np.float32)
    y_pallas = np.asarray(op.matvec(jnp.asarray(x)))
    A = convert.ell_matrix(np.asarray(jA.values), np.asarray(jA.cols), jA.ncols, device="cpu")
    before = (ell_spmv.counts.kernel, ell_spmv.counts.plain)
    y = A.matvec(torch.from_numpy(x))
    # a CPU tensor runs the plain version, never the kernel
    assert (ell_spmv.counts.kernel, ell_spmv.counts.plain) == (before[0], before[1] + 1)
    assert y.dtype == torch.float32 and y.shape == (jA.shape[0],)
    _assert_close(y.numpy(), y_pallas, F32_RTOL)
    _assert_close(y.numpy(), np.asarray(jA.matvec(jnp.asarray(x))), F32_RTOL)


def test_ell_spmv_plain_bf16_values():
    """bf16 values with an f32 vector are widened and summed in f32."""
    rows, cols, vals = _random_coo(50, 30, 300, seed=10)
    A = ell_from_coo(50, 30, rows, cols, vals.astype(np.float32), device="cpu")
    x = torch.from_numpy(np.random.default_rng(11).normal(size=30).astype(np.float32))
    A16 = A.astype(torch.bfloat16)
    y = A16.matvec(x)
    assert y.dtype == torch.float32
    ref = (A16.values.double().numpy() * x.double().numpy()[A.cols.numpy()]).sum(1)
    _assert_close(y.numpy(), ref, F32_RTOL)


# ------------------------------------------------------- the wrappers -----


def test_ell_wrapper_refuses_without_building():
    """Importing the module builds nothing; the CUDA wrapper checks its
    inputs before any build or launch and raises on what it does not take;
    the dispatcher raises on a device it has no engine for."""
    from gridapsolvers_tpu_torch.ops import build

    assert build.library_path("ell_spmv").name.startswith("libell_spmv-")
    rows, cols, vals = _random_coo(20, 20, 80, seed=12)
    A = ell_from_coo(20, 20, rows, cols, vals, device="cpu")
    x = torch.zeros(20, dtype=torch.float64)
    before = (ell_spmv.counts.kernel, ell_spmv.counts.plain)
    with pytest.raises(ValueError, match="CUDA"):
        ell_spmv.ell_spmv_cuda(A.values, A.cols, x)
    with pytest.raises(TypeError, match="dtypes"):
        ell_spmv.ell_spmv_cuda(A.values, A.cols, x.float())
    with pytest.raises(TypeError, match="int32"):
        ell_spmv.ell_spmv_cuda(A.values, A.cols.long(), x)
    with pytest.raises(ValueError, match="contiguous"):
        ell_spmv.ell_spmv_cuda(A.values.t().contiguous().t(), A.cols, x)
    with pytest.raises(ValueError, match="columns"):
        ell_spmv.ell_spmv_cuda(A.values, A.cols, torch.zeros(21, dtype=torch.float64), 20)
    with pytest.raises(ValueError, match="columns"):
        A.matvec(torch.zeros(19, dtype=torch.float64))
    with pytest.raises(ValueError, match="engine"):
        A.matvec(torch.empty(20, dtype=torch.float64, device="meta"))
    assert (ell_spmv.counts.kernel, ell_spmv.counts.plain) == before
    with pytest.raises(ValueError, match="group"):
        ell_spmv.ell_spmv_cuda(A.values, A.cols, x, 20, group=3)
    # about seven slots a lane for rows read in full: the widths of the AMG
    # path's operators
    assert [ell_spmv.group_size(K) for K in (0, 1, 6, 8, 13, 21, 125, 147, 263)] == [
        1, 1, 1, 1, 2, 4, 16, 16, 32]


# ------------------------------------------------------ row lengths -----


def _coo_with_short_and_full_rows(n_rows, n_cols, seed):
    """Random COO whose rows include empty ones and ones at the widest
    row's length, duplicates included."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = _random_coo(n_rows, n_cols, 3 * n_rows, seed)
    keep = rows % 5 != 0  # every fifth row empty
    full = np.full(n_cols, 1)  # row 1 couples to every column
    return (np.concatenate([rows[keep], full]), np.concatenate([cols[keep], np.arange(n_cols)]),
            np.concatenate([vals[keep], rng.normal(size=n_cols)]))


@pytest.mark.parametrize("shape", [(40, 40), (37, 11), (9, 50)])
def test_row_len_is_the_csr_row_count(shape):
    rows, cols, vals = _coo_with_short_and_full_rows(*shape, seed=20)
    S = sp.coo_matrix((vals, (rows, cols)), shape=shape).tocsr()
    S.sum_duplicates()
    counts = np.diff(S.indptr)
    assert counts.min() == 0 and counts.max() == shape[1]
    for A, jA in ((ell_from_scipy(S, device="cpu"), j_ell_from_scipy(S)),
                  (ell_from_coo(*shape, rows, cols, vals, device="cpu"),
                   j_ell_from_coo(*shape, rows, cols, vals)),
                  (ell_from_scipy(S, row_width=shape[1] + 3, device="cpu"),
                   j_ell_from_scipy(S, row_width=shape[1] + 3))):
        _eq_ell(A, jA)  # values and cols stay bit-equal to the JAX package's
        assert A.row_len.dtype == torch.int32 and A.row_len.device == A.device
        np.testing.assert_array_equal(A.row_len.numpy(), counts)
        assert A.group == ell_spmv.group_size(A.row_width, counts.mean())
        # every slot past a row's length holds 0, as `ELLMatrix` requires
        past = np.arange(A.row_width)[None, :] >= counts[:, None]
        assert (A.values.numpy()[past] == 0).all()


@pytest.mark.parametrize("ncells, periodic", [((5, 4, 3), None), ((6, 5), (True, False))])
def test_stencil_to_ell_row_len(ncells, periodic):
    mesh = _unit_mesh(ncells, periodic)
    jA = j_laplacian(mesh)
    if periodic is None:
        jA = j_eliminate(jA, mesh.boundary_vertex_mask())
    A = convert.stencil_matrix(np.asarray(jA.bands), jA.offsets, jA.grid_shape, jA.periodic,
                               device="cpu")
    E = A.to_ell()
    np.testing.assert_array_equal(E.row_len.numpy(), np.diff(to_scipy(A).indptr))
    assert E.row_len.min() < E.row_width  # Dirichlet rows and corners are short


def test_astype_and_scale_rows_carry_row_len():
    rows, cols, vals = _coo_with_short_and_full_rows(30, 12, seed=21)
    A = ell_from_coo(30, 12, rows, cols, vals, device="cpu")
    d = torch.from_numpy(np.random.default_rng(22).normal(size=30))
    for B in (A.astype(torch.float32), A.astype(torch.bfloat16), A.scale_rows(d)):
        assert B.row_len is A.row_len and B.cols is A.cols and B.group == A.group
    np.testing.assert_array_equal(A.scale_rows(d).values.numpy(),
                                  A.values.numpy() * d.numpy()[:, None])


@pytest.mark.parametrize("shape", [(60, 60), (45, 13), (13, 45)])
def test_ell_spmv_plain_row_len_matches_jax_f64(shape):
    """The plain version with and without row lengths against the JAX
    ELLMatrix.matvec, with empty rows and full rows."""
    rows, cols, vals = _coo_with_short_and_full_rows(*shape, seed=23)
    jA = j_ell_from_coo(*shape, rows, cols, vals)
    A = ell_from_coo(*shape, rows, cols, vals, device="cpu")
    assert (A.row_len.numpy() == 0).any() and (A.row_len.numpy() == A.row_width).any()
    x = np.random.default_rng(24).normal(size=shape[1])
    y_ref = np.asarray(jA.matvec(jnp.asarray(x)))
    xt = torch.from_numpy(x)
    for row_len in (A.row_len, None):
        y = ell_spmv.ell_spmv_plain(A.values, A.cols, xt, row_len)
        _assert_close(y.numpy(), y_ref, F64_RTOL)
    _assert_close(A.matvec(xt).numpy(), y_ref, F64_RTOL)
    assert (A.matvec(xt).numpy()[A.row_len.numpy() == 0] == 0).all()


def test_ell_spmv_plain_ignores_slots_past_row_len():
    """At the ops level, slots at or past a row's length add nothing,
    whatever they hold (the kernel never reads them). An `ELLMatrix` keeps
    them 0; these arrays do not."""
    rng = np.random.default_rng(25)
    vals = torch.from_numpy(rng.normal(size=(20, 6)))
    cols = torch.from_numpy(rng.integers(0, 9, size=(20, 6), dtype=np.int32))
    row_len = torch.from_numpy(rng.integers(0, 7, size=20).astype(np.int32))
    x = torch.from_numpy(rng.normal(size=9))
    keep = np.arange(6)[None, :] < row_len.numpy()[:, None]
    ref = (np.where(keep, vals.numpy(), 0.0) * x.numpy()[cols.numpy()]).sum(1)
    y = ell_spmv.ell_spmv_apply(vals, cols, 9, x, row_len)
    _assert_close(y.numpy(), ref, F64_RTOL)


def test_group_size_follows_mean_row_length():
    """Lanes a row come from the mean real row length, not the padded K,
    once the host conversions know the row lengths."""
    assert [ell_spmv.group_size(147, m) for m in (0.0, 2.0, 5.05, 8.89, 20.0, 46.3, 73.3)] == [
        1, 1, 2, 4, 8, 32, 32]
    K, n = 40, 64
    for mean in (4, 12, 30):
        rng = np.random.default_rng(mean)
        lens = np.full(n, mean)
        lens[::2] += rng.integers(-3, 4)
        lens[1::2] = 2 * mean - lens[::2]  # a mean of exactly `mean`
        rows = np.repeat(np.arange(n), lens)
        cols = np.concatenate([rng.permutation(K)[:m] for m in lens])
        A = ell_from_coo(n, K, rows, cols, rng.normal(size=len(rows)), device="cpu")
        assert A.group == ell_spmv.group_size(A.row_width, mean)
        assert A.group != ell_spmv.group_size(A.row_width)  # K's rule differs
    assert ELLMatrix(A.values, A.cols, K).group is None  # the kernel picks from K


def test_ell_wrapper_refuses_row_len_without_building(monkeypatch):
    """With row lengths too, the CUDA wrapper checks its inputs before any
    build or launch."""
    from gridapsolvers_tpu_torch.ops import build

    def no_build(*a, **k):
        raise AssertionError("a kernel was built or loaded")

    monkeypatch.setattr(build, "function", no_build)
    rows, cols, vals = _coo_with_short_and_full_rows(20, 20, seed=26)
    A = ell_from_coo(20, 20, rows, cols, vals, device="cpu")
    x = torch.zeros(20, dtype=torch.float64)
    before = (ell_spmv.counts.kernel, ell_spmv.counts.plain)
    with pytest.raises(ValueError, match="CUDA"):
        ell_spmv.ell_spmv_cuda(A.values, A.cols, x, 20, A.group, A.row_len)
    with pytest.raises(ValueError, match="row_len"):
        ell_spmv.ell_spmv_cuda(A.values, A.cols, x, 20, None, A.row_len.long())
    with pytest.raises(ValueError, match="row_len"):
        ell_spmv.ell_spmv_cuda(A.values, A.cols, x, 20, None, A.row_len[:-1])
    assert (ell_spmv.counts.kernel, ell_spmv.counts.plain) == before
