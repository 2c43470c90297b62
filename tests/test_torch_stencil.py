"""The port's stencil kernels K1 (constant stencil) and K2 (banded stencil),
through their plain PyTorch versions, against the JAX package's operators
and its Pallas kernels run in interpret mode; the choice between each
kernel's fast and general CUDA kernels, and the fast kernels' arithmetic in
plain PyTorch.

The CUDA kernels themselves need the card; `chip_smoke.py` holds them
against these plain versions there.

Tolerances: f64 results agree to rtol 1e-12 relative to the largest
|y| (the two packages sum the same terms in the same order, but XLA may
fuse multiply-adds); f32 results to 1e-6 of the largest |y|.
"""
import itertools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from gridapsolvers_tpu.algebra.stencil import ConstStencilMatrix as JConst
from gridapsolvers_tpu.algebra.stencil import stencil_from_scipy as j_from_scipy
from gridapsolvers_tpu.fem.assembly import eliminate_dirichlet as j_eliminate
from gridapsolvers_tpu.fem.assembly import laplacian as j_laplacian
from gridapsolvers_tpu.fem.assembly import laplacian_const as j_laplacian_const
from gridapsolvers_tpu.fem.mesh import CartesianMesh as JMesh
from gridapsolvers_tpu.ops import pallas_banded_stencil, pallas_const_stencil

from gridapsolvers_tpu_torch import convert
from gridapsolvers_tpu_torch.algebra import StencilMatrix as port_stencil
from gridapsolvers_tpu_torch.algebra import stencil_from_scipy
from gridapsolvers_tpu_torch.algebra.stencil import shift as port_shift
from gridapsolvers_tpu_torch.fem import CartesianMesh
from gridapsolvers_tpu_torch.fem.assembly import eliminate_dirichlet as port_eliminate
from gridapsolvers_tpu_torch.fem.assembly import laplacian as port_laplacian
from gridapsolvers_tpu_torch.ops import banded_stencil, const_stencil

torch.set_num_threads(1)

F64_RTOL = 1e-12
F32_RTOL = 1e-6


def _unit_mesh(ncells, periodic=None):
    return JMesh(tuple(ncells), tuple(x for _ in ncells for x in (0.0, 1.0)), periodic)


def port_mesh(ncells, periodic=None):
    return CartesianMesh(tuple(ncells), tuple(x for _ in ncells for x in (0.0, 1.0)), periodic)


def _assert_close(y, y_ref, rtol):
    y, y_ref = np.asarray(y, dtype=np.float64), np.asarray(y_ref, dtype=np.float64)
    scale = np.max(np.abs(y_ref))
    assert scale > 0
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=rtol * scale)


def _port_const(Ac):
    return convert.const_stencil_matrix(
        np.asarray(Ac.weights), np.asarray(Ac.free), Ac.offsets, Ac.grid_shape,
        device="cpu",
    )


def _port_banded(A, dtype=None):
    return convert.stencil_matrix(
        np.asarray(A.bands), A.offsets, A.grid_shape, A.periodic, device="cpu", dtype=dtype
    )


# ---------------------------------------------------------------- K1 -----


@pytest.mark.parametrize("ncells", [(8, 8, 8), (16, 8, 4), (12, 12)])
def test_const_stencil_plain_matches_pallas_and_jax(ncells):
    Ac = j_laplacian_const(_unit_mesh(ncells))
    x = np.random.default_rng(0).normal(size=Ac.n)
    y_jax = np.asarray(Ac.matvec(jnp.asarray(x)))
    y_pallas = np.asarray(
        pallas_const_stencil(Ac, tile=3, interpret=True).matvec(jnp.asarray(x))
    )
    before = (const_stencil.counts.kernel, const_stencil.counts.plain)
    y = _port_const(Ac).matvec(torch.from_numpy(x))
    assert y.dtype == torch.float64 and y.shape == (Ac.n,)
    # a CPU tensor runs the plain version, never the kernel
    assert (const_stencil.counts.kernel, const_stencil.counts.plain) == (
        before[0], before[1] + 1
    )
    _assert_close(y.numpy(), y_pallas, F64_RTOL)
    _assert_close(y.numpy(), y_jax, F64_RTOL)


@pytest.mark.parametrize("ncells", [(9, 7, 6), (10, 13)])
def test_const_stencil_plain_random_interior_mask(ncells):
    """Any mask, not only a boundary one (the Pallas twin is exact only for
    full-boundary Dirichlet, so it is left out here)."""
    rng = np.random.default_rng(1)
    A0 = j_laplacian_const(_unit_mesh(ncells))
    free = (rng.random(A0.grid_shape) < 0.7).astype(np.float64)
    Aj = JConst(jnp.asarray(A0.weights), jnp.asarray(free), A0.offsets, A0.grid_shape)
    x = rng.normal(size=Aj.n)
    y = _port_const(Aj).matvec(torch.from_numpy(x))
    _assert_close(y.numpy(), np.asarray(Aj.matvec(jnp.asarray(x))), F64_RTOL)


def test_const_stencil_diag_abs_row_sum():
    Ac = j_laplacian_const(_unit_mesh((6, 5, 4)))
    P = _port_const(Ac)
    np.testing.assert_allclose(P.diag().numpy(), np.asarray(Ac.diag()), rtol=1e-15)
    np.testing.assert_allclose(
        P.abs_row_sum().numpy(), np.asarray(Ac.abs_row_sum()), rtol=1e-15
    )


def _random_dirichlet_mask(rng, grid_shape):
    """A {0,1} mask with the whole boundary constrained and random
    interior zeros: the Pallas twin is exact under it (its circular rolls
    land only on constrained rows)."""
    free = (rng.random(grid_shape) < 0.7).astype(np.float64)
    inner = tuple(slice(1, -1) for _ in grid_shape)
    mask = np.zeros(grid_shape)
    mask[inner] = free[inner]
    return mask


@pytest.mark.parametrize("ncells", [(7, 6, 5), (10, 9)])
def test_const_stencil_plain_random_weights_and_mask_f64(ncells):
    """Random asymmetric weights under a mask with interior zeros (a sign
    or axis error that the Laplacian's symmetric weights hide shows here),
    against the JAX operator and the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(7)
    A0 = j_laplacian_const(_unit_mesh(ncells))
    w = rng.normal(size=len(A0.offsets))
    free = _random_dirichlet_mask(rng, A0.grid_shape)
    Aj = JConst(jnp.asarray(w), jnp.asarray(free), A0.offsets, A0.grid_shape)
    x = rng.normal(size=Aj.n)
    y_jax = np.asarray(Aj.matvec(jnp.asarray(x)))
    y_pallas = np.asarray(pallas_const_stencil(Aj, tile=3, interpret=True).matvec(jnp.asarray(x)))
    y = _port_const(Aj).matvec(torch.from_numpy(x)).numpy()
    _assert_close(y, y_jax, F64_RTOL)
    _assert_close(y, y_pallas, F64_RTOL)


# ------------------------------------------------- K1's kernel choice -----

_BOX3 = tuple(itertools.product((-1, 0, 1), repeat=3))


def _march_apply(weights, free, x, grid_shape, planes):
    """The marching kernel's arithmetic in plain PyTorch: output planes in
    runs of `planes` along i; each plane q of a run and its halo planes
    adds its in-plane sums S_a(q) = sum_{b,c} w[a,b,c] (free x)(q, j+b, k+c)
    to output plane q - a where that plane is the run's; free x is zero
    outside the grid."""
    n0, n1, n2 = grid_shape
    w = weights.reshape(3, 3, 3)
    xg = x.reshape(grid_shape)
    fx = torch.nn.functional.pad(free * xg, (1, 1, 1, 1, 1, 1))
    y = torch.full(grid_shape, float("nan"), dtype=x.dtype)
    for i0 in range(0, n0, planes):
        i1 = min(i0 + planes, n0)
        acc = {}
        for q in range(i0 - 1, i1 + 1):
            plane = fx[q + 1]
            for a in (-1, 0, 1):
                if i0 <= q - a < i1:
                    s = sum(w[a + 1, b + 1, c + 1] * plane[1 + b:1 + b + n1, 1 + c:1 + c + n2]
                            for b in (-1, 0, 1) for c in (-1, 0, 1))
                    acc[q - a] = acc.get(q - a, 0) + s
        for i in range(i0, i1):
            y[i] = free[i] * acc[i] + (1 - free[i]) * xg[i]
    return y.reshape(-1)


@pytest.mark.parametrize("grid_shape, planes", [
    ((2, 2, 2), 1), ((9, 7, 6), 4), ((9, 7, 6), 16), ((5, 3, 11), 2), ((13, 4, 5), None)])
def test_march_arithmetic_matches_plain(grid_shape, planes):
    """The marching kernel's plane-by-plane sums, with runs that split the
    grid unevenly, a run longer than the grid and the selector's own run
    length, reproduce the plain version for random asymmetric weights
    under a random mask."""
    rng = np.random.default_rng(40)
    w = torch.from_numpy(rng.normal(size=27))
    free = torch.from_numpy((rng.random(grid_shape) < 0.7).astype(np.float64))
    x = torch.from_numpy(rng.normal(size=int(np.prod(grid_shape))))
    tiles = const_stencil.march_tiles(grid_shape, torch.float64)
    assert tiles is not None
    ref = const_stencil.const_stencil_plain(w, free, _BOX3, grid_shape, x)
    y = _march_apply(w, free, x, grid_shape, planes or tiles[2])
    _assert_close(y.numpy(), ref.numpy(), F64_RTOL)



@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_march_tiles_for_the_poisson_levels(dtype):
    """Every grid of path A (129^3 to 17^3) takes the marching kernel, with
    k tiles of at most 64 columns split evenly and at least two blocks an
    SM where the grid has them."""
    rows = {torch.float32: 4, torch.float64: 2}[dtype]
    for m in (129, 65, 33, 17):
        tk, groups, planes = const_stencil.march_tiles((m, m, m), dtype)
        assert tk <= 64 and -(-m // tk) == -(-m // 64) and tk * -(-m // tk) - m < -(-m // tk)
        assert 1 <= groups <= 3 and 1 <= planes <= m
        blocks = -(-m // tk) * -(-m // (groups * rows)) * -(-m // planes)
        assert blocks >= 264 or planes == 1
    assert const_stencil.march_tiles((129, 129, 129), torch.float32) == (43, 3, 16)


@pytest.mark.parametrize("grid_shape, dtype, march", [
    ((129, 129), torch.float32, False),
    ((4, 4, 4, 4), torch.float64, False),
    ((4, 4, 4), torch.float16, False),
    ((2, 12 * 65535, 2), torch.float32, True),
    ((2, 12 * 65535 + 1, 2), torch.float32, False),
    ((2, 6 * 65535 + 1, 2), torch.float64, False),
    ((70000, 2, 2), torch.float32, True),
    ((2, 2 ** 16, 2 ** 15), torch.float32, False),
])
def test_march_tiles_declines_what_it_cannot_launch(grid_shape, dtype, march):
    """2D grids and grids past the marching kernel's launch grid (j tiles
    on gridDim.y at most 65535, in-plane offsets in 32 bits) go to the
    general kernel, decided from the shape and dtype alone."""
    assert (const_stencil.march_tiles(grid_shape, dtype) is not None) == march


def test_const_wrapper_refuses_before_any_build(monkeypatch):
    """Marching or general, the K1 wrapper refuses a CPU tensor, a wrong
    dtype, unsorted offsets and a 4D grid before any build or launch, and
    counts nothing; `counts.march` resets with the rest."""
    from gridapsolvers_tpu_torch.ops import build

    def no_build(*a, **k):
        raise AssertionError("a kernel was built or loaded")

    monkeypatch.setattr(build, "function", no_build)
    Ac = _port_const(j_laplacian_const(_unit_mesh((4, 4, 4))))
    args = (Ac.weights, Ac.free, Ac.offsets, Ac.grid_shape)
    x = torch.zeros(Ac.n, dtype=torch.float64)
    before = (const_stencil.counts.kernel, const_stencil.counts.march)
    for kw in ({}, {"general": True}, {"tiles": (5, 1, 2)}):
        with pytest.raises(ValueError, match="CUDA"):
            const_stencil.const_stencil_cuda(*args, x, **kw)
    with pytest.raises(TypeError, match="dtypes"):  # f16: no K1 entry point (bf16 has one)
        const_stencil.const_stencil_cuda(*(a.to(torch.float16) if torch.is_tensor(a) else a
                                           for a in args), x.to(torch.float16))
    with pytest.raises(ValueError, match="sorted"):
        const_stencil.const_stencil_cuda(Ac.weights, Ac.free, tuple(reversed(Ac.offsets)),
                                         Ac.grid_shape, x)
    with pytest.raises(ValueError, match="4D"):
        const_stencil.const_stencil_cuda(Ac.weights, Ac.free, Ac.offsets, (4, 4, 2, 2), x)
    assert (const_stencil.counts.kernel, const_stencil.counts.march) == before
    counts = const_stencil.StencilLaunchCounts(kernel=3, plain=2, march=1)
    counts.reset()
    assert (counts.kernel, counts.plain, counts.march) == (0, 0, 0)


def test_host_weights_read_once_per_tensor():
    """The marching kernel's by-value weights are read from the tensor once
    (a read of a CUDA tensor waits for the card), and again after an
    in-place change."""
    w = torch.from_numpy(np.random.default_rng(41).normal(size=27))
    first = const_stencil._host_weights(w)
    assert list(first) == w.tolist()
    assert const_stencil._host_weights(w) is first
    w.mul_(2.0)
    second = const_stencil._host_weights(w)
    assert second is not first and list(second) == w.tolist()
    w32 = w.float()
    assert list(const_stencil._host_weights(w32)) == w32.tolist()


# ---------------------------------------------------------------- K2 -----


def _dirichlet_laplacian(ncells, dtype=np.float64):
    mesh = _unit_mesh(ncells)
    return j_eliminate(j_laplacian(mesh, dtype), mesh.boundary_vertex_mask())


@pytest.mark.parametrize("ncells", [(7, 15, 15), (7, 12, 10), (15, 15)])
def test_banded_stencil_plain_matches_pallas_and_jax_f64(ncells):
    A = _dirichlet_laplacian(ncells)
    x = np.random.default_rng(0).normal(size=A.n)
    y_jax = np.asarray(A.matvec(jnp.asarray(x)))
    y_pallas = np.asarray(
        pallas_banded_stencil(A, tile=8, interpret=True).matvec(jnp.asarray(x))
    )
    before = (banded_stencil.counts.kernel, banded_stencil.counts.plain)
    y = _port_banded(A).matvec(torch.from_numpy(x))
    assert (banded_stencil.counts.kernel, banded_stencil.counts.plain) == (
        before[0], before[1] + 1
    )
    _assert_close(y.numpy(), y_pallas, F64_RTOL)
    _assert_close(y.numpy(), y_jax, F64_RTOL)


@pytest.mark.parametrize("ncells", [(7, 15, 15), (15, 15)])
def test_banded_stencil_plain_f32(ncells):
    A = _dirichlet_laplacian(ncells, np.float32)
    A = A.astype(jnp.float32)
    x = np.random.default_rng(2).normal(size=A.n).astype(np.float32)
    y_jax = np.asarray(A.matvec(jnp.asarray(x)))
    assert y_jax.dtype == np.float32
    y = _port_banded(A).matvec(torch.from_numpy(x))
    assert y.dtype == torch.float32
    _assert_close(y.numpy(), y_jax, F32_RTOL)


@pytest.mark.parametrize("ncells", [(7, 15, 15), (15, 15)])
def test_banded_stencil_plain_bf16_bands(ncells):
    """bf16 bands with an f32 vector, summed in f32, against the JAX
    bf16-band operator and the bf16 Pallas kernel."""
    A = _dirichlet_laplacian(ncells, np.float32).astype(jnp.float32)
    A16 = A.astype(jnp.bfloat16)
    x = np.random.default_rng(3).normal(size=A.n).astype(np.float32)
    y_jax = np.asarray(A16.matvec(jnp.asarray(x)))
    assert y_jax.dtype == np.float32
    y_pallas = np.asarray(
        pallas_banded_stencil(
            A, tile=8, band_dtype=jnp.bfloat16, interpret=True
        ).matvec(jnp.asarray(x))
    )
    # the JAX bf16 bands, widened exactly to f32, then narrowed exactly back
    P = convert.stencil_matrix(
        np.asarray(A16.bands).astype(np.float32), A.offsets, A.grid_shape,
        device="cpu", dtype=torch.bfloat16,
    )
    assert P.bands.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        P.bands.float().numpy(), np.asarray(A16.bands).astype(np.float32)
    )
    y = P.matvec(torch.from_numpy(x))
    assert y.dtype == torch.float32
    _assert_close(y.numpy(), y_jax, F32_RTOL)
    _assert_close(y.numpy(), y_pallas, F32_RTOL)


@pytest.mark.parametrize("periodic", [(True, False, True), (False, True)])
def test_banded_stencil_plain_periodic(periodic):
    ncells = (6, 5, 4)[: len(periodic)]
    A = j_laplacian(_unit_mesh(ncells, periodic))
    assert A.periodic == periodic
    x = np.random.default_rng(4).normal(size=A.n)
    y = _port_banded(A).matvec(torch.from_numpy(x))
    _assert_close(y.numpy(), np.asarray(A.matvec(jnp.asarray(x))), F64_RTOL)


def _q2_like_scipy(gs, seed):
    """Random operator with a 5^d offset envelope: kron of pentadiagonals."""
    rng = np.random.default_rng(seed)
    S = None
    for m in gs:
        T = sp.diags(
            [rng.normal(size=m - abs(k)) for k in range(-2, 3)], range(-2, 3),
            format="csr",
        )
        S = T if S is None else sp.kron(S, T, format="csr")
    S.eliminate_zeros()  # kron keeps explicit zeros outside the envelope
    return S


@pytest.mark.parametrize("gs", [(6, 7, 5), (9, 8)])
def test_banded_stencil_plain_5d_offsets_from_scipy(gs):
    S = _q2_like_scipy(gs, seed=5)
    Aj = j_from_scipy(S, gs)
    assert len(Aj.offsets) == 5 ** len(gs)
    P_own = stencil_from_scipy(S, gs, device="cpu")
    assert P_own.offsets == Aj.offsets
    np.testing.assert_array_equal(P_own.bands.numpy(), np.asarray(Aj.bands))
    x = np.random.default_rng(6).normal(size=Aj.n)
    y = P_own.matvec(torch.from_numpy(x)).numpy()
    _assert_close(y, np.asarray(Aj.matvec(jnp.asarray(x))), F64_RTOL)
    _assert_close(y, S @ x, F64_RTOL)
    _assert_close(_port_banded(Aj).matvec(torch.from_numpy(x)).numpy(), S @ x, F64_RTOL)


def test_banded_stencil_diag_abs_row_sum():
    A = _dirichlet_laplacian((6, 5, 4))
    P = _port_banded(A)
    np.testing.assert_array_equal(P.diag().numpy(), np.asarray(A.diag()))
    np.testing.assert_allclose(
        P.abs_row_sum().numpy(), np.asarray(A.abs_row_sum()), rtol=1e-15
    )


# ------------------------------------------------------- the wrappers -----


def test_wrappers_import_and_refuse_without_building():
    """Importing the kernel modules builds nothing; the CUDA wrappers check
    their inputs before any build or launch and raise on what they do not
    take."""
    from gridapsolvers_tpu_torch.ops import build

    assert build.library_path("const_stencil").parent == build.BUILD_DIR
    assert build.library_path("banded_stencil").name.startswith("libbanded_stencil-")
    Ac = _port_const(j_laplacian_const(_unit_mesh((4, 4, 4))))
    x = torch.zeros(Ac.n, dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        const_stencil.const_stencil_cuda(Ac.weights, Ac.free, Ac.offsets, Ac.grid_shape, x)
    bad_offsets = tuple(reversed(Ac.offsets))
    with pytest.raises(ValueError, match="sorted"):
        const_stencil.const_stencil_cuda(Ac.weights, Ac.free, bad_offsets, Ac.grid_shape, x)
    A = _port_banded(_dirichlet_laplacian((4, 4, 4)))
    with pytest.raises(ValueError, match="CUDA"):
        banded_stencil.banded_stencil_cuda(A.bands, A.offsets, A.grid_shape, (False,) * 3, x)


def test_vector_on_another_device_raises():
    A = _port_banded(_dirichlet_laplacian((4, 4, 4)))
    Ac = _port_const(j_laplacian_const(_unit_mesh((4, 4, 4))))
    x = torch.empty(A.n, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError):
        A.matvec(x)
    with pytest.raises(ValueError):
        Ac.matvec(x)


# ------------------------------------------------- K2's kernel choice -----


def _box_apply(A, perm, x):
    """The box kernel's arithmetic in plain PyTorch: position b of
    {-1, 0, 1}^3 (lexicographic) takes band perm[b]."""
    xg = x.reshape(A.grid_shape)
    y = torch.zeros_like(xg)
    for b, off in enumerate(banded_stencil._BOX):
        y = y + A.bands[perm[b]].to(x.dtype) * port_shift(xg, off)
    return y.reshape(-1)


@pytest.mark.parametrize("ncells", [(1, 1, 1), (4, 4, 4), (7, 5, 3), (8, 16, 2)])
def test_box_kernel_chosen_for_dirichlet_laplacian(ncells):
    """`laplacian` + `eliminate_dirichlet` in 3D, the operator of every K2
    launch on the Poisson paths, takes the box kernel; its band table, in
    any offset order, reproduces the plain product."""
    mesh = port_mesh(ncells)
    A = port_eliminate(port_laplacian(mesh, torch.float64, "cpu"), mesh.boundary_vertex_mask())
    perm = banded_stencil.box_permutation(A.offsets, A.grid_shape, A._periodic())
    assert perm is not None and sorted(perm) == list(range(27))
    assert all(A.offsets[perm[b]] == off for b, off in enumerate(banded_stencil._BOX))
    rng = np.random.default_rng(30)
    x = torch.from_numpy(rng.normal(size=A.n))
    ref = banded_stencil.banded_stencil_plain(A.bands, A.offsets, A.grid_shape,
                                              A._periodic(), x)
    _assert_close(_box_apply(A, perm, x).numpy(), ref.numpy(), F64_RTOL)
    # random bands under a shuffled offset table: out-of-grid neighbours add
    # nothing whatever their band holds
    order = rng.permutation(27)
    B = port_stencil(torch.from_numpy(rng.normal(size=A.bands.shape)),
                     tuple(A.offsets[s] for s in order), A.grid_shape)
    perm_b = banded_stencil.box_permutation(B.offsets, B.grid_shape, B._periodic())
    ref = banded_stencil.banded_stencil_plain(B.bands, B.offsets, B.grid_shape,
                                              B._periodic(), x)
    _assert_close(_box_apply(B, perm_b, x).numpy(), ref.numpy(), F64_RTOL)


def _general_cases():
    periodic = port_laplacian(port_mesh((6, 5, 4), (True, False, True)), torch.float64, "cpu")
    mesh2 = port_mesh((6, 5))
    flat = port_eliminate(port_laplacian(mesh2, torch.float64, "cpu"),
                          mesh2.boundary_vertex_mask())
    envelope = stencil_from_scipy(_q2_like_scipy((6, 7, 5), seed=31), (6, 7, 5), device="cpu")
    mesh3 = port_mesh((4, 4, 4))
    A = port_eliminate(port_laplacian(mesh3, torch.float64, "cpu"), mesh3.boundary_vertex_mask())
    seven = tuple(o for o in A.offsets if sum(map(abs, o)) <= 1)
    return {"periodic": periodic, "2D": flat, "5^3": envelope,
            "7-point": port_stencil(A.bands[[A.offsets.index(o) for o in seven]], seven,
                                    A.grid_shape)}


@pytest.mark.parametrize("case", ["periodic", "2D", "5^3", "7-point"])
def test_general_kernel_chosen_otherwise(case):
    A = _general_cases()[case]
    assert banded_stencil.box_permutation(A.offsets, A.grid_shape, A._periodic()) is None


@pytest.mark.parametrize("grid_shape, box", [
    ((65535, 2, 2), True), ((65536, 2, 2), False),
    ((2, 8 * 65535, 2), True), ((2, 8 * 65535 + 1, 2), False), ((2, 2, 10 ** 6), True)])
def test_box_kernel_declined_past_its_launch_grid(grid_shape, box):
    """The box kernel's launch grid holds n0 planes on gridDim.z and n1 / 8
    tiles on gridDim.y, each at most 65535; larger grids take the general
    kernel (chosen from the shape alone, with no bands built)."""
    offsets = tuple(reversed(banded_stencil._BOX))
    perm = banded_stencil.box_permutation(offsets, grid_shape, (False,) * 3)
    assert (perm is not None) == box


def test_banded_wrapper_refuses_before_any_build(monkeypatch):
    """Box or general, the CUDA wrapper refuses a CPU tensor before any
    build or launch, and counts nothing; `counts.box` resets with the rest."""
    from gridapsolvers_tpu_torch.ops import build

    def no_build(*a, **k):
        raise AssertionError("a kernel was built or loaded")

    monkeypatch.setattr(build, "function", no_build)
    mesh = port_mesh((4, 4, 4))
    A = port_eliminate(port_laplacian(mesh, torch.float64, "cpu"), mesh.boundary_vertex_mask())
    x = torch.zeros(A.n, dtype=torch.float64)
    before = (banded_stencil.counts.kernel, banded_stencil.counts.box)
    for kw in ({}, {"general": True}):
        with pytest.raises(ValueError, match="CUDA"):
            banded_stencil.banded_stencil_cuda(A.bands, A.offsets, A.grid_shape,
                                               A._periodic(), x, **kw)
    assert (banded_stencil.counts.kernel, banded_stencil.counts.box) == before
    counts = banded_stencil.StencilLaunchCounts(kernel=3, plain=2, box=1)
    counts.reset()
    assert (counts.kernel, counts.plain, counts.box) == (0, 0, 0)
