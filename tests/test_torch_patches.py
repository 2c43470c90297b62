"""The port's patch machinery against the JAX package.

Patch topologies, the native host kernels (and their NumPy twins), patch
matrix extraction (whole and in chunks of patches), the batched Vanka
smoother (velocity vertex-star patches on the grad-div augmented block and
seed-field patches on plain Stokes, both weightings), PatchSolver in its
three weightings, and the patch-corrected transfers: the same inputs, made
from a seed, go through both packages in f64 on the CPU. Index tables are
equal; single operator applies agree to 1e-12 of their largest entry.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from gridapsolvers_tpu import native as jnative
from gridapsolvers_tpu.fem import poisson_problem as j_poisson_problem
from gridapsolvers_tpu.fem.mesh import CartesianMesh as JMesh
from gridapsolvers_tpu.fem.stokes import graddiv_velocity_block as j_graddiv_block
from gridapsolvers_tpu.fem.stokes import stokes_problem as j_stokes_problem
from gridapsolvers_tpu.fem.stokes import velocity_vanka_smoother as j_vanka_smoother
from gridapsolvers_tpu.patches import PatchSolver as JPatchSolver
from gridapsolvers_tpu.patches import VankaSolver as JVankaSolver
from gridapsolvers_tpu.patches import topology as jtopo
from gridapsolvers_tpu.patches.smoothers import extract_patch_matrices_ell as j_extract
from gridapsolvers_tpu.patches.smoothers import extract_patch_matrices_stencil as j_extract_stencil
from gridapsolvers_tpu.algebra.ell_view import ell_view as j_ell_view

from gridapsolvers_tpu_torch import convert, native
from gridapsolvers_tpu_torch.fem import poisson_problem
from gridapsolvers_tpu_torch.fem.mesh import CartesianMesh
from gridapsolvers_tpu_torch.fem.stokes import graddiv_velocity_block, stokes_problem
from gridapsolvers_tpu_torch.fem.stokes import velocity_vanka_smoother
from gridapsolvers_tpu_torch.algebra.ell_view import ell_view
from gridapsolvers_tpu_torch.multilevel import cartesian_hierarchy, setup_transfer_operators
from gridapsolvers_tpu_torch.fem.assembly import eliminate_dirichlet, laplacian
from gridapsolvers_tpu_torch.patches import PatchSolver, VankaSolver, topology
from gridapsolvers_tpu_torch.patches.smoothers import (
    extract_patch_matrices_ell,
    extract_patch_matrices_stencil,
)
from gridapsolvers_tpu_torch.patches.transfer import setup_patch_transfers
from gridapsolvers_tpu_torch.utils import pytrees as pt

torch.set_num_threads(1)

OP_RTOL = 1e-12


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
    """The same random vector for both packages: (port tuple, JAX tuple)."""
    leaves = [rng.normal(size=t.shape[0]) for t in template]
    return (tuple(torch.from_numpy(v) for v in leaves), tuple(jnp.asarray(v) for v in leaves))


def _meshes(nc):
    dom = (0.0, 1.0) * len(nc)
    return CartesianMesh(nc, dom), JMesh(nc, dom)


# ------------------------------------------------------------- topology ---


@pytest.mark.parametrize("case", ["star", "star_free_r2", "star_stride2", "coarse", "interior",
                                  "concat"])
def test_topology_equal_jax(case):
    rng = np.random.default_rng(0)
    gs = (9, 7)
    free = rng.random(gs) < 0.8
    make = {
        "star": lambda m: m.vertex_star_patches(gs),
        "star_free_r2": lambda m: m.vertex_star_patches(gs, free_mask=free, radius=2),
        "star_stride2": lambda m: m.vertex_star_patches((9, 9), free_mask=None, radius=1,
                                                        stride=2),
        "coarse": lambda m: m.coarse_cell_patches((2, 2), order=2),
        "interior": lambda m: m.coarse_cell_patches((2, 3), order=2,
                                                    free_mask=rng.random((9, 13)) < 0.9,
                                                    interior=True),
        "concat": lambda m: m.concat_patches(
            [m.vertex_star_patches((5, 5)), m.vertex_star_patches((5, 5), radius=0)], [25, 25]),
    }[case]
    state = rng.bit_generator.state
    t = make(topology)
    rng.bit_generator.state = state
    jt = make(jtopo)
    np.testing.assert_array_equal(t.dofs, jt.dofs)
    assert (t.dummy, t.n_dofs) == (jt.dummy, jt.n_dofs)
    np.testing.assert_array_equal(t.overlap_counts(), jt.overlap_counts())
    np.testing.assert_array_equal(t.owner_slot_mask(), jt.owner_slot_mask())


# --------------------------------------------------------------- native ---


def _sym_ell(n, seed):
    S = sp.random(n, n, density=0.05, random_state=seed, format="csr")
    S = (S + S.T + sp.identity(n)).tocsr()
    K = int(np.diff(S.indptr).max())
    cols = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, K))
    for i in range(n):
        cs = S.indices[S.indptr[i]: S.indptr[i + 1]]
        cols[i, : len(cs)] = cs
    return S, cols


@pytest.mark.parametrize("fn", ["greedy_color", "union_patches", "rcm_order",
                                "ell_from_sorted_coo"])
def test_native_equal_twin_and_jax(fn):
    """The port's native library builds (into its own build directory) and
    agrees with its NumPy twin and with the JAX package's native outputs."""
    assert native.implementation() == "native"
    assert native.library_path().parent.name == "build"
    rng = np.random.default_rng(1)
    S, cols = _sym_ell(120, 3)
    if fn == "greedy_color":
        got = native.greedy_color(cols)
        np.testing.assert_array_equal(got, jnative.greedy_color(cols))
        twin = native.greedy_color(cols, native=False)
        for c in (got, twin):  # both valid colorings
            assert all(c[j] != c[i] for i in range(len(c)) for j in cols[i] if j != i)
        np.testing.assert_array_equal(got, twin)
    elif fn == "union_patches":
        got = native.union_patches(S.indptr, S.indices, 10, 90, 120)
        np.testing.assert_array_equal(got, jnative.union_patches(S.indptr, S.indices, 10, 90,
                                                                  120))
        twin = native.union_patches(S.indptr, S.indices, 10, 90, 120, native=False)
        np.testing.assert_array_equal(np.sort(got, axis=1), np.sort(twin, axis=1))
    elif fn == "rcm_order":
        got = native.rcm_order(cols)
        np.testing.assert_array_equal(got, jnative.rcm_order(cols))
        twin = native.rcm_order(cols, native=False)
        for perm in (got, twin):
            assert sorted(perm.tolist()) == list(range(120))
    else:
        n, nnz = 40, 300
        rows, cs = rng.integers(0, n, nnz), rng.integers(0, n, nnz)
        order = np.lexsort((cs, rows))
        rows, cs, vals = rows[order], cs[order], rng.normal(size=nnz)
        got = native.ell_from_sorted_coo(n, n, rows, cs, vals)
        ref = jnative.ell_from_sorted_coo(n, n, rows, cs, vals)
        twin = native.ell_from_sorted_coo(n, n, rows, cs, vals, native=False)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(twin[0], got[0], rtol=0, atol=1e-14)
        np.testing.assert_array_equal(twin[1], got[1])


# ----------------------------------------------------------- extraction ---


@pytest.fixture(scope="module")
def aug8():
    """The grad-div augmented velocity block at 8^2 cells (banded), both
    packages, and the vertex-star Vanka smoothers."""
    m, jm = _meshes((8, 8))
    K = graddiv_velocity_block(m, 1.0, 1e3, banded=True, device="cpu")
    jK = j_graddiv_block(jm, 1.0, 1e3, banded=True)
    return m, jm, K, jK


@pytest.mark.parametrize("chunk", [None, 1, 7])
def test_extract_patch_matrices_equal_jax(aug8, chunk):
    m, jm, K, jK = aug8
    ell, meta, _ = ell_view(K)
    jell, jmeta, _ = j_ell_view(jK)
    topo = velocity_vanka_smoother(m).topo
    Ap = extract_patch_matrices_ell(ell, topo.dofs, meta.n_rows, chunk=chunk)
    jAp = j_extract(jell, topo.dofs, jmeta.n_rows)
    np.testing.assert_array_equal(Ap.numpy(), np.asarray(jAp))
    # a single stencil leaf through its banded ELL view
    star = topology.vertex_star_patches(K.blocks[0][0].grid_shape)
    np.testing.assert_array_equal(
        extract_patch_matrices_stencil(K.blocks[0][0], star.dofs, star.dummy, chunk).numpy(),
        np.asarray(j_extract_stencil(jK.blocks[0][0], star.dofs, star.dummy)))


# ---------------------------------------------------------------- Vanka ---


@pytest.mark.parametrize("weighting", ["unit", "overlap"])
def test_velocity_vanka_equal_jax(aug8, weighting):
    """Vertex-star Vanka on the augmented block: inverses, apply, smooth
    and update (at a second viscosity) against JAX."""
    m, jm, K, jK = aug8
    v = velocity_vanka_smoother(m, omega=0.7, weighting=weighting)
    jv = j_vanka_smoother(jm, omega=0.7, weighting=weighting)
    st, jst = v.setup(K), jv.setup(jK)
    _assert_close(st["inv"], jst["inv"])
    _assert_close(st["uncovered_inv_diag"], jst["uncovered_inv_diag"])
    rng = np.random.default_rng(2)
    r, jr = _rand_like(rng, K.diag())
    _assert_close(v.apply(st, r), jv.apply(jst, jr))
    # JAX's topology and state carried across apply literally the same map
    ct = convert.patch_topology(jv.topo.dofs, jv.topo.dummy, jv.topo.n_dofs)
    np.testing.assert_array_equal(ct.dofs, v.topo.dofs)
    cv = VankaSolver(topo=ct, omega=0.7, weighting=weighting)
    cst = convert.vanka_state(cv, K, jst["dofs"], jst["inv"], jst["uncovered_inv_diag"],
                              jst.get("wdof"), device="cpu")
    _assert_close(cv.apply(cst, r), jv.apply(jst, jr), 1e-14)
    x0 = pt.zeros_like(r)
    _assert_close(v.smooth(st, x0, r), jv.smooth(jst, tuple(jnp.zeros_like(t) for t in jr), jr))
    K2 = graddiv_velocity_block(m, 2.5, 1e3, banded=True, device="cpu")
    jK2 = j_graddiv_block(jm, 2.5, 1e3, banded=True)
    st2, jst2 = v.update(st, K2), jv.update(jst, jK2)
    _assert_close(st2["inv"], jst2["inv"])
    _assert_close(v.apply(st2, r), jv.apply(jst2, jr))
    _assert_close(v.apply(st2, r), v.apply(v.setup(K2), r))


@pytest.mark.parametrize("weighting", ["unit", "overlap"])
def test_seed_field_vanka_equal_jax(weighting):
    """Pressure-seeded Vanka patches (vanka_patches through the native
    union) on plain Stokes: the same table, apply and smooth as JAX."""
    prob = stokes_problem((4, 4), device="cpu")
    jprob = j_stokes_problem((4, 4))
    v, jv = VankaSolver(omega=0.7, weighting=weighting), JVankaSolver(omega=0.7,
                                                                       weighting=weighting)
    st, jst = v.setup(prob.A), jv.setup(jprob.A)
    np.testing.assert_array_equal(st["dofs"].numpy(), np.asarray(jst["dofs"]))
    _assert_close(st["inv"], jst["inv"])
    _assert_close(v.apply(st, prob.b), jv.apply(jst, jprob.b))
    x0 = pt.zeros_like(prob.b)
    jx0 = (tuple(jnp.zeros_like(t) for t in jprob.b[0]), jnp.zeros_like(jprob.b[1]))
    _assert_close(v.smooth(st, x0, prob.b), jv.smooth(jst, jx0, jprob.b))


# ---------------------------------------------------------- PatchSolver ---


@pytest.mark.parametrize("weighting", ["unit", "overlap", "nonoverlapping"])
def test_patch_solver_equal_jax(weighting):
    prob = poisson_problem((8, 8), device="cpu")
    jprob = j_poisson_problem((8, 8))
    topo = topology.vertex_star_patches(prob.A.grid_shape, ~prob.dirichlet_mask)
    jt = jtopo.vertex_star_patches(jprob.A.grid_shape, ~jprob.dirichlet_mask)
    s = PatchSolver(topo, omega=0.6, weighting=weighting)
    js = JPatchSolver(jt, omega=0.6, weighting=weighting)
    st, jst = s.setup(prob.A), js.setup(jprob.A)
    _assert_close(st["inv"], jst["inv"])
    rng = np.random.default_rng(3)
    rv = rng.normal(size=prob.A.n)
    r, jr = torch.from_numpy(rv), jnp.asarray(rv)
    _assert_close(s.apply(st, r), js.apply(jst, jr))
    _assert_close(s.smooth(st, torch.zeros_like(r), r), js.smooth(jst, jnp.zeros_like(jr), jr))
    _assert_close(s.solve(st, r)[0], js.solve(jst, jr)[0])
    st3 = s.update(st, prob.A.astype(torch.float64))
    _assert_close(s.apply(st3, r), js.apply(jst, jr))


def test_patch_transfers_equal_jax():
    """PatchProlongation / PatchRestriction over coarse-cell patches on a
    Poisson hierarchy: one prolongation and one restriction against JAX."""
    from gridapsolvers_tpu.fem.assembly import eliminate_dirichlet as j_elim
    from gridapsolvers_tpu.fem.assembly import laplacian as j_laplacian
    from gridapsolvers_tpu.multilevel import cartesian_hierarchy as j_hier
    from gridapsolvers_tpu.multilevel import setup_transfer_operators as j_transfers
    from gridapsolvers_tpu.patches.transfer import setup_patch_transfers as j_patch_transfers

    h, jh = cartesian_hierarchy((8, 8), 2), j_hier((8, 8), 2)
    ops = [eliminate_dirichlet(laplacian(m, device="cpu"), m.boundary_vertex_mask())
           for m in h.meshes]
    jops = [j_elim(j_laplacian(m), m.boundary_vertex_mask()) for m in jh.meshes]
    P0, R0 = setup_transfer_operators(h, device="cpu")
    jP0, jR0 = j_transfers(jh)
    topos = [topology.coarse_cell_patches(h[1].ncells, order=1,
                                          free_mask=~h[0].boundary_vertex_mask())]
    jtopos = [jtopo.coarse_cell_patches(jh[1].ncells, order=1,
                                        free_mask=~jh[0].boundary_vertex_mask())]
    Pp, Rp = setup_patch_transfers(P0, R0, ops, topos)
    jPp, jRp = j_patch_transfers(jP0, jR0, jops, jtopos)
    rng = np.random.default_rng(4)
    xc, xf = rng.normal(size=ops[1].n), rng.normal(size=ops[0].n)
    _assert_close(Pp[0].matvec(torch.from_numpy(xc)), jPp[0].matvec(jnp.asarray(xc)))
    _assert_close(Rp[0].matvec(torch.from_numpy(xf)), jRp[0].matvec(jnp.asarray(xf)))
    Pu = Pp[0].update(ops[0])
    _assert_close(Pu.matvec(torch.from_numpy(xc)), jPp[0].matvec(jnp.asarray(xc)))
