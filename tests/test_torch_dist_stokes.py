"""The port's box-partitioned sparse layer and distributed Stokes flagship
against the JAX package's.

Each test makes one `run_ranks` launch of 4 gloo ranks on the CPU (the
functions of `tests/torch_dist_ranks.py`, which import no JAX); the
(2, 2), (4,), (2,) and (1, 1) cases run on meshes of the first ranks of
the launch. While they run, this process computes the JAX references on
the conftest's simulated devices, compiled where they solve. The same
seeded numpy inputs go to both packages; `convert.box_vector_from_jax`
and `convert.graph_ell_from_jax` carry JAX's box-ordered vectors and a
JAX `DistGraphELL`'s tables to the ranks.

Tolerances (f64): `box_partition` fields, `dirs`, `cols_loc` and send
tables equal; operator applies (`matvec`, `matvec_t`, `diag`,
`abs_row_sum`, the Stokes block matvec) to 1e-12 of max|y|; values and
the redistributed vector equal; Jacobi-CG and the halo-stencil GMRES:
iterations and flags equal, residual histories to rtol 1e-8 above 1e-12
of ||r0|| with an absolute floor of 1e-14 ||r0||, x to 1e-10 of max|x|
(the ranks reduce dots in another order than XLA; the floor is the
round-off of a residual recomputed from x at a restart, b - A x with
||r|| ~ 1e-7 ||r0||, which the Krylov recurrence's own entries do not
carry); the (2, 2) flagship FGMRES against JAX's: iterations and flag
equal, history as above, x to 1e-10 of max|x|; the (4,) and one-rank
solves against the port's serial twin (other transfers: the linear
node-grid ones): iterations within 1, u to 5e-7 and p to 1e-6 absolute,
as `tests/test_dist_stokes.py:207` and `tests/test_dist_stokes_nd.py:44`
allow.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_dist_ranks
from gridapsolvers_tpu.algebra.convert import to_scipy as j_to_scipy
from gridapsolvers_tpu.fem import poisson_problem as j_poisson_problem
from gridapsolvers_tpu.fem.assembly import eliminate_dirichlet as j_eliminate
from gridapsolvers_tpu.fem.assembly import laplacian as j_laplacian
from gridapsolvers_tpu.fem.dist_stokes_nd import distributed_stokes_solver_nd as j_stokes_solver
from gridapsolvers_tpu.fem.dist_stokes_nd import distributed_stokes_system_nd as j_stokes_system
from gridapsolvers_tpu.fem.mesh import CartesianMesh as JMesh
from gridapsolvers_tpu.linear import CGSolver as JCG
from gridapsolvers_tpu.linear import GMRESSolver as JGMRES
from gridapsolvers_tpu.linear import JacobiSolver as JJacobi
from gridapsolvers_tpu.multilevel.transfer import fe_grid_interpolation
from gridapsolvers_tpu.parallel import device_mesh, device_mesh_nd
from gridapsolvers_tpu.parallel import dist_ell_nd as jnd
from gridapsolvers_tpu.parallel import shard_grid_vector as j_shard_vector
from gridapsolvers_tpu.parallel.dist import pad_stencil, shard_stencil

from gridapsolvers_tpu_torch import convert
from gridapsolvers_tpu_torch.parallel import dist_ell_nd as tnd
from gridapsolvers_tpu_torch.parallel.launch import launch_ranks

torch.set_num_threads(1)

WORLD = 4
WATCHDOG_S = 120.0
Y_RTOL = 1e-12
HIST_RTOL = 1e-8
HIST_FLOOR = 1e-14
X_RTOL = 1e-10
U_ATOL, P_ATOL = 5e-7, 1e-6
NC = (16, 16)
LEVELS = 2


def _launch(fn, *args):
    return launch_ranks(fn, WORLD, args, device="cpu", timeout=WATCHDOG_S)


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def _jmesh(layout):
    return device_mesh(layout[0]) if len(layout) == 1 else device_mesh_nd(layout)


def _rows(a, n_shards: int) -> list:
    """A JAX shard-major array's rows, one block a shard."""
    return np.split(np.asarray(a), n_shards)


def _check_solve(got, want, name):
    assert (got["iters"], got["flag"]) == (want["iters"], want["flag"]), (name, got, want)
    h0 = want["history"][0]
    keep = want["history"] > 1e-12 * h0
    np.testing.assert_allclose(got["history"][keep], want["history"][keep], rtol=HIST_RTOL,
                               atol=HIST_FLOOR * h0)
    assert _rel(got["x"], want["x"]) <= X_RTOL, (name, _rel(got["x"], want["x"]))


def _jsolve(solver, A, b):
    x, stats = jax.jit(lambda A_, b_: solver.solve(solver.setup(A_), b_))(A, b)
    n = int(stats.niter)
    return {"iters": n, "flag": int(stats.flag), "history": np.asarray(stats.residuals)[: n + 1],
            "x": np.asarray(x)}


def _graph_refs(A, x, xt):
    """JAX's tables and compiled applies of one DistGraphELL."""
    x, xt = jnp.asarray(x), jnp.asarray(xt)
    refs = {"y": jax.jit(A.matvec)(x), "yt": jax.jit(A.matvec_t)(xt),
            "abs_row_sum": jax.jit(A.abs_row_sum)()}
    if A.n_rows == A.n_cols:
        refs["diag"] = jax.jit(A.diag)()
    return A, {k: np.asarray(v) for k, v in refs.items()}


def _check_graph(rows, A_refs, n_shards, name):
    """Every rank's tables equal JAX's rows of them, its applies JAX's."""
    A, refs = A_refs
    cols, vals = _rows(A.cols_loc, n_shards), _rows(A.values, n_shards)
    tbls = [np.asarray(t) for t in A.send_tbls]
    for r, row in enumerate(rows):
        assert row["dirs"] == A.dirs, (name, r, row["dirs"], A.dirs)
        assert np.array_equal(row["cols_loc"], cols[r]), (name, r)
        assert np.array_equal(row["values"], vals[r]), (name, r)
        assert all(np.array_equal(t, tj[r]) for t, tj in zip(row["send_tbls"], tbls)), (name, r)
    for key, ref in refs.items():
        got = convert.box_vector_to_jax([row[key] for row in rows])
        assert got.shape == np.asarray(ref).shape and _rel(got, ref) <= Y_RTOL, (
            name, key, _rel(got, ref))


def test_box_partitioned_sparse_layer_equal_jax(monkeypatch):
    # a launch asked for no device is on the card: with no GPU it raises
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            launch_ranks(torch_dist_ranks.graph_cases, 2)

    # the partitions, host only: (2, 2), (2, 4) and a trailing component axis
    for shape, layout in (((14, 19), (2, 2)), ((5, 7), (2, 4)), ((6, 7, 2), (2, 2)),
                          ((14, 19), (4,))):
        got, want = tnd.box_partition(shape, layout), jnd.box_partition(shape, layout)
        assert (got.shape, got.mesh_shape, got.box_shape) == (want.shape, want.mesh_shape,
                                                              want.box_shape), shape
        assert np.array_equal(got.owner, want.owner) and np.array_equal(got.slot, want.slot)
        assert np.array_equal(got.padded_index(), want.padded_index())
    got, want = tnd.contiguous_partition(23, 4), jnd.contiguous_partition(23, 4)
    assert got.box_shape == want.box_shape and np.array_equal(got.padded_index(),
                                                              want.padded_index())

    rng = np.random.default_rng(14)
    S2 = j_to_scipy(j_poisson_problem((13, 18)).A)          # 14 x 19 nodes
    S3 = j_to_scipy(j_poisson_problem((5, 6, 4)).A)         # 6 x 7 x 5 nodes
    square = []
    for S, shape, layout in ((S2, (14, 19), (4,)), (S2, (14, 19), (2, 2)),
                             (S3, (6, 7, 5), (2, 2))):
        part = jnd.box_partition(shape, layout)
        square.append({"S": S, "shape": shape, "layout": layout,
                       "x": rng.normal(size=part.n_pad), "y": rng.normal(size=part.n_pad)})
    square[1].update(host=True, cg=True)
    part22 = jnd.box_partition((14, 19), (2, 2))
    cg = {"b": jnd.shard_vector_nd(rng.normal(size=S2.shape[0]), part22, device_mesh_nd((2, 2))),
          "rtol": 1e-10, "maxiter": 200}
    cg_host = dict(cg, b=np.asarray(cg["b"]))

    Pcsr = fe_grid_interpolation((8, 8), 2)
    pf, pc = jnd.box_partition((33, 33), (2, 2)), jnd.box_partition((17, 17), (2, 2))
    mesh22 = device_mesh_nd((2, 2))
    jP = jnd.shard_csr_nd(Pcsr, pf, mesh22, part_cols=pc)
    rect = {"P": Pcsr, "fine": (33, 33), "coarse": (17, 17), "xf": rng.normal(size=pf.n_pad),
            "xc": rng.normal(size=pc.n_pad),
            "jax_P": {"values": np.asarray(jP.values), "cols_loc": np.asarray(jP.cols_loc),
                      "send_tbls": [np.asarray(t) for t in jP.send_tbls], "dirs": jP.dirs,
                      "n_cols": jP.n_cols, "m_in": jP.m_in}}
    redist = {"shape": (14, 19), "x": rng.normal(size=jnd.box_partition((14, 19), (4,)).n_pad)}

    m = JMesh((16, 16), (0.0, 1.0, 0.0, 1.0))
    Ap = pad_stencil(j_eliminate(j_laplacian(m, np.float64), m.boundary_vertex_mask()), (2,))
    gmres = {"bands": np.asarray(Ap.bands), "offsets": Ap.offsets,
             "b": rng.normal(size=Ap.grid_shape), "m": 8, "rtol": 1e-8, "maxiter": 120}
    run = _launch(torch_dist_ranks.graph_cases, square, rect, redist, cg_host, gmres)

    # the JAX side, while the ranks run
    jax_ops = []
    for c in square:
        mesh = _jmesh(c["layout"])
        A = jnd.shard_csr_nd(c["S"], jnd.box_partition(c["shape"], c["layout"]), mesh,
                             identity_pad=True)
        jax_ops.append(_graph_refs(A, c["x"], c["y"]))
    jR = jnd.shard_csr_nd(Pcsr.T.tocsr(), pc, mesh22, part_cols=pf)
    rect_refs = {"P": _graph_refs(jP, rect["xc"], rect["xf"]),
                 "R": _graph_refs(jR, rect["xf"], rect["xc"])}
    cg_ref = _jsolve(JCG(Pl=JJacobi(), rtol=cg["rtol"], maxiter=cg["maxiter"]), jax_ops[1][0],
                     cg["b"])
    S_ref = jnd.dist_to_scipy_nd(jax_ops[1][0])
    redist_ref = np.asarray(jnd.redistribute_vector_nd(
        jnp.asarray(redist["x"]), jnd.box_partition((14, 19), (4,)),
        jnd.box_partition((14, 19), (2,)), device_mesh(2)))
    mesh2 = device_mesh(2)
    gmres_ref = _jsolve(JGMRES(m=gmres["m"], rtol=gmres["rtol"], maxiter=gmres["maxiter"]),
                        shard_stencil(Ap, mesh2, "p", pad=False),
                        j_shard_vector(jnp.asarray(gmres["b"]), mesh2, Ap.grid_shape, pad=False))
    out = run.result()

    for k, (c, refs) in enumerate(zip(square, jax_ops)):
        rows = [o["square"][k] for o in out[: int(np.prod(c["layout"]))]]
        _check_graph(rows, refs, int(np.prod(c["layout"])), (c["shape"], c["layout"]))
        if len(c["layout"]) == 2 and len(c["shape"]) == 2:
            assert len(refs[0].dirs) <= 8
    for key, refs in rect_refs.items():
        _check_graph([o[key] for o in out], refs, 4, key)
    for k, key in enumerate(("y", "yt")):
        ref = rect_refs["P"][1][key]
        got = convert.box_vector_to_jax([o["P_from_jax"][k] for o in out])
        assert _rel(got, ref) <= Y_RTOL, ("P from JAX's tables", k, _rel(got, ref))

    moved = [o["redist"] for o in out]
    assert moved[2:] == [None, None]
    assert all(n == redist_ref.shape[0] for _, n in moved[:2])
    assert np.array_equal(convert.box_vector_to_jax([v for v, _ in moved[:2]]), redist_ref)

    S_port = out[0]["scipy"]
    assert S_port.shape == S_ref.shape and abs(S_port - S_ref).max() == 0.0

    got = dict(out[0]["cg"], x=convert.box_vector_to_jax([o["cg"]["x"] for o in out]))
    _check_solve(got, cg_ref, "Jacobi-CG (2, 2)")
    got = dict(out[0]["gmres"], x=convert.unshard_to_jax([o["gmres"]["x"] for o in out[:2]], (2,)))
    _check_solve(got, gmres_ref, "GMRES, 2-rank halo stencil")
    assert all(o["no_card"] for o in out)


def test_distributed_stokes_flagship_equal_jax():
    rng = np.random.default_rng(15)
    pv, pq = jnd.box_partition(tuple(2 * n + 1 for n in NC), (2, 2)), \
        jnd.box_partition(tuple(n + 1 for n in NC), (2, 2))
    x = ((rng.normal(size=pv.n_pad), rng.normal(size=pv.n_pad)), rng.normal(size=pq.n_pad))
    run = _launch(torch_dist_ranks.stokes_cases, NC, LEVELS, x)

    # the JAX side, while the ranks run: the (2, 2) block matvec and solve
    mesh22 = device_mesh_nd((2, 2))
    _, A, b, _, _ = j_stokes_system(NC, mesh22, (2, 2))
    xj = (tuple(jnp.asarray(v) for v in x[0]), jnp.asarray(x[1]))
    y_ref = [np.asarray(v) for v in jax.tree_util.tree_leaves(jax.jit(A.matvec)(xj))]
    solver, _ = j_stokes_solver(NC, LEVELS, mesh22, (2, 2), rtol=1e-8)
    xs, stats = jax.jit(lambda s, v: solver.solve(s, v))(solver.setup(A), b)
    n = int(stats.niter)
    box_ref = {"iters": n, "flag": int(stats.flag),
               "history": np.asarray(stats.residuals)[: n + 1],
               "x": np.concatenate([np.asarray(v) for v in jax.tree_util.tree_leaves(xs)])}
    out = run.result()

    for k, ref in enumerate(y_ref):
        got = convert.box_vector_to_jax([o["matvec"][k] for o in out])
        assert got.shape == ref.shape and _rel(got, ref) <= Y_RTOL, (k, _rel(got, ref))

    # the GMG levels: fine levels sharded over both axes, the coarsest
    # replicated, a level's component operator exchanging over <= 8 offsets
    flags, kind, ndirs = out[0]["levels"]
    assert flags == [True, True, False] and kind == "DistGraphELL" and ndirs <= 8

    box = out[0]["box"]
    got = {"iters": box["iters"], "flag": box["flag"], "history": box["history"],
           "x": np.concatenate([convert.box_vector_to_jax([o["box"]["blocks"][k] for o in out])
                                for k in range(3)])}
    _check_solve(got, box_ref, "FGMRES (2, 2)")

    serial = out[1]["serial"]
    for name, row in (("(4,)", out[0]["slab"]), ("(1, 1)", out[0]["one"]),
                      ("(2, 2)", out[0]["box"])):
        assert abs(row["iters"] - serial["iters"]) <= 1 and row["flag"] == serial["flag"], (
            name, row["iters"], serial["iters"])
        for a, s in zip(row["u"], serial["u"]):
            np.testing.assert_allclose(a, s, atol=U_ATOL)
        np.testing.assert_allclose(row["p"], serial["p"], atol=P_ATOL)
