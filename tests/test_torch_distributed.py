"""The port's distributed stencil path against the JAX package's.

Each test makes one `run_ranks` launch of 4 gloo ranks on the CPU (a
FileStore rendezvous in a temporary directory, a 60 s process-group
timeout and a 120 s watchdog: a hang fails the test). The ranks run the
functions of `tests/torch_dist_ranks.py`, which import no JAX; the
2-rank and (2, 2) cases run on meshes of the first ranks of the launch.
While they run, this process computes the JAX references on the
conftest's simulated devices (`device_mesh(2)`, `device_mesh(4)`,
`device_mesh_nd((2, 2))`), compiled where they solve. The same seeded
numpy inputs go to both packages (`convert.shard_from_jax` cuts them
into the ranks' blocks, `convert.unshard_to_jax` puts the blocks back).

Tolerances (f64): operator applies to 1e-12 of max|y|; the
communication-avoiding Chebyshev sweep's core to 1e-13 of the
per-matvec-exchange sweep's; GMG-CG iterations and flags equal, residual
histories to rtol 1e-8 above 1e-12 of ||r0||, x to 1e-10 of max|x| (the
ranks reduce dots in another order than XLA); Lanczos's lmax from the
global start vector to 1e-12; the periodic torus's
iterations within one of JAX's distributed count and of the port's serial
solve (as `tests/test_distributed.py:315` asks) and x to 1e-8 of max|x|.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_dist_ranks
from jax_reference_jit import jitted_jax_setups
from gridapsolvers_tpu.fem import poisson_problem as j_poisson_problem
from gridapsolvers_tpu.fem.assembly import eliminate_dirichlet as j_eliminate
from gridapsolvers_tpu.fem.assembly import laplacian as j_laplacian
from gridapsolvers_tpu.fem.assembly import mass as j_mass
from gridapsolvers_tpu.fem.mesh import CartesianMesh as JMesh
from gridapsolvers_tpu.interfaces.nullspaces import NullSpace as JNullSpace
from gridapsolvers_tpu.linear import CGSolver as JCG
from gridapsolvers_tpu.linear import ChebyshevSmoother as JCheby
from gridapsolvers_tpu.algebra.stencil import StencilMatrix as JStencil
from gridapsolvers_tpu.linear.smoothers import estimate_dinv_a_lmax as j_lanczos
from gridapsolvers_tpu.linear.wrappers import NullspaceSolver as JNullspaceSolver
from gridapsolvers_tpu.multilevel import cartesian_hierarchy as j_hierarchy
from gridapsolvers_tpu.parallel import device_mesh, device_mesh_nd
from gridapsolvers_tpu.parallel import distributed_poisson_gmg as j_dist_gmg
from gridapsolvers_tpu.parallel import shard_grid_vector as j_shard_vector
from gridapsolvers_tpu.parallel.dist import _axes_tuple, pad_stencil, shard_stencil
from gridapsolvers_tpu.parallel.halo import HaloChebyshevSmoother as JHaloCheby
from gridapsolvers_tpu.parallel.halo import halo_wrap
from gridapsolvers_tpu.parallel.weak_scaling import weak_scaling_poisson as j_weak_scaling

from gridapsolvers_tpu_torch import convert
from gridapsolvers_tpu_torch.parallel.launch import launch_ranks, rank_device

torch.set_num_threads(1)

WORLD = 4
WATCHDOG_S = 120.0
Y_RTOL = 1e-12
CA_RTOL = 1e-13
HIST_RTOL = 1e-8
X_RTOL = 1e-10
X_RTOL_PERIODIC = 1e-8


def _launch(fn, *args):
    return launch_ranks(fn, WORLD, args, device="cpu", timeout=WATCHDOG_S)


def _jmesh(layout):
    return device_mesh(layout[0]) if len(layout) == 1 else device_mesh_nd(layout)


def _axis(layout):
    return "p" if len(layout) == 1 else None


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def _blocks(values, procs):
    return convert.unshard_to_jax(values, procs)


# -- halo operators -------------------------------------------------------------

HALO_CASES = (  # ncells, mesh layout, periodic
    ((16, 16, 16), (4,), None),           # slab, 3D 27-point
    ((33, 17), (2,), None),               # odd 2D
    ((32, 32), (2, 2), None),             # box: corners through the earlier axis
    ((16, 16), (2,), (True, True)),       # periodic split axis: wrap pairs
)


def _halo_inputs(rng):
    """JAX's padded operators and seeded inputs, and a closure for each
    JAX matvec (run after the ranks have started)."""
    cases, refs = [], []
    for ncells, layout, per in HALO_CASES:
        m = JMesh(ncells, tuple(x for _ in ncells for x in (0.0, 1.0)), per)
        A = j_eliminate(j_laplacian(m, np.float64), m.boundary_vertex_mask())
        mesh = _jmesh(layout)
        axes = _axes_tuple(mesh, _axis(layout))
        Ap = pad_stencil(A, tuple(mesh.shape[a] for a in axes))
        x = rng.normal(size=Ap.grid_shape)
        cases.append({"ncells": ncells, "layout": layout, "periodic": per,
                      "bands": np.asarray(Ap.bands), "offsets": Ap.offsets, "x": x})

        def ref(Ap=Ap, mesh=mesh, layout=layout, x=x):
            Ad = shard_stencil(Ap, mesh, _axis(layout), pad=False)
            xd = j_shard_vector(jnp.asarray(x), mesh, Ap.grid_shape, axis=_axis(layout),
                                pad=False)
            return np.asarray(jax.jit(halo_wrap(Ad, mesh, _axis(layout)).matvec)(xd))
        refs.append(ref)
    return cases, refs


def test_halo_operators_equal_jax(monkeypatch):
    # a launch, or a rank's device outside one, is on the card unless the
    # caller asks for the CPU: with no GPU, both raise (no rank starts)
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        for call in (lambda: launch_ranks(torch_dist_ranks.halo_cases, 2), rank_device):
            with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
                call()

    rng = np.random.default_rng(12)
    cases, refs = _halo_inputs(rng)
    mesh4 = device_mesh(4)
    gmg, Ad = j_dist_gmg(j_hierarchy((16, 16, 16), 3), mesh4, smoother=JCheby(degree=3))
    Pj, Rj = gmg.prolongations[0], gmg.restrictions[0]
    transfer = {"ncells": (16, 16, 16), "xc": rng.normal(size=Pj.coarse_shape),
                "xf": rng.normal(size=Rj.fine_shape)}
    smooth = {"x": rng.normal(size=Ad.grid_shape), "r": rng.normal(size=Ad.grid_shape)}
    roundtrip = {"shape": (9, 9, 9), "x": rng.normal(size=9 ** 3)}
    run = _launch(torch_dist_ranks.halo_cases, cases, transfer, smooth, roundtrip)

    # the JAX side, while the ranks run
    y_ref = [ref() for ref in refs]
    vec = lambda a: j_shard_vector(jnp.asarray(a), mesh4, a.shape, pad=False)  # noqa: E731
    p_ref = np.asarray(jax.jit(Pj.matvec)(vec(transfer["xc"])))
    r_ref = np.asarray(jax.jit(Rj.matvec)(vec(transfer["xf"])))
    # Lanczos from the global start vector: JAX's estimate on the whole
    # padded level-0 operator
    Aw = JStencil(jnp.asarray(np.asarray(Ad.bands)), Ad.offsets, Ad.grid_shape)
    lanczos_ref = float(jax.jit(j_lanczos)(Aw, 1.0 / Aw.diag()))
    ca = JHaloCheby(degree=3)
    st = ca.setup(Ad)
    ca_ref = [np.asarray(v) for v in jax.jit(ca.smooth)(st, vec(smooth["x"]), vec(smooth["r"]))]
    out = run.result()

    for i, (c, y) in enumerate(zip(cases, y_ref)):
        members = [o for o in out if i in o["matvec"]]
        procs = c["layout"]
        # the port pads like the JAX package, and its own operator is JAX's
        assert all(o["shapes"][i] == (c["bands"].shape[1:],
                                      tuple(n // p for n, p in zip(
                                          c["bands"].shape[1:],
                                          procs + (1,) * (len(c["ncells"]) - len(procs)))))
                   for o in members), c["ncells"]
        assert all(o["matvec"][i][1] for o in members), c["ncells"]
        got = _blocks([o["matvec"][i][0] for o in members], procs)
        assert got.shape == y.shape
        assert _rel(got, y) <= Y_RTOL, (c["ncells"], procs, _rel(got, y))

    assert all(o["transfer_types"] == ("HaloProlongation", "HaloRestriction") for o in out)
    for key, ref in (("P", p_ref), ("R", r_ref)):
        got = _blocks([o[key] for o in out], (4,))
        assert got.shape == ref.shape and _rel(got, ref) <= Y_RTOL, (key, _rel(got, ref))

    assert all(o["lanczos"] == out[0]["lanczos"] for o in out)
    assert abs(out[0]["lanczos"] - lanczos_ref) <= 1e-12 * lanczos_ref, \
        (out[0]["lanczos"], lanczos_ref)
    assert all(o["lmax"][0] == o["lmax"][1] for o in out)
    assert abs(out[0]["lmax"][0] - float(st["lmax"])) <= 1e-14 * float(st["lmax"])
    for k, name in enumerate(("x", "r")):
        ca_port = _blocks([o["ca"][k] for o in out], (4,))
        per_matvec = _blocks([o["per_matvec"][k] for o in out], (4,))
        assert _rel(ca_port, per_matvec) <= CA_RTOL, (name, _rel(ca_port, per_matvec))
        assert _rel(ca_port, ca_ref[k]) <= Y_RTOL, (name, _rel(ca_port, ca_ref[k]))

    assert all(o["roundtrip"] == (True, True, True) for o in out)


# -- distributed GMG-CG ---------------------------------------------------------

def _jax_gmg_cg(ncells, layout):
    mesh = _jmesh(layout)
    prob = j_poisson_problem(ncells)
    gmg, Ad = j_dist_gmg(j_hierarchy(ncells, 3), mesh,
                         smoother=JCheby(degree=3, eig_method="gershgorin"), axis=_axis(layout))
    solver = JCG(Pl=gmg, rtol=1e-8, maxiter=30)
    bd = j_shard_vector(prob.b, mesh, prob.A.grid_shape, axis=_axis(layout),
                        target_shape=Ad.grid_shape)
    x, stats = jax.jit(lambda A, b: solver.solve(solver.setup(A), b))(Ad, bd)
    n = int(stats.niter)
    xg = np.asarray(x)[tuple(slice(0, m) for m in prob.A.grid_shape)].reshape(-1)
    return {"iters": n, "flag": int(stats.flag),
            "history": np.asarray(stats.residuals)[: n + 1], "x": xg}


def _periodic_inputs(ncells):
    hier = j_hierarchy(ncells, 3, periodic=(True, True))
    xs = [np.arange(n) / n for n in hier[0].ncells]
    X, Y = np.meshgrid(xs[0], xs[1], indexing="ij")
    u_ex = np.sin(2 * np.pi * X) * np.sin(2 * np.pi * Y)
    b = j_mass(hier[0]).matvec(jnp.asarray((8 * np.pi ** 2 * u_ex).reshape(-1)))
    return hier, b - jnp.mean(b)


def _jax_periodic(hier, b):
    """JAX's 2-device solve of `tests/test_distributed.py`'s periodic case
    (at 16^2 here)."""
    nc = hier[-1].vertex_shape
    mesh = device_mesh(2)
    gmg_d, Ad = j_dist_gmg(hier, mesh, smoother=JCheby(degree=3), coarsest_solver=JNullspaceSolver(
        nullspace=JNullSpace(vectors=(jnp.ones(nc),)), constrain_matrix=True))
    solver_d = JCG(Pl=gmg_d, rtol=1e-8, maxiter=30)
    bd = j_shard_vector(b, mesh, Ad.grid_shape)
    x_d, stats_d = jax.jit(lambda A, v: solver_d.solve(solver_d.setup(A), v))(Ad, bd)
    return int(stats_d.niter), int(stats_d.flag), np.asarray(x_d).reshape(-1)


def test_distributed_gmg_cg_equal_jax():
    hier, b = _periodic_inputs((16, 16))
    weak = {"local": (8, 8, 8), "counts": (1, 2), "rtol": 1e-6, "maxiter": 25}
    run = _launch(torch_dist_ranks.gmg_cases, {"ncells": (16, 16), "b": np.asarray(b)}, weak)

    # the JAX side, while the ranks run
    ref = {"slab": _jax_gmg_cg((16, 16, 16), (4,)), "box": _jax_gmg_cg((32, 32), (2, 2))}
    its_dist, flag_dist, x_periodic = _jax_periodic(hier, b)
    with jitted_jax_setups():
        weak_ref = j_weak_scaling(local_cells=weak["local"], device_counts=weak["counts"],
                                  rtol=weak["rtol"], maxiter=weak["maxiter"])
    out = run.result()

    for name in ("slab", "box"):
        got, want = out[0][name], ref[name]
        assert (got["iters"], got["flag"]) == (want["iters"], want["flag"]), (name, got, want)
        h0 = want["history"][0]
        keep = want["history"] > 1e-12 * h0
        np.testing.assert_allclose(got["history"][keep], want["history"][keep], rtol=HIST_RTOL)
        assert _rel(got["x"], want["x"]) <= X_RTOL, (name, _rel(got["x"], want["x"]))

    per = out[0]["periodic"]
    assert per["flag"] == flag_dist and abs(per["iters"] - its_dist) <= 1 and \
        abs(per["iters"] - per["serial_iters"]) <= 1, (per, its_dist)
    xp, xj = per["x"] - per["x"].mean(), x_periodic - x_periodic.mean()
    assert _rel(xp, xj) <= X_RTOL_PERIODIC, _rel(xp, xj)

    rows = out[0]["weak"]
    assert [r["iters"] for r in rows] == [r["iters"] for r in weak_ref], (rows, weak_ref)
    assert [r["levels"] for r in rows] == [r["levels"] for r in weak_ref]
    assert [r["dofs"] for r in rows] == [r["dofs"] for r in weak_ref]
