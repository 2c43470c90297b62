"""The port's smoothed-aggregation AMG (slice 2: AMG-preconditioned CG on
3D Q1 Poisson) against the JAX package's `AMGSolver(engine="ell")`.

The host set-up is the same scipy code in both packages, so hierarchies
are bit-equal. The port sets its smoothers up on the cycle operators, so
level 0's Lanczos runs on the `StencilMatrix` where JAX runs it on an ELL
copy: λmax agrees to 1e-12 (round-off), not bit for bit. Tolerances (f64):
V-cycles 1e-10 of the largest entry, CG residual histories rtol 1e-8 (dot
products and dense inverses differ in the last bits between the two).
"""
import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jax_reference_jit import jitted_jax_chebyshev_setups, jsolve, run_in_f32
from gridapsolvers_tpu.fem import poisson_problem as j_poisson_problem
from gridapsolvers_tpu.fem.assembly import eliminate_dirichlet as j_eliminate
from gridapsolvers_tpu.fem.assembly import laplacian as j_laplacian
from gridapsolvers_tpu.linear import CGSolver as JCG
from gridapsolvers_tpu.linear import ChebyshevSmoother as JCheby
from gridapsolvers_tpu.linear.amg import AMGSolver as JAMG
from gridapsolvers_tpu.linear.gmg import gmg_from_hierarchy as j_gmg_from_hierarchy
from gridapsolvers_tpu.multilevel import cartesian_hierarchy as j_hierarchy

from gridapsolvers_tpu_torch import convert
from gridapsolvers_tpu_torch.algebra import ELLMatrix, StencilMatrix
from gridapsolvers_tpu_torch.fem import poisson_problem
from gridapsolvers_tpu_torch.fem.assembly import eliminate_dirichlet, laplacian
from gridapsolvers_tpu_torch.linear import AMGSolver, CGSolver, ChebyshevSmoother
from gridapsolvers_tpu_torch.linear.gmg import gmg_from_hierarchy
from gridapsolvers_tpu_torch.multilevel import cartesian_hierarchy
from gridapsolvers_tpu_torch.ops import banded_stencil, ell_spmv

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _compiled_jax_chebyshev_setups(request):
    """The JAX references' Chebyshev smoothers set up compiled
    (`jitted_jax_chebyshev_setups`), but in the true-f32 check: there JAX
    sets up eagerly, as in a process of its own (compiled, its f32 set-up
    rounds otherwise)."""
    if request.node.name == "test_amg_cg_f32_16cubed_takes_6_iterations":
        yield
        return
    with jitted_jax_chebyshev_setups():
        yield


VCYCLE_RTOL = 1e-10
HIST_RTOL = 1e-8
LMAX_RTOL = 1e-12


@functools.cache
def _hierarchies(nc):
    """(JAX problem, JAX state, port problem, port state) at nc^3 cells,
    f64, coarse_size 400, built once per module run."""
    jp = j_poisson_problem((nc,) * 3)
    jst = JAMG(coarse_size=400, engine="ell").setup(jp.A)
    p = poisson_problem((nc,) * 3, device="cpu")
    st = AMGSolver(coarse_size=400).setup(p.A)
    return jp, jst, p, st


def _eq_ell(A, jA):
    assert isinstance(A, ELLMatrix) and A.shape == jA.shape
    np.testing.assert_array_equal(A.values.numpy(), np.asarray(jA.values))
    np.testing.assert_array_equal(A.cols.numpy(), np.asarray(jA.cols))


def _spec(op):
    """A JAX level operator or transfer as numpy fields for convert.amg_state."""
    if hasattr(op, "bands"):
        return {"bands": np.asarray(op.bands), "offsets": op.offsets,
                "grid_shape": op.grid_shape, "periodic": op.periodic}
    return {"values": np.asarray(op.values), "cols": np.asarray(op.cols), "ncols": op.ncols}


def _carry(jst):
    """The JAX AMG state's operators, λ bounds and coarse inverse in the port."""
    return convert.amg_state(
        [_spec(m) for m in jst["mats"]], [_spec(m) for m in jst["P"]],
        [_spec(m) for m in jst["R"]], [float(s["lmax"]) for s in jst["sm"]],
        [float(s["lmin"]) for s in jst["sm"]], np.asarray(jst["coarse"]["inv"]), device="cpu",
    )


def _close(y, y_ref, rtol):
    y_ref = np.asarray(y_ref)
    np.testing.assert_allclose(np.asarray(y), y_ref, rtol=0, atol=rtol * np.abs(y_ref).max())


# ---------------------------------------------------------- hierarchy -----


@pytest.mark.parametrize("nc", [12, 16])
def test_hierarchy_matches_jax(nc):
    """Level sizes, and every level's, P's and R's values and columns."""
    jp, jst, p, st = _hierarchies(nc)
    sizes = [m.shape[0] for m in st["mats"]]
    assert sizes == [m.shape[0] for m in jst["mats"]]
    assert len(sizes) >= 2 and sizes[0] == (nc + 1) ** 3
    for A, jA in zip(st["mats"][1:], jst["mats"][1:]):
        _eq_ell(A, jA)
    for key in ("P", "R"):
        assert len(st[key]) == len(jst[key]) == len(sizes) - 1
        for A, jA in zip(st[key], jst[key]):
            assert A.shape[0] != A.shape[1]
            _eq_ell(A, jA)
    for s, js in zip(st["sm"], jst["sm"]):
        np.testing.assert_allclose(s["lmax"], float(js["lmax"]), rtol=LMAX_RTOL)
        np.testing.assert_allclose(s["lmin"], float(js["lmin"]), rtol=LMAX_RTOL)
        _close(s["inv_diag"].numpy(), js["inv_diag"], 1e-15)
    _close(st["coarse"]["inv"].numpy(), jst["coarse"]["inv"], 1e-12)


def test_near_nullspace_hierarchy_matches_jax():
    """Candidate vectors (the GAMG near-nullspace hook) steer the finest
    aggregation: two candidates, constants and x, on 2D Poisson."""
    nc = (24, 24)
    jp = j_poisson_problem(nc)
    p = poisson_problem(nc, device="cpu")
    xs = np.tile(np.linspace(0.0, 1.0, nc[0] + 1), nc[1] + 1)
    cand = np.stack([np.ones(p.n), xs], axis=1)
    jst = JAMG(coarse_size=60, near_nullspace=cand, engine="ell").setup(jp.A)
    st = AMGSolver(coarse_size=60, near_nullspace=cand).setup(p.A)
    assert len(st["mats"]) == len(jst["mats"]) >= 3
    assert st["pattern"].P0s[0].getnnz(axis=1).max() == 2  # two coarse dofs an aggregate
    for key in ("P", "R"):
        for A, jA in zip(st[key], jst[key]):
            _eq_ell(A, jA)
    for A, jA in zip(st["mats"][1:], jst["mats"][1:]):
        _eq_ell(A, jA)
    b = np.random.default_rng(4).normal(size=p.n)
    _close(AMGSolver(coarse_size=60, near_nullspace=cand).apply(st, torch.from_numpy(b)).numpy(),
           JAMG(coarse_size=60, near_nullspace=cand, engine="ell").apply(jst, jnp.asarray(b)),
           VCYCLE_RTOL)


def test_finest_level_stays_stencil():
    """A StencilMatrix system stays the finest cycle operator (kernel K2 on
    the card); the same system as an ELL gives the same V-cycle."""
    _, _, p, st = _hierarchies(12)
    assert st["mats"][0] is p.A and isinstance(p.A, StencilMatrix)
    assert st["sm"][0]["A"] is p.A
    assert all(isinstance(m, ELLMatrix) for m in st["mats"][1:])
    amg = AMGSolver(coarse_size=400)
    st_ell = amg.setup(p.A.to_ell())
    assert isinstance(st_ell["mats"][0], ELLMatrix)
    b = torch.from_numpy(np.random.default_rng(1).normal(size=p.n))
    _close(amg.apply(st_ell, b).numpy(), amg.apply(st, b).numpy(), 1e-12)


# ------------------------------------------------------------ V-cycle -----


def test_vcycle_matches_jax():
    """One V-cycle on the JAX state's own operators carried across, and on
    the port's own hierarchy."""
    jp, jst, p, st = _hierarchies(16)
    jamg, amg = JAMG(coarse_size=400, engine="ell"), AMGSolver(coarse_size=400)
    b = np.random.default_rng(2).normal(size=p.n)
    z_jax = np.asarray(jamg.apply(jst, jnp.asarray(b)))
    carried = _carry(jst)
    assert isinstance(carried["mats"][0], StencilMatrix)
    _close(amg.apply(carried, torch.from_numpy(b)).numpy(), z_jax, VCYCLE_RTOL)
    _close(amg.apply(st, torch.from_numpy(b)).numpy(), z_jax, VCYCLE_RTOL)
    # a tuple vector is raveled and unraveled at the boundary
    parts = (torch.from_numpy(b[:100]), torch.from_numpy(b[100:]))
    z_parts = amg.apply(st, parts)
    _close(torch.cat(z_parts).numpy(), z_jax, VCYCLE_RTOL)


def test_update_reproduces_setup():
    """update() reuses the aggregation pattern: the same operators and the
    same V-cycle as setup(); a new system operator becomes level 0."""
    _, _, p, st = _hierarchies(12)
    amg = AMGSolver(coarse_size=400)
    st2 = amg.update(st, p.A)
    assert st2["pattern"] is st["pattern"] and st2["mats"][0] is p.A
    for key in ("mats", "P", "R"):
        for A, A2 in zip(st[key][1:] if key == "mats" else st[key],
                         st2[key][1:] if key == "mats" else st2[key]):
            torch.testing.assert_close(A2.values, A.values, rtol=0, atol=0)
            torch.testing.assert_close(A2.cols, A.cols, rtol=0, atol=0)
    b = torch.from_numpy(np.random.default_rng(3).normal(size=p.n))
    torch.testing.assert_close(amg.apply(st2, b), amg.apply(st, b), rtol=0, atol=0)
    A2 = StencilMatrix(p.A.bands * 1.5, p.A.offsets, p.A.grid_shape)
    st3 = amg.update(st, A2)
    assert st3["mats"][0] is A2
    _close(amg.apply(st3, b).numpy(), amg.apply(st, b).numpy() / 1.5, 1e-10)


# ----------------------------------------------------------------- CG -----


def test_amg_cg_matches_jax():
    """CG + AMG: equal iteration count and flag, residual histories to
    1e-8; on CPU tensors every operator apply runs a plain version, and
    the counts follow the code (the formulas chip_smoke.py asserts for
    the kernels): with L levels and Chebyshev degree k,
    K2 = (n+1)(2k+2), K3 = (n+1)((L-2)(2k+1) + 1 + 2(L-1)) in the solve."""
    jp, jst, p, _ = _hierarchies(16)
    jcg = JCG(Pl=JAMG(coarse_size=400, engine="ell"), rtol=1e-8, maxiter=60)
    jx, jstats = jsolve(jcg, {"A": jp.A, "Pl": jst}, jp.b)
    cg = CGSolver(Pl=AMGSolver(coarse_size=400), rtol=1e-8, maxiter=60)
    counters = (banded_stencil.counts, ell_spmv.counts)
    before = [(c.kernel, c.plain) for c in counters]
    state = cg.setup(p.A)
    L, k = len(state["Pl"]["mats"]), ChebyshevSmoother().degree
    lanczos = ChebyshevSmoother().lanczos_iters
    setup = [(c.kernel - b[0], c.plain - b[1]) for c, b in zip(counters, before)]
    assert setup == [(0, lanczos), (0, lanczos * (L - 2))]
    x, stats = cg.solve(state, p.b)
    solve = [(c.kernel - b[0], c.plain - b[1] - s[1])
             for c, b, s in zip(counters, before, setup)]
    n = stats.niter
    assert solve == [(0, (n + 1) * (2 * k + 2)),
                     (0, (n + 1) * ((L - 2) * (2 * k + 1) + 1 + 2 * (L - 1)))]
    assert n == int(jstats.niter) and int(stats.flag) == int(jstats.flag)
    assert stats.converged()
    np.testing.assert_allclose(stats.residuals[: n + 1].numpy(),
                               np.asarray(jstats.residuals)[: n + 1], rtol=HIST_RTOL)
    _close(x.numpy(), jx, 1e-8)
    assert float(p.l2_error(x)) < 1e-5


def test_amg_as_gmg_coarsest_solver_matches_jax():
    """AMG as the GMG coarsest-level solver (the reference's scalability
    configuration: GMG fine levels + GAMG coarse solve), as the JAX
    package's own test runs it."""
    nc = (64, 64)
    jp = j_poisson_problem(nc)
    jgmg = j_gmg_from_hierarchy(
        j_hierarchy(nc, 2), lambda m: j_eliminate(j_laplacian(m), m.boundary_vertex_mask()),
        smoother=JCheby(degree=3), coarsest_solver=JAMG(coarse_size=100, ncycles=2, engine="ell"),
    )
    jcg = JCG(Pl=jgmg, rtol=1e-8, maxiter=40)
    jx, jstats = jsolve(jcg, jcg.setup(jp.A), jp.b)

    p = poisson_problem(nc, device="cpu")
    gmg = gmg_from_hierarchy(
        cartesian_hierarchy(nc, 2),
        lambda m: eliminate_dirichlet(laplacian(m, device="cpu"), m.boundary_vertex_mask()),
        smoother=ChebyshevSmoother(degree=3),
        coarsest_solver=AMGSolver(coarse_size=100, ncycles=2), device="cpu",
    )
    cg = CGSolver(Pl=gmg, rtol=1e-8, maxiter=40)
    x, stats = cg.solve(cg.setup(p.A), p.b)
    assert stats.converged() and stats.niter == int(jstats.niter)
    np.testing.assert_allclose(stats.residuals[: stats.niter + 1].numpy(),
                               np.asarray(jstats.residuals)[: stats.niter + 1], rtol=HIST_RTOL)
    assert float(p.l2_error(x)) < 1e-5


_F32_DRIVER = r"""
import json
import jax
import numpy as np
import torch
from gridapsolvers_tpu.fem import poisson_problem as j_poisson_problem
from gridapsolvers_tpu.linear import CGSolver as JCG
from gridapsolvers_tpu.linear.amg import AMGSolver as JAMG
from gridapsolvers_tpu_torch.fem import poisson_problem
from gridapsolvers_tpu_torch.linear import AMGSolver, CGSolver

torch.set_num_threads(1)
jp = j_poisson_problem((16,) * 3, dtype=np.float32)
jcg = JCG(Pl=JAMG(coarse_size=400, engine="ell"), rtol=1e-6, maxiter=60)
jst0 = jcg.setup(jp.A)
jx, jst = jax.jit(lambda b: jcg.solve(jst0, b))(jp.b)   # eagerly: op by op, slower
p = poisson_problem((16,) * 3, dtype=torch.float32, device="cpu")
cg = CGSolver(Pl=AMGSolver(coarse_size=400), rtol=1e-6, maxiter=60)
x, st = cg.solve(cg.setup(p.A), p.b)
print("AMG_F32 " + json.dumps({
    "jax": [int(jst.niter), int(jst.flag), str(np.asarray(jx).dtype), float(jp.l2_error(jx))],
    "port": [st.niter, int(st.flag), str(x.dtype), float(p.l2_error(x))],
    "x_diff": float(np.abs(x.numpy() - np.asarray(jx)).max() / np.abs(np.asarray(jx)).max()),
}))
"""


def test_amg_cg_f32_16cubed_takes_6_iterations():
    """The slice in true f32 (JAX with x64 off, `run_in_f32`): both
    packages take 6 iterations to rtol 1e-6 and reach the same solution to
    f32 round-off."""
    out = run_in_f32(_F32_DRIVER)
    line = [ln for ln in out.splitlines() if ln.startswith("AMG_F32 ")]
    assert line, out[-1500:]
    res = json.loads(line[-1].split(" ", 1)[1])
    assert res["jax"][:3] == [6, 2, "float32"], res     # 2: CONVERGED_RTOL
    assert res["port"][:3] == [6, 2, "torch.float32"], res
    assert res["x_diff"] < 1e-4, res
    assert res["port"][3] < 1e-5, res


# -------------------------------------------------------- device rule -----


def test_constructors_default_to_the_card():
    """Without `device`, a constructor asks for CUDA; here there is none,
    so it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the rule is for machines without it")
    import scipy.sparse as sp

    from gridapsolvers_tpu_torch.algebra import ell_from_scipy

    with pytest.raises(RuntimeError, match="cuda"):
        poisson_problem((4, 4, 4))
    with pytest.raises(RuntimeError, match="cuda"):
        ell_from_scipy(sp.eye(5, format="csr"))
    with pytest.raises(RuntimeError, match="cuda"):
        convert.ell_matrix(np.ones((3, 1)), np.zeros((3, 1)), 1)
