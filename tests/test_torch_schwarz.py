"""The port's variable-coefficient Q1 assembly and one- and two-level
(GenEO) Schwarz against the JAX package, in f64 on the CPU.

- `laplacian_var`: bands equal to 1e-14 of their largest entry, open and
  periodic, and kappa = c gives c * `laplacian` to the same tolerance;
  `assemble_poisson_stencil` / `poisson_stencil` and `eliminate_dirichlet`
  likewise; `slab_neumann_matrices` equal to 1e-14.
- Schwarz on -div(kappa grad u), 32 x 8 cells, kappa = 1e4 in cell column
  2, slabs of overlap 2, ns in {2, 4}, nev 2: the one-level and two-level
  applies z = P r to 1e-10 of max|z| (never the coarse basis Zp itself:
  eigenvectors are fixed only up to sign, so P r is compared, and each
  case asserts the gap lambda_nev < lambda_{nev+1} that makes P r unique);
  the port's GenEO eigenvalues against scipy's generalized `eigh` of the
  same pencils built from the JAX operator, to rtol 1e-8; `update` after a
  kappa change against the JAX solver set up at the new kappa, 1e-10.
- CG preconditioned by each solver (rtol 1e-8, maxiter 200): iteration
  counts and flags equal, residual histories to rtol 1e-8 above 1e-12 of
  the initial residual, x to 1e-8 of max|x|; the one-level solver takes
  more iterations than the two-level one. The nested coarse solver (CG +
  Jacobi at rtol 1e-10 on A0, flexible CG outside) against dense LU and
  against JAX, on the channel problem (ns = 4, Neumann matrices).

The JAX solves run under `jax.jit` (its eager CG dispatches op by op).
The JAX package's Neumann matrices and its solvers' set-ups on the channel
problem are made once and shared by the two tests (`_jax_setup`); its
solvers take its own Neumann matrices, which the first test holds equal to
the port's to 1e-14. The two tests loop over their cases (pytest-xdist's
loadfile scheduler queues files of few tests last).
"""
import numpy as np
import pytest
import scipy.linalg
import torch

import jax
import jax.numpy as jnp

from jax_reference_jit import jitted_jax_dense
from gridapsolvers_tpu import linear as jl
from gridapsolvers_tpu.algebra.stencil import poisson_stencil as j_poisson_stencil
from gridapsolvers_tpu.fem import assembly as j_asm
from gridapsolvers_tpu.fem.mesh import CartesianMesh as JMesh

from gridapsolvers_tpu_torch import linear as tl
from gridapsolvers_tpu_torch.algebra.stencil import poisson_stencil
from gridapsolvers_tpu_torch.fem import assembly as asm
from gridapsolvers_tpu_torch.fem import assemble_poisson_stencil
from gridapsolvers_tpu_torch.fem.mesh import CartesianMesh
from gridapsolvers_tpu_torch.linear.schwarz import slab_patches

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _compiled_jax_dense():
    """The JAX package's `ELLMatrix.todense` runs compiled
    (`jitted_jax_dense`)."""
    with jitted_jax_dense():
        yield


EXACT_RTOL = 1e-14
APPLY_RTOL = 1e-10
EIG_RTOL = 1e-8
HIST_RTOL = 1e-8
HIST_FLOOR = 1e-12   # of the initial residual
X_RTOL = 1e-8
NC = (32, 8)
NEV = 2


def _close(y, y_ref, rtol):
    y, y_ref = np.asarray(y, dtype=np.float64), np.asarray(y_ref, dtype=np.float64)
    scale = np.max(np.abs(y_ref))
    assert y.shape == y_ref.shape and scale > 0
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=rtol * scale)


def _channel():
    kap = np.ones(NC)
    kap[:, 2] = 1e4
    return kap


def _problem(kap):
    """(port mesh, port A, JAX mesh, JAX A, rhs): -div(kap grad u) with the
    boundary eliminated, a seeded rhs zero on the boundary."""
    mesh, jmesh = CartesianMesh(NC, (0, 1, 0, 1)), JMesh(NC, (0, 1, 0, 1))
    mask = mesh.boundary_vertex_mask()
    A = asm.eliminate_dirichlet(asm.laplacian_var(mesh, kap, device="cpu"), mask)
    jA = j_asm.eliminate_dirichlet(j_asm.laplacian_var(jmesh, kap), mask)
    b = np.random.default_rng(0).normal(size=A.n) * (~mask.reshape(-1))
    return mesh, A, jmesh, jA, b


# the JAX package's Schwarz set-ups on the channel problem, shared by the
# two tests (each a few seconds of eager eigensolves): key -> (jP, state)
_JAX_SETUPS = {}


def _jax_setup(key, make, jA):
    """The JAX solver `make()` set up on jA, once per key."""
    if key not in _JAX_SETUPS:
        jP = make()
        _JAX_SETUPS[key] = (jP, jP.setup(jA))
    return _JAX_SETUPS[key]


def _channel_solvers(ns, jN):
    """Keys and makers of the JAX one-level, two-level (Neumann matrices jN)
    and algebraic two-level solvers with ns slabs."""
    return {("one", ns): lambda: jl.SchwarzLinearSolver(ns, 2),
            ("two", ns): lambda: jl.TwoLevelSchwarzSolver(ns, 2, NEV, neumann_matrices=jN),
            ("algebraic", ns): lambda: jl.TwoLevelSchwarzSolver(ns, 2, NEV)}


def _solve(P, A, b, jP, jA, maxiter=200, flexible=False, jstate=None):
    """CG with P (port) and jP (JAX, jitted; set up on jA, or `jstate`),
    both from zero."""
    s = tl.CGSolver(Pl=P, rtol=1e-8, maxiter=maxiter, flexible=flexible)
    x, stats = s.solve(s.setup(A), torch.from_numpy(np.asarray(b)))
    js = jl.CGSolver(Pl=jP, rtol=1e-8, maxiter=maxiter, flexible=flexible)
    jst = js.setup(jA) if jstate is None else {"A": jA, "Pl": jstate}
    jx, jstats = jax.jit(lambda v: js.solve(jst, v))(jnp.asarray(b))
    assert stats.niter == int(jstats.niter) and int(stats.flag) == int(jstats.flag)
    k = stats.niter
    h, jh = stats.residuals.numpy()[: k + 1], np.asarray(jstats.residuals)[: k + 1]
    np.testing.assert_allclose(h, jh, rtol=HIST_RTOL, atol=HIST_FLOOR * jh[0])
    _close(x.numpy(), jx, X_RTOL)
    return stats


_JAX_NEUMANN = {}


def _jax_neumann(jmesh, ns, kap):
    """The JAX package's slab Neumann matrices of the channel problem, once
    per slab count."""
    if ns not in _JAX_NEUMANN:
        _JAX_NEUMANN[ns] = jl.slab_neumann_matrices(jmesh, ns, overlap=2, kappa=kap)
    return _JAX_NEUMANN[ns]


def _geneo_eigenvalues(jA, N, ns):
    """The nev + 1 smallest eigenvalues of each subdomain's pencil (N_i,
    D_i A_i D_i + 1e-12 I) on its slab dofs, by scipy from the JAX
    operator's dense matrix."""
    topo = slab_patches(jA.grid_shape, ns, 2)
    D = np.asarray(jA.todense())
    w = 1.0 / np.maximum(topo.overlap_counts(), 1.0)
    out = []
    for s in range(ns):
        dofs = topo.dofs[s][topo.dofs[s] != topo.dummy]
        k = len(dofs)
        wd = w[dofs]
        B = wd[:, None] * D[np.ix_(dofs, dofs)] * wd[None, :] + 1e-12 * np.eye(k)
        out.append(scipy.linalg.eigh(N[s, :k, :k], B, eigvals_only=True,
                                     subset_by_index=[0, NEV]))
    return np.array(out)


def test_laplacian_var_and_schwarz_applies_equal_jax():
    rng = np.random.default_rng(3)
    # laplacian_var: open and periodic, random kappa, and kappa = const
    for periodic in ((False, False), (True, True), (True, False)):
        mesh = CartesianMesh((8, 6), (0, 1, 0, 1), periodic=periodic)
        jmesh = JMesh((8, 6), (0, 1, 0, 1), periodic=periodic)
        kap = rng.uniform(0.5, 2.0, size=(8, 6))
        A, jA = asm.laplacian_var(mesh, kap, device="cpu"), j_asm.laplacian_var(jmesh, kap)
        assert A.offsets == tuple(tuple(o) for o in jA.offsets)
        assert A.periodic == tuple(jA.periodic)
        _close(A.bands.numpy(), jA.bands, EXACT_RTOL)
        A3 = asm.laplacian_var(mesh, 3.0 * np.ones(mesh.ncells), device="cpu")
        _close(A3.bands.numpy(), 3.0 * asm.laplacian(mesh, device="cpu").bands.numpy(),
               EXACT_RTOL)
    # the constant-coefficient stencil builders
    gmask = np.zeros((9, 7), bool)
    gmask[0], gmask[-1] = True, True
    for P, jP in ((assemble_poisson_stencil((9, 7), (0.125, 1 / 6), dirichlet_mask=gmask,
                                            device="cpu"),
                   j_asm.assemble_poisson_stencil((9, 7), (0.125, 1 / 6), dirichlet_mask=gmask)),
                  (poisson_stencil((9, 7), (0.125, 1 / 6), device="cpu"),
                   j_poisson_stencil((9, 7), (0.125, 1 / 6)))):
        _close(P.bands.numpy(), jP.bands, EXACT_RTOL)

    kap = _channel()
    mesh, A, jmesh, jA, b = _problem(kap)
    _close(A.bands.numpy(), jA.bands, EXACT_RTOL)
    r = torch.from_numpy(b)
    for ns in (2, 4):
        N = tl.slab_neumann_matrices(mesh, ns, overlap=2, kappa=kap)
        jN = _jax_neumann(jmesh, ns, kap)
        _close(N, jN, EXACT_RTOL)
        makers = _channel_solvers(ns, jN)
        one = tl.SchwarzLinearSolver(ns, 2)
        jone, jst = _jax_setup(("one", ns), makers["one", ns], jA)
        _close(one.apply(one.setup(A), r).numpy(), jone.apply(jst, jnp.asarray(b)), APPLY_RTOL)
        for kind, neumann in (("two", np.array(jN)), ("algebraic", None)):
            P = tl.TwoLevelSchwarzSolver(ns, 2, NEV, neumann_matrices=neumann)
            jP, jst = _jax_setup((kind, ns), makers[kind, ns], jA)
            st = P.setup(A)
            lam = st["eigenvalues"].numpy()
            assert np.all(lam[:, NEV - 1] < 0.99 * lam[:, NEV]), lam
            if neumann is not None:
                np.testing.assert_allclose(lam, _geneo_eigenvalues(jA, jN, ns), rtol=EIG_RTOL)
            _close(P.apply(st, r).numpy(), jP.apply(jst, jnp.asarray(b)), APPLY_RTOL)

    # update after a kappa change equals the JAX solver set up at the new
    # kappa (the algebraic pencil follows the operator)
    kap2 = kap.copy()
    kap2[:, 5] = 1e3
    _, A2, _, jA2, _ = _problem(kap2)
    P = tl.TwoLevelSchwarzSolver(4, 2, NEV)
    jP = jl.TwoLevelSchwarzSolver(4, 2, NEV)
    st2 = P.update(P.setup(A), A2)
    lam = st2["eigenvalues"].numpy()
    assert np.all(lam[:, NEV - 1] < 0.99 * lam[:, NEV]), lam
    _close(P.apply(st2, r).numpy(), jP.apply(jP.setup(jA2), jnp.asarray(b)), APPLY_RTOL)
    one = tl.SchwarzLinearSolver(4, 2)
    _close(one.apply(one.update(one.setup(A), A2), r).numpy(),
           jl.SchwarzLinearSolver(4, 2).apply(jl.SchwarzLinearSolver(4, 2).setup(jA2),
                                              jnp.asarray(b)), APPLY_RTOL)


def test_schwarz_cg_histories_equal_jax():
    kap = _channel()
    mesh, A, jmesh, jA, b = _problem(kap)
    its = {}
    for ns in (2, 4):
        N = tl.slab_neumann_matrices(mesh, ns, overlap=2, kappa=kap)
        ports = {"one": tl.SchwarzLinearSolver(ns, 2),
                 "two": tl.TwoLevelSchwarzSolver(ns, 2, NEV, neumann_matrices=N),
                 "algebraic": tl.TwoLevelSchwarzSolver(ns, 2, NEV)}
        makers = _channel_solvers(ns, _jax_neumann(jmesh, ns, kap))
        for kind, P in ports.items():
            jP, jst = _jax_setup((kind, ns), makers[kind, ns], jA)
            its[ns, kind] = _solve(P, A, b, jP, jA, jstate=jst).niter
        assert its[ns, "one"] > its[ns, "two"], its
    # the JAX package's measurements at this size
    assert (its[2, "two"], its[4, "two"], its[2, "one"], its[4, "one"]) == (14, 20, 32, 200), its

    # PCHPDDM-style nesting: the coarse problem solved by CG + Jacobi (on
    # the channel problem with Neumann matrices: the JAX test's 32^2
    # constant-coefficient case has a degenerate algebraic pencil, lambda =
    # 4 repeated on its interior slabs, so its coarse space, and P r, depend
    # on the eigensolver's basis)
    N = tl.slab_neumann_matrices(mesh, 4, overlap=2, kappa=kap)
    jN = _jax_neumann(jmesh, 4, kap)
    its = {}
    for name, cs, jcs in (
        ("dense", None, None),
        ("nested", tl.CGSolver(Pl=tl.JacobiSolver(), rtol=1e-10, maxiter=100),
         jl.CGSolver(Pl=jl.JacobiSolver(), rtol=1e-10, maxiter=100)),
    ):
        # the dense coarse solver is the two-level solver of above
        jP, jst = (_jax_setup(("two", 4), _channel_solvers(4, jN)["two", 4], jA) if cs is None
                   else (jl.TwoLevelSchwarzSolver(4, 2, NEV, neumann_matrices=jN,
                                                  coarse_solver=jcs), None))
        stats = _solve(tl.TwoLevelSchwarzSolver(4, 2, NEV, neumann_matrices=N, coarse_solver=cs),
                       A, b, jP, jA, maxiter=100, flexible=True, jstate=jst)
        assert stats.converged(), name
        its[name] = stats.niter
    assert abs(its["dense"] - its["nested"]) <= 2, its
