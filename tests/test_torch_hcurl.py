"""The port's H(curl) machinery and AMS preconditioner against the JAX
package, in f64 on the CPU.

- Assembly: the edge masses, the discrete gradient G, the nodal
  interpolation Π, the discrete curl C, the curl-curl blocks and the
  boundary masks equal exactly (scipy) at 6 x 5 and 4 x 5 x 6 cells; the
  de Rham identity C·G = 0 to 1e-12; `curlcurl_operator`'s ELL blocks
  with equal columns and values to 1e-14 of their largest entry; and the
  port's device G, Gᵀ, Π_c and Π_cᵀ (from the AMS state) equal to the
  JAX state's, to 1e-14.
- One AMS apply (Chebyshev(3) on the edges, AMG on GᵀAG and on each
  Π_cᵀAΠ_c) at 16^2 and 8^3 cells, alpha in {1, 100}: to 1e-10 of max|z|,
  but for 16^2 at alpha = 1, held to 1e-3 (read: 1.7e-4). There the nodal
  AMG's coarsest operator is singular in both packages (constants lie in
  the kernel of GᵀAG; cond 9.5e15) and its dense inverse amplifies each
  LAPACK's round-off along that kernel; G removes most, not all, of it.
- `update` on A scaled by 2 (the pattern-reusing refresh), one apply
  against the JAX solver's `update`, the same tolerances.
- CG + AMS, rtol 1e-8, maxiter 100, at the JAX test's sizes (16^2 and
  8^3, alpha in {1, 100}): iteration counts and flags equal (each <= 40,
  `tests/test_hcurl.py`), residual histories to rtol 1e-7 above 1e-12 of
  the initial residual (read: up to 1.8e-8 at 8^3, alpha = 100: round-off
  through the AMG coarse inverses grows over 25 iterations), but 5e-2 for the singular case above (read:
  3.8e-2), x to 1e-6 of max|x| (that case 1e-2).

Each case's JAX AMS set-up (host AMG, eager Lanczos) is built once and
shared by both tests; the JAX solves run under `jax.jit`.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jax_reference_jit import jitted_jax_chebyshev_setups, jitted_jax_dense
from gridapsolvers_tpu import linear as jl
from gridapsolvers_tpu.fem import hcurl as jh

from gridapsolvers_tpu_torch import convert
from gridapsolvers_tpu_torch import linear as tl
from gridapsolvers_tpu_torch.fem import hcurl as th

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _compiled_jax_chebyshev_setups():
    """The JAX references' Chebyshev smoothers set up, and their
    `ELLMatrix.todense` runs, compiled (`jitted_jax_chebyshev_setups`,
    `jitted_jax_dense`)."""
    with jitted_jax_chebyshev_setups(), jitted_jax_dense():
        yield

EXACT_RTOL = 1e-14
DERHAM_ATOL = 1e-12
APPLY_RTOL = 1e-10
HIST_RTOL = 1e-7
HIST_FLOOR = 1e-12   # of the initial residual
X_RTOL = 1e-6
# the 16^2, alpha = 1 case: singular nodal coarse operator (module doc)
SINGULAR = ((16, 16), 1.0)
SINGULAR_APPLY_RTOL = 1e-3
SINGULAR_HIST_RTOL = 5e-2
SINGULAR_X_RTOL = 1e-2
CASES = (((16, 16), 1.0), ((16, 16), 100.0), ((8, 8, 8), 1.0), ((8, 8, 8), 100.0))


def _flat(x):
    if isinstance(x, (tuple, list)):
        return np.concatenate([_flat(v) for v in x])
    return np.ravel(np.asarray(x, dtype=np.float64))


def _close(y, y_ref, rtol):
    y, y_ref = _flat(y), _flat(y_ref)
    scale = np.max(np.abs(y_ref))
    assert y.shape == y_ref.shape and scale > 0
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=rtol * scale)


def _same_ell(A, jA):
    assert A.ncols == jA.ncols
    np.testing.assert_array_equal(A.cols.numpy(), np.asarray(jA.cols))
    _close(A.values, np.asarray(jA.values), EXACT_RTOL)


def _same_scipy(a, b):
    assert (a is None) == (b is None)
    assert a is None or (a.shape == b.shape and abs(a - b).max() == 0)


@functools.lru_cache(maxsize=None)
def _case(nc, alpha):
    """Both packages' operator, masks, AMS solver and AMS set-up, and a
    seeded free rhs, for one case."""
    A, free, ams = th.make_ams(nc, alpha=alpha, device="cpu")
    jA, jfree, jams = jh.make_ams(nc, alpha=alpha)
    rng = np.random.default_rng(0)
    b = tuple(rng.normal(size=f.shape[0]) * np.asarray(f) for f in jfree)
    return A, free, ams, ams.setup(A), jA, jfree, jams, jams.setup(jA), b


def test_curlcurl_blocks_transfers_and_ams_apply_equal_jax():
    for nc in ((6, 5), (4, 5, 6)):
        for fn in ("edge_mass", "discrete_gradient", "nodal_interpolation",
                   "edge_boundary_masks"):
            for a, b in zip(getattr(th, fn)(nc), getattr(jh, fn)(nc), strict=True):
                if fn == "edge_boundary_masks":
                    np.testing.assert_array_equal(a, b)
                else:
                    _same_scipy(a, b)
        C, jC, G = th.discrete_curl(nc), jh.discrete_curl(nc), th.discrete_gradient(nc)
        if len(nc) == 2:
            for a, b in zip(C, jC, strict=True):
                _same_scipy(a, b)
            assert abs(C[0] @ G[0] + C[1] @ G[1]).max() < DERHAM_ATOL
        else:
            for f in range(3):
                for a, b in zip(C[f], jC[f], strict=True):
                    _same_scipy(a, b)
                assert abs(sum(C[f][e] @ G[e] for e in range(3) if C[f][e] is not None)).max() < DERHAM_ATOL
        S, jS = th.curlcurl_system(nc, 3.0, 2.0), jh.curlcurl_system(nc, 3.0, 2.0)
        for row, jrow in zip(S["blocks"], jS["blocks"], strict=True):
            for a, b in zip(row, jrow, strict=True):
                _same_scipy(a, b)
        A, free, _ = th.curlcurl_operator(nc, 3.0, 2.0, device="cpu")
        jA, jfree, _ = jh.curlcurl_operator(nc, 3.0, 2.0)
        for row, jrow in zip(A.blocks, jA.blocks, strict=True):
            for a, b in zip(row, jrow, strict=True):
                _same_ell(a, b)
        _close(free, jfree, EXACT_RTOL)

    for nc, alpha in CASES:
        A, free, ams, st, jA, jfree, jams, jst, b = _case(nc, alpha)
        for key in ("G", "GT"):
            _same_ell(st[key], jst[key])
        for key in ("Pi", "PiT"):
            for a, ja in zip(st[key], jst[key], strict=True):
                _same_ell(a, ja)
        rtol = SINGULAR_APPLY_RTOL if (nc, alpha) == SINGULAR else APPLY_RTOL
        r = tuple(torch.from_numpy(v) for v in b)
        jr = tuple(jnp.asarray(v) for v in b)
        _close(ams.apply(st, r), jax.jit(lambda v: jams.apply(jst, v))(jr), rtol)
        if len(nc) == 3 and alpha == 1.0:
            # the pattern-reusing refresh on A scaled by 2, through the
            # converter: both packages refresh the same operator
            spec = {"blocks": [[{"values": 2.0 * np.asarray(blk.values),
                                 "cols": np.asarray(blk.cols), "ncols": blk.ncols}
                                for blk in row] for row in jA.blocks]}
            A2, _, _ = convert.curlcurl_operator(spec, jfree, jams.system, device="cpu")
            jA2 = type(jA)(tuple(tuple(type(blk)(2.0 * blk.values, blk.cols, blk.ncols)
                                       for blk in row) for row in jA.blocks))
            ams2 = th.AMSSolver(system=jams.system)
            jst2 = jams.update(jst, jA2)
            _close(ams2.apply(ams2.update(st, A2), r), jax.jit(lambda v: jams.apply(jst2, v))(jr),
                   APPLY_RTOL)


def test_ams_cg_histories_equal_jax():
    for nc, alpha in CASES:
        A, free, ams, st, jA, jfree, jams, jst, b = _case(nc, alpha)
        singular = (nc, alpha) == SINGULAR
        s = tl.CGSolver(Pl=ams, rtol=1e-8, maxiter=100)
        x, stats = s.solve({"A": A, "Pl": st}, tuple(torch.from_numpy(v) for v in b))
        js = jl.CGSolver(Pl=jams, rtol=1e-8, maxiter=100)
        jstate = {"A": jA, "Pl": jst}
        jx, jstats = jax.jit(lambda v: js.solve(jstate, v))(tuple(jnp.asarray(v) for v in b))
        assert stats.niter == int(jstats.niter) <= 40, (nc, alpha)
        assert int(stats.flag) == int(jstats.flag) and stats.converged(), (nc, alpha)
        k = stats.niter
        h, jhist = stats.residuals.numpy()[: k + 1], np.asarray(jstats.residuals)[: k + 1]
        np.testing.assert_allclose(h, jhist, rtol=SINGULAR_HIST_RTOL if singular else HIST_RTOL,
                                   atol=HIST_FLOOR * jhist[0])
        _close(x, jx, SINGULAR_X_RTOL if singular else X_RTOL)
