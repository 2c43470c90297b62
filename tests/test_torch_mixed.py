"""The port's mixed-precision GMG against the JAX package: kernel K1 in
bf16 (plain version) and the reduced-precision V-cycle. The iteration
counts of the JAX package's two mixed-precision GMG tests are held in
`test_torch_mixed_iterations.py`.

Tolerances: bf16's unit roundoff is 2^-8 (3.9e-3). K1's bf16 plain
version is the f32 sum rounded once, exactly. A V-cycle apply differs
from JAX's by a few bf16 roundings: the port's K1 sums in f32 where JAX
sums in bf16, and XLA may keep f32 between fused bf16 operations. A
mixed apply (bf16 smoothing, f64 residuals) must agree to 5 x 2^-8 of its
largest entry, an all-bf16 apply to 10 x 2^-8.
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gridapsolvers_tpu.algebra.stencil import ConstStencilMatrix as JConst
from gridapsolvers_tpu.fem.assembly import laplacian_const as j_laplacian_const
from gridapsolvers_tpu.linear import ChebyshevSmoother as JCheby
from gridapsolvers_tpu.linear import DenseLUSolver as JLU
from gridapsolvers_tpu.linear.gmg import _tree_cast as j_tree_cast
from gridapsolvers_tpu.linear.gmg import gmg_from_hierarchy as j_gmg_from_hierarchy
from gridapsolvers_tpu.multilevel import cartesian_hierarchy as j_hierarchy

from gridapsolvers_tpu_torch import convert
from gridapsolvers_tpu_torch.fem import CartesianMesh
from gridapsolvers_tpu_torch.fem.assembly import laplacian_const
from gridapsolvers_tpu_torch.linear import ChebyshevSmoother, DenseLUSolver
from gridapsolvers_tpu_torch.linear.gmg import gmg_from_hierarchy
from gridapsolvers_tpu_torch.multilevel import cartesian_hierarchy
from gridapsolvers_tpu_torch.ops import const_stencil
from gridapsolvers_tpu_torch.utils import pytrees as pt

torch.set_num_threads(1)

BF16_EPS = 2.0 ** -8
MIXED_TOL = 5 * BF16_EPS
BF16_TOL = 10 * BF16_EPS
K1_VS_JAX_TOL = 4 * BF16_EPS


def _offsets(d):
    return tuple(itertools.product((-1, 0, 1), repeat=d))


def _k1_inputs(shape, weights, mask, seed=0):
    """bf16 (weights, free, x) for K1 from a seeded generator."""
    rng = np.random.default_rng(seed)
    d = len(shape)
    if weights == "laplacian":
        A = laplacian_const(CartesianMesh(tuple(m - 1 for m in shape),
                                          tuple(v for _ in shape for v in (0.0, 1.0))),
                            torch.float64, "cpu")
        w, free = A.weights, A.free
    else:
        w = torch.from_numpy(rng.normal(size=3 ** d))
        free = torch.ones(shape, dtype=torch.float64)
    if mask == "random":
        free = torch.from_numpy((rng.random(shape) < 0.7).astype(np.float64))
    x = torch.from_numpy(rng.normal(size=int(np.prod(shape))))
    return w.bfloat16(), free.bfloat16(), x.bfloat16()


# ------------------------------------------------------ (a) bf16 K1 -----


@pytest.mark.parametrize("shape", [(2, 2, 2), (9, 7, 13), (17, 17, 17), (33, 17)])
@pytest.mark.parametrize("weights,mask", [("laplacian", "dirichlet"), ("random", "random")])
def test_bf16_plain_is_f32_sum_rounded_once(shape, weights, mask):
    """The bf16 plain version is exactly the f32 plain version on the
    bf16 values (all exact in f32), rounded to bf16 once."""
    w, free, x = _k1_inputs(shape, weights, mask)
    offs = _offsets(len(shape))
    y = const_stencil.const_stencil_plain(w, free, offs, shape, x)
    y32 = const_stencil.const_stencil_plain(w.float(), free.float(), offs, shape, x.float())
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, y32.bfloat16())


@pytest.mark.parametrize("weights,mask", [("laplacian", "dirichlet"), ("random", "random")])
def test_bf16_plain_against_jax_bf16_operator(weights, mask):
    """Against the JAX package's bf16 ConstStencilMatrix (sums in bf16):
    the two differ only by where they round, within 4 x 2^-8 of max|y|."""
    shape = (9, 7, 13)
    w, free, x = _k1_inputs(shape, weights, mask)
    offs = _offsets(3)
    y = const_stencil.const_stencil_plain(w, free, offs, shape, x).double().numpy()
    jA = JConst(jnp.asarray(w.float().numpy(), jnp.bfloat16),
                jnp.asarray(free.float().numpy(), jnp.bfloat16), offs, shape)
    jy = np.asarray(jA.matvec(jnp.asarray(x.float().numpy(), jnp.bfloat16))).astype(np.float64)
    assert np.abs(y - jy).max() <= K1_VS_JAX_TOL * np.abs(jy).max()


def test_bf16_kernel_selection_and_refusals():
    """bf16 takes the marching kernel's f32 tiling on 3D grids; the CUDA
    wrapper refuses mixed dtypes before anything is built; the marching
    kernel's by-value weights are the bf16 values as floats."""
    for shape in ((129,) * 3, (65,) * 3, (17,) * 3, (5, 3, 131)):
        assert const_stencil.march_tiles(shape, torch.bfloat16) == \
            const_stencil.march_tiles(shape, torch.float32)
    assert const_stencil.march_tiles((129, 129), torch.bfloat16) is None
    w, free, x = _k1_inputs((5, 5, 5), "random", "random")
    with pytest.raises(TypeError, match="bf16"):
        const_stencil.const_stencil_cuda(w.float(), free, _offsets(3), (5, 5, 5), x)
    with pytest.raises(ValueError, match="CUDA"):
        const_stencil.const_stencil_cuda(w, free, _offsets(3), (5, 5, 5), x)
    host = const_stencil._host_weights(w)
    assert list(host) == w.float().tolist()


# ------------------------------------------- (b) the V-cycle in bf16 -----


def _f64(a):
    """A JAX array of any float dtype as float64 numpy (exact for bf16)."""
    return np.asarray(a).astype(np.float64)


def _carry_gmg_state(gmg, jst):
    """The JAX GMG state's full-precision parts, through convert.gmg_state
    into the port's GMGSolver `gmg` (which makes its own bf16 copies)."""
    return convert.gmg_state(
        gmg,
        [{"weights": _f64(m.weights), "free": _f64(m.free), "offsets": m.offsets,
          "grid_shape": m.grid_shape} for m in jst["mats"]],
        [{"inv_diag": _f64(s["inv_diag"]), "lmax": float(s["lmax"]), "lmin": float(s["lmin"])}
         for s in jst["pre"]],
        {k: np.asarray(v) if k == "piv" else _f64(v) for k, v in jst["coarse"].items()},
        [dict(fine_shape=p.fine_shape, coarse_shape=p.coarse_shape, mask_fine=_f64(p.mask_fine),
              factors=p.factors, periodic=p.periodic) for p in jst["P"]],
        [dict(fine_shape=r.fine_shape, coarse_shape=r.coarse_shape, mode=r.mode,
              mask_coarse=_f64(r.mask_coarse), mask_fine=_f64(r.mask_fine), factors=r.factors,
              periodic=r.periodic) for r in jst["R"]],
        device="cpu", dtype=torch.float64,
    )


@pytest.fixture(scope="module")
def jax_gmg_8():
    """A JAX GMG at 8^3, 3 levels, Chebyshev(4) with Gershgorin λmax and a
    dense-LU coarse solve, set up once in f64; its reduced-precision
    states are made from it as JAX's set-up makes them (`_tree_cast`)."""
    nc = 8
    jg = j_gmg_from_hierarchy(
        j_hierarchy((nc,) * 3, 3), j_laplacian_const,
        smoother=JCheby(degree=4, eig_method="gershgorin"), coarsest_solver=JLU(),
        dtype=jnp.float64,
    )
    return nc, jg, jg.setup(j_laplacian_const(j_hierarchy((nc,) * 3, 3).meshes[0]))


@pytest.mark.parametrize("mixed", [True, False], ids=["mixed", "all_bf16"])
def test_reduced_precision_vcycle_matches_jax(jax_gmg_8, mixed):
    """One V-cycle apply at 8^3: mixed (bf16 smoothing, f64 residuals,
    transfers and coarse solve) and all bf16 (the dense-LU coarse solve on
    bf16 factors, solved in f32 here). The state carried from JAX and the
    port's own set-up agree bit for bit in their bf16 parts: the walker
    rounds the λ bounds through bf16 as JAX's casts its 0-d bounds."""
    nc, jg, jst64 = jax_gmg_8
    jg = dataclasses.replace(jg, compute_dtype=jnp.bfloat16, mixed=mixed)
    if mixed:
        jst = {**jst64, "pre16": j_tree_cast(jst64["pre"], jnp.bfloat16),
               "post16": j_tree_cast(jst64["post"], jnp.bfloat16)}
    else:
        jst = j_tree_cast(jst64, jnp.bfloat16)
    h = cartesian_hierarchy((nc,) * 3, 3)
    g = gmg_from_hierarchy(
        h, lambda m: laplacian_const(m, torch.float64, "cpu"),
        smoother=ChebyshevSmoother(degree=4, eig_method="gershgorin"),
        coarsest_solver=DenseLUSolver(), dtype=torch.float64, device="cpu",
        compute_dtype=torch.bfloat16, mixed=mixed,
    )
    state = _carry_gmg_state(g, jst)
    own = g.setup(laplacian_const(h.meshes[0], torch.float64, "cpu"))
    key = "pre16" if mixed else "pre"
    for s, o in zip(state[key], own[key]):
        assert s["inv_diag"].dtype == torch.bfloat16
        assert (s["lmax"], s["lmin"]) == (o["lmax"], o["lmin"])
        assert torch.equal(s["inv_diag"], o["inv_diag"])
    r = np.random.default_rng(0).normal(size=(nc + 1) ** 3)
    jy = _f64(jg.apply(jst, jnp.asarray(r)))
    for st in (state, own):
        y = g.apply(st, torch.from_numpy(r))
        assert y.dtype == torch.float64
        err = np.abs(y.numpy() - jy).max() / np.abs(jy).max()
        assert err <= (MIXED_TOL if mixed else BF16_TOL), err


def test_tree_cast_walks_operators_and_rounds_bounds():
    """tree_cast casts floating tensors in dicts, lists, tuples and
    operator dataclasses, leaves integer tensors alone, and rounds the
    Python-float spectrum bounds through bf16."""
    A = laplacian_const(CartesianMesh((4, 4, 4), (0.0, 1.0) * 3), torch.float32, "cpu")
    piv = torch.arange(5, dtype=torch.int32)
    state = {"A": A, "lmax": 1.0 + 2.0 ** -10, "piv": piv, "list": [A.free], "n": 3}
    out = pt.tree_cast(state, torch.bfloat16)
    assert out["A"].weights.dtype == torch.bfloat16 and out["A"].free.dtype == torch.bfloat16
    assert out["A"].offsets == A.offsets and out["A"].grid_shape == A.grid_shape
    assert out["piv"] is piv and out["n"] == 3
    assert out["lmax"] == 1.0 and out["list"][0].dtype == torch.bfloat16
    assert A.weights.dtype == torch.float32  # the original is untouched
