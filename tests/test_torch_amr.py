"""The port's block-structured AMR (`multilevel.adaptive`, `multilevel.
forest`) and `utils.timing` against the JAX package, in f64 on the CPU.

test_amr_operators_equal_jax:
- `estimate_cells` (16^2, a Gaussian bump; 6 x 5 x 4, seeded values) to
  1e-13 of max|est|; `mark_box`, `mark_boxes` (theta, thresh, align, gap 0
  through `repair_junctions`, max_boxes), `repair_junctions` (a T of three
  boxes, separated boxes) give equal boxes; a T-junction forest raises
  ValueError("...rim...") in both.
- A level-2 box on its parent box's edge: the port's single-box operator
  equals its forest operator on the same boxes (matvec and diag to
  1e-12) and is symmetric to 1e-12; the JAX package's single-box matvec
  parts from it by more than 0.1 there (it hands a parent only each
  level's own ring residual, not what the level's child added; ROADMAP
  queue 3). Everywhere else below the two packages agree.
- `composite_system` (3 levels on an 8^2 base, with kappa) and
  `forest_composite_system` (two separated boxes and a face-adjacent seam
  pair in 2D; a seam pair at 8^3): bands, active and ring masks, seams,
  boxes and rhs to 1e-13 of their largest entry (masks and metadata
  equal), `matvec` and `diag` on seeded vectors to 1e-12 of max|y| (JAX's
  compiled). The same operators carried over from JAX by
  `convert.composite_operator` / `convert.forest_composite_operator`
  apply to 1e-12 as well, and `convert.adaptive_hierarchy` /
  `convert.forest_hierarchy` give the port's own hierarchies.
- `utils.timing`: PTimer as `tests/test_interfaces.py::test_ptimer` asks,
  `fence` on CPU tensors, `trace` writing its Chrome trace.

test_amr_solves_equal_jax (CG rtol 1e-8 throughout):
- `composite_solve` with kappa on 2- and 3-level box hierarchies (8^2
  base), `forest_solve` with Jacobi and with the FAC preconditioner
  (`gmg_base=True`, flexible CG) on the two-box 16^2 forest: iterations
  and flags equal, residual histories to rtol 1e-8 above 1e-12 of the
  initial residual (FAC: its first 10 iterations, see FAC_HIST_ITS),
  every level's x to 1e-8 of max|x|. One `ForestPreconditioner.apply` (a
  GMG V-cycle per patch) on a seeded vector to 1e-10 of max|z| (the dense
  coarse LUs and the Chebyshev sums part the packages at ~1e-14).
- `adaptive_solve` (16^2, 2 levels) and `adaptive_solve_scattered`
  (16^2, two bumps, 1 round): boxes equal, and x and the field on the
  uniformly refined frame (`composite_on_finest`, `forest_on_finest`) to
  1e-8 of max|x|.

That the AMR modules and `utils.timing` import with no JAX is checked with
every port module in `tests/test_torch_darcy.py`. The JAX FAC apply and
solve run compiled, in one `jax.jit` program; its Jacobi solves run
eagerly, which at these sizes is quicker than compiling them, with the
JAX AMR modules' grid transfers and estimator compiled
(`_jitted_jax_grid_ops`).
"""
import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jax_reference_jit import jitted_jax_dense
from gridapsolvers_tpu.fem.mesh import CartesianMesh as JMesh
from gridapsolvers_tpu.multilevel import adaptive as ja
from gridapsolvers_tpu.multilevel import forest as jf
from gridapsolvers_tpu.linear import CGSolver as JCGSolver

from gridapsolvers_tpu_torch import convert
from gridapsolvers_tpu_torch.fem.mesh import CartesianMesh
from gridapsolvers_tpu_torch.multilevel import adaptive as ta
from gridapsolvers_tpu_torch.multilevel import forest as tf
from gridapsolvers_tpu_torch.utils import pytrees as tpt
from gridapsolvers_tpu_torch.utils import timing

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _compiled_jax_dense():
    """The JAX package's `ELLMatrix.todense` runs compiled
    (`jitted_jax_dense`)."""
    with jitted_jax_dense():
        yield


EXACT_RTOL = 1e-13
APPLY_RTOL = 1e-12
PRECOND_RTOL = 1e-10
HIST_RTOL = 1e-8
HIST_FLOOR = 1e-12   # of the initial residual
X_RTOL = 1e-8
# flexible CG + FAC amplifies round-off ~10x an iteration on the two-box
# forest: the JAX package's own eager and compiled solves part by 1e-9 at
# entry 10 and by up to 56% (relative) near entry 18, then meet again at
# the same count (30) and x. Its history is held over its first entries.
FAC_HIST_ITS = 10

BUMPS = ((0.25, 0.25), (0.75, 0.75))
C = 200.0


def u_two(p):
    return sum(np.exp(-C * ((p[:, 0] - b[0]) ** 2 + (p[:, 1] - b[1]) ** 2)) for b in BUMPS)


def f_two(p):
    out = 0.0
    for b in BUMPS:
        r2 = (p[:, 0] - b[0]) ** 2 + (p[:, 1] - b[1]) ** 2
        out = out + (4 * C - 4 * C * C * r2) * np.exp(-C * r2)
    return out


def f_one(p):
    r2 = (p[:, 0] - 0.7) ** 2 + (p[:, 1] - 0.7) ** 2
    return (4 * C - 4 * C * C * r2) * np.exp(-C * r2)


def f_const(p):
    return np.ones(p.shape[0])


def kappa(p):
    return 1.0 + 0.5 * np.sin(3.0 * p[:, 0]) * np.cos(2.0 * p[:, 1])


def _mesh(n, dim=2):
    dom = tuple(x for _ in range(dim) for x in (0.0, 1.0))
    return CartesianMesh((n,) * dim, dom), JMesh((n,) * dim, dom)


def _close(y, y_ref, rtol):
    y = np.concatenate([np.ravel(np.asarray(v, dtype=np.float64)) for v in y])
    y_ref = np.concatenate([np.ravel(np.asarray(v, dtype=np.float64)) for v in y_ref])
    scale = np.max(np.abs(y_ref))
    assert y.shape == y_ref.shape and scale > 0
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=rtol * scale)


@contextlib.contextmanager
def _jitted_jax_grid_ops():
    """While active, the JAX package's AMR modules call their grid
    transfers and estimator compiled, one program a shape (eagerly each
    slice, pad and add compiles on its own); nothing else of theirs
    changes."""
    names = ("prolong_slices", "restrict_slices", "estimate_cells")
    saved = [(mod, name, getattr(mod, name)) for mod in (ja, jf) for name in names
             if hasattr(mod, name)]
    for mod, name, fn in saved:
        setattr(mod, name, jax.jit(fn, static_argnums=(1,)) if name == "estimate_cells"
                else jax.jit(fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _torch(v):
    return tuple(torch.from_numpy(np.array(a)) for a in v)


def _hist_close(st, jst, its=None):
    """Iterations and flags equal; the residual history (its first `its`
    + 1 entries, or all) to HIST_RTOL above HIST_FLOOR."""
    assert st.niter == int(jst.niter) and int(st.flag) == int(jst.flag), (
        st.niter, int(jst.niter), st.flag, jst.flag)
    n = st.niter + 1 if its is None else its + 1
    h = st.residuals.numpy()[:n]
    jh = np.asarray(jst.residuals)[:n]
    keep = jh > HIST_FLOOR * jh[0]
    np.testing.assert_allclose(h[keep], jh[keep], rtol=HIST_RTOL)


def _seeded(rng, op):
    """Seeded per-level vectors (zero on pinned dofs, as CG keeps them)."""
    xs = [rng.normal(size=int(np.prod(s))) * np.asarray(a).reshape(-1)
          for s, a in zip(op.shapes, op.active)]
    return tuple(torch.from_numpy(x) for x in xs), tuple(jnp.asarray(x) for x in xs)


def _stencil_spec(A):
    return {"bands": np.asarray(A.bands), "offsets": A.offsets, "grid_shape": A.grid_shape,
            "periodic": A.periodic}


def _same_operators(op, jop, rng):
    """Level operators, masks and metadata equal; matvec and diag on seeded
    vectors; then the same through the convert functions."""
    for A, jA in zip(op.ops, jop.ops):
        assert A.offsets == tuple(map(tuple, jA.offsets)) and A.grid_shape == jA.grid_shape
        _close([A.bands], [jA.bands], EXACT_RTOL)
    for a, ja_ in zip(op.active, jop.active):
        np.testing.assert_array_equal(a.numpy().reshape(-1), np.asarray(ja_).reshape(-1))
    assert op.shapes == tuple(map(tuple, jop.shapes))
    x, jx = _seeded(rng, op)
    jy, jd = jax.jit(lambda v: (jop.matvec(v), jop.diag()))(jx)
    _close(op.matvec(x), jy, APPLY_RTOL)
    _close(op.diag(), jd, APPLY_RTOL)
    if isinstance(op, tf.ForestCompositeOperator):
        for r, jr in zip(op.ring_par, jop.ring_par):
            np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
        assert op.meta == jop.meta and op.seams == jop.seams
        carried = convert.forest_composite_operator(
            [_stencil_spec(A) for A in jop.ops], [np.asarray(a) for a in jop.active],
            [np.asarray(r) for r in jop.ring_par], jop.meta, jop.seams, jop.shapes,
            device="cpu")
    else:
        assert op.boxes == jop.boxes
        carried = convert.composite_operator(
            [_stencil_spec(A) for A in jop.ops], [np.asarray(a) for a in jop.active],
            jop.boxes, jop.shapes, device="cpu")
    _close(carried.matvec(x), jy, APPLY_RTOL)
    _close(carried.diag(), jd, APPLY_RTOL)


def _level_spec(m, lo, hi, parent=None):
    spec = {"ncells": m.ncells, "domain": m.domain, "lo": lo, "hi": hi}
    return spec if parent is None else {**spec, "parent": parent}


def _box_hierarchies(boxes, n=16):
    tb, jb = _mesh(n)
    th, jh = ta.adaptive_hierarchy(tb), ja.adaptive_hierarchy(jb)
    for lo, hi in boxes:
        th, jh = th.refine_box(lo, hi), jh.refine_box(lo, hi)
    assert convert.adaptive_hierarchy(
        [_level_spec(lv.mesh, lv.lo, lv.hi) for lv in jh.levels]).levels == th.levels
    return th, jh


def _forests(rounds, n=16, dim=2):
    """Port and JAX forests refined by each of `rounds` (a `refine`
    argument: the boxes of each finest patch)."""
    tb, jb = _mesh(n, dim)
    th, jh = tf.forest_hierarchy(tb), jf.forest_hierarchy(jb)
    for boxes in rounds:
        th, jh = th.refine(boxes), jh.refine(boxes)
    assert convert.forest_hierarchy(
        [[_level_spec(p.mesh, p.lo, p.hi, p.parent) for p in lv]
         for lv in jh.levels]).levels == th.levels
    return th, jh


TWO_BOX = [[((2, 2), (8, 8)), ((10, 10), (14, 14))]]
BOX2 = [((2, 2), (6, 6))]          # on an 8^2 base
BOX3 = BOX2 + [((2, 2), (6, 6))]
EDGE_BOX3 = BOX2 + [((0, 0), (4, 4))]   # level 2 on its parent box's edge


def test_amr_operators_equal_jax(tmp_path):
    with _jitted_jax_grid_ops():
        _operators_equal_jax(tmp_path)


def test_amr_solves_equal_jax():
    with _jitted_jax_grid_ops():
        _solves_equal_jax()


def _operators_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    # estimator and markers
    tb, jb = _mesh(16)
    u = u_two(tb.vertex_coords())
    est = ta.estimate_cells(torch.from_numpy(u), tb).numpy()
    jest = np.asarray(ja.estimate_cells(jnp.asarray(u), jb))
    _close([est], [jest], EXACT_RTOL)
    t3 = CartesianMesh((6, 5, 4), (0.0, 1.0, 0.0, 0.5, 0.0, 2.0))
    u3 = rng.normal(size=t3.num_vertices)
    _close([ta.estimate_cells(torch.from_numpy(u3), t3)],
           [ja.estimate_cells(jnp.asarray(u3), JMesh(t3.ncells, t3.domain))], EXACT_RTOL)
    for theta, pad, align in ((0.25, 1, 2), (0.5, 0, 1), (0.1, 2, 4)):
        assert ta.mark_box(est, theta, pad, align) == ja.mark_box(jest, theta, pad, align)
    for kw in (dict(theta=0.25), dict(thresh=0.3 * est.max(), align=4), dict(theta=0.05, gap=0),
               dict(theta=0.25, max_boxes=1), dict(theta=0.1, pad=0, gap=3)):
        assert tf.mark_boxes(est, **kw) == jf.mark_boxes(jest, **kw), kw
    t_boxes = [((2, 2), (8, 10)), ((8, 2), (14, 6)), ((8, 6), (14, 10))]
    sep = [((2, 2), (6, 6)), ((10, 10), (14, 14))]
    for boxes in (t_boxes, sep):
        assert tf.repair_junctions(list(boxes), (16, 16)) == jf.repair_junctions(
            list(boxes), (16, 16))
    th, jh = _forests([[t_boxes]])
    for build, h in ((tf.forest_composite_system, th), (jf.forest_composite_system, jh)):
        with pytest.raises(ValueError, match="rim"):
            build(h, f_two, device="cpu") if h is th else build(h, f_two)

    # composite operators: a 3-level box hierarchy with kappa, and forests
    th, jh = _box_hierarchies(BOX3, 8)
    op, b = ta.composite_system(th, f_two, kappa, device="cpu")
    jop, jb_ = ja.composite_system(jh, f_two, kappa)
    _close(b, jb_, EXACT_RTOL)
    _same_operators(op, jop, rng)
    # a level-2 box on its parent box's edge: the port's single-box operator
    # is the forest operator of the same boxes (exact adjoint, symmetric);
    # the JAX package's passes on only each level's own apply there
    th, jh = _box_hierarchies(EDGE_BOX3, 8)
    op, _ = ta.composite_system(th, f_two, device="cpu")
    fop, _ = tf.forest_composite_system(
        tf.forest_hierarchy(th[0].mesh).refine([EDGE_BOX3[:1]]).refine([EDGE_BOX3[1:]]), f_two,
        device="cpu")
    x, jx = _seeded(rng, op)
    y, _ = _seeded(rng, op)
    _close(op.matvec(x), fop.matvec(x), APPLY_RTOL)
    _close(op.diag(), fop.diag(), APPLY_RTOL)
    xay, yax = tpt.dot(x, op.matvec(y)), tpt.dot(y, op.matvec(x))
    assert abs(xay - yax) <= APPLY_RTOL * abs(xay)
    jop, _ = ja.composite_system(jh, f_two)
    jy = jax.jit(jop.matvec)(jx)
    assert max(float((a - b).abs().max()) for a, b in zip(op.matvec(x), _torch(jy))) > 0.1
    forests = [
        (TWO_BOX, 16, 2, f_two),
        ([[((2, 2), (8, 8)), ((8, 2), (12, 8))]], 16, 2, f_two),       # seam pair
        ([[((2, 2, 2), (4, 6, 6)), ((4, 2, 2), (6, 6, 6))]], 8, 3, f_const),
    ]
    for boxes, n, dim, f in forests:
        th, jh = _forests([boxes], n, dim)
        op, b = tf.forest_composite_system(th, f, device="cpu")
        jop, jb_ = jf.forest_composite_system(jh, f)
        _close(b, jb_, EXACT_RTOL)
        _same_operators(op, jop, rng)
        assert len(op.seams) == (0 if boxes is TWO_BOX else 1)

    # utils.timing (tests/test_interfaces.py::test_ptimer, and the rest)
    t = timing.PTimer()
    with t.phase("a"):
        sum(range(1000))
    t.tic("b", barrier=b)
    t.toc("b", barrier=b)
    assert "a" in t.data and t.data["a"] >= 0
    assert "b" in t.report()
    timing.fence((torch.ones(3), [torch.zeros(2)]))
    with timing.trace(str(tmp_path / "trace")) as prof:
        torch.ones(8).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0 and prof is not None


def _solves_equal_jax():
    # composite_solve with kappa: 2 and 3 levels on an 8^2 base
    for boxes in (BOX2, BOX3):
        th, jh = _box_hierarchies(boxes, 8)
        us, st = ta.composite_solve(th, f_two, kappa, rtol=1e-8, device="cpu")
        jus, jst = ja.composite_solve(jh, f_two, kappa, rtol=1e-8)
        _hist_close(st, jst)
        _close(us, jus, X_RTOL)
    # forest_solve, Jacobi and FAC, on the two-box forest
    th, jh = _forests([TWO_BOX])
    us, st = tf.forest_solve(th, f_two, rtol=1e-8, device="cpu")
    jus, jst = jf.forest_solve(jh, f_two, rtol=1e-8)
    _hist_close(st, jst)
    _close(us, jus, X_RTOL)
    # FAC: one preconditioner apply and the solve (JAX's forest_solve
    # spelled out, so that one set-up and one compiled program serve both)
    us, st = tf.forest_solve(th, f_two, rtol=1e-8, gmg_base=True, device="cpu")
    op, b = tf.forest_composite_system(th, f_two, device="cpu")
    pre = tf.ForestPreconditioner(th)
    jop, jb_ = jf.forest_composite_system(jh, f_two)
    jsolver = JCGSolver(Pl=jf.ForestPreconditioner(jh), rtol=1e-8, maxiter=2000, flexible=True)
    jstate = jsolver.setup(jop)
    r, jr = _seeded(np.random.default_rng(1), op)
    jz, (jx, jst) = jax.jit(lambda v, w: (jsolver.Pl.apply(jstate["Pl"], v),
                                          jsolver.solve(jstate, w)))(jr, jb_)
    _close(pre.apply(pre.setup(op), r), jz, PRECOND_RTOL)
    _hist_close(st, jst, FAC_HIST_ITS)
    _close(us, jop._extend(jx), X_RTOL)
    # the drivers: boxes chosen and solutions
    tb, jb = _mesh(16)
    th, us = ta.adaptive_solve(tb, f_one, num_levels=2, rtol=1e-8, device="cpu")
    jh, jus = ja.adaptive_solve(jb, f_one, num_levels=2, rtol=1e-8)
    assert [(lv.lo, lv.hi) for lv in th.levels] == [(lv.lo, lv.hi) for lv in jh.levels]
    _close(us, jus, X_RTOL)
    field, mesh = ta.composite_on_finest(th, us)
    jfield, jmesh = ja.composite_on_finest(jh, jus)
    assert mesh.ncells == jmesh.ncells
    _close([field], [jfield], X_RTOL)
    th, us = tf.adaptive_solve_scattered(tb, f_two, num_rounds=1, rtol=1e-8, device="cpu")
    jh, jus = jf.adaptive_solve_scattered(jb, f_two, num_rounds=1, rtol=1e-8)
    assert [[(p.lo, p.hi, p.parent) for p in lv] for lv in th.levels] == [
        [(p.lo, p.hi, p.parent) for p in lv] for lv in jh.levels]
    assert len(th.levels) == 2 and len(th.levels[1]) == 2
    _close(us, jus, X_RTOL)
    field, mesh = tf.forest_on_finest(th, us)
    jfield, jmesh = jf.forest_on_finest(jh, jus)
    assert mesh.ncells == jmesh.ncells
    _close([field], [jfield], X_RTOL)
