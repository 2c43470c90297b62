"""The port's Navier-Stokes problem against the JAX package.

The manufactured-solution and lid-driven-cavity problems, plain (Q2/Q1)
and grad-div augmented (Q2/P1disc), built by both packages at 8^2 cells in
f64 on the CPU from the same numpy-seeded iterates: residuals, Newton and
Picard Jacobian matvecs agree to 1e-12 of their largest entry. On the
port alone: the finite-difference Jacobian checks of
tests/test_navier_stokes.py:74,280, the pattern (`cols`, `row_len`,
`group`) every velocity block carries, and a JAX problem carried across by
`convert.navier_stokes_problem`. The f32 Newton plateau of the augmented
cavity, and NewtonRefinement's compensated residual and refinement steps,
against JAX's in true f32 (JAX x64 off while the script runs,
`jax_reference_jit.run_in_f32`, as tests/test_torch_mixed_iterations.py
runs it).
"""
import dataclasses
import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from jax_reference_jit import jitted_jax_methods, jitted_jax_patch_setups, run_in_f32
from gridapsolvers_tpu.fem.navier_stokes import navier_stokes_problem as j_navier_stokes_problem
from gridapsolvers_tpu.linear import GMRESSolver as JGMRES

from gridapsolvers_tpu_torch import convert
from gridapsolvers_tpu_torch.algebra import ELLMatrix
from gridapsolvers_tpu_torch.fem import assembly2 as asm
from gridapsolvers_tpu_torch.fem.navier_stokes import (
    Q2ConvectionAssembler,
    navier_stokes_problem,
)
from gridapsolvers_tpu_torch.utils import pytrees as pt

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _compiled_jax_patch_setups():
    """The JAX references' patch smoothers refresh their values compiled
    (`jitted_jax_patch_setups`)."""
    with jitted_jax_patch_setups():
        yield


OP_RTOL = 1e-12
NU = 0.1
CASES = [("mms", 0.0), ("mms", 1e3), ("cavity", 0.0), ("cavity", 1e3)]


def _flat(x):
    if isinstance(x, (tuple, list)):
        return np.concatenate([_flat(v) for v in x])
    return np.ravel(np.asarray(x, dtype=np.float64))


def _assert_close(y, y_ref, rtol=OP_RTOL):
    y, y_ref = _flat(y), _flat(y_ref)
    scale = np.max(np.abs(y_ref))
    assert y.shape == y_ref.shape and scale > 0
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=rtol * scale)


def _rand_x(prob, seed, scale=1.0):
    """The same random block iterate for both packages (port, JAX)."""
    rng = np.random.default_rng(seed)
    u = [scale * rng.normal(size=prob.n_u) for _ in range(2)]
    p = scale * rng.normal(size=prob.Mp.shape[0])
    return ((tuple(torch.from_numpy(v) for v in u), torch.from_numpy(p)),
            (tuple(jnp.asarray(v) for v in u), jnp.asarray(p)))


def jax_numpy(v):
    """A JAX field as numpy arrays (tuples kept)."""
    if v is None:
        return None
    if isinstance(v, (tuple, list)):
        return tuple(jax_numpy(vi) for vi in v)
    return np.asarray(v)


@pytest.fixture(scope="module")
def problems():
    """Both packages' problem for every (bc, alpha) case, built once."""
    return {(bc, a): (navier_stokes_problem((8, 8), nu=NU, graddiv_alpha=a, bc=bc,
                                            device="cpu"),
                      j_navier_stokes_problem((8, 8), nu=NU, graddiv_alpha=a, bc=bc))
            for bc, a in CASES}


@pytest.mark.parametrize("bc,alpha", CASES)
def test_problem_equal_jax(problems, bc, alpha):
    """Residual, Newton and Picard Jacobian matvecs, forcing and initial
    guess against JAX at a random iterate."""
    prob, jprob = problems[bc, alpha]
    x, jx = _rand_x(prob, 0)
    _assert_close(prob.residual(x), jprob.residual(jx))
    _assert_close(prob.jacobian(x).matvec(x), jprob.jacobian(jx).matvec(jx))
    _assert_close(prob.picard_jacobian(x).matvec(x), jprob.picard_jacobian(jx).matvec(jx))
    if bc == "mms":
        _assert_close(prob.f, jprob.f)
    else:
        _assert_close(prob.initial_guess()[0], jprob.initial_guess()[0])
    np.testing.assert_array_equal(prob.cols_ell.numpy(), np.asarray(jprob.cols_ell))
    np.testing.assert_array_equal(prob.slots.numpy(), np.asarray(jprob.slots))
    if bc == "mms":
        u_err = prob.velocity_error(x[0])
        assert u_err == pytest.approx(jprob.velocity_error(jx[0]), rel=OP_RTOL)


def test_mms_jacobian_finite_difference(problems):
    """tests/test_navier_stokes.py:74 on the port: a central difference of
    the residual along d equals J d (the convection is quadratic)."""
    prob = problems["mms", 0.0][0]
    x, _ = _rand_x(prob, 0, 0.1)
    d, _ = _rand_x(prob, 1)
    eps = 1e-5
    fd = pt.scale(1.0 / (2 * eps), pt.sub(prob.residual(pt.axpy(eps, d, x)),
                                          prob.residual(pt.axpy(-eps, d, x))))
    Jd = prob.jacobian(x).matvec(d)
    assert float(pt.norm(pt.sub(fd, Jd)) / pt.norm(Jd)) < 1e-8


@pytest.mark.parametrize("alpha", [0.0, 100.0])
def test_cavity_jacobian_finite_difference(alpha):
    """tests/test_navier_stokes.py:280 on the port: the masked Jacobian is
    the derivative of the row-masked cavity residual along free-dof
    directions, and the lift start leaves the constrained rows exactly
    zero."""
    prob = navier_stokes_problem((8, 8), nu=NU, graddiv_alpha=alpha, bc="cavity", device="cpu")
    rng = np.random.default_rng(0)
    u0, p0 = prob.initial_guess()
    du = tuple(torch.from_numpy(rng.normal(size=prob.n_u)) * prob.free_u for _ in range(2))
    dp = torch.from_numpy(rng.normal(size=p0.shape[0]))
    x = (tuple(u + 0.3 * d for u, d in zip(u0, du)), 0.1 * dp)
    Jd = prob.jacobian(x).matvec((du, dp))
    eps = 1e-6
    rp = prob.residual((tuple(u + eps * d for u, d in zip(x[0], du)), x[1] + eps * dp))
    rm = prob.residual((tuple(u - eps * d for u, d in zip(x[0], du)), x[1] - eps * dp))
    fd = pt.axpy(1.0 / (2 * eps), rp, pt.scale(-1.0 / (2 * eps), rm))
    assert float(pt.norm(pt.sub(fd, Jd)) / pt.norm(Jd)) < 1e-6
    r0 = prob.residual((u0, p0))
    bdry = 1.0 - prob.free_u
    for c in range(2):
        assert float((r0[0][c] * bdry).abs().max()) == 0.0


def _velocity_ells(op):
    return [b for row in op.blocks for b in row]


@pytest.mark.parametrize("alpha", [0.0, 1e3])
def test_blocks_carry_the_pattern(alpha):
    """Every velocity ELLMatrix the problem and a level assembler build (the
    Jacobian, the Picard block, the cavity residual's row-masked operators,
    the grad-div values) lies on the pattern's `cols`, `row_len` and
    `group`: rows of 25, 15 or 9 entries, value 0 past each row's length."""
    prob = navier_stokes_problem((8, 8), nu=NU, graddiv_alpha=alpha, bc="cavity", device="cpu")
    pattern = asm.assemble_bilinear(prob.mesh, 2, "stiffness")
    np.testing.assert_array_equal(prob.row_len.numpy(), np.diff(pattern.indptr))
    assert set(prob.row_len.tolist()) == {9, 15, 25} and prob.cols_ell.shape[1] == 25
    seen = []
    real = ELLMatrix.matvec

    def spy(blk, v):
        seen.append(blk)
        return real(blk, v)

    ELLMatrix.matvec = spy
    try:
        x = prob.initial_guess()
        prob.residual(x)
    finally:
        ELLMatrix.matvec = real
    velocity = [b for b in seen if b.cols is prob.cols_ell]
    assert len(velocity) == (2 + 4 * (alpha > 0))   # Adiag per component, G_res blocks
    asb = Q2ConvectionAssembler(prob.mesh, NU, graddiv_alpha=alpha, bc="cavity", device="cpu")
    u = tuple(torch.randn(prob.n_u, dtype=torch.float64) for _ in range(2))
    blocks = (velocity + _velocity_ells(prob.jacobian(x).block(0, 0))
              + _velocity_ells(prob.picard_jacobian(x).block(0, 0))
              + _velocity_ells(asb.velocity_block(u)))
    slot = torch.arange(25)[None, :]
    for b in blocks:
        own = prob if b.cols is prob.cols_ell else asb
        assert b.cols is own.cols_ell and b.row_len is own.row_len and b.group == own.group == 8
        assert float(b.values.masked_fill(slot < b.row_len[:, None], 0.0).abs().max()) == 0.0


@pytest.mark.parametrize("bc,alpha", [("mms", 0.0), ("cavity", 1e3)])
def test_convert_problem_equal_port(problems, bc, alpha):
    """A JAX problem carried across (convert.navier_stokes_problem) applies
    as the port's own: residual and Jacobian at a random iterate, and the
    pattern's row lengths."""
    prob, jprob = problems[bc, alpha]

    def spec(op):
        return {"values": np.asarray(op.values), "cols": np.asarray(op.cols), "ncols": op.ncols}

    fields = {}
    for f in dataclasses.fields(jprob):
        v = getattr(jprob, f.name)
        if f.name in ("BTs", "Bs", "res_Bs"):
            v = None if v is None else [spec(o) for o in v]
        elif f.name in ("Mp", "Mu"):
            v = spec(v)
        elif f.name not in ("mesh", "nu", "n_u"):
            v = jax_numpy(v)
        fields[f.name] = v
    carried = convert.navier_stokes_problem(fields, device="cpu")
    assert torch.equal(carried.row_len, prob.row_len) and carried.group == prob.group
    x, _ = _rand_x(prob, 3)
    _assert_close(carried.residual(x), prob.residual(x))
    _assert_close(carried.jacobian(x).matvec(x), prob.jacobian(x).matvec(x))


def test_csr_slot_map_rejects_foreign_entries():
    """The slot map raises on a (row, col) pair outside the pattern."""
    from gridapsolvers_tpu_torch.fem.navier_stokes import _csr_slot_map

    S = sp.csr_matrix(np.array([[1.0, 0.0], [1.0, 1.0]]))
    ok = _csr_slot_map(S, torch.tensor([1, 1, 0]), torch.tensor([1, 0, 0]))
    assert ok.tolist() == [1, 0, 0]
    with pytest.raises(ValueError, match="not in the pattern"):
        _csr_slot_map(S, torch.tensor([0]), torch.tensor([1]))


_F32_SCRIPT = r"""
import json, dataclasses as dc
import jax
import numpy as np
import jax.numpy as jnp
import torch
from gridapsolvers_tpu.fem.navier_stokes import navier_stokes_problem as jp, ns_velocity_gmg as jg
from gridapsolvers_tpu.blocks import (BlockTriangularSolver as JBT, MatrixBlock as JMB,
                                      NonlinearSystemBlock as JNB)
from gridapsolvers_tpu.linear import CGSolver as JCG, FGMRESSolver as JF, JacobiSolver as JJ
from gridapsolvers_tpu.nonlinear import NewtonSolver as JN
from gridapsolvers_tpu.nonlinear.refinement import NewtonRefinement as JR
from gridapsolvers_tpu_torch.fem.navier_stokes import navier_stokes_problem, ns_velocity_gmg
from gridapsolvers_tpu_torch.blocks import BlockTriangularSolver, MatrixBlock, NonlinearSystemBlock
from gridapsolvers_tpu_torch.linear import CGSolver, FGMRESSolver, JacobiSolver
from gridapsolvers_tpu_torch.nonlinear import NewtonSolver
from gridapsolvers_tpu_torch.nonlinear.refinement import NewtonRefinement

torch.set_num_threads(1)
nc, nu, alpha = 8, 0.1, 1e3
out = {}
# tests/test_refinement.py's script at 8^2: each package's f32 Newton
# plateau (atol 3e-3), then three two-float refinement steps in each
# package from the port's iterate and the solver's set-up state
x_f32 = None
for name, P in (("port", dict(p=navier_stokes_problem, g=ns_velocity_gmg, BT=BlockTriangularSolver,
                              MB=MatrixBlock, NB=NonlinearSystemBlock, CG=CGSolver, J=JacobiSolver,
                              F=FGMRESSolver, N=NewtonSolver, R=NewtonRefinement,
                              kw=dict(dtype=torch.float32, device="cpu"), scale=-1.0 / alpha)),
                ("jax", dict(p=jp, g=jg, BT=JBT, MB=JMB, NB=JNB, CG=JCG, J=JJ, F=JF, N=JN, R=JR,
                             kw=dict(dtype=np.float32), scale=np.float32(-1.0 / alpha)))):
    prob = P["p"]((nc, nc), nu=nu, graddiv_alpha=alpha, bc="cavity", **P["kw"])
    gmg = P["g"]((nc, nc), num_levels=2, nu=nu, graddiv_alpha=alpha, bc="cavity",
                 vanka_engine="batched", cheby_degree=4, **P["kw"])
    Mp = dc.replace(prob.Mp, values=prob.Mp.values * P["scale"])
    pc = P["BT"](solvers=(gmg, P["CG"](Pl=P["J"](), rtol=1e-6, maxiter=30)),
                 blocks=((P["NB"](), None), (None, P["MB"](Mp))),
                 coeffs=((1.0, 1.0), (0.0, 1.0)), half="upper")
    fg = P["F"](m=20, Pr=pc, rtol=1e-8, maxiter=60)
    x0 = prob.zero_guess()
    ls = fg.setup(prob.jacobian(x0), x0)
    x, st = P["N"](fg, maxiter=12, rtol=1e-6, atol=3e-3).solve(prob, x0)
    h = np.asarray(st.residuals)
    out[name + "_newton"] = {"niter": int(st.niter), "flag": int(st.flag),
                             "rmax": float(np.nanmax(h)), "hist": [float(v) for v in h]}
    if name == "port":
        x_f32 = [[np.asarray(t) for t in x[0]], np.asarray(x[1])]
    else:
        x = (tuple(jnp.asarray(t) for t in x_f32[0]), jnp.asarray(x_f32[1]))
    _, x_lo, rnorms = P["R"](fg, niter=3).refine(prob, x, ls)
    out[name] = {"rnorms": [float(r) for r in rnorms], "dtype": str(x_lo[1].dtype)}
print("REFINE_RESULT " + json.dumps(out))
"""


def test_newton_refinement_f32_equal_jax():
    """tests/test_refinement.py:102 at 8^2 in true f32. The f32 Newton
    plateau in each package: equal iterations and flag (3 steps,
    CONVERGED_ATOL, as the JAX bench's f32 row reads); the first two
    residuals, above f32's floor, to 1e-5; the later ones, at the floor
    (~3e-5 of the largest, set by how each f32 inner solve rounds), within
    5%. Then, from the port's iterate, three two-float refinement steps in
    each package take the compensated residual below 1e-6 of the Newton
    history's largest residual and 1/100 of the entry floor; the entry
    floors agree to 1e-2 (both compensated, from the same f32 iterate), and
    the final residuals within 2x: each is the f32 floor of its package's
    last correction solve, so they agree in size, not in digits."""
    # the JAX package's GMRES solves compiled (eagerly they dispatch op by
    # op, several times slower on the CPU); nothing else of it changes
    out = run_in_f32(_F32_SCRIPT, jitted_jax_methods((JGMRES, "solve")))
    line = [ln for ln in out.splitlines() if ln.startswith("REFINE_RESULT ")]
    res = json.loads(line[-1].split(" ", 1)[1])
    newton, jnewton, jax_, port = res["port_newton"], res["jax_newton"], res["jax"], res["port"]
    assert (newton["niter"], newton["flag"]) == (jnewton["niter"], jnewton["flag"]) == (3, 1), res
    h, jh = np.array(newton["hist"][:4]), np.array(jnewton["hist"][:4])
    np.testing.assert_allclose(h[:2], jh[:2], rtol=1e-5)
    np.testing.assert_allclose(h[2:], jh[2:], rtol=5e-2)
    assert port["dtype"] == "torch.float32" and jax_["dtype"] == "float32", res
    for run in (jax_, port):
        assert run["rnorms"][-1] < 1e-6 * newton["rmax"], res
        assert run["rnorms"][-1] < 0.01 * run["rnorms"][0], res
    assert port["rnorms"][0] == pytest.approx(jax_["rnorms"][0], rel=1e-2), res
    assert 0.5 < port["rnorms"][-1] / jax_["rnorms"][-1] < 2.0, res
