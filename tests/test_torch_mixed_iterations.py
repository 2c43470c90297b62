"""Iteration counts of the port's mixed-precision GMG against the JAX
package's, in true f32: the configurations of
tests/test_gmg.py::test_gmg_mixed_precision_smoother and
::test_gmg_bf16_mixed_precision, run by both packages in one process with
JAX's x64 off (tests/conftest.py turns it on; `run_in_f32` turns it off
while the script runs). The port's counts must equal JAX's or exceed them
by one at most.
"""
import json

from jax_reference_jit import run_in_f32

_F32_SCRIPT = r"""
import json
import jax
import numpy as np
import jax.numpy as jnp
import torch
from gridapsolvers_tpu.fem import poisson_problem as j_poisson_problem
from gridapsolvers_tpu.fem.assembly import laplacian_const as j_lc
from gridapsolvers_tpu.linear import CGSolver as JCG, ChebyshevSmoother as JCheby
from gridapsolvers_tpu.linear import DenseInverseSolver as JInv
from gridapsolvers_tpu.linear.gmg import gmg_from_hierarchy as j_gfh
from gridapsolvers_tpu.multilevel import cartesian_hierarchy as j_h
from gridapsolvers_tpu_torch.fem import poisson_problem
from gridapsolvers_tpu_torch.fem.assembly import laplacian_const as lc
from gridapsolvers_tpu_torch.linear import CGSolver, ChebyshevSmoother, DenseInverseSolver
from gridapsolvers_tpu_torch.linear.gmg import gmg_from_hierarchy as gfh
from gridapsolvers_tpu_torch.multilevel import cartesian_hierarchy as h

torch.set_num_threads(1)
f32, bf16 = torch.float32, torch.bfloat16
out = {}
# tests/test_gmg.py::test_gmg_mixed_precision_smoother: 16^3, 3 levels
jp = j_poisson_problem((16,) * 3, dtype=np.float32)
jA = j_lc(jp.mesh, np.float32)
jb = jnp.asarray(np.asarray(jp.b, np.float32))
p = poisson_problem((16,) * 3, dtype=f32, device="cpu")
A = lc(p.mesh, f32, "cpu")
for name, jkw, kw in (("f32", {}, {}),
                      ("mixed", dict(compute_dtype=jnp.bfloat16, mixed=True),
                       dict(compute_dtype=bf16, mixed=True))):
    jg = j_gfh(j_h((16,) * 3, 3), lambda m: j_lc(m, np.float32),
               smoother=JCheby(degree=4, eig_method="gershgorin"),
               coarsest_solver=JInv(), dtype=jnp.float32, **jkw)
    jcg = JCG(Pl=jg, rtol=1e-5, maxiter=40, flexible=True)
    jx, jst = jax.jit(jcg.solve)(jcg.setup(jA), jb)
    g = gfh(h((16,) * 3, 3), lambda m: lc(m, f32, "cpu"),
            smoother=ChebyshevSmoother(degree=4, eig_method="gershgorin"),
            coarsest_solver=DenseInverseSolver(), dtype=f32, device="cpu", **kw)
    cg = CGSolver(Pl=g, rtol=1e-5, maxiter=40, flexible=True)
    x, st = cg.solve(cg.setup(A), p.b)
    rn = float(torch.linalg.norm(A.matvec(x) - p.b) / torch.linalg.norm(p.b))
    out[name] = {"jax": int(jst.niter), "port": st.niter, "port_rel_res": rn,
                 "dtype": str(x.dtype)}
# tests/test_gmg.py::test_gmg_bf16_mixed_precision: 12^3, 3 levels, all bf16
jp = j_poisson_problem((12,) * 3, dtype=np.float32)
jg = j_gfh(j_h((12,) * 3, 3), lambda m: j_lc(m, np.float32),
           smoother=JCheby(degree=3, eig_method="gershgorin"), dtype=jnp.float32,
           compute_dtype=jnp.bfloat16)
jcg = JCG(Pl=jg, rtol=1e-5, maxiter=30, flexible=True)
jx, jst = jax.jit(jcg.solve)(jcg.setup(j_lc(jp.mesh, np.float32)), jnp.asarray(jp.b, jnp.float32))
p = poisson_problem((12,) * 3, dtype=f32, device="cpu")
g = gfh(h((12,) * 3, 3), lambda m: lc(m, f32, "cpu"),
        smoother=ChebyshevSmoother(degree=3, eig_method="gershgorin"), dtype=f32,
        device="cpu", compute_dtype=bf16)
cg = CGSolver(Pl=g, rtol=1e-5, maxiter=30, flexible=True)
x, st = cg.solve(cg.setup(lc(p.mesh, f32, "cpu")), p.b)
out["bf16"] = {"jax": int(jst.niter), "port": st.niter, "converged": st.converged(),
               "l2": float(p.l2_error(x.double())), "dtype": str(x.dtype)}
print("MIXED_F32 " + json.dumps(out))
"""


def test_mixed_precision_iteration_counts_f32():
    """The configurations of tests/test_gmg.py::test_gmg_mixed_precision_
    smoother (mixed: at most the f32 twin's count + 1, true residual <
    2e-5) and ::test_gmg_bf16_mixed_precision (all bf16: converged in <= 15,
    L2 < 1e-3), in true f32 in both packages: the port's counts equal
    JAX's or exceed them by one at most."""
    out = run_in_f32(_F32_SCRIPT)
    line = [ln for ln in out.splitlines() if ln.startswith("MIXED_F32 ")]
    assert line, out[-1500:]
    res = json.loads(line[-1].split(" ", 1)[1])
    for name, v in res.items():
        assert v["dtype"] == "torch.float32", res
        assert v["jax"] <= v["port"] <= v["jax"] + 1, res
    for name in ("f32", "mixed"):
        assert res[name]["port_rel_res"] < 2e-5, res
    assert res["mixed"]["port"] <= res["f32"]["port"] + 1, res
    assert res["bf16"]["converged"] and res["bf16"]["port"] <= 15, res
    assert res["bf16"]["l2"] < 1e-3, res
