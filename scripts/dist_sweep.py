#!/usr/bin/env python3
"""The distributed Poisson GMG-CG of `chip_smoke.py`'s path Q over 1-8
ranks, on the CPU (gloo) or the card.

    python3 scripts/dist_sweep.py [--device cpu] [--nc 32 64] [--worlds 1 2 4 8]
                                  [--weak] [--jax] [--stokes [--maxiter N]]

For each grid (nc^3 cells, levels down to a 9^3 coarsest grid: 3 at 32^3,
4 at 64^3) and each layout (slab (p,) for every world size, plus the
(2, 2) and (2, 2, 2) boxes), one `run_ranks` launch runs
`parallel.weak_scaling.poisson_case` (Chebyshev(3) with Gershgorin
bounds, CG to rtol 1e-8) and prints rank 0's row: iterations, relative
residual, the padded grid and block, K2 launches against
`k2_launches_formula` (the plain version's on the CPU), set-up and solve
seconds, and what rank 0 sent per CG iteration: point-to-point batches
and messages and their bytes and all-gathers per operator apply plus
V-cycle (a solve makes n + 1 of each), all-reduces per loop iteration.
Beside the JAX design's count (COMMS_r05.json: 29 loop-body collectives
per GMG-CG iteration at 8 devices on 32^3: 22 permutes, 3 all-reduces,
4 all-gathers).

`--stokes` runs the distributed Stokes flagship of path R instead
(`parallel.weak_scaling.stokes_case`: FGMRES(30), upper block-triangular
velocity GMG and pressure-mass Jacobi-CG, rtol 1e-8, `--maxiter`,
default 60) at nc^2 cells (default 64 128 256), levels down to a 16^2
coarsest mesh (6 at 512^2), over one rank (1, 1), the slabs (2,) and
(4,) (the 1-D spelling) and the (2, 2) box: iterations, relative
residual, velocity and pressure L2 errors, K3 launches against
`k3_launches_formula`, and what rank 0 sent per FGMRES iteration (the
pressure CG's iterations in it); beside each (1, 1) row, the serial twin
(`stokes_serial_twin`: linear node-grid transfers where the flagship has
exact Q2 embeddings, so other iterations). `--jax` adds the JAX
package's iterations for the same rows and its serial twin's (a child
process; its 8 simulated devices) and holds each within one of the
port's. At 512^2 (path R's size) the port's row takes ~4 GB and 20
minutes on an 8-core CPU and the JAX child passed 35 GB: run that size
on the card (`--device cuda`), without `--jax`.

`--weak` runs `weak_scaling_poisson` (one launch a world size) at local
cells (16, 16, 16), base_levels 2, over the world sizes (the 4-rank count
that the tests do not hold) and prints its rows with their efficiency;
`--jax` runs the JAX package's `weak_scaling_poisson` on the
same rows in a child process (it imports JAX; this script does not) and
holds the iteration counts equal, and shows that both packages refuse
local cells (8, 8, 8) at 4 ranks (8 cells do not coarsen 4 times).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from gridapsolvers_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from gridapsolvers_tpu_torch.parallel.weak_scaling import (  # noqa: E402
    k2_launches_formula,
    k3_launches_formula,
    poisson_case,
    stokes_case,
    stokes_serial_twin,
    weak_scaling_poisson,
)

DEGREE = 3
SMOOTHER = {"degree": DEGREE, "eig_method": "gershgorin"}

_JAX_WEAK = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)
from gridapsolvers_tpu.parallel.weak_scaling import weak_scaling_poisson
local, counts, base = json.loads(sys.argv[1])
out = []
for p in counts:
    try:
        r = weak_scaling_poisson(local_cells=tuple(local), device_counts=(p,), base_levels=base)
        out.append({"devices": p, "iters": r[0]["iters"], "levels": r[0]["levels"]})
    except Exception as e:
        out.append({"devices": p, "error": type(e).__name__})
print(json.dumps(out))
"""


_JAX_STOKES = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)
from gridapsolvers_tpu.fem.dist_stokes_nd import (
    distributed_stokes_solver_nd, distributed_stokes_system_nd)
from gridapsolvers_tpu.parallel import device_mesh_nd
from gridapsolvers_tpu.blocks import BlockTriangularSolver, LinearSystemBlock, MatrixBlock
from gridapsolvers_tpu.fem.stokes import stokes_problem, velocity_gmg
from gridapsolvers_tpu.linear import CGSolver, FGMRESSolver, JacobiSolver
rows, maxiter = json.loads(sys.argv[1])
out = []
for nc, levels, layout in rows:
    ms = tuple(layout)
    mesh = device_mesh_nd(ms)
    _, A, b, _, _ = distributed_stokes_system_nd((nc, nc), mesh, ms)
    solver, _ = distributed_stokes_solver_nd((nc, nc), levels, mesh, ms, maxiter=maxiter)
    x, st = jax.jit(lambda s, v: solver.solve(s, v))(solver.setup(A), b)
    row = {"nc": nc, "layout": layout, "iters": int(st.niter), "flag": int(st.flag)}
    if ms == (1, 1):  # the serial twin (tests/test_dist_stokes.py:185-207)
        prob = stokes_problem((nc, nc))
        prec = BlockTriangularSolver(
            solvers=(velocity_gmg((nc, nc), levels), CGSolver(Pl=JacobiSolver(), rtol=1e-8,
                                                              maxiter=40)),
            blocks=((LinearSystemBlock(), None), (None, MatrixBlock(prob.Mp))), half="upper")
        twin = FGMRESSolver(m=30, Pr=prec, rtol=1e-8, maxiter=maxiter)
        _, st = jax.jit(lambda A_, b_: twin.solve(twin.setup(A_), b_))(prob.A, prob.b)
        row["twin_iters"] = int(st.niter)
    out.append(row)
print(json.dumps(out))
"""


def stokes_levels(nc: int) -> int:
    """GMG levels down to a 16^2 coarsest mesh (path R: 6 at 512^2)."""
    return max(2, int(round(np.log2(nc / 16))) + 1)


def stokes_row(r, device) -> str:
    n = max(r["iters"], 1)
    c = r["comm"]
    want = k3_launches_formula(r["iters"], r["cg_its"], r["operand_shapes"], r["m"])
    if device == "cpu":
        assert r["k3_plain"] == sum(want.values()), (r["k3_plain"], want)
        k3 = f"K3 plain {r['k3_plain']} = formula"
    else:
        assert r["k3_plain"] == 0 and r["k3_shapes"] == want, (r["k3_shapes"], want)
        k3 = f"K3 {r['k3_launches']} by shape = formula"
    h = r["history"]
    return (f"{r['iters']} its (flag {r['flag']}), rel res {h[-1] / h[0]:.3e}, "
            f"|u-u_h| {r['velocity_error']:.4e}, |p-p_h| {r['pressure_error']:.4e}; {k3}; "
            f"pressure CG {sum(r['cg_its']) / n:.1f} its/it; set-up {r['setup_s']:.2f} s, solve "
            f"{r['time_s']:.3f} s; rank 0 per FGMRES iteration: p2p {c['p2p_batches'] / n:.1f} "
            f"batches / {c['p2p_messages'] / n:.1f} msgs / {c['p2p_bytes'] / n:.0f} B, "
            f"all-reduces {c['all_reduces'] / n:.1f}, all-gathers {c['all_gathers'] / n:.1f} "
            f"({c['gather_bytes'] / n:.0f} B)")


def stokes_sweep(opts) -> None:
    rows, twin_its = [], {}
    for nc in opts.nc:
        levels = stokes_levels(nc)
        for layout, one_axis in (((1, 1), False), ((2,), True), ((4,), True), ((2, 2), False)):
            world = int(np.prod(layout))
            if world > max(opts.worlds):
                continue
            t0 = time.perf_counter()
            r = run_ranks(stokes_case, world, ((nc, nc), levels, layout),
                          {"one_axis": one_axis, "maxiter": opts.maxiter, "runs": 1},
                          device=opts.device, timeout=3600)[0]
            twin = ""
            if layout == (1, 1):
                tw = stokes_serial_twin((nc, nc), levels, maxiter=opts.maxiter,
                                        device=opts.device)
                du = max(float(np.abs(a - b).max()) for a, b in zip(r["u"], tw["u"]))
                dp = float(np.abs(r["p"] - tw["p"]).max())
                twin = (f"; serial twin {tw['iters']} its (flag {tw['flag']}), |u-u_h| "
                        f"{tw['velocity_error']:.4e}, against it u {du:.1e} p {dp:.1e}")
                twin_its[nc] = tw["iters"]
            rows.append((nc, levels, list(layout), r["iters"]))
            print(f"stokes {nc}^2/{levels} levels {layout} ({r['transport']}): "
                  f"{stokes_row(r, opts.device)}{twin} [launch {time.perf_counter() - t0:.1f} s]",
                  flush=True)
    if opts.jax:
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        out = subprocess.run(
            [sys.executable, "-c", _JAX_STOKES,
             json.dumps([[[nc, lv, layout] for nc, lv, layout, _ in rows], opts.maxiter])],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=3600)
        assert out.returncode == 0, out.stderr[-3000:]
        ref = json.loads(out.stdout.strip().splitlines()[-1])
        for (nc, lv, layout, its), j in zip(rows, ref):
            twin = (f"; serial twin {j['twin_iters']} its, port {twin_its[nc]}"
                    if "twin_iters" in j else "")
            print(f"JAX stokes {nc}^2/{lv} levels {tuple(layout)}: {j['iters']} its "
                  f"(flag {j['flag']}), port {its}{twin}", flush=True)
            assert abs(j["iters"] - its) <= 1, (nc, layout, j, its)
            if "twin_iters" in j:
                assert abs(j["twin_iters"] - twin_its[nc]) <= 1, (nc, j, twin_its[nc])


def per_iteration(row) -> str:
    n1 = row["iters"] + 1
    c = row["comm"]
    return (f"p2p {c['p2p_batches'] / n1:.1f} batches / {c['p2p_messages'] / n1:.1f} msgs / "
            f"{c['p2p_bytes'] / n1:.0f} B, all-gathers {c['all_gathers'] / n1:.1f} "
            f"({c['gather_bytes'] / n1:.0f} B) per apply+V-cycle; all-reduces "
            f"{(c['all_reduces'] - 2) / row['iters'] if c['all_reduces'] else 0:.1f} per "
            f"iteration")


def check_launches(row, device) -> str:
    want = k2_launches_formula(row["iters"], row["level_shapes"], DEGREE)
    if device == "cpu":
        assert row["k2_plain"] == sum(want.values()), (row["k2_plain"], want)
        return f"K2 plain {row['k2_plain']} = formula"
    assert row["k2_plain"] == 0 and row["k2_shapes"] == want, (row["k2_shapes"], want)
    return f"K2 {row['k2_launches']} by shape = formula"


def jax_weak(local, counts, base):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _JAX_WEAK, json.dumps([local, counts, base])],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=1800)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--nc", type=int, nargs="+", default=[32, 64])
    parser.add_argument("--worlds", type=int, nargs="+", default=[1, 2, 4, 8])
    parser.add_argument("--weak", action="store_true")
    parser.add_argument("--jax", action="store_true")
    parser.add_argument("--stokes", action="store_true")
    parser.add_argument("--maxiter", type=int, default=60)
    opts = parser.parse_args()
    if opts.device == "cpu":  # one thread a rank process (they inherit it)
        os.environ["OMP_NUM_THREADS"] = "1"
    if opts.stokes:
        if opts.nc == [32, 64]:
            opts.nc = [64, 128, 256]
        stokes_sweep(opts)
        return
    for nc in opts.nc:
        levels = {32: 3, 64: 4, 128: 5}.get(nc, 3)
        layouts = [(p,) for p in opts.worlds] + [(2, 2), (2, 2, 2)]
        for layout in layouts:
            world = 1
            for p in layout:
                world *= p
            if world > max(opts.worlds):
                continue
            t0 = time.perf_counter()
            rows = run_ranks(poisson_case, world, ((nc,) * 3, levels, layout),
                             {"rtol": 1e-8, "maxiter": 30, "smoother": SMOOTHER},
                             device=opts.device, timeout=1800)
            r = rows[0]
            h = r["history"]
            print(f"{nc}^3/{levels} levels {layout} ({r['transport']}): {r['iters']} its, "
                  f"rel res {h[-1] / h[0]:.3e}, padded {r['padded']} block {r['block']}; "
                  f"{check_launches(r, opts.device)}; set-up {r['setup_s']:.2f} s, solve "
                  f"{r['time_s']:.3f} s; rank 0 {per_iteration(r)} "
                  f"[launch {time.perf_counter() - t0:.1f} s]", flush=True)
    if opts.weak:
        local, base = (16, 16, 16), 2
        rows = weak_scaling_poisson(local_cells=local, device_counts=opts.worlds,
                                    base_levels=base, device=opts.device, timeout=1800)
        for r in rows:
            print(f"weak {local} x {r['devices']}: {r['ncells']} cells, {r['levels']} levels, "
                  f"{r['iters']} its, {r['time_per_iter'] * 1e3:.2f} ms/it, efficiency "
                  f"{r['efficiency']:.3f}", flush=True)
        if opts.jax:
            ref = jax_weak(local, opts.worlds, base)
            assert [r["iters"] for r in rows] == [j["iters"] for j in ref], (rows, ref)
            print(f"JAX weak_scaling_poisson {local}, base_levels {base}: its "
                  f"{[j['iters'] for j in ref]} = port's", flush=True)
            ref8 = jax_weak((8, 8, 8), [4], 3)
            try:
                weak_scaling_poisson(local_cells=(8, 8, 8), device_counts=(4,), base_levels=3,
                                     device=opts.device, timeout=600)
                port8 = "ran"
            except Exception as e:  # noqa: BLE001 - the refusal is the finding
                port8 = type(e).__name__
            print(f"weak (8, 8, 8) x 4 (5 levels): JAX {ref8[0].get('error', 'ran')}, "
                  f"port {port8}", flush=True)


if __name__ == "__main__":
    main()
