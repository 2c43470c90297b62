#!/usr/bin/env python3
"""The distributed Poisson GMG-CG of `chip_smoke.py`'s path Q over 1-8
ranks, on the CPU (gloo) or the card.

    python3 scripts/dist_sweep.py [--device cpu] [--nc 32 64] [--worlds 1 2 4 8]
                                  [--weak] [--jax]

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

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from gridapsolvers_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from gridapsolvers_tpu_torch.parallel.weak_scaling import (  # noqa: E402
    k2_launches_formula,
    poisson_case,
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
    opts = parser.parse_args()
    if opts.device == "cpu":  # one thread a rank process (they inherit it)
        os.environ["OMP_NUM_THREADS"] = "1"
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
