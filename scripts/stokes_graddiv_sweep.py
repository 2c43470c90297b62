#!/usr/bin/env python3
"""Path H's augmented-Lagrangian Stokes configuration at several sizes, in
f64 and f32, on the CPU or the card: FGMRES iterations and flag, the true
relative block residual (f64 arithmetic), the velocity and pressure L2
errors, and set-up and solve seconds. `chip_smoke.py` takes path H1's error
bounds at 512^2 cells from this script's f64 run at 256^2, and the size of
its f32 run (the bench's) from the f32 runs here.

    python3 scripts/stokes_graddiv_sweep.py [--device cpu] [--nc 16 32 64 96 128]
        [--levels 3 | --to16] [--dtypes f64 f32]

The configuration is chip_smoke.setup_h's: grad-div alpha 1e3, Q2/P1disc,
flat engine, Chebyshev(4) over the materialized Vanka, FGMRES(20) rtol 1e-8
within maxiter 30, Jacobi-CG rtol 1e-6 <= 30 its on -(1/alpha) Mp. --levels
gives the GMG's level count (the bench's is 3); --to16 coarsens to 16^2
cells, as path H1 does.
"""
from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import setup_h, solve_h, stokes_rel_residual64  # noqa: E402

DTYPES = {"f64": torch.float64, "f32": torch.float32}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--nc", type=int, nargs="+", default=[16, 32, 64, 96, 128])
    parser.add_argument("--levels", type=int, default=3)
    parser.add_argument("--to16", action="store_true")
    parser.add_argument("--dtypes", nargs="+", default=["f64", "f32"], choices=list(DTYPES))
    opts = parser.parse_args()
    torch.set_num_threads(min(8, torch.get_num_threads()))
    for nc in opts.nc:
        levels = max(2, int(math.log2(nc // 16)) + 1) if opts.to16 else opts.levels
        for name in opts.dtypes:
            run = solve_h(setup_h(nc, levels, DTYPES[name], opts.device))
            prob, x, st = run["prob"], run["x"], run["stats"]
            k = st.niter
            h = st.residuals.cpu().numpy()
            print(f"{nc}^2 {levels} levels {name}: {k} its, flag {int(st.flag)}, FGMRES estimate "
                  f"ratio {h[k] / h[0]:.3e}, true rel residual "
                  f"{stokes_rel_residual64(prob, x):.3e}, velocity L2 "
                  f"{prob.velocity_error(x[0]):.4e}, pressure L2 {prob.pressure_error(x[1]):.4e}, "
                  f"inner CG its {sum(run['cg_its'])}, set-up {run['setup_s']:.2f} s, solve "
                  f"{run['solve_s']:.2f} s", flush=True)


if __name__ == "__main__":
    main()
