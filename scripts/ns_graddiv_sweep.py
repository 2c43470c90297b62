#!/usr/bin/env python3
"""Path I's Navier-Stokes configurations at several sizes, on the CPU or
the card: Newton iterations and flag, FGMRES iterations of each Newton
step, the final relative Newton residual, u_x at the cavity centre, and
set-up and Newton seconds. `chip_smoke.py` takes path I1's Newton and
FGMRES bands and its bound on the centre u_x at 512^2 cells from the f64
runs here.

    python3 scripts/ns_graddiv_sweep.py [--device cpu] [--nc 16 32 64 128]
        [--i2]

The configuration is chip_smoke.setup_i's: the lid-driven cavity at Re = 10
(nu = 0.1), grad-div alpha 1e3, Q2/P1disc, Chebyshev(4) over the
materialized vertex-star Vanka, patch prolongations, the velocity GMG
coarsened to 16^2 cells (two levels at 16^2), FGMRES(20) rtol 1e-8 <= 60,
Newton rtol 1e-6 with atol 0, from zero, in f64. --i2 also runs path I2's
rows at 32^2 cells on 3 levels in f32: the bench's ns_newton (Richardson(1,
0.8) over the velocity-row Vanka, Newton atol 1e-8) and ns_graddiv (atol
3e-3) followed by two NewtonRefinement steps.
"""
from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import NC_I2, LEVELS_I2, setup_i, solve_i  # noqa: E402
from gridapsolvers_tpu_torch.nonlinear.refinement import NewtonRefinement  # noqa: E402


def report(tag, run) -> None:
    st = run["stats"]
    h = st.residuals.numpy()
    steps = run["per_step"]
    print(f"{tag}: {st.niter} Newton its, flag {st.flag}, residuals "
          + " ".join(f"{v:.3e}" for v in h[: st.niter + 1])
          + f", final relative {h[st.niter] / h[0]:.3e}, FGMRES its by step "
          f"{[s['its'] for s in steps]}, centre u_x {run['ux_centre']:.10f}, set-up "
          f"{sum(run['setup_secs'].values()):.2f} s, Newton {run['newton_s']:.2f} s", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--nc", type=int, nargs="+", default=[16, 32, 64, 128])
    parser.add_argument("--i2", action="store_true")
    opts = parser.parse_args()
    torch.set_num_threads(min(8, torch.get_num_threads()))
    for nc in opts.nc:
        levels = max(2, int(math.log2(nc // 16)) + 1)
        report(f"I1 {nc}^2 {levels} levels f64",
               solve_i(setup_i(nc, levels, torch.float64, opts.device)))
    if opts.i2:
        f32 = torch.float32
        report(f"I2 ns_newton {NC_I2}^2 {LEVELS_I2} levels f32",
               solve_i(setup_i(NC_I2, LEVELS_I2, f32, opts.device, graddiv=False, atol=1e-8)))
        run = solve_i(setup_i(NC_I2, LEVELS_I2, f32, opts.device, atol=3e-3))
        report(f"I2 ns_graddiv {NC_I2}^2 {LEVELS_I2} levels f32", run)
        _, _, rnorms = NewtonRefinement(run["fgmres"], niter=2).refine(
            run["prob"], run["x"], run["probe"].setup_state)
        rmax = float(np.nanmax(run["stats"].residuals.numpy()))
        print(f"I2 NewtonRefinement(niter=2): compensated residuals "
              + " ".join(f"{v:.3e}" for v in rnorms)
              + f", relative to the Newton history's max {rnorms[-1] / rmax:.3e}", flush=True)


if __name__ == "__main__":
    main()
