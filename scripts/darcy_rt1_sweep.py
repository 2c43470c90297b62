#!/usr/bin/env python3
"""Path J's Darcy configurations at several sizes, on the CPU or the card:
the RT1 x P1disc DarcyGMG solve (J1) and, with --j3, the RT0 H(div)
GMG-CG (J3). `chip_smoke.py` takes the FGMRES and CG iteration bands of its
NC_J^2 and NC_J3^2 runs from the f64 runs here.

    python3 scripts/darcy_rt1_sweep.py [--device cpu] [--nc 16 32 64 128 256]
        [--j3]

J1's configuration is chip_smoke.setup_j's: darcy_rt1_problem and
darcy_rt1_solver (alpha 1e2, FGMRES(20) rtol 1e-10 <= 40, upper
block-triangular [RT1 GMG with Richardson(10, 0.2) over the vertex-star
Vanka and exact nested transfers; Jacobi-CG on -(1/alpha) Mp]), the GMG
coarsened to 16^2 cells (one level, the dense LU alone, at 16^2), in f64.
It prints FGMRES iterations and flag, residual_norm, velocity_error, the
true relative residual and set-up and solve seconds. J3's is
hdiv_gmg(alpha 1e2, levels to 16^2) as CG's preconditioner (rtol 1e-6 <= 20)
on hdiv_operator with a seeded exact solution: CG iterations and the
relative error.
"""
from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import (  # noqa: E402
    DARCY_ALPHA,
    J3_MAXITER,
    J3_RTOL,
    setup_j,
    solve_j,
)
from gridapsolvers_tpu_torch.fem import hdiv  # noqa: E402
from gridapsolvers_tpu_torch.linear import CGSolver  # noqa: E402
from gridapsolvers_tpu_torch.utils import pytrees as pt  # noqa: E402


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--nc", type=int, nargs="+", default=[16, 32, 64, 128, 256])
    parser.add_argument("--j3", action="store_true")
    opts = parser.parse_args()
    for nc in opts.nc:
        levels = int(math.log2(nc // 16)) + 1
        run = solve_j(setup_j(nc, levels, torch.float64, opts.device))
        prob, x, st = run["prob"], run["x"], run["stats"]
        res = prob.residual_norm(x)
        print(f"J1 {nc}^2/{levels} levels: {st.niter} FGMRES its, flag {st.flag}, "
              f"residual_norm {res:.3e}, velocity_error {prob.velocity_error(x[0]):.3e}, "
              f"true relative residual {res / float(pt.norm(prob.b)):.3e}, inner CG its "
              f"{run['cg_its']}, set-up {run['setup_s']:.2f} s, solve {run['solve_s']:.2f} s",
              flush=True)
        if opts.j3:
            gmg, A, free = hdiv.hdiv_gmg((nc, nc), levels, alpha=DARCY_ALPHA,
                                         device=opts.device)
            rng = np.random.default_rng(1)
            x_true = tuple(torch.from_numpy(rng.normal(size=int(f.shape[0]))).to(f.device) * f
                           for f in free)
            cg = CGSolver(Pl=gmg, rtol=J3_RTOL, maxiter=J3_MAXITER)
            x3, s3 = cg.solve(cg.setup(A), A.matvec(x_true))
            err = float(pt.norm(pt.sub(x3, x_true)) / pt.norm(x_true))
            print(f"J3 {nc}^2/{levels} levels: {s3.niter} CG its, flag {s3.flag}, relative "
                  f"error {err:.2e}", flush=True)


if __name__ == "__main__":
    main()
