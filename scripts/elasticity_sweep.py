#!/usr/bin/env python3
"""Path Ka's elasticity configuration at several sizes, on the CPU or the
card. `chip_smoke.py` takes the CG iteration band of its NC_K^3 run from
the f64 runs here.

    python3 scripts/elasticity_sweep.py [--device cpu] [--nc 16 32 64]

The configuration is chip_smoke.setup_k's: solve_elasticity's problem and
solver (clamped on the x0 face, mu = lambda = 1, unit downward body force;
CG rtol 1e-8 <= 60 + GMG with Chebyshev(4, ratio 40) and structured Q1
transfers per component) in 3D, the GMG coarsened to 8^3 cells, in f64.
It prints CG iterations and flag, the relative residual, the mean of u_z
and set-up and solve seconds.
"""
from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import setup_k, solve_j  # noqa: E402
from gridapsolvers_tpu_torch.utils import pytrees as pt  # noqa: E402


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--nc", type=int, nargs="+", default=[16, 32, 64])
    opts = parser.parse_args()
    for nc in opts.nc:
        levels = int(math.log2(nc // 8)) + 1
        run = solve_j(setup_k(nc, levels, torch.float64, opts.device))
        prob, x, st = run["prob"], run["x"], run["stats"]
        rel = prob.residual_norm(x) / float(pt.norm(prob.b))
        print(f"Ka {nc}^3/{levels} levels: {st.niter} CG its, flag {st.flag}, relative residual "
              f"{rel:.3e}, mean u_z {float(x[2].mean()):.6e}, set-up {run['setup_s']:.2f} s, "
              f"solve {run['solve_s']:.2f} s", flush=True)


if __name__ == "__main__":
    main()
