#!/usr/bin/env python3
"""Path O1's MHD multifield GMG configuration at several sizes, on the CPU
or the card. `chip_smoke.py` takes the FGMRES iteration band of its
NC_O^3 run from the f64 runs here.

    python3 scripts/mhd_sweep.py [--device cpu] [--nc 12 24 48]

The configuration is chip_smoke.setup_o's: mhd_gmg((nc,)*3, levels,
gamma=1, maxiter=1) coarsened to 6^3 cells as O1 is (Richardson(2, 0.3)
over the 15-dof vertex Vanka, dense LU at 6^3) under FGMRES(30) rtol 1e-6
<= 40, in f64. It prints FGMRES iterations and flag, residual_norm
relative to ||b||, and set-up (by step) and solve seconds.
"""
from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import setup_o, solve_j  # noqa: E402
from gridapsolvers_tpu_torch.utils import pytrees as pt  # noqa: E402


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--nc", type=int, nargs="+", default=[12, 24, 48])
    opts = parser.parse_args()
    for nc in opts.nc:
        levels = int(math.log2(nc // 6)) + 1
        run = solve_j(setup_o((nc,) * 3, levels, torch.float64, opts.device))
        prob, x, st = run["prob"], run["x"], run["stats"]
        rel = prob.residual_norm(x) / float(pt.norm(prob.b))
        n = sum(int(t.shape[0]) for t in prob.b)
        print(f"O {nc}^3/{levels} levels ({n} unknowns): {st.niter} FGMRES its, flag {st.flag}, "
              f"residual_norm / ||b|| {rel:.3e}, set-up {run['setup_s']:.2f} s ("
              + ", ".join(f"{k} {v:.2f}" for k, v in run["secs"].items())
              + f"), solve {run['solve_s']:.2f} s", flush=True)
        del run


if __name__ == "__main__":
    main()
