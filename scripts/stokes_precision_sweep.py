#!/usr/bin/env python3
"""Path G's Stokes configuration at several sizes, in f64 and f32, on the CPU
or the card: FGMRES iterations, the true relative block residual (f64
arithmetic), the f32 floor (the f64 solution rounded to f32) and the
velocity and pressure L2 errors. `chip_smoke.py` takes its velocity-error
bounds at 512^2 cells from this script's 256^2 run.

    python3 scripts/stokes_precision_sweep.py [--device cpu] [--nc 32 64 128 256]

The GMG coarsens to 16^2 cells, as path G does. Sizes above 256^2 belong on
the card.
"""
from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import solve_g, stokes_rel_residual64  # noqa: E402
from gridapsolvers_tpu_torch.utils import pytrees as pt  # noqa: E402


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--nc", type=int, nargs="+", default=[32, 64, 128, 256])
    opts = parser.parse_args()
    torch.set_num_threads(min(8, torch.get_num_threads()))
    for nc in opts.nc:
        levels = int(math.log2(nc // 16)) + 1
        x64 = None
        for dt in (torch.float64, torch.float32):
            run = solve_g(nc, levels, dt, opts.device, maxiter=120)
            prob, x, st = run["prob"], run["x"], run["stats"]
            line = (f"{nc}^2 {levels} levels {str(dt)[6:]}: {st.niter} its, flag {int(st.flag)}, "
                    f"true rel residual {stokes_rel_residual64(prob, x):.3e}")
            if dt == torch.float64:
                x64 = x
            else:
                floor = stokes_rel_residual64(prob, pt.tree_cast(x64, dt))
                line += f" (f32 floor {floor:.3e})"
            print(line + f", velocity L2 {prob.velocity_error(x[0]):.3e}, pressure L2 "
                  f"{prob.pressure_error(x[1]):.3e}", flush=True)


if __name__ == "__main__":
    main()
