#!/usr/bin/env python3
"""Path P1's adaptive configuration at several base sizes, on the CPU or
the card. `chip_smoke.py` takes the CG iteration band of its NC_P^3 run
from the runs here.

    python3 scripts/amr_sweep.py [--device cpu] [--nc 32 48 64]

The configuration is chip_smoke.setup_p's: the two-bump 3D problem on an
nc^3 base, P_ROUNDS rounds of solve -> estimate_cells on every finest
patch -> mark_boxes(theta 0.3 of the front's largest estimate, max_boxes 8,
align 8) -> refine, every solve flexible CG rtol 1e-8 +
ForestPreconditioner(num_levels=5) in f64; then the set-up and solve on the
final forest (chip_smoke.build_p, solve_p). It prints each round's
iterations and boxes, the final solve's iterations, flag and relative
residual, every patch's GMG depth and coarsest size, and the set-up (by
step) and solve seconds.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import build_p, setup_p, solve_p  # noqa: E402
from gridapsolvers_tpu_torch.utils import pytrees as pt  # noqa: E402


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--nc", type=int, nargs="+", default=[32, 48, 64])
    opts = parser.parse_args()
    for nc in opts.nc:
        loop = setup_p(nc, torch.float64, opts.device)
        run = solve_p(build_p(loop["hier"], torch.float64, opts.device))
        op, b, st = run["op"], run["b"], run["stats"]
        rel = float(pt.norm(pt.sub(b, op.matvec(run["x"]))) / pt.norm(b))
        patches = ", ".join(
            f"{'x'.join(map(str, np.array(s) - 1))} cells: {len(gst['mats'])} levels, coarsest "
            f"{gst['mats'][-1].n}" for s, (_, gst) in zip(op.shapes, run["state"]["Pl"]["gmgs"]))
        print(f"P {nc}^3: rounds " + "; ".join(
            f"{r['its']} its ({r['patches']} patches), boxes {r['boxes']}" for r in loop["rounds"])
            + f" | final ({[len(lv) for lv in loop['hier'].levels]} patches per level): "
            f"{st.niter} CG its, flag {st.flag}, relative residual {rel:.3e}; patches: "
            f"{patches}; set-up {run['setup_s']:.2f} s ("
            + ", ".join(f"{k} {v:.2f}" for k, v in run["secs"].items())
            + f"), solve {run['solve_s']:.2f} s", flush=True)
        del loop, run


if __name__ == "__main__":
    main()
