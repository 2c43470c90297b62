#!/usr/bin/env python3
"""Path N1's curl-curl + AMS configuration at several sizes, on the CPU or
the card. `chip_smoke.py` takes the CG iteration band of its NC_N^3 run
from the f64 runs here.

    python3 scripts/ams_sweep.py [--device cpu] [--nc 16 32 48]

The configuration is chip_smoke.setup_n's: make_ams((nc,)*3, alpha=1,
beta=1) (Chebyshev(3) on the edges, AMG on GᵀAG and on each Π_cᵀAΠ_c),
CG rtol 1e-8 <= 100, a seeded rhs zero on the constrained edges, in f64;
then AMSSolver.update on A scaled by 2 and a second solve. It prints both
solves' CG iterations and flags, relative residuals, the AMG levels, and
set-up (by step), update and solve seconds.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import scaled_block_operator, setup_n, solve_j  # noqa: E402
from gridapsolvers_tpu_torch.utils import pytrees as pt  # noqa: E402


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--nc", type=int, nargs="+", default=[16, 32, 48])
    opts = parser.parse_args()
    for nc in opts.nc:
        run = solve_j(setup_n((nc,) * 3, 1.0, torch.float64, opts.device))
        A, b = run["prob"].A, run["prob"].b
        rel = float(pt.norm(pt.sub(b, A.matvec(run["x"]))) / pt.norm(b))
        ams = run["state"]["Pl"]
        levels = [len(h["mats"]) for h in [ams["node"]] + list(ams["vec"])]
        coarse = [h["mats"][-1].shape[0] for h in [ams["node"]] + list(ams["vec"])]
        t0 = time.perf_counter()
        A2 = scaled_block_operator(A, 2.0)
        state2 = run["solver"].update(run["state"], A2)
        t_up = time.perf_counter() - t0
        t0 = time.perf_counter()
        x2, st2 = run["solver"].solve(state2, b)
        t_s2 = time.perf_counter() - t0
        rel2 = float(pt.norm(pt.sub(b, A2.matvec(x2))) / pt.norm(b))
        print(f"N {nc}^3 ({sum(int(t.shape[0]) for t in b)} edges): {run['stats'].niter} CG its, "
              f"flag {run['stats'].flag}, relative residual {rel:.3e}; AMG levels (node, Pi_x, "
              f"Pi_y, Pi_z) {levels}, coarsest sizes {coarse}; set-up {run['setup_s']:.2f} s ("
              + ", ".join(f"{k} {v:.2f}" for k, v in run["secs"].items())
              + f"), solve {run['solve_s']:.2f} s; after update on 2A ({t_up:.2f} s): "
              f"{st2.niter} its, flag {st2.flag}, relative residual {rel2:.3e}, solve "
              f"{t_s2:.2f} s", flush=True)
        del run, state2, x2


if __name__ == "__main__":
    main()
