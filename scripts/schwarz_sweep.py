#!/usr/bin/env python3
"""Path M1's two-level Schwarz (GenEO) configuration at several sizes, on
the CPU or the card. `chip_smoke.py` takes the CG iteration band of its
NC_M run from the f64 runs here.

    python3 scripts/schwarz_sweep.py [--device cpu] [--n0 256 512 1024]

The configuration is chip_smoke.setup_m's: -div(kappa grad u) on n0 x 64
square cells, (0, n0/64) x (0, 1), or with --unit-square on (0, 1)^2 (kappa = 1e4 in cell columns 16-23 and 40-47, else 1; boundary
eliminated; seeded rhs), CG rtol 1e-8 <= 200 + TwoLevelSchwarzSolver with
n0 / 32 slabs of overlap 2 (M1's slab width), nev 4 and the local Neumann
matrices, in f64; and the one-level SchwarzLinearSolver on the same
slabs. It prints CG iterations and flag, the relative residual, and
set-up (by step) and solve seconds.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import NEV_M, setup_m, solve_j  # noqa: E402


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--n0", type=int, nargs="+", default=[256, 512, 1024])
    parser.add_argument("--unit-square", action="store_true")
    opts = parser.parse_args()
    for n0 in opts.n0:
        nc, ns = (n0, 64), n0 // 32
        for level in ("two", "one"):
            domain = (0.0, 1.0, 0.0, 1.0) if opts.unit_square else None
            run = solve_j(setup_m(nc, ns, NEV_M, torch.float64, opts.device, level=level,
                                  domain=domain))
            A, b, x, st = run["prob"].A, run["prob"].b, run["x"], run["stats"]
            rel = float(torch.linalg.norm(b - A.matvec(x)) / torch.linalg.norm(b))
            extra = ""
            if level == "two":
                lam = run["state"]["Pl"]["eigenvalues"]
                extra = (f", smallest gap lambda_{NEV_M + 1} / lambda_{NEV_M} "
                         f"{float((lam[:, NEV_M] / lam[:, NEV_M - 1]).min()):.3f}")
            print(f"M {level}-level {nc[0]}x{nc[1]} {'unit-square' if domain else 'square'} "
                  f"cells, {ns} slabs: {st.niter} CG its, flag "
                  f"{st.flag}, relative residual {rel:.3e}{extra}, set-up {run['setup_s']:.2f} s ("
                  + ", ".join(f"{k} {v:.2f}" for k, v in run["secs"].items())
                  + f"), solve {run['solve_s']:.2f} s", flush=True)
            del run


if __name__ == "__main__":
    main()
