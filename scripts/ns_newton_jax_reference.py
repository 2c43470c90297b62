#!/usr/bin/env python3
"""The JAX package's ns_newton row (bench.py:1205-1265) on the CPU, for the
port's path I2 to be compared with: the lid-driven cavity at Re = 10
(nu = 0.1), Q2/P1disc at 32^2 cells in f32, the velocity GMG on 3 levels
with Richardson(1, 0.8) over the materialized Vanka of the velocity rows
(seed_field=-1) and two cycles, FGMRES(40) rtol 1e-8 <= 100 under the upper
block-triangular preconditioner (Jacobi-CG rtol 1e-6 <= 30 on Mp), Newton
maxiter 12, rtol 1e-6, atol 1e-8, from zero. Prints the Newton iterations,
the flag and the residual history of each loop asked for.

    python3 scripts/ns_newton_jax_reference.py [--nc 32] [--loop device host]
        [--vanka materialized batched]

This script runs the reference package only (JAX on the CPU); the port's
counterpart is `scripts/ns_graddiv_sweep.py --i2`.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from gridapsolvers_tpu.blocks import (  # noqa: E402
    BlockTriangularSolver,
    MatrixBlock,
    NonlinearSystemBlock,
)
from gridapsolvers_tpu.fem.navier_stokes import navier_stokes_problem, ns_velocity_gmg  # noqa: E402
from gridapsolvers_tpu.linear import (  # noqa: E402
    CGSolver,
    FGMRESSolver,
    JacobiSolver,
    RichardsonSmoother,
)
from gridapsolvers_tpu.nonlinear import NewtonSolver  # noqa: E402
from gridapsolvers_tpu.patches import VankaSolver  # noqa: E402
from gridapsolvers_tpu.patches.materialized import MaterializedVankaSmoother  # noqa: E402


def run(nc: int, loop: str, vanka: str) -> None:
    nu = 0.1
    t0 = time.perf_counter()
    prob = navier_stokes_problem((nc, nc), nu=nu, dtype=np.float32, bc="cavity")
    if vanka == "batched":
        sm = VankaSolver(omega=1.0, seed_field=-1)
    else:
        sm = MaterializedVankaSmoother(omega=1.0, seed_field=-1)
    gmg = ns_velocity_gmg((nc, nc), num_levels=3, nu=nu,
                          smoother=RichardsonSmoother(sm, niter=1, omega=0.8), ncycles=2,
                          dtype=np.float32, bc="cavity")
    pc = BlockTriangularSolver(
        solvers=(gmg, CGSolver(Pl=JacobiSolver(), rtol=1e-6, maxiter=30)),
        blocks=((NonlinearSystemBlock(), None), (None, MatrixBlock(prob.Mp))),
        half="upper")
    fgmres = FGMRESSolver(m=40, Pr=pc, rtol=1e-8, maxiter=100)
    newton = NewtonSolver(fgmres, maxiter=12, rtol=1e-6, atol=1e-8, loop=loop)
    x, stats = newton.solve(prob, prob.zero_guess())
    h = np.asarray(stats.residuals)
    k = int(stats.niter)
    ux = float(np.asarray(x[0][0]).reshape(2 * nc + 1, 2 * nc + 1)[nc, nc])
    print(f"JAX ns_newton {nc}^2 f32 CPU loop={loop} vanka={vanka}: {k} Newton its, flag "
          f"{int(stats.flag)}, residuals " + " ".join(f"{v:.6e}" for v in h[: k + 1])
          + f", centre u_x {ux:.7f}, {time.perf_counter() - t0:.1f} s", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--nc", type=int, default=32)
    parser.add_argument("--loop", nargs="+", default=["device", "host"])
    parser.add_argument("--vanka", nargs="+", default=["materialized"])
    opts = parser.parse_args()
    for vanka in opts.vanka:
        for loop in opts.loop:
            run(opts.nc, loop, vanka)


if __name__ == "__main__":
    main()
