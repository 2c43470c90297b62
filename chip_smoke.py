#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gridapsolvers_tpu_torch) on one GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--profile DIR]

It builds the three hand-written kernels from `gridapsolvers_tpu_torch/csrc/`
(nvcc, sm_90a, all three at once) and drives the port's Poisson, Stokes,
Navier-Stokes, Darcy, elasticity, GenEO Schwarz, H(curl), MHD and AMR
paths, the distributed Poisson GMG-CG and the distributed Stokes flagship
through their public entry points, in phases that each print one line:

  1 device   card name and power limit (nvidia-smi), TF32 off
  2 build    the kernels, with build seconds and ptxas register counts
  3 kernels  K1 (its marching and general kernels; f32, f64 and bf16), K2
             (its box and general kernels; the Stokes velocity stiffness
             and pressure mass) and K3 (with and without row lengths; the
             Stokes B and Bt) against their plain PyTorch versions
  4 path A   solve_poisson_const (constant stencils, K1), f32, 32^3 and 128^3
  5 path B   solve_poisson (banded stencils, K2), f64, 64^3 and 128^3
  6 path C   CG + smoothed-aggregation AMG (K2 finest level, K3 below and
             for every transfer), f32, 32^3 and 128^3
  6D path D  mixed-precision GMG (bf16 K1 smoothing, f32 residuals) under
             flexible CG, and its f32 twin, 32^3 (card = CPU) and 128^3
  6E path E  f32 iterative refinement (banded K2 GMG-CG, two-float
             residuals) to an f64-grade residual, 128^3
  6F path F  FGMRES(30) + path D's mixed GMG and MINRES + path A's GMG,
             32^3 (card = CPU) and 128^3
  6G path G  plain Stokes (BASELINE config 3): Taylor-Hood Q2/Q1, FGMRES(20)
             + upper block-triangular preconditioner (velocity GMG on
             banded K2 levels, pressure-mass Jacobi-CG on K2), couplings B
             and Bt on K3; 32^2 (card = CPU), solve_stokes at 16^2 (f64),
             and 512^2 in f64 and f32
  6H path H  augmented-Lagrangian Stokes (grad-div alpha 1e3, Q2/P1disc):
             the bench's f32 run at 96^2 (card = CPU, and one V-cycle card
             against CPU on the same operators); H2, solve_stokes at 64^2
             (block engine: banded K2 levels, batched Vanka, ELL FE
             transfers on K3; card = CPU, and the flat engine's iterations
             equal to it); H1, the flat engine (every velocity block, the
             materialized Vanka, the patch prolongations, B, Bt and Mp on K3)
             at 512^2 in f64, its launches counted by block in set-up and
             solve; then K3 on every block of every level and K2 on the
             25-band blocks of H1 and H2 against their plain versions
  6I path I  Navier-Stokes and Newton (BASELINE config 4), the lid-driven
             cavity at Re = 10: I2, the JAX bench's ns_newton and
             ns_graddiv rows at 32^2 in f32 (card = CPU Newton counts;
             two-float NewtonRefinement after ns_graddiv); I1, ns_graddiv
             (grad-div alpha 1e3, nonlinear velocity GMG with Chebyshev(4)
             over the materialized Vanka refreshed at every Newton step,
             patch prolongations, FGMRES(20), the values-only refresh
             walker) at 512^2 in f64, its K3 launches counted by role in
             set-up and Newton phase, set-up and each Newton step timed by
             step, every refreshed block holding its set-up pattern; then K3
             on every I1 block after its last refresh
  6J path J  Darcy: J2, solve_darcy in its three branches (RT1 x P1disc at
             32^2, RT0 plain and grad-div at 64^2; card = CPU); J1, the
             reference's DarcyGMG at order 2 (RT1 x P1disc, alpha 1e2,
             FGMRES(20) + upper block-triangular [RT1 GMG with the
             vertex-star Vanka, Jacobi-CG on -(1/alpha) Mp]) at 512^2 in
             f64, 6 levels: K2's general kernel on the RT1 diagonal blocks,
             K3 on the cross blocks, B, Bt and Mp, its launches counted by
             operand shape, set-up timed by step, host syncs measured; J3,
             the RT0 H(div) GMG under CG at 512^2 (K3); then each of their
             operators against its plain version
  6K path K  linear elasticity: Kb, solve_elasticity at 32^3 and Kc, CG +
             AMG with rigid-body candidates at 64^2 (card = CPU); Ka,
             solve_elasticity's configuration at 128^3 in f64, 5 levels
             (nine K2 launches an operator apply: the box kernel on the
             27-offset blocks, the general kernel on the others), counted,
             set-up by step, host syncs measured; then K2 on the nine
             level-0 blocks against its plain version
  6L path L  at 32^3, card = CPU: ColoredGaussSeidel (masked, compact, SSOR)
             under CG, a GMG built from an FESpaceHierarchy, and an
             L2ProjectionRestriction
  6M path M  two-level Schwarz with GenEO (the reference's HPDDM analog):
             M2 at 32 x 8 cells (one-level, two-level with and without
             Neumann matrices, the nested coarse solver; card = CPU); M1,
             -div(kappa grad u) with high-contrast channels on 2048 x 64
             cells in f64, 64 slabs, nev 4, the batched Cholesky/eigh pencil
             on the card, CG (K2 on the 9-band operator), counted by operand
             shape, set-up by step, beside the one-level solver
  6N path N  H(curl) curl-curl + AMS: N2 at 16^2 and 8^3, alpha 1 and 100
             (card = CPU); N1, make_ams at 64^3 in f64 under CG, then
             AMSSolver.update on 2A and a second solve (K3 on the edge
             blocks, G, Gt, Pi_c, Pi_ct and four AMG hierarchies), counted
             by operand shape
  6O path O  3D MHD multifield GMG: O2 at 8^3 (V, W, F cycles, gamma 1
             and 10; card = CPU); O1, mhd_gmg at 96^3 with 5 levels in f64
             under FGMRES(30) (K3 on the 6 x 6 blocks of every level),
             counted by operand shape; then each path's operators against
             their plain versions
  6P path P  block-structured AMR: P2, the tests' AMR solves at 16^2 and
             12^3 (adaptive_solve, composite_solve with kappa,
             adaptive_solve_scattered, forest_solve with Jacobi and FAC,
             a partial-overlap seam; card = CPU); P1, the two-bump 3D
             problem on a 128^3 base, two rounds of solve -> estimate ->
             mark_boxes -> refine, then the counted set-up and solve on the
             three-level forest (flexible CG + ForestPreconditioner: a GMG
             V-cycle per patch, K2's box kernel on every patch operator and
             GMG level) in f64, its energy error on the 512^3 frame against
             the coarse-only solve's; then K2 on its base composite, largest
             patch and base GMG level-0 operators against the plain version
  6Q path Q  the distributed Poisson GMG-CG (parallel.distributed_poisson_gmg
             + CG, 128^3 cells, f64, 4 levels, Chebyshev(3) on Gershgorin
             bounds) through parallel.launch.run_ranks: Q1 on one rank over
             NCCL, held against the serial GMG-CG of the same levels
             (iterations equal, x to 1e-10 of max|x|); Q2 on two gloo ranks
             sharing the card (blocks and K2 on the card, halo slabs and
             reductions through pinned host buffers), held against Q1; each
             rank's K2 launches by extended block shape against
             k2_launches_formula, and its messages per iteration; then K2 on
             Q2's level-0 extended blocks against its plain version
  6R path R  the distributed Stokes flagship (fem.dist_stokes_nd: FGMRES(30)
             + upper block-triangular velocity GMG on box-partitioned
             DistGraphELL levels and pressure-mass Jacobi-CG; 512^2 cells,
             f64, 6 levels) through parallel.launch.run_ranks: R1 on one
             rank over NCCL (mesh (1, 1)), and the serial twin over
             fem.stokes.velocity_gmg, each within 1 iteration of its own
             count in the CPU sweep at this size, and R1's u to 5e-7 and p
             to 1e-6 of the twin's; R2 on two gloo ranks sharing the card
             through the 1-D spelling fem.dist_stokes (mesh (2,)), held
             against R1 (iterations within 1, the same u and p atol); each
             rank's K3 launches by operand shape (the extended window of
             every local apply) against k3_launches_formula, and its
             messages per FGMRES iteration; then K3 on R2's rank-0 level-0
             extended-window K, B and Bt blocks against its plain version
  7 K3 ops   K3 on path C's own 128^3 level operators, P and R (f32, bf16
             values, one f64 level) against its plain version
  8 times    per-apply kernel, plain, library and bound times (K1
             marching against general at every path A level, cold and warm
             L2, in f32 and bf16, and its run-length sweep; K2 box against
             general; K3 with each operator's fill, read to row lengths and
             in full; K2 and K3 on path G's 512^2 operators; K3 on path H's
             512^2 operators and K2 on its banded blocks; K3 on path I1's
             level-0 Jacobian blocks; K2 and K3 on paths J, K, M, N and O's
             operators, cold and warm, beside cuSPARSE int32 and int64; K2
             on path P1's three operators and path Q2's level-0 extended
             blocks likewise, K3 on path R2's extended-window blocks), K3's
             lanes sweep, and each 128^3 and 512^2 solve

Each path's 128^3 run starts with every launch count at 0 and is read
right after, so the counts show that every operator apply went through
the kernels, every K1 launch through its marching kernel (in the dtype
the code gives it: bf16 inside path D's smoothers) and every K2 launch
through its box kernel (path G's 2D operators: its general kernel). Any
failed check
raises, so a failure exits non-zero. The
line before the last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}. Without CUDA it exits non-zero before
printing any result. `--profile DIR` adds a torch.profiler trace of one
path C, G, H, J1, Ka, M1, N1, O1 and P1 solve each and of path I1's
Newton run (kernel tables in DIR, summary lines printed).
"""
from __future__ import annotations

import argparse
import collections
import concurrent.futures
import dataclasses
import functools
import itertools
import json
import math
import statistics
import subprocess
import sys
import time
import types
import warnings
import weakref
from pathlib import Path

import numpy as np
import scipy.sparse as sp
import torch

# imported before anything is printed: a copy of this script without the
# package fails here, with no output
import gridapsolvers_tpu_torch.algebra.flat as flat_mod
import gridapsolvers_tpu_torch.fem.assembly as asm_q1
import gridapsolvers_tpu_torch.fem.elasticity as el_mod
import gridapsolvers_tpu_torch.fem.hcurl as hcurl_mod
import gridapsolvers_tpu_torch.fem.hdiv as hdiv_mod
import gridapsolvers_tpu_torch.fem.mhd as mhd_mod
import gridapsolvers_tpu_torch.fem.navier_stokes as ns_mod
import gridapsolvers_tpu_torch.fem.rt1 as rt1_mod
import gridapsolvers_tpu_torch.fem.stokes as stokes_mod
import gridapsolvers_tpu_torch.linear.schwarz as schwarz_mod
import gridapsolvers_tpu_torch.linear.smoothers as smoothers_mod
import gridapsolvers_tpu_torch.multilevel.adaptive as adaptive_mod
import gridapsolvers_tpu_torch.multilevel.forest as forest_mod
import gridapsolvers_tpu_torch.multilevel.transfer as transfer_mod
import gridapsolvers_tpu_torch.patches.smoothers as psm_mod
import gridapsolvers_tpu_torch.patches.topology as topology_mod
from gridapsolvers_tpu_torch import native
from gridapsolvers_tpu_torch.algebra import ell_from_scipy, stencil_from_scipy, to_scipy
from gridapsolvers_tpu_torch.algebra.block import BlockOperator, ColumnStack, RowStack
from gridapsolvers_tpu_torch.algebra.ell import ELLMatrix
from gridapsolvers_tpu_torch.algebra.flat import BlockedKernelOperator
from gridapsolvers_tpu_torch.algebra.stencil import StencilMatrix
from gridapsolvers_tpu_torch.blocks import (
    BlockTriangularSolver,
    LinearSystemBlock,
    MatrixBlock,
    NonlinearSystemBlock,
)
from gridapsolvers_tpu_torch.fem import CartesianMesh, poisson_problem
from gridapsolvers_tpu_torch.fem.assembly import eliminate_dirichlet, laplacian, laplacian_const
from gridapsolvers_tpu_torch.fem import assembly2 as asm
from gridapsolvers_tpu_torch.fem.stokes import stokes_problem, velocity_gmg
from gridapsolvers_tpu_torch.interfaces import rigid_body_modes
from gridapsolvers_tpu_torch.linear import (
    AMGSolver,
    CGSolver,
    ChebyshevSmoother,
    ColoredGaussSeidel,
    DenseInverseSolver,
    DenseLUSolver,
    FGMRESSolver,
    IterativeRefinementSolver,
    JacobiSolver,
    MINRESSolver,
    PreconditionedChebyshevSmoother,
    RichardsonSmoother,
)
from gridapsolvers_tpu_torch.linear.gmg import GMGSolver, gmg_from_hierarchy
from gridapsolvers_tpu_torch.models import (
    poisson_const_gmg,
    solve_darcy,
    solve_elasticity,
    solve_poisson,
    solve_poisson_const,
    solve_stokes,
)
from gridapsolvers_tpu_torch.multilevel import (
    cartesian_hierarchy,
    fe_space_hierarchy,
    setup_projection_restrictions,
)
from gridapsolvers_tpu_torch.nonlinear import NewtonSolver
from gridapsolvers_tpu_torch.nonlinear.refinement import NewtonRefinement
from gridapsolvers_tpu_torch.ops import banded_stencil as k2
from gridapsolvers_tpu_torch.ops import build
from gridapsolvers_tpu_torch.ops import const_stencil as k1
from gridapsolvers_tpu_torch.ops import ell_spmv as k3
from gridapsolvers_tpu_torch.patches import (
    MaterializedVankaSmoother,
    PatchProlongation,
    VankaSolver,
)
from gridapsolvers_tpu_torch.utils import pytrees as pt

F32_TOL = 1e-6   # max|y - y_ref| / max|y_ref|: reordered f32 sums, FMA contraction
F64_TOL = 1e-13
# bf16 K1 against its plain version: both sum in f32 (in other orders) and
# round once, so they differ by at most one bf16 ulp of max|y_ref|,
# 2^(floor(log2 max|y_ref|) - 7), which lies between 2^-8 and 2^-7 of it
BF16_X_TOL = 2.0 ** -8   # x of a bf16-preconditioned solve, card against CPU
TIMING_RUNS = 30
DEVICE = "cuda:0"
NC = 128                 # cells per axis of the main-path runs (129^3 dofs)
ITS = {"A": (4, 4), "B": (6, 6), "C": (7, 9)}   # CG iterations asserted at NC^3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# path G: the JAX bench's Stokes configuration (bench.py:693-706) at NC_G^2
# cells, its velocity GMG down to 16^2 cells (a 2 x 33^2 dense LU)
NC_G = 512
STOKES_RTOL = 1e-6
# solve_stokes((16, 16), num_levels=3) in f64: FGMRES iterations of the JAX
# package on the CPU (tests/test_torch_stokes.py holds the port equal to it)
JAX_STOKES_16_ITS = 27
# velocity L2 error bounds at NC_G^2 from scripts/stokes_precision_sweep.py
# at 256^2 cells on the CPU: f64 4.519e-8 (the error does not grow as h
# shrinks), f32 3.885e-6 times 8 (in f32 it grew ~4x per halving of h from
# 64^2 to 256^2: the f32 rounding of u, amplified by 1/h^2)
VEL_ERR_BOUND = {torch.float64: 4.519e-8, torch.float32: 8 * 3.885e-6}
# the f32 run at NC_G^2 takes 69 FGMRES iterations on an H100 80GB HBM3
# (700 W), over the bench's maxiter 60 (PERF.md section 6): it runs with
# maxiter 120 and is held to this band around the reading
STOKES_F32_ITS_MAX = 75
# the 32^2 f32 solve's x, card against the CPU plain path: 3.3e-7 relative on
# an H100 80GB HBM3 (700 W); about 30x that
SMALL_G_TOL = 1e-5
# path H: the augmented-Lagrangian Stokes configuration of the JAX bench
# (bench.py:751-786: grad-div alpha 1e3, Q2/P1disc, flat engine, Chebyshev(4)
# over the materialized Vanka, FGMRES(20) rtol 1e-8 <= 30 its) at NC_H^2
# cells in f64, its velocity GMG down to 16^2 cells (a 2 x 33^2 dense LU)
NC_H = 512
GD_ALPHA = 1e3
GD_RTOL = 1e-8
GD_MAXITER = 30
# FGMRES iterations at NC_H^2: 8 on an H100 80GB HBM3 (700 W), as in the
# CPU sweep at every size (scripts/stokes_graddiv_sweep.py); the band reaches
# to the JAX package's counts in BENCH_* (8 and 10 at 64^2, 10 at 96^2)
H_ITS = (7, 10)
# velocity and pressure L2 error bounds at NC_H^2: twice the port's f64
# errors at 256^2 cells on the CPU (scripts/stokes_graddiv_sweep.py --to16:
# 1.1831e-11 and 3.3029e-8). The exact pressure is linear, so P1disc holds
# it and what is left is mostly the solve's: from 64^2 to 256^2 the pressure
# error moved with the final residual ratio (5.2e-9 to 5.9e-9 there, up to
# twice that within rtol 1e-8), not with h
H_VEL_ERR_BOUND = 2 * 1.1831e-11
H_PRE_ERR_BOUND = 2 * 3.3029e-8
# the bench's own f32 run: its size (stokes_graddiv_nc 96 in BENCH_FULL_r04)
# and 3 levels, card = CPU
NC_H_F32, LEVELS_H_F32 = 96, 3
# its x against the f64 solution: the card's error may exceed the CPU's by
# this much of max|x| (on an H100 80GB HBM3, 700 W, the card's x and the
# CPU's differed by 1.98e-3 of max|x|)
H_F32_TOL = 1e-3
# one V-cycle of that run's velocity GMG on the same operators and input,
# card against CPU. In f32 the CPU's own cycle departs from the same cycle in
# f64 arithmetic by 7.55e-5 of max|y| at 96^2 (the coarse LU amplifies
# rounding), so two f32 cycles that sum in other orders may differ by about
# twice that: 4x the reading. Widened to f64, the same amplification
# (7.55e-5 over f32's 6e-8, ~1.3e3) of f64 rounding gives ~1.4e-13: 1e-10
H_VCYCLE_F32_TOL = 3e-4
H_VCYCLE_F64_TOL = 1e-10
# path H2: solve_stokes((NC_H2, NC_H2), graddiv_alpha=1e3) (block engine), f64
NC_H2 = 64
H2_TOL = 1e-8        # its x, card against CPU (atomic scatter sums on the card)
# path I: Navier-Stokes (BASELINE config 4), the lid-driven cavity at Re = 10.
# I1: the JAX bench's ns_graddiv row (the reference's NavierStokesGMG
# configuration) at NC_I^2 cells in f64, its velocity GMG down to 16^2 cells;
# I2: the bench's ns_newton and ns_graddiv rows at their own size in f32
NC_I = 512
NS_NU = 0.1
# I1's bands, set before the first card run from scripts/ns_graddiv_sweep.py
# on the CPU (f64, the velocity GMG to 16^2 cells): 3 Newton steps at 64^2,
# 128^2 and 256^2 (4 at 16^2 and 32^2), FGMRES its by step [1, 8, 8] at
# every size; the centre u_x -0.2051615732 at 128^2 and -0.2051616931 at
# 256^2, bounded at NC_I^2 by twice that change around the 256^2 value
I_NEWTON_ITS = (3, 4)
I_FGMRES_ITS = (1, 12)
I_UX_CENTRE = -0.2051616931
I_UX_BOUND = 2 * abs(-0.2051616931 - -0.2051615732)
NC_I2, LEVELS_I2 = 32, 3
# path J: Darcy. J1, the reference's DarcyGMG at order 2 (RT1 x P1disc,
# alpha 1e2; fem/rt1.py darcy_rt1_solver with solve_darcy's rtol and
# min(maxiter, 40)) at NC_J^2 cells in f64, its RT1 GMG down to 16^2 cells
# (a 2 x 33 x 32 dense LU; solve_darcy's 3 levels would leave 131 584)
NC_J = 512
DARCY_ALPHA = 1e2
J_RTOL = 1e-10
J_MAXITER = 40
# FGMRES iterations: 7 at every size from 32^2 to 256^2 (levels to 16^2)
# in scripts/darcy_rt1_sweep.py on the CPU, set before the first card run;
# the band reaches the JAX package's 8 at 8^2 (2 levels)
J_ITS = (6, 9)
# the reference's final checks (tests/test_hdiv.py:201-202)
J_RES_BOUND = 1e-5
J_VEL_BOUND = 1e-5
# J2: solve_darcy card = CPU, order 2 at NC_J2^2 on 3 levels and both RT0
# branches at NC_J2_RT0^2 (they build a dense n_p x n_p identity, as the
# JAX package does); x card against CPU (atomic scatter sums in the Vanka)
NC_J2, NC_J2_RT0 = 32, 64
J2_TOL = 1e-8
# J3: hdiv_gmg as CG's preconditioner on hdiv_operator (tests/test_hdiv.py:58:
# rtol 1e-6, <= 20 its) at NC_J3^2, alpha 1e2, levels down to 16^2
# (5 CG its at every size from 32^2 to 256^2 in scripts/darcy_rt1_sweep.py
# --j3 on the CPU)
NC_J3 = 512
J3_RTOL, J3_MAXITER = 1e-6, 20
J3_ITS = (4, 7)
# path K: linear elasticity. Ka, solve_elasticity's configuration (CG rtol
# 1e-8 <= 60, GMG Chebyshev(4, ratio 40)) in 3D at NC_K^3 cells in f64, 5
# levels down to 8^3 (a 3 x 9^3 dense LU); its CG band around the 9 its of
# scripts/elasticity_sweep.py on the CPU at 16^3, 32^3 and 64^3
NC_K, LEVELS_K = 128, 5
K_RTOL, K_MAXITER = 1e-8, 60
K_ITS = (8, 11)
# Kb: solve_elasticity((NC_KB,)*3, num_levels=3) and Kc: CG + AMG with
# rigid-body candidates at NC_KC^2 (tests/test_amg.py:45-67), card = CPU,
# x to K_SMALL_TOL of max|x|
NC_KB, NC_KC = 32, 64
K_SMALL_TOL = 1e-8
# path L: the small modules at NC_L^3, card = CPU (iterations equal, x and
# the projection to L_TOL of their largest entry)
NC_L = 32
L_SSOR_MAXITER = 200
L_TOL = 1e-8
# path M: two-level Schwarz with GenEO (the reference's HPDDM/PCHPDDM
# analog). M1: -div(kappa grad u) on NC_M square cells ((0, 32) x (0, 1))
# in f64, boundary eliminated (on the unit square the cells would be 32:1
# and the two-level iterations grow with the slab count: 48, 73, 121 at
# 8, 16, 32 slabs, scripts/schwarz_sweep.py at (0, 1)^2), kappa = 1e4 in
# the cell columns M_CHANNELS of the second axis
# (tests/test_schwarz.py's channels scaled from 16 to 64 cells; they cross
# every slab interface), else 1; NS_M slabs of overlap 2, nev NEV_M, local
# Neumann matrices (true GenEO); CG rtol 1e-8 <= 200; its band from
# scripts/schwarz_sweep.py on the CPU; the one-level solver beside it on
# the same operator must take more iterations. M2 (card = CPU): the test
# size, M2_NC cells, kappa 1e4 in cell column 2, ns in (2, 4), nev 2
NC_M, NS_M, NEV_M = (2048, 64), 64, 4
M_CHANNELS = ((16, 24), (40, 48))
M_RTOL, M_MAXITER = 1e-8, 200
M_ITS = (15, 26)
M2_NC = (32, 8)
M2_TOL = 1e-8
# path N: H(curl) curl-curl with AMS. N1: make_ams((NC_N,)*3, alpha 1,
# beta 1) in f64 (vector correction on: Chebyshev(3) on the edges, AMG on
# GᵀAG and on each Π_cᵀAΠ_c), CG rtol 1e-8 <= 100, then AMSSolver.update
# on A scaled by 2 and a second solve; its band from scripts/ams_sweep.py.
# Its size is bounded by the four host AMG set-ups (scipy), as in the JAX
# package. N2 (card = CPU): 16^2 and 8^3, alpha in (1, 100), its equal and
# <= 40 (tests/test_hcurl.py)
NC_N = 64
N_RTOL, N_MAXITER = 1e-8, 100
N_ITS = (50, 90)
N2_TOL = 1e-6
N2_SINGULAR_TOL = 1e-2
# path O: 3D MHD multifield GMG. O1: mhd_gmg((NC_O,)*3, LEVELS_O, gamma 1,
# maxiter 1) in f64 under FGMRES(30) rtol 1e-6 <= 40 (tests/test_multifield.py:
# 36-45), Richardson(2, 0.3) over the 15-dof vertex Vanka, dense LU at 6^3;
# its band from scripts/mhd_sweep.py; residual_norm < O_RES_REL * ||b||.
# O2 (card = CPU): 8^3, 2 levels, the V, W and F cycles and gamma in (1, 10)
NC_O, LEVELS_O = 96, 5
O_RTOL, O_MAXITER = 1e-6, 40
O_ITS = (5, 9)
O_RES_REL = 1e-5
O2_TOL = 1e-8
# path P: block-structured AMR. P1: the two-bump 3D problem of
# tests/test_forest.py:156-200 (C3 = 300, centres (0.25,)^3 and (0.75,)^3,
# -lap u3 = f3 on the unit cube) on a NC_P^3 base; P_ROUNDS rounds of solve
# -> estimate_cells on each finest patch -> mark_boxes(theta 0.3 of the
# front's largest estimate, max_boxes 8, align 8) -> refine, every solve
# flexible CG (rtol P_RTOL) + ForestPreconditioner(num_levels=P_LEVELS) in
# f64; the counted run is the set-up and solve on the final forest. The FAC
# preconditioner is not h-robust: scripts/amr_sweep.py reads 48, 52, 86, 96
# its at bases 32^3-96^3, and the band below was set after the card's first
# 128^3 run read 152. P2 (card = CPU): the tests' AMR drivers and solves at
# 16^2 and 12^3, x within P2_TOL of max|x|
NC_P = 128
P_ROUNDS = 2
P_THETA, P_MAX_BOXES, P_ALIGN = 0.3, 8, 8
P_LEVELS = 5
P_RTOL, P_MAXITER = 1e-8, 400
P_ITS = (120, 190)
P_C3 = 300.0
P_CENTRES = ((0.25, 0.25, 0.25), (0.75, 0.75, 0.75))
P2_TOL = 1e-8
# path Q: the distributed Poisson GMG-CG (parallel.distributed_poisson_gmg
# + CGSolver, rtol Q_RTOL) at NC_Q^3 cells in f64 with path A's level count
# and Chebyshev(3) on Gershgorin bounds (the same bound on every split: a
# Lanczos estimate starts from a vector of the padded grid's length, so
# it would part Q2 from Q1). Q1: world size 1 over NCCL, held against the
# serial GMG-CG of the same levels, transfers and smoother; Q2: 2 gloo ranks
# on the one card (blocks and kernels on the card, messages through
# pinned host buffers), held against Q1. scripts/dist_sweep.py gives the
# iterations on the CPU (7 at 32^3 and 64^3 for every layout)
NC_Q, LEVELS_Q = 128, 4
Q_RTOL, Q_MAXITER = 1e-8, 30
Q_SMOOTHER = {"degree": 3, "eig_method": "gershgorin"}
Q_ITS = (5, 12)
Q_X_TOL = 1e-10
# path R: the distributed Stokes flagship (fem.dist_stokes_nd: FGMRES(30) +
# upper block-triangular velocity GMG on box-partitioned DistGraphELL levels
# and pressure-mass Jacobi-CG, rtol 1e-8) at NC_R^2 cells (path G's size)
# in f64 with LEVELS_R levels (a 16^2 coarsest mesh). R1: one NCCL rank,
# mesh (1, 1), and the serial twin (the same FGMRES(30) and preconditioner
# over fem.stokes.velocity_gmg and Jacobi-CG on prob.Mp) are each held
# within one iteration of its own count in the port's CPU sweep of this
# configuration (R_CPU_ITS, R_CPU_TWIN_ITS: scripts/dist_sweep.py --stokes
# --nc 512 --worlds 1), and R1's u and p within R_U_ATOL and R_P_ATOL of
# the twin's; R2: two gloo ranks sharing the card through the 1-D spelling
# (fem.dist_stokes, mesh (2,)), held against R1 (iterations within one, u
# and p likewise). R1 is not held within one iteration of the twin: the
# twin's transfers are the linear node-grid ones where the flagship has
# exact Q2 embeddings, and in the JAX package too their counts part beyond
# 16^2 (twin 42/47/50 against flagship 41/42/48 at 64^2-256^2; the port's
# equal JAX's on every layout there; no JAX count exists at 512^2).
# R_VEL_ERR_BOUND is 1.5x the sweep's velocity error at this configuration
# (1.9484e-10 on the CPU; solver-limited from 128^2 on, so it no longer
# falls with h). A CPU rehearsal at another size sets the two counts and
# the bound from the sweep at that size.
NC_R, LEVELS_R = 512, 6
R_MAXITER = 60
R_CPU_ITS, R_CPU_TWIN_ITS = 50, 53
R_U_ATOL, R_P_ATOL = 5e-7, 1e-6
R_VEL_ERR_BOUND = 1.5 * 1.9484e-10
# COMMS_r05.json: the JAX design's loop-body collectives of its stokes
# FGMRES iteration (8 devices), a count to set beside the port's, not a target
R_JAX_LOOP = {"collective-permute": 54, "all-reduce": 8}
KERNELS = ("const_stencil", "banded_stencil", "ell_spmv")
COUNTS = {"K1": k1.counts, "K2": k2.counts, "K3": k3.counts}


def bf16_ulp(m: float) -> float:
    """One bf16 ulp at magnitude m (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(m)) - 7)


@dataclasses.dataclass(frozen=True)
class Recorded:
    """A solver that records the iteration count of each of its solves (for
    launch-count formulas); the solves are `inner`'s."""

    inner: object
    its: list

    def setup(self, A, x=None):
        return self.inner.setup(A, x)

    def solve(self, state, b, x0=None):
        x, stats = self.inner.solve(state, b, x0)
        self.its.append(stats.niter)
        return x, stats

    def apply(self, state, r):
        return self.solve(state, r)[0]


def relerr(y, y_ref) -> float:
    return float((y.double() - y_ref.double()).abs().max() / y_ref.double().abs().max())


def abserr(y, y_ref) -> float:
    return float((y.double() - y_ref.double()).abs().max())


def reset_counts() -> None:
    for c in COUNTS.values():
        c.reset()


def read_counts(k2_box: bool = True) -> dict:
    """Kernel launches by kernel; raises if any plain version ran or a K1
    launch took its general kernel, or if a K2 launch took its general
    kernel (`k2_box`) or its box kernel (not `k2_box`: 2D operators)."""
    plain = {k: c.plain for k, c in COUNTS.items() if c.plain}
    assert not plain, f"plain versions ran on the main path: {plain}"
    assert k1.counts.march == k1.counts.kernel, (
        f"K1 general kernel on the main path: {k1.counts.kernel - k1.counts.march} launches")
    want_box = k2.counts.kernel if k2_box else 0
    assert k2.counts.box == want_box, (
        f"K2 box kernel took {k2.counts.box} of {k2.counts.kernel} launches, want {want_box}")
    return {k: c.kernel for k, c in COUNTS.items()}


def cg_gmg_applies(niter: int, levels: int, degree: int) -> int:
    """Operator applies of one GMG-preconditioned CG solve (linear/cg.py,
    linear/gmg.py): the initial residual and one apply per iteration, plus
    niter+1 V-cycles. A V-cycle applies the operator `degree` times per
    Chebyshev sweep (pre and post) and once for the correction residual on
    each of the levels-1 smoothing levels, and once on the coarsest."""
    return (niter + 1) * ((levels - 1) * (2 * degree + 1) + 2)


def cg_gmg_level_applies(niter: int, levels: int, degree: int) -> list:
    """cg_gmg_applies by level, finest first: CG's applies go to the finest
    level, each V-cycle's (2k+1) to every smoothing level and one to the
    coarsest."""
    per = [(niter + 1) * (2 * degree + 1)] * (levels - 1) + [niter + 1]
    per[0] += niter + 1
    return per


def cg_amg_applies(niter: int, levels: int, degree: int, lanczos: int):
    """(K2, K3) launches of one AMG-preconditioned CG run from set-up to L2
    error (linear/amg.py, linear/cg.py, linear/smoothers.py). Set-up: one
    Lanczos run on every smoothing level (the finest is the stencil, K2).
    Solve: CG applies the stencil once at the start and once per
    iteration; each of the niter+1 V-cycles applies every smoothing level
    2k+1 times, the coarsest once (its residual) and each of the L-1 P and
    R once. The L2 error applies the mass stencil once."""
    k2_count = lanczos + (niter + 1) * (2 * degree + 2) + 1
    k3_count = lanczos * (levels - 2) + (niter + 1) * (
        (levels - 2) * (2 * degree + 1) + 1 + 2 * (levels - 1))
    return k2_count, k3_count


def fgmres_applies(n: int, m: int) -> int:
    """System applies of one FGMRES(m) solve of n iterations from zero
    (linear/gmres.py): the initial residual, one a restart cycle and one an
    iteration."""
    return 1 + -(-n // m) + n


def stokes_launches(nc: int, n: int, cg_its: list, levels: int, degree: int, lanczos: int,
                    m: int) -> dict:
    """Launches of one path G run at nc^2 cells, from `stokes_problem` to
    the end of the solve (fem/stokes.py, linear/gmres.py,
    blocks/block_solvers.py, linear/gmg.py, linear/cg.py), by kernel and
    by the operand shape its wrapper counts (`counts.shapes`): K2 on each
    level's Q2 velocity stiffness (25 bands on its node grid) and on the
    Q1 pressure mass (9 bands), K3 on B (pressure rows x velocity columns),
    Bt and the velocity mass Mu. Each velocity operator applies K2 or K3
    once a component (two). The problem applies Mu once for the load.
    Set-up: one Lanczos run on every smoothing level. FGMRES applies the
    block operator (K, B and Bt) once at the start, once a restart cycle
    and once an iteration; each of the n preconditioner applies runs the
    pressure CG (its iterations + 1 pressure-mass applies), Bt once and one
    V-cycle, which applies each smoothing level's operator 2k+1 times and
    the coarsest level's once."""
    applies = fgmres_applies(n, m)
    nu, npr = (2 * nc + 1) ** 2, (nc + 1) ** 2
    k2_count = {}
    for lev in range(levels):
        g = 2 * (nc >> lev) + 1
        per = n if lev == levels - 1 else lanczos + n * (2 * degree + 1)
        k2_count[(25, g, g)] = 2 * (per + (applies if lev == 0 else 0))
    k2_count[(9, nc + 1, nc + 1)] = sum(c + 1 for c in cg_its)
    k3_count = {(npr, nu): 2 * applies, (nu, npr): 2 * (applies + n), (nu, nu): 2}
    return {"K2": k2_count, "K3": k3_count}


def stokes_rel_residual64(prob, x) -> float:
    """||b - A x|| / ||b|| over every block, in f64 arithmetic on the card
    (the operators' stored values and x widened to f64)."""
    A = pt.tree_cast(prob.A, torch.float64)
    b = pt.tree_cast(prob.b, torch.float64)
    return float(pt.norm(pt.sub(b, A.matvec(pt.tree_cast(x, torch.float64)))) / pt.norm(b))


def solve_g(nc, levels, dtype, device, maxiter=60):
    """Path G through the public API: the JAX bench's Stokes configuration
    (bench.py:693-706) at nc^2 cells with `levels` GMG levels. Returns a
    dict with the problem, solver, state, solution, stats, each inner
    pressure CG's iteration count and the set-up seconds by step."""
    cg_its = []
    t0 = time.perf_counter()
    prob = stokes_problem((nc, nc), dtype=dtype, device=device)
    t1 = time.perf_counter()
    gmg = velocity_gmg((nc, nc), levels, mode="preconditioner", dtype=dtype, device=device)
    t2 = time.perf_counter()
    P = BlockTriangularSolver(
        solvers=(gmg, Recorded(CGSolver(Pl=JacobiSolver(), rtol=1e-6, maxiter=30), cg_its)),
        blocks=((LinearSystemBlock(), None), (None, MatrixBlock(prob.Mp))),
        half="upper",
    )
    solver = FGMRESSolver(m=20, Pr=P, rtol=STOKES_RTOL, maxiter=maxiter)
    state = solver.setup(prob.A)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    t3 = time.perf_counter()
    x, st = solver.solve(state, prob.b)
    return {"prob": prob, "solver": solver, "state": state, "x": x, "stats": st,
            "cg_its": cg_its, "gmg": gmg, "secs": {"assembly": t1 - t0, "hierarchy": t2 - t1,
                                                   "setup": t3 - t2}}


def fence() -> None:
    """Wait for the card, for a measurement: a sync that SyncCount leaves
    out (it is the script's, not the program's)."""
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode(mode)


class SyncCount:
    """Host syncs the program makes while active, as PyTorch's sync debug
    mode reports them: every read of a device value to the host (`.item()`,
    `float()`, a device-to-host copy) and every stream synchronization.
    `read()` is the count so far. Warnings other than these pass on."""

    MESSAGE = "synchronizing CUDA operation"

    def __enter__(self):
        self.n = 0
        self._catch = warnings.catch_warnings(record=True)
        self._log = self._catch.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def read(self) -> int:
        log, self._log[:] = list(self._log), []
        for w in log:
            if self.MESSAGE in str(w.message):
                self.n += 1
            else:
                print(warnings.formatwarning(w.message, w.category, w.filename, w.lineno),
                      end="", file=sys.stderr)
        return self.n

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(0)
        self.read()
        self._catch.__exit__(*exc)


class StepTimes:
    """Set-up seconds by step while active: wraps the functions and methods
    that make each step and charges each call's time, less that of the
    steps nested in it, to its step (the card synchronized at both ends).
    Steps: assembly (host FE assembly and banding), patch topologies (host
    index tables), flat blocks (the ELL
    field blocks of every flat operator), Vanka extraction and inversion,
    materialization (M_vanka's blocks and refresh plan), transfers, λmax
    (the power iterations), LU (the coarse factorization)."""

    STEPS = (
        ("assembly", stokes_mod, "stokes_problem"),
        ("assembly", stokes_mod, "graddiv_velocity_block"),
        ("patch topologies", stokes_mod, "_vertex_star_topology"),
        ("patch topologies", topology_mod, "coarse_cell_patches"),
        ("flat blocks", flat_mod, "flat_kernel_operator"),
        ("Vanka extraction and inversion", VankaSolver, "setup"),
        ("materialization", MaterializedVankaSmoother, "setup"),
        ("transfers", transfer_mod, "fe_transfer_pair_dense"),
        ("transfers", transfer_mod, "fe_transfer_pair"),
        ("λmax", PreconditionedChebyshevSmoother, "_lmax"),
        ("LU", DenseLUSolver, "setup"),
    )

    def __init__(self, device, steps=None):
        self.steps = self.STEPS if steps is None else steps
        self.secs = collections.Counter()
        self._cuda = torch.device(device).type == "cuda"
        self._stack = []
        self._saved = []

    def _wrap(self, step, fn):
        def timed(*args, **kwargs):
            if self._cuda:
                fence()
            t0 = time.perf_counter()
            self._stack.append(0.0)
            try:
                return fn(*args, **kwargs)
            finally:
                if self._cuda:
                    fence()
                total = time.perf_counter() - t0
                nested = self._stack.pop()
                self.secs[step] += total - nested
                if self._stack:
                    self._stack[-1] += total
        return timed

    def __enter__(self):
        for step, owner, name in self.steps:
            fn = owner.__dict__[name]
            self._saved.append((owner, name, fn))
            setattr(owner, name, self._wrap(step, fn))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)
        self._saved.clear()


def ell_blocks(op) -> list:
    """The ELLMatrix blocks an operator applies (K3 launches an apply)."""
    if isinstance(op, ELLMatrix):
        return [op]
    if isinstance(op, BlockedKernelOperator):
        return [b for row in op.kblocks for b in row if b is not None]
    if isinstance(op, BlockOperator):
        return [b for row in op.blocks for blk in row if blk is not None for b in ell_blocks(blk)]
    if isinstance(op, (ColumnStack, RowStack)):
        return [b for o in op.ops for b in ell_blocks(o)]
    raise TypeError(f"no ELL blocks in {type(op).__name__}")


def kernel_leaves(tree, out=None) -> list:
    """Every ELLMatrix (K3) and StencilMatrix (K2) reachable from an
    operator or a solver state, through dicts, sequences and dataclass
    fields, each once."""
    out = [] if out is None else out
    if isinstance(tree, (ELLMatrix, StencilMatrix)):
        if not any(tree is o for o in out):
            out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            kernel_leaves(v, out)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            kernel_leaves(v, out)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            kernel_leaves(getattr(tree, f.name), out)
    return out


def tree_to(tree, device):
    """Move every tensor of a solver or state to `device`, through dicts,
    sequences and dataclass fields, as `pt.tree_cast` walks them."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_to(v, device) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: tree_to(getattr(tree, f.name), device)
                                            for f in dataclasses.fields(tree) if f.init})
    return tree


class BlockCounts:
    """K3 launches by ELL block while active: wraps `ELLMatrix.matvec`
    (the only caller of K3's wrapper) and counts each block's applies in
    the current `phase`, keeping every block it saw so that an id stays
    its block's."""

    def __init__(self):
        self.seen = {}
        self.counts = collections.Counter()
        self.phase = "set-up"

    def __enter__(self):
        self._matvec = ELLMatrix.matvec

        def counted(blk, x, _apply=self._matvec):
            self.seen[id(blk)] = blk
            self.counts[self.phase, id(blk)] += 1
            return _apply(blk, x)
        ELLMatrix.matvec = counted
        return self

    def __exit__(self, *exc):
        ELLMatrix.matvec = self._matvec

    def of(self, blocks, phase) -> int:
        """Applies of `blocks` counted in `phase`."""
        return sum(self.counts[phase, id(b)] for b in blocks)

    def by_shape(self) -> dict:
        """Every counted apply by its block's (rows, columns)."""
        out = collections.Counter()
        for (_, key), c in self.counts.items():
            out[self.seen[key].shape] += c
        return dict(out)


def setup_h(nc, levels, dtype, device, engine="flat", cheby=4, m=20, rtol=GD_RTOL,
            maxiter=GD_MAXITER, cg_rtol=1e-6, cg_maxiter=30):
    """Path H through the public API, set up: the JAX bench's augmented
    Stokes configuration (bench.py:751-786) at nc^2 cells with `levels` GMG
    levels: stokes_problem(graddiv_alpha=1e3, engine), velocity_gmg with
    Chebyshev(cheby) over the Vanka (0: Richardson(10, 0.2)), the upper
    block-triangular preconditioner with coefficients ((1, 1), (0, 1)) and
    Jacobi-CG on -(1/alpha) Mp, FGMRES(m). Returns a dict with the problem,
    solver and state, the inner CG iteration log and the set-up seconds by
    step (StepTimes) and in total."""
    cg_its = []
    with StepTimes(device) as steps:
        t0 = time.perf_counter()
        prob = stokes_mod.stokes_problem((nc, nc), graddiv_alpha=GD_ALPHA, engine=engine,
                                         dtype=dtype, device=device)
        gmg = stokes_mod.velocity_gmg((nc, nc), levels, graddiv_alpha=GD_ALPHA, engine=engine,
                                      cheby_degree=cheby, dtype=dtype, device=device)
        Mp = dataclasses.replace(prob.Mp, values=prob.Mp.values * (-1.0 / GD_ALPHA))
        P = BlockTriangularSolver(
            solvers=(gmg, Recorded(CGSolver(Pl=JacobiSolver(), rtol=cg_rtol,
                                            maxiter=cg_maxiter), cg_its)),
            blocks=((LinearSystemBlock(), None), (None, MatrixBlock(Mp))),
            coeffs=((1.0, 1.0), (0.0, 1.0)), half="upper")
        solver = FGMRESSolver(m=m, Pr=P, rtol=rtol, maxiter=maxiter)
        state = solver.setup(prob.A)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        total = time.perf_counter() - t0
    secs = dict(steps.secs)
    secs["other"] = total - sum(secs.values())
    return {"prob": prob, "solver": solver, "state": state, "cg_its": cg_its, "gmg": gmg,
            "levels": levels, "secs": secs, "setup_s": total}


def solve_h(run) -> dict:
    """Solve a set-up path H run: adds its solution, stats and solve
    seconds."""
    t0 = time.perf_counter()
    run["x"], run["stats"] = run["solver"].solve(run["state"], run["prob"].b)
    if run["x"][1].device.type == "cuda":
        torch.cuda.synchronize()
    run["solve_s"] = time.perf_counter() - t0
    return run


def h_roles(run) -> dict:
    """The operators path H1 applies through K3, by role: the problem's
    flat velocity block (the GMG's level 0), each coarser level operator,
    each smoothing level's materialized Vanka, each patch prolongation's
    grad-div operator and patch solver, B, Bt, the pressure-mass block and
    the velocity mass."""
    prob, gst = run["prob"], run["state"]["Pr"]["states"][0]
    roles = {"K0": prob.K}
    roles.update({f"K{lv}": op for lv, op in enumerate(gst["mats"]) if lv > 0})
    roles.update({f"M{lv}": st["M"]["Mv"] for lv, st in enumerate(gst["pre"])})
    roles.update({f"G{lv}": p.rhs_op for lv, p in enumerate(gst["P"])})
    roles.update({f"S{lv}": p.state["Mv"] for lv, p in enumerate(gst["P"])})
    roles.update({"B": prob.A.block(1, 0), "Bt": prob.A.block(0, 1),
                  "Mp": run["state"]["Pr"]["diag_ops"][1], "Mu": prob.Mu})
    return roles


def h_launches(n: int, cg_its: list, levels: int, degree: int, power_iters: int, m: int,
               blocks: dict) -> tuple:
    """K3 launches of one path H1 run by role (fem/stokes.py,
    linear/gmres.py, blocks/block_solvers.py, linear/gmg.py,
    linear/smoothers.py, patches/*.py), each an operator's ELL blocks
    (`blocks[role]`) times its applies: (set-up, solve). Set-up: the load
    applies Mu once a velocity component (two); each smoothing level's λmax runs `power_iters` applies
    of its operator and of its Vanka. Solve: FGMRES applies the system
    (K0, B, Bt) once at the start, once a restart cycle and once an
    iteration; each of the n preconditioner applies runs the pressure CG
    (its iterations + 1 Mp applies), Bt once and one V-cycle, which on each
    smoothing level applies the Vanka 2(k+1) times and the operator 2k+1
    times (Chebyshev(k) pre and post, the correction residual) and the
    prolongation's grad-div operator and patch solver once, and on the
    coarsest level the operator once."""
    a = fgmres_applies(n, m)
    setup = {"Mu": 2 * blocks["Mu"]}
    solve = {"K0": blocks["K0"] * a, "B": blocks["B"] * a, "Bt": blocks["Bt"] * (a + n),
             "Mp": sum(c + 1 for c in cg_its)}
    for lv in range(levels):
        k = f"K{lv}"
        if lv == levels - 1:
            solve[k] = blocks[k] * n
            continue
        setup[k] = blocks[k] * power_iters
        setup[f"M{lv}"] = blocks[f"M{lv}"] * power_iters
        solve[k] = solve.get(k, 0) + blocks[k] * n * (2 * degree + 1)
        solve[f"M{lv}"] = blocks[f"M{lv}"] * n * 2 * (degree + 1)
        solve[f"G{lv}"] = blocks[f"G{lv}"] * n
        solve[f"S{lv}"] = blocks[f"S{lv}"] * n
    return setup, solve


class NewtonProbe:
    """The linear solver of a Newton loop, wrapped: the same set-up, update
    and solves, and for each solve its iterations, flag and seconds, with a
    snapshot of the StepTimes counters at its start (the difference of two
    snapshots is one Newton step's solve, residual and refresh by step),
    and with a SyncCount given (`syncs`) its count at that start. `check`
    runs on every set-up and refreshed state; `setup_state` keeps the first
    (NewtonRefinement starts from it, as the JAX bench does)."""

    def __init__(self, inner, steps, check=None):
        self.inner, self.steps, self.check = inner, steps, check
        self.log, self.setup_state, self.on_solve, self.syncs = [], None, None, None

    def _sync(self, leaf):
        if leaf.device.type == "cuda":
            fence()

    def setup(self, A, x=None):
        state = self.inner.setup(A, x)
        self.setup_state = self.state = state
        if self.check is not None:
            self.check(state)
        return state

    def update(self, state, A, x=None):
        state = self.state = self.inner.update(state, A, x)
        if self.check is not None:
            self.check(state)
        return state

    def solve(self, state, b, x0=None):
        if self.on_solve is not None:
            self.on_solve()
        leaf = pt.tree_leaves(b)[0]
        self._sync(leaf)
        snap = collections.Counter(self.steps.secs)
        n_sync = self.syncs.read() if self.syncs is not None else None
        t0 = time.perf_counter()
        x, stats = self.inner.solve(state, b, x0)
        self._sync(leaf)
        self.log.append({"snap": snap, "solve_s": time.perf_counter() - t0,
                         "its": stats.niter, "flag": int(stats.flag), "sync_at": n_sync})
        return x, stats


# StepTimes' steps for path I: set-up (host assembly, slot maps, grad-div
# values, Jacobians, patch topologies, Vanka extraction and inversion,
# materialization, transfers, λmax, LU, residual) and each Newton refresh
# (Jacobians on every level, the smoothers' Vanka re-extraction, inversion and
# materialized refresh, the patch prolongations' refresh, LU)
I_STEPS = (
    ("assembly", ns_mod, "navier_stokes_problem"),
    ("assembly", ns_mod.Q2ConvectionAssembler, "__init__"),
    ("slot maps", ns_mod, "_csr_slot_map"),
    ("grad-div values", ns_mod, "_graddiv_ell_vals"),
    ("Jacobian", ns_mod.NavierStokesProblem, "velocity_block"),
    ("Jacobian", ns_mod.Q2ConvectionAssembler, "velocity_block"),
    ("residual", ns_mod.NavierStokesProblem, "residual"),
    ("patch topologies", stokes_mod, "_vertex_star_topology"),
    ("patch topologies", topology_mod, "coarse_cell_patches"),
    ("Vanka extraction and inversion", VankaSolver, "setup"),
    ("materialization", MaterializedVankaSmoother, "setup"),
    ("Vanka refresh", MaterializedVankaSmoother, "update"),
    ("prolongation refresh", PatchProlongation, "update"),
    ("transfers", transfer_mod, "fe_transfer_pair_dense"),
    ("λmax", PreconditionedChebyshevSmoother, "_lmax"),
    ("LU", DenseLUSolver, "setup"),
)


def setup_i(nc, levels, dtype, device, graddiv=True, atol=0.0, check=None):
    """Path I through the public API, set up: the lid-driven cavity at Re =
    10 (nu = 0.1) with `levels` velocity GMG levels (every update refreshes
    through the walker), under the upper block-triangular preconditioner with
    Jacobi-CG (rtol 1e-6, <= 30) on the pressure block and Newton (maxiter
    12, rtol 1e-6, `atol`). graddiv (the JAX bench's ns_graddiv row,
    bench.py:1355-1412): grad-div alpha 1e3, Q2/P1disc, Chebyshev(4) over
    the materialized vertex-star Vanka, patch prolongations, coefficients
    ((1, 1), (0, 1)) and -(1/alpha) Mp, FGMRES(20) rtol 1e-8 <= 60. Else
    (ns_newton, bench.py:1205-1265): Q2/Q1, Richardson(1, 0.8) over the
    materialized Vanka of the velocity block's rows (seed_field=-1),
    ncycles=2, the pressure mass, FGMRES(40) rtol 1e-8 <= 100. Returns a
    dict with the problem, Newton solver, its probe (NewtonProbe around the
    FGMRES), the pressure operator, the inner CG iteration log, the active
    StepTimes (entered here; `solve_i` exits it) and FGMRES's restart
    length."""
    cg_its = []
    steps = StepTimes(device, I_STEPS).__enter__()
    alpha = GD_ALPHA if graddiv else 0.0
    prob = ns_mod.navier_stokes_problem((nc, nc), nu=NS_NU, graddiv_alpha=alpha, bc="cavity",
                                        dtype=dtype, device=device)
    if graddiv:
        gmg = ns_mod.ns_velocity_gmg((nc, nc), levels, nu=NS_NU, graddiv_alpha=alpha,
                                     bc="cavity", vanka_engine="materialized", cheby_degree=4,
                                     dtype=dtype, device=device)
        Mp = dataclasses.replace(prob.Mp, values=prob.Mp.values * (-1.0 / alpha))
        coeffs, m, maxiter = ((1.0, 1.0), (0.0, 1.0)), 20, 60
    else:
        sm = RichardsonSmoother(MaterializedVankaSmoother(omega=1.0, seed_field=-1), niter=1,
                                omega=0.8)
        gmg = ns_mod.ns_velocity_gmg((nc, nc), levels, nu=NS_NU, smoother=sm, ncycles=2,
                                     bc="cavity", dtype=dtype, device=device)
        Mp, coeffs, m, maxiter = prob.Mp, None, 40, 100
    P = BlockTriangularSolver(
        solvers=(gmg, Recorded(CGSolver(Pl=JacobiSolver(), rtol=1e-6, maxiter=30), cg_its)),
        blocks=((NonlinearSystemBlock(), None), (None, MatrixBlock(Mp))),
        coeffs=coeffs, half="upper")
    fgmres = FGMRESSolver(m=m, Pr=P, rtol=1e-8, maxiter=maxiter)
    probe = NewtonProbe(fgmres, steps, check)
    newton = NewtonSolver(probe, maxiter=12, rtol=1e-6, atol=atol)
    return {"prob": prob, "gmg": gmg, "fgmres": fgmres, "probe": probe, "newton": newton,
            "Mp": Mp, "cg_its": cg_its, "steps": steps, "m": m}


def solve_i(run) -> dict:
    """Newton from zero on a set-up path I run; adds its solution, stats,
    set-up seconds by step (to the first solve), each Newton step's record
    (residual, FGMRES its, solve seconds, the refresh after it by step, and
    with the probe's SyncCount the host syncs from its solve's start to the
    next's, or to the end) and the cavity-centre u_x. Leaves the StepTimes
    wrappers."""
    prob, steps, probe = run["prob"], run["steps"], run["probe"]
    t0 = time.perf_counter()
    try:
        run["x"], run["stats"] = run["newton"].solve(prob, prob.zero_guess())
        if run["x"][1].device.type == "cuda":
            fence()
    finally:
        steps.__exit__(None, None, None)
    run["newton_s"] = time.perf_counter() - t0
    log = probe.log
    snaps = [rec["snap"] for rec in log] + [collections.Counter(steps.secs)]
    run["setup_secs"] = dict(snaps[0])
    hist = run["stats"].residuals.numpy()
    sync_at = [rec["sync_at"] for rec in log]
    if probe.syncs is not None:
        sync_at.append(probe.syncs.read())
        run["setup_syncs"] = sync_at[0]
    run["per_step"] = [
        {"residual": float(hist[k + 1]), "its": rec["its"], "flag": rec["flag"],
         "solve_s": rec["solve_s"],
         "refresh": {step: v for step, v in (snaps[k + 1] - snaps[k]).items() if v > 0},
         "syncs": None if probe.syncs is None else sync_at[k + 1] - sync_at[k]}
        for k, rec in enumerate(log)]
    nc = prob.mesh.ncells[0]
    run["ux_centre"] = float(run["x"][0][0].reshape(2 * nc + 1, 2 * nc + 1)[nc, nc])
    return run


class IRoles:
    """K3 launches of a path I run by role while active, in its set-up and
    its Newton phase apart (`phase`, set to "Newton" when the first linear
    solve starts). It wraps `ELLMatrix.matvec` (the only caller of K3's
    wrapper) and names each launched block's role at launch time, holding
    no block: inside the problem's residual, "res K" (its row-masked
    velocity blocks), "res G" (its grad-div blocks), "res Bt", "res B";
    elsewhere "J{l}" for level l's Jacobian blocks (their values tensors,
    held weakly, registered as `velocity_block` makes them; the walker
    hands on the same values), "M{l}" for level l's materialized Vanka blocks (by their
    columns tensor, which each refresh keeps), "G{l}" for level l's
    patch-prolongation grad-div blocks, and "B", "Bt", "Mp" (by their
    values tensors, which the walker hands on). A launch of no
    role, or on a block without row lengths, is recorded and fails the
    run. `n_u` lists the velocity unknowns by level."""

    def __init__(self, n_u):
        self.n_u = list(n_u)
        self.counts = collections.Counter()    # (phase, role)
        self.pos = collections.Counter()       # (role, (a, b)) for Jacobian blocks
        self.shapes = collections.Counter()
        self.stray, self.no_row_len = collections.Counter(), 0
        self.phase, self.in_residual = "set-up", 0
        self.jac, self.m_cols, self.fixed, self.g_vals = {}, {}, {}, {}
        self.prob = None
        self._saved = []

    def install(self, run) -> None:
        """The run's fixed blocks: B, Bt, the pressure operator and each
        prolongation level's grad-div blocks."""
        prob = self.prob = run["prob"]
        for role, blocks in (("B", prob.Bs), ("Bt", prob.BTs), ("Mp", (run["Mp"],))):
            self.fixed.update({id(b.values): (role, b.values) for b in blocks})
        for lv, P in enumerate(run["gmg"].prolongations):
            for row in P.rhs_op.blocks:
                self.g_vals.update({id(b.values): (lv, b.values) for b in row})
        run["probe"].on_solve = self.newton_phase

    def newton_phase(self) -> None:
        self.phase = "Newton"

    def role(self, blk) -> str:
        vid = id(blk.values)
        if self.in_residual:
            p = self.prob
            if blk.cols is p.cols_ell:
                gd = [g for row in (p.gd_res_vals or ()) for g in row]
                return "res G" if any(blk.values is g for g in gd) else "res K"
            return "res Bt" if any(blk is b for b in p.BTs) else "res B"
        if vid in self.fixed:
            return self.fixed[vid][0]
        if vid in self.g_vals:
            return f"G{self.g_vals[vid][0]}"
        lv, ab, ref = self.jac.get(vid, (None, None, lambda: None))
        if ref() is blk.values:
            self.pos[f"J{lv}", ab] += 1
            return f"J{lv}"
        if id(blk.cols) in self.m_cols:
            return f"M{self.m_cols[id(blk.cols)][0]}"
        return ""

    def _wrap(self, owner, name, make):
        fn = owner.__dict__[name]
        self._saved.append((owner, name, fn))
        setattr(owner, name, make(fn))

    def __enter__(self):
        roles = self

        def matvec(fn):
            def counted(blk, x):
                role = roles.role(blk)
                if not role:
                    roles.stray[blk.shape] += 1
                if blk.row_len is None:
                    roles.no_row_len += 1
                roles.counts[roles.phase, role] += 1
                roles.shapes[blk.shape] += 1
                return fn(blk, x)
            return counted

        def residual(fn):
            def wrapped(prob, x):
                roles.in_residual += 1
                try:
                    return fn(prob, x)
                finally:
                    roles.in_residual -= 1
            return wrapped

        def velocity_block(fn):
            def wrapped(obj, u, newton=True):
                op = fn(obj, u, newton)
                for k in [k for k, v in roles.jac.items() if v[2]() is None]:
                    del roles.jac[k]   # values gone
                lv = roles.n_u.index(obj.n_u)
                for a, row in enumerate(op.blocks):
                    for b, blk in enumerate(row):
                        roles.jac[id(blk.values)] = (lv, (a, b), weakref.ref(blk.values))
                return op
            return wrapped

        def vanka_setup(fn):
            def wrapped(smoother, A, x=None):
                state = fn(smoother, A, x)
                lv = roles.n_u.index(state["Mv"].sizes[0])
                for row in state["Mv"].kblocks:
                    roles.m_cols.update({id(b.cols): (lv, b.cols) for b in row if b is not None})
                return state
            return wrapped

        self._wrap(ELLMatrix, "matvec", matvec)
        self._wrap(ns_mod.NavierStokesProblem, "residual", residual)
        self._wrap(ns_mod.NavierStokesProblem, "velocity_block", velocity_block)
        self._wrap(ns_mod.Q2ConvectionAssembler, "velocity_block", velocity_block)
        self._wrap(MaterializedVankaSmoother, "setup", vanka_setup)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)
        self._saved.clear()
        self.jac.clear()


def i_launches(per_step, cg_its, levels, degree, power_iters, m, m_blocks) -> dict:
    """K3 launches of one path I1 run by role (fem/navier_stokes.py,
    nonlinear/newton.py, linear/gmres.py, blocks/block_solvers.py,
    linear/gmg.py, linear/smoothers.py, patches/*.py): {phase: {role: n}}.
    Each cavity residual applies its row-masked velocity block once a
    component (res K 2), the grad-div blocks (res G 4), Bt (2) and B (2).
    Set-up: the residual at the start, and on each smoothing level the λmax
    power iteration's `power_iters` applies of the level Jacobian (4
    blocks) and of its Vanka (`m_blocks[l]` blocks). Newton phase: the
    residual after each step; step k's FGMRES applies the Jacobian (J0, B,
    Bt) 1 + c_k + n_k times (c_k restart cycles) and the preconditioner n_k
    times: each runs the pressure CG (its iterations + 1 Mp applies), Bt
    once and one V-cycle, which on smoothing level l applies the Jacobian
    2k+1 times, the Vanka 2(k+1) times and the prolongation's grad-div
    blocks (4) once, and on the coarsest level the Jacobian once. The
    refreshes launch nothing."""
    res = {"res K": 2, "res G": 4, "res Bt": 2, "res B": 2}
    setup = dict(res)
    for lv in range(levels - 1):
        setup[f"J{lv}"] = 4 * power_iters
        setup[f"M{lv}"] = m_blocks[lv] * power_iters
    steps = len(per_step)
    a = sum(1 + -(-s["its"] // m) + s["its"] for s in per_step)
    n = sum(s["its"] for s in per_step)
    newton = {r: v * steps for r, v in res.items()}
    newton.update({"B": 2 * a, "Bt": 2 * (a + n), "Mp": sum(c + 1 for c in cg_its)})
    for lv in range(levels):
        if lv == levels - 1:
            newton[f"J{lv}"] = 4 * n
            continue
        newton[f"J{lv}"] = 4 * n * (2 * degree + 1) + (4 * a if lv == 0 else 0)
        newton[f"M{lv}"] = m_blocks[lv] * n * 2 * (degree + 1)
        newton[f"G{lv}"] = 4 * n
    return {"set-up": setup, "Newton": newton}


# StepTimes' steps for path J1: the host Kronecker assembly of the RT1
# blocks (every call: level 0 three times, for the problem, the GMG and the
# pressure block), the Dirichlet elimination, banding and device copies of
# each level's velocity operator, the problem's B rows and right-hand side,
# the vertex-star patch tables, the nested transfers, the Vanka extraction
# and inversion, and the coarse LU
J_STEPS = (
    ("Kronecker assembly", rt1_mod, "rt1_blocks"),
    ("elimination, banding, device copies", rt1_mod, "rt1_velocity_operator"),
    ("problem (B, Bt, rhs)", rt1_mod, "darcy_rt1_problem"),
    ("patch topologies", rt1_mod, "rt1_vertex_patches"),
    ("transfers", rt1_mod, "rt1_transfer_pair"),
    ("Vanka extraction and inversion", VankaSolver, "setup"),
    ("LU", DenseLUSolver, "setup"),
)
# ... and for path Ka: each level's banded block assembly (host bands,
# elimination, device copies), the problem's load, the Chebyshev smoothers'
# Lanczos λmax and the coarse LU
K_STEPS = (
    ("band assembly", el_mod, "elasticity_operator"),
    ("problem (load)", el_mod, "elasticity_problem"),
    ("λmax (Lanczos)", ChebyshevSmoother, "setup"),
    ("LU", DenseLUSolver, "setup"),
)


def setup_j(nc, levels, dtype, device, cg_its=None):
    """Path J1 through the public API, set up: `darcy_rt1_problem` and
    `darcy_rt1_solver` (the reference's DarcyGMG at order 2: RT1 x P1disc,
    alpha 1e2, FGMRES(20) rtol 1e-10 <= 40, upper block-triangular [RT1 GMG
    of `levels` levels, Richardson(10, 0.2) over the unit-weighted
    vertex-star Vanka, exact nested transfers; Jacobi-CG rtol 1e-6 <= 20 on
    -(1/alpha) Mp]) at nc^2 cells. The pressure CG is wrapped to record its
    iterations (`cg_its`). Returns a dict with the problem, solver, state,
    the set-up seconds by step and in total."""
    cg_its = [] if cg_its is None else cg_its
    with StepTimes(device, J_STEPS) as steps:
        t0 = time.perf_counter()
        prob = rt1_mod.darcy_rt1_problem((nc, nc), alpha=DARCY_ALPHA, dtype=dtype,
                                         device=device)
        solver = rt1_mod.darcy_rt1_solver((nc, nc), num_levels=levels, alpha=DARCY_ALPHA,
                                          rtol=J_RTOL, maxiter=J_MAXITER, dtype=dtype,
                                          device=device)
        P = solver.Pr
        solver = dataclasses.replace(solver, Pr=dataclasses.replace(
            P, solvers=(P.solvers[0], Recorded(P.solvers[1], cg_its))))
        state = solver.setup(prob.A)
        if torch.device(device).type == "cuda":
            fence()
        total = time.perf_counter() - t0
    secs = dict(steps.secs)
    secs["other"] = total - sum(secs.values())
    return {"prob": prob, "solver": solver, "state": state, "cg_its": cg_its,
            "levels": levels, "secs": secs, "setup_s": total}


def solve_j(run) -> dict:
    """Solve a set-up path J1 (or Ka) run: adds its solution, stats and
    solve seconds."""
    t0 = time.perf_counter()
    run["x"], run["stats"] = run["solver"].solve(run["state"], run["prob"].b)
    if pt.tree_leaves(run["x"])[0].device.type == "cuda":
        fence()
    run["solve_s"] = time.perf_counter() - t0
    return run


def j_launches(nc: int, n: int, cg_its: list, levels: int, niter: int, m: int,
               noffs: list) -> dict:
    """Launches of one path J1 run at nc^2 cells, from `darcy_rt1_problem`
    to the end of the solve (fem/rt1.py, linear/gmres.py,
    blocks/block_solvers.py, linear/gmg.py, linear/smoothers.py,
    patches/vanka.py), by kernel and operand shape: K2 on the two diagonal
    velocity blocks of each level ((noffs[l][c], *grid of component c)), K3
    on the two cross blocks of each level ((N_l, N_l), N_l = (2n_l+1) 2n_l),
    B ((3nc^2, N_0), two), Bt ((N_0, 3nc^2), two) and -(1/alpha) Mp. A
    velocity apply is one launch a block. The problem applies the system
    once (its consistent right-hand side); the set-up none (patch
    extraction, diagonals and the LU read values); FGMRES applies the
    system `fgmres_applies` times; each of its n preconditioner applies
    runs the pressure CG (its iterations + 1 Mp applies), Bt once and one
    V-cycle, which applies each smoothing level's operator 2 niter + 1
    times (Richardson(niter) pre and post over the Vanka, whose applies
    launch no kernel, and the correction residual) and the coarsest
    level's once."""
    a = 1 + fgmres_applies(n, m)
    N0 = (2 * nc + 1) * 2 * nc
    npr = 3 * nc * nc
    k2_count, k3_count = collections.Counter(), collections.Counter()
    for lev in range(levels):
        n_l = nc >> lev
        per = n if lev == levels - 1 else n * (2 * niter + 1)
        per += a if lev == 0 else 0
        for c, grid in enumerate(((2 * n_l + 1, 2 * n_l), (2 * n_l, 2 * n_l + 1))):
            k2_count[(noffs[lev][c],) + grid] += per
        N_l = (2 * n_l + 1) * 2 * n_l
        k3_count[(N_l, N_l)] += 2 * per
    k3_count[(npr, N0)] += 2 * a
    k3_count[(N0, npr)] += 2 * (a + n)
    k3_count[(npr, npr)] += sum(c + 1 for c in cg_its)
    return {"K2": dict(k2_count), "K3": dict(k3_count)}


def setup_k(nc, levels, dtype, device):
    """Path Ka through the public API, set up: `solve_elasticity`'s
    configuration (`elasticity_problem`: clamped on the x0 face, mu = lambda
    = 1, unit downward body force; CG rtol 1e-8 <= 60 + `elasticity_gmg`:
    Chebyshev(4, ratio 40), structured Q1 transfers per component, dense LU
    on the coarsest level) in 3D at nc^3 cells with `levels` levels.
    Returns a dict as setup_j's."""
    with StepTimes(device, K_STEPS) as steps:
        t0 = time.perf_counter()
        prob = el_mod.elasticity_problem((nc,) * 3, dtype=dtype, device=device)
        gmg = el_mod.elasticity_gmg((nc,) * 3, num_levels=levels, dtype=dtype, device=device)
        solver = CGSolver(Pl=gmg, rtol=K_RTOL, maxiter=K_MAXITER)
        state = solver.setup(prob.A)
        if torch.device(device).type == "cuda":
            fence()
        total = time.perf_counter() - t0
    secs = dict(steps.secs)
    secs["other"] = total - sum(secs.values())
    return {"prob": prob, "solver": solver, "state": state, "levels": levels, "secs": secs,
            "setup_s": total}


def k_launches(nc: int, n: int, levels: int, degree: int, lanczos: int, noffs: list) -> dict:
    """K2 launches of one path Ka run at nc^3 cells (fem/elasticity.py,
    linear/cg.py, linear/gmg.py, linear/smoothers.py) by operand shape
    ((offsets, *vertex grid)): an operator apply launches K2 once a block
    (nine), `noffs[l]` the offset counts of level l's blocks. Set-up: one
    Lanczos run on every smoothing level (pre and post share it). Solve:
    `cg_gmg_level_applies` by level."""
    per = cg_gmg_level_applies(n, levels, degree)
    out = collections.Counter()
    for lev in range(levels):
        g = (nc >> lev) + 1
        applies = per[lev] + (lanczos if lev < levels - 1 else 0)
        for s in noffs[lev]:
            out[(s, g, g, g)] += applies
    return dict(out)


M_STEPS = (
    ("host assembly", asm_q1, "laplacian_var"),
    ("Neumann matrices (host)", schwarz_mod, "slab_neumann_matrices"),
    ("patch extraction", psm_mod, "extract_patch_matrices_ell"),
    ("batched inverses", torch.linalg, "inv"),
    ("Cholesky", torch.linalg, "cholesky"),
    ("triangular solves", torch.linalg, "solve_triangular"),
    ("eigh", torch.linalg, "eigh"),
    ("coarse operator A0 = ZᵀAZ, LU", schwarz_mod.TwoLevelSchwarzSolver, "_refresh_coarse"),
)
N_STEPS = (
    ("host assembly (curl-curl system)", hcurl_mod, "curlcurl_system"),
    ("ELL conversion", hcurl_mod, "curlcurl_operator"),
    ("AMS projections (host)", hcurl_mod.AMSSolver, "setup"),
    ("AMS re-projections (host)", hcurl_mod.AMSSolver, "update"),
    ("AMG set-ups (host)", AMGSolver, "setup"),
    ("AMG updates (host)", AMGSolver, "update"),
    ("λmax (Lanczos)", ChebyshevSmoother, "setup"),
    ("dense inverses", DenseInverseSolver, "setup"),
)
O_STEPS = (
    ("Kronecker assembly", mhd_mod, "mhd_system"),
    ("patch topologies", mhd_mod, "mhd_vertex_patches"),
    ("Vanka extraction and inversion", VankaSolver, "setup"),
    ("LU", DenseLUSolver, "setup"),
)


def m_kappa(nc) -> np.ndarray:
    """Path M1's coefficient: 1e4 in the M_CHANNELS cell columns (scaled to
    nc[1] cells from 64), else 1."""
    kap = np.ones(nc)
    for lo, hi in M_CHANNELS:
        kap[:, lo * nc[1] // 64: hi * nc[1] // 64] = 1e4
    return kap


def setup_m(nc, ns, nev, dtype, device, kappa=None, level="two", neumann=True,
            coarse_solver=None, maxiter=M_MAXITER, domain=None):
    """Path M through the public API, set up: -div(kappa grad u) by
    `laplacian_var` on `domain` (None: (0, nc[0]/nc[1]) x (0, 1), square
    cells) with the boundary eliminated, a seeded rhs zero on the boundary,
    and CG rtol 1e-8 preconditioned by `TwoLevelSchwarzSolver` (`level`
    "two": ns slabs of overlap 2, nev, the `slab_neumann_matrices` if
    `neumann`) or by the one-level `SchwarzLinearSolver` ("one"). Returns
    a dict as setup_j's (the problem: A and b)."""
    kappa = m_kappa(nc) if kappa is None else kappa
    domain = (0.0, nc[0] / nc[1], 0.0, 1.0) if domain is None else domain
    with StepTimes(device, M_STEPS) as steps:
        t0 = time.perf_counter()
        mesh = CartesianMesh(nc, domain)
        mask = mesh.boundary_vertex_mask()
        A = eliminate_dirichlet(asm_q1.laplacian_var(mesh, kappa, dtype, device), mask)
        b = np.random.default_rng(0).normal(size=A.n) * (~mask.reshape(-1))
        b = torch.from_numpy(b).to(device=device, dtype=dtype)
        if level == "one":
            P = schwarz_mod.SchwarzLinearSolver(n_subdomains=ns, overlap=2)
        else:
            N = (schwarz_mod.slab_neumann_matrices(mesh, ns, overlap=2, kappa=kappa)
                 if neumann else None)
            P = schwarz_mod.TwoLevelSchwarzSolver(n_subdomains=ns, overlap=2, nev=nev,
                                                  neumann_matrices=N,
                                                  coarse_solver=coarse_solver)
        solver = CGSolver(Pl=P, rtol=M_RTOL, maxiter=maxiter, flexible=coarse_solver is not None)
        state = solver.setup(A)
        if torch.device(device).type == "cuda":
            fence()
        total = time.perf_counter() - t0
    secs = dict(steps.secs)
    secs["other"] = total - sum(secs.values())
    return {"prob": types.SimpleNamespace(A=A, b=b), "solver": solver, "state": state,
            "secs": secs, "setup_s": total}


def m_launches(grid_shape, n: int, ns: int, nev: int) -> dict:
    """K2 launches of one path M1 run (linear/schwarz.py, linear/cg.py) by
    operand shape (9 bands on the vertex grid): the coarse operator A0 =
    ZᵀAZ takes one apply a coarse vector (ns * nev); CG applies A once at
    the start and once an iteration; the Schwarz applies launch none."""
    return {(9,) + tuple(grid_shape): ns * nev + n + 1}


def setup_n(nc, alpha, dtype, device):
    """Path N through the public API, set up: `make_ams(nc, alpha)` (beta
    1, vector correction on) and CG rtol 1e-8 <= 100 with the AMS
    preconditioner, a seeded rhs zero on the constrained edges. Returns a
    dict as setup_j's (the problem: A, b and the free masks)."""
    with StepTimes(device, N_STEPS) as steps:
        t0 = time.perf_counter()
        A, free, ams = hcurl_mod.make_ams(nc, alpha=alpha, dtype=dtype, device=device)
        rng = np.random.default_rng(0)
        b = tuple(torch.from_numpy(rng.normal(size=int(f.shape[0]))).to(device, dtype) * f
                  for f in free)
        solver = CGSolver(Pl=ams, rtol=N_RTOL, maxiter=N_MAXITER)
        state = solver.setup(A)
        if torch.device(device).type == "cuda":
            fence()
        total = time.perf_counter() - t0
    secs = dict(steps.secs)
    secs["other"] = total - sum(secs.values())
    return {"prob": types.SimpleNamespace(A=A, b=b, free=free), "solver": solver,
            "state": state, "secs": secs, "setup_s": total}


def n_launches(A, ams_state, its: list, lanczos: int, degree: int) -> dict:
    """K3 launches of one path N1 run (fem/hcurl.py, linear/cg.py,
    linear/amg.py, linear/smoothers.py) by operand shape: set-up, then one
    solve per entry of `its`, with an `AMSSolver.update` before each solve
    after the first. An operator apply launches K3 once a block (nine).
    The set-up and each update run one Lanczos λmax on A (Chebyshev) and
    one on every AMG level but the coarsest. CG applies A and AMS once at
    the start and once an iteration; an AMS apply is Chebyshev(degree) on
    A (degree applies), Gᵀ, the nodal AMG V-cycle and G, and for each
    component Π_cᵀ, its AMG V-cycle and Π_c. A V-cycle applies each level
    but the coarsest 2·degree + 1 times with one R and one P there, and
    the coarsest once (after its dense inverse)."""
    out = collections.Counter()
    ams_applies = sum(n + 1 for n in its)
    a_applies = len(its) * lanczos + ams_applies * (1 + degree)
    for row in A.blocks:
        for blk in row:
            if blk is not None:
                out[blk.shape] += a_applies
    for P in [ams_state["G"]] + list(ams_state["Pi"]):
        out[P.shape] += ams_applies
    for PT in [ams_state["GT"]] + list(ams_state["PiT"]):
        out[PT.shape] += ams_applies
    for amg in [ams_state["node"]] + list(ams_state["vec"]):
        mats = amg["mats"]
        for lev, m in enumerate(mats):
            if lev < len(mats) - 1:
                out[m.shape] += len(its) * lanczos + ams_applies * (2 * degree + 1)
                out[amg["R"][lev].shape] += ams_applies
                out[amg["P"][lev].shape] += ams_applies
            else:
                out[m.shape] += ams_applies
    return dict(out)


def scaled_block_operator(A: BlockOperator, c: float) -> BlockOperator:
    """c A for a BlockOperator of ELL blocks (path N1's update): the same
    columns and row lengths, the values scaled."""
    return BlockOperator(tuple(
        tuple(None if b is None else dataclasses.replace(b, values=c * b.values) for b in row)
        for row in A.blocks))


def setup_o(nc, levels, dtype, device, gamma=1.0, cycle="v"):
    """Path O through the public API, set up: `mhd_gmg(nc, levels, gamma,
    maxiter=1, cycle)` (Richardson(2, 0.3) over the vertex Vanka, dense LU
    on the coarsest level) as the right preconditioner of FGMRES(30) rtol
    1e-6 <= 40 on its problem. Returns a dict as setup_j's."""
    with StepTimes(device, O_STEPS) as steps:
        t0 = time.perf_counter()
        gmg, prob = mhd_mod.mhd_gmg(nc, levels, gamma=gamma, maxiter=1, cycle=cycle,
                                    dtype=dtype, device=device)
        solver = FGMRESSolver(m=30, Pr=gmg, rtol=O_RTOL, maxiter=O_MAXITER)
        state = solver.setup(prob.A)
        if torch.device(device).type == "cuda":
            fence()
        total = time.perf_counter() - t0
    secs = dict(steps.secs)
    secs["other"] = total - sum(secs.values())
    return {"prob": prob, "solver": solver, "state": state, "levels": levels, "secs": secs,
            "setup_s": total}


def o_launches(mats, n: int, m: int, niter: int) -> dict:
    """K3 launches of one path O1 run (fem/mhd.py, linear/gmres.py,
    linear/gmg.py) by operand shape: an operator apply launches K3 once a
    block (ten of the 6 x 6: the six diagonal blocks and the four
    couplings). FGMRES(m) applies the fine operator `fgmres_applies`
    times and the GMG once an iteration; a V-cycle applies each level but
    the coarsest 2·niter + 1 times (Richardson's residual updates and the
    coarse correction's) and the coarsest once. `mats`: the GMG's level
    operators."""
    out = collections.Counter()
    for lev, A in enumerate(mats):
        applies = n if lev == len(mats) - 1 else n * (2 * niter + 1)
        if lev == 0:
            applies += fgmres_applies(n, m)
        for row in A.blocks:
            for blk in row:
                if blk is not None:
                    out[blk.shape] += applies
    return dict(out)


def k2_bound_ms(A: StencilMatrix, x: torch.Tensor) -> float:
    """Bytes K2 must move (every band read once, x and y once each) over
    the card's memory rate."""
    return ((len(A.offsets) * A.bands.element_size() + 2 * x.element_size()) * A.n
            / HBM_BYTES_PER_S * 1e3)


def paths_jkl(dev, opts, card, elapsed, launches, check_k2, check_ell, vec, lines) -> dict:
    """Paths J, K and L on `dev` (main's phases 6J, 6K, 6L): each counted
    run's launches go into `launches`, each kernel check through main's
    `check_k2` / `check_ell` (with `vec` and `lines`). Returns what phase 8
    times and reports: the timed operators (`jk_ops`), each one's launches
    in its run, the counted runs' launches by operand shape and the J1 and
    Ka solve times."""
    f32, f64 = torch.float32, torch.float64
    lanczos = ChebyshevSmoother().lanczos_iters
    # ---- 6J path J: Darcy ------------------------------------------------
    # J2 (card = CPU): solve_darcy in its three branches; then J1, the
    # reference's DarcyGMG at order 2 at NC_J^2 in f64 (counted, set-up by
    # step, host syncs measured); then J3, the RT0 H(div) GMG under CG at
    # NC_J3^2
    def flat(x):
        return torch.cat([t.reshape(-1) for t in pt.tree_leaves(x)])

    small = []
    for tag, nc_, kw in (("RT1", NC_J2, dict(order=2, num_levels=3)),
                         ("RT0", NC_J2_RT0, {}),
                         ("RT0 grad-div", NC_J2_RT0, dict(graddiv_alpha=DARCY_ALPHA))):
        (xc_, sc_, ic_), (xh_, sh_, ih_) = (solve_darcy((nc_, nc_), device=d, **kw)
                                            for d in (dev, "cpu"))
        assert sc_.niter == sh_.niter and int(sc_.flag) == int(sh_.flag) and sc_.converged(), (
            tag, sc_.niter, sh_.niter, sc_.flag, sh_.flag)
        e = relerr(flat(xc_).cpu(), flat(xh_))
        assert e <= J2_TOL, f"J2 {tag}: card against CPU x {e:.2e}"
        err = "velocity_error" if "order" in kw else "pressure_error"
        small.append(f"{tag} {nc_}^2 ({kw}) {sc_.niter} = {sh_.niter} its, flag {sc_.flag}, "
                     f"x rel diff {e:.1e}, residual {ic_['residual']:.2e}, {err} "
                     f"{ic_[err]:.3e}")
    del xc_, xh_, ic_, ih_
    levels_j = int(math.log2(NC_J // 16)) + 1
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    with SyncCount() as syncs:
        run_j = setup_j(NC_J, levels_j, f64, dev)
        syncs_j = [syncs.read()]
        solve_j(run_j)
        syncs_j.append(syncs.read() - syncs_j[0])
    launches["J1"] = read_counts(k2_box=False)
    shapes_j = {"K2": dict(k2.counts.shapes), "K3": dict(k3.counts.shapes)}
    mem_j = (torch.cuda.max_memory_allocated() - mem0) / 2 ** 30
    prob_j, x_j, st_j = run_j["prob"], run_j["x"], run_j["stats"]
    gst_j = run_j["state"]["Pr"]["states"][0]
    noffs_j = [[len(m_.blocks[c][c].offsets) for c in (0, 1)] for m_ in gst_j["mats"]]
    want_j = j_launches(NC_J, st_j.niter, run_j["cg_its"], levels_j, 10, 20, noffs_j)
    assert shapes_j == want_j, (shapes_j, want_j)
    assert launches["J1"]["K1"] == 0
    hist_j = st_j.residuals.cpu().numpy()
    assert st_j.converged() and J_ITS[0] <= st_j.niter <= J_ITS[1], (st_j.niter, st_j.flag)
    leaves = pt.tree_leaves(x_j)
    n_uj = (2 * NC_J + 1) * 2 * NC_J
    assert [t.shape[0] for t in leaves] == [n_uj, n_uj, 3 * NC_J ** 2]
    assert all(t.dtype == f64 and bool(torch.isfinite(t).all()) for t in leaves)
    res_j, vel_j = prob_j.residual_norm(x_j), prob_j.velocity_error(x_j[0])
    rel_j = res_j / float(pt.norm(prob_j.b))
    assert res_j < J_RES_BOUND and vel_j < J_VEL_BOUND, (res_j, vel_j)
    assert rel_j <= 2 * J_RTOL, rel_j
    t_solve_j = median_ms(lambda: run_j["solver"].solve(run_j["state"], prob_j.b), runs=3,
                          warmup=0, spin=False)
    print(f"[6J path J] Darcy: J2 card = CPU: " + "; ".join(small)
          + f"; J1 RT1 x P1disc {NC_J}^2/{levels_j} levels f64 (alpha {DARCY_ALPHA:g}, "
          f"FGMRES(20) rtol {J_RTOL:g} <= {J_MAXITER}, upper block-triangular [RT1 GMG, "
          f"Richardson(10, 0.2) over the vertex-star Vanka; Jacobi-CG on -(1/alpha) Mp]; "
          f"{2 * n_uj + 3 * NC_J ** 2} unknowns; counted): {st_j.niter} its (band {J_ITS}), flag "
          f"{st_j.flag}, residuals " + " ".join(f"{v:.3e}" for v in hist_j[: st_j.niter + 1])
          + f"; residual_norm {res_j:.3e}, velocity_error {vel_j:.3e} (< {J_RES_BOUND:g}, "
          f"{J_VEL_BOUND:g}), true relative residual {rel_j:.3e}; inner CG its "
          f"{run_j['cg_its']}; set-up {run_j['setup_s']:.2f} s by step: "
          + ", ".join(f"{k} {v:.2f}" for k, v in run_j["secs"].items())
          + f"; solve {run_j['solve_s']:.3f} s (median of 3 more on the same set-up "
          f"{t_solve_j / 1e3:.3f} s); host syncs measured: set-up {syncs_j[0]}, solve "
          f"{syncs_j[1]}; peak device memory {mem_j:.2f} GiB over what earlier paths hold; "
          f"launches by shape equal to j_launches: K2 "
          + ", ".join(f"{k} {v}" for k, v in sorted(shapes_j["K2"].items()))
          + "; K3 " + ", ".join(f"{k} {v}" for k, v in sorted(shapes_j["K3"].items()))
          + f"; K1 0, plain 0 {elapsed()}", flush=True)
    if opts.profile is not None:
        summary = profile_solve(lambda: run_j["solver"].solve(run_j["state"], prob_j.b),
                                opts.profile, "path_J1")
        print(f"[profile] path J1 solve, {card}: {summary} {elapsed()}", flush=True)
    # the J1 operators that phase 8 times and that are held against their
    # plain versions below: level 0's diagonal velocity blocks (K2), its
    # cross blocks, B, Bt and -(1/alpha) Mp (K3)
    K0_j = gst_j["mats"][0]
    jk_ops = {f"J K2 u0 {K0_j.blocks[0][0].grid_shape}": K0_j.blocks[0][0],
              f"J K2 u1 {K0_j.blocks[1][1].grid_shape}": K0_j.blocks[1][1],
              "J K3 G01": K0_j.blocks[0][1], "J K3 G10": K0_j.blocks[1][0],
              "J K3 B0": prob_j.A.block(1, 0).ops[0], "J K3 Bt0": prob_j.A.block(0, 1).ops[0],
              "J K3 Mp": run_j["state"]["Pr"]["diag_ops"][1]}
    # each block's launches: its shape's count over the blocks of that shape
    # (G01 and G10, B0 and B1, Bt0 and Bt1 share theirs)
    j_block_launches = {
        key: shapes_j["K2" if " K2 " in key else "K3"][
            (len(A_.offsets),) + A_.grid_shape if isinstance(A_, StencilMatrix) else A_.shape]
        // (1 if " K2 " in key or key.endswith("Mp") else 2)
        for key, A_ in jk_ops.items()}
    del run_j, x_j, st_j, gst_j, leaves, K0_j
    torch.cuda.empty_cache()
    # J3: the RT0 H(div) GMG (Richardson(2, 0.4) over the vertex patches)
    # as CG's preconditioner on hdiv_operator, x_true seeded
    gmg3, A3, free3 = hdiv_mod.hdiv_gmg((NC_J3, NC_J3), levels_j, alpha=DARCY_ALPHA,
                                        device=dev)
    rng3 = np.random.default_rng(1)
    x_true3 = tuple(torch.from_numpy(rng3.normal(size=int(f_.shape[0]))).to(dev) * f_
                    for f_ in free3)
    b3 = A3.matvec(x_true3)
    cg3 = CGSolver(Pl=gmg3, rtol=J3_RTOL, maxiter=J3_MAXITER)
    reset_counts()
    st3 = cg3.setup(A3)
    x3, s3 = cg3.solve(st3, b3)
    launches["J3"] = read_counts(k2_box=False)
    shapes_j3 = dict(k3.counts.shapes)
    # CG applies the operator once at the start and once an iteration; each
    # of the n + 1 V-cycles Richardson(2) pre and post and the correction
    # residual on every smoothing level, once on the coarsest: four K3
    # blocks an apply, each of level l's (N_l, N_l)
    want_j3 = {}
    for lev in range(levels_j):
        n_l = NC_J3 >> lev
        per = (s3.niter + 1) * (1 if lev == levels_j - 1 else 5) + (s3.niter + 1 if lev == 0
                                                                    else 0)
        want_j3[((n_l + 1) * n_l, (n_l + 1) * n_l)] = 4 * per
    assert shapes_j3 == want_j3 and launches["J3"]["K2"] == 0, (shapes_j3, want_j3)
    assert s3.converged() and J3_ITS[0] <= s3.niter <= J3_ITS[1], (s3.niter, s3.flag)
    err3 = float(pt.norm(pt.sub(x3, x_true3)) / pt.norm(x_true3))
    jk_ops.update({"J3 K3 RT0 (0,0)": A3.blocks[0][0], "J3 K3 RT0 (0,1)": A3.blocks[0][1]})
    n3 = (NC_J3 + 1) * NC_J3
    j_block_launches.update({key: want_j3[(n3, n3)] // 4 for key in jk_ops if "J3" in key})
    print(f"[6J path J3] RT0 H(div) GMG-CG {NC_J3}^2/{levels_j} levels f64 (alpha "
          f"{DARCY_ALPHA:g}, rtol {J3_RTOL:g} <= {J3_MAXITER}): {s3.niter} its (band {J3_ITS}), "
          f"flag {s3.flag}, relative error {err3:.2e}; K3 launches {launches['J3']['K3']} by "
          f"shape equal to the formula ({', '.join(f'{k} {v}' for k, v in sorted(want_j3.items()))})"
          f"; K1 0, K2 0, plain 0 {elapsed()}", flush=True)
    # J's operators against their plain versions (f64 as the path runs
    # them, and f32)
    for key, A64 in jk_ops.items():
        for dt, tol in ((f64, F64_TOL), (f32, F32_TOL)):
            A = A64.astype(dt)
            if isinstance(A, StencilMatrix):
                check_k2(f"[{key}]{str(dt)[6:]}", A, vec(A.n, dt), tol, False)
            else:
                check_ell(f"K3[{key} {A.nrows}x{A.ncols} K={A.row_width}]{str(dt)[6:]}", A,
                          vec(A.ncols, dt), tol)
    print(f"[6J kernels] {len(lines)} cases on path J's operators within f32 {F32_TOL:.0e} / "
          f"f64 {F64_TOL:.0e}: " + ", ".join(lines) + f" {elapsed()}", flush=True)
    lines.clear()
    del gmg3, st3, x3, x_true3, b3, A3
    torch.cuda.empty_cache()

    # ---- 6K path K: linear elasticity ------------------------------------
    # Kb (card = CPU): solve_elasticity at NC_KB^3; Kc (card = CPU): CG +
    # AMG with rigid-body near-nullspace candidates at NC_KC^2; Ka:
    # solve_elasticity's configuration at NC_K^3 in f64, counted
    (xc_, sc_, ic_), (xh_, sh_, ih_) = (solve_elasticity((NC_KB,) * 3, num_levels=3, device=d)
                                        for d in (dev, "cpu"))
    assert sc_.niter == sh_.niter and int(sc_.flag) == int(sh_.flag) == 2, (sc_.niter, sh_.niter)
    ekb = relerr(flat(xc_).cpu(), flat(xh_))
    assert ekb <= K_SMALL_TOL, f"Kb: card against CPU x {ekb:.2e}"
    small = [f"Kb solve_elasticity(({NC_KB},)*3, num_levels=3) {sc_.niter} = {sh_.niter} its, "
             f"flag {sc_.flag}, x rel diff {ekb:.1e}, residual {ic_['residual']:.2e}"]
    kc = {}
    for d in (dev, "cpu"):
        prob_c = el_mod.elasticity_problem((NC_KC, NC_KC), device=d)
        coords = prob_c.mesh.vertex_coords()
        ns = rigid_body_modes(torch.from_numpy(coords))
        n_ = coords.shape[0]
        cand = np.stack([np.concatenate([q.numpy().reshape(n_, 2)[:, 0],
                                         q.numpy().reshape(n_, 2)[:, 1]]) for q in ns.vectors],
                        axis=1)
        cg_c = CGSolver(Pl=AMGSolver(coarse_size=80, near_nullspace=cand), rtol=1e-8,
                        maxiter=80)
        reset_counts()
        st_c = cg_c.setup(prob_c.A)
        xk_, sk_ = cg_c.solve(st_c, prob_c.b)
        kc[d] = (xk_, sk_, prob_c.residual_norm(xk_))
        if d == dev:
            launches["Kc"] = read_counts(k2_box=False)
            amg_c = len(st_c["Pl"]["mats"])
    assert kc[dev][1].niter == kc["cpu"][1].niter and kc[dev][1].converged(), (
        kc[dev][1].niter, kc["cpu"][1].niter)
    ekc = relerr(flat(kc[dev][0]).cpu(), flat(kc["cpu"][0]))
    assert ekc <= K_SMALL_TOL and launches["Kc"]["K3"] > 0, (ekc, launches["Kc"])
    small.append(f"Kc AMG + rigid-body candidates {NC_KC}^2 ({amg_c} levels) {kc[dev][1].niter} "
                 f"= {kc['cpu'][1].niter} its, x rel diff {ekc:.1e}, residual {kc[dev][2]:.2e}, "
                 f"K3 launches {launches['Kc']['K3']}")
    del kc, xc_, xh_, ic_, ih_, prob_c, st_c
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    with SyncCount() as syncs:
        run_k = setup_k(NC_K, LEVELS_K, f64, dev)
        syncs_k = [syncs.read()]
        solve_j(run_k)
        syncs_k.append(syncs.read() - syncs_k[0])
    assert not any(c.plain for c in COUNTS.values()), {k: c.plain for k, c in COUNTS.items()}
    launches["Ka"] = {k: c.kernel for k, c in COUNTS.items()}
    shapes_k = dict(k2.counts.shapes)
    box_k = k2.counts.box
    mem_k = (torch.cuda.max_memory_allocated() - mem0) / 2 ** 30
    prob_k, x_k, st_k = run_k["prob"], run_k["x"], run_k["stats"]
    gst_k = run_k["state"]["Pl"]
    noffs_k = [[len(b.offsets) for row in m_.blocks for b in row] for m_ in gst_k["mats"]]
    want_k = k_launches(NC_K, st_k.niter, LEVELS_K, 4, lanczos, noffs_k)
    assert shapes_k == want_k, (shapes_k, want_k)
    assert launches["Ka"]["K1"] == launches["Ka"]["K3"] == 0
    # the 27-offset blocks take the box kernel, the others (fewer offsets)
    # the general kernel
    assert box_k == sum(c for s_, c in shapes_k.items() if s_[0] == 27), (box_k, shapes_k)
    hist_k = st_k.residuals.cpu().numpy()
    assert int(st_k.flag) == 2 and K_ITS[0] <= st_k.niter <= K_ITS[1], (st_k.niter, st_k.flag)
    leaves = pt.tree_leaves(x_k)
    assert [t.shape[0] for t in leaves] == [(NC_K + 1) ** 3] * 3
    assert all(t.dtype == f64 and bool(torch.isfinite(t).all()) for t in leaves)
    res_k = prob_k.residual_norm(x_k)
    rel_k = res_k / float(pt.norm(prob_k.b))
    uz_mean = float(x_k[2].mean())
    assert rel_k <= 2 * K_RTOL and uz_mean < 0, (rel_k, uz_mean)
    t_solve_k = median_ms(lambda: run_k["solver"].solve(run_k["state"], prob_k.b), runs=3,
                          warmup=0, spin=False)
    print(f"[6K path K] elasticity: " + "; ".join(small)
          + f"; Ka {NC_K}^3/{LEVELS_K} levels f64 (clamped x0, mu = lambda = 1, unit downward "
          f"load; CG rtol {K_RTOL:g} <= {K_MAXITER} + GMG Chebyshev(4, ratio 40); "
          f"{3 * (NC_K + 1) ** 3} unknowns; counted): {st_k.niter} its (band {K_ITS}), flag "
          f"{st_k.flag}, residuals " + " ".join(f"{v:.3e}" for v in hist_k[: st_k.niter + 1])
          + f"; residual_norm {res_k:.3e} (relative {rel_k:.3e}), mean u_z {uz_mean:.4e}; "
          f"set-up {run_k['setup_s']:.2f} s by step: "
          + ", ".join(f"{k} {v:.2f}" for k, v in run_k["secs"].items())
          + f"; solve {run_k['solve_s']:.3f} s (median of 3 more {t_solve_k / 1e3:.3f} s); "
          f"host syncs measured: set-up {syncs_k[0]}, solve {syncs_k[1]}; peak device memory "
          f"{mem_k:.2f} GiB over what earlier paths hold; K2 launches by shape equal to "
          f"k_launches: " + ", ".join(f"{k} {v}" for k, v in sorted(shapes_k.items()))
          + f" ({box_k} on the box kernel: the 27-offset blocks); K1 0, K3 0, plain 0 "
          f"{elapsed()}", flush=True)
    if opts.profile is not None:
        summary = profile_solve(lambda: run_k["solver"].solve(run_k["state"], prob_k.b),
                                opts.profile, "path_Ka")
        print(f"[profile] path Ka solve, {card}: {summary} {elapsed()}", flush=True)
    # K2 on the nine level-0 blocks against its plain version (f64, f32);
    # phase 8 times the (0,0) block (27 offsets, box kernel) and the (0,2)
    # block (23 offsets, general kernel)
    K0_k = prob_k.A
    for i_, row in enumerate(K0_k.blocks):
        for j_, A64 in enumerate(row):
            for dt, tol in ((f64, F64_TOL), (f32, F32_TOL)):
                A = A64.astype(dt)
                check_k2(f"[Ka ({i_},{j_}) {len(A.offsets)} bands]{str(dt)[6:]}", A,
                         vec(A.n, dt), tol, len(A.offsets) == 27)
            del A
    print(f"[6K kernels] {len(lines)} cases on path Ka's {NC_K + 1}^3 blocks within f32 "
          f"{F32_TOL:.0e} / f64 {F64_TOL:.0e}: " + ", ".join(lines) + f" {elapsed()}",
          flush=True)
    lines.clear()
    for i_, j_ in ((0, 0), (0, 2)):
        A_ = K0_k.blocks[i_][j_]
        key = f"K K2 ({i_},{j_}) {len(A_.offsets)} bands"
        jk_ops[key] = A_
        j_block_launches[key] = sum(c for s_, c in shapes_k.items()
                                    if s_ == (len(A_.offsets),) + A_.grid_shape) // (
            sum(1 for row in K0_k.blocks for b in row if len(b.offsets) == len(A_.offsets)))
    del run_k, x_k, st_k, gst_k, leaves, K0_k, prob_k
    torch.cuda.empty_cache()

    # ---- 6L path L: the small modules (card = CPU) ------------------------
    small = []
    for d in (dev, "cpu"):
        prob_l = poisson_problem((NC_L,) * 3, device=d)
        part = []
        for tag, pl, kw in (
                ("GS masked", ColoredGaussSeidel(niter=1), dict(rtol=1e-8, flexible=True)),
                ("GS compact", ColoredGaussSeidel(niter=1, impl="compact"),
                 dict(rtol=1e-8, flexible=True)),
                ("SSOR 1.3", ColoredGaussSeidel(niter=1, sweep="symmetric", omega=1.3),
                 dict(rtol=1e-9, maxiter=L_SSOR_MAXITER))):
            cg_l = CGSolver(Pl=pl, **kw)
            xl_, sl_ = cg_l.solve(cg_l.setup(prob_l.A), prob_l.b)
            assert sl_.converged(), (tag, d, sl_.niter, sl_.flag)
            part.append((tag, sl_.niter, flat(xl_).cpu()))
        sh_l = fe_space_hierarchy(cartesian_hierarchy((NC_L,) * 3, 3), order=1)
        mats_l = sh_l.compute_matrices("stiffness", device=d)
        P_l, R_l = sh_l.transfer_operators(device=d)
        gmg_l = GMGSolver(coarse_ops=tuple(mats_l[1:]), prolongations=tuple(P_l),
                          restrictions=tuple(R_l), smoother=ChebyshevSmoother(degree=3))
        cg_l = CGSolver(Pl=gmg_l, rtol=1e-8, maxiter=30)
        xl_, sl_ = cg_l.solve(cg_l.setup(mats_l[0]), prob_l.b)
        assert sl_.converged(), (d, sl_.niter)
        part.append(("FESpaceHierarchy GMG-CG", sl_.niter, flat(xl_).cpu()))
        R2 = setup_projection_restrictions(cartesian_hierarchy((NC_L,) * 3, 2), device=d)[0]
        uf = torch.from_numpy(np.random.default_rng(2).normal(size=(NC_L + 1) ** 3)).to(d)
        part.append(("L2ProjectionRestriction", 0, R2.matvec(uf).cpu()))
        small.append(part)
    out_l = []
    for (tag, n_c, x_c), (_, n_h, x_h) in zip(*small):
        e = relerr(x_c, x_h)
        assert n_c == n_h and e <= L_TOL, (tag, n_c, n_h, e)
        out_l.append(f"{tag} {n_c} = {n_h} its, rel diff {e:.1e}")
    print(f"[6L path L] {NC_L}^3 card = CPU: " + "; ".join(out_l) + f" {elapsed()}", flush=True)
    del small, prob_l, mats_l, gmg_l, cg_l, xl_
    torch.cuda.empty_cache()

    return {"jk_ops": jk_ops, "j_block_launches": j_block_launches, "shapes_j": shapes_j,
            "shapes_j3": shapes_j3, "shapes_k": shapes_k, "t_solve_j": t_solve_j,
            "t_solve_k": t_solve_k}


def paths_mno(dev, opts, card, elapsed, launches, check_k2, check_ell, lines) -> dict:
    """Paths M, N and O on `dev` (main's phases 6M, 6N, 6O), as paths_jkl:
    each counted run's launches go into `launches`, each kernel check
    through main's `check_k2` / `check_ell` (with `lines`), on vectors of
    its own generator, so that the phases after it see the inputs they saw
    before it was added.
    Returns what phase 8 times and reports: the timed operators (`ops`),
    each one's launches in its run (`op_launches`), the counted runs'
    launches by operand shape and the M1, N1 and O1 solve times."""
    f32, f64 = torch.float32, torch.float64
    lanczos = ChebyshevSmoother().lanczos_iters
    rng = np.random.default_rng(10)

    def vec(n, dtype):
        return torch.from_numpy(rng.normal(size=n)).to(dev, dtype)

    def flat(x):
        return torch.cat([t.reshape(-1) for t in pt.tree_leaves(x)])

    def true_rel(A, b, x):
        return float(pt.norm(pt.sub(b, A.matvec(x))) / pt.norm(b))

    def card_cpu(tag, runs, tol, cap=None):
        """Card (runs[0]) against CPU (runs[1]): iterations and flags equal,
        x within tol of max|x|."""
        (xc, sc), (xh, sh) = ((r["x"], r["stats"]) for r in runs)
        assert sc.niter == sh.niter and int(sc.flag) == int(sh.flag), (
            tag, sc.niter, sh.niter, sc.flag, sh.flag)
        assert cap is None or (sc.converged() and sc.niter <= cap), (tag, sc.niter, sc.flag)
        e = relerr(flat(xc).cpu(), flat(xh))
        assert e <= tol, f"{tag}: card against CPU x {e:.2e} > {tol:g}"
        return f"{tag} {sc.niter} = {sh.niter} its, flag {sc.flag}, x rel diff {e:.1e}"

    def by_shape(counts):
        return ", ".join(f"{'x'.join(map(str, k))} {v}" for k, v in sorted(counts.items()))

    def setup_line(run):
        return (f"set-up {run['setup_s']:.2f} s by step: "
                + ", ".join(f"{k} {v:.2f}" for k, v in run["secs"].items()))

    def hist(st):
        return " ".join(f"{v:.3e}" for v in st.residuals.cpu().numpy()[: st.niter + 1])

    def check_ops(tag, named):
        """Each operator against its plain version, f64 as the path runs
        it, and f32."""
        for key, A64 in named.items():
            for dt, tol in ((f64, F64_TOL), (f32, F32_TOL)):
                A = A64.astype(dt)
                if isinstance(A, StencilMatrix):
                    check_k2(f"[{key}]{str(dt)[6:]}", A, vec(A.n, dt), tol, False)
                else:
                    check_ell(f"K3[{key} {A.nrows}x{A.ncols} K={A.row_width}]{str(dt)[6:]}", A,
                              vec(A.ncols, dt), tol)
        print(f"[{tag} kernels] {len(lines)} cases on the path's operators within f32 "
              f"{F32_TOL:.0e} / f64 {F64_TOL:.0e}: " + ", ".join(lines) + f" {elapsed()}",
              flush=True)
        lines.clear()

    ops, op_launches, shapes, t_solve = {}, {}, {}, {}

    # ---- 6M path M: two-level Schwarz with GenEO --------------------------
    # M2 (card = CPU) at the test size: the one-level solver, the two-level
    # one with the Neumann matrices and without (the algebraic pencil), and
    # the nested coarse solver (CG + Jacobi on A0, flexible CG outside)
    kap2 = np.ones(M2_NC)
    kap2[:, 2] = 1e4
    small = []
    for ns, level, neumann, nested in ((2, "one", False, False), (2, "two", True, False),
                                       (2, "two", False, False), (4, "one", False, False),
                                       (4, "two", True, False), (4, "two", False, False),
                                       (4, "two", True, True)):
        runs = [solve_j(setup_m(M2_NC, ns, 2, f64, d, kappa=kap2, level=level, neumann=neumann,
                                domain=(0.0, 1.0, 0.0, 1.0),
                                coarse_solver=CGSolver(Pl=JacobiSolver(), rtol=1e-10,
                                                       maxiter=100) if nested else None))
                for d in (dev, "cpu")]
        tag = (f"{level}-level{' Neumann' if neumann else ''}{' nested coarse' if nested else ''}"
               f" ns {ns}")
        small.append(card_cpu(tag, runs, M2_TOL))
    del runs
    # M1, counted
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    with SyncCount() as syncs:
        run_m = setup_m(NC_M, NS_M, NEV_M, f64, dev)
        syncs_m = [syncs.read()]
        solve_j(run_m)
        syncs_m.append(syncs.read() - syncs_m[0])
    launches["M1"] = read_counts(k2_box=False)
    shapes["M1"] = dict(k2.counts.shapes)
    mem_m = (torch.cuda.max_memory_allocated() - mem0) / 2 ** 30
    A_m, b_m, x_m, st_m = run_m["prob"].A, run_m["prob"].b, run_m["x"], run_m["stats"]
    want_m = m_launches(A_m.grid_shape, st_m.niter, NS_M, NEV_M)
    assert shapes["M1"] == want_m, (shapes["M1"], want_m)
    assert launches["M1"]["K1"] == launches["M1"]["K3"] == 0, launches["M1"]
    assert st_m.converged() and M_ITS[0] <= st_m.niter <= M_ITS[1], (st_m.niter, st_m.flag)
    assert x_m.shape == (A_m.n,) and x_m.dtype == f64 and bool(torch.isfinite(x_m).all())
    rel_m = true_rel(A_m, b_m, x_m)
    assert rel_m <= 10 * M_RTOL, rel_m      # tests/test_schwarz.py's check
    lam = run_m["state"]["Pl"]["eigenvalues"]
    gap_m = float((lam[:, NEV_M] / lam[:, NEV_M - 1]).min())
    t_solve["M1"] = median_ms(lambda: run_m["solver"].solve(run_m["state"], b_m), runs=3,
                              warmup=0, spin=False)
    line_m = (f"M1 {NC_M[0]}x{NC_M[1]} square cells f64 ({A_m.n} unknowns; kappa 1e4 in cell columns "
              f"{M_CHANNELS}; {NS_M} slabs of overlap 2, nev {NEV_M}, Neumann matrices; CG rtol "
              f"{M_RTOL:g} <= {M_MAXITER}; counted): {st_m.niter} its (band {M_ITS}), flag "
              f"{st_m.flag}, residuals {hist(st_m)}; true relative residual {rel_m:.3e} (<= "
              f"{10 * M_RTOL:g}); smallest eigenvalue ratio lambda_{NEV_M + 1} / lambda_{NEV_M} "
              f"over the slabs {gap_m:.4f}; {setup_line(run_m)}; solve {run_m['solve_s']:.3f} s "
              f"(median of 3 more {t_solve['M1'] / 1e3:.3f} s); host syncs measured: set-up "
              f"{syncs_m[0]}, solve {syncs_m[1]}; peak device memory {mem_m:.2f} GiB over what "
              f"earlier paths hold; K2 launches by shape equal to m_launches: "
              f"{by_shape(shapes['M1'])}; K1 0, K3 0, plain 0")
    if opts.profile is not None:
        summary = profile_solve(lambda: run_m["solver"].solve(run_m["state"], b_m),
                                opts.profile, "path_M1")
        print(f"[profile] path M1 solve, {card}: {summary} {elapsed()}", flush=True)
    del run_m, x_m
    torch.cuda.empty_cache()
    # the one-level solver beside it, on the same operator
    one = CGSolver(Pl=schwarz_mod.SchwarzLinearSolver(n_subdomains=NS_M, overlap=2),
                   rtol=M_RTOL, maxiter=M_MAXITER)
    t0 = time.perf_counter()
    _, st_one = one.solve(one.setup(A_m), b_m)
    fence()
    t_one = time.perf_counter() - t0
    assert st_one.niter > st_m.niter, (st_one.niter, st_m.niter)
    print(f"[6M path M] two-level Schwarz (GenEO): M2 card = CPU ({M2_NC[0]}x{M2_NC[1]} cells, "
          f"kappa 1e4 in cell column 2, overlap 2, nev 2): " + "; ".join(small) + f"; {line_m}; "
          f"one-level Schwarz on the same operator: {st_one.niter} its, flag {st_one.flag} "
          f"(set-up and solve {t_one:.2f} s) {elapsed()}", flush=True)
    check_ops("6M", {"M K2 A 9 bands": A_m})
    key = f"M K2 A 9 bands"
    ops[key] = A_m
    op_launches[key] = want_m[(9,) + A_m.grid_shape]
    del one, b_m
    torch.cuda.empty_cache()

    # ---- 6N path N: H(curl) curl-curl with AMS ----------------------------
    # N2 (card = CPU): tests/test_hcurl.py's sizes and alphas; at 16^2,
    # alpha 1 the nodal AMG's coarsest operator is singular (constants lie
    # in the kernel of GᵀAG) and its dense inverse amplifies each device's
    # round-off along that kernel: x held to N2_SINGULAR_TOL there
    small = []
    for nc, alpha in (((16, 16), 1.0), ((16, 16), 100.0), ((8, 8, 8), 1.0), ((8, 8, 8), 100.0)):
        runs = [solve_j(setup_n(nc, alpha, f64, d)) for d in (dev, "cpu")]
        tol = N2_SINGULAR_TOL if (len(nc), alpha) == (2, 1.0) else N2_TOL
        small.append(card_cpu(f"{nc} alpha {alpha:g}", runs, tol, cap=40))
    del runs
    # N1, counted: set-up, solve, AMSSolver.update on 2A, solve
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    with SyncCount() as syncs:
        run_n = setup_n((NC_N,) * 3, 1.0, f64, dev)
        syncs_n = [syncs.read()]
        solve_j(run_n)
        syncs_n.append(syncs.read() - syncs_n[0])
        A_n, b_n = run_n["prob"].A, run_n["prob"].b
        A2_n = scaled_block_operator(A_n, 2.0)
        t0 = time.perf_counter()
        state2 = run_n["solver"].update(run_n["state"], A2_n)
        fence()
        t_up = time.perf_counter() - t0
        syncs_n.append(syncs.read() - sum(syncs_n))
        t0 = time.perf_counter()
        x2, st2 = run_n["solver"].solve(state2, b_n)
        fence()
        t_s2 = time.perf_counter() - t0
    launches["N1"] = read_counts(k2_box=False)
    shapes["N1"] = dict(k3.counts.shapes)
    mem_n = (torch.cuda.max_memory_allocated() - mem0) / 2 ** 30
    x_n, st_n = run_n["x"], run_n["stats"]
    ams = state2["Pl"]
    want_n = n_launches(A_n, ams, [st_n.niter, st2.niter], lanczos, 3)
    assert shapes["N1"] == want_n, (shapes["N1"], want_n)
    assert launches["N1"]["K1"] == launches["N1"]["K2"] == 0, launches["N1"]
    for st_ in (st_n, st2):
        assert st_.converged() and N_ITS[0] <= st_.niter <= N_ITS[1], (st_.niter, st_.flag)
    n_edges = sum(int(t.shape[0]) for t in b_n)
    assert [int(t.shape[0]) for t in pt.tree_leaves(x_n)] == [NC_N * (NC_N + 1) ** 2] * 3
    assert all(t.dtype == f64 and bool(torch.isfinite(t).all()) for t in pt.tree_leaves(x_n))
    rel_n, rel2 = true_rel(A_n, b_n, x_n), true_rel(A2_n, b_n, x2)
    assert rel_n <= 10 * N_RTOL and rel2 <= 10 * N_RTOL, (rel_n, rel2)
    # AMS on 2A is AMS on A halved (Chebyshev sees D⁻¹A, AMG's levels
    # scale), so the second solve repeats the first at x / 2
    e_half = relerr(2.0 * flat(x2), flat(x_n))
    assert st2.niter == st_n.niter and e_half <= N2_TOL, (st2.niter, st_n.niter, e_half)
    levels_n = [len(h["mats"]) for h in [ams["node"]] + list(ams["vec"])]
    coarse_n = [h["mats"][-1].shape[0] for h in [ams["node"]] + list(ams["vec"])]
    t_solve["N1"] = median_ms(lambda: run_n["solver"].solve(state2, b_n), runs=3, warmup=0,
                              spin=False)
    print(f"[6N path N] curl-curl + AMS: N2 card = CPU (CG rtol {N_RTOL:g}, <= 40 its): "
          + "; ".join(small)
          + f"; N1 make_ams(({NC_N},)*3, alpha 1, beta 1) f64 ({n_edges} edges; Chebyshev(3) + "
          f"AMG on GᵀAG and on each Π_cᵀAΠ_c, AMG levels {levels_n}, coarsest {coarse_n}; CG "
          f"rtol {N_RTOL:g} <= {N_MAXITER}; counted): {st_n.niter} its (band {N_ITS}), flag "
          f"{st_n.flag}, residuals {hist(st_n)}; true relative residual {rel_n:.3e}; "
          f"{setup_line(run_n)}; solve {run_n['solve_s']:.3f} s; AMSSolver.update on 2A "
          f"{t_up:.2f} s, then {st2.niter} its, flag {st2.flag}, true relative residual "
          f"{rel2:.3e}, 2 x2 against x {e_half:.1e}, solve {t_s2:.3f} s (median of 3 more "
          f"{t_solve['N1'] / 1e3:.3f} s); host syncs measured: set-up {syncs_n[0]}, solve "
          f"{syncs_n[1]}, update {syncs_n[2]}; peak device memory {mem_n:.2f} GiB over what "
          f"earlier paths hold; K3 launches by shape equal to n_launches: "
          f"{by_shape(shapes['N1'])}; K1 0, K2 0, plain 0 {elapsed()}", flush=True)
    if opts.profile is not None:
        summary = profile_solve(lambda: run_n["solver"].solve(state2, b_n), opts.profile,
                                "path_N1")
        print(f"[profile] path N1 solve, {card}: {summary} {elapsed()}", flush=True)
    # N1's operators: the level-0 edge blocks (0,0) and (0,1), G, Gᵀ, Π_0
    # and Π_0ᵀ; each one's launches: its shape's count over the operators
    # of that shape (the nine blocks share one; G and the three Π_c
    # another; Gᵀ and the Π_cᵀ a third)
    named = {"N K3 A (0,0)": A_n.blocks[0][0], "N K3 A (0,1)": A_n.blocks[0][1],
             "N K3 G": ams["G"], "N K3 Gt": ams["GT"], "N K3 Pi0": ams["Pi"][0],
             "N K3 Pi0t": ams["PiT"][0]}
    check_ops("6N", named)
    for key, A_ in named.items():
        share = 9 if " A " in key else 4
        ops[key] = A_
        op_launches[key] = shapes["N1"][A_.shape] // share
    del run_n, state2, ams, x_n, x2, A2_n, b_n
    torch.cuda.empty_cache()

    # ---- 6O path O: 3D MHD multifield GMG ---------------------------------
    # O2 (card = CPU): 8^3, 2 levels, the V, W and F cycles at gamma 1 and
    # the V-cycle at gamma 10 (tests/test_multifield.py: <= 20 and <= 30 its)
    small = []
    for cycle, gamma, cap in (("v", 1.0, 20), ("w", 1.0, 20), ("f", 1.0, 20), ("v", 10.0, 30)):
        runs = [solve_j(setup_o((8, 8, 8), 2, f64, d, gamma=gamma, cycle=cycle))
                for d in (dev, "cpu")]
        small.append(card_cpu(f"{cycle}-cycle gamma {gamma:g}", runs, O2_TOL, cap=cap))
    del runs
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    with SyncCount() as syncs:
        run_o = setup_o((NC_O,) * 3, LEVELS_O, f64, dev)
        syncs_o = [syncs.read()]
        solve_j(run_o)
        syncs_o.append(syncs.read() - syncs_o[0])
    launches["O1"] = read_counts(k2_box=False)
    shapes["O1"] = dict(k3.counts.shapes)
    mem_o = (torch.cuda.max_memory_allocated() - mem0) / 2 ** 30
    prob_o, x_o, st_o = run_o["prob"], run_o["x"], run_o["stats"]
    mats_o = run_o["state"]["Pr"]["mats"]
    want_o = o_launches(mats_o, st_o.niter, 30, 2)
    assert shapes["O1"] == want_o, (shapes["O1"], want_o)
    assert launches["O1"]["K1"] == launches["O1"]["K2"] == 0, launches["O1"]
    assert st_o.converged() and O_ITS[0] <= st_o.niter <= O_ITS[1], (st_o.niter, st_o.flag)
    n_node, n_face = (NC_O + 1) ** 3, (NC_O + 1) * NC_O ** 2
    assert [int(t.shape[0]) for t in x_o] == [n_node] * 3 + [n_face] * 3
    assert all(t.dtype == f64 and bool(torch.isfinite(t).all()) for t in x_o)
    res_o = prob_o.residual_norm(x_o)
    bnorm_o = float(pt.norm(prob_o.b))
    assert res_o < O_RES_REL * bnorm_o, (res_o, bnorm_o)
    t_solve["O1"] = median_ms(lambda: run_o["solver"].solve(run_o["state"], prob_o.b), runs=3,
                              warmup=0, spin=False)
    print(f"[6O path O] MHD multifield GMG: O2 card = CPU (8^3, 2 levels, FGMRES(30) rtol "
          f"{O_RTOL:g}): " + "; ".join(small)
          + f"; O1 mhd_gmg(({NC_O},)*3, {LEVELS_O}) f64 ({3 * n_node + 3 * n_face} unknowns in "
          f"6 fields; Richardson(2, 0.3) over the 15-dof vertex Vanka, "
          f"{(NC_O - 1) ** 3} patches at level 0, dense LU at {NC_O >> (LEVELS_O - 1)}^3; "
          f"FGMRES(30) rtol {O_RTOL:g} <= {O_MAXITER}; counted): {st_o.niter} its (band "
          f"{O_ITS}), flag {st_o.flag}, residuals {hist(st_o)}; residual_norm {res_o:.3e} "
          f"(< {O_RES_REL:g} x ||b|| = {O_RES_REL * bnorm_o:.3e}); {setup_line(run_o)}; solve "
          f"{run_o['solve_s']:.3f} s (median of 3 more {t_solve['O1'] / 1e3:.3f} s); host syncs "
          f"measured: set-up {syncs_o[0]}, solve {syncs_o[1]}; peak device memory {mem_o:.2f} "
          f"GiB over what earlier paths hold; K3 launches by shape equal to o_launches: "
          f"{by_shape(shapes['O1'])}; K1 0, K2 0, plain 0 {elapsed()}", flush=True)
    if opts.profile is not None:
        summary = profile_solve(lambda: run_o["solver"].solve(run_o["state"], prob_o.b),
                                opts.profile, "path_O1")
        print(f"[profile] path O1 solve, {card}: {summary} {elapsed()}", flush=True)
    # O1's level-0 u-u, u-j, j-u and j-j blocks; each one's launches: its
    # shape's count over the level-0 blocks of that shape
    A0 = prob_o.A
    named = {"O K3 u-u (0,0)": A0.blocks[0][0], "O K3 u-j (0,4)": A0.blocks[0][4],
             "O K3 j-u (4,0)": A0.blocks[4][0], "O K3 j-j (3,3)": A0.blocks[3][3]}
    check_ops("6O", named)
    per_shape = collections.Counter(b.shape for row in A0.blocks for b in row if b is not None)
    for key, A_ in named.items():
        ops[key] = A_
        op_launches[key] = shapes["O1"][A_.shape] // per_shape[A_.shape]
    del run_o, x_o, mats_o
    torch.cuda.empty_cache()
    return {"ops": ops, "op_launches": op_launches, "shapes": shapes, "t_solve": t_solve}


# ---- path P: block-structured AMR -----------------------------------------


def p_f3(p) -> np.ndarray:
    """-lap u3 for path P1's exact solution u3 = sum over P_CENTRES of
    exp(-P_C3 |x - c|^2) (host, (n, 3) points)."""
    out = 0.0
    for c in P_CENTRES:
        r2 = sum((p[:, d] - c[d]) ** 2 for d in range(3))
        out = out + (6 * P_C3 - 4 * P_C3 * P_C3 * r2) * np.exp(-P_C3 * r2)
    return out


def p_u3_grid(ncells: int, dtype, device) -> torch.Tensor:
    """u3 (see p_f3) at the vertices of the uniform ncells^3 grid of the
    unit cube, on the device (each bump is a product of three 1D factors)."""
    x = torch.from_numpy(np.linspace(0.0, 1.0, ncells + 1)).to(device, dtype)
    out = 0.0
    for c in P_CENTRES:
        g = [torch.exp(-P_C3 * (x - c[d]) ** 2) for d in range(3)]
        out = out + g[0][:, None, None] * g[1][None, :, None] * g[2][None, None, :]
    return out


def q1_energy(e: torch.Tensor, h) -> float:
    """eᵀ A e for the Q1 stiffness A of a uniform vertex grid of spacings h
    (no boundary rows eliminated), from the element quadratic forms: for
    each axis d, (1/h_d) Π_{o≠d} (h_o/6) Σ_cells Σ_{a,b} Π_o m[a_o, b_o]
    w[c+a] w[c+b], with w the differences of e along d and m = [[2, 1],
    [1, 2]]. On e's device, without assembling A (at 513^3 its bands would
    take 29 GB)."""
    dim, total = e.ndim, 0.0
    for d in range(dim):
        w = torch.diff(e, dim=d)
        others = [o for o in range(dim) if o != d]
        scale = 1.0 / h[d]
        for o in others:
            scale *= h[o] / 6.0
        acc = 0.0
        for a in itertools.product((0, 1), repeat=len(others)):
            wa = w
            for o, ao in zip(others, a):
                wa = wa.narrow(o, ao, w.shape[o] - 1)
            for b in itertools.product((0, 1), repeat=len(others)):
                coef = 1
                wb = w
                for o, ao, bo in zip(others, a, b):
                    coef *= 2 if ao == bo else 1
                    wb = wb.narrow(o, bo, w.shape[o] - 1)
                acc += coef * float(torch.sum(wa * wb))
        total += scale * acc
    return total


P_STEPS = (
    ("host assembly", asm_q1, "q1_var_bands_host"),
    ("patch GMG", forest_mod.ForestPreconditioner, "_patch_gmg"),
    ("Gershgorin bounds", smoothers_mod, "gershgorin_dinv_a_lmax"),
    ("LU", DenseLUSolver, "setup"),
)


def build_p(hier, dtype, device) -> dict:
    """Path P's composite system and solver on a forest, set up: the
    forest's composite operator and load (`forest_composite_system`),
    flexible CG rtol P_RTOL <= P_MAXITER + ForestPreconditioner(hier,
    num_levels=P_LEVELS). Returns a dict with them, the set-up seconds by
    step (StepTimes over P_STEPS) and each patch's GMG set-up seconds."""
    cuda = torch.device(device).type == "cuda"
    per_patch = []
    orig = forest_mod.ForestPreconditioner.__dict__["_patch_gmg"]

    def timed(self, *args, **kwargs):
        if cuda:
            fence()
        t0 = time.perf_counter()
        out = orig(self, *args, **kwargs)
        if cuda:
            fence()
        per_patch.append(time.perf_counter() - t0)
        return out

    forest_mod.ForestPreconditioner._patch_gmg = timed
    try:
        with StepTimes(device, P_STEPS) as steps:
            t0 = time.perf_counter()
            op, b = forest_mod.forest_composite_system(hier, p_f3, dtype=dtype, device=device)
            solver = CGSolver(Pl=forest_mod.ForestPreconditioner(hier, num_levels=P_LEVELS),
                              rtol=P_RTOL, maxiter=P_MAXITER, flexible=True)
            state = solver.setup(op)
            if cuda:
                fence()
            total = time.perf_counter() - t0
    finally:
        forest_mod.ForestPreconditioner._patch_gmg = orig
    secs = dict(steps.secs)
    secs["other"] = total - sum(secs.values())
    return {"hier": hier, "op": op, "b": b, "solver": solver, "state": state, "secs": secs,
            "setup_s": total, "patch_gmg_s": per_patch}


def solve_p(run) -> dict:
    """Solve a set-up path P run: adds x, the stats, the solve seconds and
    the per-patch grids (`us`, slave rings filled in)."""
    t0 = time.perf_counter()
    run["x"], run["stats"] = run["solver"].solve(run["state"], run["b"])
    if run["b"][0].device.type == "cuda":
        fence()
    run["solve_s"] = time.perf_counter() - t0
    run["us"] = run["op"]._extend(run["x"])
    return run


def setup_p(nc, dtype, device, rounds=P_ROUNDS) -> dict:
    """Path P's adaptive loop on an nc^3 base: `rounds` rounds of build_p
    -> solve_p -> estimate_cells on every finest patch -> mark_boxes (one
    threshold, P_THETA of the front's largest estimate; max_boxes, align)
    -> refine. Returns the final forest (not yet set up), the coarse-only
    solution (round 0's base grid) and each round's iterations, boxes and
    seconds (set-up, solve, marker)."""
    hier = forest_mod.forest_hierarchy(
        CartesianMesh((nc,) * 3, (0.0, 1.0, 0.0, 1.0, 0.0, 1.0)))
    rounds_info, u_coarse = [], None
    for _ in range(rounds):
        run = solve_p(build_p(hier, dtype, device))
        if u_coarse is None:
            u_coarse = run["us"][0]
        t0 = time.perf_counter()
        ests = forest_mod.finest_estimates(hier, run["us"])
        cut = P_THETA * max(float(e.max()) for e in ests)
        boxes = [forest_mod.mark_boxes(e, thresh=cut, max_boxes=P_MAX_BOXES, align=P_ALIGN)
                 for e in ests]
        marker_s = time.perf_counter() - t0
        assert any(boxes), "path P: nothing marked"
        rounds_info.append({"its": run["stats"].niter, "flag": int(run["stats"].flag),
                            "patches": len(run["op"].shapes), "boxes": boxes,
                            "setup_s": run["setup_s"], "solve_s": run["solve_s"],
                            "marker_s": marker_s})
        hier = hier.refine(boxes)
        del run
    return {"hier": hier, "u_coarse": u_coarse, "rounds": rounds_info}


def p_launches(run) -> dict:
    """K2 launches of one path P run from `forest_composite_system` to the
    end of the solve, by operand shape (forest.py, linear/cg.py,
    linear/gmg.py, linear/smoothers.py): each patch's load applies its
    mass stencil once; flexible CG applies the composite operator (one
    launch a patch) once at the start and once an iteration, and the
    preconditioner n + 1 times: one V-cycle a patch, which applies each of
    its smoothing levels 2·3 + 1 times (Chebyshev(3) before and after, the
    correction residual) and its coarsest level once. The Gershgorin bounds
    and the coarse LUs launch nothing. Returns (by shape, by operator:
    "patch k load" (its mass stencil), "patch k" (its composite block) and
    "patch k level l" (its GMG levels))."""
    n = run["stats"].niter
    by_shape, by_op = collections.Counter(), {}
    for k, shape in enumerate(run["op"].shapes):
        by_op[f"patch {k} load"] = 1
        by_op[f"patch {k}"] = n + 1
        by_shape[(27,) + shape] += 1 + (n + 1)
    for k, (gmg, gst) in enumerate(run["state"]["Pl"]["gmgs"]):
        mats = gst["mats"]
        for l, A in enumerate(mats):
            by_op[f"patch {k} level {l}"] = (n + 1) * (2 * 3 + 1 if l < len(mats) - 1 else 1)
            by_shape[(27,) + A.grid_shape] += by_op[f"patch {k} level {l}"]
    return dict(by_shape), by_op


class SolveLog:
    """(iterations, flag) of every CGSolver solve while active, in order:
    the drivers (`adaptive_solve`, `adaptive_solve_scattered`) return no
    stats of their own."""

    def __enter__(self):
        self.stats = []
        self._orig = CGSolver.__dict__["solve"]
        orig, log = self._orig, self.stats

        def solve(solver, state, b, x0=None):
            x, st = orig(solver, state, b, x0)
            log.append((st.niter, int(st.flag)))
            return x, st

        CGSolver.solve = solve
        return self

    def __exit__(self, *exc):
        CGSolver.solve = self._orig


def p2_cases(device) -> dict:
    """Path P2 on `device`: the tests' AMR solves at their sizes, each an
    entry (x as a flat tensor, [(its, flag), ...], boxes or None)."""
    def f2(p):
        out = 0.0
        for b in ((0.25, 0.25), (0.75, 0.75)):
            r2 = (p[:, 0] - b[0]) ** 2 + (p[:, 1] - b[1]) ** 2
            out = out + (4 * 200.0 - 4 * 200.0 ** 2 * r2) * np.exp(-200.0 * r2)
        return out

    def f1(p):
        r2 = (p[:, 0] - 0.7) ** 2 + (p[:, 1] - 0.7) ** 2
        return (4 * 200.0 - 4 * 200.0 ** 2 * r2) * np.exp(-200.0 * r2)

    def kap(p):
        return 1.0 + 10.0 * (p[:, 0] > 0.5)

    def flat(us):
        return torch.cat([u.reshape(-1) for u in us])

    base2 = CartesianMesh((16, 16), (0.0, 1.0, 0.0, 1.0))
    base3 = CartesianMesh((12, 12, 12), (0.0, 1.0, 0.0, 1.0, 0.0, 1.0))
    f64 = torch.float64
    out = {}
    with SolveLog() as log:
        hier, us = adaptive_mod.adaptive_solve(base2, f1, num_levels=3, theta=0.25,
                                               device=device)
        out["adaptive_solve 16^2 3 levels"] = (
            flat(us), list(log.stats), [(lv.lo, lv.hi) for lv in hier.levels])
        log.stats.clear()
        hier = adaptive_mod.adaptive_hierarchy(base2).refine_box((8, 8), (16, 16))
        us, st = adaptive_mod.composite_solve(hier, f1, kappa=kap, device=device)
        out["composite_solve kappa"] = (flat(us), list(log.stats), None)
        log.stats.clear()
        for tag, base, f, theta in (("16^2", base2, f2, 0.25), ("12^3", base3, p_f3, 0.3)):
            hier, us = forest_mod.adaptive_solve_scattered(base, f, num_rounds=1, theta=theta,
                                                           device=device)
            out[f"adaptive_solve_scattered {tag}"] = (
                flat(us), list(log.stats),
                [[(p_.lo, p_.hi) for p_ in lv] for lv in hier.levels])
            log.stats.clear()
        two = forest_mod.forest_hierarchy(base2).refine([[((2, 2), (8, 8)), ((10, 10), (14, 14))]])
        for gmg_base in (False, True):
            us, st = forest_mod.forest_solve(two, f2, rtol=1e-8, gmg_base=gmg_base, dtype=f64,
                                             device=device)
            out[f"forest_solve {'FAC' if gmg_base else 'Jacobi'}"] = (
                flat(us), list(log.stats), None)
            log.stats.clear()
        seam = forest_mod.forest_hierarchy(base2).refine([[((2, 2), (8, 8)), ((8, 2), (12, 6))]])
        us, st = forest_mod.forest_solve(seam, f2, rtol=1e-11, device=device)
        out["partial-overlap seam"] = (flat(us), list(log.stats), None)
    return out


def paths_p(dev, opts, card, elapsed, launches, check_k2, lines) -> dict:
    """Path P on `dev` (main's phase 6P), as paths_mno: P2 card = CPU, then
    P1's adaptive loop and its counted final run, each check raising; the
    kernel checks draw vectors from a generator of their own. Returns what
    phase 8 times and reports: the timed operators (`ops`), each one's
    launches in the counted run (`op_launches`), the launches by operand
    shape and the solve time."""
    f32, f64 = torch.float32, torch.float64
    rng = np.random.default_rng(11)

    def vec(n, dtype):
        return torch.from_numpy(rng.normal(size=n)).to(dev, dtype)

    def by_shape(counts):
        return ", ".join(f"{'x'.join(map(str, k))} {v}" for k, v in sorted(counts.items()))

    # ---- P2: card = CPU at the tests' sizes
    card_runs, cpu_runs = p2_cases(dev), p2_cases("cpu")
    small = []
    for tag, (xc, sc, bc) in card_runs.items():
        xh, sh, bh = cpu_runs[tag]
        assert sc == sh, f"P2 {tag}: (its, flag) card {sc} CPU {sh}"
        assert bc == bh, f"P2 {tag}: boxes card {bc} CPU {bh}"
        e = relerr(xc.cpu(), xh)
        assert e <= P2_TOL, f"P2 {tag}: card against CPU x {e:.2e} > {P2_TOL:g}"
        small.append(f"{tag} its {'+'.join(str(i) for i, _ in sc)} = CPU, flags "
                     f"{sorted({f for _, f in sc})}, x rel diff {e:.1e}")
    del card_runs, cpu_runs

    # ---- P1: the adaptive loop, then the counted run on the final forest
    t0 = time.perf_counter()
    loop = setup_p(NC_P, f64, dev)
    loop_s = time.perf_counter() - t0
    hier = loop["hier"]
    assert hier.num_levels == P_ROUNDS + 1 and len(hier.levels[1]) >= 2, [
        [(q.lo, q.hi) for q in lv] for lv in hier.levels]
    torch.cuda.empty_cache()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    with SyncCount() as syncs:
        run = build_p(hier, f64, dev)
        syncs_p = [syncs.read()]
        solve_p(run)
        syncs_p.append(syncs.read() - syncs_p[0])
    launches["P1"] = read_counts()
    shapes_p = dict(k2.counts.shapes)
    mem_p = (torch.cuda.max_memory_allocated() - mem0) / 2 ** 30
    op, b, x, st = run["op"], run["b"], run["x"], run["stats"]
    want_p, per_op = p_launches(run)
    assert shapes_p == want_p, (shapes_p, want_p)
    assert launches["P1"]["K1"] == launches["P1"]["K3"] == 0, launches["P1"]
    assert st.converged() and P_ITS[0] <= st.niter <= P_ITS[1], (st.niter, st.flag)
    assert [tuple(t.shape) for t in x] == [(int(np.prod(s)),) for s in op.shapes]
    assert all(t.dtype == f64 and bool(torch.isfinite(t).all()) for t in x)
    rel_p = float(pt.norm(pt.sub(b, op.matvec(x))) / pt.norm(b))
    assert rel_p <= 10 * P_RTOL, rel_p
    t_solve = median_ms(lambda: run["solver"].solve(run["state"], b), runs=3, warmup=0,
                        spin=False)
    if opts.profile is not None:
        summary = profile_solve(lambda: run["solver"].solve(run["state"], b), opts.profile,
                                "path_P1")
        print(f"[profile] path P1 solve, {card}: {summary} {elapsed()}", flush=True)
    gmgs = run["state"]["Pl"]["gmgs"]
    patch_desc = "; ".join(
        f"patch {k} (level {lv}, {'x'.join(map(str, np.array(s) - 1))} cells"
        + (f", box {lo}-{hi} of patch {par}" if par >= 0 else "")
        + f"): GMG {len(gst['mats'])} levels, coarsest {gst['mats'][-1].n} dofs "
        f"({'x'.join(map(str, gst['mats'][-1].grid_shape))}), set-up "
        f"{run['patch_gmg_s'][k]:.2f} s"
        for k, ((lv, par, lo, hi), s, (_, gst)) in enumerate(zip(op.meta, op.shapes, gmgs)))
    # the energy error on the uniformly refined frame, against the
    # coarse-only solve's (tests/test_forest.py:156-200)
    field, frame = forest_mod.forest_on_finest(hier, run["us"])
    u_ex = p_u3_grid(frame.ncells[0], f64, dev)
    err_amr = q1_energy(field - u_ex, frame.h)
    del field
    coarse = loop["u_coarse"]
    for _ in range(P_ROUNDS):
        coarse = transfer_mod.prolong_slices(coarse)
    err_coarse = q1_energy(coarse - u_ex, frame.h)
    del coarse, u_ex
    assert err_amr < 0.5 * err_coarse, (err_amr, err_coarse)
    rounds = "; ".join(
        f"round {i} ({r['patches']} patches): {r['its']} its, flag {r['flag']}, set-up "
        f"{r['setup_s']:.2f} s, solve {r['solve_s']:.2f} s, marker {r['marker_s']:.2f} s, boxes "
        f"{r['boxes']}" for i, r in enumerate(loop["rounds"]))
    n_dofs = sum(int(np.prod(s)) for s in op.shapes)
    print(f"[6P path P] block-structured AMR: P2 card = CPU: " + "; ".join(small)
          + f" | P1 {NC_P}^3 base, {P_ROUNDS} rounds (theta {P_THETA}, max_boxes "
          f"{P_MAX_BOXES}, align {P_ALIGN}; flexible CG rtol {P_RTOL:g} + ForestPreconditioner("
          f"num_levels={P_LEVELS}), f64), loop {loop_s:.1f} s: {rounds} | counted final run, "
          f"{hier.num_levels} levels, patches per level {[len(lv) for lv in hier.levels]}, "
          f"{n_dofs} grid dofs: {st.niter} its (band {P_ITS}), flag {st.flag}, residuals "
          + " ".join(f"{v:.3e}" for v in st.residuals.cpu().numpy()[: st.niter + 1])
          + f"; true relative residual {rel_p:.3e} (<= {10 * P_RTOL:g}); energy error on the "
          f"{frame.ncells[0]}^3 frame {err_amr:.4e} against the coarse-only {err_coarse:.4e} "
          f"(ratio {err_amr / err_coarse:.4f} < 0.5); {patch_desc}; set-up "
          f"{run['setup_s']:.2f} s by step: " + ", ".join(f"{k_} {v:.2f}" for k_, v in
                                                          run["secs"].items())
          + f"; solve {run['solve_s']:.3f} s (median of 3 more {t_solve / 1e3:.3f} s); host "
          f"syncs measured: set-up {syncs_p[0]}, solve {syncs_p[1]}; peak device memory "
          f"{mem_p:.2f} GiB over what earlier paths hold; K2 launches by shape equal to "
          f"p_launches: {by_shape(shapes_p)} (every one on the box kernel); K1 0, K3 0, plain 0 "
          f"{elapsed()}", flush=True)
    # the three operators of phases 6P and 8: the base composite operator,
    # the largest refined patch's, and the base patch's level-0 GMG operator
    big = max(range(1, len(op.shapes)), key=lambda k: int(np.prod(op.shapes[k])))
    named = {"P K2 base composite": (op.ops[0], per_op["patch 0"]),
             f"P K2 patch {big} composite": (op.ops[big], per_op[f"patch {big}"]),
             "P K2 base GMG level 0": (gmgs[0][1]["mats"][0], per_op["patch 0 level 0"])}
    for key, (A64, _) in named.items():
        for dt, tol in ((f64, F64_TOL), (f32, F32_TOL)):
            A = A64.astype(dt)
            check_k2(f"[{key[5:]} {'x'.join(map(str, A.grid_shape))}]{str(dt)[6:]}", A,
                     vec(A.n, dt), tol, True)
    print(f"[6P kernels] {len(lines)} cases on the path's operators within f32 {F32_TOL:.0e} / "
          f"f64 {F64_TOL:.0e}: " + ", ".join(lines) + f" {elapsed()}", flush=True)
    lines.clear()
    ops = {key: A for key, (A, _) in named.items()}
    op_launches = {key: n_ for key, (_, n_) in named.items()}
    del run, loop, x, b, gmgs
    torch.cuda.empty_cache()
    return {"ops": ops, "op_launches": op_launches, "shapes": shapes_p, "t_solve": t_solve}


def q_serial(dev) -> tuple:
    """Path Q's serial twin on `dev`: GMG-CG from the same Dirichlet
    `laplacian` levels, masked transfers and Chebyshev smoother."""
    f64 = torch.float64
    hier = cartesian_hierarchy((NC_Q,) * 3, LEVELS_Q)
    prob = poisson_problem((NC_Q,) * 3, dtype=f64, device=dev)

    def assemble(m):
        return eliminate_dirichlet(laplacian(m, f64, dev), m.boundary_vertex_mask())

    gmg = gmg_from_hierarchy(hier, assemble, smoother=ChebyshevSmoother(**Q_SMOOTHER),
                             dtype=f64, device=dev)
    solver = CGSolver(Pl=gmg, rtol=Q_RTOL, maxiter=Q_MAXITER)
    x, st = solver.solve(solver.setup(prob.A), prob.b)
    return x.cpu().numpy(), st


def q_comms(row) -> str:
    """What a rank sent, per operator apply plus V-cycle (a solve makes
    n + 1 of each) and per CG iteration (all-reduces; 2 more before the
    loop)."""
    n, c = row["iters"], row["comm"]
    return (f"{c['p2p_batches'] / (n + 1):.0f} p2p batches ({c['p2p_messages'] / (n + 1):.0f} "
            f"messages, {c['p2p_bytes'] / (n + 1):.0f} B) and {c['all_gathers'] / (n + 1):.0f} "
            f"all-gathers ({c['gather_bytes'] / (n + 1):.0f} B) per apply + V-cycle, "
            f"{(c['all_reduces'] - 2) / n if c['all_reduces'] else 0:.0f} all-reduces per "
            f"iteration")


def paths_q(dev, card, elapsed, launches, check_k2, lines) -> dict:
    """Path Q (main's phase 6Q): the distributed Poisson GMG-CG through
    `parallel.launch.run_ranks`, Q1 on one NCCL rank and Q2 on two gloo
    ranks sharing the card, each rank's K2 launches counted in its solve
    (every count set to 0 just before it, read just after) and held by
    operand shape against `k2_launches_formula`; then K2 on Q2's level-0
    extended blocks against its plain version. Returns the launches by
    shape and the level-0 operators for phase 8."""
    from gridapsolvers_tpu_torch.parallel.dist import pad_stencil
    from gridapsolvers_tpu_torch.parallel.launch import run_ranks
    from gridapsolvers_tpu_torch.parallel.weak_scaling import k2_launches_formula, poisson_case

    f64 = torch.float64
    deg = Q_SMOOTHER["degree"]
    kw = {"rtol": Q_RTOL, "maxiter": Q_MAXITER, "smoother": Q_SMOOTHER, "return_x": True}
    t0 = time.perf_counter()
    x_serial, st_serial = q_serial(dev)
    serial_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    rows = {}
    on_card = torch.device(dev).type == "cuda"
    for name, layout in (("Q1", (1,)), ("Q2", (2,))):
        t0 = time.perf_counter()
        rows[name] = run_ranks(poisson_case, layout[0], ((NC_Q,) * 3, LEVELS_Q, layout), kw,
                               device=torch.device(dev).type, timeout=600)
        rows[name + " s"] = time.perf_counter() - t0
    q1, q2 = rows["Q1"][0], rows["Q2"]
    assert q1["transport"] == ("nccl" if on_card else "gloo"), q1["transport"]
    assert all(r["transport"] == ("gloo-host-staged" if on_card else "gloo") for r in q2), [
        r["transport"] for r in q2]
    n = q1["iters"]
    assert st_serial.converged() and Q_ITS[0] <= n <= Q_ITS[1] and q1["flag"] == st_serial.flag
    assert n == st_serial.niter, (n, st_serial.niter)
    e1 = float(np.abs(q1["x"] - x_serial).max() / np.abs(x_serial).max())
    assert e1 <= Q_X_TOL, f"Q1 x against the serial solve {e1:.2e}"
    assert all((r["iters"], r["flag"]) == (n, q1["flag"]) for r in q2), [r["iters"] for r in q2]
    e2 = float(np.abs(q2[0]["x"] - q1["x"]).max() / np.abs(q1["x"]).max())
    assert e2 <= Q_X_TOL, f"Q2 x against Q1 {e2:.2e}"
    assert np.isfinite(q2[0]["x"]).all() and q2[0]["x"].shape == ((NC_Q + 1) ** 3,)
    shapes = {}
    for tag, r in [("Q1", q1)] + [(f"Q2 rank {i}", r) for i, r in enumerate(q2)]:
        want = k2_launches_formula(r["iters"], r["level_shapes"], deg)
        if on_card:
            assert r["k2_shapes"] == want, (tag, r["k2_shapes"], want)
            assert r["k2_plain"] == 0 and r["k2_launches"] == sum(want.values()), tag
        else:  # a rehearsal on the CPU: every apply on the plain version
            assert r["k2_launches"] == 0 and r["k2_plain"] == sum(want.values()), tag
            r["k2_shapes"] = want
        shapes[tag] = r["k2_shapes"]
        launches[tag] = {"K1": 0, "K2": r["k2_launches"], "K3": 0}

    def by_shape(counts):
        return ", ".join(f"{'x'.join(map(str, k))} {v}" for k, v in sorted(counts.items()))

    h = q1["history"]
    print(f"[6Q path Q] distributed Poisson GMG-CG, {NC_Q}^3 cells f64, {LEVELS_Q} levels, "
          f"Chebyshev({deg}) on Gershgorin bounds, CG rtol {Q_RTOL:g}: serial twin {st_serial.niter}"
          f" its ({serial_s:.1f} s with set-up) | Q1 1 rank ({q1['transport']}): {n} its (band "
          f"{Q_ITS}), flag {q1['flag']}, residuals " + " ".join(f"{v:.3e}" for v in h)
          + f", x against the serial twin {e1:.1e} of max|x|; set-up {q1['setup_s']:.2f} s, "
          f"solve {q1['time_s']:.3f} s, launch {rows['Q1 s']:.1f} s; K2 by shape = formula: "
          f"{by_shape(shapes['Q1'])} | Q2 2 ranks ({q2[0]['transport']}, padded "
          f"{q2[0]['padded']}, blocks {q2[0]['block']}): {[r['iters'] for r in q2]} its, x "
          f"against Q1 {e2:.1e} of max|x|; set-up {[round(r['setup_s'], 2) for r in q2]} s, "
          f"solve {[round(r['time_s'], 3) for r in q2]} s, launch {rows['Q2 s']:.1f} s; "
          + "; ".join(f"rank {i}: K2 by shape = formula: {by_shape(shapes[f'Q2 rank {i}'])}; "
                      f"{q_comms(r)}" for i, r in enumerate(q2))
          + f" {elapsed()}", flush=True)

    # K2 on Q2's level-0 extended blocks (the halo matvec's and the
    # ghost-extended smoother's) against its plain version: rank 0's rows
    # of the padded level-0 operator below a zero lower halo
    m0 = cartesian_hierarchy((NC_Q,) * 3, LEVELS_Q)[0]
    A = eliminate_dirichlet(laplacian(m0, f64, dev), m0.boundary_vertex_mask())
    A = pad_stencil(A, (2,), target_shape=q2[0]["padded"])
    blk = q2[0]["block"][0]
    grid, ca = q2[0]["level_shapes"][0]
    ops, op_launches = {}, {}
    for tag, g in (("halo matvec", grid), ("smoother", ca)):
        lo = (g[0] - blk) // 2
        bands = A.bands.new_zeros((27,) + tuple(g))
        bands[:, lo:] = A.bands[:, : g[0] - lo]
        key = f"Q K2 level 0 {tag}"
        ops[key] = StencilMatrix(bands, A.offsets, tuple(g))
        op_launches[key] = shapes["Q2 rank 0"][(27,) + tuple(g)]
        xq = torch.from_numpy(np.random.default_rng(13).normal(size=ops[key].n)).to(dev, f64)
        check_k2(f"[Q2 level 0 {tag} {'x'.join(map(str, g))}]f64", ops[key], xq, F64_TOL, True)
    print(f"[6Q kernels] {len(lines)} cases within f64 {F64_TOL:.0e}: " + ", ".join(lines)
          + f" {elapsed()}", flush=True)
    lines.clear()
    del A
    torch.cuda.empty_cache()
    return {"shapes": shapes, "ops": ops, "op_launches": op_launches,
            "t_solve": {"Q1": q1["time_s"], "Q2": max(r["time_s"] for r in q2)}}


def r_comms(row) -> str:
    """What a rank sent per FGMRES iteration (set-up excluded), beside the
    JAX design's loop-body collectives."""
    n, c = max(row["iters"], 1), row["comm"]
    return (f"{c['p2p_batches'] / n:.1f} p2p batches ({c['p2p_messages'] / n:.1f} messages, "
            f"{c['p2p_bytes'] / n:.0f} B), {c['all_reduces'] / n:.1f} all-reduces, "
            f"{c['all_gathers'] / n:.1f} all-gathers ({c['gather_bytes'] / n:.0f} B) per FGMRES "
            f"iteration (JAX loop body: {R_JAX_LOOP['collective-permute']} permutes, "
            f"{R_JAX_LOOP['all-reduce']} all-reduces)")


def paths_r(dev, card, elapsed, launches, check_ell, lines) -> dict:
    """Path R (main's phase 6R): the distributed Stokes flagship through
    `parallel.launch.run_ranks` and `parallel.weak_scaling.stokes_case`:
    R1 on one NCCL rank (mesh (1, 1)), then the serial twin in this
    process, then R2 on two gloo ranks sharing the card through the 1-D
    spelling (mesh (2,)). Each rank's K3 launches in its counted solve (every count
    set to 0 just before it, read just after) are held by operand shape
    against `k3_launches_formula`; then K3 on R2's rank-0 extended-window
    K, B and Bt blocks against its plain version. Returns the launches by
    shape and those blocks for phase 8."""
    from gridapsolvers_tpu_torch.parallel.launch import run_ranks
    from gridapsolvers_tpu_torch.parallel.weak_scaling import (
        STOKES_RTOL,
        k3_launches_formula,
        stokes_case,
        stokes_serial_twin,
    )

    on_card = torch.device(dev).type == "cuda"
    kind = torch.device(dev).type
    kw = {"maxiter": R_MAXITER}
    ncells = (NC_R, NC_R)
    # one at a time, so no solve shares the card with another
    t0 = time.perf_counter()
    r1 = run_ranks(stokes_case, 1, (ncells, LEVELS_R, (1, 1)), kw, device=kind, timeout=900)[0]
    r1_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    twin = stokes_serial_twin(ncells, LEVELS_R, maxiter=R_MAXITER, device=dev)
    twin_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    r2 = run_ranks(stokes_case, 2, (ncells, LEVELS_R, (2,)),
                   {**kw, "one_axis": True, "return_blocks": True}, device=kind, timeout=900)
    r2_s = time.perf_counter() - t0
    assert r1["transport"] == ("nccl" if on_card else "gloo"), r1["transport"]
    assert all(r["transport"] == ("gloo-host-staged" if on_card else "gloo") for r in r2), [
        r["transport"] for r in r2]
    n1 = r1["iters"]
    assert twin["flag"] == r1["flag"] == 2, (twin["flag"], r1["flag"])
    assert abs(n1 - R_CPU_ITS) <= 1 and abs(twin["iters"] - R_CPU_TWIN_ITS) <= 1, (
        n1, R_CPU_ITS, twin["iters"], R_CPU_TWIN_ITS)
    du1 = max(float(np.abs(a - b).max()) for a, b in zip(r1["u"], twin["u"]))
    dp1 = float(np.abs(r1["p"] - twin["p"]).max())
    assert du1 <= R_U_ATOL and dp1 <= R_P_ATOL, f"R1 against the twin: u {du1:.2e}, p {dp1:.2e}"
    assert r1["velocity_error"] <= R_VEL_ERR_BOUND, (r1["velocity_error"], R_VEL_ERR_BOUND)
    assert all(abs(r["iters"] - n1) <= 1 and r["flag"] == r1["flag"] for r in r2), [
        r["iters"] for r in r2]
    du2 = max(float(np.abs(a - b).max()) for a, b in zip(r2[0]["u"], r1["u"]))
    dp2 = float(np.abs(r2[0]["p"] - r1["p"]).max())
    assert du2 <= R_U_ATOL and dp2 <= R_P_ATOL, f"R2 against R1: u {du2:.2e}, p {dp2:.2e}"
    for u in r2[0]["u"] + (r2[0]["p"],):
        assert np.isfinite(u).all()
    assert r2[0]["u"][0].shape == ((2 * NC_R + 1) ** 2,) and r2[0]["p"].shape == ((NC_R + 1) ** 2,)
    shapes = {}
    for tag, r in [("R1", r1)] + [(f"R2 rank {i}", r) for i, r in enumerate(r2)]:
        want = k3_launches_formula(r["iters"], r["cg_its"], r["operand_shapes"], r["m"])
        if on_card:
            assert r["k3_shapes"] == want, (tag, r["k3_shapes"], want)
            assert r["k3_plain"] == 0 and r["k3_launches"] == sum(want.values()), tag
        else:  # a rehearsal on the CPU: every apply on the plain version
            assert r["k3_launches"] == 0 and r["k3_plain"] == sum(want.values()), tag
            r["k3_shapes"] = want
        shapes[tag] = r["k3_shapes"]
        launches[tag] = {"K1": 0, "K2": 0, "K3": r["k3_launches"]}

    def by_shape(counts):
        return ", ".join(f"{'x'.join(map(str, k))} {v}" for k, v in sorted(counts.items()))

    h = r1["history"]
    print(f"[6R path R] distributed Stokes flagship, {NC_R}^2 cells f64 ({r1['dofs']} dofs), "
          f"{LEVELS_R} levels (sharded {r1['sharded_levels']}), FGMRES(30) rtol {STOKES_RTOL:g} + "
          f"upper block-triangular (velocity GMG, Chebyshev(3) on Lanczos bounds; pressure-mass "
          f"Jacobi-CG): serial twin {twin['iters']} its (CPU {R_CPU_TWIN_ITS}), |u-u_h| "
          f"{twin['velocity_error']:.4e} ({twin_s:.1f} s with set-up) | R1 1 rank "
          f"({r1['transport']}): {n1} its (CPU {R_CPU_ITS}), flag "
          f"{r1['flag']}, rel res {h[-1] / h[0]:.3e}, against the twin u {du1:.1e} p {dp1:.1e}, "
          f"|u-u_h| {r1['velocity_error']:.4e} (bound {R_VEL_ERR_BOUND:.0e}), |p-p_h| "
          f"{r1['pressure_error']:.4e}; pressure CG {sum(r1['cg_its'])} its; set-up "
          f"{r1['setup_s']:.2f} s, solve {r1['time_s']:.3f} s, launch {r1_s:.1f} s; K3 by shape "
          f"= formula: {by_shape(shapes['R1'])} | R2 2 ranks ({r2[0]['transport']}, 1-D "
          f"spelling, padded {r2[0]['padded']}): {[r['iters'] for r in r2]} its, against R1 u "
          f"{du2:.1e} p {dp2:.1e}; set-up {[round(r['setup_s'], 2) for r in r2]} s, solve "
          f"{[round(r['time_s'], 3) for r in r2]} s, launch {r2_s:.1f} s; "
          + "; ".join(f"rank {i}: K3 by shape = formula: {by_shape(shapes[f'R2 rank {i}'])}; "
                      f"{r_comms(r)}" for i, r in enumerate(r2))
          + f"; R1 {r_comms(r1)} {elapsed()}", flush=True)

    # K3 on R2's rank-0 extended-window blocks against its plain version
    ops, op_launches = {}, {}
    rng = np.random.default_rng(17)
    for name, (values, cols, ncols, row_len, group) in r2[0]["blocks"].items():
        A = ELLMatrix(values.to(dev), cols.to(dev), int(ncols), row_len.to(dev), group)
        key = f"R K3 level 0 {name} {A.nrows}x{A.ncols}"
        ops[key] = A
        op_launches[key] = shapes["R2 rank 0"][tuple(A.shape)]
        xr = torch.from_numpy(rng.normal(size=A.ncols)).to(dev, torch.float64)
        check_ell(f"[R2 rank 0 {name} {A.nrows}x{A.ncols} K={A.row_width}]f64", A, xr, F64_TOL)
    print(f"[6R kernels] {len(lines)} cases within f64 {F64_TOL:.0e}: " + ", ".join(lines)
          + f" {elapsed()}", flush=True)
    lines.clear()
    t_solve = {"R1": r1["time_s"], "R2": max(r["time_s"] for r in r2)}
    del r2
    torch.cuda.empty_cache()
    return {"shapes": shapes, "ops": ops, "op_launches": op_launches, "t_solve": t_solve}


def ell_csr(A: ELLMatrix, index=torch.int32) -> torch.Tensor:
    """A's real entries (slots within each row's length) as a torch CSR
    tensor on its device: the cuSPARSE yardstick, never called by the
    port."""
    slot = torch.arange(A.row_width, device=A.device)
    keep = slot[None, :] < A.row_len[:, None]
    crow = torch.zeros(A.nrows + 1, dtype=torch.int64, device=A.device)
    crow[1:] = torch.cumsum(A.row_len.to(torch.int64), 0)
    return torch.sparse_csr_tensor(crow.to(index), A.cols[keep].to(index), A.values[keep],
                                   size=A.shape, check_invariants=False)


def median_ms(fn, runs=TIMING_RUNS, warmup=3, before=None, spin=True) -> float:
    """Median time of `fn` over `runs` calls, each between its own pair of
    CUDA events; `before` runs outside the timed span. With `spin`, each
    call is queued behind a ~1 ms device-side spin, so the span holds the
    device work and not the host's launch latency; without it (solves,
    which wait on the host every iteration) the span is wall time."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        if before is not None:
            before()
        if spin:
            torch.cuda._sleep(2_000_000)
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def build_all() -> str:
    """nvcc for every kernel source at once; the build log's register line."""
    def one(name):
        t0 = time.perf_counter()
        path = build.build(name)
        return time.perf_counter() - t0, path

    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        done = dict(zip(KERNELS, pool.map(one, KERNELS)))
    parts = []
    for name, (secs, path) in done.items():
        build.load(name)
        regs = [ln.strip() for ln in path.with_suffix(".log").read_text().splitlines()
                if "registers" in ln]
        parts.append(f"{name} {secs:.1f} s ({'; '.join(regs)})")
    return " | ".join(parts)


def csr_of(S, dev, dtype, index=torch.int32) -> torch.Tensor:
    """A scipy matrix as a torch CSR tensor on the card: the cuSPARSE
    yardstick, never called by the port. int32 indices (the width K3
    reads, and the faster call) are the library time; int64 ones, the
    yardstick of earlier runs, are timed beside them."""
    values = torch.from_numpy(S.data).to(dev, dtype)
    return torch.sparse_csr_tensor(
        torch.from_numpy(S.indptr).to(dev, index),
        torch.from_numpy(S.indices).to(dev, index), values, size=S.shape,
        check_invariants=False,
    )


def ell_fill(A: ELLMatrix) -> tuple:
    """(real entries, their share of the stored slots, their share of the
    slots that K3's warps step through at A's lanes a row: rows that share
    a warp run as long as its longest row)."""
    rl = A.row_len.cpu().numpy().astype(np.int64)
    g = A.group
    per_warp = np.concatenate([rl, np.zeros(-len(rl) % (32 // g), np.int64)]).reshape(-1, 32 // g)
    stepped = (-(-per_warp.max(axis=1) // g) * g * (32 // g)).sum()
    return int(rl.sum()), rl.sum() / A.nnz, rl.sum() / stepped


def ell_sector_bytes(A: ELLMatrix) -> int:
    """Bytes of the 32-byte memory sectors that hold A's real entries in
    its (nrows, K) values and cols: what reading to row lengths fetches,
    padding that shares a sector with a real entry included."""
    rl = A.row_len.cpu().numpy().astype(np.int64)
    total = 0
    for width in (A.values.element_size(), 4):
        start = np.arange(A.nrows, dtype=np.int64)[rl > 0] * A.row_width * width
        first, last = start // 32, (start + rl[rl > 0] * width - 1) // 32
        seen = np.concatenate([[-1], np.maximum.accumulate(last)[:-1]])
        total += 32 * int(np.maximum(last - np.maximum(first, seen + 1) + 1, 0).sum())
    return total


def ell_bound_ms(A: ELLMatrix, x: torch.Tensor) -> float:
    """Bytes K3 must move (value and int32 column of every real entry, the
    int32 row lengths, x and y once each) over the card's memory rate."""
    real = ell_fill(A)[0]
    nbytes = (real * (A.values.element_size() + 4) + 4 * A.nrows
              + (A.ncols + A.nrows) * x.element_size())
    return nbytes / HBM_BYTES_PER_S * 1e3


def solve_amg(nc, dev, maxiter=60):
    """Path C through the public API: f32 3D Q1 Poisson, CG + AMG."""
    prob = poisson_problem((nc,) * 3, dtype=torch.float32, device=dev)
    cg = CGSolver(Pl=AMGSolver(coarse_size=400), rtol=1e-6, maxiter=maxiter)
    t0 = time.perf_counter()
    state = cg.setup(prob.A)
    setup_s = time.perf_counter() - t0
    x, st = cg.solve(state, prob.b)
    l2 = float(prob.l2_error(x))
    return prob, cg, state, x, st, l2, setup_s


def profile_solve(solve, out_dir: Path, name: str) -> str:
    """torch.profiler over one solve: kernels launched, device busy time and
    the device's idle share of the traced wall time; the kernel table goes
    to out_dir/profile_<name>.txt."""
    from torch.profiler import ProfilerActivity, profile

    out_dir.mkdir(parents=True, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    (out_dir / f"profile_{name}.txt").write_text(
        "\n".join(f"{us / 1e3:10.3f} ms {n:6d}  {name}" for name, (n, us) in rows) + "\n")
    top = ", ".join(f"{name[:40]} {us / 1e3:.2f} ms ({n})" for name, (n, us) in rows[:6])
    return (f"kernels launched {len(kernels)}, device busy {busy_us / 1e3:.2f} ms of "
            f"{wall_us / 1e3:.2f} ms traced wall, idle share {1 - busy_us / wall_us:.1%}; {top}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", type=Path, default=None,
                        help="also trace one path C solve; kernel table written to this directory")
    opts = parser.parse_args()
    t_start = time.perf_counter()

    def elapsed():
        return f"[{time.perf_counter() - t_start:.0f} s]"

    # ---- 1 device -------------------------------------------------------
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"[1 device] {kind} x{count} | {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | tf32 matmul/cudnn off", flush=True)

    dev = torch.device(DEVICE)
    N1 = NC + 1

    # ---- 2 build --------------------------------------------------------
    print(f"[2 build] {build_all()} {elapsed()}", flush=True)

    # ---- 3 kernels against their plain versions -------------------------
    rng = np.random.default_rng(0)
    level_shapes = [(N1,) * 3, (65,) * 3, (33,) * 3, (17,) * 3, (129, 129), (17, 9, 5)]

    def mesh_of(shape, periodic=None):
        ncells = tuple(m if periodic and periodic[k] else m - 1 for k, m in enumerate(shape))
        return CartesianMesh(ncells, tuple(x for _ in shape for x in (0.0, 1.0)), periodic)

    def vec(n, dtype):
        return torch.from_numpy(rng.normal(size=n)).to(dev, dtype)

    worst = {"K1": 0.0, "K2": 0.0, "K3": 0.0, "K1 bf16": 0.0}
    lines = []

    def check(tag, key, y, y_ref, tol):
        torch.cuda.synchronize()
        assert y.shape == y_ref.shape and y.dtype == y_ref.dtype, (tag, y.shape, y.dtype)
        assert bool(torch.isfinite(y).all()), tag
        e = relerr(y, y_ref)
        worst[key] = max(worst[key], abserr(y, y_ref))
        assert e <= tol, f"{tag}: max relative error {e:.3e} > {tol:.0e}"
        lines.append(f"{tag} {e:.2e}")
        return e

    def check_k3(tag, x, tol, values, cols, ncols, row_len=None, group=None):
        """K3 on bare arrays against its plain version (slots past a row's
        length may hold anything here; an ELLMatrix keeps them 0)."""
        return check(tag, "K3", k3.ell_spmv_cuda(values, cols, x, ncols, group, row_len),
                     k3.ell_spmv_plain(values, cols, x, row_len), tol)

    def check_ell(tag, A, x, tol):
        return check_k3(tag, x, tol, A.values, A.cols, A.ncols, A.row_len, A.group)

    def check_k1(tag, weights, free, shape, x, tol, march):
        """K1 on (weights, free) against its plain version; `march`:
        whether the marching kernel must have taken it."""
        args = (weights, free, tuple(itertools.product((-1, 0, 1), repeat=len(shape))), shape, x)
        before = k1.counts.march
        y = k1.const_stencil_cuda(*args)
        assert k1.counts.march - before == int(march), f"{tag}: marching kernel taken {not march}"
        check(f"K1{tag}", "K1", y, k1.const_stencil_plain(*args), tol)

    def check_k1_bf16(tag, weights, free, shape, x, march):
        """bf16 K1 on both kernels against its plain version, within one
        bf16 ulp of max|y|; `march`: whether the wrapper's choice is the
        marching kernel."""
        args = tuple(t.to(torch.bfloat16) for t in (weights, free)) + (
            tuple(itertools.product((-1, 0, 1), repeat=len(shape))), shape,
            x.to(torch.bfloat16))
        y_ref = k1.const_stencil_plain(*args)
        ulp = bf16_ulp(float(y_ref.double().abs().max()))
        for general in (False, True):
            before = (k1.counts.march, k1.counts.bf16)
            y = k1.const_stencil_cuda(*args, general=general)
            assert (k1.counts.march - before[0], k1.counts.bf16 - before[1]) == (
                int(march and not general), 1), f"{tag}: kernel taken"
            torch.cuda.synchronize()
            assert y.dtype == y_ref.dtype == torch.bfloat16 and y.shape == y_ref.shape, tag
            assert bool(torch.isfinite(y).all()), tag
            e = abserr(y, y_ref)
            worst["K1 bf16"] = max(worst["K1 bf16"], e)
            which = "general" if general or not march else "march"
            assert e <= ulp, f"K1{tag} bf16 {which}: max error {e:.3e} > one bf16 ulp {ulp:.3e}"
            lines.append(f"K1{tag} bf16 {which} {e / ulp:.2f} ulp")

    def check_k2(tag, A, x, tol, box):
        """K2 on A against its plain version; `box`: whether the box kernel
        must have taken it."""
        args = (A.bands, A.offsets, A.grid_shape, A._periodic(), x)
        before = k2.counts.box
        y = k2.banded_stencil_cuda(*args)
        assert k2.counts.box - before == int(box), f"{tag}: box kernel taken {not box}"
        return check(f"K2{tag}", "K2", y, k2.banded_stencil_plain(*args), tol)

    for shape in level_shapes:
        for dt, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
            A = laplacian_const(mesh_of(shape), dt, dev)
            check_k1(f"{shape}{str(dt)[6:]}", A.weights, A.free, shape, vec(A.n, dt), tol,
                     len(shape) == 3)
        for dt, band_dt, tol in ((torch.float32, torch.float32, F32_TOL),
                                 (torch.float64, torch.float64, F64_TOL),
                                 (torch.float32, torch.bfloat16, F32_TOL)):
            mesh = mesh_of(shape)
            A = eliminate_dirichlet(laplacian(mesh, dt, dev), mesh.boundary_vertex_mask())
            A = A.astype(band_dt)
            check_k2(f"{shape}{str(band_dt)[6:]}", A, vec(A.n, dt), tol, len(shape) == 3)
    # the marching K1 at edge shapes (tiles that no grid fills, k extents of
    # no multiple of 32, 2 points an axis) and at every level: with the
    # Laplacian, with 27 random asymmetric weights (a sign error or a sum
    # added to the wrong plane shows only there), and with those under a
    # random mask with zeros inside the grid; against the general kernel at
    # 129^3
    for shape in ((2, 2, 2), (33, 17, 5), (9, 7, 67), (5, 3, 131), (17,) * 3, (33,) * 3,
                  (65,) * 3, (N1,) * 3):
        for dt, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
            A = laplacian_const(mesh_of(shape), dt, dev)
            x = vec(A.n, dt)
            w_rand = vec(27, dt)
            f_rand = torch.from_numpy((rng.random(shape) < 0.7).astype(np.float64)).to(dev, dt)
            tag = f"[march {shape}]{str(dt)[6:]}"
            check_k1(f"{tag} lap", A.weights, A.free, shape, x, tol, True)
            check_k1(f"{tag} rand", w_rand, A.free, shape, x, tol, True)
            check_k1(f"{tag} rand mask", w_rand, f_rand, shape, x, tol, True)
            if shape[0] == N1:
                args = (w_rand, f_rand, A.offsets, shape, x)
                check(f"K1march=general{shape}{str(dt)[6:]}", "K1", k1.const_stencil_cuda(*args),
                      k1.const_stencil_cuda(*args, general=True), tol)
            if dt == torch.float32:  # bf16: the same cases on both kernels
                tag = f"[march {shape}]"
                check_k1_bf16(f"{tag} lap", A.weights, A.free, shape, x, True)
                check_k1_bf16(f"{tag} rand", w_rand, A.free, shape, x, True)
                check_k1_bf16(f"{tag} rand mask", w_rand, f_rand, shape, x, True)
    A = laplacian_const(mesh_of((N1, N1)), torch.float32, dev)
    check_k1_bf16(f"[{N1}x{N1}] lap", A.weights, A.free, (N1, N1), vec(A.n, torch.float32),
                  False)
    # the box kernel at edge shapes (tiles of 8 x 64 / 8 x 32 points that
    # fill no whole tile, k extents of no multiple of 32), with random bands
    # and a permuted offset table, against the plain and the general kernel
    for shape in ((2, 2, 2), (33, 17, 5), (9, 7, 67), (5, 3, 131), (N1,) * 3):
        mesh = mesh_of(shape)
        A64 = eliminate_dirichlet(laplacian(mesh, torch.float64, dev), mesh.boundary_vertex_mask())
        order = rng.permutation(27)
        bands = torch.from_numpy(rng.normal(size=A64.bands.shape)).to(dev)
        Ar = dataclasses.replace(A64, bands=bands, offsets=tuple(A64.offsets[s] for s in order))
        for dt, band_dt, tol in ((torch.float32, torch.float32, F32_TOL),
                                 (torch.float64, torch.float64, F64_TOL),
                                 (torch.float32, torch.bfloat16, F32_TOL)):
            x = vec(A64.n, dt)
            tag = f"[box {shape}]{str(band_dt)[6:]}"
            check_k2(tag, A64.astype(band_dt), x, tol, True)
            check_k2(f"{tag} rand", Ar.astype(band_dt), x, tol, True)
            if shape[0] == N1:
                A = A64.astype(band_dt)
                check(f"K2box=general{shape}{str(band_dt)[6:]}", "K2", A.matvec(x),
                      k2.banded_stencil_cuda(A.bands, A.offsets, A.grid_shape, A._periodic(), x,
                                             general=True), tol)
    S = None
    for m in (33, 33, 33):  # kron of pentadiagonals: a 125-offset envelope
        T = sp.diags([rng.normal(size=m - abs(k)) for k in range(-2, 3)], range(-2, 3),
                     format="csr")
        S = T if S is None else sp.kron(S, T, format="csr")
    S.eliminate_zeros()
    extra = {
        "periodic": laplacian(mesh_of((32, 24, 16), (True, False, True)), torch.float64, dev),
        "5^3": stencil_from_scipy(S, (33, 33, 33), dtype=torch.float64, device=dev),
    }
    assert len(extra["5^3"].offsets) == 125
    for tag, A64 in extra.items():
        for dt, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
            A = A64.astype(dt)
            check_k2(f"[{tag}]{str(dt)[6:]}", A, vec(A.n, dt), tol, False)
    # K1 and K2 on the same operator: the Dirichlet-eliminated Laplacian
    for dt, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
        mesh = mesh_of((N1,) * 3)
        Ac = laplacian_const(mesh, dt, dev)
        Ab = eliminate_dirichlet(laplacian(mesh, dt, dev), mesh.boundary_vertex_mask())
        x = vec(Ac.n, dt)
        check(f"K1=K2({N1}^3){str(dt)[6:]}", "K1", Ac.matvec(x), Ab.matvec(x), tol)
    # K3: the Laplacian as an ELL (zero face couplings dropped), and K3
    # against K2 on it; then random patterns, square and rectangular, with
    # row counts that fill no whole block and row widths of every group
    # size, with every slot counted and with random row lengths (zero-length
    # rows, full rows, garbage past each row's length)
    Aell = ell_from_scipy(to_scipy(Ab), device=dev)  # Ab is the f64 one
    assert Aell.row_width == 21 and Aell.row_len is not None, Aell.row_width
    for dt, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
        A = Aell.astype(dt)
        x = vec(A.ncols, dt)
        check_ell(f"K3[lap {N1}^3 K={A.row_width}]{str(dt)[6:]}", A, x, tol)
        check(f"K3=K2({N1}^3){str(dt)[6:]}", "K3", A.matvec(x), Ab.astype(dt).matvec(x), tol)
    for nrows, ncols, K in ((300_001, 1_000_003, 20), (100, 100, 7), (1001, 1001, 27),
                            (12_345, 777, 13), (777, 12_345, 1), (50_001, 50_001, 3),
                            (4099, 4099, 64)):
        cols = torch.from_numpy(rng.integers(0, ncols, size=(nrows, K), dtype=np.int32)).to(dev)
        vals = torch.from_numpy(rng.normal(size=(nrows, K))).to(dev)
        row_len = rng.integers(0, K + 1, size=nrows).astype(np.int32)
        row_len[::7] = 0
        row_len[1::5] = K
        group = k3.group_size(K, row_len.mean())
        row_len = torch.from_numpy(row_len).to(dev)
        for v_dt, x_dt, tol in ((torch.float32, torch.float32, F32_TOL),
                                (torch.bfloat16, torch.float32, F32_TOL),
                                (torch.float64, torch.float64, F64_TOL)):
            x = vec(ncols, x_dt)
            tag = f"K3[rand {nrows}x{ncols} K={K}"
            check_k3(f"{tag}]{str(v_dt)[6:]}", x, tol, vals.to(v_dt), cols, ncols)
            check_k3(f"{tag} row_len G={group}]{str(v_dt)[6:]}", x, tol, vals.to(v_dt), cols,
                     ncols, row_len, group)
    # path G's operators (2D, K2's general kernel): the Q2 velocity stiffness
    # (25 bands) and the Q1 pressure mass (9 bands) at 16^2 and NC_G^2 cells,
    # and K3 on B (rows 2-20 long) and Bt (rows 0-7, empty at Dirichlet nodes)
    stokes_ops = {}
    for nc in (16, NC_G):
        prob = stokes_problem((nc, nc), dtype=torch.float64, device=dev)
        B, Bt = prob.A.block(1, 0).ops[0], prob.A.block(0, 1).ops[0]
        K = prob.K.ops[0]
        assert len(K.offsets) == 25 and len(prob.Mp.offsets) == 9
        assert int(Bt.row_len.min()) == 0 and int(B.row_len.min()) > 0
        for dt, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
            for tag, A in ((f"[Stokes K {K.grid_shape}]", K),
                           (f"[Stokes Mp {prob.Mp.grid_shape}]", prob.Mp)):
                A = A.astype(dt)
                check_k2(f"{tag}{str(dt)[6:]}", A, vec(A.n, dt), tol, False)
            for tag, A in (("B", B), ("Bt", Bt)):
                A = A.astype(dt)
                check_ell(f"K3[Stokes {tag} {A.nrows}x{A.ncols} K={A.row_width} rows "
                          f"{int(A.row_len.min())}-{int(A.row_len.max())} G={A.group}]"
                          f"{str(dt)[6:]}", A, vec(A.ncols, dt), tol)
        if nc == NC_G:
            stokes_ops = {"K": K, "Mp": prob.Mp, "B": B, "Bt": Bt}
        del prob
    print(f"[3 kernels] {len(lines)} cases within f32 {F32_TOL:.0e} / f64 {F64_TOL:.0e} "
          f"(bf16 bands and values against the plain version on the same bf16 data), bf16 K1 "
          f"within one bf16 ulp of max|y| (worst {worst['K1 bf16']:.3e} abs): "
          + ", ".join(lines) + f" {elapsed()}", flush=True)
    del extra, S, Ac, Ab, A, A64, Ar, bands, x, Aell, cols, vals, row_len, w_rand, f_rand
    lines.clear()

    # ---- 4, 5, 6 main paths: small checks, then each counted NC^3 run ---
    deg = ChebyshevSmoother().degree
    lanczos = ChebyshevSmoother().lanczos_iters
    launches = {}

    # path A: constant stencils (K1)
    x, st, _ = solve_poisson_const((32,) * 3, 3, device=dev, dtype=torch.float32)
    assert st.niter == 4 and st.converged(), (st.niter, st.flag)
    x_cpu, st_cpu, _ = solve_poisson_const((32,) * 3, 3, device="cpu", dtype=torch.float32)
    assert st_cpu.niter == st.niter
    e32 = relerr(x.cpu(), x_cpu)
    assert e32 <= 1e-4, f"32^3 f32 solve: card vs CPU plain path {e32:.2e}"
    reset_counts()
    t0 = time.perf_counter()
    xA, stA, infoA = solve_poisson_const((NC,) * 3, 4, device=dev, dtype=torch.float32)
    torch.cuda.synchronize()
    secsA = time.perf_counter() - t0
    launches["A"] = read_counts()
    marchA = k1.counts.march
    nA = cg_gmg_applies(stA.niter, 4, deg)
    assert ITS["A"][0] <= stA.niter <= ITS["A"][1] and stA.converged(), (stA.niter, stA.flag)
    assert xA.shape == (N1 ** 3,) and bool(torch.isfinite(xA).all())
    assert infoA["l2_error"] <= 2e-4, infoA["l2_error"]
    assert launches["A"] == {"K1": nA, "K2": 1, "K3": 0}, (launches["A"], nA)  # K2: L2 error
    levelsA = cg_gmg_level_applies(stA.niter, 4, deg)
    assert sum(levelsA) == nA
    print(f"[4 path A] solve_poisson_const f32: 32^3/3 levels {st.niter} its (CPU plain path "
          f"{st_cpu.niter} its, x rel diff {e32:.1e}); {NC}^3/4 levels {stA.niter} its, "
          f"flag {stA.flag}, L2 error {infoA['l2_error']:.3e}, "
          f"{secsA:.2f} s incl. setup; K1 launches {launches['A']['K1']} = "
          f"(n+1)((L-1)(2k+1)+2) = {nA}, by level {levelsA}, all on the marching kernel; "
          f"K2 launches 1 (L2 error, box kernel), plain launches 0 {elapsed()}", flush=True)

    # path B: banded stencils (K2), f64
    _, st64, info64 = solve_poisson((64,) * 3, 4, rtol=1e-8, dtype=torch.float64, device=dev)
    assert st64.niter == 7 and st64.converged(), (st64.niter, st64.flag)
    x16, st16, _ = solve_poisson((16,) * 3, 3, rtol=1e-8, dtype=torch.float64, device=dev)
    x16c, st16c, _ = solve_poisson((16,) * 3, 3, rtol=1e-8, dtype=torch.float64, device="cpu")
    assert st16.niter == st16c.niter == 7
    e16 = relerr(x16.cpu(), x16c)
    assert e16 <= 1e-10, f"16^3 f64 solve: card vs CPU plain path {e16:.2e}"
    reset_counts()
    t0 = time.perf_counter()
    xB, stB, infoB = solve_poisson((NC,) * 3, 4, rtol=1e-8, dtype=torch.float64, device=dev)
    torch.cuda.synchronize()
    secsB = time.perf_counter() - t0
    launches["B"] = read_counts()
    # setup: one Lanczos run per smoothing level (pre and post share it)
    nB = 3 * lanczos + cg_gmg_applies(stB.niter, 4, deg) + 1
    assert ITS["B"][0] <= stB.niter <= ITS["B"][1] and int(stB.flag) == 2, (stB.niter, stB.flag)
    assert xB.shape == (N1 ** 3,) and bool(torch.isfinite(xB).all())
    assert infoB["l2_error"] <= 1e-6, infoB["l2_error"]
    assert launches["B"] == {"K1": 0, "K2": nB, "K3": 0}, (launches["B"], nB)
    print(f"[5 path B] solve_poisson f64 rtol 1e-8: 64^3/4 levels {st64.niter} its "
          f"(L2 {info64['l2_error']:.3e}); 16^3 card = CPU plain path {st16.niter} its, "
          f"x rel diff {e16:.1e}; {NC}^3/4 levels {stB.niter} its, flag CONVERGED_RTOL, "
          f"L2 error {infoB['l2_error']:.3e}, {secsB:.2f} s incl. setup; K2 launches "
          f"{launches['B']['K2']} = 3*{lanczos} Lanczos + (n+1)((L-1)(2k+1)+2) + 1 = {nB}, "
          f"all on the box kernel; "
          f"plain launches 0 {elapsed()}", flush=True)
    del xB, info64, x16, x16c, x, x_cpu

    # path C: CG + smoothed-aggregation AMG, f32
    _, _, stateC32, xc, stc, l2c, _ = solve_amg(32, dev)
    _, _, _, xc_cpu, stc_cpu, _, _ = solve_amg(32, "cpu")
    assert stc.niter == stc_cpu.niter == 6 and stc.converged(), (stc.niter, stc_cpu.niter)
    ec = relerr(xc.cpu(), xc_cpu)
    assert ec <= 1e-4, f"32^3 AMG solve: card vs CPU plain path {ec:.2e}"
    del stateC32, xc, xc_cpu
    reset_counts()
    t0 = time.perf_counter()
    probC, cgC, stateC, xC, stC, l2C, setupC = solve_amg(NC, dev)
    torch.cuda.synchronize()
    secsC = time.perf_counter() - t0
    launches["C"] = read_counts()
    amg = stateC["Pl"]
    L = len(amg["mats"])
    nC2, nC3 = cg_amg_applies(stC.niter, L, deg, lanczos)
    assert ITS["C"][0] <= stC.niter <= ITS["C"][1] and int(stC.flag) == 2, (stC.niter, stC.flag)
    assert xC.shape == (N1 ** 3,) and bool(torch.isfinite(xC).all())
    assert l2C <= 2e-4, l2C
    assert launches["C"] == {"K1": 0, "K2": nC2, "K3": nC3}, (launches["C"], nC2, nC3)
    shapes = [m.shape[0] for m in amg["mats"]]
    widths = ("/".join(str(m.row_width) for m in amg["mats"][1:]),
              "/".join(str(m.row_width) for m in amg["P"]),
              "/".join(str(m.row_width) for m in amg["R"]))
    print(f"[6 path C] CG + AMGSolver(coarse_size=400) f32 rtol 1e-6: 32^3 card = CPU plain "
          f"path {stc.niter} its, x rel diff {ec:.1e}, L2 {l2c:.3e}; {NC}^3: {L} levels "
          f"{shapes}, ELL widths levels 1.. {widths[0]}, P {widths[1]}, R {widths[2]}; "
          f"{stC.niter} its, flag CONVERGED_RTOL, L2 error {l2C:.3e}; set-up {setupC:.2f} s "
          f"(host aggregation and Galerkin products, device Lanczos), set-up + solve + L2 "
          f"{secsC:.2f} s; K2 launches {nC2} = {lanczos} + (n+1)(2k+2) + 1 (box kernel), "
          f"K3 launches "
          f"{nC3} = {lanczos}(L-2) + (n+1)((L-2)(2k+1) + 1 + 2(L-1)), K1 0, plain "
          f"launches 0 {elapsed()}", flush=True)

    # ---- 6D path D: mixed-precision GMG under flexible CG ----------------
    # the JAX bench's gmg_cg_mixed row: constant stencils, Chebyshev(4) with
    # Gershgorin λmax, dense-inverse coarse solve, f32, bf16 smoothing
    # (`mixed`) or the whole cycle in bf16 (mixed=False); flexible CG
    f32, bf16 = torch.float32, torch.bfloat16
    degD = 4
    mixed_kw = {"f32": {}, "mixed": {"compute_dtype": bf16, "mixed": True},
                "bf16": {"compute_dtype": bf16}}

    def gmg_d(nc, levels, device, kind):
        return poisson_const_gmg((nc,) * 3, levels, degree=degD,
                                 coarsest_solver=DenseInverseSolver(), dtype=f32, device=device,
                                 **mixed_kw[kind])

    def solve_d(nc, levels, device, kind):
        """CG(flexible) + path D's GMG: (problem, solver, state, x, stats,
        true relative residual, L2 error)."""
        prob = poisson_problem((nc,) * 3, dtype=f32, device=device)
        A = laplacian_const(prob.mesh, f32, device)
        cg = CGSolver(Pl=gmg_d(nc, levels, device, kind), rtol=1e-5, maxiter=40, flexible=True)
        state = cg.setup(A)
        x, st = cg.solve(state, prob.b)
        rel = float(torch.linalg.norm(prob.b - A.matvec(x)) / torch.linalg.norm(prob.b))
        return prob, cg, state, x, st, rel, float(prob.l2_error(x))

    small = []
    for variant in ("mixed", "bf16"):
        _, _, _, x, st, rel, _ = solve_d(32, 3, dev, variant)
        _, _, _, x_cpu, st_cpu, _, _ = solve_d(32, 3, "cpu", variant)
        e = relerr(x.cpu(), x_cpu)
        assert st.niter == st_cpu.niter and st.converged() and rel < 2e-5, (variant, st.niter,
                                                                         st_cpu.niter, rel)
        assert e <= BF16_X_TOL, f"32^3 {variant} solve: card vs CPU plain path {e:.2e}"
        small.append(f"{variant} {st.niter} its (CPU {st_cpu.niter}), x rel diff {e:.1e}")
    runs_d = {}
    bf16_launches = {}
    for variant in ("f32", "mixed"):
        reset_counts()
        t0 = time.perf_counter()
        runs_d[variant] = solve_d(NC, 4, dev, variant)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches[f"D {variant}"] = read_counts()
        bf16_launches[f"D {variant}"] = k1.counts.bf16
        _, _, _, x, st, rel, l2 = runs_d[variant]
        n = st.niter
        if variant == "f32":  # CG + V-cycles, and the true-residual check
            want = (cg_gmg_applies(n, 4, degD) + 1, 0)
        else:  # a smoothing level: 2k bf16 (smoothers) + 3 f32 (residuals, correction)
            want = ((n + 1) * (3 * 3 + 1) + (n + 1) + 1 + (n + 1) * 3 * 2 * degD,
                    (n + 1) * 3 * 2 * degD)
        assert (launches[f"D {variant}"]["K1"], bf16_launches[f"D {variant}"]) == want, (
            variant, launches[f"D {variant}"], bf16_launches[f"D {variant}"], want)
        assert launches[f"D {variant}"]["K2"] == 1 and launches[f"D {variant}"]["K3"] == 0
        assert st.converged() and rel < 2e-5 and l2 <= 2e-4, (variant, st.niter, st.flag, rel, l2)
        assert x.shape == (N1 ** 3,) and x.dtype == f32 and bool(torch.isfinite(x).all())
        small.append(f"{NC}^3 {variant}: {n} its, flag {st.flag}, true rel residual {rel:.3e}, "
                     f"L2 {l2:.3e}, {secs:.2f} s incl. setup, K1 launches "
                     f"{launches[f'D {variant}']['K1']} ({bf16_launches[f'D {variant}']} bf16), "
                     f"all marching")
    itsD = {k: v[4].niter for k, v in runs_d.items()}
    assert itsD["mixed"] <= itsD["f32"] + 1, itsD
    print(f"[6D path D] CG(flexible, rtol 1e-5) + GMG Chebyshev({degD}) Gershgorin, dense "
          f"inverse, f32 / bf16 smoothing (mixed) / all bf16, 32^3/3 levels card = CPU plain "
          f"path, {NC}^3/4 levels: " + "; ".join(small)
          + f"; mixed its {itsD['mixed']} <= f32 its {itsD['f32']} + 1; K1 launch formulas: "
          f"f32 (n+1)((L-1)(2k+1)+2) + 1, mixed f32 (n+1)(3(L-1)+2) + 1 and bf16 "
          f"(n+1)(L-1)2k; K2 1 (L2 error), plain launches 0 {elapsed()}", flush=True)

    # ---- 6E path E: f32 iterative refinement ------------------------------
    # tests/test_refinement.py's linear refinement: banded Dirichlet-
    # eliminated operators on every level (K2), Chebyshev(4) with Gershgorin
    # λmax, dense-inverse coarse solve, CG rtol 1e-6, two refinement steps
    probE = poisson_problem((NC,) * 3, dtype=f32, device=dev)
    itsE = []
    gmgE = gmg_from_hierarchy(
        cartesian_hierarchy((NC,) * 3, 4),
        lambda m: eliminate_dirichlet(laplacian(m, f32, dev), m.boundary_vertex_mask()),
        smoother=ChebyshevSmoother(degree=4, eig_method="gershgorin"),
        coarsest_solver=DenseInverseSolver(), dtype=f32, device=dev)
    cgE = CGSolver(Pl=gmgE, rtol=1e-6, maxiter=40)
    refE = IterativeRefinementSolver(Recorded(cgE, itsE), niter=2)
    reset_counts()
    t0 = time.perf_counter()
    stateE = refE.setup(probE.A)
    (xh, xl), (stE, rnormE) = refE.solve(stateE, probE.b)
    torch.cuda.synchronize()
    secsE = time.perf_counter() - t0
    launches["E"] = read_counts()
    itsE = list(itsE)  # the counted run's inner solves (the timed runs append more)
    nE = sum((n + 1) * (3 * (2 * 4 + 1) + 2) for n in itsE)
    assert launches["E"] == {"K1": 0, "K2": nE, "K3": 0}, (launches["E"], nE, itsE)
    assert len(itsE) == 3 and stE.converged() and xh.dtype == xl.dtype == f32
    x32, st32 = cgE.solve(stateE["inner"], probE.b)
    A64, b64 = probE.A.astype(torch.float64), probE.b.double()

    def rel64(x):
        return float(torch.linalg.norm(b64 - A64.matvec(x)) / torch.linalg.norm(b64))

    plainE, refinedE = rel64(x32.double()), rel64(xh.double() + xl.double())
    compE = float(rnormE) / float(torch.linalg.norm(b64))
    assert refinedE < 1e-10 and refinedE < 1e-2 * plainE, (plainE, refinedE)
    print(f"[6E path E] IterativeRefinementSolver(CG rtol 1e-6 + banded GMG, niter=2) f32, "
          f"{NC}^3/4 levels: inner its {itsE}, f64 relative residual of the f32 system (card, "
          f"f64 K2 from x_hi + x_lo) {refinedE:.3e} against the plain f32 solve's {plainE:.3e} "
          f"({st32.niter} its); compensated residual {compE:.3e}; {secsE:.2f} s incl. setup; "
          f"K2 launches {nE} = sum over the 3 inner solves of (n+1)((L-1)(2k+1)+2), all box, "
          f"K1 0, plain launches 0 {elapsed()}", flush=True)
    del xh, xl, x32, A64, b64

    # ---- 6F path F: FGMRES and MINRES ------------------------------------
    def solve_f(nc, levels, device, kind):
        prob = poisson_problem((nc,) * 3, dtype=f32, device=device)
        A = laplacian_const(prob.mesh, f32, device)
        if kind == "fgmres":  # right preconditioner: path D's mixed GMG
            solver = FGMRESSolver(m=30, Pr=gmg_d(nc, levels, device, "mixed"), rtol=1e-5)
        else:  # left SPD preconditioner: path A's f32 GMG
            solver = MINRESSolver(Pl=poisson_const_gmg((nc,) * 3, levels, dtype=f32,
                                                       device=device), rtol=1e-5)
        state = solver.setup(A)
        x, st = solver.solve(state, prob.b)
        rel = float(torch.linalg.norm(prob.b - A.matvec(x)) / torch.linalg.norm(prob.b))
        return prob, solver, state, x, st, float(prob.l2_error(x)), rel

    runs_f = {}
    small = []
    for variant in ("fgmres", "minres"):
        st = solve_f(32, 3, dev, variant)[4]
        st_cpu = solve_f(32, 3, "cpu", variant)[4]
        assert st.niter == st_cpu.niter and int(st.flag) == 2, (variant, st.niter, st_cpu.niter)
        reset_counts()
        t0 = time.perf_counter()
        runs_f[variant] = solve_f(NC, 4, dev, variant)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches[f"F {variant}"] = read_counts()
        bf16_launches[f"F {variant}"] = k1.counts.bf16
        _, _, _, x, stF, l2, rel = runs_f[variant]
        n = stF.niter
        # each count has one K1 f32 launch more: the true-residual check
        if variant == "fgmres":  # initial and per-cycle residuals, A and one mixed V-cycle an its
            cycles = -(-n // 30)
            want = (2 + cycles + n + n * (3 * 3 + 1) + n * 3 * 2 * degD, n * 3 * 2 * degD)
        else:  # the first residual and M apply, then A and M an iteration
            want = (cg_gmg_applies(n, 4, 3) + 1, 0)
        assert (launches[f"F {variant}"]["K1"], bf16_launches[f"F {variant}"]) == want, (
            variant, launches[f"F {variant}"], bf16_launches[f"F {variant}"], want)
        assert launches[f"F {variant}"]["K2"] == 1 and launches[f"F {variant}"]["K3"] == 0
        # rtol 1e-5 solves: the true residual under 2e-5 (tests/test_gmg.py:275), and the
        # L2 error under path A's 2e-4 for MINRES. FGMRES minimizes the residual: at 128^3
        # it reaches rtol 1e-5 in 3 iterations, with an L2 error above 2e-4 (PERF.md)
        assert int(stF.flag) == 2 and rel < 2e-5, (variant, n, stF.flag, rel)
        assert variant == "fgmres" or l2 <= 2e-4, (variant, n, l2)
        assert x.shape == (N1 ** 3,) and bool(torch.isfinite(x).all())
        small.append(f"{variant}: 32^3/3 levels {st.niter} its (CPU plain path {st_cpu.niter}); "
                     f"{NC}^3/4 levels {n} its, flag CONVERGED_RTOL, true rel residual "
                     f"{rel:.3e}, L2 {l2:.3e}, {secs:.2f} s "
                     f"incl. setup, K1 launches {launches[f'F {variant}']['K1']} "
                     f"({bf16_launches[f'F {variant}']} bf16), all marching")
    print(f"[6F path F] FGMRES(m=30, Pr=path D's mixed GMG, rtol 1e-5) and MINRES(Pl=path A's "
          f"f32 GMG, rtol 1e-5): " + "; ".join(small)
          + f"; K1 formulas (+1: the true residual): FGMRES f32 2 + cycles + n + n(3(L-1)+1), "
          f"bf16 n(L-1)2k; MINRES (n+1)((L-1)(2k+1)+2) + 1; K2 1 (L2 error), plain launches 0 "
          f"{elapsed()}", flush=True)

    # ---- 6G path G: plain Stokes ----------------------------------------
    # the JAX bench's Stokes row (BASELINE config 3): Taylor-Hood Q2/Q1,
    # FGMRES(20) rtol 1e-6 + upper block-triangular preconditioner, velocity
    # GMG (Chebyshev(3) on banded Q2 levels, K2's general kernel: 25 bands in
    # 2D) and the pressure mass (9 bands, K2) by Jacobi-CG rtol 1e-6 <= 30
    # its; B and Bt on K3. 32^2 card = CPU (f32, 3 levels), solve_stokes at
    # 16^2 in f64, then the counted NC_G^2 runs in f64 and in f32
    levels_g = int(math.log2(NC_G // 16)) + 1
    small_g = solve_g(32, 3, f32, dev)
    small_g_cpu = solve_g(32, 3, f32, "cpu")
    st, st_cpu = small_g["stats"], small_g_cpu["stats"]
    assert st.niter == st_cpu.niter and int(st.flag) == int(st_cpu.flag) == 2, (
        st.niter, st_cpu.niter, st.flag, st_cpu.flag)
    eg = relerr(pt.ravel(small_g["x"]).cpu(), pt.ravel(small_g_cpu["x"]))
    assert eg <= SMALL_G_TOL, f"32^2 f32 Stokes solve: card vs CPU plain path {eg:.2e}"
    _, st16, info16 = solve_stokes((16, 16), num_levels=3, dtype=torch.float64, device=dev)
    assert st16.niter == JAX_STOKES_16_ITS and int(st16.flag) == 2, (st16.niter, st16.flag)
    assert info16["residual"] < 1e-7 and info16["velocity_error"] < 1e-7, info16
    del small_g, small_g_cpu, info16
    runs_g = {}
    small = []
    nu_g, np_g = (2 * NC_G + 1) ** 2, (NC_G + 1) ** 2
    g_k3 = {"B": (np_g, nu_g), "Bt": (nu_g, np_g), "Mu": (nu_g, nu_g)}
    for dt, maxiter in ((torch.float64, 60), (torch.float32, 120)):
        tag = f"G f{torch.finfo(dt).bits}"
        reset_counts()
        t0 = time.perf_counter()
        run = solve_g(NC_G, levels_g, dt, dev, maxiter=maxiter)
        torch.cuda.synchronize()
        run["secs"]["solve"] = time.perf_counter() - t0 - sum(run["secs"].values())
        launches[tag] = read_counts(k2_box=False)
        shapes = {"K2": dict(k2.counts.shapes), "K3": dict(k3.counts.shapes)}
        run["cg_its"] = list(run["cg_its"])  # the counted run's (timed re-solves append)
        runs_g[tag] = run
        prob, x, stG = run["prob"], run["x"], run["stats"]
        n = stG.niter
        assert len(run["cg_its"]) == n, (len(run["cg_its"]), n)
        # every operator's launches as counted, each equal to its formula term
        want = stokes_launches(NC_G, n, run["cg_its"], levels_g, deg, lanczos, 20)
        assert launches[tag]["K1"] == 0 and shapes == want, (tag, launches[tag], shapes, want)
        run["launches"] = shapes
        # host syncs: FGMRES reads its first residual, one a restart cycle and
        # one an iteration; each inner CG its first residual and one an iteration
        run["syncs"] = 1 + -(-n // 20) + n + sum(c + 1 for c in run["cg_its"])
        assert int(stG.flag) == 2, (tag, n, stG.flag)
        leaves = pt.tree_leaves(x)
        assert [t.shape[0] for t in leaves] == [(2 * NC_G + 1) ** 2] * 2 + [(NC_G + 1) ** 2]
        assert all(t.dtype == dt and bool(torch.isfinite(t).all()) for t in leaves)
        run["rel64"] = stokes_rel_residual64(prob, x)
        run["uerr"], run["perr"] = prob.velocity_error(x[0]), prob.pressure_error(x[1])
        assert run["uerr"] <= VEL_ERR_BOUND[dt], (tag, run["uerr"], VEL_ERR_BOUND[dt])
        if dt == torch.float64:
            # the true relative block residual: under 2 rtol
            assert run["rel64"] < 2 * STOKES_RTOL, (tag, run["rel64"])
            x64 = x
        else:
            # no f32 vector gets under 2 rtol here: the f64 solution rounded
            # to f32 leaves `floor`; the f32 solve must come within 2x of it
            floor = stokes_rel_residual64(prob, pt.tree_cast(x64, f32))
            run["floor"] = floor
            assert run["rel64"] < 2 * floor, (tag, run["rel64"], floor)
            assert n <= STOKES_F32_ITS_MAX, (tag, n, STOKES_F32_ITS_MAX)
        cg = run["cg_its"]
        small.append(
            f"{NC_G}^2 {tag[2:]} (maxiter {maxiter}): {n} its, flag CONVERGED_RTOL, true rel "
            f"residual {run['rel64']:.3e}"
            + (f" (f32 floor: the f64 solution rounded to f32 reads {run['floor']:.3e})"
               if "floor" in run else "")
            + f", velocity L2 error {run['uerr']:.3e} (bound {VEL_ERR_BOUND[dt]:.3e}), pressure "
            f"{run['perr']:.3e}; inner CG its {min(cg)}-{max(cg)} (sum {sum(cg)}); set-up s: "
            + ", ".join(f"{k} {v:.2f}" for k, v in run["secs"].items())
            + f"; launches counted, each = its formula term: K2 velocity K by level "
            + ", ".join(f"{g[1]}^2 {c}" for g, c in shapes["K2"].items() if g[0] == 25)
            + f", pressure mass {shapes['K2'][(9, NC_G + 1, NC_G + 1)]}; K3 "
            + ", ".join(f"{name} {shapes['K3'][key]}" for name, key in g_k3.items())
            + f" (K2 {launches[tag]['K2']}, K3 {launches[tag]['K3']}); host syncs "
            f"{run['syncs']}")
    del x64
    coarse_g = runs_g["G f64"]["state"]["Pr"]["states"][0]["mats"][-1]
    lu_ms = median_ms(lambda: runs_g["G f64"]["gmg"].coarsest_solver.setup(coarse_g), runs=3,
                      warmup=1, spin=False)
    print(f"[6G path G] plain Stokes, FGMRES(20, rtol {STOKES_RTOL:.0e}) + upper block-"
          f"triangular (velocity GMG Chebyshev(3), {levels_g} levels at {NC_G}^2; Jacobi-CG "
          f"pressure mass rtol 1e-6 <= 30 its): 32^2/3 levels f32 card = CPU plain path "
          f"{st.niter} its (CPU {st_cpu.niter}), x rel diff {eg:.1e}; solve_stokes 16^2/3 "
          f"levels f64 {st16.niter} its (JAX {JAX_STOKES_16_ITS}), flag {st16.flag}; "
          + "; ".join(small)
          + f"; coarse dense LU ({coarse_g.shape[0]} dofs) {lu_ms:.2f} ms; formulas (c "
          f"restart cycles, k = {deg}): K2 velocity K level 0 2({lanczos} + n(2k+1) + 1+c+n), "
          f"levels 1..L-2 2({lanczos} + n(2k+1)), coarsest 2n, pressure mass sum(cg+1); K3 "
          f"B 2(1+c+n), Bt 2(1+c+2n), Mu 2; every K2 launch on the general kernel, plain "
          f"launches 0 "
          f"{elapsed()}", flush=True)

    # ---- 6H path H: augmented-Lagrangian Stokes -------------------------
    # the JAX bench's stokes_graddiv row (bench.py:740-816): grad-div alpha
    # 1e3, Q2/P1disc, flat engine (every velocity block an ELL field block,
    # K3), Chebyshev(4) over the materialized vertex-star Vanka (K3), patch-
    # corrected prolongations (K3) over exact FE transfers (per-axis dense
    # products), FGMRES(20) rtol 1e-8 <= 30 its, Jacobi-CG rtol 1e-6 <= 30 its
    # on -(1/alpha) Mp (P1disc, K3), B and Bt on K3. First the bench's own f32
    # run at its size, card = CPU; then path H2, solve_stokes's block engine
    # (batched Vanka, banded K2 levels, ELL transfers on K3) at NC_H2^2, card
    # = CPU, and the flat engine's iterations equal to it; then the counted
    # NC_H^2 run in f64 (H1)
    f64 = torch.float64
    levels_h = int(math.log2(NC_H // 16)) + 1
    small = []
    # in f32 the FGMRES estimate reaches rtol 1e-8 within a few f32 ulps of
    # it (the CPU sweep: 7.4e-9 at 96^2), so the card and the CPU, summing in
    # other orders, may stop one iteration apart; and an f32 solution of the
    # alpha-augmented system is only as good as its ~2.6e-2 true residual
    # (the sweep), so each is held against the f64 solution: the card's as
    # close to it as the CPU's (within H_F32_TOL of max|x64| more)
    hf = {d: solve_h(setup_h(NC_H_F32, LEVELS_H_F32, f32, d)) for d in (dev, "cpu")}
    x64_f32 = pt.ravel(solve_h(setup_h(NC_H_F32, LEVELS_H_F32, torch.float64, dev))["x"]).cpu()
    st, st_cpu = hf[dev]["stats"], hf["cpu"]["stats"]
    assert abs(st.niter - st_cpu.niter) <= 1 and int(st.flag) == int(st_cpu.flag) == 2, (
        st.niter, st_cpu.niter, st.flag, st_cpu.flag)
    ratio = {d: float(hf[d]["stats"].residuals[hf[d]["stats"].niter]
                      / hf[d]["stats"].residuals[0]) for d in hf}
    eh = relerr(pt.ravel(hf[dev]["x"]).cpu(), pt.ravel(hf["cpu"]["x"]))
    e64 = {d: relerr(pt.ravel(hf[d]["x"]).cpu(), x64_f32) for d in hf}
    assert e64[dev] <= e64["cpu"] + H_F32_TOL, (
        f"{NC_H_F32}^2 f32 augmented Stokes against f64: card {e64[dev]:.2e}, CPU "
        f"{e64['cpu']:.2e}")
    small.append(f"the bench's f32 run, {NC_H_F32}^2/{LEVELS_H_F32} levels: {st.niter} its "
                 f"(CPU plain path {st_cpu.niter}), flag CONVERGED_RTOL, final estimate ratio "
                 f"{ratio[dev]:.3e} (CPU {ratio['cpu']:.3e}), x against the f64 solution "
                 f"{e64[dev]:.2e} (CPU {e64['cpu']:.2e}), card against CPU {eh:.1e}, "
                 f"true rel residual {stokes_rel_residual64(hf[dev]['prob'], hf[dev]['x']):.3e} "
                 f"(f32 vectors), solve {hf[dev]['solve_s']:.2f} s")
    # one augmented V-cycle at this run's shapes, card against CPU on the
    # same operators (the CPU's f32 set-up moved to the card) and input: in
    # f32, and on the same stored values widened to f64, so that the
    # solver's amplification of the two devices' summation orders is one
    # cycle's, not a whole solve's
    g32, s32 = hf["cpu"]["gmg"], hf["cpu"]["state"]["Pr"]["states"][0]
    r_u = tuple(vec(t.shape[0], f64).cpu() for t in hf["cpu"]["prob"].b[0])
    vc = {}
    for dt, tol in ((f32, H_VCYCLE_F32_TOL), (f64, H_VCYCLE_F64_TOL)):
        g, s_ = pt.tree_cast(g32, dt), pt.tree_cast(s32, dt)
        y = {d: torch.cat(tree_to(g, d).apply(tree_to(s_, d), tuple(t.to(d, dt) for t in r_u)))
             for d in (dev, "cpu")}
        vc[dt] = relerr(y[dev].cpu(), y["cpu"])
        assert bool(torch.isfinite(y[dev]).all()) and vc[dt] <= tol, (
            f"{NC_H_F32}^2 V-cycle {dt}, card against CPU on the same operators: "
            f"{vc[dt]:.2e} > {tol:.0e}")
    small.append(f"one V-cycle at {NC_H_F32}^2 on the CPU's set-up, card against CPU: f32 "
                 f"{vc[f32]:.2e} (<= {H_VCYCLE_F32_TOL:.0e}), widened to f64 {vc[f64]:.2e} "
                 f"(<= {H_VCYCLE_F64_TOL:.0e})")
    del hf, x64_f32
    reset_counts()
    t0 = time.perf_counter()
    xh2, sth2, infoh2 = solve_stokes((NC_H2, NC_H2), graddiv_alpha=GD_ALPHA, device=dev)
    torch.cuda.synchronize()
    secs_h2 = time.perf_counter() - t0
    launches["H2"] = read_counts(k2_box=False)
    shapes_h2 = {"K2": dict(k2.counts.shapes), "K3": dict(k3.counts.shapes)}
    xh2c, sth2c, infoh2c = solve_stokes((NC_H2, NC_H2), graddiv_alpha=GD_ALPHA, device="cpu")
    assert sth2.niter == sth2c.niter and int(sth2.flag) == int(sth2c.flag) == 2, (
        sth2.niter, sth2c.niter, sth2.flag, sth2c.flag)
    e2 = relerr(pt.ravel(xh2).cpu(), pt.ravel(xh2c))
    assert e2 <= H2_TOL, f"{NC_H2}^2 solve_stokes(graddiv): card vs CPU {e2:.2e}"
    assert infoh2["residual"] < 1e-7 and launches["H2"]["K2"] > 0 and launches["H2"]["K3"] > 0
    # the flat engine at NC_H2^2 with solve_stokes's configuration
    # (Richardson(10, 0.2) Vanka, FGMRES(40) rtol 1e-9, Jacobi-CG rtol 1e-8)
    flat2 = solve_h(setup_h(NC_H2, 3, f64, dev, cheby=0, m=40, rtol=1e-9, maxiter=120,
                            cg_rtol=1e-8, cg_maxiter=50))
    assert flat2["stats"].niter == sth2.niter, (flat2["stats"].niter, sth2.niter)
    ef = relerr(pt.ravel(flat2["x"]), pt.ravel(xh2))
    assert ef <= 1e-6, f"{NC_H2}^2 flat engine against block engine: x {ef:.2e}"
    small.append(
        f"H2 solve_stokes({NC_H2}^2, graddiv_alpha=1e3) f64 (block engine, Richardson(10, 0.2) "
        f"Vanka): {sth2.niter} its (CPU plain path {sth2c.niter}), x rel diff {e2:.1e}, "
        f"velocity L2 {infoh2['velocity_error']:.3e}, {secs_h2:.2f} s incl. set-up, launches K2 "
        + ", ".join(f"{g[1]}^2 {c}" for g, c in sorted(shapes_h2["K2"].items()))
        + f" (25 bands, general kernel), K3 {launches['H2']['K3']}; the flat engine "
        f"{flat2['stats'].niter} its, x against the block engine's {ef:.1e}")
    prob_h2 = infoh2["problem"]
    del xh2c, infoh2c, flat2
    # H1, counted: every launch from stokes_problem to the end of the solve
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    with BlockCounts() as bc:
        run_h = setup_h(NC_H, levels_h, f64, dev)
        bc.phase = "solve"
        solve_h(run_h)
    launches["H f64"] = read_counts(k2_box=False)
    shapes_h = {"K2": dict(k2.counts.shapes), "K3": dict(k3.counts.shapes)}
    mem_gb = (torch.cuda.max_memory_allocated() - mem0) / 2 ** 30
    kept_gb = (torch.cuda.memory_allocated() - mem0) / 2 ** 30
    prob, x, stH = run_h["prob"], run_h["x"], run_h["stats"]
    n = stH.niter
    # every counted apply belongs to one role's block; each role's count,
    # set-up and solve apart, equals its term of h_launches, and the counts
    # by block shape add up to the kernel's own counts by shape
    role_blocks = {role: ell_blocks(op) for role, op in h_roles(run_h).items()}
    owned = [id(b) for bl in role_blocks.values() for b in bl]
    assert len(owned) == len(set(owned)), "a block in two roles"
    stray = {bc.seen[k].shape for _, k in bc.counts if k not in set(owned)}
    assert not stray, f"K3 launches on blocks of no role: {stray}"
    counted = {ph: {role: bc.of(bl, ph) for role, bl in role_blocks.items()}
               for ph in ("set-up", "solve")}
    blocks = {role: len(bl) for role, bl in role_blocks.items()}
    shape_of = {role: bl[0].shape for role, bl in role_blocks.items()}
    power_iters = PreconditionedChebyshevSmoother().power_iters
    want = dict(zip(("set-up", "solve"), h_launches(n, run_h["cg_its"], levels_h, 4,
                                                     power_iters, 20, blocks)))
    for ph in want:
        assert counted[ph] == {r: want[ph].get(r, 0) for r in blocks}, (ph, counted[ph], want[ph])
    assert launches["H f64"]["K1"] == launches["H f64"]["K2"] == 0 and not shapes_h["K2"]
    assert shapes_h["K3"] == bc.by_shape(), (shapes_h["K3"], bc.by_shape())
    run_h["syncs"] = 1 + -(-n // 20) + n + sum(c + 1 for c in run_h["cg_its"])
    assert int(stH.flag) == 2 and n <= GD_MAXITER, (n, stH.flag)
    assert H_ITS[0] <= n <= H_ITS[1], (n, H_ITS)
    leaves = pt.tree_leaves(x)
    assert [t.shape[0] for t in leaves] == [(2 * NC_H + 1) ** 2] * 2 + [3 * NC_H ** 2]
    assert all(t.dtype == f64 and bool(torch.isfinite(t).all()) for t in leaves)
    run_h["rel64"] = stokes_rel_residual64(prob, x)
    run_h["uerr"], run_h["perr"] = prob.velocity_error(x[0]), prob.pressure_error(x[1])
    assert run_h["rel64"] < 2 * GD_RTOL, run_h["rel64"]
    assert run_h["uerr"] <= H_VEL_ERR_BOUND and run_h["perr"] <= H_PRE_ERR_BOUND, (
        run_h["uerr"], run_h["perr"])
    cg = run_h["cg_its"]
    print(f"[6H path H] augmented Stokes (alpha 1e3, Q2/P1disc), FGMRES(20, rtol {GD_RTOL:.0e}"
          f" <= {GD_MAXITER}) + upper block-triangular ((1, 1), (0, 1)): velocity GMG flat engine "
          f"Chebyshev(4) over materialized Vanka, patch prolongations; Jacobi-CG on -(1/alpha)Mp "
          f"rtol 1e-6 <= 30 its. " + "; ".join(small)
          + f"; H1 {NC_H}^2/{levels_h} levels f64 (counted): {n} its (band {H_ITS}), flag "
          f"CONVERGED_RTOL, true rel residual {run_h['rel64']:.3e} (< {2 * GD_RTOL:.0e}), "
          f"velocity L2 {run_h['uerr']:.4e} (bound {H_VEL_ERR_BOUND:.4e}), pressure L2 "
          f"{run_h['perr']:.4e} (bound {H_PRE_ERR_BOUND:.4e}); inner CG its {min(cg)}-{max(cg)} "
          f"(sum {sum(cg)}); host syncs {run_h['syncs']}; set-up {run_h['setup_s']:.2f} s by "
          f"step: " + ", ".join(f"{k} {v:.2f}" for k, v in run_h["secs"].items())
          + f"; solve {run_h['solve_s']:.2f} s; device memory over what the earlier paths "
          f"hold: peak {mem_gb:.2f} GiB, {kept_gb:.2f} GiB kept after the solve; native "
          f"host kernels: {native.implementation()}; K3 launches {launches['H f64']['K3']}, "
          f"counted by role (set-up + solve, each equal to blocks x applies): "
          + ", ".join(f"{role} {counted['set-up'][role]} + {counted['solve'][role]} "
                      f"({blocks[role]} blocks, {shape_of[role][0]}x{shape_of[role][1]})"
                      for role in blocks)
          + f"; by shape equal to the kernel's counts; K1 0, K2 0, plain launches 0 "
          f"{elapsed()}", flush=True)
    # K3 on path H's new shapes (and K2 on the block engine's 25-band
    # augmented blocks) against their plain versions, at 16^2 and NC_H^2:
    # every ELL block of every role H1 applies (each level's operator,
    # materialized Vanka and patch prolongation, B, Bt, Mp, Mu), and K2 on
    # the 25-band K+G and G blocks; then every kernel leaf of H2's
    # hierarchy (K2 on each level's banded blocks, K3 on its FE transfers)
    run16 = setup_h(16, 2, f64, dev)
    by_role = []
    for nc, r in ((16, run16), (NC_H, run_h)):
        pr = r["prob"]
        for role, op in h_roles(r).items():
            err = {}
            for dt, tol in ((f32, F32_TOL), (f64, F64_TOL)):
                err[dt] = max(check_ell(f"K3[H {nc}^2 {role}.{i} {A.nrows}x{A.ncols}]"
                                        f"{str(dt)[6:]}", A, vec(A.ncols, dt), tol)
                              for i, A in enumerate(b.astype(dt) for b in ell_blocks(op)))
            bl = ell_blocks(op)
            by_role.append(f"{nc}^2 {role} {len(bl)}x{bl[0].nrows}x{bl[0].ncols} K<="
                           f"{max(b.row_width for b in bl)} f32 {err[f32]:.1e} "
                           f"f64 {err[f64]:.1e}")
        for dt, tol in ((f32, F32_TOL), (f64, F64_TOL)):
            for name, A in (("K+G", pr.K.inner.blocks[0][0]), ("G", pr.K.inner.blocks[0][1])):
                A = A.astype(dt)
                assert len(A.offsets) == 25, (name, len(A.offsets))
                e = check_k2(f"[H {nc}^2 {name} 25 bands {A.grid_shape}]{str(dt)[6:]}", A,
                             vec(A.n, dt), tol, False)
                by_role.append(f"{nc}^2 {name} K2 {A.grid_shape[0]}^2 {str(dt)[6:]} {e:.1e}")
    # the timed blocks (phase 8): level 0's, and the -(1/alpha) Mp that the
    # pressure CG applies
    Mv = run_h["state"]["Pr"]["states"][0]["pre"][0]["M"]["Mv"]
    h_ops = {"M_vanka (0,0)": Mv.kblocks[0][0], "M_vanka (0,1)": Mv.kblocks[0][1],
             "K+G (0,0)": run_h["prob"].K.kblocks[0][0], "G (0,1)": run_h["prob"].K.kblocks[0][1],
             "Mp P1disc": run_h["state"]["Pr"]["diag_ops"][1], "B P1disc": run_h["prob"].A.block(1, 0).ops[0],
             "Bt P1disc": run_h["prob"].A.block(0, 1).ops[0]}
    h2_leaves = collections.defaultdict(lambda: [0, 0.0])  # kind: [leaves, worst]
    for lv, A in enumerate(kernel_leaves(infoh2["state"]["Pr"]["states"][0])):
        for dt, tol in ((f32, F32_TOL), (f64, F64_TOL)):
            Ad, tag = A.astype(dt), f"[H2 leaf {lv}]{str(dt)[6:]}"
            if isinstance(A, ELLMatrix):
                e = check_ell(f"K3{tag}", Ad, vec(Ad.ncols, dt), tol)
                leaf_kind = f"H2 K3 {Ad.nrows}x{Ad.ncols} {str(dt)[6:]}"
            else:
                e = check_k2(tag, Ad, vec(Ad.n, dt), tol, False)
                leaf_kind = f"H2 K2 {len(Ad.offsets)} bands {Ad.grid_shape[0]}^2 {str(dt)[6:]}"
            h2_leaves[leaf_kind][0] += 1
            h2_leaves[leaf_kind][1] = max(h2_leaves[leaf_kind][1], e)
    by_role += [f"{k} ({c} leaves) {e:.1e}" for k, (c, e) in h2_leaves.items()]
    print(f"[6H kernels] {len(lines)} cases on path H's operators within f32 {F32_TOL:.0e} / "
          f"f64 {F64_TOL:.0e}, worst by role (blocks x rows x columns): " + ", ".join(by_role)
          + f" {elapsed()}", flush=True)
    lines.clear()
    del run16
    # H1's solve time and trace are taken here, and only the blocks phase 8
    # times are kept, so that H1's state is gone before path I
    t_solve_h = median_ms(lambda: run_h["solver"].solve(run_h["state"], run_h["prob"].b),
                          runs=3, warmup=1, spin=False)
    if opts.profile is not None:
        summary = profile_solve(lambda: run_h["solver"].solve(run_h["state"], run_h["prob"].b),
                                opts.profile, "path_H_f64")
        print(f"[profile] path H f64 solve, {card}: {summary} {elapsed()}", flush=True)
    h_timed_launches = {name: sum(bc.of([blk], ph) for ph in counted)
                        for name, blk in h_ops.items()}
    h_kg_banded = run_h["prob"].K.inner.blocks[0][0]
    h1_its = run_h["stats"].niter
    del run_h, role_blocks, bc, prob, x, stH, leaves, Mv, pr, r, op, bl
    torch.cuda.empty_cache()

    # ---- 6I path I: Navier-Stokes and Newton ----------------------------
    # BASELINE config 4, the lid-driven cavity at Re = 10. First I2, the JAX
    # bench's ns_newton and ns_graddiv rows (bench.py:1205-1265, 1355-1470)
    # at their own size in f32, card and CPU, with two NewtonRefinement
    # steps after ns_graddiv; then I1, the ns_graddiv configuration at
    # NC_I^2 in f64 with atol 0, its K3 launches counted by role in set-up
    # and in the Newton phase apart, set-up and each Newton step timed by step
    small = []
    i2 = {}
    for name, kw in (("ns_newton", dict(graddiv=False, atol=1e-8)),
                     ("ns_graddiv", dict(atol=3e-3))):
        for d in (dev, "cpu"):
            run = i2[name, d] = solve_i(setup_i(NC_I2, LEVELS_I2, f32, d, **kw))
            if name == "ns_graddiv":
                _, _, run["rnorms"] = NewtonRefinement(run["fgmres"], niter=2).refine(
                    run["prob"], run["x"], run["probe"].setup_state)
        sc, sh = i2[name, dev]["stats"], i2[name, "cpu"]["stats"]
        # equal Newton counts, or one apart where the run that went on had,
        # at the other's count, a residual within 10% of its target (the f32
        # residual floor sits at the target: ns_graddiv's atol 3e-3)
        longer = sc if sc.niter > sh.niter else sh
        lh = longer.residuals.numpy()
        target = max(kw["atol"], 1e-6 * lh[0])
        apart = abs(sc.niter - sh.niter)
        assert sc.flag == sh.flag and sc.converged() and (
            apart == 0 or (apart == 1 and lh[min(sc.niter, sh.niter)] <= 1.1 * target)), (
            name, sc.niter, sh.niter, sc.flag, sh.flag, lh)
        part = {}
        for d in (dev, "cpu"):
            run = i2[name, d]
            h = run["stats"].residuals.numpy()
            part[d] = (f"{run['stats'].niter} Newton its, flag {run['stats'].flag}, final "
                       f"residual {h[run['stats'].niter]:.3e}, FGMRES its by step "
                       f"{[s_['its'] for s_ in run['per_step']]}, centre u_x "
                       f"{run['ux_centre']:.6f}, Newton {run['newton_s']:.2f} s")
            if "rnorms" in run:
                rel = run["rnorms"][-1] / float(np.nanmax(h))
                run["refined_rel"] = rel
                part[d] += (f", NewtonRefinement(2) compensated residuals "
                            + " ".join(f"{v:.3e}" for v in run["rnorms"])
                            + f", relative to the history's max {rel:.3e}")
        small.append(f"I2 {name} {NC_I2}^2/{LEVELS_I2} levels f32: card {part[dev]}; CPU plain "
                     f"path {part['cpu']}")
    del i2, run
    # I1, counted
    levels_i = int(math.log2(NC_I // 16)) + 1
    n_u_levels = [(2 * (NC_I >> lv) + 1) ** 2 for lv in range(levels_i)]
    first_pattern, refreshes = [], [0]

    def keep_pattern(state):
        """The set-up's and every refreshed state's ELL blocks (the outer
        Jacobian, each level's Jacobian, each level's materialized Vanka)
        carry row lengths and keep the set-up's cols, row_len and group."""
        gst = state["Pr"]["states"][0]
        blocks = ([("A", b) for b in ell_blocks(state["A"])]
                  + [(f"J{lv}", b) for lv, m_ in enumerate(gst["mats"]) for b in ell_blocks(m_)]
                  + [(f"M{lv}", b) for lv, s_ in enumerate(gst["pre"])
                     for b in ell_blocks(s_["M"]["Mv"])])
        assert all(b.row_len is not None for _, b in blocks), "a block without row lengths"
        now = [(n_, b.cols.data_ptr(), b.row_len.data_ptr(), b.group) for n_, b in blocks]
        if not first_pattern:
            first_pattern.extend(now)
        assert now == first_pattern, "a refresh changed a block's cols, row_len or group"
        refreshes[0] += 1

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    with IRoles(n_u_levels) as roles, SyncCount() as syncs:
        run_i = setup_i(NC_I, levels_i, f64, dev, check=keep_pattern)
        run_i["probe"].syncs = syncs
        roles.install(run_i)
        solve_i(run_i)
    launches["I f64"] = read_counts(k2_box=False)
    mem_gb = (torch.cuda.max_memory_allocated() - mem0) / 2 ** 30
    kept_gb = (torch.cuda.memory_allocated() - mem0) / 2 ** 30
    prob_i, x_i, st_i = run_i["prob"], run_i["x"], run_i["stats"]
    state_i = run_i["probe"].state
    gst_i = state_i["Pr"]["states"][0]
    per_step, n_i = run_i["per_step"], st_i.niter
    hist_i = st_i.residuals.numpy()
    m_blocks = [len(ell_blocks(s_["M"]["Mv"])) for s_ in gst_i["pre"]]
    power_iters = PreconditionedChebyshevSmoother().power_iters
    want_i = i_launches(per_step, run_i["cg_its"], levels_i, 4, power_iters, run_i["m"], m_blocks)
    counted_i = {ph: {r_: c for (p_, r_), c in roles.counts.items() if p_ == ph} for ph in want_i}
    assert not roles.stray and roles.no_row_len == 0, (dict(roles.stray), roles.no_row_len)
    assert counted_i == want_i, (counted_i, want_i)
    assert dict(roles.shapes) == dict(k3.counts.shapes), (dict(roles.shapes), k3.counts.shapes)
    assert launches["I f64"]["K1"] == launches["I f64"]["K2"] == 0 and not k2.counts.shapes
    assert refreshes[0] == n_i, (refreshes[0], n_i)  # the set-up and n - 1 refreshes
    assert int(st_i.flag) == 2 and I_NEWTON_ITS[0] <= n_i <= I_NEWTON_ITS[1], (n_i, st_i.flag)
    assert all(I_FGMRES_ITS[0] <= s_["its"] <= I_FGMRES_ITS[1] for s_ in per_step), per_step
    assert hist_i[n_i] <= 1e-6 * hist_i[0], hist_i
    leaves = pt.tree_leaves(x_i)
    assert [t.shape[0] for t in leaves] == [(2 * NC_I + 1) ** 2] * 2 + [3 * NC_I ** 2]
    assert all(t.dtype == f64 and bool(torch.isfinite(t).all()) for t in leaves)
    ux = run_i["ux_centre"]
    assert ux < 0 and abs(ux - I_UX_CENTRE) <= I_UX_BOUND, (ux, I_UX_CENTRE, I_UX_BOUND)
    steps_txt, k_cg = [], 0
    for k, s_ in enumerate(per_step):
        cgs = run_i["cg_its"][k_cg: k_cg + s_["its"]]
        k_cg += s_["its"]
        # the host syncs the code's reads predict: the Newton residual norm,
        # FGMRES's first residual, one a restart cycle and one an iteration,
        # each inner CG's first residual and one an iteration
        s_["syncs_formula"] = (1 + fgmres_applies(s_["its"], run_i["m"])
                               + sum(c + 1 for c in cgs))
        steps_txt.append(
            f"step {k + 1}: residual {s_['residual']:.3e}, FGMRES {s_['its']} its, solve "
            f"{s_['solve_s']:.3f} s, then " + ", ".join(f"{st_} {v:.3f} s"
                                                        for st_, v in s_["refresh"].items())
            + f", host syncs {s_['syncs']} measured ({s_['syncs_formula']} from the formula)")
    print(f"[6I path I] Navier-Stokes (lid-driven cavity, Re = 10): " + "; ".join(small)
          + f"; I1 {NC_I}^2/{levels_i} levels f64 (grad-div alpha 1e3, Q2/P1disc, Chebyshev(4) "
          f"over the materialized Vanka, patch prolongations, FGMRES(20) rtol 1e-8 <= 60, "
          f"Newton rtol 1e-6 atol 0, the walker at every update; counted): {n_i} Newton its (band "
          f"{I_NEWTON_ITS}), flag CONVERGED_RTOL, residuals "
          + " ".join(f"{v:.3e}" for v in hist_i[: n_i + 1])
          + f" (final / r0 {hist_i[n_i] / hist_i[0]:.3e}), centre u_x {ux:.10f} (within "
          f"{I_UX_BOUND:.2e} of {I_UX_CENTRE}); " + "; ".join(steps_txt)
          + f"; set-up {sum(run_i['setup_secs'].values()):.2f} s by step: "
          + ", ".join(f"{k} {v:.2f}" for k, v in run_i["setup_secs"].items())
          + f"; set-up host syncs {run_i['setup_syncs']} measured (PyTorch's sync debug "
          f"mode, the timing fences left out); Newton {run_i['newton_s']:.2f} s; device "
          f"memory over what the earlier paths "
          f"hold: peak {mem_gb:.2f} GiB, {kept_gb:.2f} GiB kept; every set-up and refreshed "
          f"block kept its set-up cols, row_len and group ({refreshes[0]} states); K3 "
          f"launches {launches['I f64']['K3']} by role (set-up + Newton, each equal to its "
          f"i_launches term): "
          + ", ".join(f"{r_} {counted_i['set-up'].get(r_, 0)} + {counted_i['Newton'].get(r_, 0)}"
                      for r_ in sorted(set(counted_i["set-up"]) | set(counted_i["Newton"])))
          + f"; by shape equal to the kernel's counts; K1 0, K2 0, plain launches 0 "
          f"{elapsed()}", flush=True)
    # K3 on every ELL block of I1 after its last refresh (each level's
    # Jacobian, the outer Jacobian, each level's materialized Vanka and
    # prolongation grad-div blocks, the residual's row-masked blocks, B, Bt,
    # the residual's B, Mp) against its plain version, f64 and f32
    conv, _ = prob_i._convection_elems(x_i[0], newton=False)
    i_blocks = {"A": ell_blocks(state_i["A"]), "Mp": [run_i["Mp"]],
                "res K": [prob_i._ell(prob_i.res_vals + prob_i._scatter(
                    conv, mask=prob_i.row_mask_ell))],
                "res G": [prob_i._ell(g) for row in prob_i.gd_res_vals for g in row],
                "res B": list(prob_i.res_Bs)}
    del conv
    for lv, m_ in enumerate(gst_i["mats"]):
        i_blocks[f"J{lv}"] = ell_blocks(m_)
    for lv, (s_, P_) in enumerate(zip(gst_i["pre"], gst_i["P"])):
        i_blocks[f"M{lv}"] = ell_blocks(s_["M"]["Mv"])
        i_blocks[f"G{lv}"] = ell_blocks(P_.rhs_op)
    by_role = []
    for role, bl_ in i_blocks.items():
        assert all(b.row_len is not None for b in bl_), role
        err = {dt: max(check_ell(f"K3[I {NC_I}^2 {role}.{i} {A_.nrows}x{A_.ncols}]"
                                 f"{str(dt)[6:]}", A_, vec(A_.ncols, dt), tol)
                       for i, A_ in enumerate(b.astype(dt) for b in bl_))
               for dt, tol in ((f32, F32_TOL), (f64, F64_TOL))}
        by_role.append(f"{role} {len(bl_)}x{bl_[0].nrows}x{bl_[0].ncols} K<="
                       f"{max(b.row_width for b in bl_)} f32 {err[f32]:.1e} f64 {err[f64]:.1e}")
    print(f"[6I kernels] {len(lines)} cases on path I1's blocks after its last refresh within "
          f"f32 {F32_TOL:.0e} / f64 {F64_TOL:.0e}, worst by role (blocks x rows x columns): "
          + ", ".join(by_role) + f" {elapsed()}", flush=True)
    lines.clear()
    if opts.profile is not None:  # the Newton run again from zero, on the same problem and GMG
        run_i["probe"].check = None
        summary = profile_solve(lambda: run_i["newton"].solve(prob_i, prob_i.zero_guess()),
                                opts.profile, "path_I_f64")
        print(f"[profile] path I1 Newton run (solver set-up and {n_i} steps), {card}: {summary} "
              f"{elapsed()}", flush=True)
    # the timed blocks (phase 8): level 0's Jacobian block (0,0) and its N2
    # off-diagonal block (0,1), with their launches counted in I1's run
    J0 = state_i["A"].blocks[0][0]
    i_ops = {"J0 (0,0)": J0.blocks[0][0], "J0 (0,1)": J0.blocks[0][1]}
    i_timed_launches = {"J0 (0,0)": roles.pos["J0", (0, 0)], "J0 (0,1)": roles.pos["J0", (0, 1)]}
    i_roles = {r_: {ph: counted_i[ph].get(r_, 0) for ph in counted_i}
               for r_ in sorted(set(counted_i["set-up"]) | set(counted_i["Newton"]))}
    i_shapes = {f"{r_}x{c_}": n_ for (r_, c_), n_ in sorted(roles.shapes.items())}
    del run_i, prob_i, x_i, st_i, state_i, gst_i, i_blocks, roles, J0, leaves
    torch.cuda.empty_cache()

    # ---- 6J, 6K, 6L paths J, K and L: Darcy, elasticity, the small modules
    jk = paths_jkl(dev, opts, card, elapsed, launches, check_k2, check_ell, vec, lines)

    # ---- 6M, 6N, 6O paths M, N and O: GenEO Schwarz, H(curl) + AMS, MHD
    mno = paths_mno(dev, opts, card, elapsed, launches, check_k2, check_ell, lines)

    # ---- 6P path P: block-structured AMR
    amr = paths_p(dev, opts, card, elapsed, launches, check_k2, lines)

    # ---- 6Q path Q: the distributed Poisson GMG-CG (1 NCCL rank, 2 gloo ranks)
    dq = paths_q(dev, card, elapsed, launches, check_k2, lines)

    # ---- 6R path R: the distributed Stokes flagship (1 NCCL rank, 2 gloo ranks)
    dr = paths_r(dev, card, elapsed, launches, check_ell, lines)

    # ---- 7 K3 on path C's own operators ---------------------------------
    ops = ([(f"level {i}", m) for i, m in enumerate(amg["mats"]) if i > 0]
           + [(f"P{i}", m) for i, m in enumerate(amg["P"])]
           + [(f"R{i}", m) for i, m in enumerate(amg["R"])])
    for tag, A in ops:
        assert isinstance(A, ELLMatrix) and A.dtype == torch.float32, (tag, type(A))
        x = vec(A.ncols, torch.float32)
        check_ell(f"{tag} {A.nrows}x{A.ncols} K={A.row_width} f32", A, x, F32_TOL)
        check_ell(f"{tag} bf16", A.astype(torch.bfloat16), x, F32_TOL)
    A1 = amg["mats"][1].astype(torch.float64)
    check_ell("level 1 f64", A1, vec(A1.ncols, torch.float64), F64_TOL)
    A1 = amg["mats"][1]
    check_k3("level 1 every slot f32", vec(A1.ncols, torch.float32), F32_TOL, A1.values, A1.cols,
             A1.ncols)
    print(f"[7 K3 ops] {len(lines)} cases on path C's {NC}^3 operators within f32 "
          f"{F32_TOL:.0e} / f64 {F64_TOL:.0e}: " + ", ".join(lines) + f" {elapsed()}",
          flush=True)
    del A1

    # ---- 8 times --------------------------------------------------------
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)  # 256 MB > L2

    def cold():
        flush.zero_()

    mesh = mesh_of((N1,) * 3)
    Ac = laplacian_const(mesh, torch.float32, dev)
    Ab = eliminate_dirichlet(laplacian(mesh, torch.float32, dev), mesh.boundary_vertex_mask())
    Ab64 = eliminate_dirichlet(laplacian(mesh, torch.float64, dev), mesh.boundary_vertex_mask())
    x = vec(Ac.n, torch.float32)
    a1 = (Ac.weights, Ac.free, Ac.offsets, Ac.grid_shape, x)
    per = Ab._periodic()
    # library yardsticks: cuDNN conv3d with the 27 weights (no mask
    # pass-through) for K1, cuSPARSE CSR SpMV of the same matrix (int32
    # indices; int64 beside it) for K2, K3
    w3 = torch.zeros((3, 3, 3), dtype=torch.float32, device=dev)
    for s, off in enumerate(Ac.offsets):
        w3[tuple(o + 1 for o in off)] = Ac.weights[s]
    w3 = w3.reshape(1, 1, 3, 3, 3)
    x5 = x.reshape(1, 1, N1, N1, N1)
    S_lap = to_scipy(Ab)  # explicit zeros dropped: K = 21
    csrB = csr_of(S_lap, dev, torch.float32)
    csrB64 = csr_of(S_lap, dev, torch.float32, torch.int64)
    y1 = torch.empty_like(x)
    one = torch.zeros(1, device=dev)
    t = {
        "K1 plain": median_ms(lambda: k1.const_stencil_plain(*a1)),
        "K1 library": median_ms(lambda: torch.nn.functional.conv3d(x5, w3, padding=1)),
        # yardsticks, not the same function: an elementwise kernel that moves
        # K1's bytes (x and free read, y written once), and a launch that
        # moves nothing (the span's own floor)
        "K1 same-bytes add": median_ms(lambda: torch.add(x, Ac.free.reshape(-1), out=y1)),
        "K1 same-bytes add cold": median_ms(lambda: torch.add(x, Ac.free.reshape(-1), out=y1),
                                            before=cold),
        "launch floor": median_ms(lambda: one.add_(1)),
        "K2 library": median_ms(lambda: torch.mv(csrB, x)),
        "K2 library int64": median_ms(lambda: torch.mv(csrB64, x)),
    }
    # K1: the marching kernel (the wrapper's choice) and the general kernel,
    # warm and with L2 flushed before each launch (cold, the headline: x and
    # free at 129^3 fit in L2), on the Laplacian of each path A level in f32
    # and at 129^3 in f64
    k1_keys = {}
    dt_tag = {torch.float32: "", torch.float64: " f64", torch.bfloat16: " bf16"}
    for m, dt in ([(NC // 2 ** lv + 1, torch.float32) for lv in range(4)] + [(N1, torch.float64)]
                  + [(NC // 2 ** lv + 1, torch.bfloat16) for lv in range(4)]):
        if (m, dt) == (N1, torch.float32):
            A = Ac
        else:  # bf16: the f32 operator's values rounded (path D's smoother copies)
            A = laplacian_const(mesh_of((m,) * 3), torch.float32 if dt == bf16 else dt, dev)
            A = dataclasses.replace(A, weights=A.weights.to(dt), free=A.free.to(dt))
        xa = x if A is Ac else vec(A.n, dt)
        args = (A.weights, A.free, A.offsets, A.grid_shape, xa)
        key = "K1" if A is Ac else f"K1 {m}^3{dt_tag[dt]}"
        k1_keys[key] = (m, dt, args)
        t[key] = median_ms(lambda: k1.const_stencil_cuda(*args))
        t[f"{key} cold"] = median_ms(lambda: k1.const_stencil_cuda(*args), before=cold)
        t[f"{key} general"] = median_ms(lambda: k1.const_stencil_cuda(*args, general=True))
        t[f"{key} general cold"] = median_ms(lambda: k1.const_stencil_cuda(*args, general=True),
                                             before=cold)
    # the marching kernel's run length (planes a block) at 129^3 (f32 and
    # f64) and 65^3, cold, at the rule's tile; the rule's choice is marked
    k1_bf16 = f"K1 {N1}^3 bf16"
    t[f"{k1_bf16} plain"] = median_ms(lambda: k1.const_stencil_plain(*k1_keys[k1_bf16][2]))
    x5_16, w3_16 = k1_keys[k1_bf16][2][4].reshape(1, 1, N1, N1, N1), w3.to(bf16)
    t[f"{k1_bf16} library"] = median_ms(
        lambda: torch.nn.functional.conv3d(x5_16, w3_16, padding=1))
    k1_sweep = []
    for key in ("K1", f"K1 {N1}^3 f64", f"K1 {NC // 2 + 1}^3", k1_bf16):
        m, dt, args = k1_keys[key]
        tk, groups, rule = k1.march_tiles(args[3], dt)
        ms = {p: median_ms(lambda: k1.const_stencil_cuda(*args, tiles=(tk, groups, p)),
                           before=cold)
              for p in sorted({1, 2, 4, 8, 16, 32, rule})}
        k1_sweep.append(f"{m}^3 {str(dt)[6:]} tile {groups * k1._MARCH_ROWS[dt]}x{tk}, rule {rule} "
                        f"planes: "
                        + " ".join(f"P{p}{'*' if p == rule else ''} {v:.4f}"
                                   for p, v in ms.items()))
    # K2: the box kernel (the wrapper's choice), the general kernel on the
    # same operator, and the plain version, in f32, bf16 bands and f64
    k2_args = {key: (A.bands, A.offsets, A.grid_shape, per, xx) for key, A, xx in (
        ("K2", Ab, x), ("K2 bf16", Ab.astype(torch.bfloat16), x), ("K2 f64", Ab64, x.double()))}
    for key, args in k2_args.items():
        t[key] = median_ms(lambda: k2.banded_stencil_cuda(*args))
        t[f"{key} general"] = median_ms(lambda: k2.banded_stencil_cuda(*args, general=True))
        t[f"{key} plain"] = median_ms(lambda: k2.banded_stencil_plain(*args))
    n = Ac.n
    bound = {  # K1: x, free read, y written
        **{key: 3 * args[4].element_size() * args[4].numel() / HBM_BYTES_PER_S * 1e3
           for key, (_, _, args) in k1_keys.items()},
        "K2": (27 + 2) * 4 * n / HBM_BYTES_PER_S * 1e3,     # bands, x, y
        "K2 bf16": (27 * 2 + 2 * 4) * n / HBM_BYTES_PER_S * 1e3,
        "K2 f64": (27 + 2) * 8 * n / HBM_BYTES_PER_S * 1e3,
    }
    # K3 as ELLMatrix.matvec runs it (rows read to their lengths), and the
    # same kernel reading all K slots at the lanes K gives (a matrix built
    # with no row lengths)
    Aell = ell_from_scipy(S_lap, device=dev)
    k3_ops = {"level 1": amg["mats"][1], "P0": amg["P"][0], "R0": amg["R"][0],
              f"lap {N1}^3": Aell}
    k3_x = {tag: vec(A.ncols, torch.float32) for tag, A in k3_ops.items()}
    fills = []
    for tag, A in k3_ops.items():
        xk = k3_x[tag]
        S_A = S_lap if A is Aell else to_scipy(A)
        csr = csrB if A is Aell else csr_of(S_A, dev, A.dtype)
        csr64 = csrB64 if A is Aell else csr_of(S_A, dev, A.dtype, torch.int64)
        t[f"K3 {tag}"] = median_ms(lambda: A.matvec(xk))
        t[f"K3 {tag} every slot"] = median_ms(
            lambda: k3.ell_spmv_cuda(A.values, A.cols, xk, A.ncols))
        t[f"K3 {tag} plain"] = median_ms(
            lambda: k3.ell_spmv_plain(A.values, A.cols, xk, A.row_len))
        t[f"K3 {tag} library"] = median_ms(lambda: torch.mv(csr, xk))
        t[f"K3 {tag} library int64"] = median_ms(lambda: torch.mv(csr64, xk))
        bound[f"K3 {tag}"] = ell_bound_ms(A, xk)
        real, fill, warp_fill = ell_fill(A)
        vb = A.values.element_size()
        fills.append(f"{tag} {A.nrows}x{A.ncols} K={A.row_width}: {real} entries, mean row "
                     f"{real / A.nrows:.2f}, fill {fill:.3f}, warp fill {warp_fill:.3f} at "
                     f"G={A.group}; values + cols: real {real * (vb + 4)} B, in the sectors "
                     f"read {ell_sector_bytes(A)} B, stored {A.nnz * (vb + 4)} B; CSR int32 "
                     f"values + indices + row pointers {real * (vb + 4) + 4 * (A.nrows + 1)} B")
        del csr, csr64
    del csrB, csrB64, S_lap
    # path G's operators at NC_G^2 in f32: K2's general kernel on the
    # velocity stiffness (25 bands) and pressure mass (9 bands), K3 on B and
    # Bt. The library yardstick is cuSPARSE on the assembled CSR (explicit
    # zeros dropped), which also cross-checks the kernel's y
    mesh_g = CartesianMesh((NC_G, NC_G), (0.0, 1.0, 0.0, 1.0))
    csr_g = {"K": asm.dirichlet_square(asm.assemble_bilinear(mesh_g, 2, "stiffness"),
                                       asm.boundary_node_mask(mesh_g, 2)),
             "Mp": asm.assemble_bilinear(mesh_g, 1, "mass")}
    g_keys = {}
    for name, A in stokes_ops.items():
        A = A.astype(f32)
        key = f"G {name}"
        if name in csr_g:
            S_A = csr_g[name]
            S_A.eliminate_zeros()
            xg = vec(A.n, f32)
            args = (A.bands, A.offsets, A.grid_shape, A._periodic(), xg)
            t[key] = median_ms(lambda: k2.banded_stencil_cuda(*args))
            t[f"{key} plain"] = median_ms(lambda: k2.banded_stencil_plain(*args))
            y_kernel = k2.banded_stencil_cuda(*args)
            bound[key] = (len(A.offsets) + 2) * 4 * A.n / HBM_BYTES_PER_S * 1e3
        else:
            S_A = to_scipy(A)
            xg = vec(A.ncols, f32)
            t[key] = median_ms(lambda: A.matvec(xg))
            t[f"{key} plain"] = median_ms(lambda: k3.ell_spmv_plain(A.values, A.cols, xg,
                                                                     A.row_len))
            y_kernel = A.matvec(xg)
            bound[key] = ell_bound_ms(A, xg)
        csr, csr64 = csr_of(S_A, dev, f32), csr_of(S_A, dev, f32, torch.int64)
        t[f"{key} library"] = median_ms(lambda: torch.mv(csr, xg))
        t[f"{key} library int64"] = median_ms(lambda: torch.mv(csr64, xg))
        e = relerr(y_kernel, torch.mv(csr, xg))
        assert e <= F32_TOL, f"{key}: kernel against cuSPARSE on the assembled CSR {e:.2e}"
        g_keys[key] = (f"{A.shape[0]}x{A.shape[1]}, {S_A.nnz} entries", e)
        del csr, csr64
    del csr_g
    # path H's operators at NC_H^2 in f64 (H1's dtype) and f32: K3 as the
    # path runs it, its plain version, cuSPARSE on the same real entries
    # (which also cross-checks y) and the bytes bound; K2's general kernel on
    # path H2's 25-band augmented blocks (the block engine at NC_H2^2) and on
    # the same blocks at NC_H^2
    h_keys = {}
    for name, A64 in h_ops.items():
        for dt in (f64, f32):
            A = A64.astype(dt)
            key = f"H {name} f{torch.finfo(dt).bits}"
            xh = vec(A.ncols, dt)
            t[key] = median_ms(lambda: A.matvec(xh))
            t[f"{key} plain"] = median_ms(lambda: k3.ell_spmv_plain(A.values, A.cols, xh,
                                                                     A.row_len))
            csr = ell_csr(A)
            t[f"{key} library"] = median_ms(lambda: torch.mv(csr, xh))
            bound[key] = ell_bound_ms(A, xh)
            e = relerr(A.matvec(xh), torch.mv(csr, xh))
            assert e <= (F32_TOL if dt == f32 else F64_TOL), f"{key}: kernel vs cuSPARSE {e:.2e}"
            h_keys[key] = (f"{A.nrows}x{A.ncols}, {ell_fill(A)[0]} entries, K={A.row_width}, "
                           f"G={A.group}", e)
            del csr
    h2_ops = {f"K+G {NC_H2}^2": prob_h2.K.blocks[0][0], f"G {NC_H2}^2": prob_h2.K.blocks[0][1],
              f"K+G {NC_H}^2": h_kg_banded}
    for name, A64 in h2_ops.items():
        key = f"H2 {name}"
        A = A64.astype(f64)
        xh = vec(A.n, f64)
        args = (A.bands, A.offsets, A.grid_shape, A._periodic(), xh)
        t[key] = median_ms(lambda: k2.banded_stencil_cuda(*args))
        t[f"{key} plain"] = median_ms(lambda: k2.banded_stencil_plain(*args))
        csr = ell_csr(flat_mod.flat_kernel_operator(A).kblocks[0][0])
        t[f"{key} library"] = median_ms(lambda: torch.mv(csr, xh))
        bound[key] = (len(A.offsets) + 2) * 8 * A.n / HBM_BYTES_PER_S * 1e3
        e = relerr(k2.banded_stencil_cuda(*args), torch.mv(csr, xh))
        assert e <= F64_TOL, f"{key}: kernel vs cuSPARSE {e:.2e}"
        h_keys[key] = (f"25 bands on {A.grid_shape[0]}^2, {csr._nnz()} entries", e)
        del csr
    # path I1's level-0 Jacobian blocks at NC_I^2 in f64 (I1's dtype) and
    # f32, as path H's blocks above
    i_keys = {}
    for name, A64 in i_ops.items():
        for dt in (f64, f32):
            A = A64.astype(dt)
            key = f"I {name} f{torch.finfo(dt).bits}"
            xi = vec(A.ncols, dt)
            t[key] = median_ms(lambda: A.matvec(xi))
            t[f"{key} plain"] = median_ms(lambda: k3.ell_spmv_plain(A.values, A.cols, xi,
                                                                     A.row_len))
            csr = ell_csr(A)
            t[f"{key} library"] = median_ms(lambda: torch.mv(csr, xi))
            bound[key] = ell_bound_ms(A, xi)
            e = relerr(A.matvec(xi), torch.mv(csr, xi))
            assert e <= (F32_TOL if dt == f32 else F64_TOL), f"{key}: kernel vs cuSPARSE {e:.2e}"
            real = ell_fill(A)[0]
            i_keys[key] = (f"{A.nrows}x{A.ncols}, {real} entries, mean row "
                           f"{real / A.nrows:.2f}, K={A.row_width}, G={A.group}", e)
            del csr
    # paths J and K's operators in f64, as the paths run them: K2 on J1's
    # RT1 diagonal blocks (general kernel) and Ka's (0,0) (27 offsets, box
    # kernel) and (0,2) (23 offsets, general kernel) blocks, K3 on J1's
    # cross blocks, B, Bt and -(1/alpha) Mp and on J3's RT0 blocks: warm and
    # with L2 flushed before each launch (cold), the plain version, cuSPARSE
    # CSR with int32 and int64 indices on the same real entries (which also
    # cross-checks y) and the bytes bound
    jk_keys = {}
    jk_ops = {**jk["jk_ops"], **mno["ops"], **amr["ops"], **dq["ops"], **dr["ops"]}
    j_block_launches = {**jk["j_block_launches"], **mno["op_launches"], **amr["op_launches"],
                        **dq["op_launches"], **dr["op_launches"]}
    for key, A in jk_ops.items():
        xj = vec(A.shape[1], f64)
        if isinstance(A, StencilMatrix):
            args = (A.bands, A.offsets, A.grid_shape, A._periodic(), xj)
            fn = functools.partial(k2.banded_stencil_cuda, *args)
            plain = functools.partial(k2.banded_stencil_plain, *args)
            E = flat_mod.flat_kernel_operator(A).kblocks[0][0]
            bound[key] = k2_bound_ms(A, xj)
            desc = f"{len(A.offsets)} bands on {A.grid_shape}"
        else:
            fn = functools.partial(A.matvec, xj)
            plain = functools.partial(k3.ell_spmv_plain, A.values, A.cols, xj, A.row_len)
            E = A
            bound[key] = ell_bound_ms(A, xj)
            desc = f"{A.nrows}x{A.ncols}, K={A.row_width}, G={A.group}"
        t[key] = median_ms(fn)
        t[f"{key} cold"] = median_ms(fn, before=cold)
        t[f"{key} plain"] = median_ms(plain)
        csr, csr64 = ell_csr(E), ell_csr(E, torch.int64)
        t[f"{key} library"] = median_ms(lambda: torch.mv(csr, xj))
        t[f"{key} library int64"] = median_ms(lambda: torch.mv(csr64, xj))
        e = relerr(fn(), torch.mv(csr, xj))
        assert e <= F64_TOL, f"{key}: kernel vs cuSPARSE {e:.2e}"
        jk_keys[key] = (f"{desc}, {ell_fill(E)[0]} entries", e)
        del csr, csr64, E
    # K3's lanes a row, read to row lengths and in full
    sweep = []
    for tag, A in k3_ops.items():
        xk = k3_x[tag]
        for row_len, default in ((A.row_len, A.group), (None, k3.group_size(A.row_width))):
            ms = {g: median_ms(lambda: k3.ell_spmv_cuda(A.values, A.cols, xk, A.ncols, g,
                                                        row_len))
                  for g in (1, 2, 4, 8, 16, 32)}
            sweep.append(f"{tag} {'to lengths' if row_len is not None else 'every slot'} "
                         f"(default G={default}): "
                         + " ".join(f"G{g} {v:.4f}" for g, v in ms.items()))
    for tag, info, b in (("solve A", infoA, infoA["problem"].b),
                         ("solve B", infoB, infoB["problem"].b)):
        t[tag] = median_ms(lambda: info["solver"].solve(info["state"], b), runs=20, warmup=2,
                           spin=False)
    t["solve C"] = median_ms(lambda: cgC.solve(stateC, probC.b), runs=20, warmup=2, spin=False)
    for variant, (prob, solver, state, *_) in runs_d.items():
        t[f"solve D {variant}"] = median_ms(lambda: solver.solve(state, prob.b), runs=20, warmup=2,
                                         spin=False)
    t["solve E"] = median_ms(lambda: refE.solve(stateE, probE.b), runs=20, warmup=2, spin=False)
    for tag, run in runs_g.items():
        t[f"solve {tag}"] = median_ms(lambda: run["solver"].solve(run["state"], run["prob"].b),
                                      runs=5, warmup=1, spin=False)
    t["solve H f64"] = t_solve_h
    t["solve H2"] = median_ms(
        lambda: infoh2["solver"].solve(infoh2["state"], prob_h2.b), runs=5, warmup=1, spin=False)
    for variant, (prob, solver, state, *_) in runs_f.items():
        t[f"solve F {variant}"] = median_ms(lambda: solver.solve(state, prob.b), runs=20, warmup=2,
                                         spin=False)
    print(f"[8 times] {card} | {N1}^3 stencils f32 unless said, K3 on path C's f32 operators; "
          f"median of {TIMING_RUNS} (CUDA events), ms per apply: "
          + ", ".join(f"{k} {v:.4f}" for k, v in t.items() if not k.startswith("solve"))
          + " | bound ms (bytes / 3.35 TB/s; K3 on real entries): "
          + ", ".join(f"{k} {v:.4f}" for k, v in bound.items())
          + f" | {NC}^3 solve only, median of 20: A (const f32, {stA.niter} its) "
          f"{t['solve A']:.2f} ms, B (banded f64, {stB.niter} its) {t['solve B']:.2f} ms, "
          f"C (AMG f32, {stC.niter} its) {t['solve C']:.2f} ms, D f32 twin ({itsD['f32']} its) "
          f"{t['solve D f32']:.2f} ms, D mixed ({itsD['mixed']} its) {t['solve D mixed']:.2f} ms, "
          f"E refinement ({'+'.join(map(str, itsE))} inner its) {t['solve E']:.2f} ms, F FGMRES "
          f"({runs_f['fgmres'][4].niter} its) {t['solve F fgmres']:.2f} ms, F MINRES "
          f"({runs_f['minres'][4].niter} its) {t['solve F minres']:.2f} ms {elapsed()}",
          flush=True)
    k1_levels = dict(zip(k1_keys, levelsA))  # the four f32 levels, finest first
    # path D's bf16 launches by level: 2k a V-cycle on each smoothing level
    nD = itsD["mixed"] + 1
    k1_levels_bf16 = {f"K1 {NC // 2 ** lv + 1}^3 bf16": (nD * 2 * degD if lv < 3 else 0)
                      for lv in range(4)}
    assert sum(k1_levels_bf16.values()) == bf16_launches["D mixed"]
    print(f"[8 K1] {card} | marching / general kernel, ms per apply, cold L2 / warm: "
          + "; ".join(f"{k1_keys[key][0]}^3{dt_tag[k1_keys[key][1]]} "
                      f"{t[key + ' cold']:.4f} / {t[key]:.4f} against {t[key + ' general cold']:.4f}"
                      f" / {t[key + ' general']:.4f}, bound {bound[key]:.5f}"
                      + (f", path A launches {k1_levels[key]}, launches x (cold - bound) "
                         f"{k1_levels[key] * (t[key + ' cold'] - bound[key]):.4f} / "
                         f"{k1_levels[key] * (t[key + ' general cold'] - bound[key]):.4f} ms"
                         if key in k1_levels else "")
                      + (f", path D bf16 launches {k1_levels_bf16[key]}"
                         if key in k1_levels_bf16 else "")
                      for key in k1_keys)
          + f" | bf16 at {N1}^3: plain {t[k1_bf16 + ' plain']:.4f}, conv3d bf16 (computes "
          f"less) {t[k1_bf16 + ' library']:.4f}"
          + f" | same bytes as one elementwise add, cold / warm: "
          f"{t['K1 same-bytes add cold']:.4f} / {t['K1 same-bytes add']:.4f}; "
          f"launch floor {t['launch floor']:.4f}", flush=True)
    print(f"[8 K1 run length] {card} | cold L2, ms per apply: " + "; ".join(k1_sweep),
          flush=True)
    print(f"[8 K3 fill] real entries of the stored slots, and of the slots K3's warps step "
          f"through: " + "; ".join(fills), flush=True)
    print(f"[8 K3 lanes per row] {card} | ms per apply by group size G: " + "; ".join(sweep),
          flush=True)
    print(f"[8 G] {card} | path G's {NC_G}^2 operators, f32, median of {TIMING_RUNS} (CUDA "
          f"events), ms per apply: "
          + "; ".join(f"{key} ({desc}) kernel {t[key]:.4f}, plain {t[key + ' plain']:.4f}, "
                      f"cuSPARSE int32 {t[key + ' library']:.4f} (int64 "
                      f"{t[key + ' library int64']:.4f}), bound {bound[key]:.4f}, kernel vs "
                      f"cuSPARSE y {e:.1e}" for key, (desc, e) in g_keys.items())
          + f" | {NC_G}^2 solve only, median of 5: "
          + ", ".join(f"{tag} ({runs_g[tag]['stats'].niter} its) {t['solve ' + tag]:.2f} ms"
                      for tag in runs_g) + f" {elapsed()}", flush=True)
    print(f"[8 H] {card} | path H's {NC_H}^2 operators (K3) in f64 and f32, and the "
          f"augmented banded blocks (K2's general kernel, f64), median of {TIMING_RUNS} (CUDA "
          f"events), ms per apply: "
          + "; ".join(f"{key} ({desc}) kernel {t[key]:.4f}, plain {t[key + ' plain']:.4f}, "
                      f"cuSPARSE int32 {t[key + ' library']:.4f}, bound {bound[key]:.4f}, "
                      f"kernel vs cuSPARSE y {e:.1e}" for key, (desc, e) in h_keys.items())
          + f" | solve only: H1 {NC_H}^2 f64 ({h1_its} its) median of 3 "
          f"{t['solve H f64']:.2f} ms; H2 {NC_H2}^2 ({sth2.niter} its) median of 5 "
          f"{t['solve H2']:.2f} ms {elapsed()}", flush=True)
    print(f"[8 I] {card} | path I1's level-0 Jacobian blocks at {NC_I}^2 (K3) in f64 and "
          f"f32, median of {TIMING_RUNS} (CUDA events), ms per apply: "
          + "; ".join(f"{key} ({desc}) kernel {t[key]:.4f}, plain {t[key + ' plain']:.4f}, "
                      f"cuSPARSE int32 {t[key + ' library']:.4f}, bound {bound[key]:.4f}, "
                      f"kernel vs cuSPARSE y {e:.1e}" for key, (desc, e) in i_keys.items())
          + f" {elapsed()}", flush=True)
    print(f"[8 J K] {card} | paths J1 ({NC_J}^2), J3 ({NC_J3}^2) and Ka ({NC_K}^3) operators, "
          f"f64, median of {TIMING_RUNS} (CUDA events), ms per apply: "
          + "; ".join(f"{key} ({desc}) kernel {t[key]:.4f} (cold {t[key + ' cold']:.4f}), "
                      f"plain {t[key + ' plain']:.4f}, cuSPARSE int32 {t[key + ' library']:.4f} "
                      f"(int64 {t[key + ' library int64']:.4f}), bound {bound[key]:.4f}, "
                      f"launches {j_block_launches[key]}, kernel vs cuSPARSE y {e:.1e}"
                      for key, (desc, e) in jk_keys.items()
                      if key not in mno["ops"] and key not in amr["ops"]
                      and key not in dq["ops"])
          + f" | solve only, median of 3: J1 {jk['t_solve_j']:.2f} ms, Ka {jk['t_solve_k']:.2f} ms "
          f"{elapsed()}", flush=True)
    print(f"[8 M N O] {card} | paths M1 ({NC_M[0]}x{NC_M[1]}), N1 ({NC_N}^3) and O1 ({NC_O}^3) "
          f"operators, f64, median of {TIMING_RUNS} (CUDA events), ms per apply: "
          + "; ".join(f"{key} ({desc}) kernel {t[key]:.4f} (cold {t[key + ' cold']:.4f}), "
                      f"plain {t[key + ' plain']:.4f}, cuSPARSE int32 {t[key + ' library']:.4f} "
                      f"(int64 {t[key + ' library int64']:.4f}), bound {bound[key]:.4f}, "
                      f"launches {j_block_launches[key]}, kernel vs cuSPARSE y {e:.1e}"
                      for key, (desc, e) in jk_keys.items() if key in mno["ops"])
          + " | solve only, median of 3: " + ", ".join(f"{k} {v:.2f} ms"
                                                        for k, v in mno["t_solve"].items())
          + f" {elapsed()}", flush=True)
    print(f"[8 P] {card} | path P1's operators ({NC_P}^3 base), f64, median of {TIMING_RUNS} "
          f"(CUDA events), ms per apply: "
          + "; ".join(f"{key} ({desc}) kernel {t[key]:.4f} (cold {t[key + ' cold']:.4f}), "
                      f"plain {t[key + ' plain']:.4f}, cuSPARSE int32 {t[key + ' library']:.4f} "
                      f"(int64 {t[key + ' library int64']:.4f}), bound {bound[key]:.4f}, "
                      f"launches {j_block_launches[key]}, kernel vs cuSPARSE y {e:.1e}"
                      for key, (desc, e) in jk_keys.items() if key in amr["ops"])
          + f" | P1 solve only, median of 3: {amr['t_solve']:.2f} ms {elapsed()}", flush=True)
    print(f"[8 Q] {card} | path Q2's level-0 extended blocks ({NC_Q}^3, 2 ranks), f64, median "
          f"of {TIMING_RUNS} (CUDA events), ms per apply: "
          + "; ".join(f"{key} ({desc}) kernel {t[key]:.4f} (cold {t[key + ' cold']:.4f}), "
                      f"plain {t[key + ' plain']:.4f}, cuSPARSE int32 {t[key + ' library']:.4f} "
                      f"(int64 {t[key + ' library int64']:.4f}), bound {bound[key]:.4f}, "
                      f"launches a rank {j_block_launches[key]}, kernel vs cuSPARSE y {e:.1e}"
                      for key, (desc, e) in jk_keys.items() if key in dq["ops"])
          + " | solve only (in the ranks, one run): " + ", ".join(
              f"{k} {v * 1e3:.2f} ms" for k, v in dq["t_solve"].items()) + f" {elapsed()}",
          flush=True)
    print(f"[8 R] {card} | path R2's rank-0 level-0 extended-window blocks ({NC_R}^2, 2 ranks), "
          f"f64, median of {TIMING_RUNS} (CUDA events), ms per apply: "
          + "; ".join(f"{key} ({desc}) kernel {t[key]:.4f} (cold {t[key + ' cold']:.4f}), "
                      f"plain {t[key + ' plain']:.4f}, cuSPARSE int32 {t[key + ' library']:.4f} "
                      f"(int64 {t[key + ' library int64']:.4f}), bound {bound[key]:.4f}, "
                      f"launches a rank {j_block_launches[key]}, kernel vs cuSPARSE y {e:.1e}"
                      for key, (desc, e) in jk_keys.items() if key in dr["ops"])
          + " | solve only (in the ranks, second run): " + ", ".join(
              f"{k} {v * 1e3:.2f} ms" for k, v in dr["t_solve"].items()) + f" {elapsed()}",
          flush=True)
    if opts.profile is not None:
        summary = profile_solve(lambda: cgC.solve(stateC, probC.b), opts.profile, "path_c")
        print(f"[profile] path C solve, {card}: {summary} {elapsed()}", flush=True)
        for tag, run in runs_g.items():
            summary = profile_solve(lambda: run["solver"].solve(run["state"], run["prob"].b),
                                    opts.profile, f"path_{tag.replace(' ', '_')}")
            print(f"[profile] path {tag} solve, {card}: {summary} {elapsed()}", flush=True)

    def row(key, name, source, replaces, shape_key):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(launches[p][key] for p in launches),
                "max_abs_err": worst[key], "ms": t[shape_key],
                "plain_ms": t[f"{shape_key} plain"], "bound_ms": bound[shape_key],
                "bound_by": "bytes", "library_ms": t[f"{shape_key} library"]}

    def r4(v):
        return round(v, 4)

    k2_row = row("K2", "K2 banded_stencil", "gridapsolvers_tpu_torch/csrc/banded_stencil.cu",
                 "gridapsolvers_tpu/ops/banded_pallas.py:64", "K2")
    k2_row.update({"general_ms": t["K2 general"], "library_int64_ms": t["K2 library int64"], **{
        dt: {"ms": r4(t[f"K2 {dt}"]), "general_ms": r4(t[f"K2 {dt} general"]),
             "bound_ms": r4(bound[f"K2 {dt}"])} for dt in ("bf16", "f64")}})
    k3_row = row("K3", "K3 ell_spmv", "gridapsolvers_tpu_torch/csrc/ell_spmv.cu",
                 "gridapsolvers_tpu/ops/ell_pallas.py:113", "K3 level 1")
    k3_row.update({"library_int64_ms": t["K3 level 1 library int64"], **{
        tag: {"ms": r4(t[f"K3 {tag}"]), "bound_ms": r4(bound[f"K3 {tag}"]),
              "library_ms": r4(t[f"K3 {tag} library"]),
              "library_int64_ms": r4(t[f"K3 {tag} library int64"])} for tag in ("R0", "P0")}})
    def g_entry(key, kernel, shape):
        # launches: those counted at this operand shape in path G's runs
        return {"ms": r4(t[key]), "plain_ms": r4(t[f"{key} plain"]), "bound_ms": r4(bound[key]),
                "library_ms": r4(t[f"{key} library"]),
                "library_int64_ms": r4(t[f"{key} library int64"]),
                "launches": sum(run["launches"][kernel][shape] for run in runs_g.values())}

    g0, gp = 2 * NC_G + 1, NC_G + 1
    k2_row["stokes"] = {
        f"K 25 bands {g0}^2": g_entry("G K", "K2", (25, g0, g0)),
        f"Mp 9 bands {gp}^2": g_entry("G Mp", "K2", (9, gp, gp)),
        "K 25 bands, all levels launches": sum(
            c for run in runs_g.values() for g, c in run["launches"]["K2"].items() if g[0] == 25)}
    k3_row["stokes"] = {name: g_entry(f"G {name}", "K3", g_k3[name]) for name in ("B", "Bt")}
    # path H: each timed block's launches counted in H1's run (set-up and
    # solve), every role's counted launches, and the kernel's by shape

    def h_entry(key, launches_n):
        return {"ms": r4(t[key]), "plain_ms": r4(t[f"{key} plain"]), "bound_ms": r4(bound[key]),
                "library_ms": r4(t[f"{key} library"]), "launches": launches_n}

    k3_row["stokes_graddiv"] = {
        key: h_entry(key, h_timed_launches[key[2:-4]]) for key in h_keys if key.startswith("H ")}
    k3_row["stokes_graddiv"]["launches_by_role"] = {
        role: {ph: counted[ph][role] for ph in counted} for role in blocks}
    k3_row["stokes_graddiv"]["launches_by_shape"] = {
        f"{r}x{c}": n for (r, c), n in sorted(shapes_h["K3"].items())}
    k3_row["stokes_graddiv"]["H2 launches"] = launches["H2"]["K3"]
    # path I1: each timed block's launches in its run, and every role's
    k3_row["navier_stokes"] = {key: h_entry(key, i_timed_launches[key[2:-4]]) for key in i_keys}
    k3_row["navier_stokes"]["launches_by_role"] = i_roles
    k3_row["navier_stokes"]["launches_by_shape"] = i_shapes
    k2_row["stokes_graddiv_h2"] = {
        key: h_entry(key, sum(c for g, c in shapes_h2["K2"].items()
                              if g == (25,) + h2_ops[key[3:]].grid_shape))
        for key in h_keys if key.startswith("H2 ")}
    # paths J and K: each timed operator's launches in its run, and the
    # kernel's launches by operand shape in each counted run

    def jk_entry(key):
        return {"ms": r4(t[key]), "cold_ms": r4(t[f"{key} cold"]),
                "plain_ms": r4(t[f"{key} plain"]), "bound_ms": r4(bound[key]),
                "library_ms": r4(t[f"{key} library"]),
                "library_int64_ms": r4(t[f"{key} library int64"]),
                "launches": j_block_launches[key]}

    def by_shape(counts):
        return {"x".join(map(str, s_)): n_ for s_, n_ in sorted(counts.items())}

    k2_row["darcy"] = {"J1 " + key.split(" K2 ")[1]: jk_entry(key) for key in jk_keys
                       if key.startswith("J K2")}
    k2_row["darcy"]["J1 launches_by_shape"] = by_shape(jk["shapes_j"]["K2"])
    k2_row["elasticity"] = {"Ka " + key.split(" K2 ")[1]: jk_entry(key) for key in jk_keys
                            if key.startswith("K K2")}
    k2_row["elasticity"]["Ka launches_by_shape"] = by_shape(jk["shapes_k"])
    k3_row["darcy"] = {("J3 " if key.startswith("J3") else "J1 ") + key.split(" K3 ")[1]:
                       jk_entry(key) for key in jk_keys if " K3 " in key}
    k3_row["darcy"]["J1 launches_by_shape"] = by_shape(jk["shapes_j"]["K3"])
    k3_row["darcy"]["J3 launches_by_shape"] = by_shape(jk["shapes_j3"])
    k3_row["elasticity"] = {"Kc launches": launches["Kc"]["K3"]}
    # paths M, N and O: each timed operator's launches in its run, and the
    # kernel's launches by operand shape in each counted run
    k2_row["schwarz"] = {"M1 " + key.split(" K2 ")[1]: jk_entry(key) for key in jk_keys
                         if key.startswith("M K2")}
    k2_row["schwarz"]["M1 launches_by_shape"] = by_shape(mno["shapes"]["M1"])
    k2_row["amr"] = {"P1 " + key.split(" K2 ")[1]: jk_entry(key) for key in jk_keys
                     if key.startswith("P K2")}
    k2_row["amr"]["P1 launches_by_shape"] = by_shape(amr["shapes"])
    k2_row["distributed"] = {"Q2 " + key.split(" K2 ")[1]: jk_entry(key) for key in jk_keys
                             if key.startswith("Q K2")}
    for tag, shapes_q in dq["shapes"].items():
        k2_row["distributed"][f"{tag} launches_by_shape"] = by_shape(shapes_q)
    k3_row["distributed"] = {"R2 " + key.split(" K3 ")[1]: jk_entry(key) for key in jk_keys
                             if key.startswith("R K3")}
    for tag, shapes_r in dr["shapes"].items():
        k3_row["distributed"][f"{tag} launches_by_shape"] = by_shape(shapes_r)
    for name, path in (("hcurl", "N"), ("mhd", "O")):
        k3_row[name] = {f"{path}1 " + key.split(" K3 ")[1]: jk_entry(key) for key in jk_keys
                        if key.startswith(f"{path} K3")}
        k3_row[name][f"{path}1 launches_by_shape"] = by_shape(mno["shapes"][f"{path}1"])
    k1_row = row("K1", "K1 const_stencil", "gridapsolvers_tpu_torch/csrc/const_stencil.cu",
                 "gridapsolvers_tpu/ops/stencil_pallas.py:61", "K1")
    k1_row.update({
        "cold_ms": t["K1 cold"], "general_ms": t["K1 general"],
        "general_cold_ms": t["K1 general cold"], "march_launches": marchA,
        "level_launches": {f"{k1_keys[key][0]}^3": v for key, v in k1_levels.items()},
        **{key[3:]: {"ms": t[key], "cold_ms": t[f"{key} cold"], "general_ms": t[f"{key} general"],
                     "general_cold_ms": t[f"{key} general cold"], "bound_ms": bound[key]}
           for key in k1_keys if key != "K1" and not key.endswith("bf16")}})
    k1_row["bf16"] = {
        "launches": sum(bf16_launches.values()), "max_abs_err": worst["K1 bf16"],
        "ms": t[k1_bf16], "cold_ms": t[f"{k1_bf16} cold"], "general_ms": t[f"{k1_bf16} general"],
        "general_cold_ms": t[f"{k1_bf16} general cold"], "plain_ms": t[f"{k1_bf16} plain"],
        "bound_ms": bound[k1_bf16], "bound_by": "bytes", "library_ms": t[f"{k1_bf16} library"],
        "level_launches": {key[3:-5]: v for key, v in k1_levels_bf16.items()},
        **{key[3:-5]: {"ms": t[key], "cold_ms": t[f"{key} cold"],
                       "general_ms": t[f"{key} general"],
                       "general_cold_ms": t[f"{key} general cold"], "bound_ms": bound[key]}
           for key in k1_levels_bf16 if key != k1_bf16}}
    summary = {"kernels": [
        k1_row,
        k2_row,
        k3_row,
    ]}
    print(json.dumps(summary))
    torch.cuda.synchronize()
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
