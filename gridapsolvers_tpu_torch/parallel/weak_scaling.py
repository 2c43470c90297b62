"""Weak-scaling harness and the distributed Poisson solve of one rank.

Port of `weak_scaling_poisson` (`gridapsolvers_tpu/parallel/
weak_scaling.py:29-105`, BASELINE.json config 5): constant local problem
size a rank, the global problem growing with the rank count, the GMG
hierarchy deepened by log2(p) levels to keep the coarse problem's size
(preparejobs.jl:80-105); iteration counts and times a row.

`poisson_case` is one distributed GMG-CG solve as every rank of a launch
runs it (`launch.run_ranks`); `weak_scaling_poisson` makes one launch a
rank count and collects rank 0's rows; `weak_scaling_case` runs one row
inside an existing launch, on its first ranks. `stokes_case` is one
distributed Stokes flagship solve (`fem.dist_stokes_nd`) as every rank
runs it, with `k3_launches_formula` the K3 launches it makes, and
`stokes_serial_twin` its serial counterpart.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..fem import poisson_problem
from ..linear import CGSolver, ChebyshevSmoother
from ..multilevel import cartesian_hierarchy
from ..ops import banded_stencil, ell_spmv
from ..utils import resolve_device
from .dist import distributed_poisson_gmg, gather, shard_grid_vector, unpad_grid_vector
from .launch import rank_device, run_ranks
from .mesh import comm_counts, device_mesh, device_mesh_nd


def level_shapes(gmg, A) -> list:
    """Per GMG level, the grid its operator's K2 launch runs on (a
    sharded level's halo-extended block, a replicated level's whole grid)
    and, where the level smooths communication-avoidingly, the grid of
    its smoother's K2 launches (the block extended by the sweep's ghost
    depth); None otherwise."""
    from ..linear.gmg import _per_level
    from .halo import HaloChebyshevSmoother, HaloStencilMatrix

    mats = [A] + list(gmg.coarse_ops)
    smoothers = _per_level(gmg.smoother, len(mats) - 1) + [None]
    out = []
    for op, sm in zip(mats, smoothers):
        grid = (tuple(op.bands_ext.shape[1:]) if isinstance(op, HaloStencilMatrix)
                else tuple(op.grid_shape))
        ca = None
        if isinstance(sm, HaloChebyshevSmoother):
            block = op.layout.block_shape
            ca = (block[0] + 2 * sm._width(op),) + tuple(block[1:])
        out.append((grid, ca))
    return out


def k2_launches_formula(niter: int, shapes: list, degree: int) -> dict:
    """K2 launches of one GMG-CG solve of `niter` iterations by operand
    shape (27, *grid) (the Q1 Laplacian's 27 offsets), from the code: CG
    applies A once before its loop and once an iteration, and the V-cycle
    once before the loop and once an iteration (n + 1 each); a V-cycle
    smooths each level but the
    coarsest twice with `degree` applies (on the ghost-extended grid
    where it smooths communication-avoidingly) and applies the level's
    operator once to update the residual; the coarsest level applies its
    operator once after its direct solve."""
    n1 = niter + 1
    out = {}

    def add(grid, k):
        key = (27,) + tuple(grid)
        out[key] = out.get(key, 0) + k

    add(shapes[0][0], n1)
    for grid, ca in shapes[:-1]:
        add(grid, n1)
        add(ca or grid, n1 * 2 * degree)
    add(shapes[-1][0], n1)
    return out


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def poisson_case(ncells: Tuple[int, ...], levels: int, layout: Tuple[int, ...], *,
                 dtype=torch.float64, rtol: float = 1e-6, maxiter: int = 25,
                 smoother: Optional[dict] = None, device=None, return_x: bool = False,
                 runs: int = 2) -> Optional[Dict]:
    """Distributed GMG-CG on the Q1 Poisson problem of `ncells` with a
    `levels`-level hierarchy, over the first prod(layout) ranks: a 1-tuple
    layout is a slab partition over mesh axis "p", a longer one a box
    partition over ("px", "py", ...). Every rank of the world calls it;
    non-members return None. `smoother` holds ChebyshevSmoother's
    arguments (default degree 3). The solve runs `runs` times (the first
    loads the kernels); the last is timed and counted: its K2 launches by
    extended block shape, plain K2 launches, and this rank's messages
    (`mesh.comm_counts`). With `return_x`, rank 0 also returns the
    solution on the unpadded grid."""
    dev = resolve_device(device if device is not None else rank_device())
    layout = tuple(int(p) for p in layout)
    mesh = (device_mesh(layout[0], device=dev) if len(layout) == 1
            else device_mesh_nd(layout, device=dev))
    if not mesh.member:
        return None
    axis = "p" if len(layout) == 1 else None
    t0 = time.perf_counter()
    prob = poisson_problem(tuple(ncells), dtype=dtype, device=dev)
    hierarchy = cartesian_hierarchy(tuple(ncells), levels)
    gmg, Ad = distributed_poisson_gmg(
        hierarchy, mesh, smoother=ChebyshevSmoother(**({"degree": 3} | (smoother or {}))),
        axis=axis, dtype=dtype, device=dev)
    solver = CGSolver(Pl=gmg, rtol=rtol, maxiter=maxiter)
    bd = shard_grid_vector(prob.b, mesh, prob.A.grid_shape, axis=axis,
                           target_shape=Ad.grid_shape)
    state = solver.setup(Ad)
    _sync(dev)
    setup_s = time.perf_counter() - t0
    for i in range(runs):
        if i == runs - 1:
            banded_stencil.counts.reset()
            comm_counts.reset()
            _sync(dev)
            t0 = time.perf_counter()
        x, stats = solver.solve(state, bd)
    _sync(dev)
    solve_s = time.perf_counter() - t0
    row = dict(
        devices=mesh.size, layout=layout, ncells=tuple(ncells), dofs=prob.A.n,
        padded=tuple(Ad.grid_shape), levels=levels, iters=int(stats.niter),
        flag=int(stats.flag), time_s=solve_s, setup_s=setup_s,
        time_per_iter=solve_s / max(int(stats.niter), 1),
        history=stats.residuals[: int(stats.niter) + 1].cpu().numpy(),
        k2_shapes=dict(banded_stencil.counts.shapes), k2_launches=banded_stencil.counts.kernel,
        k2_plain=banded_stencil.counts.plain, comm=comm_counts.as_dict(),
        transport=mesh.transport, rank=mesh.rank, block=tuple(Ad.layout.block_shape),
        level_shapes=level_shapes(gmg, Ad),
    )
    if return_x:
        xg = unpad_grid_vector(gather(x), prob.A.grid_shape)
        if mesh.rank == 0:
            row["x"] = xg.reshape(-1).cpu().numpy()
    return row


def _levels(p_total: int, base_levels: int) -> int:
    return base_levels + int(np.log2(p_total))


def _scaled(local_cells, layout):
    return tuple(local_cells[d] * (layout[d] if d < len(layout) else 1)
                 for d in range(len(local_cells)))


def weak_scaling_case(local_cells, p, base_levels: int = 3, rtol: float = 1e-6,
                      maxiter: int = 25, dtype=torch.float64, device=None) -> Optional[Dict]:
    """One row of `weak_scaling_poisson` on the first ranks of the
    running launch (every rank calls it; non-members return None). `p` is
    a rank count (slab partition) or a tuple (box partition)."""
    layout = tuple(p) if isinstance(p, tuple) else (int(p),)
    p_total = int(np.prod(layout))
    return poisson_case(_scaled(local_cells, layout), _levels(p_total, base_levels), layout,
                        dtype=dtype, rtol=rtol, maxiter=maxiter, device=device)


def weak_scaling_poisson(
    local_cells: Tuple[int, int, int] = (16, 16, 16),
    device_counts: Sequence = (1, 2, 4, 8),
    base_levels: int = 3,
    rtol: float = 1e-6,
    maxiter: int = 25,
    dtype=torch.float64,
    device=None,
    timeout: float = 600.0,
) -> List[Dict]:
    """Scale the domain with the rank count and deepen the hierarchy by
    log2(p) levels so the coarse grid stays about constant; one
    `run_ranks` launch a rank count, on the card unless `device="cpu"`.
    `device_counts` entries are ints (slab partition, x extent scaled) or
    tuples (box partition, each extent scaled by its axis count). Rows
    have the JAX package's keys, plus this port's counts."""
    results = []
    for p in device_counts:
        p_total = int(np.prod(p)) if isinstance(p, tuple) else int(p)
        rows = run_ranks(weak_scaling_case, p_total,
                         (local_cells, p, base_levels, rtol, maxiter, dtype),
                         device=device, timeout=timeout)
        results.append(rows[0])
    base = results[0]["time_per_iter"]
    for r in results:
        r["efficiency"] = base / r["time_per_iter"]
    return results


# -- the distributed Stokes flagship -------------------------------------------

@dataclasses.dataclass(frozen=True)
class _CountedCG:
    """The flagship's pressure-mass CG, recording the iterations of each
    solve in `its` (a list it shares with the caller)."""

    inner: object
    its: list

    def setup(self, A, x=None):
        return self.inner.setup(A, x)

    def update(self, state, A, x=None):
        return self.inner.update(state, A, x)

    def solve(self, state, b, x0=None):
        x, stats = self.inner.solve(state, b, x0)
        self.its.append(int(stats.niter))
        return x, stats

    def apply(self, state, r):
        return self.solve(state, r)[0]


def k3_shape(op) -> Tuple[int, int]:
    """The (rows, columns) of the K3 launch an operator makes: a
    `DistGraphELL`'s local rows by its window, the rank's rows of a
    `ShardedRows` by the whole coarse vector, a `GatheredColumns`' and an
    `ELLMatrix`'s own shape."""
    from ..algebra.ell import ELLMatrix
    from .dist_ell_nd import DistGraphELL, GatheredColumns, ShardedRows

    if isinstance(op, (DistGraphELL, ShardedRows)):
        return tuple(op.local.shape)
    if isinstance(op, GatheredColumns):
        return tuple(op.op.shape)
    if isinstance(op, ELLMatrix):
        return tuple(op.shape)
    raise TypeError(f"no K3 operand in {type(op).__name__}")


def stokes_operand_shapes(A, gmg, Mp) -> dict:
    """K3 operand shapes of the flagship's operators on this rank: the
    system's K, Bᵀ and B blocks (a field each), the pressure mass, and
    per GMG level its operator (level 0 is the system's K) and transfer."""
    dim = len(A.block(0, 0).ops)
    return {
        "dim": dim,
        "BT": [k3_shape(op) for op in A.block(0, 1).ops],
        "B": [k3_shape(op) for op in A.block(1, 0).ops],
        "Mp": k3_shape(Mp),
        "K": [k3_shape(A.block(0, 0).ops[0])] + [k3_shape(op.ops[0]) for op in gmg.coarse_ops],
        "P": [k3_shape(t.ops[0]) for t in gmg.prolongations],
        "R": [k3_shape(t.ops[0]) for t in gmg.restrictions],
    }


def k3_launches_formula(niter: int, cg_its: Sequence[int], shapes: dict, m: int = 30,
                        degree: int = 3) -> dict:
    """K3 launches of one flagship FGMRES(m) solve of `niter` iterations
    by operand shape, from the code:

    - FGMRES applies the block operator once before its loop, once at the
      start of each restart cycle (ceil(niter / m) of them) and once an
      iteration; a block apply is dim K, dim Bᵀ and dim B launches;
    - the preconditioner, once an iteration, runs the pressure-mass CG
      (one apply before its loop and one an iteration: cg_its[i] + 1),
      applies Bᵀ (dim) and one GMG V-cycle;
    - the V-cycle smooths each level but the coarsest twice with `degree`
      applies, updates the level's residual once after the coarse
      correction and restricts and prolongs once, every one of them dim
      launches (one a field); the coarsest level applies its operator
      once after its direct solve."""
    dim = shapes["dim"]
    out: Dict[Tuple[int, int], int] = {}

    def add(shape, k):
        key = tuple(shape)
        out[key] = out.get(key, 0) + k

    applies = 1 + math.ceil(niter / m) + niter
    add(shapes["K"][0], dim * applies)
    for bt, b in zip(shapes["BT"], shapes["B"]):
        add(bt, applies + niter)
        add(b, applies)
    add(shapes["Mp"], niter + sum(cg_its))
    for K, P, R in zip(shapes["K"][:-1], shapes["P"], shapes["R"]):
        add(K, niter * dim * (2 * degree + 1))
        add(P, niter * dim)
        add(R, niter * dim)
    add(shapes["K"][-1], niter * dim)
    return {k: v for k, v in out.items() if v}


# the flagship's FGMRES tolerance (the JAX signature's default)
STOKES_RTOL = 1e-8


def stokes_serial_twin(ncells: Tuple[int, ...], levels: int, *, maxiter: int = 60,
                       device=None) -> Dict:
    """The flagship's serial twin in this process, in f64: the same
    FGMRES(30) and upper block-triangular preconditioner over
    `fem.stokes.velocity_gmg` (banded K2 levels with linear node-grid
    transfers, where the flagship has exact Q2 FE embeddings) and
    Jacobi-CG on prob.Mp, as `tests/test_dist_stokes.py:185-207` builds
    it. Returns its iterations, flag, ((u_x, ...), p) on the host, their
    L2 errors and the pressure CG's iterations."""
    from ..blocks import BlockTriangularSolver, LinearSystemBlock, MatrixBlock
    from ..fem.stokes import stokes_problem, velocity_gmg
    from ..linear import FGMRESSolver, JacobiSolver

    dev, dtype = resolve_device(device), torch.float64
    cg_its: list = []
    prob = stokes_problem(tuple(ncells), dtype=dtype, device=dev)
    prec = BlockTriangularSolver(
        solvers=(velocity_gmg(tuple(ncells), levels, dtype=dtype, device=dev),
                 _CountedCG(CGSolver(Pl=JacobiSolver(), rtol=1e-8, maxiter=40), cg_its)),
        blocks=((LinearSystemBlock(), None), (None, MatrixBlock(prob.Mp))), half="upper")
    solver = FGMRESSolver(m=30, Pr=prec, rtol=STOKES_RTOL, maxiter=maxiter)
    x, stats = solver.solve(solver.setup(prob.A), prob.b)
    return {"iters": int(stats.niter), "flag": int(stats.flag),
            "u": tuple(c.cpu().numpy() for c in x[0]), "p": x[1].cpu().numpy(),
            "velocity_error": prob.velocity_error(x[0]), "pressure_error": prob.pressure_error(x[1]),
            "cg_its": cg_its}


def stokes_case(ncells: Tuple[int, ...], levels: int, layout: Tuple[int, ...], *,
                one_axis: bool = False, maxiter: int = 60, device=None,
                return_blocks: bool = False, runs: int = 2) -> Optional[Dict]:
    """The distributed Stokes flagship (FGMRES(30) + upper block-triangular
    velocity GMG and pressure-mass Jacobi-CG) on `ncells` with `levels`
    GMG levels in f64 over the first prod(layout) ranks, through
    `fem.dist_stokes_nd` (or, `one_axis`, the 1-D spelling of
    `fem.dist_stokes` over a (p,) layout). Every rank of the world calls
    it; non-members return None. The solve runs `runs` times (the first
    loads the kernels); the last is timed and counted: its K3 launches by
    operand shape, plain K3 launches, this rank's messages, and the
    pressure CG's iterations an FGMRES iteration. Rank 0 also returns
    ((u_x, u_y, ...), p) in global dof order and their L2 errors against
    the manufactured solution; with `return_blocks`, the local ELLs of its
    K, B and Bᵀ blocks (first field), each as the arrays of an `ELLMatrix`
    (values, cols, ncols, row_len, group)."""
    from ..fem import dist_stokes, dist_stokes_nd

    dev = resolve_device(device if device is not None else rank_device())
    dtype = torch.float64
    layout = tuple(int(p) for p in layout)
    mesh = (device_mesh(layout[0], device=dev) if len(layout) == 1
            else device_mesh_nd(layout, device=dev))
    if not mesh.member:
        return None
    t0 = time.perf_counter()
    if one_axis:
        assert len(layout) == 1, layout
        prob, A, b, pv, pq = dist_stokes.distributed_stokes_system(ncells, mesh, dtype=dtype,
                                                                   device=dev)
        solver, gmg = dist_stokes.distributed_stokes_solver(ncells, levels, mesh, rtol=STOKES_RTOL,
                                                            maxiter=maxiter, dtype=dtype,
                                                            device=dev)
    else:
        prob, A, b, pv, pq = dist_stokes_nd.distributed_stokes_system_nd(
            ncells, mesh, layout, dtype=dtype, device=dev)
        solver, gmg = dist_stokes_nd.distributed_stokes_solver_nd(
            ncells, levels, mesh, layout, rtol=STOKES_RTOL, maxiter=maxiter, dtype=dtype,
            device=dev)
    cg_its: list = []
    prec = solver.Pr
    solver = dataclasses.replace(solver, Pr=dataclasses.replace(
        prec, solvers=(prec.solvers[0], _CountedCG(prec.solvers[1], cg_its))))
    Mp = prec.blocks[1][1].op
    state = solver.setup(A)
    _sync(dev)
    setup_s = time.perf_counter() - t0
    for i in range(runs):
        if i == runs - 1:
            ell_spmv.counts.reset()
            comm_counts.reset()
            cg_its.clear()
            _sync(dev)
            t0 = time.perf_counter()
        x, stats = solver.solve(state, b)
    _sync(dev)
    solve_s = time.perf_counter() - t0
    niter = int(stats.niter)
    row = dict(
        devices=mesh.size, layout=layout, ncells=tuple(ncells), levels=levels,
        dofs=pv.n * len(ncells) + pq.n, padded=(pv.n_pad, pq.n_pad), iters=niter,
        flag=int(stats.flag), time_s=solve_s, setup_s=setup_s,
        time_per_iter=solve_s / max(niter, 1),
        history=stats.residuals[: niter + 1].cpu().numpy(),
        k3_shapes=dict(ell_spmv.counts.shapes), k3_launches=ell_spmv.counts.kernel,
        k3_plain=ell_spmv.counts.plain, comm=comm_counts.as_dict(), cg_its=list(cg_its),
        transport=mesh.transport, rank=mesh.rank, m=solver.m,
        operand_shapes=stokes_operand_shapes(A, gmg, Mp),
        sharded_levels=[isinstance(op.ops[0], type(A.block(0, 0).ops[0]))
                        for op in [A.block(0, 0)] + list(gmg.coarse_ops)],
    )
    if return_blocks:
        row["blocks"] = {
            name: (op.values, op.cols, op.ncols, op.row_len, op.group)
            for name, op in (("K", A.block(0, 0).ops[0].local), ("B", A.block(1, 0).ops[0].local),
                             ("BT", A.block(0, 1).ops[0].local))}
    u, p = dist_stokes_nd.unshard_stokes_solution_nd(x, ncells, pv.mesh_shape, pv.n, pq.n)
    if mesh.rank == 0:
        row["u"], row["p"] = u, p
        vec = lambda a: torch.from_numpy(a).to(dev, dtype)  # noqa: E731
        row["velocity_error"] = prob.velocity_error(tuple(vec(c) for c in u))
        row["pressure_error"] = prob.pressure_error(vec(p))
    return row
