"""Weak-scaling harness and the distributed Poisson solve of one rank.

Port of `weak_scaling_poisson` (`gridapsolvers_tpu/parallel/
weak_scaling.py:29-105`, BASELINE.json config 5): constant local problem
size a rank, the global problem growing with the rank count, the GMG
hierarchy deepened by log2(p) levels to keep the coarse problem's size
(preparejobs.jl:80-105); iteration counts and times a row.

`poisson_case` is one distributed GMG-CG solve as every rank of a launch
runs it (`launch.run_ranks`); `weak_scaling_poisson` makes one launch a
rank count and collects rank 0's rows; `weak_scaling_case` runs one row
inside an existing launch, on its first ranks.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..fem import poisson_problem
from ..linear import CGSolver, ChebyshevSmoother
from ..multilevel import cartesian_hierarchy
from ..ops import banded_stencil
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
