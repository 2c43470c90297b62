"""Distributed Stokes over multi-axis process meshes (box partitions).

Port of the plain half of `gridapsolvers_tpu/fem/dist_stokes_nd.py`: the
flagship configuration, FGMRES + upper block-triangular preconditioning
with velocity GMG and pressure-mass Jacobi-CG (the reference's
joss_paper/scalability/src/stokes_gmg.jl), over a D-dimensional process
grid (np = (px, py) boxes).

Every coupling block is a `parallel.dist_ell_nd.DistGraphELL` over box
partitions of its field's own node grid (velocity Q2 nodes, pressure Q1
nodes) on the same process grid, so velocity and pressure boxes cover the
same region and every coupling and FE-embedding transfer exchanges ghosts
with single-hop neighbour offsets; each local apply is kernel K3.

Coarse GMG levels are replicated below `min_sharded_rows` node rows a
rank an axis. Where a sharded level meets a replicated one, the JAX
package applies a replicated `scipy_in_part_order` ELL to a sharded array
and lets XLA move the data; here the moves are explicit: the prolongation
computes only the rank's own rows of P from the replicated coarse vector
(`ShardedRows`, no message), and the restriction all-gathers the fine
vector and applies the whole R on every rank (`GatheredColumns`).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..algebra.block import BlockOperator, ColumnStack, FieldwiseOperator, RowStack
from ..algebra.convert import to_scipy
from ..algebra.ell import ell_from_scipy
from ..multilevel.hierarchy import cartesian_hierarchy
from ..multilevel.multifield import MultiFieldTransfer
from ..parallel.dist_ell_nd import (
    BoxPartition,
    box_partition,
    gathered_columns,
    mesh_device,
    shard_csr_nd,
    shard_vector_nd,
    sharded_rows,
    unshard_vector_nd,
)
from ..parallel.mesh import ProcessMesh
from . import assembly2 as asm
from .mesh import CartesianMesh
from .stokes import stokes_problem


def _unit_mesh(ncells) -> CartesianMesh:
    dim = len(ncells)
    domain = tuple(x for _ in range(dim) for x in (0.0, 1.0))
    return CartesianMesh(tuple(ncells), domain)


def stokes_partitions_nd(ncells, mesh_shape: Sequence[int]) -> Tuple[BoxPartition, BoxPartition]:
    """Box partitions of the velocity (Q2 node) and pressure (Q1 node)
    grids over the same process grid: aligned spatial footprints."""
    vshape = tuple(2 * n + 1 for n in ncells)
    pshape = tuple(n + 1 for n in ncells)
    return box_partition(vshape, mesh_shape), box_partition(pshape, mesh_shape)


def distributed_stokes_system_nd(ncells, mesh: ProcessMesh, mesh_shape: Sequence[int],
                                 nu: float = 1.0, dtype=torch.float64, device=None):
    """Serially assembled Stokes problem sharded over a multi-axis process
    grid. Returns (prob, A_dist, b_dist, part_v, part_p); `prob` is whole
    on every rank. Every member rank of the mesh calls it."""
    dev = mesh_device(mesh, device)
    dim = len(ncells)
    prob = stokes_problem(ncells, nu=nu, dtype=dtype, device=dev)
    pv, pq = stokes_partitions_nd(ncells, mesh_shape)

    # one sharded operator for every component (the JAX package shards the
    # same matrix once a component)
    Kd1 = shard_csr_nd(to_scipy(prob.A.block(0, 0).ops[0]), pv, mesh, identity_pad=True,
                       dtype=dtype, device=dev)
    Kd = FieldwiseOperator(tuple(Kd1 for _ in range(dim)))
    BTd, Bd = [], []
    for c in range(dim):
        BT_c = to_scipy(prob.A.block(0, 1).ops[c])
        B_c = to_scipy(prob.A.block(1, 0).ops[c])
        BTd.append(shard_csr_nd(BT_c, pv, mesh, part_cols=pq, dtype=dtype, device=dev))
        Bd.append(shard_csr_nd(B_c, pq, mesh, part_cols=pv, dtype=dtype, device=dev))
    A_dist = BlockOperator(((Kd, ColumnStack(tuple(BTd))), (RowStack(tuple(Bd)), None)))
    b_dist = (
        tuple(shard_vector_nd(bc, pv, mesh, dtype=dtype, device=dev) for bc in prob.b[0]),
        shard_vector_nd(prob.b[1], pq, mesh, dtype=dtype, device=dev),
    )
    return prob, A_dist, b_dist, pv, pq


def dist_velocity_gmg_nd(ncells, num_levels: int, mesh: ProcessMesh, mesh_shape: Sequence[int],
                         nu: float = 1.0, smoother=None, min_sharded_rows: int = 2,
                         dtype=torch.float64, device=None, **kw):
    """Velocity-block GMG on box-partitioned levels: per-level Q2 vector
    stiffness as `DistGraphELL` components, exact Q2 FE-embedding
    transfers as rectangular `DistGraphELL` between the levels' box
    partitions, coarse levels replicated below `min_sharded_rows` node
    rows a rank an axis. Returns (gmg, parts), parts[l] None where level
    l is replicated."""
    from ..linear.gmg import GMGSolver
    from ..linear.smoothers import ChebyshevSmoother
    from ..multilevel.transfer import fe_grid_interpolation

    dev = mesh_device(mesh, device)
    dim = len(ncells)
    mesh_shape = tuple(mesh_shape)
    hierarchy = cartesian_hierarchy(ncells, num_levels)

    def vshape(lev_mesh):
        return asm.node_grid_shape(lev_mesh, 2)

    def is_sharded(lev_mesh, lev):
        return lev < num_levels - 1 and all(
            s >= min_sharded_rows * p for s, p in zip(vshape(lev_mesh), mesh_shape))

    # level 0's operator is the one passed to setup: only its partition
    # is needed here (the JAX package assembles and shards it unused)
    parts, ops = [], []
    for lev, lev_mesh in enumerate(hierarchy.meshes):
        part = box_partition(vshape(lev_mesh), mesh_shape) if is_sharded(lev_mesh, lev) else None
        parts.append(part)
        if lev == 0:
            continue
        m = asm.boundary_node_mask(lev_mesh, 2)
        Kc = asm.dirichlet_square(asm.assemble_bilinear(lev_mesh, 2, "stiffness", scale=nu), m)
        if part is not None:
            K1 = shard_csr_nd(Kc, part, mesh, identity_pad=True, dtype=dtype, device=dev)
        else:
            K1 = ell_from_scipy(Kc, dtype=dtype, device=dev)
        ops.append(FieldwiseOperator(tuple(K1 for _ in range(dim))))

    prolongs, restricts = [], []
    for lev in range(num_levels - 1):
        fine, coarse = hierarchy[lev], hierarchy[lev + 1]
        Pcsr = fe_grid_interpolation(coarse.ncells, 2)
        Pcsr = asm.zero_rows(Pcsr, asm.boundary_node_mask(fine, 2))
        Pcsr = asm.zero_columns(Pcsr, asm.boundary_node_mask(coarse, 2))
        Pcsr.eliminate_zeros()
        Rcsr = Pcsr.T.tocsr()
        pf, pc = parts[lev], parts[lev + 1]
        if pf is not None and pc is not None:
            Pop = shard_csr_nd(Pcsr, pf, mesh, part_cols=pc, dtype=dtype, device=dev)
            Rop = shard_csr_nd(Rcsr, pc, mesh, part_cols=pf, dtype=dtype, device=dev)
        elif pf is not None:
            Pop = sharded_rows(Pcsr, pf, mesh, dtype=dtype, device=dev)
            Rop = gathered_columns(Rcsr, pf, mesh, dtype=dtype, device=dev)
        else:
            Pop = ell_from_scipy(Pcsr, dtype=dtype, device=dev)
            Rop = ell_from_scipy(Rcsr, dtype=dtype, device=dev)
        prolongs.append(MultiFieldTransfer(tuple(Pop for _ in range(dim))))
        restricts.append(MultiFieldTransfer(tuple(Rop for _ in range(dim))))

    return GMGSolver(
        coarse_ops=tuple(ops),
        prolongations=tuple(prolongs),
        restrictions=tuple(restricts),
        smoother=smoother or ChebyshevSmoother(degree=3),
        **kw,
    ), parts


def dist_pressure_mass_nd(ncells, mesh: ProcessMesh, mesh_shape: Sequence[int],
                          dtype=torch.float64, device=None):
    """Sharded Q1 pressure mass matrix on the pressure box partition."""
    Mp = asm.assemble_bilinear(_unit_mesh(ncells), 1, "mass")
    _, pq = stokes_partitions_nd(ncells, mesh_shape)
    return shard_csr_nd(Mp, pq, mesh, identity_pad=True, dtype=dtype,
                        device=mesh_device(mesh, device))


def distributed_stokes_solver_nd(ncells, num_levels: int, mesh: ProcessMesh,
                                 mesh_shape: Sequence[int], nu: float = 1.0, rtol: float = 1e-8,
                                 maxiter: int = 60, gmg_kw: Optional[dict] = None,
                                 dtype=torch.float64, device=None):
    """The flagship configuration on a multi-axis process grid. Returns
    (solver, gmg): call solver.setup(A_dist) with the system from
    `distributed_stokes_system_nd`."""
    from ..blocks import BlockTriangularSolver, LinearSystemBlock, MatrixBlock
    from ..linear import CGSolver, FGMRESSolver, JacobiSolver

    gmg, _ = dist_velocity_gmg_nd(ncells, num_levels, mesh, mesh_shape, nu=nu, dtype=dtype,
                                  device=device, **(gmg_kw or {}))
    Mp_dist = dist_pressure_mass_nd(ncells, mesh, mesh_shape, dtype=dtype, device=device)
    prec = BlockTriangularSolver(
        solvers=(gmg, CGSolver(Pl=JacobiSolver(), rtol=1e-8, maxiter=40)),
        blocks=((LinearSystemBlock(), None), (None, MatrixBlock(Mp_dist))),
        half="upper",
    )
    solver = FGMRESSolver(m=30, Pr=prec, rtol=rtol, maxiter=maxiter)
    return solver, gmg


def unshard_stokes_solution_nd(x, ncells, mesh_shape, n_u: int, n_p: int,
                               pressure: str = "q1"):
    """Sharded block solution -> host ((u_x, u_y, ...), p) in global dof
    order (unpadded). Gathers over the ranks: every member calls it. Only
    the Taylor-Hood pressure ('q1') is ported."""
    if pressure != "q1":
        raise NotImplementedError(f"pressure {pressure!r}: the grad-div half of the "
                                  "distributed Stokes slice is not ported")
    pv, pq = stokes_partitions_nd(ncells, mesh_shape)
    u = tuple(unshard_vector_nd(uc, pv, n_u) for uc in x[0])
    return u, unshard_vector_nd(x[1], pq, n_p)
