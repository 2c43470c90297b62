"""Rank functions of `tests/test_torch_distributed.py`.

Each runs on every rank of one `run_ranks` launch of 4 gloo ranks on the
CPU; the 2-rank and (2, 2) cases run on meshes of the first ranks (every
rank builds each mesh; the others skip its case). This module imports
torch and the port only: a rank never imports a test module or JAX.
Inputs and results are numpy arrays: the whole padded arrays the JAX
package holds go in, and each rank sends back its blocks.
"""
import torch
import torch.distributed as dist

from gridapsolvers_tpu_torch import convert
from gridapsolvers_tpu_torch.fem import CartesianMesh
from gridapsolvers_tpu_torch.fem.assembly import eliminate_dirichlet, laplacian
from gridapsolvers_tpu_torch.interfaces.nullspaces import NullSpace
from gridapsolvers_tpu_torch.linear import CGSolver, ChebyshevSmoother, GMGSolver
from gridapsolvers_tpu_torch.linear.smoothers import estimate_dinv_a_lmax
from gridapsolvers_tpu_torch.linear.wrappers import NullspaceSolver
from gridapsolvers_tpu_torch.multilevel import cartesian_hierarchy, setup_transfer_operators
from gridapsolvers_tpu_torch.parallel import (
    Resharded,
    device_mesh,
    device_mesh_nd,
    distributed_poisson_gmg,
    shard_grid_vector,
    shard_stencil,
)
from gridapsolvers_tpu_torch.parallel.dist import P, gather, unpad_grid_vector
from gridapsolvers_tpu_torch.parallel.halo import HaloChebyshevSmoother, HaloStencilMatrix
from gridapsolvers_tpu_torch.parallel.weak_scaling import poisson_case, weak_scaling_case
from gridapsolvers_tpu_torch.utils import pytrees as pt
from gridapsolvers_tpu_torch.utils.pytrees import Sharded

torch.set_num_threads(1)


def _mesh(layout):
    return device_mesh(layout[0]) if len(layout) == 1 else device_mesh_nd(layout)


def _axis(layout):
    return "p" if len(layout) == 1 else None


def _block(mesh, a, lead=0):
    return convert.shard_from_jax(a, mesh.devices_shape, mesh.coords, lead=lead, device="cpu")


def _q1_dirichlet(ncells, periodic=None):
    m = CartesianMesh(tuple(ncells), tuple(x for _ in ncells for x in (0.0, 1.0)), periodic)
    return eliminate_dirichlet(laplacian(m, torch.float64, "cpu"), m.boundary_vertex_mask())


class _Identity:
    def matvec(self, x):
        return x


def halo_cases(cases, transfer, smooth, roundtrip):
    """The halo matvec cases (JAX's padded bands and x in), the nested
    transfers, one CA Chebyshev sweep beside the per-matvec sweep, and a
    sharded -> whole -> sharded round trip. Returns this rank's blocks."""
    out = {"matvec": {}, "shapes": {}}
    for i, c in enumerate(cases):
        mesh = _mesh(c["layout"])
        if not mesh.member:
            continue
        # the port's own padding of the same operator
        own = shard_stencil(_q1_dirichlet(c["ncells"], c["periodic"]), mesh, _axis(c["layout"]))
        out["shapes"][i] = (tuple(own.grid_shape), tuple(own.layout.block_shape))
        own_bands_equal = bool(torch.equal(own.bands, _block(mesh, c["bands"], lead=1)))
        A = HaloStencilMatrix.from_blocks(_block(mesh, c["bands"], lead=1), c["offsets"],
                                          c["bands"].shape[1:], c["periodic"], mesh,
                                          own.axes)
        y = A.matvec(Sharded(_block(mesh, c["x"]), A.layout))
        out["matvec"][i] = (y.local.numpy(), own_bands_equal)

    mesh = device_mesh(4)
    gmg, Ad = distributed_poisson_gmg(cartesian_hierarchy(transfer["ncells"], 3), mesh,
                                      smoother=ChebyshevSmoother(degree=3))
    Pop, Rop = gmg.prolongations[0], gmg.restrictions[0]
    out["transfer_types"] = (type(Pop).__name__, type(Rop).__name__)
    xc = Sharded(_block(mesh, transfer["xc"]), Pop.coarse_layout)
    xf = Sharded(_block(mesh, transfer["xf"]), Rop.fine_layout)
    out["P"] = Pop.matvec(xc).local.numpy()
    out["R"] = Rop.matvec(xf).local.numpy()

    ca = HaloChebyshevSmoother(degree=3)
    plain = ChebyshevSmoother(degree=3, eig_method=ca.eig_method)
    x0 = Sharded(_block(mesh, smooth["x"]), Ad.layout)
    r0 = Sharded(_block(mesh, smooth["r"]), Ad.layout)
    st = ca.setup(Ad)
    out["lanczos"] = float(estimate_dinv_a_lmax(Ad, pt.tree_map(lambda d: 1.0 / d, Ad.diag())))
    out["ca"] = [v.local.numpy() for v in ca.smooth(st, x0, r0)]
    out["per_matvec"] = [v.local.numpy() for v in plain.smooth(plain.setup(Ad), x0, r0)]
    out["lmax"] = (st["lmax"], plain.setup(Ad)["lmax"])

    x = torch.from_numpy(roundtrip["x"])
    xd = shard_grid_vector(x, mesh, roundtrip["shape"])
    whole = Resharded(_Identity(), P(), mesh).matvec(xd)
    back = Resharded(_Identity(), P("p", None, None), mesh).matvec(whole)
    out["roundtrip"] = (bool(torch.equal(back.local, xd.local)),
                        bool(torch.equal(unpad_grid_vector(whole, roundtrip["shape"]),
                                         x.reshape(roundtrip["shape"]))),
                        back.layout == xd.layout)
    return out


def _solve_row(x, stats, shape):
    xg = unpad_grid_vector(gather(x), shape)
    return {"iters": int(stats.niter), "flag": int(stats.flag),
            "history": stats.residuals[: int(stats.niter) + 1].numpy(),
            "x": xg.reshape(-1).numpy() if dist.get_rank() == 0 else None}


def gmg_cases(periodic, weak):
    """Distributed GMG-CG at (4,) on 16^3 and at (2, 2) on 32^2 (Gershgorin
    Chebyshev(3): its global max; the weak-scaling rows run Lanczos), the
    periodic 16^2 torus at (2,) with the nullspace coarsest solver beside
    the serial solve, and
    the weak-scaling rows at 1 and 2 ranks."""
    out = {}
    for name, ncells, layout in (("slab", (16, 16, 16), (4,)), ("box", (32, 32), (2, 2))):
        out[name] = poisson_case(ncells, 3, layout, rtol=1e-8, maxiter=30, return_x=True,
                                 runs=1, smoother={"eig_method": "gershgorin"})

    mesh = device_mesh(2)
    if mesh.member:
        hier = cartesian_hierarchy(periodic["ncells"], 3, periodic=(True, True))
        gmg, Ad = distributed_poisson_gmg(
            hier, mesh, smoother=ChebyshevSmoother(degree=3),
            coarsest_solver=NullspaceSolver(
                nullspace=NullSpace(vectors=(torch.ones(hier[-1].vertex_shape,
                                                        dtype=torch.float64),)),
                constrain_matrix=True))
        solver = CGSolver(Pl=gmg, rtol=1e-8, maxiter=30)
        bd = shard_grid_vector(torch.from_numpy(periodic["b"]), mesh, Ad.grid_shape)
        x, stats = solver.solve(solver.setup(Ad), bd)
        out["periodic"] = _solve_row(x, stats, Ad.grid_shape)
        # the port's serial solve of the same torus (flat vectors)
        ops = [laplacian(m, torch.float64, "cpu") for m in hier.meshes]
        Pt, Rt = setup_transfer_operators(hier, device="cpu")
        gmg_s = GMGSolver(
            coarse_ops=tuple(ops[1:]), prolongations=tuple(Pt), restrictions=tuple(Rt),
            smoother=ChebyshevSmoother(degree=3),
            coarsest_solver=NullspaceSolver(
                nullspace=NullSpace(vectors=(torch.ones(ops[-1].n, dtype=torch.float64),)),
                constrain_matrix=True))
        serial = CGSolver(Pl=gmg_s, rtol=1e-8, maxiter=30)
        _, stats_s = serial.solve(serial.setup(ops[0]), torch.from_numpy(periodic["b"]))
        out["periodic"]["serial_iters"] = int(stats_s.niter)

    out["weak"] = [weak_scaling_case(weak["local"], p, rtol=weak["rtol"], maxiter=weak["maxiter"])
                   for p in weak["counts"]]
    for row in out["weak"]:
        if row is not None:
            row.pop("history", None)
    return out

