"""Rank functions of `tests/test_torch_distributed.py` and
`tests/test_torch_dist_stokes.py`.

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
from gridapsolvers_tpu_torch.parallel.weak_scaling import (
    poisson_case,
    stokes_serial_twin,
    weak_scaling_case,
)
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



# -- box-partitioned sparse operators and the distributed Stokes flagship -------
# (the rank functions of tests/test_torch_dist_stokes.py)

def _graph_row(A, x, xt=None):
    """This rank's tables and applies of a DistGraphELL, as numpy."""
    from gridapsolvers_tpu_torch.parallel.dist_ell_nd import DistGraphELL

    assert isinstance(A, DistGraphELL)
    out = {"dirs": A.dirs, "cols_loc": A.cols_loc.numpy(), "values": A.values.numpy(),
           "send_tbls": [t.numpy() for t in A.send_tbls],
           "y": A.matvec(x).local.numpy()}
    if xt is not None:
        out["yt"] = A.matvec_t(xt).local.numpy()
    if A.n_rows == A.n_cols:
        out["diag"] = A.diag().local.numpy()
    out["abs_row_sum"] = A.abs_row_sum().local.numpy()
    return out


def graph_cases(square, rect, redist, cg, gmres):
    """The sparse layer: square DistGraphELL cases (tables and applies),
    the rectangular P/R pair with part_cols (the port's own and JAX's
    tables carried across), redistribution (4,) -> (2,), the whole
    operator on the host, Jacobi-CG at (2, 2) and GMRES on the 2-rank
    halo stencil. Returns this rank's blocks."""
    from gridapsolvers_tpu_torch.fem.dist_stokes_nd import distributed_stokes_system_nd
    from gridapsolvers_tpu_torch.linear import GMRESSolver, JacobiSolver
    from gridapsolvers_tpu_torch.parallel.dist_ell_nd import (
        box_partition,
        dist_to_scipy_nd,
        redistribute_vector_nd,
        shard_csr_nd,
    )

    meshes = {(4,): device_mesh(4), (2, 2): device_mesh_nd((2, 2)), (2,): device_mesh(2)}
    out = {"square": [], "rank": dist.get_rank()}
    for c in square:
        mesh = meshes[c["layout"]]
        part = box_partition(c["shape"], c["layout"])
        A = shard_csr_nd(c["S"], part, mesh, identity_pad=True)
        box = lambda a: convert.box_vector_from_jax(a, mesh)  # noqa: E731
        out["square"].append(_graph_row(A, box(c["x"]), box(c["y"])))
        if c.get("host"):
            S_pad = dist_to_scipy_nd(A)
            out["scipy"] = S_pad if dist.get_rank() == 0 else None
        if c.get("cg"):
            solver = CGSolver(Pl=JacobiSolver(), rtol=cg["rtol"], maxiter=cg["maxiter"])
            x, stats = solver.solve(solver.setup(A), box(cg["b"]))
            out["cg"] = {"iters": int(stats.niter), "flag": int(stats.flag),
                         "history": stats.residuals[: int(stats.niter) + 1].numpy(),
                         "x": x.local.numpy()}

    mesh = meshes[(2, 2)]
    pf, pc = box_partition(rect["fine"], (2, 2)), box_partition(rect["coarse"], (2, 2))
    fine = convert.box_vector_from_jax(rect["xf"], mesh)
    coarse = convert.box_vector_from_jax(rect["xc"], mesh)
    P = shard_csr_nd(rect["P"], pf, mesh, part_cols=pc)
    R = shard_csr_nd(rect["P"].T.tocsr(), pc, mesh, part_cols=pf)
    out["P"] = _graph_row(P, coarse, fine)
    out["R"] = _graph_row(R, fine, coarse)
    jP = rect["jax_P"]
    P_jax = convert.graph_ell_from_jax(jP["values"], jP["cols_loc"], jP["send_tbls"], jP["dirs"],
                                       jP["n_cols"], jP["m_in"], mesh)
    out["P_from_jax"] = (P_jax.matvec(coarse).local.numpy(), P_jax.matvec_t(fine).local.numpy())

    p4, p2 = box_partition(redist["shape"], (4,)), box_partition(redist["shape"], (2,))
    moved = redistribute_vector_nd(convert.box_vector_from_jax(redist["x"], meshes[(4,)]),
                                   p4, p2, meshes[(2,)])
    out["redist"] = None if moved is None else (moved.local.numpy(), moved.layout.global_numel)

    mesh = meshes[(2,)]
    if mesh.member:
        A = HaloStencilMatrix.from_blocks(_block(mesh, gmres["bands"], lead=1), gmres["offsets"],
                                          gmres["bands"].shape[1:], None, mesh, ("p",))
        solver = GMRESSolver(m=gmres["m"], rtol=gmres["rtol"], maxiter=gmres["maxiter"])
        x, stats = solver.solve(solver.setup(A), Sharded(_block(mesh, gmres["b"]), A.layout))
        out["gmres"] = {"iters": int(stats.niter), "flag": int(stats.flag),
                        "history": stats.residuals[: int(stats.niter) + 1].numpy(),
                        "x": x.local.numpy()}

    # an entry point asked for the card where there is none raises
    if not torch.cuda.is_available():
        try:
            distributed_stokes_system_nd((4, 4), meshes[(2, 2)], (2, 2), device="cuda")
        except RuntimeError as e:
            out["no_card"] = "torch.cuda.is_available" in str(e)
    return out


def _stokes_solve(ncells, levels, mesh, layout, one_axis=False, rtol=1e-8):
    from gridapsolvers_tpu_torch.fem import dist_stokes, dist_stokes_nd

    if one_axis:
        prob, A, b, pv, pq = dist_stokes.distributed_stokes_system(ncells, mesh)
        solver, _ = dist_stokes.distributed_stokes_solver(ncells, levels, mesh, rtol=rtol)
    else:
        prob, A, b, pv, pq = dist_stokes_nd.distributed_stokes_system_nd(ncells, mesh, layout)
        solver, _ = dist_stokes_nd.distributed_stokes_solver_nd(ncells, levels, mesh, layout,
                                                                rtol=rtol)
    x, stats = solver.solve(solver.setup(A), b)
    if one_axis:
        u, p = dist_stokes.unshard_stokes_solution(x, ncells, mesh, pv.n, pq.n)
    else:
        u, p = dist_stokes_nd.unshard_stokes_solution_nd(x, ncells, layout, pv.n, pq.n)
    return {"iters": int(stats.niter), "flag": int(stats.flag),
            "history": stats.residuals[: int(stats.niter) + 1].numpy(),
            "blocks": [v.local.numpy() for v in (*x[0], x[1])], "u": u, "p": p}


def stokes_cases(ncells, levels, x):
    """The flagship at (2, 2): the sharded block matvec on JAX's padded x,
    the GMG levels at 3 levels, the FGMRES solve; then the (4,) solve
    through the 1-D spelling, and the one-rank solve (rank 0) beside the
    serial twin (rank 1)."""
    from gridapsolvers_tpu_torch.fem.dist_stokes_nd import (
        dist_velocity_gmg_nd,
        distributed_stokes_system_nd,
    )

    m22, m4, m1 = device_mesh_nd((2, 2)), device_mesh(4), device_mesh_nd((1, 1))
    out = {}
    _, A, _, _, _ = distributed_stokes_system_nd(ncells, m22, (2, 2))
    xv = tuple(convert.box_vector_from_jax(a, m22) for a in x[0])
    xd = (xv, convert.box_vector_from_jax(x[1], m22))
    y = A.matvec(xd)
    out["matvec"] = [v.local.numpy() for v in (*y[0], y[1])]
    gmg, parts = dist_velocity_gmg_nd(ncells, 3, m22, (2, 2))
    K1 = gmg.coarse_ops[0].ops[0]
    out["levels"] = ([p is not None for p in parts], type(K1).__name__, len(K1.dirs))
    out["box"] = _stokes_solve(ncells, levels, m22, (2, 2))
    out["slab"] = _stokes_solve(ncells, levels, m4, (4,), one_axis=True)
    if m1.member:
        out["one"] = _stokes_solve(ncells, levels, m1, (1, 1))
    elif dist.get_rank() == 1:
        out["serial"] = stokes_serial_twin(ncells, levels, device="cpu")
    return out
