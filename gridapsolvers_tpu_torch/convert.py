"""Carry the JAX package's operators and problem data into this package.

Each function takes what a `gridapsolvers_tpu` object holds, handed over
as numpy arrays plus its static fields (the caller does the `np.asarray`
on the JAX side), and returns the port's object on `device`, so both
packages apply literally the same operator. Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .algebra.block import BlockOperator, ColumnStack, FieldwiseOperator, RowStack
from .algebra.ell import ELLMatrix
from .algebra.flat import BlockedKernelOperator
from .algebra.stencil import ConstStencilMatrix, StencilMatrix
from .fem.darcy import DarcyProblem
from .fem.elasticity import ElasticityProblem
from .fem.hdiv import RTProlongation, RTRestriction
from .fem.mesh import CartesianMesh
from .fem.mhd import MHDProblem
from .fem.navier_stokes import NavierStokesProblem
from .fem.rt1 import DarcyRT1Problem, RT1Prolongation, RT1Restriction
from .fem.poisson import PoissonProblem
from .fem.stokes import StokesProblem
from .interfaces.nullspaces import NullSpace
from .multilevel.adaptive import AdaptiveHierarchy, AdaptiveLevel, CompositeOperator
from .multilevel.forest import ForestCompositeOperator, ForestHierarchy, Patch
from .multilevel.multifield import MultiFieldTransfer
from .multilevel.transfer import StructuredProlongation, StructuredRestriction, TensorTransfer
from .patches.topology import PatchTopology
from .patches.transfer import PatchProlongation
from .utils import resolve_device


def _tensor(a, device, dtype=None) -> Optional[torch.Tensor]:
    if a is None:
        return None
    t = torch.from_numpy(np.array(a))  # a copy: JAX hands out read-only views
    return t.to(device=resolve_device(device), dtype=dtype or t.dtype)


def _vec(v, device, dtype=None):
    """A numpy array, or a (nested) tuple of them, as tensors; None stays."""
    if v is None:
        return None
    if isinstance(v, (tuple, list)):
        return tuple(_vec(vi, device, dtype) for vi in v)
    return _tensor(v, device, dtype)


def _offsets(offsets) -> Tuple[Tuple[int, ...], ...]:
    return tuple(tuple(int(v) for v in off) for off in offsets)


def stencil_matrix(
    bands: np.ndarray,
    offsets: Sequence[Sequence[int]],
    grid_shape: Sequence[int],
    periodic: Optional[Sequence[bool]] = None,
    *,
    device=None,
    dtype=None,
) -> StencilMatrix:
    """`StencilMatrix` from (bands, offsets, grid_shape, periodic)."""
    return StencilMatrix(
        _tensor(bands, device, dtype),
        _offsets(offsets),
        tuple(int(m) for m in grid_shape),
        None if periodic is None else tuple(bool(p) for p in periodic),
    )


def const_stencil_matrix(
    weights: np.ndarray,
    free: np.ndarray,
    offsets: Sequence[Sequence[int]],
    grid_shape: Sequence[int],
    *,
    device=None,
    dtype=None,
) -> ConstStencilMatrix:
    """`ConstStencilMatrix` from (weights, free, offsets, grid_shape)."""
    gs = tuple(int(m) for m in grid_shape)
    return ConstStencilMatrix(
        _tensor(np.asarray(weights).reshape(-1), device, dtype),
        _tensor(np.asarray(free).reshape(gs), device, dtype),
        _offsets(offsets),
        gs,
    )


def ell_matrix(
    values: np.ndarray,
    cols: np.ndarray,
    ncols: int,
    *,
    device=None,
    dtype=None,
) -> ELLMatrix:
    """`ELLMatrix` from (values, cols, ncols); columns become int32."""
    return ELLMatrix(
        _tensor(values, device, dtype),
        _tensor(np.asarray(cols, dtype=np.int32), device),
        int(ncols),
    )


_STACKS = {"column_stack": ColumnStack, "row_stack": RowStack, "fieldwise": FieldwiseOperator}


def operator(spec: dict, *, device=None, dtype=None):
    """An operator from its numpy fields: ELL {"values", "cols", "ncols"},
    constant stencil {"weights", "free", "offsets", "grid_shape"}, stencil
    {"bands", "offsets", "grid_shape", "periodic"}, or a block operator
    whose parts are such dicts: {"blocks": rows of dicts or None},
    {"column_stack": [...]}, {"row_stack": [...]} or {"fieldwise": [...]};
    or a blocked-kernel operator {"kblocks": rows of ELL dicts or None,
    "inner": a dict or None, "sizes"}. An ELL dict may carry "row_len"
    (the real entries of each row; the JAX package's ELL has none)."""
    if "values" in spec:
        A = ell_matrix(spec["values"], spec["cols"], spec["ncols"], device=device, dtype=dtype)
        if spec.get("row_len") is not None:
            A.row_len = _tensor(np.asarray(spec["row_len"], np.int32), device)
        return A
    if "kblocks" in spec:
        return BlockedKernelOperator(
            kblocks=tuple(tuple(None if b is None else operator(b, device=device, dtype=dtype)
                                for b in row) for row in spec["kblocks"]),
            inner=None if spec.get("inner") is None else operator(spec["inner"], device=device,
                                                                  dtype=dtype),
            sizes=tuple(int(n) for n in spec["sizes"]))
    if "weights" in spec:
        return const_stencil_matrix(spec["weights"], spec["free"], spec["offsets"],
                                    spec["grid_shape"], device=device, dtype=dtype)
    if "blocks" in spec:
        return BlockOperator(tuple(
            tuple(None if b is None else operator(b, device=device, dtype=dtype) for b in row)
            for row in spec["blocks"]))
    for key, cls in _STACKS.items():
        if key in spec:
            return cls(tuple(operator(o, device=device, dtype=dtype) for o in spec[key]))
    return stencil_matrix(spec["bands"], spec["offsets"], spec["grid_shape"],
                          spec.get("periodic"), device=device, dtype=dtype)


def amg_state(
    mats: Sequence[dict],
    P: Sequence[dict],
    R: Sequence[dict],
    lmax: Sequence[float],
    lmin: Sequence[float],
    coarse_inv: np.ndarray,
    *,
    device=None,
    dtype=None,
) -> dict:
    """The state of an `AMGSolver` with the default Chebyshev smoother from
    a JAX AMG state's parts: its level operators, prolongations and
    restrictions (each a dict for `operator`), the smoothers' spectral
    bounds of levels 0..L-2, and the coarsest level's dense inverse. The
    smoothers' inverse diagonals are taken from the carried operators,
    as the JAX smoother takes them (1 / diag, exact)."""
    mats = [operator(m, device=device, dtype=dtype) for m in mats]
    sm = [
        {"A": A, "inv_diag": 1.0 / A.diag(), "lmax": float(hi), "lmin": float(lo)}
        for A, hi, lo in zip(mats[:-1], lmax, lmin)
    ]
    return {
        "mats": mats,
        "P": [operator(p, device=device, dtype=dtype) for p in P],
        "R": [operator(r, device=device, dtype=dtype) for r in R],
        "sm": sm,
        "coarse": {"inv": _tensor(coarse_inv, device, dtype)},
    }


def gmg_state(
    solver,
    mats: Sequence[dict],
    smoothers: Sequence[dict],
    coarse: dict,
    P: Sequence[dict],
    R: Sequence[dict],
    *,
    device=None,
    dtype=None,
) -> dict:
    """The state of the port's `GMGSolver` `solver` (Chebyshev smoothers,
    no post_smoother) from a JAX GMG state's parts in full precision: its
    level operators (dicts for `operator`), each smoothing level's
    Chebyshev state {"inv_diag" (an array, or a tuple of them for a block
    operator), "lmax", "lmin"}, the coarse solver's
    arrays ({"inv"}, or {"lu", "piv"} with JAX's 0-based pivots, made
    LAPACK's 1-based here), and the transfers (dicts for `transfer`; a
    restriction's keyword dict without "mode" is residual mode). The post smoothers share the pre
    smoothers' states, as the port's set-up makes them. Then `solver`'s
    own reduced-precision step runs: its `compute_dtype` twins (`mixed`)
    or the whole state cast down, so a JAX state's bf16 copies come out
    of its full-precision values exactly as JAX's `_tree_cast` makes
    them."""
    mats = [operator(m, device=device, dtype=dtype) for m in mats]
    pre = [
        {"A": A, "inv_diag": _vec(s["inv_diag"], device, dtype),
         "lmax": float(s["lmax"]), "lmin": float(s["lmin"])}
        for A, s in zip(mats[:-1], smoothers)
    ]
    coarse_state = {
        k: _tensor(np.asarray(v, np.int32) + 1, device) if k == "piv" else _tensor(v, device, dtype)
        for k, v in coarse.items()
    }
    return solver.reduced_state({
        "mats": mats,
        "pre": pre,
        "post": pre,
        "coarse": coarse_state,
        "P": tuple(transfer(p, device=device, dtype=dtype) for p in P),
        "R": tuple(transfer({"mode": "residual", **r} if "fine_shape" in r else r,
                            device=device, dtype=dtype) for r in R),
    })


def nullspace(vectors: Sequence[np.ndarray], *, device=None, dtype=None) -> NullSpace:
    """`NullSpace` from its spanning vectors (flat arrays)."""
    return NullSpace([_tensor(v, device, dtype) for v in vectors])


def prolongation(
    fine_shape, coarse_shape, mask_fine=None, factors=None, periodic=None,
    *, device=None, dtype=None,
) -> StructuredProlongation:
    """`StructuredProlongation` from the JAX one's fields and mask."""
    return StructuredProlongation(
        tuple(fine_shape), tuple(coarse_shape), _tensor(mask_fine, device, dtype),
        None if factors is None else tuple(factors),
        None if periodic is None else tuple(periodic),
    )


def restriction(
    fine_shape, coarse_shape, mode="residual", mask_coarse=None, mask_fine=None,
    factors=None, periodic=None, *, device=None, dtype=None,
) -> StructuredRestriction:
    """`StructuredRestriction` from the JAX one's fields and masks."""
    return StructuredRestriction(
        tuple(fine_shape), tuple(coarse_shape), mode,
        _tensor(mask_coarse, device, dtype), _tensor(mask_fine, device, dtype),
        None if factors is None else tuple(factors),
        None if periodic is None else tuple(periodic),
    )


def poisson_problem(
    mesh: CartesianMesh,
    A: StencilMatrix,
    A_full: StencilMatrix,
    M: StencilMatrix,
    b: np.ndarray,
    u_exact: np.ndarray,
    dirichlet_mask: np.ndarray,
    *,
    device=None,
    dtype=None,
) -> PoissonProblem:
    """`PoissonProblem` from converted operators and the JAX problem's
    b, u_exact and Dirichlet mask."""
    return PoissonProblem(
        mesh=mesh,
        A=A,
        A_full=A_full,
        M=M,
        b=_tensor(b, device, dtype),
        u_exact=_tensor(u_exact, device, dtype),
        dirichlet_mask=np.asarray(dirichlet_mask, dtype=bool),
    )


def stokes_problem(
    mesh: CartesianMesh,
    A: dict,
    b,
    Mu: dict,
    Mp: dict,
    u_exact,
    p_exact,
    dirichlet_mask_u: np.ndarray,
    nu: float,
    const_p=None,
    *,
    device=None,
    dtype=None,
) -> StokesProblem:
    """`StokesProblem` from the JAX problem's operators (dicts for
    `operator`), its vectors as numpy arrays (b as ((b_u0, .., b_ud), b_p),
    u_exact a tuple or None, p_exact and const_p arrays or None) and its
    static fields."""
    def vec(v):
        return _vec(v, device, dtype)

    return StokesProblem(
        mesh=mesh,
        A=operator(A, device=device, dtype=dtype),
        b=vec(b),
        Mu=operator(Mu, device=device, dtype=dtype),
        Mp=operator(Mp, device=device, dtype=dtype),
        u_exact=vec(u_exact),
        p_exact=vec(p_exact),
        dirichlet_mask_u=np.asarray(dirichlet_mask_u, dtype=bool),
        nu=float(nu),
        const_p=vec(const_p),
    )


def patch_topology(dofs: np.ndarray, dummy: int, n_dofs: int) -> PatchTopology:
    """`PatchTopology` from the JAX one's fields."""
    return PatchTopology(dofs=np.array(dofs, dtype=np.int32), dummy=int(dummy),
                         n_dofs=int(n_dofs))


def vanka_state(solver, A, dofs, inv, uncovered_inv_diag, wdof=None, *, device=None,
                dtype=None) -> dict:
    """The state of the port's `VankaSolver` (or `PatchSolver`) `solver` on
    the port's operator A from a JAX Vanka state's arrays: the patch dof
    table, the batched patch inverses, the uncovered dofs' inverse diagonal
    and (overlap weighting) the dof weights. The pattern entries
    (`meta`, `ell_cols`, `leaf_masks`, `uncov`) come from the port's own
    set-up of A, so only the patch inverses are carried."""
    state = solver.setup(A)
    state.update({
        "dofs": _tensor(np.asarray(dofs, np.int64), device),
        "inv": _tensor(inv, device, dtype),
        "uncovered_inv_diag": _tensor(uncovered_inv_diag, device, dtype),
    })
    if wdof is not None:
        state["wdof"] = _tensor(wdof, device, dtype)
    return state


def tensor_transfer(mats, in_shape, out_shape, mask_in=None, mask_out=None, *, device=None,
                    dtype=None) -> TensorTransfer:
    """`TensorTransfer` from the JAX one's fields."""
    return TensorTransfer(
        mats=tuple(_tensor(m, device, dtype) for m in mats),
        in_shape=tuple(int(m) for m in in_shape), out_shape=tuple(int(m) for m in out_shape),
        mask_in=_tensor(mask_in, device, dtype), mask_out=_tensor(mask_out, device, dtype))


def navier_stokes_problem(fields: dict, *, device=None, dtype=None) -> NavierStokesProblem:
    """`NavierStokesProblem` from a JAX one's fields, by their names: the
    mesh and nu as they are, n_u an int, the operators BTs, Bs (sequences),
    Mp, Mu and res_Bs (a sequence or None) as dicts for `operator`, every
    other field a numpy array, a (nested) tuple of them, or None. The
    pattern's row lengths ("row_len", which the JAX package's ELL lacks)
    default to the Q2 stiffness pattern's row counts on the mesh, the
    pattern both packages lay the velocity blocks out by."""
    from .fem import assembly2 as asm

    def vec(v, dt=dtype):
        return _vec(v, device, dt)

    def ops(v):
        return None if v is None else tuple(operator(o, device=device, dtype=dtype) for o in v)

    mesh = fields["mesh"]
    row_len = fields.get("row_len")
    if row_len is None:
        row_len = np.diff(asm.assemble_bilinear(mesh, 2, "stiffness").indptr)
    arrays = ("base_vals", "mask_ell", "free_u", "phi", "dphi", "wq", "f", "u_exact", "p_exact",
              "gd_vals", "lift_g", "res_vals", "gd_res_vals", "row_mask_ell")
    return NavierStokesProblem(
        mesh=mesh, nu=float(fields["nu"]), n_u=int(fields["n_u"]),
        cols_ell=_tensor(np.asarray(fields["cols_ell"], np.int32), device),
        conn=_tensor(np.asarray(fields["conn"], np.int64), device),
        slots=_tensor(np.asarray(fields["slots"], np.int32), device),
        BTs=ops(fields["BTs"]), Bs=ops(fields["Bs"]), res_Bs=ops(fields.get("res_Bs")),
        Mp=operator(fields["Mp"], device=device, dtype=dtype),
        Mu=operator(fields["Mu"], device=device, dtype=dtype),
        row_len=_tensor(np.asarray(row_len, np.int32), device),
        **{k: vec(fields.get(k)) for k in arrays})


def ns_gmg_state(
    solver,
    mats: Sequence[dict],
    lmax: Sequence[float],
    vanka: Sequence[dict],
    coarse: dict,
    P: Sequence[dict],
    R: Sequence[Sequence[dict]],
    *,
    device=None,
    dtype=None,
) -> dict:
    """The state of the port's augmented `ns_velocity_gmg` `solver`
    (Chebyshev over the materialized Vanka, patch prolongations, no
    post_smoother) from a JAX state's parts: its level operators (dicts
    for `operator`), each smoothing level's λmax and materialized M_vanka
    (a "kblocks" dict for `operator`), the coarse LU ({"lu", "piv"} with
    JAX's 0-based pivots), each prolongation's parts ({"base": a list of
    `tensor_transfer` keyword dicts, one a field, "A" and "rhs_op": dicts
    for `operator`, "dofs", "inv", "uncovered_inv_diag": its Vanka's
    arrays}) and each restriction's (a list of `tensor_transfer` keyword
    dicts). The pattern tables of every smoother and patch solver come from
    the port's own set-up on the carried operators; the numbers (λmax,
    M_vanka, patch inverses, LU) are the carried ones."""
    mats = [operator(m, device=device, dtype=dtype) for m in mats]
    pre = []
    for sm, A, lm, mv in zip(solver.smoother, mats[:-1], lmax, vanka):
        mst = sm.M.setup(A)
        mst["Mv"] = operator(mv, device=device, dtype=dtype)
        pre.append({"A": A, "M": mst, "lmax": float(lm)})
    prolongs = []
    for p_solver, p in zip(solver.prolongations, P):
        A = operator(p["A"], device=device, dtype=dtype)
        vs = p_solver.solver
        prolongs.append(PatchProlongation(
            MultiFieldTransfer(tuple(tensor_transfer(**t, device=device, dtype=dtype)
                                     for t in p["base"])),
            A, vs,
            vanka_state(vs, A, p["dofs"], p["inv"], p["uncovered_inv_diag"], device=device,
                        dtype=dtype),
            rhs_op=operator(p["rhs_op"], device=device, dtype=dtype)))
    return solver.reduced_state({
        "mats": mats,
        "pre": pre,
        "post": pre,
        "coarse": {k: _tensor(np.asarray(v, np.int32) + 1, device) if k == "piv"
                   else _tensor(v, device, dtype) for k, v in coarse.items()},
        "P": tuple(prolongs),
        "R": tuple(MultiFieldTransfer(tuple(tensor_transfer(**t, device=device, dtype=dtype)
                                            for t in r)) for r in R),
    })


def transfer(spec: dict, *, device=None, dtype=None):
    """A grid transfer from a JAX one's fields: {"fields": [specs]} (a
    `MultiFieldTransfer`), {"rt0": "P" or "R", "coarse_cells", "mask_fine",
    "mask_coarse"} (RT0 face transfers; masks per component or None),
    {"rt1": "P" or "R", "mats" (per component, per axis), "coarse_cells",
    "mask_fine", "mask_coarse"}, or the keyword dict of `prolongation`
    (no "mode") or `restriction` (with "mode")."""
    if "fields" in spec:
        return MultiFieldTransfer(tuple(transfer(f, device=device, dtype=dtype)
                                        for f in spec["fields"]))
    cells = tuple(int(n) for n in spec.get("coarse_cells", ()))
    mf = _vec(spec.get("mask_fine"), device, dtype)
    mc = _vec(spec.get("mask_coarse"), device, dtype)
    if "rt0" in spec:
        return RTProlongation(cells, mf) if spec["rt0"] == "P" else RTRestriction(cells, mc, mf)
    if "rt1" in spec:
        mats = tuple(tuple(_tensor(m, device, dtype) for m in per) for per in spec["mats"])
        if spec["rt1"] == "P":
            return RT1Prolongation(mats, cells, mf)
        return RT1Restriction(mats, cells, mc, mf)
    if "mode" in spec:
        return restriction(**spec, device=device, dtype=dtype)
    return prolongation(**spec, device=device, dtype=dtype)


def patch_gmg_state(
    solver,
    mats: Sequence[dict],
    vanka: Sequence[dict],
    coarse: dict,
    P: Sequence[dict],
    R: Sequence[dict],
    *,
    device=None,
    dtype=None,
) -> dict:
    """The state of the port's `GMGSolver` `solver` whose smoothers are
    `RichardsonSmoother`s over a `VankaSolver` (`hdiv_gmg`, `rt1_gmg`), no
    post_smoother, from a JAX GMG state's parts: its level operators (dicts
    for `operator`), each smoothing level's Vanka arrays ({"dofs", "inv",
    "uncovered_inv_diag"}), the coarse LU ({"lu", "piv"}, JAX's 0-based
    pivots) and the transfers (dicts for `transfer`). The pattern tables
    of every Vanka come from the port's own set-up on the carried
    operators; the patch inverses and the LU are the carried ones."""
    mats = [operator(m, device=device, dtype=dtype) for m in mats]
    pre = []
    for sm, A, v in zip(solver._smoothers()[0], mats[:-1], vanka):
        pre.append({"A": A, "M": vanka_state(sm.M, A, v["dofs"], v["inv"],
                                              v["uncovered_inv_diag"], device=device,
                                              dtype=dtype)})
    return {
        "mats": mats,
        "pre": pre,
        "post": pre,
        "coarse": {k: _tensor(np.asarray(v, np.int32) + 1, device) if k == "piv"
                   else _tensor(v, device, dtype) for k, v in coarse.items()},
        "P": tuple(transfer(p, device=device, dtype=dtype) for p in P),
        "R": tuple(transfer(r, device=device, dtype=dtype) for r in R),
    }


def darcy_problem(ncells, A: dict, b, u_exact, p_exact, cell_volume: float, *, device=None,
                  dtype=None) -> DarcyProblem:
    """`DarcyProblem` (RT0) from the JAX one's operator (a dict for
    `operator`), its vectors as numpy arrays (b as ((b_ux, b_uy), b_p))
    and its static fields."""
    return DarcyProblem(ncells=tuple(int(n) for n in ncells),
                        A=operator(A, device=device, dtype=dtype), b=_vec(b, device, dtype),
                        u_exact=_vec(u_exact, device, dtype),
                        p_exact=_vec(p_exact, device, dtype), cell_volume=float(cell_volume))


def darcy_rt1_problem(ncells, A: dict, b, x_exact, Mp: dict, alpha: float, *, device=None,
                      dtype=None) -> DarcyRT1Problem:
    """`DarcyRT1Problem` from the JAX one's operators (dicts for
    `operator`), its vectors as numpy arrays (b and x_exact as
    ((u_0, .., u_d), p)) and alpha."""
    return DarcyRT1Problem(ncells=tuple(int(n) for n in ncells),
                           A=operator(A, device=device, dtype=dtype), b=_vec(b, device, dtype),
                           x_exact=_vec(x_exact, device, dtype),
                           Mp=operator(Mp, device=device, dtype=dtype), alpha=float(alpha))


def elasticity_problem(mesh: CartesianMesh, A: dict, b, dirichlet_mask, mu: float, lam: float,
                       *, device=None, dtype=None) -> ElasticityProblem:
    """`ElasticityProblem` from the JAX one's operator (a dict for
    `operator`), b (a tuple of numpy arrays) and its static fields."""
    return ElasticityProblem(mesh=mesh, A=operator(A, device=device, dtype=dtype),
                             b=_vec(b, device, dtype),
                             dirichlet_mask=np.asarray(dirichlet_mask, dtype=bool),
                             mu=float(mu), lam=float(lam))


def curlcurl_operator(A: dict, free, system: dict, *, device=None, dtype=None):
    """(BlockOperator, free masks, system dict) of the JAX package's
    `curlcurl_operator`: the operator from its numpy fields (a dict for
    `operator`), the masks as numpy arrays, and its host system dict
    (scipy blocks, masks, G, Pi), whose scipy matrices carry over as they
    are."""
    sysd = dict(system)
    sysd["ncells"] = tuple(int(n) for n in system["ncells"])
    return operator(A, device=device, dtype=dtype), _vec(tuple(free), device, dtype), sysd


def mhd_problem(ncells, A: dict, b, free, *, device=None, dtype=None) -> MHDProblem:
    """`MHDProblem` from the JAX one's operator (a dict for `operator`),
    its rhs and free masks (tuples of six numpy arrays) and its cells; a
    list of them, finest first, builds the port's GMG through
    `fem.mhd.mhd_gmg_from_problems`."""
    return MHDProblem(ncells=tuple(int(n) for n in ncells),
                      A=operator(A, device=device, dtype=dtype), b=_vec(tuple(b), device, dtype),
                      free=_vec(tuple(free), device, dtype))


def _ints(t):
    return None if t is None else tuple(int(v) for v in t)


def _mesh(spec: dict) -> CartesianMesh:
    return CartesianMesh(_ints(spec["ncells"]), tuple(float(v) for v in spec["domain"]))


def adaptive_hierarchy(levels: Sequence[dict]) -> AdaptiveHierarchy:
    """`AdaptiveHierarchy` from its levels, coarsest first, each
    {"ncells", "domain", "lo", "hi"} (lo and hi None for the base)."""
    return AdaptiveHierarchy([AdaptiveLevel(_mesh(lv), _ints(lv["lo"]), _ints(lv["hi"]))
                              for lv in levels])


def forest_hierarchy(levels: Sequence[Sequence[dict]]) -> ForestHierarchy:
    """`ForestHierarchy` from its levels of patches, each {"ncells",
    "domain", "lo", "hi", "parent"} (the base: lo and hi None, parent -1)."""
    return ForestHierarchy([[Patch(_mesh(p), _ints(p["lo"]), _ints(p["hi"]), int(p["parent"]))
                             for p in lv] for lv in levels])


def composite_operator(ops: Sequence[dict], active, boxes, shapes, *, device=None,
                       dtype=None) -> CompositeOperator:
    """`CompositeOperator` from the JAX one's level operators (dicts for
    `operator`), active masks (numpy arrays), boxes ((lo, hi) per level,
    (None, None) for the base) and vertex shapes."""
    return CompositeOperator(
        ops=tuple(operator(o, device=device, dtype=dtype) for o in ops),
        active=_vec(tuple(active), device, dtype),
        boxes=tuple((_ints(lo), _ints(hi)) for lo, hi in boxes),
        shapes=tuple(_ints(s) for s in shapes))


def forest_composite_operator(ops: Sequence[dict], active, ring_par, meta, seams, shapes, *,
                              device=None, dtype=None) -> ForestCompositeOperator:
    """`ForestCompositeOperator` from the JAX one's patch operators (dicts
    for `operator`), active and parent-ring masks (numpy arrays), per-patch
    metadata (level, parent, lo, hi), seam records (k_own, k_slv, own_box,
    slv_box) and vertex shapes."""
    return ForestCompositeOperator(
        ops=tuple(operator(o, device=device, dtype=dtype) for o in ops),
        active=_vec(tuple(active), device, dtype),
        ring_par=tuple(_tensor(np.asarray(r, dtype=bool), device) for r in ring_par),
        meta=tuple((int(l), int(p), _ints(lo), _ints(hi)) for l, p, lo, hi in meta),
        seams=tuple((int(ko), int(ks), tuple(_ints(b) for b in ob), tuple(_ints(b) for b in sb))
                    for ko, ks, ob, sb in seams),
        shapes=tuple(_ints(s) for s in shapes))


def _block_slices(shape, procs, coords, lead: int):
    grid = tuple(shape[lead:])
    procs = tuple(procs) + (1,) * (len(grid) - len(procs))
    coords = tuple(coords) + (0,) * (len(grid) - len(coords))
    sl = []
    for n, p, c in zip(grid, procs, coords):
        if n % p:
            raise ValueError(f"padded shape {grid} does not split over {procs} ranks")
        m = n // p
        sl.append(slice(c * m, (c + 1) * m))
    return (slice(None),) * lead + tuple(sl)


def shard_from_jax(a: np.ndarray, procs: Sequence[int], coords: Sequence[int], *, lead: int = 0,
                   device=None, dtype=None) -> torch.Tensor:
    """One rank's block of a JAX sharded grid vector or sharded bands,
    handed over whole as a numpy array of its padded shape: grid axis k
    (after `lead` leading axes: 1 for bands) is cut in procs[k] equal
    blocks and the rank at mesh coordinates `coords` keeps block
    coords[k]. The block is what `parallel.dist.BlockLayout.take` keeps."""
    a = np.asarray(a)
    return _tensor(a[_block_slices(a.shape, procs, coords, lead)], device, dtype)


def unshard_to_jax(blocks: Sequence, procs: Sequence[int], *, lead: int = 0) -> np.ndarray:
    """The whole padded array from every rank's block (tensors or numpy
    arrays, in rank order: C order over the mesh of shape `procs`), as
    the numpy array a JAX sharded array of that layout holds."""
    blocks = [b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b) for b in blocks]
    procs = tuple(procs)
    b0 = blocks[0]
    grid_procs = procs + (1,) * (b0.ndim - lead - len(procs))
    shape = tuple(b0.shape[:lead]) + tuple(m * p for m, p in zip(b0.shape[lead:], grid_procs))
    out = np.empty(shape, dtype=b0.dtype)
    for r, b in enumerate(blocks):
        coords = np.unravel_index(r, procs)
        out[_block_slices(shape, procs, coords, lead)] = b
    return out


def box_vector_from_jax(a: np.ndarray, mesh, *, device=None, dtype=None):
    """This rank's block of a JAX box-ordered vector (shard-major padded,
    `parallel/dist_ell_nd.py`), handed over whole: rank r keeps entries
    [r·m, (r + 1)·m), as a `Sharded` vector of the partition layout."""
    from .parallel.dist_ell_nd import PartitionLayout
    from .utils.pytrees import Sharded

    a = np.asarray(a).reshape(-1)
    layout = PartitionLayout(mesh, a.shape[0] // mesh.size)
    r, m = mesh.rank, layout.m
    return Sharded(_tensor(a[r * m:(r + 1) * m], device or mesh.device, dtype), layout)


def box_vector_to_jax(blocks: Sequence) -> np.ndarray:
    """The whole shard-major padded vector from every rank's block (in
    rank order), as the numpy array a JAX box-ordered vector holds."""
    return np.concatenate([b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
                           for b in blocks])


def graph_ell_from_jax(values: np.ndarray, cols_loc: np.ndarray, send_tbls: Sequence[np.ndarray],
                       dirs, n_cols: int, m_in: int, mesh, *, device=None, dtype=None):
    """This rank's `parallel.dist_ell_nd.DistGraphELL` from a JAX
    `DistGraphELL`'s whole arrays (values and cols_loc (n_shards·m_out,
    K), one (n_shards, W_d) send table an offset) and static fields. The
    JAX operator keeps no row lengths, so every slot of a row counts."""
    from .parallel.dist_ell_nd import DistGraphELL

    dev = resolve_device(device or mesh.device)
    m_out = np.asarray(values).shape[0] // mesh.size
    rows = slice(mesh.rank * m_out, (mesh.rank + 1) * m_out)
    window = int(m_in) + sum(np.asarray(t).shape[1] for t in send_tbls)
    local = ELLMatrix(_tensor(np.asarray(values)[rows], dev, dtype),
                      torch.from_numpy(np.ascontiguousarray(np.asarray(cols_loc)[rows])).to(dev),
                      window)
    tbls = tuple(torch.from_numpy(np.ascontiguousarray(np.asarray(t)[mesh.rank])).to(dev)
                 for t in send_tbls)
    return DistGraphELL(local=local, send_tbls=tbls, n_cols=int(n_cols), m_in=int(m_in),
                        dirs=tuple(tuple(int(v) for v in d) for d in dirs), mesh=mesh,
                        axes=tuple(mesh.axis_names))
