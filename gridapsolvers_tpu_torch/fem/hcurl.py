"""H(curl) machinery: Nédélec edge elements and the AMS preconditioner.

Port of `gridapsolvers_tpu/fem/hcurl.py`, the analog of the reference's
auxiliary-space solver family (ext/GridapPETScExt/HipmairXuSolvers.jl:
hypre AMS fed with the discrete gradient G and the nodal interpolation Π
of PETScUtils.interpolation_operator). Model problem

    a(u, v) = α ∫ curl u · curl v + β ∫ u · v

on lowest-order Nédélec edge elements over a uniform unit-box grid, with
essential (tangential) boundary conditions. On a tensor grid curl maps the
edge space exactly onto the RT0 face space through a ±1/h incidence C
(C @ G == 0 identically), so A = α Cᵀ M_face C + β M_edge with every
factor a Kronecker chain of 1D matrices, assembled on the host in scipy as
in the JAX package. Every block, G, Gᵀ, Π_c and Π_cᵀ becomes an
`ELLMatrix` (kernel K3) on the requested device. The preconditioner is the
additive Hiptmair/auxiliary-space operator

    P r = S r + G B_node(Gᵀ r) + Σ_c Π_c B_c(Π_cᵀ r)

with S a Chebyshev edge smoother and each B the port's smoothed-
aggregation `AMGSolver` (hypre BoomerAMG's role), set up on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ..algebra.ell import ell_from_scipy
from ..interfaces import LinearSolver
from ..utils import pytrees as pt
from ..utils import resolve_device
from . import assembly2 as asm2
from .darcy import _kron_chain, _rt0_mass_1d, rt0_blocks


def edge_shape(ncells, d) -> Tuple[int, ...]:
    """Family-d edges: cells along axis d, nodes transverse."""
    return tuple(
        n if a == d else n + 1 for a, n in enumerate(ncells)
    )


def _diff_1d(n: int, h: float) -> sp.csr_matrix:
    """(n, n+1) node-difference / h along one axis."""
    return (
        sp.diags([np.full(n, -1.0), np.full(n, 1.0)], [0, 1], shape=(n, n + 1))
        / h
    ).tocsr()


def _avg_1d(n: int) -> sp.csr_matrix:
    """(n, n+1) endpoint average (nodal -> edge interpolation 1D)."""
    return sp.diags(
        [np.full(n, 0.5), np.full(n, 0.5)], [0, 1], shape=(n, n + 1)
    ).tocsr()


def edge_mass(ncells) -> list:
    """Per-family Nédélec edge mass: constant along the edge axis (cell
    measure), 1D hats transverse."""
    dim = len(ncells)
    h = tuple(1.0 / n for n in ncells)
    out = []
    for d in range(dim):
        parts = []
        for a, n in enumerate(ncells):
            if a == d:
                parts.append(sp.identity(n) * h[a])
            else:
                parts.append(_rt0_mass_1d(n + 1, h[a]))
        out.append(_kron_chain(parts))
    return out


def discrete_gradient(ncells) -> list:
    """G: nodes -> edges per family (reference
    PETScUtils.interpolation_operator gradient mode). Family d is the
    1D difference along axis d, identity transverse."""
    dim = len(ncells)
    h = tuple(1.0 / n for n in ncells)
    out = []
    for d in range(dim):
        parts = [
            _diff_1d(n, h[a]) if a == d else sp.identity(n + 1)
            for a, n in enumerate(ncells)
        ]
        out.append(_kron_chain(parts))
    return out


def nodal_interpolation(ncells) -> list:
    """Π: nodal scalar field -> family-d edge values (endpoint averages;
    the AMS Π operator per vector component)."""
    dim = len(ncells)
    out = []
    for d in range(dim):
        parts = [
            _avg_1d(n) if a == d else sp.identity(n + 1)
            for a, n in enumerate(ncells)
        ]
        out.append(_kron_chain(parts))
    return out


def discrete_curl(ncells) -> list:
    """C: edges -> faces (3D, per face family) or cells (2D, scalar curl):
    the ±1/h incidence realizing curl exactly on the complex
    (C @ G == 0 identically)."""
    dim = len(ncells)
    h = tuple(1.0 / n for n in ncells)

    def chain(op_axis: dict) -> sp.csr_matrix:
        parts = []
        for a, n in enumerate(ncells):
            kind = op_axis.get(a)
            if kind == "diff":
                parts.append(_diff_1d(n, h[a]))
            elif kind == "cell":
                parts.append(sp.identity(n))
            else:
                parts.append(sp.identity(n + 1))
        return _kron_chain(parts)

    if dim == 2:
        # scalar curl on cells: d(uy)/dx - d(ux)/dy
        Cx = -chain({0: "cell", 1: "diff"})   # acts on ux (nx, ny+1)
        Cy = chain({0: "diff", 1: "cell"})    # acts on uy (nx+1, ny)
        return [Cx, Cy]
    assert dim == 3
    # (curl u)_x on x-faces = d(uz)/dy - d(uy)/dz, etc. Each entry maps one
    # edge family to one face family; return a 3x3 grid (face, edge).
    Z = None
    C = [[Z] * 3 for _ in range(3)]
    # face family f, with (a, b) the cyclic pair after f
    for f in range(3):
        a, b = (f + 1) % 3, (f + 2) % 3
        # (curl u)_f = d(u_b)/d(a) - d(u_a)/d(b)
        C[f][b] = chain({a: "diff", b: "cell"})
        C[f][a] = -chain({b: "diff", a: "cell"})
    return C


def edge_boundary_masks(ncells) -> list:
    """Essential (tangential) boundary masks per edge family: family-d
    edges lying on any boundary face NOT normal to d."""
    dim = len(ncells)
    out = []
    for d in range(dim):
        shape = edge_shape(ncells, d)
        m = np.zeros(shape, dtype=bool)
        for a in range(dim):
            if a == d:
                continue
            idx = [slice(None)] * dim
            idx[a] = 0
            m[tuple(idx)] = True
            idx[a] = shape[a] - 1
            m[tuple(idx)] = True
        out.append(m.reshape(-1))
    return out


def curlcurl_system(ncells, alpha: float = 1.0, beta: float = 1.0):
    """Assemble the (d*d)-block curl-curl + mass system with essential
    tangential BCs eliminated. Returns dict with scipy blocks, masks, and
    the auxiliary operators G (per family) and Pi (per family)."""
    dim = len(ncells)
    Me = edge_mass(ncells)
    masks = edge_boundary_masks(ncells)
    C = discrete_curl(ncells)

    if dim == 2:
        ncellsv = int(np.prod(ncells))
        cellvol = float(np.prod([1.0 / n for n in ncells]))
        W = sp.identity(ncellsv) * cellvol
        blocks = [[None] * 2 for _ in range(2)]
        for a in range(2):
            for b in range(2):
                S = alpha * (C[a].T @ W @ C[b]).tocsr()
                if a == b:
                    S = S + beta * Me[a]
                blocks[a][b] = S
    else:
        rt = rt0_blocks(ncells)
        Mf = rt["M"]
        blocks = [[None] * 3 for _ in range(3)]
        for a in range(3):
            for b in range(3):
                S = None
                for f in range(3):
                    Ca, Cb = C[f][a], C[f][b]
                    if Ca is None or Cb is None:
                        continue
                    term = alpha * (Ca.T @ Mf[f] @ Cb).tocsr()
                    S = term if S is None else (S + term).tocsr()
                if a == b:
                    S = (S + beta * Me[a]).tocsr() if S is not None else (
                        beta * Me[a]
                    )
                blocks[a][b] = S

    # eliminate tangential boundary edges
    for a in range(dim):
        for b in range(dim):
            S = blocks[a][b]
            if S is None:
                continue
            S = asm2.zero_rows(S.tocsr(), masks[a])
            S = asm2.zero_columns(S, masks[b])
            if a == b:
                S = (S + sp.diags(masks[a].astype(float))).tocsr()
            blocks[a][b] = S.tocsr()

    return dict(
        blocks=blocks,
        masks=masks,
        G=discrete_gradient(ncells),
        Pi=nodal_interpolation(ncells),
        Me=Me,
        ncells=tuple(ncells),
    )


def curlcurl_operator(ncells, alpha: float = 1.0, beta: float = 1.0, dtype=torch.float64,
                      device=None):
    """(BlockOperator over edge families, free masks, system dict), the
    operator and masks in the torch `dtype` on `device` (None: the card)."""
    from ..algebra import BlockOperator

    dev = resolve_device(device)
    S = curlcurl_system(ncells, alpha, beta)
    rows = tuple(
        tuple(None if b is None else ell_from_scipy(b, dtype=dtype, device=dev) for b in row)
        for row in S["blocks"]
    )
    free = tuple(torch.from_numpy((~m).astype(np.float64)).to(dev, dtype) for m in S["masks"])
    return BlockOperator(rows), free, S


def _regularized(Ap: sp.csr_matrix) -> sp.csr_matrix:
    """Unit diagonal on the rows a masked projection decouples."""
    d = Ap.diagonal()
    return (Ap + sp.diags(np.where(d == 0, 1.0, 0.0))).tocsr()


@dataclasses.dataclass(frozen=True, eq=False)
class AMSSolver(LinearSolver):
    """Additive auxiliary-space preconditioner for curl-curl systems
    (reference HipmairXuSolvers.jl AMS via hypre):

        P r = S r + G B_g (Gᵀ r) + Σ_c Π_c B_c (Π_cᵀ r)

    S: Chebyshev edge smoother; B_g: AMG on the gradient-space projection
    Gᵀ A G; B_c: AMG per vector component on Π_cᵀ A Π_c (optional). The
    host scipy G and Π_c ride in the state (`host`), so `update` re-forms
    the triple products without rebuilding them. Construct with
    `make_ams(...)`.
    """

    system: dict = None
    smoother: object = None
    vector_correction: bool = True

    def _amg(self):
        from ..linear.amg import AMGSolver

        return AMGSolver(coarse_size=200)

    def _sm(self):
        from ..linear.smoothers import ChebyshevSmoother

        return self.smoother or ChebyshevSmoother(degree=3)

    def setup(self, A, x=None):
        sys = self.system
        dim = len(sys["ncells"])
        masks = sys["masks"]
        blocks = sys["blocks"]
        dt, dev = A.dtype, A.device

        def ell(S):
            return ell_from_scipy(S, dtype=dt, device=dev)

        # flat scipy system for the projections
        Afull = sp.bmat(
            [
                [
                    blocks[a][b] if blocks[a][b] is not None
                    else sp.csr_matrix(blocks[a][a].shape)
                    for b in range(dim)
                ]
                for a in range(dim)
            ],
            format="csr",
        )
        # G maps nodes -> concatenated edges, with constrained edge rows
        # zeroed (the correction lives in the free space)
        free_diag = sp.diags(np.concatenate([(~m).astype(float) for m in masks]))
        G = (free_diag @ sp.vstack(sys["G"], format="csr")).tocsr()
        # boundary nodes decouple under the masked G: regularize
        Anode = _regularized((G.T @ Afull @ G).tocsr())
        amg = self._amg()
        state = {
            "G": ell(G),
            "GT": ell(G.T.tocsr()),
            "node": amg.setup(ell(Anode)),
            "host": {"G": G, "Pis": ()},
            "sm": self._sm().setup(A),
            "A": A,
        }
        if self.vector_correction:
            Pis, PiTs, vec_states = [], [], []
            for c in range(dim):
                # Π_c: nodal scalar -> edges of family c only (zero rows for
                # the other families), constrained edges zeroed
                Pi_c = sp.vstack(
                    [
                        sys["Pi"][c] if a == c
                        else sp.csr_matrix((len(masks[a]), sys["Pi"][c].shape[1]))
                        for a in range(dim)
                    ],
                    format="csr",
                )
                Pi_c = (free_diag @ Pi_c).tocsr()
                Avec = _regularized((Pi_c.T @ Afull @ Pi_c).tocsr())
                Pis.append(Pi_c)
                PiTs.append(ell(Pi_c.T.tocsr()))
                vec_states.append(amg.setup(ell(Avec)))
            state["Pi"] = tuple(ell(P) for P in Pis)
            state["PiT"] = tuple(PiTs)
            state["vec"] = tuple(vec_states)
            state["host"] = {"G": G, "Pis": tuple(Pis)}
        return state

    def update(self, state, A, x=None):
        """Pattern-reusing numerical_setup!: the geometric projections (G,
        Π) and the AMG aggregation patterns stay; only the triple products
        GᵀAG / Π_cᵀAΠ_c, the level values and the smoother recompute."""
        from ..algebra.convert import to_scipy

        host = state.get("host") if isinstance(state, dict) else None
        if host is None:
            return self.setup(A, x)
        amg = self._amg()
        Afull = to_scipy(A).tocsr()
        dt, dev = A.dtype, A.device

        def project(P):
            return ell_from_scipy(_regularized((P.T @ Afull @ P).tocsr()), dtype=dt, device=dev)

        new = dict(state)
        new["node"] = amg.update(state["node"], project(host["G"]))
        new["sm"] = self._sm().update(state["sm"], A)
        new["A"] = A
        if self.vector_correction and "Pi" in state:
            new["vec"] = tuple(
                amg.update(vs, project(Pi_c)) for Pi_c, vs in zip(host["Pis"], state["vec"])
            )
        return new

    def apply(self, state, r):
        z = self._sm().apply(state["sm"], r)
        flat = pt.ravel(r)
        amg = self._amg()
        acc = state["G"].matvec(amg.apply(state["node"], state["GT"].matvec(flat)))
        if self.vector_correction and "Pi" in state:
            for Pi, PiT, vs in zip(state["Pi"], state["PiT"], state["vec"]):
                acc = acc + Pi.matvec(amg.apply(vs, PiT.matvec(flat)))
        return pt.add(z, pt.unflatten_like(acc, r))

    def solve(self, state, b, x0=None):
        return self.apply(state, b), None

    def smooth(self, state, x, r):
        dx = self.apply(state, r)
        return pt.add(x, dx), pt.sub(r, state["A"].matvec(dx))


def make_ams(
    ncells,
    alpha: float = 1.0,
    beta: float = 1.0,
    smoother=None,
    vector_correction: bool = True,
    dtype=torch.float64,
    device=None,
):
    """Build (A, free_masks, AMSSolver) for the model curl-curl problem in
    the torch `dtype` on `device` (None: the card)."""
    A, free, sysd = curlcurl_operator(ncells, alpha, beta, dtype=dtype, device=device)
    return A, free, AMSSolver(system=sysd, smoother=smoother, vector_correction=vector_correction)
