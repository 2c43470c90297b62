"""Patch-based smoothers as batched dense operations.

Port of `gridapsolvers_tpu/patches/smoothers.py` (reference
PatchBasedSmoothers, src/PatchBasedSmoothers/PatchSolvers.jl,
BlockJacobiSolvers.jl). All patches have one padded width, so the whole
smoother is three batched operations on the device:

    gather   (n_patches, k)        <- r[patch_dofs]
    solve    (n_patches, k, k) batched explicit inverses (one batched matmul)
    scatter-add with overlap weights -> additive Schwarz over patches

Patch matrices are extracted from the assembled operator through its ELL
view (`algebra/ell_view.py`); re-extraction at a new Newton iterate re-runs
the same gather (numerical_setup! analog). The extraction runs in chunks
of patches (`extract_patch_matrices_ell`), so its (patches, k, k, K) match
tensor never exceeds a fixed size: at 512^2 cells the vertex-star Vanka's
whole tensor would hold 4.2e9 entries. The scatter-add is `index_add_`,
which sums in no fixed order on CUDA (atomics).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..interfaces import Smoother
from ..utils import pytrees as pt
from .topology import PatchTopology

# entries of one chunk's (patches, k, k, K) match tensor
EXTRACT_CHUNK_ENTRIES = 1 << 25


def _extend(v: torch.Tensor) -> torch.Tensor:
    """Append the dummy slot (one zero) to a flat vector."""
    return torch.cat([v, torch.zeros((1,), dtype=v.dtype, device=v.device)])


def extract_patch_matrices_ell(A, dofs, dummy: int, chunk: int = None) -> torch.Tensor:
    """(n_patches, k, k) dense patch matrices from an ELLMatrix, on its
    device: A_p[p, i, j] = A[dofs[p,i], dofs[p,j]]; padded slots get the
    identity. `chunk` patches at a time (default: as many as keep the
    match tensor within EXTRACT_CHUNK_ENTRIES entries)."""
    vals, cols = A.values, A.cols
    d = torch.as_tensor(dofs, device=vals.device).to(torch.int64)
    n_p, k = d.shape
    K = vals.shape[1]
    if chunk is None:
        chunk = max(1, EXTRACT_CHUNK_ENTRIES // max(1, k * k * K))
    safe = d.clamp(max=vals.shape[0] - 1)
    Ap = torch.empty((n_p, k, k), dtype=vals.dtype, device=vals.device)
    for lo in range(0, n_p, chunk):
        hi = min(lo + chunk, n_p)
        rows = safe[lo:hi]
        row_vals = vals[rows]                          # (c, k, K)
        row_cols = cols[rows].to(torch.int64)          # (c, k, K)
        match = row_cols[:, :, None, :] == d[lo:hi, None, :, None]  # (c, k, k, K)
        Ap[lo:hi] = torch.where(match, row_vals[:, :, None, :], 0.0).sum(dim=-1)
    valid = d != dummy
    vi = valid[:, :, None] & valid[:, None, :]
    eye = torch.eye(k, dtype=vals.dtype, device=vals.device)[None]
    return torch.where(vi, Ap, eye)


def extract_patch_matrices_stencil(A, dofs, dummy: int, chunk: int = None) -> torch.Tensor:
    """Patch matrices from a StencilMatrix via its banded ELL view."""
    from ..algebra.ell_view import ell_view

    ell, _, _ = ell_view(A)
    return extract_patch_matrices_ell(ell, dofs, dummy, chunk)


def _dof_table(topo: PatchTopology, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(topo.dofs, dtype=np.int64), device=device)


@dataclasses.dataclass(frozen=True, eq=False)
class PatchSolver(Smoother):
    """Overlapping additive-Schwarz patch smoother on a flat-vector operator
    (reference PatchSolvers.jl solve_patch_overlapping!:227-277).

    weighting: 'unit' (plain scatter-add, reference overlapping behavior),
    'overlap' (divide by patch multiplicity), or 'nonoverlapping' (each
    dof written by exactly one patch: the reference's
    solve_patch_nonoverlapping!, last patch wins). omega damps the update.
    """

    topo: PatchTopology
    omega: float = 1.0
    weighting: str = "unit"
    spd: bool = True  # API parity: both paths use explicit patch inverses

    def setup(self, A, x=None):
        """Pattern work happens once here; `update` is device work only."""
        from ..algebra.ell_view import ell_pattern

        meta, ell_cols, leaf_masks = ell_pattern(A)
        dev = ell_cols.device
        cov = self.topo.overlap_counts()
        state = {
            "meta": meta,
            "ell_cols": ell_cols,
            "leaf_masks": leaf_masks,
            "dofs": _dof_table(self.topo, dev),
            "uncov": torch.as_tensor(cov[: self.topo.n_dofs] == 0, device=dev),
        }
        if self.weighting == "overlap":
            state["wdof"] = torch.as_tensor(1.0 / np.maximum(cov, 1.0), device=dev,
                                            dtype=A.dtype)
        elif self.weighting == "nonoverlapping":
            state["wslot"] = torch.as_tensor(self.topo.owner_slot_mask(), device=dev,
                                             dtype=A.dtype)
        return self._refresh(state, A)

    def update(self, state, A, x=None):
        """Re-extract and re-invert on the device (reference
        PatchSolvers.jl numerical_setup! re-assembly)."""
        return self._refresh(state, A)

    def _refresh(self, state, A):
        from ..algebra.ell import ELLMatrix
        from ..algebra.ell_view import ell_values

        meta = state["meta"]
        ell = ELLMatrix(ell_values(A, meta, state["leaf_masks"]), state["ell_cols"], meta.n_cols)
        Ap = extract_patch_matrices_ell(ell, state["dofs"], self.topo.dummy)
        new = dict(state)
        # explicit batched inverses (a library call, as the JAX package's
        # jnp.linalg.inv): the apply-time solve is one batched matmul
        new["inv"] = torch.linalg.inv(Ap)
        # dofs no patch covers (e.g. eliminated Dirichlet rows with identity
        # diagonal) get a point-Jacobi update so the smoother's error
        # propagation covers the whole space
        new["uncovered_inv_diag"] = torch.where(state["uncov"], 1.0 / A.diag(), 0.0)
        new["A"] = A
        return new

    def apply(self, state, r):
        dofs = state["dofs"]
        re = _extend(r)
        valid = dofs != self.topo.dummy
        rp = torch.where(valid, re[dofs], 0.0)
        dxp = torch.bmm(state["inv"], rp[:, :, None])[:, :, 0]
        dxp = torch.where(valid, dxp, 0.0)
        if self.weighting == "nonoverlapping":
            dxp = dxp * state["wslot"]
        z = torch.zeros_like(re).index_add_(0, dofs.reshape(-1), dxp.reshape(-1))[: r.shape[0]]
        if self.weighting == "overlap":
            z = z * state["wdof"][: r.shape[0]]
        z = z + state["uncovered_inv_diag"] * r
        return self.omega * z

    def smooth(self, state, x, r):
        dx = self.apply(state, r)
        return x + dx, r - state["A"].matvec(dx)

    def solve(self, state, b, x0=None):
        x = pt.zeros_like(b) if x0 is None else x0
        r = b - state["A"].matvec(x)
        x, _ = self.smooth(state, x, r)
        return x, None
