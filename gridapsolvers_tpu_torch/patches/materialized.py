"""Materialized (assembled) Vanka smoother.

Port of `gridapsolvers_tpu/patches/materialized.py`. The batched Vanka
apply (gather r over patch dofs, per-patch dense solve, scatter-add) is a
LINEAR map in r. For linear problems its patch inverses are fixed after
set-up, so the whole smoother is assembled ONCE into one sparse matrix

    M_vanka = omega * ( W  Σ_p  S_p A_p^{-1} R_p  +  diag(uncovered) )

and each application is one SpMV per field block (kernel K3 on the card)
instead of a gather and an atomic scatter per patch dof. M_vanka's
bandwidth equals the patch span. Reference counterpart: BlockJacobiSolvers.jl's
matrix-extracted patch solves, with the patch loop folded into the matrix
at numerical set-up.

Set-up assembles M_vanka on the operator's device (`ell_blocks_from_coo`:
the COO stream of every patch inverse entry plus one diagonal slot a dof,
sorted, duplicates summed, explicit zeros kept, cut into field blocks) and
records the static refresh plan. `update` recomputes the batched inverses
at a new operator, segment-sums the stream into the summed entries and
writes them into a new `values` tensor of each block's same `ELLMatrix`
(pattern, `row_len` and `group` stay): the port's counterpart of the JAX
package's `pallas_ell_refresh`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from ..interfaces import Smoother
from ..utils import pytrees as pt
from .topology import PatchTopology
from .vanka import VankaSolver


def materialize_vanka(vanka: VankaSolver, state: dict, n: int) -> sp.csr_matrix:
    """Assemble the additive-Schwarz patch-solve map of a set-up
    VankaSolver into one scipy CSR (host)."""
    dofs = state["dofs"].cpu().numpy()
    inv = state["inv"].cpu().numpy()                   # (np, k, k)
    valid = dofs != n  # VankaSolver's dummy slot is always n
    rows = np.broadcast_to(dofs[:, :, None], inv.shape)
    cols = np.broadcast_to(dofs[:, None, :], inv.shape)
    m = valid[:, :, None] & valid[:, None, :]
    M = sp.coo_matrix((inv[m], (rows[m], cols[m])), shape=(n, n)).tocsr()  # overlaps ADD
    if vanka.weighting == "overlap":
        M = sp.diags(state["wdof"].cpu().numpy()[:n]) @ M
    M = M + sp.diags(state["uncovered_inv_diag"].cpu().numpy()[:n])
    return (vanka.omega * M).tocsr()


@dataclasses.dataclass(frozen=True, eq=False)
class MaterializedVankaSmoother(Smoother):
    """VankaSolver-equivalent smoother whose apply is one SpMV per field
    block.

    Same constructor surface as VankaSolver (topo/omega/weighting/
    jacobi_uncovered); the kernel is chosen by the vector's device.
    `band_dtype` stores M_vanka's values narrower (bf16: f32 sums on K3)."""

    topo: PatchTopology = None
    omega: float = 1.0
    weighting: str = "overlap"  # same default as VankaSolver
    seed_field: int = -1
    jacobi_uncovered: bool = True
    band_dtype: object = None

    def _vanka(self) -> VankaSolver:
        return VankaSolver(topo=self.topo, omega=self.omega, weighting=self.weighting,
                           seed_field=self.seed_field, jacobi_uncovered=self.jacobi_uncovered)

    def setup(self, A, x=None):
        """Assemble M_vanka into per-field ELL blocks on the device and
        record the static refresh plan that makes `update` device work."""
        from ..algebra.flat import blocked_kernel_from_coo

        inner = getattr(A, "inner", A)
        vst = self._vanka().setup(inner)
        n = int(vst["uncovered_inv_diag"].shape[0])
        dev = vst["inv"].device
        sizes = vst["meta"].row_sizes

        # static stream: every valid (p, i, j) -> (row, col) coo entry, plus
        # one diagonal slot per dof (uncovered point-Jacobi)
        dofs = vst["dofs"]
        valid = dofs != n
        pair = valid[:, :, None] & valid[:, None, :]
        rows = dofs[:, :, None].expand(pair.shape)[pair]
        cols = dofs[:, None, :].expand(pair.shape)[pair]
        w_coo = vst["wdof"][rows] if self.weighting == "overlap" else None
        drow = torch.arange(n, device=dev)
        data = vst["inv"][pair]
        if w_coo is not None:
            data = data * w_coo
        data0 = torch.cat([data, vst["uncovered_inv_diag"]])
        Mop, plan = blocked_kernel_from_coo(
            torch.cat([rows, drow]), torch.cat([cols, drow]), self.omega * data0, sizes,
            band_dtype=self.band_dtype, refreshable=True, plan=True)
        del rows, cols, data, data0
        return {"A": A, "Mv": Mop, "vst": vst, "pair": pair, "w_coo": w_coo,
                "plan": {"inv": plan["inv"].to(torch.int32), "n": plan["n"],
                         "blocks": tuple((i, j, n_b, K_b, sel.to(torch.int32), flat)
                                         for i, j, n_b, K_b, sel, flat in plan["blocks"])}}

    def update(self, state, A, x=None):
        """numerical_setup! on the device: new batched patch inverses ->
        segment sum into the assembled pattern -> values-only refresh of
        each block (same pattern, new `values`)."""
        inner = getattr(A, "inner", A)
        vst = self._vanka().update(state["vst"], inner)
        data = vst["inv"][state["pair"]]
        if state["w_coo"] is not None:
            data = data * state["w_coo"]
        stream = torch.cat([data, vst["uncovered_inv_diag"]])
        plan = state["plan"]
        summed = torch.zeros(plan["n"], dtype=stream.dtype, device=stream.device)
        summed = self.omega * summed.index_add_(0, plan["inv"], stream)
        kb = [list(row) for row in state["Mv"].kblocks]
        for i, j, n_b, K_b, sel, flat in plan["blocks"]:
            blk = kb[i][j]
            vals = torch.zeros(n_b * K_b, dtype=blk.values.dtype, device=stream.device)
            vals[flat] = summed[sel].to(vals.dtype)
            kb[i][j] = dataclasses.replace(blk, values=vals.reshape(n_b, K_b))
        Mop = dataclasses.replace(state["Mv"], kblocks=tuple(tuple(r) for r in kb))
        new = dict(state)
        new.update({"A": A, "Mv": Mop, "vst": vst})
        return new

    def apply(self, state, r):
        return state["Mv"].matvec(r)

    def smooth(self, state, x, r):
        dx = self.apply(state, r)
        return pt.add(x, dx), pt.sub(r, state["A"].matvec(dx))

    def solve(self, state, b, x0=None):
        x = pt.zeros_like(b) if x0 is None else x0
        r = pt.sub(b, state["A"].matvec(x))
        x, _ = self.smooth(state, x, r)
        return x, None
