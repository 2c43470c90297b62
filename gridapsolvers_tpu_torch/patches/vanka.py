"""Vanka (block-Jacobi) smoother for mixed saddle-point systems.

Port of `gridapsolvers_tpu/patches/vanka.py` (reference BlockJacobiSolver,
ex-VankaSolver, src/PatchBasedSmoothers/BlockJacobiSolvers.jl:2-43,111-170):
patches seeded at the dofs of one field (pressure), each patch containing
the seed dof plus every dof it couples to through the seed field's block
row; patch matrices are EXTRACTED from the assembled block system (not
reassembled), inverted, and applied as batched overlapping solves with a
scatter-add (`index_add_`: on CUDA its sums run in no fixed order).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..algebra.convert import to_scipy
from ..algebra.ell import ELLMatrix
from ..algebra.ell_view import ell_pattern, ell_values
from ..interfaces import Smoother
from ..utils import pytrees as pt
from ..utils.pytrees import flatten_concat as _flatten
from ..utils.pytrees import unflatten_like as _unflatten
from .smoothers import _dof_table, extract_patch_matrices_ell
from .topology import PatchTopology


def vanka_patches(A, seed_field: int = -1) -> PatchTopology:
    """Vanka patches of an assembled BlockOperator (host): one patch per
    row of the seed field (default: last = pressure), holding that dof and
    every dof coupled through the seed field's block row."""
    from .. import native

    S = to_scipy(A).tocsr()
    sizes = _field_sizes(A)
    offs = np.cumsum([0] + sizes)
    if seed_field < 0:
        seed_field = len(sizes) + seed_field
    lo, hi = offs[seed_field], offs[seed_field + 1]
    dummy = S.shape[0]
    table = native.union_patches(S.indptr, S.indices, int(lo), int(hi), dummy)
    return PatchTopology(dofs=table, dummy=dummy, n_dofs=S.shape[0])


def _field_sizes(A) -> list:
    """Leaf field sizes of the block system in flatten order."""
    from ..algebra.block import FieldwiseOperator

    sizes = []
    n = len(A.blocks)
    for i in range(n):
        diag = A.blocks[i][i]
        if isinstance(diag, FieldwiseOperator):
            sizes.extend(o.shape[0] for o in diag.ops)
            continue
        if diag is not None and hasattr(diag, "shape"):
            sizes.append(diag.shape[0])
            continue
        # empty diagonal (e.g. Stokes pressure block): infer from couplings
        size = None
        for j in range(n):
            blk = A.blocks[i][j]
            if blk is not None and hasattr(blk, "shape"):
                size = blk.shape[0]
                break
        if size is None:
            for j in range(n):
                blk = A.blocks[j][i]
                if blk is not None and hasattr(blk, "shape"):
                    size = blk.shape[1]
                    break
        assert size is not None, f"cannot infer size of block field {i}"
        sizes.append(size)
    return sizes


@dataclasses.dataclass(frozen=True, eq=False)
class VankaSolver(Smoother):
    """Batched overlapping Vanka smoother over a BlockOperator system."""

    topo: PatchTopology = None
    omega: float = 1.0
    weighting: str = "overlap"
    seed_field: int = -1
    # point-Jacobi on dofs no patch covers (Dirichlet identity rows).
    # Disable when the solver is a patch CORRECTION that must leave
    # non-patch dofs untouched (patch prolongations).
    jacobi_uncovered: bool = True

    def setup(self, A, x=None):
        """Pattern construction happens once here; every later `update` is
        device work only (see _refresh)."""
        topo = self.topo if self.topo is not None else vanka_patches(A, self.seed_field)
        meta, ell_cols, leaf_masks = ell_pattern(A)
        dev = ell_cols.device
        cov = topo.overlap_counts()
        state = {
            "dofs": _dof_table(topo, dev),
            "meta": meta,
            "ell_cols": ell_cols,
            "leaf_masks": leaf_masks,
            "uncov": torch.as_tensor(cov[: topo.n_dofs] == 0, device=dev),
        }
        if self.weighting == "overlap":
            state["wdof"] = torch.as_tensor(1.0 / np.maximum(cov, 1.0), device=dev,
                                            dtype=A.dtype)
        return self._refresh(state, A)

    def update(self, state, A, x=None):
        """Re-extract and re-invert at the new operator (reference
        BlockJacobiSolvers.jl:141-170 numerical_setup!)."""
        return self._refresh(state, A)

    def _refresh(self, state, A):
        meta = state["meta"]
        ell = ELLMatrix(ell_values(A, meta, state["leaf_masks"]), state["ell_cols"], meta.n_cols)
        Ap = extract_patch_matrices_ell(ell, state["dofs"], meta.n_rows)
        # explicit batched patch inverses (a library call, as the JAX
        # package's jnp.linalg.inv): apply is one batched matmul
        inv = torch.linalg.inv(Ap)
        del Ap
        diag = ell.diag()
        uncovered_inv_diag = torch.where(
            state["uncov"] & self.jacobi_uncovered,
            1.0 / torch.where(diag == 0, 1.0, diag), 0.0)
        new = dict(state)
        new.update({"A": A, "inv": inv, "uncovered_inv_diag": uncovered_inv_diag})
        return new

    def apply(self, state, r):
        flat, info = _flatten(r)
        re = torch.cat([flat, torch.zeros((1,), dtype=flat.dtype, device=flat.device)])
        dofs = state["dofs"]
        valid = dofs != (re.shape[0] - 1)
        rp = torch.where(valid, re[dofs], 0.0)
        dxp = torch.bmm(state["inv"], rp[:, :, None])[:, :, 0]
        dxp = torch.where(valid, dxp, 0.0)
        z = torch.zeros_like(re).index_add_(0, dofs.reshape(-1), dxp.reshape(-1))
        z = z[:-1]
        if self.weighting == "overlap":
            z = z * state["wdof"][:-1]
        z = z + state["uncovered_inv_diag"] * flat
        return _unflatten(self.omega * z, info)

    def smooth(self, state, x, r):
        dx = self.apply(state, r)
        return pt.add(x, dx), pt.sub(r, state["A"].matvec(dx))

    def solve(self, state, b, x0=None):
        x = pt.zeros_like(b) if x0 is None else x0
        r = pt.sub(b, state["A"].matvec(x))
        x, _ = self.smooth(state, x, r)
        return x, None


# Reference naming alias (BlockJacobiSolver == matrix-extracted Vanka)
BlockJacobiSolver = VankaSolver
