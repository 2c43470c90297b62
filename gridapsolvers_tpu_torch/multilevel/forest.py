"""Multi-patch (forest-of-boxes) adaptive hierarchies — scattered marking.

Port of `gridapsolvers_tpu/multilevel/forest.py`. Generalizes
`multilevel/adaptive.py` (one nested box per level) to MANY disjoint boxes
per level, each attached to a parent patch: the block-structured
counterpart of p4est's scattered per-cell marking
(ext/GridapP4estExt/GridapP4estExt.jl:25-39). Marked cells are clustered
into axis-aligned boxes (connected components + merge-until-separated),
so disconnected features each get their own refined patch while every
patch stays a dense uniform grid.

The composite operator is the exact hanging-node-constrained Galerkin sum
A = Σ_p E_pᵀ A_p E_p, one term per PATCH (one K2 launch a patch on the
card). FACE-ADJACENT siblings are glued through SEAMS: the lower-indexed
patch OWNS the shared-plane dofs, the other patch's plane is slaved to it
(copy in E, adjoint scatter-add in Eᵀ), and parent vertices whose whole
cell neighbourhood is covered by the union of child boxes are pinned.
Construction asserts that every parent vertex a ring reads stays uncovered
(rim exposure): a T-junction of three boxes violates it and raises.

`ForestPreconditioner` is the FAC-style block preconditioner: a GMG
V-cycle per patch on the patch's own uniform grid (Chebyshev(3) with the
Gershgorin bound, banded K2 levels, dense LU at the coarsest).

Marking, seams and masks are host NumPy (and `scipy.ndimage.label`), as in
the JAX package; the masks an operator applies live on its device.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..fem.assembly import assemble_q1_stencil_var, eliminate_dirichlet, q1_element_matrices
from ..fem.mesh import CartesianMesh
from ..utils import numpy_dtype, resolve_device
from .adaptive import _cell_centers, _level_rhs, _ring_mask, box_mesh, estimate_cells
from .transfer import prolong_slices, restrict_slices


@dataclasses.dataclass(frozen=True)
class Patch:
    """One refined box. `lo`/`hi` are cell ranges [lo, hi) in the PARENT
    patch's cell indices; `parent` indexes the previous level's patches.
    The base level has a single patch with parent = -1."""

    mesh: CartesianMesh
    lo: Optional[Tuple[int, ...]] = None
    hi: Optional[Tuple[int, ...]] = None
    parent: int = -1


@dataclasses.dataclass
class ForestHierarchy:
    """levels[0] = [base patch]; levels[l] = list of level-l patches."""

    levels: List[List[Patch]]

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    def refine(self, boxes_per_patch: Sequence[Sequence[Tuple[tuple, tuple]]]) -> "ForestHierarchy":
        """Append a level refining, for each finest-level patch p, the
        cell boxes boxes_per_patch[p] (each (lo, hi)) by factor 2."""
        parents = self.levels[-1]
        assert len(boxes_per_patch) == len(parents)
        new: List[Patch] = []
        for pi, (par, boxes) in enumerate(zip(parents, boxes_per_patch)):
            for lo, hi in boxes:
                lo = tuple(int(x) for x in lo)
                hi = tuple(int(x) for x in hi)
                assert all(0 <= a < b <= n for a, b, n in zip(lo, hi, par.mesh.ncells)), (
                    lo, hi, par.mesh.ncells)
                new.append(Patch(box_mesh(par.mesh, lo, hi), lo, hi, parent=pi))
        assert new, "refine() with no boxes"
        return ForestHierarchy(self.levels + [new])


def forest_hierarchy(base_mesh: CartesianMesh) -> ForestHierarchy:
    return ForestHierarchy([[Patch(base_mesh)]])


# ------------------------------------------------------------------ marking


def _union(b1, b2):
    return (tuple(min(a, b) for a, b in zip(b1[0], b2[0])),
            tuple(max(a, b) for a, b in zip(b1[1], b2[1])))


def mark_boxes(
    est: np.ndarray,
    theta: float = 0.5,
    thresh: Optional[float] = None,
    pad: int = 1,
    align: int = 1,
    gap: int = 1,
    max_boxes: int = 8,
) -> List[Tuple[tuple, tuple]]:
    """Cluster cells with est > theta*max (or > thresh if given) into
    disjoint boxes: connected components -> bounding boxes -> merge any
    two boxes closer than `gap` cells -> pad/align/clip -> re-merge ->
    merge closest pairs down to max_boxes (host NumPy and scipy)."""
    from scipy import ndimage

    est = np.asarray(est)
    cut = thresh if thresh is not None else theta * est.max()
    marked = est > cut
    if not marked.any():
        return []
    labels, nlab = ndimage.label(marked)
    d = est.ndim

    def bbox(mask):
        lo, hi = [], []
        for ax in range(d):
            idx = np.nonzero(mask.any(axis=tuple(k for k in range(d) if k != ax)))[0]
            lo.append(int(idx[0]))
            hi.append(int(idx[-1]) + 1)
        return tuple(lo), tuple(hi)

    def finalize(box):
        lo, hi = [], []
        for ax in range(d):
            a = max(box[0][ax] - pad, 0)
            b = min(box[1][ax] + pad, est.shape[ax])
            lo.append((a // align) * align)
            hi.append(min(-(-b // align) * align, est.shape[ax]))
        return tuple(lo), tuple(hi)

    def too_close(b1, b2):
        return all(b1[0][ax] < b2[1][ax] + gap and b2[0][ax] < b1[1][ax] + gap
                   for ax in range(d))

    def merge_pass(boxes, limit):
        changed = True
        while changed or len(boxes) > limit:
            changed = False
            for i in range(len(boxes)):
                for j in range(i + 1, len(boxes)):
                    if too_close(boxes[i], boxes[j]):
                        boxes[i] = _union(boxes[i], boxes[j])
                        del boxes[j]
                        changed = True
                        break
                if changed:
                    break
            if not changed and len(boxes) > limit:
                # merge the pair with the smallest union volume
                best, bi, bj = None, 0, 1
                for i in range(len(boxes)):
                    for j in range(i + 1, len(boxes)):
                        u = _union(boxes[i], boxes[j])
                        vol = int(np.prod([b - a for a, b in zip(u[0], u[1])]))
                        if best is None or vol < best:
                            best, bi, bj = vol, i, j
                boxes[bi] = _union(boxes[bi], boxes[bj])
                del boxes[bj]
                changed = True
        return boxes

    # merge raw component boxes first, then pad/align and re-merge whatever
    # the inflation brought into contact
    boxes = merge_pass([bbox(labels == k) for k in range(1, nlab + 1)], max_boxes)
    boxes = merge_pass([finalize(b) for b in boxes], max_boxes)
    if gap == 0:
        boxes = repair_junctions(boxes, est.shape)
    return boxes


def repair_junctions(
    boxes: List[Tuple[tuple, tuple]], ncells: Tuple[int, ...]
) -> List[Tuple[tuple, tuple]]:
    """Merge face-adjacent boxes until no T-junctions remain: merge the two
    touching boxes with the largest contact area among those meeting at a
    T-point (a parent vertex whose whole cell neighbourhood is covered by
    >= 3 boxes); iterate until clean. No-op for separated boxes."""
    d = len(ncells)

    def owners(boxes):
        own = np.full(ncells, -1, dtype=np.int64)
        for i, (lo, hi) in enumerate(boxes):
            own[tuple(slice(a, b) for a, b in zip(lo, hi))] = i
        return own

    def contact(b1, b2):
        """Shared-face area of two touching boxes (0 if not touching)."""
        area = 0
        for ax in range(d):
            if b1[1][ax] == b2[0][ax] or b2[1][ax] == b1[0][ax]:
                a = 1
                for e in range(d):
                    if e != ax:
                        a *= max(0, min(b1[1][e], b2[1][e]) - max(b1[0][e], b2[0][e]))
                area = max(area, a)
        return area

    while len(boxes) > 1:
        ownpad = np.pad(owners(boxes), 1, constant_values=-1)
        vshape = tuple(n + 1 for n in ncells)
        stacks = np.stack([
            ownpad[tuple(slice(c, c + v) for c, v in zip(cc, vshape))]
            for cc in itertools.product((0, 1), repeat=d)
        ])
        allcov = (stacks >= 0).all(axis=0)
        nown = np.zeros(vshape, dtype=np.int64)
        for i in range(len(boxes)):
            nown += (stacks == i).any(axis=0)
        tpoints = np.argwhere(allcov & (nown >= 3))
        if len(tpoints) == 0:
            return boxes
        ids = sorted(set(stacks[(slice(None),) + tuple(tpoints[0])]) - {-1})
        _, i, j = max((contact(boxes[i], boxes[j]), i, j)
                      for i, j in itertools.combinations(ids, 2))
        boxes = [b for k, b in enumerate(boxes) if k not in (i, j)] + [
            _union(boxes[i], boxes[j])]
    return boxes


# ------------------------------------------------- composite forest operator


def _covered_interior_mask(shape, lo, hi) -> np.ndarray:
    m = np.zeros(shape, dtype=bool)
    m[tuple(slice(a + 1, b) for a, b in zip(lo, hi))] = True
    return m


def _union_covered_pin(ncells, vertex_shape, boxes) -> np.ndarray:
    """Vertices ALL of whose adjacent cells are covered by the union of
    the child boxes (with face-adjacent boxes this also pins the shared
    plane between them)."""
    cov = np.zeros(ncells, dtype=bool)
    for lo, hi in boxes:
        cov[tuple(slice(a, b) for a, b in zip(lo, hi))] = True
    covpad = np.pad(cov, 1, constant_values=False)
    allcov = np.ones(vertex_shape, dtype=bool)
    for c in itertools.product((0, 1), repeat=len(ncells)):
        allcov &= covpad[tuple(slice(cd, cd + vs) for cd, vs in zip(c, vertex_shape))]
    return allcov


def _detect_seams(metas, shapes):
    """Face-adjacency seams between same-level, same-parent patches.

    Returns (seams, own_masks, slv_masks). Each seam is a record
    (k_own, k_slv, own_box, slv_box): per-dim (start, stop) index ranges
    into each patch's fine VERTEX grid covering the strict interior of the
    shared-face overlap (the rim stays parent-slaved). The owner is always
    the lower flat index."""
    K = len(metas)
    seams = []
    own_masks = [np.zeros(s, dtype=bool) for s in shapes]
    slv_masks = [np.zeros(s, dtype=bool) for s in shapes]
    for j in range(K):
        lj, pj, loj, hij = metas[j]
        if pj < 0:
            continue  # the base patch has no siblings
        for k in range(j + 1, K):
            lk, pk, lok, hik = metas[k]
            if lk != lj or pk != pj:
                continue
            dim = len(loj)
            assert not all(loj[d] < hik[d] and lok[d] < hij[d] for d in range(dim)), (
                f"sibling patches overlap: {(loj, hij)} vs {(lok, hik)}")
            for ax in range(dim):
                touch_r = hij[ax] == lok[ax]
                touch_l = hik[ax] == loj[ax]
                if not (touch_r or touch_l):
                    continue
                o = [(max(loj[d], lok[d]), min(hij[d], hik[d])) for d in range(dim)]
                if any(o[d][0] >= o[d][1] for d in range(dim) if d != ax):
                    continue  # edge/corner contact: parent slaving suffices
                own_box, slv_box = [], []
                for d in range(dim):
                    if d == ax:
                        pj_pl = 2 * (hij[ax] - loj[ax]) if touch_r else 0
                        pk_pl = 0 if touch_r else 2 * (hik[ax] - lok[ax])
                        own_box.append((pj_pl, pj_pl + 1))
                        slv_box.append((pk_pl, pk_pl + 1))
                    else:
                        a, b = o[d]
                        own_box.append((2 * (a - loj[d]) + 1, 2 * (b - loj[d])))
                        slv_box.append((2 * (a - lok[d]) + 1, 2 * (b - lok[d])))
                seams.append((j, k, tuple(own_box), tuple(slv_box)))
                own_masks[j][_sl(own_box)] = True
                slv_masks[k][_sl(slv_box)] = True
    return seams, own_masks, slv_masks


def _assert_rim_exposure(metas, shapes, ring_par_masks, pin_cov_masks):
    """Every parent vertex read by a patch's parent-slaved ring must stay
    uncovered (its full value is reconstructible). A T-junction of three
    face-adjacent boxes covers a seam-rim vertex and violates this."""
    for k, (lev, par, lo, hi) in enumerate(metas):
        if par < 0:
            continue
        dim = len(lo)
        fine = np.pad(ring_par_masks[k], 1, constant_values=False)
        wshape = tuple(b - a + 1 for a, b in zip(lo, hi))
        read = np.zeros(wshape, dtype=bool)
        for e in itertools.product((-1, 0, 1), repeat=dim):
            read |= fine[np.ix_(*[2 * np.arange(w) + ed + 1 for w, ed in zip(wshape, e)])]
        pinned = pin_cov_masks[par][tuple(slice(a, b + 1) for a, b in zip(lo, hi))]
        if (read & pinned).any():
            raise ValueError(
                "forest seam rim is covered (e.g. a T-junction of "
                "face-adjacent sibling boxes, or a child box covering a "
                "parent's seam face): merge the offending boxes — patch "
                f"{k} reads pinned parent vertices at "
                f"{np.argwhere(read & pinned)[:4].tolist()}"
            )


def _sl(box):
    return tuple(slice(a, b) for a, b in box)


def _vertex_slice(lo, hi):
    return tuple(slice(a, b + 1) for a, b in zip(lo, hi))


@dataclasses.dataclass
class ForestCompositeOperator:
    """Exact composite Galerkin operator over a patch forest; acts on
    tuples of per-patch flat vectors (level-major flat order).

    ops[k]     : patch-k StencilMatrix over its UNCOVERED cells
    active[k]  : 1.0 on composite dofs, 0.0 on pinned (ring slaves,
                 covered interiors, Dirichlet)
    ring_par[k]: bool mask of dofs slaved to the PARENT (the hanging ring
                 minus any seam dofs, which are owner-glued instead)
    meta       : per-patch (level, parent flat index, lo, hi)
    seams      : (k_own, k_slv, own_box, slv_box) face-gluing records
    shapes     : vertex shapes.
    """

    ops: Tuple
    active: Tuple
    ring_par: Tuple
    meta: Tuple
    seams: Tuple
    shapes: Tuple

    @property
    def grid_shape(self):
        return self.shapes[0]

    def _extend(self, u):
        full = []
        for k, (lev, par, lo, hi) in enumerate(self.meta):
            ug = u[k].reshape(self.shapes[k])
            if par < 0:
                full.append(ug)
                continue
            g = prolong_slices(full[par][_vertex_slice(lo, hi)])
            base = torch.where(self.ring_par[k].reshape(self.shapes[k]), g, ug)
            # seam gluing: slave faces copy the owner's (already built,
            # lower flat index) values — coincident fine vertices
            for ko, ks, ob, sb in self.seams:
                if ks == k:
                    base[_sl(sb)] = full[ko][_sl(ob)]
            full.append(base)
        return full

    def matvec(self, u):
        K = len(self.ops)
        full = self._extend(u)
        ys = [self.ops[k].matvec(full[k].reshape(-1)).reshape(self.shapes[k])
              for k in range(K)]
        out = [None] * K
        for k in range(K - 1, -1, -1):
            lev, par, lo, hi = self.meta[k]
            yg = ys[k]
            # adjoint of the seam copy: slave contributions accumulate on
            # the owner (processed later in this reverse sweep)
            for ko, ks, ob, sb in self.seams:
                if ks == k:
                    ys[ko][_sl(ob)] += yg[_sl(sb)]
            if par >= 0:
                rc = torch.where(self.ring_par[k].reshape(self.shapes[k]), yg, 0.0)
                ys[par][_vertex_slice(lo, hi)] += restrict_slices(rc)
            a = self.active[k].reshape(self.shapes[k])
            ug = u[k].reshape(self.shapes[k])
            out[k] = (a * yg + (1.0 - a) * ug).reshape(-1)
        return tuple(out)

    def diag(self):
        K = len(self.ops)
        # copies: diag() is a view of the operator's centre band
        ds = [self.ops[k].diag().reshape(self.shapes[k]).clone() for k in range(K)]
        for k in range(K - 1, -1, -1):
            lev, par, lo, hi = self.meta[k]
            for ko, ks, ob, sb in self.seams:
                if ks == k:
                    ds[ko][_sl(ob)] += ds[k][_sl(sb)]
            if par >= 0:
                rc = torch.where(self.ring_par[k].reshape(self.shapes[k]), ds[k], 0.0)
                ds[par][_vertex_slice(lo, hi)] += rc[
                    tuple(slice(None, None, 2) for _ in self.shapes[k])]
        out = []
        for k in range(K):
            a = self.active[k].reshape(self.shapes[k])
            out.append((a * ds[k] + (1.0 - a)).reshape(-1))
        return tuple(out)

    @property
    def n(self):
        return sum(int(np.prod(s)) for s in self.shapes)


def forest_composite_system(
    hier: ForestHierarchy,
    f: Callable[[np.ndarray], np.ndarray],
    kappa: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    dtype=torch.float64,
    device=None,
):
    """Assemble -div(kappa grad u) = f over the forest (homogeneous
    Dirichlet on the true domain boundary) on `device` (None: the card).
    Same structure as adaptive.composite_system, one term per patch."""
    dev = resolve_device(device)
    np_dtype = numpy_dtype(dtype)
    # flat patch order (level-major) + parent flat indices
    flat: List[Patch] = []
    flat_idx: List[List[int]] = []
    for patches in hier.levels:
        flat_idx.append(list(range(len(flat), len(flat) + len(patches))))
        flat.extend(patches)

    # children per flat patch: (child cell box) for indicator masking
    children: List[List[Tuple[tuple, tuple]]] = [[] for _ in flat]
    for l in range(1, hier.num_levels):
        for patch in hier.levels[l]:
            children[flat_idx[l - 1][patch.parent]].append((patch.lo, patch.hi))

    # static metadata first: seams need the full patch list
    metas, shapes = [], []
    for l, patches in enumerate(hier.levels):
        for patch in patches:
            par = -1 if patch.parent < 0 or l == 0 else flat_idx[l - 1][patch.parent]
            metas.append((l, par, patch.lo, patch.hi))
            shapes.append(patch.mesh.vertex_shape)
    seams, own_masks, slv_masks = _detect_seams(metas, shapes)

    ops, actives, ring_pars, rhs, pin_covs = [], [], [], [], []
    for l, patches in enumerate(hier.levels):
        for p, patch in zip(flat_idx[l], patches):
            mesh = patch.mesh
            Ke, _ = q1_element_matrices(mesh.h)
            ind = np.ones(mesh.ncells, dtype=np_dtype)
            for lo, hi in children[p]:
                ind[tuple(slice(a, b) for a, b in zip(lo, hi))] = 0.0
            kap = ind if kappa is None else ind * kappa(_cell_centers(mesh)).reshape(mesh.ncells)
            shape = mesh.vertex_shape
            ring = _ring_mask(shape)
            pin_cov = _union_covered_pin(mesh.ncells, shape, children[p])
            pin = pin_cov.copy()
            if l == 0:
                pin |= mesh.boundary_vertex_mask()
                ring_par = np.zeros(shape, dtype=bool)
            else:
                # owner-side seam dofs are ACTIVE composite unknowns;
                # slave-side ones stay pinned (glued to the owner)
                assert not (own_masks[p] & pin_cov).any(), (
                    "a child box covers its patch's seam face: merge the offending boxes")
                pin |= ring & ~own_masks[p]
                ring_par = ring & ~own_masks[p] & ~slv_masks[p]
            ops.append(assemble_q1_stencil_var(mesh, Ke, kap, dtype, dev))
            actives.append(torch.from_numpy((~pin).astype(np_dtype)).to(dev))
            ring_pars.append(ring_par)
            pin_covs.append(pin_cov)
            rhs.append(_level_rhs(mesh, f, ind, dtype, dev))

    _assert_rim_exposure(metas, shapes, ring_pars, pin_covs)
    ring_par_t = tuple(torch.from_numpy(r).to(dev) for r in ring_pars)

    # loads cascade finest-first: seam slaves onto owners, rings to parents
    for k in range(len(flat) - 1, -1, -1):
        l, par, lo, hi = metas[k]
        for ko, ks, ob, sb in seams:
            if ks == k:
                rhs[ko][_sl(ob)] += rhs[k][_sl(sb)]
        if par >= 0:
            rc = torch.where(ring_par_t[k], rhs[k], 0.0)
            rhs[par][_vertex_slice(lo, hi)] += restrict_slices(rc)
    out_rhs = tuple((rhs[k] * actives[k].reshape(shapes[k])).reshape(-1)
                    for k in range(len(flat)))
    op = ForestCompositeOperator(ops=tuple(ops), active=tuple(actives), ring_par=ring_par_t,
                                 meta=tuple(metas), seams=tuple(seams), shapes=tuple(shapes))
    return op, out_rhs


def forest_on_finest(hier: ForestHierarchy, us):
    """The composite function sampled on the uniformly refined base grid
    (base refined 2^(L-1)): prolong the running field and overlay each
    patch at its global offset, level by level."""
    u = us[0].reshape(hier.levels[0][0].mesh.vertex_shape)
    mesh = hier.levels[0][0].mesh
    # global cell offsets per patch of the current level
    offsets = [tuple(0 for _ in range(mesh.dim))]
    k = 1
    for l in range(1, hier.num_levels):
        u = prolong_slices(u)
        mesh = mesh.refine(2)
        new_offsets = []
        for patch in hier.levels[l]:
            off = tuple(2 * (o + a) for o, a in zip(offsets[patch.parent], patch.lo))
            u[tuple(slice(o, o + n) for o, n in zip(off, patch.mesh.vertex_shape))] = (
                us[k].reshape(patch.mesh.vertex_shape))
            new_offsets.append(off)
            k += 1
        offsets = new_offsets
    return u, mesh


def finest_estimates(hier: ForestHierarchy, us) -> List[np.ndarray]:
    """`estimate_cells` on each finest-level patch, read to the host."""
    finest = hier.levels[-1]
    n_prev = sum(len(lv) for lv in hier.levels[:-1])
    return [estimate_cells(us[n_prev + i].reshape(-1), p.mesh).cpu().numpy()
            for i, p in enumerate(finest)]


def adaptive_solve_scattered(
    base_mesh: CartesianMesh,
    f,
    kappa=None,
    num_rounds: int = 2,
    theta: float = 0.25,
    rtol: float = 1e-10,
    max_boxes: int = 8,
    dtype=torch.float64,
    device=None,
):
    """Scattered-marking AMR driver: solve -> estimate per finest patch ->
    cluster marks into boxes (one threshold across the finest front) ->
    refine -> re-solve. Each disconnected feature gets its own patch."""
    hier = forest_hierarchy(base_mesh)
    us, _ = forest_solve(hier, f, kappa, rtol=rtol, dtype=dtype, device=device)
    for _ in range(num_rounds):
        ests = finest_estimates(hier, us)
        cut = theta * max(e.max() for e in ests)
        boxes_per_patch = [mark_boxes(e, thresh=cut, max_boxes=max_boxes) for e in ests]
        if not any(boxes_per_patch):
            break
        hier = hier.refine(boxes_per_patch)
        us, _ = forest_solve(hier, f, kappa, rtol=rtol, dtype=dtype, device=device)
    return hier, us


# --------------------------------------------------- FAC-style preconditioner


@dataclasses.dataclass(frozen=True)
class ForestPreconditioner:
    """Additive FAC-style block preconditioner for the composite forest
    system: EVERY patch — the base included — gets its own GMG V-cycle on
    its own uniform grid with Dirichlet at its boundary (domain boundary
    for the base, the slaved interface ring for refined patches); coarser
    levels are rediscretized from 2^d-averaged coefficient fields, and
    pinned dofs pass through as identity.

    Follows the solver protocol: setup(op)/apply(state, r), usable as
    CGSolver(Pl=ForestPreconditioner(hier), flexible=True); the state
    lives on the operator's device and dtype.
    """

    hier: ForestHierarchy = None
    kappa: object = None
    num_levels: int = 3

    def _patch_gmg(self, mesh: CartesianMesh, kappa, dtype, device):
        """GMG solver for ONE patch's own uniform grid, Dirichlet at its
        whole boundary, built on the UNMASKED coefficient field (the
        composite block zeroes child-covered cells; the plain field is
        spectrally equivalent on active dofs and the correction is masked
        by `active` afterwards)."""
        from ..linear import ChebyshevSmoother
        from ..linear.gmg import GMGSolver
        from .transfer import StructuredProlongation, StructuredRestriction

        np_dtype = numpy_dtype(dtype)
        L = max(1, min(self.num_levels, int(np.log2(max(min(mesh.ncells), 1)))))
        # each coarsening (and the field 2^d averaging) needs factor-2
        # divisibility; cap the depth by the axes' 2-adic valuation
        while L > 1 and any(n % 2 ** (L - 1) for n in mesh.ncells):
            L -= 1
        kap = (np.ones(mesh.ncells, dtype=np_dtype) if kappa is None
               else kappa(_cell_centers(mesh)).reshape(mesh.ncells))
        meshes, fields = [mesh], [kap]
        for _ in range(L - 1):
            fld = fields[-1]
            for ax in range(fld.ndim):
                fld = 0.5 * (fld.take(np.arange(0, fld.shape[ax], 2), axis=ax)
                             + fld.take(np.arange(1, fld.shape[ax], 2), axis=ax))
            meshes.append(meshes[-1].coarsen(2))
            fields.append(fld)

        ops = []
        for m, fld in zip(meshes, fields):
            Ke, _ = q1_element_matrices(m.h)
            A = assemble_q1_stencil_var(m, Ke, fld, dtype, device)
            ops.append(eliminate_dirichlet(A, m.boundary_vertex_mask()))

        def free(m):
            return torch.from_numpy((~m.boundary_vertex_mask()).astype(np_dtype)).to(device)

        Ps, Rs = [], []
        for l in range(L - 1):
            fshape, cshape = meshes[l].vertex_shape, meshes[l + 1].vertex_shape
            mf, mc = free(meshes[l]), free(meshes[l + 1])
            Ps.append(StructuredProlongation(fshape, cshape, mf))
            Rs.append(StructuredRestriction(fshape, cshape, "residual", mc, mf))
        gmg = GMGSolver(
            coarse_ops=tuple(ops[1:]),
            prolongations=tuple(Ps),
            restrictions=tuple(Rs),
            smoother=ChebyshevSmoother(degree=3, eig_method="gershgorin"),
        )
        return gmg, gmg.setup(ops[0])

    def setup(self, A: ForestCompositeOperator, x=None):
        flat = [p for level in self.hier.levels for p in level]
        assert len(flat) == len(A.shapes)
        dtype, dev = A.active[0].dtype, A.active[0].device
        gmgs = [self._patch_gmg(p.mesh, self.kappa, dtype, dev) for p in flat]
        return {"gmgs": gmgs, "active": A.active, "shapes": A.shapes}

    def apply(self, state, r):
        """Block-additive FAC: z_k = a_k GMG_k(a_k r_k) + (1-a_k) r_k."""
        out = []
        for k, rk in enumerate(r):
            gmg, gst = state["gmgs"][k]
            ak = state["active"][k].reshape(-1)
            out.append(ak * gmg.apply(gst, ak * rk) + (1.0 - ak) * rk)
        return tuple(out)


def forest_solve(
    hier: ForestHierarchy,
    f,
    kappa=None,
    rtol: float = 1e-10,
    maxiter: int = 2000,
    gmg_base: bool = False,
    dtype=torch.float64,
    device=None,
):
    """CG on the composite forest system; returns per-patch full grids
    (slave rings reconstructed) in level-major flat order, and the stats.

    gmg_base=True preconditions with ForestPreconditioner (a GMG V-cycle
    per patch) under flexible CG; otherwise point Jacobi."""
    from ..linear import CGSolver, JacobiSolver

    op, b = forest_composite_system(hier, f, kappa, dtype, device)
    if gmg_base:
        solver = CGSolver(Pl=ForestPreconditioner(hier, kappa), rtol=rtol, maxiter=maxiter,
                          flexible=True)
    else:
        solver = CGSolver(Pl=JacobiSolver(), rtol=rtol, maxiter=maxiter)
    x, stats = solver.solve(solver.setup(op), b)
    return op._extend(x), stats
