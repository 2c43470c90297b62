"""Box-partitioned general-sparsity operators over multi-axis process meshes.

Port of `gridapsolvers_tpu/parallel/dist_ell_nd.py`. Dofs of a structured
grid are assigned to ranks by axis-aligned boxes (`BoxPartition`); every
rank holds the same static number `m` of slots (its padded box), so a
vector of the partition is one (m,) block a rank (`utils.pytrees.Sharded`
with a `PartitionLayout`), and the whole vector is the JAX package's
shard-major padded array of length `n_shards * m`.

`DistGraphELL` is one rank's rows of a row-sharded padded-ELL matrix:

- its columns are the extended window `[own box (m_in) | ghost slab per
  offset]`, with set-up int32 tables;
- `matvec` is one exchange over the static list of mesh-coordinate
  offsets (`ProcessMesh.exchange_offsets`, the JAX package's one
  `lax.ppermute` an offset) followed by kernel K3 on the local ELL, whose
  rows are the rank's padded box and whose columns are the window
  (`jnp.sum(vals * xe[cols], 1)` there). On a CUDA block the apply
  launches K3 or raises; on a CPU block it runs K3's plain version;
- `matvec_t` scatter-adds into the window and sends every ghost slab back
  to its owner (the reverse exchange), as the JAX package does it outside
  any Pallas kernel.

Rectangular operators (grid transfers) give rows and columns different
partitions of the same process grid. Ranks are row-major over the mesh
axes, as the JAX package flattens its mesh axes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..algebra.ell import ELLMatrix
from ..ops.ell_spmv import group_size
from ..utils import resolve_device
from ..utils.pytrees import Sharded
from .mesh import ProcessMesh


# ---------------------------------------------------------------------------
# box partitions of structured dof grids (host NumPy, as in the JAX package)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BoxPartition:
    """Assignment of a structured dof grid's entries to a process grid.

    The first `len(mesh_shape)` grid axes are split into near-equal
    contiguous chunks (np.array_split sizes); trailing axes (vector
    components, say) stay whole on every shard. Within a shard, dofs are
    laid out lexicographically in a padded local box of shape
    `box_shape`, so every shard has the same static local size `m`.

    owner[i] : flat shard id of global (C-order) dof i
    slot[i]  : position of dof i inside its shard's padded local box
    """

    shape: Tuple[int, ...]
    mesh_shape: Tuple[int, ...]
    box_shape: Tuple[int, ...]
    owner: np.ndarray
    slot: np.ndarray

    @property
    def n(self) -> int:
        return int(np.prod(self.shape))

    @property
    def n_shards(self) -> int:
        return int(np.prod(self.mesh_shape))

    @property
    def m(self) -> int:
        return int(np.prod(self.box_shape))

    @property
    def n_pad(self) -> int:
        return self.n_shards * self.m

    def padded_index(self) -> np.ndarray:
        """Global dof i -> row in the shard-major padded layout."""
        return self.owner.astype(np.int64) * self.m + self.slot


def box_partition(shape: Sequence[int], mesh_shape: Sequence[int]) -> BoxPartition:
    """Partition a dof grid `shape` over a process grid `mesh_shape`;
    len(mesh_shape) <= len(shape), trailing dof axes are unsplit."""
    shape = tuple(int(s) for s in shape)
    mesh_shape = tuple(int(p) for p in mesh_shape)
    D, Dm = len(shape), len(mesh_shape)
    assert Dm <= D, (shape, mesh_shape)
    assert all(p >= 1 for p in mesh_shape)
    assert all(shape[d] >= mesh_shape[d] for d in range(Dm)), (
        "fewer grid points than ranks along an axis")

    axis_owner, axis_slot, box_dims = [], [], []
    for d in range(Dm):
        sizes = [len(c) for c in np.array_split(np.arange(shape[d]), mesh_shape[d])]
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        own = np.repeat(np.arange(mesh_shape[d]), sizes)
        axis_owner.append(own)
        axis_slot.append(np.arange(shape[d]) - starts[own])
        box_dims.append(max(sizes))
    box_shape = tuple(box_dims) + shape[Dm:]

    coords = np.unravel_index(np.arange(int(np.prod(shape))), shape)
    owner = np.ravel_multi_index(tuple(axis_owner[d][coords[d]] for d in range(Dm)),
                                 mesh_shape)
    slot = np.ravel_multi_index(
        tuple(axis_slot[d][coords[d]] for d in range(Dm)) + tuple(coords[d] for d in range(Dm, D)),
        box_shape)
    return BoxPartition(shape=shape, mesh_shape=mesh_shape, box_shape=box_shape,
                        owner=owner.astype(np.int32), slot=slot.astype(np.int32))


def contiguous_partition(n: int, n_shards: int) -> BoxPartition:
    """Balanced contiguous 1-D partition of n unstructured dofs (sizes n/P
    rounded): the row partition of algebraic levels, where no dof grid
    exists. Equal blocks when P | n (padded_index is then the identity)."""
    owner = np.minimum(np.arange(n) * n_shards // n, n_shards - 1)
    counts = np.bincount(owner, minlength=n_shards)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(n) - starts[owner]
    return BoxPartition(shape=(n,), mesh_shape=(n_shards,), box_shape=(int(counts.max()),),
                        owner=owner.astype(np.int32), slot=slot.astype(np.int32))


def scipy_in_part_order(S, part_rows=None, part_cols=None):
    """Re-index a scipy matrix into shard-padded partition order on either
    side (rows or columns left in global order where no partition is
    given): the glue between partition-ordered sharded levels and
    replicated (global-order) levels of a solver hierarchy."""
    import scipy.sparse as sp

    C = S.tocoo()
    rows = part_rows.padded_index()[C.row] if part_rows is not None else C.row
    cols = part_cols.padded_index()[C.col] if part_cols is not None else C.col
    shape = (part_rows.n_pad if part_rows is not None else S.shape[0],
             part_cols.n_pad if part_cols is not None else S.shape[1])
    return sp.coo_matrix((C.data, (rows, cols)), shape=shape).tocsr()


# ---------------------------------------------------------------------------
# the layout of a partition's vectors
# ---------------------------------------------------------------------------


class PartitionLayout:
    """The split of a shard-major padded vector of `n_shards * m` entries
    over `mesh`: rank r holds entries [r·m, (r + 1)·m). Two layouts are
    equal where the JAX package's shardings are: the same mesh and the
    same shard size."""

    def __init__(self, mesh: ProcessMesh, m: int):
        self.mesh = mesh
        self.m = int(m)
        self.global_numel = mesh.size * self.m

    def _key(self):
        return (id(self.mesh), self.m)

    def __eq__(self, other):
        return isinstance(other, PartitionLayout) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        return self.mesh.all_reduce(t, op)

    def global_flat_index(self, device) -> torch.Tensor:
        """The padded shard-major index `rank·m + slot` of every entry of
        this rank's block (int64): the index of the JAX package's global
        array, from which `pt.seeded_like` builds the Lanczos start."""
        return self.mesh.rank * self.m + torch.arange(self.m, device=device)

    def shard(self, full: torch.Tensor) -> Sharded:
        r = self.mesh.rank
        return Sharded(full.reshape(-1)[r * self.m:(r + 1) * self.m].contiguous(), self)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole padded vector from every rank's block (one all-gather)."""
        return torch.cat(self.mesh.all_gather(local.contiguous()))


def partition_layout(mesh: ProcessMesh, part: BoxPartition) -> PartitionLayout:
    if tuple(mesh.devices_shape) != tuple(part.mesh_shape):
        raise ValueError(f"partition over {part.mesh_shape} on a mesh of {mesh.devices_shape}")
    return PartitionLayout(mesh, part.m)


# ---------------------------------------------------------------------------
# the operator
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DistGraphELL:
    """This rank's rows of a row-sharded padded-ELL matrix over a process
    mesh with a static neighbour-exchange graph.

    local     : ELLMatrix (m_out, K), columns index the extended window
                [ own (m_in) | ghost slab dirs[0] | ghost slab dirs[1] | ... ]
    send_tbls : per offset, this rank's (W_d,) int32 table: the local
                column indices it sends to the rank at coords - dirs[d]
    dirs      : static tuple of mesh-coordinate offsets (receiver -> owner)
    n_cols    : the global (padded) column count; `shape` is global too.
    """

    local: ELLMatrix
    send_tbls: Tuple[torch.Tensor, ...]
    n_cols: int
    m_in: int
    dirs: Tuple[Tuple[int, ...], ...]
    mesh: ProcessMesh
    axes: Tuple[str, ...]

    def __post_init__(self):
        self.row_layout = PartitionLayout(self.mesh, self.local.nrows)
        self.col_layout = PartitionLayout(self.mesh, self.m_in)
        self._index = tuple(t.long() for t in self.send_tbls)

    @property
    def values(self) -> torch.Tensor:
        return self.local.values

    @property
    def cols_loc(self) -> torch.Tensor:
        return self.local.cols

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_rows, self.n_cols)

    @property
    def n_rows(self) -> int:
        return self.mesh.size * self.local.nrows

    @property
    def window(self) -> int:
        """Columns of the local ELL: own box plus every ghost slab."""
        return self.local.ncols

    @property
    def dtype(self):
        return self.local.dtype

    @property
    def device(self):
        return self.local.device

    @staticmethod
    def _check(x, layout, what):
        if not (isinstance(x, Sharded) and x.layout == layout):
            raise TypeError(f"DistGraphELL.{what} takes a Sharded vector of its {layout.m}-slot "
                            f"layout")

    def extend(self, xl: torch.Tensor) -> torch.Tensor:
        """The window [own | slab per offset]: one exchange batch."""
        if not self.dirs:
            return xl
        slabs = self.mesh.exchange_offsets(self.dirs, [xl[t] for t in self._index])
        return torch.cat([xl] + slabs)

    def matvec(self, x: Sharded) -> Sharded:
        self._check(x, self.col_layout, "matvec")
        return Sharded(self.local.matvec(self.extend(x.local)), self.row_layout)

    def matvec_t(self, y: Sharded) -> Sharded:
        """Adjoint: scatter-add into the window, then fold every ghost
        slab back onto its owner (the reverse exchange)."""
        self._check(y, self.row_layout, "matvec_t")
        ze = self.local.matvec_t(y.local)
        own = ze[: self.m_in].clone()
        if self.dirs:
            widths = [t.numel() for t in self._index]
            slabs = list(torch.split(ze[self.m_in:], widths))
            back = self.mesh.exchange_offsets(self.dirs, slabs, reverse=True)
            for idx, b in zip(self._index, back):
                own.index_add_(0, idx, b)
        return Sharded(own, self.col_layout)

    def diag(self) -> Sharded:
        """Diagonal: needs equal row and column partitions (the own window
        leads, so a diagonal entry has col == local row)."""
        assert self.n_rows == self.n_cols, "diag needs a square partition"
        return Sharded(self.local.diag(), self.row_layout)

    def abs_row_sum(self) -> Sharded:
        return Sharded(self.local.abs_row_sum(), self.row_layout)

    def astype(self, dtype) -> "DistGraphELL":
        return dataclasses.replace(self, local=self.local.astype(dtype))


# ---------------------------------------------------------------------------
# host-side constructors
# ---------------------------------------------------------------------------


def mesh_device(mesh: ProcessMesh, device=None) -> torch.device:
    """`device`, or the rank's own (the card unless the launch asked for
    the CPU); raises on CUDA where there is none."""
    return resolve_device(mesh.device if device is None else device)


def _mesh_axes(mesh: ProcessMesh, axes):
    axes = tuple(mesh.axis_names) if axes is None else tuple(axes)
    return axes, tuple(mesh.shape[a] for a in axes)


def shard_csr_nd(S, part_rows: BoxPartition, mesh: ProcessMesh,
                 part_cols: Optional[BoxPartition] = None, axes: Optional[Sequence[str]] = None,
                 identity_pad: bool = False, row_width: Optional[int] = None, dtype=None,
                 device=None) -> DistGraphELL:
    """scipy CSR + box partition(s) -> this rank's `DistGraphELL` (its
    rows of the JAX package's tables, bit for bit). part_cols defaults to
    part_rows (square operators); identity_pad gives padding rows a unit
    diagonal (square partitions only), so padded systems stay SPD and pad
    dofs decouple at zero. `dtype` is a torch dtype (default: the
    matrix's own), `device` defaults to the mesh's. Every member rank of
    the mesh calls it."""
    if not mesh.member:
        raise ValueError("shard_csr_nd on a rank outside the mesh")
    S = S.tocsr().copy()
    S.sum_duplicates()
    S.sort_indices()
    part_cols = part_cols or part_rows
    n_r, n_c = S.shape
    assert n_r <= part_rows.n and n_c <= part_cols.n, ((n_r, n_c), (part_rows.n, part_cols.n))
    axes, mesh_shape = _mesh_axes(mesh, axes)
    assert mesh_shape == part_rows.mesh_shape == part_cols.mesh_shape, (
        mesh_shape, part_rows.mesh_shape, part_cols.mesh_shape)
    n_shards = part_rows.n_shards
    me = mesh.rank
    m_out, m_in = part_rows.m, part_cols.m

    counts = np.diff(S.indptr)
    K = max(int(counts.max()) if counts.size else 1, 1)
    if row_width is not None:
        assert row_width >= K
        K = row_width

    r_glob = np.repeat(np.arange(n_r), counts)
    c_glob = S.indices.astype(np.int64)
    pr = part_rows.padded_index()[:n_r][r_glob]
    slot_in_row = np.arange(S.nnz) - np.repeat(S.indptr[:-1], counts)
    row_shard = part_rows.owner[r_glob].astype(np.int64)
    col_shard = part_cols.owner[c_glob].astype(np.int64)
    own = col_shard == row_shard
    mine = row_shard == me
    lo = me * m_out

    vals = np.zeros((m_out, K), dtype=S.dtype)
    cols_loc = np.zeros((m_out, K), dtype=np.int32)
    row_len = np.zeros(m_out, dtype=np.int32)
    vals[pr[mine] - lo, slot_in_row[mine]] = S.data[mine]
    inside = mine & own
    cols_loc[pr[inside] - lo, slot_in_row[inside]] = part_cols.slot[c_glob[inside]]
    rows_mine = np.nonzero(part_rows.owner[:n_r] == me)[0]
    my_rows = part_rows.padded_index()[rows_mine] - lo
    row_len[my_rows] = counts[rows_mine]

    # ghost entries: group by mesh-coordinate offset (owner - receiver)
    send_tbls, dirs = [], []
    g = ~own
    if g.any():
        rc = np.array(np.unravel_index(row_shard[g], mesh_shape)).T
        cc = np.array(np.unravel_index(col_shard[g], mesh_shape)).T
        dkey, dinv = np.unique(cc - rc, axis=0, return_inverse=True)
        dinv = dinv.reshape(-1)
        gpr, gslot = pr[g], slot_in_row[g]
        gt, gc = row_shard[g], c_glob[g]
        off = m_in
        for di in range(len(dkey)):
            d = tuple(int(v) for v in dkey[di])
            sel = dinv == di
            t, c = gt[sel], gc[sel]
            # unique requested (receiver, col) pairs; np.unique sorts, so
            # slab positions group by receiver and order by global col
            key = t * part_cols.n + c
            uk, inv = np.unique(key, return_inverse=True)
            inv = inv.reshape(-1)
            ut = (uk // part_cols.n).astype(np.int64)
            uc = uk % part_cols.n
            grp_start = np.searchsorted(ut, np.arange(n_shards), side="left")
            pos = np.arange(len(uk)) - grp_start[ut]
            W = int(np.bincount(ut, minlength=n_shards).max())
            u_send = np.ravel_multi_index(
                tuple(np.unravel_index(ut, mesh_shape)[a] + d[a] for a in range(len(mesh_shape))),
                mesh_shape)
            tbl = np.zeros(W, dtype=np.int32)
            to_me = u_send == me
            tbl[pos[to_me]] = part_cols.slot[uc[to_me]]
            at_me = t == me
            cols_loc[gpr[sel][at_me] - lo, gslot[sel][at_me]] = off + pos[inv[at_me]]
            dirs.append(d)
            send_tbls.append(tbl)
            off += W

    if identity_pad:
        assert part_rows.m == part_cols.m and part_rows.n_pad == part_cols.n_pad
        used = np.zeros(m_out, dtype=bool)
        used[my_rows] = True
        pad_rows = np.nonzero(~used)[0]
        vals[pad_rows, 0] = 1.0
        cols_loc[pad_rows, 0] = pad_rows
        row_len[pad_rows] = 1

    dev = mesh_device(mesh, device)
    v = torch.from_numpy(vals)
    window = m_in + sum(len(t) for t in send_tbls)
    local = ELLMatrix(v.to(device=dev, dtype=dtype or v.dtype), torch.from_numpy(cols_loc).to(dev),
                      window, torch.from_numpy(row_len).to(dev),
                      group_size(K, row_len.mean() if len(row_len) else 0.0))
    return DistGraphELL(local=local, send_tbls=tuple(torch.from_numpy(t).to(dev) for t in send_tbls),
                        n_cols=part_cols.n_pad, m_in=m_in, dirs=tuple(dirs), mesh=mesh, axes=axes)


def dense_padded_nd(S, part: BoxPartition, identity_pad: bool = True) -> np.ndarray:
    """scipy matrix -> dense array in the shard-padded box ordering (the
    replicated coarsest operator of a box-sharded hierarchy); padding
    slots get a unit diagonal so the padded system stays invertible."""
    n = S.shape[0]
    assert S.shape[1] == n, "dense coarse embedding needs a square operator"
    D = np.zeros((part.n_pad, part.n_pad), dtype=S.dtype)
    pidx = part.padded_index()[:n]
    D[np.ix_(pidx, pidx)] = np.asarray(S.todense())
    if identity_pad:
        used = np.zeros(part.n_pad, dtype=bool)
        used[pidx] = True
        pad = np.nonzero(~used)[0]
        D[pad, pad] = 1.0
    return D


def shard_vector_nd(x, part: BoxPartition, mesh: ProcessMesh, axes=None, dtype=None,
                    device=None) -> Sharded:
    """Host (or device) vector of length <= part.n -> this rank's block of
    the padded box-ordered vector, on `device` (default: the mesh's)."""
    xt = x.detach().cpu() if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    xp = torch.zeros(part.n_pad, dtype=xt.dtype)
    xp[torch.from_numpy(part.padded_index()[: xt.shape[0]])] = xt
    layout = partition_layout(mesh, part)
    dev = mesh_device(mesh, device)
    blk = layout.shard(xp)
    return Sharded(blk.local.to(device=dev, dtype=dtype or xt.dtype), layout)


def unshard_vector_nd(xd, part: BoxPartition, n: Optional[int] = None) -> np.ndarray:
    """Padded box-ordered vector (a `Sharded` block, gathered over the
    ranks: every member calls it; or the whole padded array) -> host
    vector in global order."""
    full = xd.layout.gather(xd.local) if isinstance(xd, Sharded) else torch.as_tensor(xd)
    xp = full.detach().cpu().numpy()
    n = part.n if n is None else n
    return xp[part.padded_index()[:n]]


def _all_rows(A: DistGraphELL, t: torch.Tensor) -> np.ndarray:
    """Every rank's `t` (equal shapes) stacked in rank order, on the host:
    the multi-process fetch of the JAX package's `_host_fetch`."""
    return np.stack([p.cpu().numpy() for p in A.mesh.all_gather(t)])


def window_to_global_nd(A: DistGraphELL) -> np.ndarray:
    """(n_shards, window) host table: extended-window position -> global
    padded column id, per shard. Positions a boundary shard never
    receives map to that shard's own column 0 (their slab is zero-fill).
    Collective: every member rank calls it."""
    mesh_shape = A.mesh.devices_shape
    n_shards = A.mesh.size
    m_in = A.m_in
    glob = np.zeros((n_shards, A.window), dtype=np.int64)
    for s in range(n_shards):
        glob[s, :m_in] = s * m_in + np.arange(m_in)
    off = m_in
    for d, tbl in zip(A.dirs, A.send_tbls):
        tbl = _all_rows(A, tbl)
        W = tbl.shape[1]
        for t in range(n_shards):
            tc = np.array(np.unravel_index(t, mesh_shape)) + np.array(d)
            if not all(0 <= c < s for c, s in zip(tc, mesh_shape)):
                continue  # boundary shard: slab is zero-fill, never used
            u = int(np.ravel_multi_index(tuple(tc), mesh_shape))
            glob[t, off: off + W] = u * m_in + tbl[u]
        off += W
    return glob


def global_cols_nd(A: DistGraphELL) -> np.ndarray:
    """(n_rows, K) host table of global padded column ids matching the
    value array's slot layout. Collective."""
    glob = window_to_global_nd(A)
    cols = _all_rows(A, A.cols_loc)
    shard = np.arange(A.mesh.size)[:, None, None]
    return glob[shard, cols].reshape(A.n_rows, -1)


def dist_to_scipy_nd(A: DistGraphELL):
    """Host validation view (padded sizes, shard-major box order) of the
    whole operator. Collective: every member rank calls it."""
    import scipy.sparse as sp

    vals = _all_rows(A, A.values).reshape(A.n_rows, -1)
    n_rows, K = vals.shape
    cols = global_cols_nd(A)
    rows = np.repeat(np.arange(n_rows), K)
    keep = vals.reshape(-1) != 0
    M = sp.coo_matrix((vals.reshape(-1)[keep], (rows[keep], cols.reshape(-1)[keep])),
                      shape=(n_rows, A.n_cols))
    return M.tocsr()


def redistribute_vector_nd(xd: Sharded, part_from: BoxPartition, part_to: BoxPartition,
                           mesh_to: ProcessMesh, axes=None) -> Optional[Sharded]:
    """Move a box-ordered sharded vector onto another box partition,
    possibly over another mesh with another rank count (the reference's
    redistribute!): one all-gather over the source mesh and a static
    permutation; pad slots of the target are zero. Every rank of the
    source mesh calls it; the target mesh's ranks are among them, and the
    others get None."""
    assert part_from.shape == part_to.shape, (part_from.shape, part_to.shape)
    full = xd.layout.gather(xd.local)
    if not mesh_to.member:
        return None
    perm = np.zeros(part_to.n_pad, dtype=np.int64)
    valid = np.zeros(part_to.n_pad, dtype=bool)
    perm[part_to.padded_index()] = part_from.padded_index()
    valid[part_to.padded_index()] = True
    layout = partition_layout(mesh_to, part_to)
    r, m = mesh_to.rank, part_to.m
    sl = slice(r * m, (r + 1) * m)
    idx = torch.from_numpy(perm[sl]).to(full.device)
    keep = torch.from_numpy(valid[sl]).to(full.device)
    return Sharded(torch.where(keep, full[idx], 0.0), layout)


# ---------------------------------------------------------------------------
# where a sharded level meets a replicated one
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedRows:
    """This rank's rows of a replicated-input operator whose rows are in a
    partition's padded order (the prolongation from a replicated coarse
    level onto a sharded fine one): the whole input vector is on every
    rank, so the rank computes only its own rows (kernel K3), with no
    message. The JAX package applies the whole operator and lets XLA
    keep each device's rows."""

    local: ELLMatrix
    layout: PartitionLayout

    def matvec(self, x: torch.Tensor) -> Sharded:
        return Sharded(self.local.matvec(x), self.layout)


@dataclasses.dataclass
class GatheredColumns:
    """A replicated-output operator whose columns are in a partition's
    padded order (the restriction from a sharded fine level onto a
    replicated coarse one): the sharded input is all-gathered and the
    whole operator (kernel K3) applied on every rank, the JAX package's
    arithmetic on the same padded vector."""

    op: ELLMatrix
    layout: PartitionLayout

    def matvec(self, x: Sharded) -> torch.Tensor:
        if not (isinstance(x, Sharded) and x.layout == self.layout):
            raise TypeError("GatheredColumns.matvec takes a Sharded vector of its layout")
        return self.op.matvec(self.layout.gather(x.local))


def sharded_rows(S, part_rows: BoxPartition, mesh: ProcessMesh, dtype=None,
                 device=None) -> ShardedRows:
    """This rank's rows of `scipy_in_part_order(S, part_rows, None)`."""
    from ..algebra.ell import ell_from_scipy

    layout = partition_layout(mesh, part_rows)
    Sp = scipy_in_part_order(S, part_rows, None)
    r, m = mesh.rank, part_rows.m
    dev = mesh_device(mesh, device)
    return ShardedRows(ell_from_scipy(Sp[r * m:(r + 1) * m], dtype=dtype, device=dev), layout)


def gathered_columns(S, part_cols: BoxPartition, mesh: ProcessMesh, dtype=None,
                     device=None) -> GatheredColumns:
    """`scipy_in_part_order(S, None, part_cols)` on every rank, applied
    to the all-gathered input."""
    from ..algebra.ell import ell_from_scipy

    dev = mesh_device(mesh, device)
    return GatheredColumns(
        ell_from_scipy(scipy_in_part_order(S, None, part_cols), dtype=dtype, device=dev),
        partition_layout(mesh, part_cols))
