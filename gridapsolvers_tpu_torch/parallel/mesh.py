"""Process meshes for domain decomposition.

Port of `gridapsolvers_tpu/parallel/mesh.py`. The JAX package lays the
blocks of a grid on the devices of a `jax.sharding.Mesh` and lets XLA
insert the collectives; here each block lives on one rank of a
`torch.distributed` process group, and the collectives are explicit
(`all_reduce`, `all_gather`, `exchange`, `exchange_offsets`). A
`ProcessMesh` arranges the first ranks of the world in a grid with the
JAX axis names ("p", or "px", "py", "pz"); on the card each rank holds
one GPU and the group runs NCCL, on the CPU it runs gloo.

Where ranks share a card (gloo over CUDA blocks: more ranks than GPUs, as
on a one-GPU machine), the blocks and kernels stay on the card and every
message goes through a pinned host buffer ("gloo-host-staged"). The
counts in `comm_counts` record what a rank sent: point-to-point batches
and messages, all-reduces, all-gathers and bytes.

The mesh is its own small class, not a `torch.distributed.DeviceMesh`:
the tests run a 2-rank and a (2, 2) mesh on subgroups of one 4-rank
launch, and this needs only the group of the mesh's ranks, which
`dist.new_group` gives on every PyTorch version.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


class PartitionSpec(tuple):
    """Mesh axis (or None) per array axis, as `jax.sharding.PartitionSpec`."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass
class CommCounts:
    """What this rank sent since the last `reset`: point-to-point batches
    (one a halo exchange along one mesh axis, or one exchange over a list
    of mesh offsets), messages and bytes in them, all-reduces,
    all-gathers and the bytes it contributed to them."""

    p2p_batches: int = 0
    p2p_messages: int = 0
    p2p_bytes: int = 0
    all_reduces: int = 0
    all_gathers: int = 0
    gather_bytes: int = 0

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


comm_counts = CommCounts()


class ProcessMesh:
    """The first `prod(shape)` ranks of the world in a C-ordered grid of
    mesh axes `axis_names`. `shape` maps each axis name to its size, as
    `jax.sharding.Mesh.shape` does. Only member ranks may use it for
    collectives (`member`); every rank of the world must construct it,
    because making its process group is collective."""

    def __init__(self, devices_shape: Sequence[int], axis_names: Sequence[str], device=None):
        if not dist.is_initialized():
            raise RuntimeError("ProcessMesh needs an initialized torch.distributed "
                               "process group (parallel.launch.run_ranks)")
        self.devices_shape = tuple(int(n) for n in devices_shape)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != len(self.devices_shape):
            raise ValueError(f"{len(self.devices_shape)} axes need as many names, "
                             f"got {self.axis_names}")
        self.size = int(np.prod(self.devices_shape))
        world = dist.get_world_size()
        if self.size > world:
            raise ValueError(f"need {self.size} ranks, have {world}")
        self.shape = collections.OrderedDict(zip(self.axis_names, self.devices_shape))
        self.ranks = list(range(self.size))
        self.group = (dist.group.WORLD if self.size == world
                      else dist.new_group(self.ranks))
        self.rank = dist.get_rank()
        self.member = self.rank < self.size
        self.coords = (tuple(int(c) for c in np.unravel_index(self.rank, self.devices_shape))
                       if self.member else None)
        self.device = torch.device(device) if device is not None else _rank_device()
        backend = dist.get_backend(self.group if self.member else None)
        self.transport = ("gloo-host-staged" if backend == "gloo" and self.device.type == "cuda"
                          else backend)

    def axis_index(self, axis: str) -> int:
        return self.axis_names.index(axis)

    def offset_rank(self, delta: Sequence[int], wrap: bool = False) -> Optional[int]:
        """The rank at this one's mesh coordinates plus `delta` (one entry
        an axis; rank ids are row-major over the mesh axes), or None off
        the mesh where the axes do not wrap."""
        c = [a + b for a, b in zip(self.coords, delta)]
        if not all(0 <= ci < n for ci, n in zip(c, self.devices_shape)):
            if not wrap:
                return None
            c = [ci % n for ci, n in zip(c, self.devices_shape)]
        return int(np.ravel_multi_index(c, self.devices_shape))

    def _unit(self, axis: str, step: int) -> tuple:
        d = [0] * len(self.devices_shape)
        d[self.axis_index(axis)] = step
        return tuple(d)

    def neighbor(self, axis: str, step: int, wrap: bool = False) -> Optional[int]:
        """Rank `step` places along `axis` from this one, or None past an
        edge of an axis that does not wrap."""
        return self.offset_rank(self._unit(axis, step), wrap)

    # -- collectives over the mesh's group -------------------------------

    def _staged(self) -> bool:
        return self.transport == "gloo-host-staged"

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The sum or max of `t` over the mesh's ranks (a new tensor on
        t's device). A mesh of one rank sends nothing."""
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        if self.size == 1:
            return t.clone()
        comm_counts.all_reduces += 1
        if self._staged():
            h = t.detach().to("cpu").clone()
            dist.all_reduce(h, red, group=self.group)
            return h.to(t.device)
        out = t.clone()
        dist.all_reduce(out, red, group=self.group)
        return out

    def all_gather(self, t: torch.Tensor) -> list:
        """Every member rank's `t` (equal shapes), in rank order."""
        if self.size == 1:
            return [t]
        comm_counts.all_gathers += 1
        comm_counts.gather_bytes += t.numel() * t.element_size()
        src = t.detach().contiguous()
        if self._staged():
            src = src.to("cpu")
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return [p.to(t.device) for p in parts] if self._staged() else parts

    def exchange(self, axis: str, up=None, down=None, wrap: bool = False):
        """One halo exchange along `axis`: send `up` to the next rank and
        `down` to the previous one; return (from the previous rank, from
        the next rank), each zeros where there is no such rank (an edge
        of an axis that does not wrap) and None where nothing of that
        kind was sent. All ranks of the mesh call it together."""
        sent = [(d, t) for d, t in ((self._unit(axis, -1), up), (self._unit(axis, +1), down))
                if t is not None]
        got = iter(self.exchange_offsets([d for d, _ in sent], [t for _, t in sent], wrap=wrap))
        return tuple(None if t is None else next(got) for t in (up, down))

    def exchange_offsets(self, dirs, bufs, reverse: bool = False, wrap: bool = False) -> list:
        """One batch over a static list of mesh-coordinate offsets (the
        JAX package's one `lax.ppermute` an offset, `parallel/dist_ell_nd.py`):
        for each offset d, send bufs[i] to the rank at coords - d and
        receive, into a tensor shaped like bufs[i], what the rank at
        coords + d sent (`reverse`: to coords + d, from coords - d). Where
        there is no such rank (off the mesh, and the axes do not wrap)
        nothing is sent, and the received tensor is zeros. Each offset
        travels under its own tag, so two ranks trading in both directions
        (or both neighbours of a wrapped axis of two) keep the messages
        apart; every rank posts in the same order. Ranks sharing a card
        stage the messages through pinned host buffers. All ranks of the
        mesh call it together."""
        sign = 1 if reverse else -1
        staged = self._staged()
        ops, got = [], {}
        for i, (d, t) in enumerate(zip(dirs, bufs)):
            dst = self.offset_rank(tuple(sign * a for a in d), wrap)
            src = self.offset_rank(tuple(-sign * a for a in d), wrap)
            if dst is not None:
                h = t.contiguous()
                if staged:
                    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(h)
                ops.append(dist.P2POp(dist.isend, h, dst, self.group, i))
                comm_counts.p2p_messages += 1
                comm_counts.p2p_bytes += t.numel() * t.element_size()
            if src is not None:
                got[i] = torch.empty(t.shape, dtype=t.dtype, pin_memory=staged,
                                     device="cpu" if staged else t.device)
                ops.append(dist.P2POp(dist.irecv, got[i], src, self.group, i))
        if ops:
            comm_counts.p2p_batches += 1
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        out = []
        for i, t in enumerate(bufs):
            if i not in got:
                out.append(torch.zeros_like(t))
            else:
                out.append(got[i].to(t.device) if staged else got[i])
        return out


def _rank_device() -> torch.device:
    # imported here: a rank runs launch.py as __main__ after this package's
    # __init__, which would otherwise import launch.py a second time
    from .launch import rank_device

    return rank_device()


def device_mesh(n_devices: Optional[int] = None, axis: str = "p", device=None) -> ProcessMesh:
    """1D mesh over the first `n_devices` ranks (default: all). Every rank
    of the world calls it."""
    return ProcessMesh((n_devices or dist.get_world_size(),), (axis,), device)


def device_mesh_nd(shape: Sequence[int], axes: Optional[Sequence[str]] = None,
                   device=None) -> ProcessMesh:
    """Multi-axis mesh for a D-dimensional domain partition (the
    reference's per-level processor boxes, np_per_level NTuple{D},
    ModelHierarchies.jl:82); axes default to ('px', 'py', 'pz', ...).
    Every rank of the world calls it."""
    shape = tuple(shape)
    if axes is None:
        axes = tuple(f"p{'xyz'[d]}" for d in range(len(shape)))
    return ProcessMesh(shape, axes, device)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A block layout: the mesh and which mesh axis splits each array
    axis (`jax.sharding.NamedSharding`'s meaning)."""

    mesh: ProcessMesh
    spec: PartitionSpec


def row_sharding(mesh: ProcessMesh, ndim: int = 1, axis: str = "p") -> NamedSharding:
    """Split the leading (grid/row) axis; keep the rest whole."""
    return NamedSharding(mesh, P(axis, *([None] * (ndim - 1))))


def replicated(mesh: ProcessMesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def axis_size(mesh: ProcessMesh, axis: str = "p") -> int:
    return mesh.shape[axis]
