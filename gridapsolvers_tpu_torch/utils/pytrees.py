"""Vector algebra over tensors and tuples of tensors.

Port of `gridapsolvers_tpu/utils/pytrees.py`. A vector is a
`torch.Tensor`, or a (nested) tuple/list of tensors where the JAX package
has a pytree of blocks; every function maps over the leaves. Reductions
return 0-d tensors on the vectors' device, so nothing here waits for the
device.

A `Sharded` leaf is one rank's block of a grid vector split over the ranks
of a process mesh (`parallel/`), where the JAX package has a sharded
array. Maps act on the block; `dot`, `norm`, `max_abs`, `size` and
`seeded_like` reduce or index over the whole vector through the block's
`layout`, so the solvers built on these functions (CG, GMG, Chebyshev)
give every rank the global value and know nothing of the split.
"""
from __future__ import annotations

import dataclasses
import functools
import operator

import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Sharded:
    """One rank's block `local` of a vector split over a process mesh.
    `layout` (a `parallel.dist.BlockLayout` of a grid split, or a
    `parallel.dist_ell_nd.PartitionLayout` of a box partition; equal for
    blocks of one split) knows the global shape, this block's place in it
    and the ranks that hold the others: it gives `mesh`, `all_reduce(t,
    op)` (the sum or max of a tensor over the ranks), `global_numel` and
    `global_flat_index(device)`."""

    local: torch.Tensor
    layout: object


def blocks(x):
    """(tensor, layout or None) of every leaf, in order."""
    if isinstance(x, (tuple, list)):
        return [blk for xi in x for blk in blocks(xi)]
    if isinstance(x, Sharded):
        return [(x.local, x.layout)]
    return [(x, None)]


def tree_leaves(x):
    """Leaves of a tensor or (nested) tuple/list of tensors, in order; a
    `Sharded` leaf gives its local block."""
    return [t for t, _ in blocks(x)]


def tree_map(fn, x, *rest):
    """Apply `fn` leafwise over one or more vectors of the same structure;
    on `Sharded` leaves, to the local blocks, keeping the layout."""
    if isinstance(x, (tuple, list)):
        return type(x)(tree_map(fn, *parts) for parts in zip(x, *rest))
    if isinstance(x, Sharded):
        for r in rest:
            if not (isinstance(r, Sharded) and r.layout == x.layout):
                raise TypeError("a Sharded vector meets a vector of another layout")
        return Sharded(fn(x.local, *(r.local for r in rest)), x.layout)
    return fn(x, *rest)


def reduce_terms(parts, op="sum"):
    """Combine per-leaf terms (0-d, or equal-shaped tensors such as a
    Krylov basis' stacked dots), given as (term, layout or None) pairs:
    `op` over the plain leaves' terms and the all-reduced local terms of
    the sharded ones. Layouts over one process mesh (a velocity and a
    pressure partition, say) share one collective."""
    plain, by_mesh = [], {}
    for t, layout in parts:
        if layout is None:
            plain.append(t)
        else:
            by_mesh.setdefault(id(layout.mesh), (layout, []))[1].append(t)
    combine = operator.add if op == "sum" else torch.maximum
    for layout, terms in by_mesh.values():
        plain.append(layout.all_reduce(functools.reduce(combine, terms), op))
    return functools.reduce(combine, plain)



def dot(a, b):
    """Global inner product sum_i <a_i, b_i> over all leaves (real); over
    all ranks for sharded leaves."""
    return reduce_terms(
        [(torch.dot(x.reshape(-1), y.reshape(-1)), layout)
         for (x, layout), (y, _) in zip(blocks(a), blocks(b))],
        "sum",
    )


def dots(*pairs):
    """The inner products <a, b> of several (a, b) pairs of one structure,
    as one 1-D tensor: each entry is what `dot(a, b)` gives (the same
    per-leaf sums in the same order), and the sharded leaves' local terms
    go over the ranks as one all-reduce a process mesh."""
    per_leaf = zip(*[blocks(a) for a, _ in pairs], *[blocks(b) for _, b in pairs])
    n = len(pairs)
    return reduce_terms(
        [(torch.stack([torch.dot(leaves[k][0].reshape(-1), leaves[n + k][0].reshape(-1))
                       for k in range(n)]), leaves[0][1])
         for leaves in per_leaf],
        "sum",
    )


def norm(a):
    """Global 2-norm over all leaves."""
    return torch.sqrt(dot(a, a))


def max_abs(a):
    """max_i |a_i| over all leaves (and ranks), a 0-d tensor."""
    return reduce_terms([(torch.max(torch.abs(x)), layout) for x, layout in blocks(a)], "max")


def size(a) -> int:
    """Number of entries of the whole vector."""
    return sum(x.numel() if layout is None else layout.global_numel
               for x, layout in blocks(a))


def seeded_like(a):
    """The JAX package's deterministic start vector shaped like `a`: per
    leaf, sin(12.9898 * k) at the entry of 1-based flat index k; a sharded
    leaf's block holds the entries of its own global indices."""
    if isinstance(a, (tuple, list)):
        return type(a)(seeded_like(ai) for ai in a)
    if isinstance(a, Sharded):
        k = a.layout.global_flat_index(a.local.device) + 1
        return Sharded(torch.sin(k.to(a.local.dtype) * 12.9898), a.layout)
    k = torch.arange(1, a.numel() + 1, dtype=a.dtype, device=a.device).reshape(a.shape)
    return torch.sin(k * 12.9898)


def axpy(alpha, x, y):
    """y + alpha * x."""
    return tree_map(lambda xi, yi: yi + alpha * xi, x, y)


def axpby(alpha, x, beta, y):
    return tree_map(lambda xi, yi: alpha * xi + beta * yi, x, y)


def scale(alpha, x):
    return tree_map(lambda xi: alpha * xi, x)


def add(x, y):
    return tree_map(torch.add, x, y)


def sub(x, y):
    return tree_map(torch.sub, x, y)


def mul(x, y):
    """Elementwise (Hadamard) product."""
    return tree_map(torch.mul, x, y)


def zeros_like(x):
    return tree_map(torch.zeros_like, x)


def where(pred, x, y):
    """Leafwise select with a scalar (0-d boolean tensor or bool)
    predicate."""
    return tree_map(lambda xi, yi: torch.where(torch.as_tensor(pred, device=xi.device), xi, yi),
                    x, y)


def ravel(x):
    """Flatten a vector into one 1D tensor."""
    if any(layout is not None for _, layout in blocks(x)):
        raise TypeError("ravel of a Sharded vector: gather it first (parallel.dist)")
    return torch.cat([leaf.reshape(-1) for leaf in tree_leaves(x)])


def tree_unflatten(template, leaves):
    """A vector shaped like `template` whose leaves, in order, are
    `leaves` (no copy)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, (tuple, list)):
            return type(t)(build(ti) for ti in t)
        return next(it)

    return build(template)


def flatten_concat(x):
    """(flat 1D tensor, info): pair with `unflatten_like(flat, info)`. The
    info is the vector itself, as `unflatten_like` takes a template."""
    return ravel(x), x


def unflatten_like(flat, template):
    """Inverse of `ravel` (and `flatten_concat`) for a vector shaped like
    `template`."""
    if not isinstance(template, (tuple, list)):
        return flat.reshape(template.shape)
    out, off = [], 0
    for t in template:
        n = sum(leaf.numel() for leaf in tree_leaves(t))
        out.append(unflatten_like(flat[off : off + n], t))
        off += n
    return type(template)(out)


def round_scalar(v: float, dtype: torch.dtype) -> float:
    """A Python float rounded through `dtype` (read back as a float)."""
    return torch.tensor(v, dtype=dtype).item()


def tree_cast(tree, dtype):
    """Cast every floating tensor of a state to `dtype`: through dicts,
    tuples, lists and dataclass instances (operators, transfers), leaving
    integer tensors and other values alone. Port of `_tree_cast`
    (`gridapsolvers_tpu/linear/gmg.py:41`). A Python float, as the port
    keeps a Chebyshev state's spectrum bounds where the JAX package keeps
    0-d arrays that its walker casts, is rounded through `dtype`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, float):
        return round_scalar(tree, dtype)
    if isinstance(tree, dict):
        return {k: tree_cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_cast(v, dtype) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_cast(getattr(tree, f.name), dtype)
            for f in dataclasses.fields(tree) if f.init
        })
    return tree
