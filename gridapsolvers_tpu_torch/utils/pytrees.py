"""Vector algebra over tensors and tuples of tensors.

Port of `gridapsolvers_tpu/utils/pytrees.py`. A vector is a
`torch.Tensor`, or a (nested) tuple/list of tensors where the JAX package
has a pytree of blocks; every function maps over the leaves. Reductions
return 0-d tensors on the vectors' device, so nothing here waits for the
device.
"""
from __future__ import annotations

import dataclasses
import functools
import operator

import torch


def tree_leaves(x):
    """Leaves of a tensor or (nested) tuple/list of tensors, in order."""
    if isinstance(x, (tuple, list)):
        return [leaf for xi in x for leaf in tree_leaves(xi)]
    return [x]


def tree_map(fn, x, *rest):
    """Apply `fn` leafwise over one or more vectors of the same structure."""
    if isinstance(x, (tuple, list)):
        return type(x)(tree_map(fn, *parts) for parts in zip(x, *rest))
    return fn(x, *rest)


def dot(a, b):
    """Global inner product sum_i <a_i, b_i> over all leaves (real)."""
    terms = [
        torch.dot(x.reshape(-1), y.reshape(-1))
        for x, y in zip(tree_leaves(a), tree_leaves(b))
    ]
    return functools.reduce(operator.add, terms)


def norm(a):
    """Global 2-norm over all leaves."""
    return torch.sqrt(dot(a, a))


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
