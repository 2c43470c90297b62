"""Error-free transformations and double-f32 ("two-float") arithmetic.

Port of `gridapsolvers_tpu/utils/compensated.py`. Emulates about twice
f32's precision with IEEE f32 operations only:

- two_sum:  Knuth's branch-free 6-flop exact addition (s + e == a + b).
- two_prod: Dekker's split-based exact product (no FMA dependence).
- comp_ell_matvec / comp_stencil_matvec: compensated SpMV returning the
  (hi, lo) unevaluated sum; the per-row accumulation error drops from
  O(K eps max|a_k x_k|) to O(eps^2).

These are plain PyTorch elementwise code, as the JAX package computes
them in XLA outside any Pallas kernel. The transforms are exact only if
no step is contracted into a fused multiply-add: in eager PyTorch each
operation is its own kernel, on the CPU and on the card alike, so none
is. Do not run them under a compiler that fuses elementwise chains.
"""
from __future__ import annotations

import torch

from ..ops.banded_stencil import pad_halo

# Dekker split constant for IEEE binary32 (p = 24): 2^ceil(p/2) + 1
_SPLIT32 = 4097.0


def two_sum(a, b):
    """s, e with s = fl(a+b) and s + e == a + b exactly (Knuth)."""
    s = a + b
    ap = s - b
    bp = s - ap
    da = a - ap
    db = b - bp
    return s, da + db


def fast_two_sum(a, b):
    """s, e exact when |a| >= |b| (Dekker, 3 flops)."""
    s = a + b
    return s, b - (s - a)


def _split(a):
    c = _SPLIT32 * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """p, e with p = fl(a*b) and p + e == a * b exactly (Dekker)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df_add(hi, lo, y_hi, y_lo=None):
    """Double-f32 addition (hi, lo) + (y_hi[, y_lo]) -> (hi, lo)."""
    s, e = two_sum(hi, y_hi)
    e = e + lo
    if y_lo is not None:
        e = e + y_lo
    return fast_two_sum(s, e)


def df_neg(hi, lo):
    return -hi, -lo


def comp_ell_matvec(values, cols, x, x_lo=None):
    """Compensated padded-ELL SpMV: y_hi + y_lo ~= values @ x to ~eps^2.

    values: (n, K), cols: (n, K) int, x: (ncols,). The slot loop
    accumulates with two_prod + two_sum, so intermediate cancellation is
    exact; only the final (hi, lo) pair carries rounding. x_lo (optional)
    is the low word of a two-float input vector; its contribution is first
    order, so a plain product suffices for it.
    """
    cols = cols.long()
    xk = x[cols]
    p, e = two_prod(values, xk)
    if x_lo is not None:
        e = e + values * x_lo[cols]
    hi = torch.zeros(values.shape[0], dtype=values.dtype, device=values.device)
    lo = torch.zeros_like(hi)
    for k in range(values.shape[1]):
        hi, ek = two_sum(hi, p[:, k])
        lo = lo + ek + e[:, k]
    return fast_two_sum(hi, lo)


def comp_stencil_matvec(A, x, x_lo=None):
    """Compensated StencilMatrix matvec -> (hi, lo) with ~eps^2
    accumulation error: the padded-slice lowering of the plain matvec with
    two_prod per band and exact two_sum accumulation; x_lo contributes at
    first order (plain products)."""
    gs = A.grid_shape
    per = A._periodic()
    d = len(gs)
    lo_w = [max(-min(o[k] for o in A.offsets), 0) for k in range(d)]
    hi_w = [max(max(o[k] for o in A.offsets), 0) for k in range(d)]
    xp = pad_halo(x.reshape(gs), lo_w, hi_w, per)
    xp_lo = None if x_lo is None else pad_halo(x_lo.reshape(gs), lo_w, hi_w, per)
    hi = torch.zeros(gs, dtype=x.dtype, device=x.device)
    lo = torch.zeros_like(hi)
    for s, off in enumerate(A.offsets):
        sl = tuple(slice(lo_w[k] + off[k], lo_w[k] + off[k] + gs[k]) for k in range(d))
        p, e = two_prod(A.bands[s], xp[sl])
        if xp_lo is not None:
            e = e + A.bands[s] * xp_lo[sl]
        hi, ek = two_sum(hi, p)
        lo = lo + ek + e
    hi, lo = fast_two_sum(hi, lo)
    return hi.reshape(-1), lo.reshape(-1)


def comp_dot(a, b):
    """Partially compensated dot product -> (hi, lo): exact two_prod per
    element and exact cross-chunk two_sum, but plain sums within each of 64
    chunks. Tighter than a plain f32 dot; not eps^2."""
    p, e = two_prod(a.reshape(-1), b.reshape(-1))
    nchunk = 64
    pad = (-p.shape[0]) % nchunk
    p = torch.nn.functional.pad(p, (0, pad)).reshape(nchunk, -1)
    e = torch.nn.functional.pad(e, (0, pad)).reshape(nchunk, -1)
    s_c = p.sum(dim=1)
    err_c = e.sum(dim=1)
    hi = torch.zeros((), dtype=p.dtype, device=p.device)
    lo = torch.zeros_like(hi)
    for k in range(nchunk):
        hi, ek = two_sum(hi, s_c[k])
        lo = lo + ek + err_c[k]
    return fast_two_sum(hi, lo)
