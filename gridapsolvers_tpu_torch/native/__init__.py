"""ctypes loader for the port's native host kernels (`solvercore.cpp`).

Port of `gridapsolvers_tpu/native/__init__.py` with the port's own copy of
the C++ source. The library is built with g++ at first use (never at
import) into `gridapsolvers_tpu_torch/build/`, under a hash of the source
and flags, as `ops/build.py` does for the CUDA kernels; nothing is written
beside the source. Every entry point has a NumPy twin that computes the
same result; when the library cannot be built or loaded the twin runs and
a warning says so once. `implementation()` names the one in use.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import warnings
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "solvercore.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
_FLAGS = ("-O3", "-shared", "-fPIC")


def library_path() -> Path:
    """Where the library lives once built."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD_DIR / f"libsolvercore-{h.hexdigest()[:16]}.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    _BUILD_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        tmp_out = Path(tmp) / out.name
        proc = subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp_out)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed (exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp_out, out)  # atomic: a reader sees all or nothing
    return out


@functools.cache
def _load():
    """The loaded library with its signatures, or None (NumPy twins run)."""
    try:
        lib = ctypes.CDLL(str(_build()))
    except Exception as e:  # no toolchain, or a failed build: the twins run
        warnings.warn(f"solvercore native build unavailable ({e}); NumPy twins run instead")
        return None
    i64 = ctypes.c_int64
    i32 = ctypes.c_int32
    p64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    pf64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.ell_from_sorted_coo.restype = i64
    lib.ell_from_sorted_coo.argtypes = [i64, i64, i64, p64, p64, pf64, i64, pf64, p32, i64]
    lib.greedy_color.restype = i32
    lib.greedy_color.argtypes = [i64, i64, p32, p32]
    lib.patch_widths.restype = i64
    lib.patch_widths.argtypes = [p64, p32, i64, i64, p64]
    lib.patch_fill.restype = None
    lib.patch_fill.argtypes = [p64, p32, i64, i64, i64, i32, p32]
    lib.rcm_order.restype = None
    lib.rcm_order.argtypes = [i64, i64, p32, p32]
    return lib


def available() -> bool:
    return _load() is not None


def implementation() -> str:
    """"native" when the C++ library is in use, "numpy" when the twins are."""
    return "native" if available() else "numpy"


def greedy_color(cols: np.ndarray, native: bool = True) -> np.ndarray:
    """Greedy coloring of an ELL adjacency; returns per-node colors.
    `native=False` runs the NumPy twin."""
    n, K = cols.shape
    cols = np.ascontiguousarray(cols, np.int32)
    lib = _load() if native else None
    if lib is not None:
        out = np.empty(n, np.int32)
        lib.greedy_color(n, K, cols, out)
        return out
    colors = -np.ones(n, dtype=np.int32)
    for i in range(n):
        used = set(colors[c] for c in cols[i] if c != i and 0 <= c < n and colors[c] >= 0)
        c = 0
        while c in used:
            c += 1
        colors[i] = c
    return colors


def union_patches(indptr: np.ndarray, indices: np.ndarray, lo: int, hi: int, dummy: int,
                  native: bool = True) -> np.ndarray:
    """Padded patch table: row p in [lo,hi) -> sorted unique(indices[p] + p).
    `native=False` runs the NumPy twin."""
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    npatch = hi - lo
    lib = _load() if native else None
    if lib is not None:
        widths = np.empty(npatch, np.int64)
        W = int(lib.patch_widths(indptr, indices, lo, hi, widths))
        table = np.empty((npatch, W), np.int32)
        lib.patch_fill(indptr, indices, lo, hi, W, dummy, table)
        return table
    rows = [np.unique(np.concatenate([indices[indptr[p]: indptr[p + 1]], [p]]))
            for p in range(lo, hi)]
    W = max((len(d) for d in rows), default=0)
    table = np.full((npatch, W), dummy, np.int32)
    for i, d in enumerate(rows):
        table[i, : len(d)] = d
    return table


def rcm_order(cols: np.ndarray, native: bool = True) -> np.ndarray:
    """Reverse Cuthill-McKee permutation from an ELL adjacency.
    `native=False` runs the scipy twin."""
    n, K = cols.shape
    cols = np.ascontiguousarray(cols, np.int32)
    lib = _load() if native else None
    if lib is not None:
        out = np.empty(n, np.int32)
        lib.rcm_order(n, K, cols, out)
        return out
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    rows = np.repeat(np.arange(n), K)
    S = sp.coo_matrix((np.ones(n * K), (rows, cols.reshape(-1))), shape=(n, n)).tocsr()
    return reverse_cuthill_mckee(S).astype(np.int32)


def ell_from_sorted_coo(n_rows, n_cols, rows, cols, vals, K=None, native: bool = True):
    """COO (lexicographically sorted) -> padded ELL arrays (values, cols).
    `native=False` runs the NumPy twin."""
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    vals = np.ascontiguousarray(vals, np.float64)
    lib = _load() if native else None
    if lib is not None:
        if K is None:
            uniq = np.unique(rows * n_cols + cols)
            K = int(np.bincount((uniq // n_cols).astype(np.int64), minlength=n_rows).max())
        out_vals = np.empty((n_rows, K), np.float64)
        out_cols = np.empty((n_rows, K), np.int32)
        r = lib.ell_from_sorted_coo(n_rows, n_cols, len(rows), rows, cols, vals, K, out_vals,
                                    out_cols, K)
        if r < 0:
            raise ValueError("row degree exceeds requested ELL width")
        return out_vals, out_cols
    from ..algebra.ell import ell_from_coo

    ell = ell_from_coo(n_rows, n_cols, rows, cols, vals, row_width=K, device="cpu")
    return ell.values.numpy(), ell.cols.numpy()
