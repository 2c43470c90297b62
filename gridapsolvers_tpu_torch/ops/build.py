"""Build and load the port's CUDA kernels; count their launches.

Each kernel source `csrc/<name>.cu` is compiled by nvcc for `sm_90a` into
a shared library with a plain C interface and loaded with ctypes. The
build happens at first use, never at import, into
`gridapsolvers_tpu_torch/build/` under a hash of the sources and flags, so
a changed source is rebuilt and an unchanged one is loaded as it is.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers and spills go to the build log
)


@dataclasses.dataclass
class LaunchCounts:
    """Launches of one kernel (`kernel`) and of its plain PyTorch version
    (`plain`); `shapes` splits `kernel` by the operand shape the wrapper
    names (a grid, a band count, rows and columns). Each wrapper adds one
    where it launches, and nowhere else."""

    kernel: int = 0
    plain: int = 0
    shapes: collections.Counter = dataclasses.field(default_factory=collections.Counter)

    def reset(self) -> None:
        self.kernel = 0
        self.plain = 0
        self.shapes.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME): the CUDA kernels cannot be built"
    )


def library_path(name: str) -> Path:
    """Where the library of kernel `name` lives once built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless its library is already built. The
    nvcc output (ptxas register and spill report) is kept beside it as
    `<library>.log`."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_out = Path(tmp) / out.name
        cmd = [
            _nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR),
            "-o", str(tmp_out), str(CSRC_DIR / f"{name}.cu"),
        ]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {name} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp_out, out)  # atomic: a reader sees all or nothing
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build if needed, then load kernel library `name` (once per process)."""
    return ctypes.CDLL(str(build(name)))


@functools.cache
def function(lib: str, name: str, argtypes: tuple):
    """C entry point `name` of library `lib`, returning cudaError_t. Pass
    ctypes.c_void_p for every pointer and the stream: an undeclared
    argument would go through as a 32-bit int and cut the pointer."""
    fn = getattr(load(lib), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check_status(name: str, status: int) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError_t {status}")
