#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gridapsolvers_tpu_torch) on one GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds both hand-written kernels from `gridapsolvers_tpu_torch/csrc/`
(nvcc, sm_90a) and drives the port's GMG-CG Poisson main path through its
public entry points, in phases that each print one line:

  1 device   card name and power limit (nvidia-smi), TF32 off
  2 build    both kernels, with build seconds and ptxas register counts
  3 kernels  K1 and K2 against their plain PyTorch versions on the card
  4 path A   solve_poisson_const (constant stencils, K1), f32, 32^3 and 128^3
  5 path B   solve_poisson (banded stencils, K2), f64, 64^3 and 128^3
  6 times    per-apply kernel and plain times, and each 128^3 solve

The launch counts of the two 128^3 solves show that every stencil apply
went through the kernels. Any failed check raises, so a failure exits
non-zero. The line before the last is a JSON summary of the kernels; the
last line is {"ok": true, "device": {...}}. Without CUDA it exits non-zero
before printing any result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sp
import torch

# imported before anything is printed: a copy of this script without the
# package fails here, with no output
from gridapsolvers_tpu_torch.algebra import stencil_from_scipy
from gridapsolvers_tpu_torch.fem import CartesianMesh
from gridapsolvers_tpu_torch.fem.assembly import eliminate_dirichlet, laplacian, laplacian_const
from gridapsolvers_tpu_torch.linear import ChebyshevSmoother
from gridapsolvers_tpu_torch.models import solve_poisson, solve_poisson_const
from gridapsolvers_tpu_torch.ops import banded_stencil as k2
from gridapsolvers_tpu_torch.ops import build
from gridapsolvers_tpu_torch.ops import const_stencil as k1

F32_TOL = 1e-6   # max|y - y_ref| / max|y_ref|: reordered f32 sums, FMA contraction
F64_TOL = 1e-13
TIMING_RUNS = 30
DEVICE = "cuda:0"


def relerr(y, y_ref) -> float:
    return float((y.double() - y_ref.double()).abs().max() / y_ref.double().abs().max())


def abserr(y, y_ref) -> float:
    return float((y.double() - y_ref.double()).abs().max())


def cg_gmg_applies(niter: int, levels: int, degree: int) -> int:
    """Operator applies of one GMG-preconditioned CG solve (linear/cg.py,
    linear/gmg.py): the initial residual and one apply per iteration, plus
    niter+1 V-cycles. A V-cycle applies the operator `degree` times per
    Chebyshev sweep (pre and post) and once for the correction residual on
    each of the levels-1 smoothing levels, and once on the coarsest."""
    return (niter + 1) * ((levels - 1) * (2 * degree + 1) + 2)


def median_ms(fn, runs=TIMING_RUNS, warmup=3, before=None, spin=True) -> float:
    """Median time of `fn` over `runs` calls, each between its own pair of
    CUDA events; `before` runs outside the timed span. With `spin`, each
    call is queued behind a ~1 ms device-side spin, so the span holds the
    device work and not the host's launch latency; without it (solves,
    which wait on the host every iteration) the span is wall time."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        if before is not None:
            before()
        if spin:
            torch.cuda._sleep(2_000_000)
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def main() -> None:
    # ---- 1 device -------------------------------------------------------
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"[1 device] {kind} x{count} | {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | tf32 matmul/cudnn off", flush=True)

    dev = torch.device(DEVICE)

    # ---- 2 build --------------------------------------------------------
    parts = []
    for name in ("const_stencil", "banded_stencil"):
        t0 = time.perf_counter()
        path = build.build(name)
        secs = time.perf_counter() - t0
        build.load(name)
        regs = [ln.strip() for ln in path.with_suffix(".log").read_text().splitlines()
                if "registers" in ln]
        parts.append(f"{name} {secs:.1f} s ({'; '.join(regs)})")
    print("[2 build] " + " | ".join(parts), flush=True)

    # ---- 3 kernels against their plain versions -------------------------
    rng = np.random.default_rng(0)
    level_shapes = [(129,) * 3, (65,) * 3, (33,) * 3, (17,) * 3, (129, 129), (17, 9, 5)]

    def mesh_of(shape, periodic=None):
        ncells = tuple(m if periodic and periodic[k] else m - 1 for k, m in enumerate(shape))
        return CartesianMesh(ncells, tuple(x for _ in shape for x in (0.0, 1.0)), periodic)

    def vec(n, dtype):
        return torch.from_numpy(rng.normal(size=n)).to(dev, dtype)

    worst = {"K1": 0.0, "K2": 0.0}
    lines = []

    def check(tag, key, y, y_ref, tol):
        torch.cuda.synchronize()
        assert y.shape == y_ref.shape and y.dtype == y_ref.dtype, (tag, y.shape, y.dtype)
        assert bool(torch.isfinite(y).all()), tag
        e = relerr(y, y_ref)
        worst[key] = max(worst[key], abserr(y, y_ref))
        assert e <= tol, f"{tag}: max relative error {e:.3e} > {tol:.0e}"
        lines.append(f"{tag} {e:.2e}")

    for shape in level_shapes:
        for dt, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
            A = laplacian_const(mesh_of(shape), dt, dev)
            x = vec(A.n, dt)
            args = (A.weights, A.free, A.offsets, A.grid_shape, x)
            check(f"K1{shape}{str(dt)[6:]}", "K1",
                  k1.const_stencil_cuda(*args), k1.const_stencil_plain(*args), tol)
        for dt, band_dt, tol in ((torch.float32, torch.float32, F32_TOL),
                                 (torch.float64, torch.float64, F64_TOL),
                                 (torch.float32, torch.bfloat16, F32_TOL)):
            mesh = mesh_of(shape)
            A = eliminate_dirichlet(laplacian(mesh, dt, dev), mesh.boundary_vertex_mask())
            A = A.astype(band_dt)
            x = vec(A.n, dt)
            args = (A.bands, A.offsets, A.grid_shape, A._periodic(), x)
            check(f"K2{shape}{str(band_dt)[6:]}", "K2",
                  k2.banded_stencil_cuda(*args), k2.banded_stencil_plain(*args), tol)
    S = None
    for m in (33, 33, 33):  # kron of pentadiagonals: a 125-offset envelope
        T = sp.diags([rng.normal(size=m - abs(k)) for k in range(-2, 3)], range(-2, 3),
                     format="csr")
        S = T if S is None else sp.kron(S, T, format="csr")
    S.eliminate_zeros()
    extra = {
        "periodic": laplacian(mesh_of((32, 24, 16), (True, False, True)), torch.float64, dev),
        "5^3": stencil_from_scipy(S, (33, 33, 33), dtype=torch.float64, device=dev),
    }
    assert len(extra["5^3"].offsets) == 125
    for tag, A64 in extra.items():
        for dt, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
            A = A64.astype(dt)
            x = vec(A.n, dt)
            args = (A.bands, A.offsets, A.grid_shape, A._periodic(), x)
            check(f"K2[{tag}]{str(dt)[6:]}", "K2",
                  k2.banded_stencil_cuda(*args), k2.banded_stencil_plain(*args), tol)
    # K1 and K2 on the same operator: the Dirichlet-eliminated Laplacian
    for dt, tol in ((torch.float32, F32_TOL), (torch.float64, F64_TOL)):
        mesh = mesh_of((129,) * 3)
        Ac = laplacian_const(mesh, dt, dev)
        Ab = eliminate_dirichlet(laplacian(mesh, dt, dev), mesh.boundary_vertex_mask())
        x = vec(Ac.n, dt)
        check(f"K1=K2(129^3){str(dt)[6:]}", "K1", Ac.matvec(x), Ab.matvec(x), tol)
    print(f"[3 kernels] {len(lines)} cases within f32 {F32_TOL:.0e} / f64 {F64_TOL:.0e} "
          f"(bf16 bands against the plain version on the same bands): " + ", ".join(lines),
          flush=True)
    del extra, S, Ac, Ab, A, A64, x, args

    # ---- 4, 5 main paths: small checks first, then the counted 128^3 run -
    deg = ChebyshevSmoother().degree
    lanczos = ChebyshevSmoother().lanczos_iters
    x, st, _ = solve_poisson_const((32,) * 3, 3, device=dev, dtype=torch.float32)
    assert st.niter == 4 and st.converged(), (st.niter, st.flag)
    x_cpu, st_cpu, _ = solve_poisson_const((32,) * 3, 3, device="cpu", dtype=torch.float32)
    assert st_cpu.niter == st.niter
    e32 = relerr(x.cpu(), x_cpu)
    assert e32 <= 1e-4, f"32^3 f32 solve: card vs CPU plain path {e32:.2e}"
    _, st64, info64 = solve_poisson((64,) * 3, 4, rtol=1e-8, dtype=torch.float64, device=dev)
    assert st64.niter == 7 and st64.converged(), (st64.niter, st64.flag)
    x16, st16, _ = solve_poisson((16,) * 3, 3, rtol=1e-8, dtype=torch.float64, device=dev)
    x16c, st16c, _ = solve_poisson((16,) * 3, 3, rtol=1e-8, dtype=torch.float64, device="cpu")
    assert st16.niter == st16c.niter == 7
    e16 = relerr(x16.cpu(), x16c)
    assert e16 <= 1e-10, f"16^3 f64 solve: card vs CPU plain path {e16:.2e}"

    # the main path's run: every launch count starts at 0 here
    for c in (k1.counts, k2.counts):
        c.reset()
    t0 = time.perf_counter()
    xA, stA, infoA = solve_poisson_const((128,) * 3, 4, device=dev, dtype=torch.float32)
    torch.cuda.synchronize()
    secsA = time.perf_counter() - t0
    k1A, k2A = k1.counts.kernel, k2.counts.kernel
    t0 = time.perf_counter()
    xB, stB, infoB = solve_poisson((128,) * 3, 4, rtol=1e-8, dtype=torch.float64, device=dev)
    torch.cuda.synchronize()
    secsB = time.perf_counter() - t0
    k1B, k2B = k1.counts.kernel - k1A, k2.counts.kernel - k2A
    launches = {"K1": k1.counts.kernel, "K2": k2.counts.kernel}
    assert k1.counts.plain == 0 and k2.counts.plain == 0, (k1.counts, k2.counts)

    nA = cg_gmg_applies(stA.niter, 4, deg)
    assert stA.niter == 4 and stA.converged(), (stA.niter, stA.flag)
    assert xA.shape == (129 ** 3,) and bool(torch.isfinite(xA).all())
    assert infoA["l2_error"] <= 2e-4, infoA["l2_error"]
    assert k1A == nA == 115, (k1A, nA)
    assert k2A == 1  # l2_error's mass-matrix apply
    print(f"[4 path A] solve_poisson_const f32: 32^3/3 levels {st.niter} its (CPU plain path "
          f"{st_cpu.niter} its, x rel diff {e32:.1e}); 128^3/4 levels {stA.niter} its, "
          f"flag {stA.flag}, L2 error {infoA['l2_error']:.3e}, "
          f"{secsA:.2f} s incl. setup; K1 launches {k1A} = (n+1)((L-1)(2k+1)+2) "
          f"= {nA}, K2 launches {k2A} (L2 error), plain launches 0", flush=True)

    # setup: one Lanczos run per smoothing level (pre and post share it)
    nB = 3 * lanczos + cg_gmg_applies(stB.niter, 4, deg) + 1
    assert stB.niter == 6 and int(stB.flag) == 2, (stB.niter, stB.flag)  # CONVERGED_RTOL
    assert xB.shape == (129 ** 3,) and bool(torch.isfinite(xB).all())
    assert infoB["l2_error"] <= 1e-6, infoB["l2_error"]
    assert k1B == 0 and k2B == nB, (k1B, k2B, nB)
    print(f"[5 path B] solve_poisson f64 rtol 1e-8: 64^3/4 levels {st64.niter} its "
          f"(L2 {info64['l2_error']:.3e}); 16^3 card = CPU plain path {st16.niter} its, "
          f"x rel diff {e16:.1e}; 128^3/4 levels {stB.niter} its, flag CONVERGED_RTOL, "
          f"L2 error {infoB['l2_error']:.3e}, {secsB:.2f} s incl. setup; K2 launches {k2B} = "
          f"3*{lanczos} Lanczos + (n+1)((L-1)(2k+1)+2) + 1 = {nB}; plain launches 0", flush=True)

    # ---- 6 times --------------------------------------------------------
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)  # 256 MB > L2

    def cold():
        flush.zero_()

    mesh = mesh_of((129,) * 3)
    Ac = laplacian_const(mesh, torch.float32, dev)
    Ab = eliminate_dirichlet(laplacian(mesh, torch.float32, dev), mesh.boundary_vertex_mask())
    A16 = Ab.astype(torch.bfloat16)
    Ab64 = eliminate_dirichlet(laplacian(mesh, torch.float64, dev), mesh.boundary_vertex_mask())
    x = vec(Ac.n, torch.float32)
    x64 = x.double()
    a1 = (Ac.weights, Ac.free, Ac.offsets, Ac.grid_shape, x)
    per = Ab._periodic()
    t = {
        "K1": median_ms(lambda: k1.const_stencil_cuda(*a1)),
        "K1 cold L2": median_ms(lambda: k1.const_stencil_cuda(*a1), before=cold),
        "K1 plain": median_ms(lambda: k1.const_stencil_plain(*a1)),
        "K2": median_ms(lambda: k2.banded_stencil_cuda(Ab.bands, Ab.offsets, Ab.grid_shape, per, x)),
        "K2 plain": median_ms(lambda: k2.banded_stencil_plain(Ab.bands, Ab.offsets, Ab.grid_shape, per, x)),
        "K2 bf16": median_ms(lambda: k2.banded_stencil_cuda(A16.bands, A16.offsets, A16.grid_shape, per, x)),
        "K2 bf16 plain": median_ms(lambda: k2.banded_stencil_plain(A16.bands, A16.offsets, A16.grid_shape, per, x)),
        "K2 f64": median_ms(lambda: k2.banded_stencil_cuda(Ab64.bands, Ab64.offsets, Ab64.grid_shape, per, x64)),
        "K2 f64 plain": median_ms(lambda: k2.banded_stencil_plain(Ab64.bands, Ab64.offsets, Ab64.grid_shape, per, x64)),
    }
    for tag, info, b in (("solve A", infoA, infoA["problem"].b), ("solve B", infoB, infoB["problem"].b)):
        t[tag] = median_ms(lambda: info["solver"].solve(info["state"], b), runs=20, warmup=2,
                           spin=False)
    n = Ac.n
    gbs = {
        "K1": 3 * 4 * n / (t["K1"] * 1e6),            # x, free read, y written
        "K2": (27 * 4 + 2 * 4) * n / (t["K2"] * 1e6),  # bands, x, y
        "K2 bf16": (27 * 2 + 2 * 4) * n / (t["K2 bf16"] * 1e6),
        "K2 f64": (27 + 2) * 8 * n / (t["K2 f64"] * 1e6),
    }
    print(f"[6 times] {card} | 129^3 f32, median of {TIMING_RUNS} (CUDA events), ms per apply: "
          + ", ".join(f"{k} {v:.4f}" for k, v in t.items() if not k.startswith("solve"))
          + " | effective GB/s (bytes the algorithm needs / time): "
          + ", ".join(f"{k} {v:.0f}" for k, v in gbs.items())
          + f" | 128^3 solve only, median of 20: A (const f32, {stA.niter} its) {t['solve A']:.2f} ms"
          f", B (banded f64, {stB.niter} its) {t['solve B']:.2f} ms", flush=True)

    summary = {"kernels": [
        {"name": "K1 const_stencil", "route": "cuda",
         "source": "gridapsolvers_tpu_torch/csrc/const_stencil.cu",
         "replaces": "gridapsolvers_tpu/ops/stencil_pallas.py:61",
         "launches": launches["K1"], "max_abs_err": worst["K1"],
         "ms": t["K1"], "plain_ms": t["K1 plain"]},
        {"name": "K2 banded_stencil", "route": "cuda",
         "source": "gridapsolvers_tpu_torch/csrc/banded_stencil.cu",
         "replaces": "gridapsolvers_tpu/ops/banded_pallas.py:64",
         "launches": launches["K2"], "max_abs_err": worst["K2"],
         "ms": t["K2"], "plain_ms": t["K2 plain"]},
    ]}
    print(json.dumps(summary))
    torch.cuda.synchronize()
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    main()
