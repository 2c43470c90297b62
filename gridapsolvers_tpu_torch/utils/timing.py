"""Phase timers and profiling hooks.

Port of `gridapsolvers_tpu/utils/timing.py`, the analog of the reference's
PTimer usage (tic!/toc! with barriers around phases,
joss_paper/scalability/src/stokes_gmg.jl:2-36). On the card a barrier is
`torch.cuda.synchronize` on the device of the tensors it is given; on the
CPU there is nothing to wait for. `trace` records a region with
`torch.profiler` (CPU and, where there is a card, CUDA activity) and
writes a Chrome trace.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch

from .pytrees import tree_leaves


def fence(x) -> None:
    """Completion barrier: wait for the card that holds any tensor of x (a
    tensor or a nested tuple/list of them); a no-op for CPU tensors."""
    seen = set()
    for leaf in tree_leaves(x):
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            if leaf.device not in seen:
                seen.add(leaf.device)
                torch.cuda.synchronize(leaf.device)


class PTimer:
    """Named phase wall timers (reference PTimer: tic!/toc!)."""

    def __init__(self):
        self.data: Dict[str, float] = {}
        self._t0: Dict[str, float] = {}

    def tic(self, name: str, barrier=None):
        if barrier is not None:
            fence(barrier)
        self._t0[name] = time.perf_counter()

    def toc(self, name: str, barrier=None):
        if barrier is not None:
            fence(barrier)
        self.data[name] = self.data.get(name, 0.0) + (time.perf_counter() - self._t0.pop(name))

    @contextlib.contextmanager
    def phase(self, name: str, barrier=None):
        self.tic(name)
        try:
            yield
        finally:
            self.toc(name, barrier=barrier)

    def report(self) -> str:
        return "\n".join(f"{k:30s} {v:10.4f}s" for k, v in sorted(self.data.items()))


@contextlib.contextmanager
def trace(log_dir: str = "profile_trace"):
    """torch.profiler trace of the enclosed region, written to
    `log_dir/trace.json` (Chrome trace format); yields the profiler, whose
    `key_averages()` tabulates the region's operators and kernels."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
