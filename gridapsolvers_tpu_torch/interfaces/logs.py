"""Convergence logging and solver statistics.

Port of `gridapsolvers_tpu/interfaces/logs.py`. Every solver records its
residual history into a fixed-size tensor on the vectors' device and
returns a `SolverStats`; pretty-printing happens afterwards on the host.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch

from .tolerances import ConvergenceFlag, SolverTolerances


class VerboseLevel(enum.IntEnum):
    """Reference SolverVerboseLevel (ConvergenceLogs.jl:1-24)."""

    NONE = 0
    LOW = 1
    HIGH = 2


@dataclasses.dataclass
class SolverStats:
    """Result record of one solve.

    niter     : number of iterations performed.
    flag      : ConvergenceFlag value.
    residuals : (maxiter+1,) residual-norm history; entries past `niter`
                hold NaN. residuals[0] is the initial residual.
    """

    niter: int
    flag: int
    residuals: torch.Tensor
    # Optional solver-specific diagnostics (e.g. CG Lanczos coefficients).
    extra: Optional[object] = None

    @property
    def final_residual(self):
        return self.residuals[min(int(self.niter), self.residuals.shape[0] - 1)]

    def converged(self) -> bool:
        f = int(self.flag)
        return f in (ConvergenceFlag.CONVERGED_ATOL, ConvergenceFlag.CONVERGED_RTOL)


def init_history(maxiter: int, r0norm: torch.Tensor) -> torch.Tensor:
    """Fresh residual-history tensor with residuals[0] = ||r0||."""
    hist = torch.full(
        (maxiter + 1,), float("nan"), dtype=r0norm.dtype, device=r0norm.device
    )
    hist[0] = r0norm
    return hist


def record(hist: torch.Tensor, it, rnorm) -> torch.Tensor:
    """Record the residual of iteration `it` (1-based) into `hist`, in
    place, and return it."""
    hist[it] = rnorm
    return hist


def make_stats(tols: SolverTolerances, niter: int, rnorm, r0norm, hist) -> SolverStats:
    return SolverStats(
        niter=int(niter),
        flag=tols.finished_flag(niter, rnorm, r0norm),
        residuals=hist,
    )


@dataclasses.dataclass
class ConvergenceLog:
    """Host-side pretty printer for SolverStats (post-hoc).

    Mirrors the reference output format: a header, per-iteration residual
    table (verbose=HIGH), and a convergence summary line, with two-space
    indentation per nesting `depth` (ConvergenceLogs.jl:71-83,101-150).
    """

    name: str
    tols: SolverTolerances = dataclasses.field(default_factory=SolverTolerances)
    verbose: VerboseLevel = VerboseLevel.NONE
    depth: int = 0

    def _indent(self) -> str:
        return "  " * self.depth

    def report(self, stats: SolverStats) -> str:
        niter = int(stats.niter)
        res = stats.residuals.cpu().tolist()
        flag = ConvergenceFlag(int(stats.flag))
        pad = self._indent()
        lines = []
        if self.verbose >= VerboseLevel.HIGH:
            lines.append(f"{pad}{self.name}: starting, ||r0|| = {res[0]:.6e}")
            for it in range(1, niter + 1):
                lines.append(f"{pad}  iter {it:4d}  r = {res[it]:.6e}")
        if self.verbose >= VerboseLevel.LOW:
            rfinal = res[min(niter, len(res) - 1)]
            lines.append(
                f"{pad}{self.name}: {flag.name} in {niter} iterations, "
                f"||r|| = {rfinal:.6e}"
            )
        text = "\n".join(lines)
        if text:
            print(text)
        return text
