"""Solver-info trees.

Port of `gridapsolvers_tpu/interfaces/info.py` (reference
SolverInterfaces/SolverInfos.jl:2-16,30-54): post-hoc dictionaries of
iteration counts, residuals and tolerances per solver, printable as a
nested tree that mirrors the preconditioner composition.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from .logs import SolverStats
from .tolerances import ConvergenceFlag, SolverTolerances


def get_solver_info(solver, stats: Optional[SolverStats] = None) -> Dict[str, Any]:
    """A dict of solver configuration and (optionally) convergence data
    (reference SolverInfos.jl:30-45)."""
    info: Dict[str, Any] = {"type": type(solver).__name__}
    tols = getattr(solver, "tols", None)
    if isinstance(tols, SolverTolerances):
        info["tols"] = {
            "maxiter": tols.maxiter,
            "atol": tols.atol,
            "rtol": tols.rtol,
            "dtol": tols.dtol,
        }
    if stats is not None:
        info["niter"] = int(stats.niter)
        info["flag"] = ConvergenceFlag(int(stats.flag)).name
        res = stats.residuals.cpu().tolist()
        info["r0"] = float(res[0])
        info["r_final"] = float(res[min(int(stats.niter), len(res) - 1)])
    return info


def children(solver):
    """Nested solvers of a composite solver (preconditioners, block solvers,
    GMG smoothers...). A solver may override this by defining `children()`."""
    if hasattr(solver, "children"):
        return solver.children()
    out = []
    for attr in ("Pl", "Pr", "M", "pre_smoother", "post_smoother",
                 "coarsest_solver", "solver", "inner"):
        s = getattr(solver, attr, None)
        if s is not None and hasattr(s, "setup"):
            out.append((attr, s))
    blocks = getattr(solver, "solvers", None)
    if blocks:
        out.extend((f"block[{i}]", s) for i, s in enumerate(blocks))
    return out


def format_solver_tree(solver, depth: int = 0) -> str:
    """Printable nested solver tree (reference SolverInfos.jl:49-54)."""
    pad = "  " * depth
    lines = [f"{pad}{type(solver).__name__}"]
    for _, child in children(solver):
        lines.append(format_solver_tree(child, depth + 1))
    return "\n".join(lines)
