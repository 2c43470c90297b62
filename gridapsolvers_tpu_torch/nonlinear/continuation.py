"""Continuation between nonlinear operators (e.g. Picard -> Newton).

Port of `gridapsolvers_tpu/nonlinear/continuation.py` (reference
ContinuationFEOperator, src/NonlinearSolvers/ContinuationFEOperators.jl:
26-60,79-160): a nonlinear operator wrapping two operators and a switch;
residuals are op2's, Jacobians op1's until the switch fires, then op2's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from .newton import NonlinearOperator


@dataclasses.dataclass
class ContinuationSwitch:
    """Switch after `niter` Jacobian evaluations (the reference's usage,
    ContinuationFEOperators.jl:55-60), or when a callback
    (x, count) -> bool says so."""

    niter: int = 1
    callback: Optional[Callable] = None
    _count: int = dataclasses.field(default=0, repr=False)
    _switched: bool = dataclasses.field(default=False, repr=False)

    def should_switch(self, x) -> bool:
        if self._switched:
            return True
        self._count += 1
        if self.callback is not None:
            fire = bool(self.callback(x, self._count))
        else:
            fire = self._count > self.niter
        if fire:
            self._switched = True
        return fire


@dataclasses.dataclass
class ContinuationOperator(NonlinearOperator):
    """op1's Jacobian until the switch fires, then op2's; residuals always
    op2's (the true problem)."""

    op1: NonlinearOperator
    op2: NonlinearOperator
    switch: ContinuationSwitch

    def residual(self, x):
        return self.op2.residual(x)

    def jacobian(self, x):
        if self.switch.should_switch(x):
            return self.op2.jacobian(x)
        return self.op1.jacobian(x)
