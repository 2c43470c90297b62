"""The JAX package's Krylov solves under `jax.jit`, for the port's parity
tests (`tests/test_torch_*.py`). Eagerly, the JAX package dispatches a
solve op by op, several times slower on the CPU than the compiled solve;
the results are the same to round-off. Nothing of the JAX package is
edited: `jitted_jax_solves` swaps the classes' `solve` while active."""
import contextlib

import jax


def jsolve(solver, state, b):
    """solver.solve(state, b) of a JAX package solver, compiled."""
    return jax.jit(lambda v: solver.solve(state, v))(b)


@contextlib.contextmanager
def jitted_jax_solves():
    """While active, every JAX `CGSolver` and `GMRESSolver` solve from zero
    runs compiled (`FGMRESSolver` builds a `GMRESSolver`), one program a
    solver object, reused while it lives (each Newton step's state has the
    same structure), so the JAX package's model functions (`solve_darcy`
    and the like), which solve eagerly, run their solves compiled; nothing
    else of theirs changes."""
    import gridapsolvers_tpu.linear as jlin

    classes = [jlin.CGSolver, jlin.GMRESSolver]
    saved = [c.solve for c in classes]
    own = [c.__dict__.get("solve") for c in classes]

    def jitted(orig):
        compiled = {}   # id(solver) -> (solver, its compiled solve)

        def solve(self, state, b, x0=None):
            if x0 is not None:
                return orig(self, state, b, x0)
            kept = compiled.get(id(self))
            if kept is None or kept[0] is not self:
                kept = compiled[id(self)] = (self, jax.jit(lambda st, v: orig(self, st, v)))
            try:
                return kept[1](state, b)
            except TypeError:   # a state that is not all arrays: close over it
                return jax.jit(lambda v: orig(self, state, v))(b)
        return solve

    for c, orig in zip(classes, saved):
        c.solve = jitted(orig)
    try:
        yield
    finally:
        for c, orig in zip(classes, own):
            if orig is None:
                del c.solve
            else:
                c.solve = orig
