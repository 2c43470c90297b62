"""The JAX package's Krylov solves under `jax.jit`, for the port's parity
tests (`tests/test_torch_*.py`). Eagerly, the JAX package dispatches a
solve op by op, several times slower on the CPU than the compiled solve;
the results are the same to round-off. Nothing of the JAX package is
edited: `jitted_jax_solves` swaps the classes' `solve` while active."""
import contextlib
import io

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


@contextlib.contextmanager
def jitted_jax_methods(*targets):
    """While active, each (class, method name) of the JAX package in
    `targets` runs compiled on its array arguments, one program a bound
    object (its own fields stay static: closed over, as a solver's
    configuration is), so a set-up that the JAX package runs eagerly op by
    op (a Vanka's patch extraction, a GMG's Lanczos estimates) compiles
    once instead. A call with a keyword argument, or whose tracing meets
    a host-side step (a concrete value asked of a traced array), runs as
    it was, eagerly; nothing else changes."""
    saved = [(cls, name, cls.__dict__.get(name), getattr(cls, name)) for cls, name in targets]
    eager_only = (jax.errors.ConcretizationTypeError, jax.errors.TracerArrayConversionError,
                  jax.errors.TracerBoolConversionError, jax.errors.TracerIntegerConversionError)

    def jitted(orig):
        compiled = {}   # id(object) -> (object, its compiled method, or None: eager)

        def method(self, *args, **kw):
            if kw:
                return orig(self, *args, **kw)
            kept = compiled.get(id(self))
            if kept is None or kept[0] is not self:
                kept = compiled[id(self)] = (self, jax.jit(lambda *a: orig(self, *a)))
            if kept[1] is None:
                return orig(self, *args)
            try:
                return kept[1](*args)
            except eager_only:
                compiled[id(self)] = (self, None)
                return orig(self, *args)
        return method

    for cls, name, _, orig in saved:
        setattr(cls, name, jitted(orig))
    try:
        yield
    finally:
        for cls, name, own, _ in saved:
            if own is None:
                delattr(cls, name)
            else:
                setattr(cls, name, own)


def jitted_jax_setups():
    """`jitted_jax_methods` on the JAX package's `CGSolver.setup`: a JAX
    entry point that sets up eagerly (`parallel.weak_scaling.weak_scaling_poisson`:
    the GMG levels' Lanczos estimates and ghost extensions) compiles its
    set-up instead."""
    import gridapsolvers_tpu.linear as jlin

    return jitted_jax_methods((jlin.CGSolver, "setup"))


def jitted_jax_patch_setups():
    """`jitted_jax_methods` on the JAX package's patch smoothers' value
    refresh (`VankaSolver._refresh`, `PatchSolver._refresh`: the ELL value
    gather, the batched patch extraction and inversion), which their
    `setup` runs eagerly after its host-side pattern work."""
    from gridapsolvers_tpu.patches.smoothers import PatchSolver
    from gridapsolvers_tpu.patches.vanka import VankaSolver

    return jitted_jax_methods((VankaSolver, "_refresh"), (PatchSolver, "_refresh"))


def jitted_jax_chebyshev_setups():
    """`jitted_jax_methods` on the JAX package's `ChebyshevSmoother.setup`
    (the inverse diagonal and the Lanczos or Gershgorin bound, eager op by
    op in a GMG's or an AMG's set-up)."""
    import gridapsolvers_tpu.linear as jlin

    return jitted_jax_methods((jlin.ChebyshevSmoother, "setup"))


@contextlib.contextmanager
def jitted_jax_dense():
    """While active, the JAX package's `ELLMatrix.todense` (eager op by op
    in its dense direct solvers' set-ups, in AMG's coarsest level and in
    the tests' dense references) runs compiled, one program a shape: the
    same zero matrix and scatter-add, traced once instead of dispatched op
    by op."""
    from gridapsolvers_tpu.algebra.ell import ELLMatrix

    own = ELLMatrix.__dict__["todense"]
    compiled = jax.jit(own)
    ELLMatrix.todense = lambda self: compiled(self)
    try:
        yield
    finally:
        ELLMatrix.todense = own


def run_in_f32(script: str, *contexts) -> str:
    """Run a test's script in this process with JAX's x64 off
    (`jax.enable_x64(False)`: true f32, as in a process of its own where
    tests/conftest.py has not turned it on), inside `contexts` (such as
    `jitted_jax_methods`), and return what it printed. The script must not
    change JAX's configuration or patch the JAX package itself."""
    out = io.StringIO()
    with contextlib.ExitStack() as stack:
        stack.enter_context(jax.enable_x64(False))
        for c in contexts:
            stack.enter_context(c)
        stack.enter_context(contextlib.redirect_stdout(out))
        exec(script, {"__name__": "f32_script"})
    return out.getvalue()
