"""The JAX package's functions compiled for the port's parity tests.

``jit`` is ``jax.jit`` with XLA's CPU backend at optimization level 1: a
smoke model's programs compile in about half the time of the default
level 2, which is most of what the language-model parity tests spend.
``transformer.init_model`` draws bitwise the same weights at both levels
for every smoke configuration; a forward or a gradient moves by ~1e-7,
far inside each test's stated tolerance.  Call the reference compiled in
place of eagerly: eager, each call compiles its ops one by one.
"""

import jax

COMPILER_OPTIONS = {"xla_backend_optimization_level": 1}


def jit(fn, **kw):
    """``jax.jit(fn, **kw)`` at the tests' compiler options."""
    return jax.jit(fn, compiler_options=COMPILER_OPTIONS, **kw)
