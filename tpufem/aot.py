"""Ahead-of-time compilation and the precision policy of the solve programs.

Every solve program is lowered here (``lower``), under one matmul
precision: float32 products run at full float32 precision.  Without it a
GPU may run an f32 product with no precision given in TF32, which keeps
about three decimal digits and stalls CG far above its tolerance.
Programs whose inputs are deliberately bf16 (``la.amg.DenseMat``) keep
their bf16 operands and f32 accumulation.

The reference reaches its first solution in seconds because its kernels
are compiled at build time (ffcx/C++, src/CMakeLists.txt:23-33); AOT
compilation with a persistent cache (``config.enable_compilation_cache``)
is the JAX equivalent.
"""

from __future__ import annotations

import contextlib

import jax

# the one matmul precision of every program this package compiles
MATMUL_PRECISION = "highest"


def precision_policy() -> contextlib.AbstractContextManager:
    """Scope under which a program is traced: its f32 matrix products
    carry ``Precision.HIGHEST``."""
    return jax.default_matmul_precision(MATMUL_PRECISION)


def lower(fn, *args):
    """``jax.jit(fn)`` (or an already-jitted ``fn``) lowered against
    ``args`` under the precision policy."""
    jitted = fn if hasattr(fn, "lower") else jax.jit(fn)
    with precision_policy():
        return jitted.lower(*args)


def compile_aot(fn, *args):
    """``jax.jit(fn)`` compiled eagerly against ``args``; returns the
    compiled executable (callable with same-structured arguments)."""
    return lower(fn, *args).compile()


_EXE_CACHE: dict = {}


def compile_aot_cached(key, fn_factory, *args):
    """Process-wide compiled-executable memo (the analogue of DOLFINx's
    compiled-form cache: ffcx kernels are compiled once per signature
    and reused across every form instance).  ``fn_factory()`` is only
    called — and its program traced + compiled — the first time ``key``
    is seen; later builds reuse the executable with fresh same-shaped
    arguments.  Callers must fold every shape/constant the traced
    program closes over into ``key``.  Re-tracing the RHS assembly
    program measured 0.5-0.6 s per elasticity problem build at 500k —
    pure Python tracing overhead, identical program every time."""
    exe = _EXE_CACHE.get(key)
    if exe is None:
        exe = compile_aot(fn_factory(), *args)
        _EXE_CACHE[key] = exe
    return exe
