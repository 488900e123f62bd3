"""Conjugate-gradient solver, jitted with ``lax.while_loop``.

From-scratch replacement for PETSc KSP CG (reference solver setup:
src/poisson_problem.cpp:164-179, README.md:72 ``-ksp_type cg -ksp_rtol
1.0e-8``) and generalization of the hand-written matrix-free CG
(src/cg.h:38-86: kmax, rtol on ||r||/||r0||, allreduce dots).

``action`` and ``precond`` are traceable functions; under sharding they
close over halo exchanges and psum reductions, so this single driver
serves both the single-chip and the SPMD paths.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from tpufem.la.vector import dot


def cg_solve(action: Callable[[jnp.ndarray], jnp.ndarray],
             b: jnp.ndarray,
             x0: Optional[jnp.ndarray] = None,
             precond: Optional[Callable[[jnp.ndarray], jnp.ndarray]] = None,
             rtol: float = 1e-8,
             maxit: int = 100,
             dot_fn: Callable = dot,
             ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Solve A x = b.  Returns (x, iterations, ||r||/||r0||).

    Convergence: ||r||_2 / ||r0||_2 < rtol on the recurrence residual,
    matching src/cg.h:78 (which compares squared norms against rtol^2).
    With a preconditioner this is still the *unpreconditioned* norm, so
    iteration counts are directly comparable across preconditioners.

    ``x0=None`` assumes a ZERO initial guess (PETSc KSP's default — the
    reference never sets KSPSetInitialGuessNonzero) so r0 = b with no
    operator application.  The loop is the "z-first" rotation of the
    classic recurrence (bit-identical iterates): the preconditioner and
    the operator each appear exactly ONCE in the lowered program, where
    the classic form inlines both twice (init + body).  On the
    const-table stencil programs those duplicated multigrid V-cycles
    dominated XLA compile time.
    """
    M = precond if precond is not None else (lambda v: v)
    if x0 is None:
        x = jnp.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - action(x0)
    rnorm0 = dot_fn(r, r)
    one = jnp.ones_like(rnorm0)

    def cond(state):
        x, r, p, rz_prev, rnorm, k = state
        return jnp.logical_and(k < maxit, rnorm > rtol * rtol * rnorm0)

    def body(state):
        x, r, p, rz_prev, rnorm, k = state
        z = M(r)
        rz = dot_fn(r, z)
        beta = jnp.where(k == 0, jnp.zeros_like(rz),
                         rz / rz_prev).astype(b.dtype)
        p = z + beta * p
        y = action(p)
        alpha = (rz / dot_fn(p, y)).astype(b.dtype)
        x = x + alpha * p
        r = r - alpha * y
        return (x, r, p, rz, dot_fn(r, r), k + 1)

    state = (x, r, jnp.zeros_like(b), one, rnorm0,
             jnp.asarray(0, dtype=jnp.int32))
    x, r, p, rz, rnorm, k = jax.lax.while_loop(cond, body, state)
    rel = jnp.sqrt(rnorm / rnorm0)
    return x, k, rel


def cg_solve_fused(action: Callable[[jnp.ndarray], jnp.ndarray],
                   b: jnp.ndarray,
                   x0: Optional[jnp.ndarray] = None,
                   rtol: float = 1e-8,
                   maxit: int = 100,
                   dot_fn: Callable = dot,
                   ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Unpreconditioned CG, Chronopoulos-Gear single-matvec form with
    barrier-free updates — the bandwidth-lean variant behind the
    cgpoisson Gdof/s metric.

    Identical Krylov trajectory to :func:`cg_solve` in exact arithmetic
    (same iterates, same residuals); finite-precision iterates differ in
    the last bits because the update order differs.  Why it is faster:
    the classic loop interleaves its axpys with reduction barriers
    (alpha needs p.y before x/r update, beta needs r.r before the p
    update), so its vector updates cannot fuse with the operator; here

    - the two reductions (r.r and w.r, w = A r) happen together right
      after the matvec (one fused pass over r and w);
    - all four vector updates (p, s = A p, x, r) use only
      already-known scalars, so they chain into back-to-back axpys with
      no reduction barrier between them:
          p' = r + beta p        s' = w + beta s
          x' = x + alpha p'      r' = r - alpha s'
      with alpha_k = rr_k / (w_k.r_k - beta_k rr_k / alpha_{k-1}),
      beta_k = rr_k / rr_{k-1} (Chronopoulos & Gear 1989; the s
      recurrence keeps s = A p without a second matvec).
      The state stays in four separate [N] vectors.

    Convergence: ||r|| / ||r0|| < rtol on the recurrence residual
    (reference src/cg.h:78), checked as the loop condition so the
    iteration count matches cg_solve's.

    The matvec sits at the TOP of the loop body (w = A r), so the
    lowered program holds exactly ONE ``action`` instance — with
    ``x0=None`` (zero initial guess, the product default) nothing is
    applied outside the loop at all.
    """
    dt = b.dtype
    if x0 is None:
        x = jnp.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - action(x0)
    rr0 = dot_fn(r, r)
    one = jnp.ones_like(rr0)
    z = jnp.zeros_like(b)

    def cond(state):
        p, s, x, r, rr, rr_prev, alpha_prev, k = state
        return jnp.logical_and(k < maxit, rr > rtol * rtol * rr0)

    def body(state):
        p, s, x, r, rr, rr_prev, alpha_prev, k = state
        w = action(r)
        wr = dot_fn(w, r)
        beta = jnp.where(k == 0, jnp.zeros_like(rr), rr / rr_prev)
        alpha = rr / (wr - beta * rr / alpha_prev)
        a = alpha.astype(dt)
        bt = beta.astype(dt)
        pn = r + bt * p
        sn = w + bt * s
        xn = x + a * pn
        rn = r - a * sn
        return (pn, sn, xn, rn, dot_fn(rn, rn), rr, alpha, k + 1)

    state = (z, z, x, r, rr0, one, one,
             jnp.asarray(0, dtype=jnp.int32))
    out = jax.lax.while_loop(cond, body, state)
    x, rr = out[2], out[4]
    rel = jnp.sqrt(rr / rr0)
    return x, out[7], rel
