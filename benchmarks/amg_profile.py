"""Per-component timing of the SA-AMG V-cycle on the AMG-forced cube.

Pinpoints where the solve time goes (the AMG-forced solve costs far
more per dof*iteration than the GMG path).
Times, each as its own pipelined jitted dispatch:

  - fine stencil apply (the matrix-free fine_matvec hook)
  - per level: A matvec (ELL or dense), PT matvec, P matvec
  - dense coarse solve
  - one full V-cycle
  - one full CG solve (amortized per iteration)

Usage:  python benchmarks/amg_profile.py [ndofs]
"""

from __future__ import annotations

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")

from tpufem.config import Config, SolverOptions, enable_compilation_cache


def timeit(fn, x, reps: int = 30, passes: int = 3) -> float:
    """Amortized seconds per call (min over passes of pipelined reps;
    scalar readback as the completion barrier)."""
    y = fn(x)
    jax.block_until_ready(y)
    best = 1e30
    for _ in range(passes):
        t0 = time.perf_counter()
        out = x
        for _ in range(reps):
            out = fn(out) if out.shape == x.shape else fn(x)
        float(jnp.ravel(out)[-1])
        best = min(best, (time.perf_counter() - t0) / reps)
    return best


def main() -> None:
    enable_compilation_cache()
    ndofs = int(sys.argv[1]) if len(sys.argv) > 1 else 216_000
    dims = (60, 60, 60) if ndofs == 216_000 else None

    from tpufem.mesh import BoxTetMesh
    from tpufem.mesh.structured import compute_box_size_structured
    from tpufem.fem.dia_op import build_operator
    from tpufem.fem.dirichlet import DirichletBC
    from tpufem.fem.space import FunctionSpace
    from tpufem.la.amg import SAAMG, DenseMat
    from tpufem.problems import common

    if dims is None:
        nx, ny, nz, _ = compute_box_size_structured(ndofs, True, 1, 1, 1)
        dims = (nx, ny, nz)
    mesh = BoxTetMesh(*dims)
    space = FunctionSpace(mesh, 1)
    bc = DirichletBC.from_space(
        space, mesh.locate_boundary_facets(common.poisson_bc_marker))
    dtype = jnp.float32
    A = build_operator(mesh, 1, "poisson", bc_dofs=bc.flat_dofs(),
                       dtype=dtype, bake_bc=True)
    n = space.ndofs
    print(f"n = {n}", flush=True)

    M = A.to_scipy()
    t0 = time.perf_counter()
    cfg = Config(problem_type="poisson", ndofs=ndofs, scaling_type="strong",
                 dtype="float32",
                 solver=SolverOptions(pc_type="amg", ksp_rtol=1e-8,
                                      ksp_max_it=100))
    pc = SAAMG.setup((M.indptr, M.indices, M.data), bs=1,
                     options=cfg.solver, dtype=dtype, bc_mask=bc.mask())
    print(f"setup: {time.perf_counter() - t0:.2f}s  "
          f"levels {pc.level_sizes}", flush=True)

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(n).astype(np.float32))

    t = timeit(jax.jit(A.apply), x)
    print(f"fine stencil apply      : {t * 1e3:8.3f} ms", flush=True)

    for i, lv in enumerate(pc.levels):
        ni = pc.level_sizes[i]
        nc = pc.level_sizes[i + 1]
        xi = jnp.asarray(rng.standard_normal(ni).astype(np.float32))
        xc = jnp.asarray(rng.standard_normal(nc).astype(np.float32))
        kind = "dense" if isinstance(lv.A, DenseMat) else \
            f"ELL K={lv.A.cols.shape[1]}"
        ta = timeit(jax.jit(lv.A.matvec), xi)
        tr = timeit(jax.jit(lv.PT.matvec), xi)
        tp = timeit(jax.jit(lv.P.matvec), xc)
        print(f"level {i} ({ni:>7} -> {nc:>6}): A[{kind}] "
              f"{ta * 1e3:8.3f} ms  PT {tr * 1e3:8.3f} ms  "
              f"P {tp * 1e3:8.3f} ms  "
              f"(PT K={lv.PT.cols.shape[1]}, P K={lv.P.cols.shape[1]})",
              flush=True)

    tc = timeit(jax.jit(lambda v: jnp.matmul(
        pc.coarse_inv, v, precision=jax.lax.Precision.HIGHEST)),
        jnp.asarray(rng.standard_normal(
            pc.level_sizes[-1]).astype(np.float32)))
    print(f"coarse dense solve      : {tc * 1e3:8.3f} ms", flush=True)

    vc = jax.jit(lambda r: pc.vcycle(r, fine_matvec=A.apply))
    t = timeit(vc, x)
    print(f"full V-cycle            : {t * 1e3:8.3f} ms", flush=True)

    from tpufem.la.cg import cg_solve
    b = jnp.asarray(rng.standard_normal(n).astype(np.float32))

    def solve(rhs):
        xx, it, rel = cg_solve(A.apply, rhs,
                               precond=lambda r: pc.vcycle(
                                   r, fine_matvec=A.apply),
                               rtol=1e-8, maxit=100)
        return xx, it

    sj = jax.jit(solve)
    xx, it = sj(b)
    jax.block_until_ready(xx)
    it = int(it)
    t0 = time.perf_counter()
    outs = [sj(b * (1.0 + 1e-6 * i))[0] for i in range(5)]
    float(jnp.ravel(outs[-1])[-1])
    dt = (time.perf_counter() - t0) / 5
    print(f"CG solve: {dt * 1e3:.1f} ms, {it} iters "
          f"-> {dt / max(it, 1) * 1e3:.3f} ms/iter", flush=True)


if __name__ == "__main__":
    main()
