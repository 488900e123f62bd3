"""Per-stage timing of the elasticity SA-AMG V-cycle at 500k.
Run: python benchmarks/el_amg_profile.py"""
import sys, time
sys.path.insert(0, ".")
from tpufem.config import Config, SolverOptions, enable_compilation_cache
enable_compilation_cache()
import jax, jax.numpy as jnp, numpy as np

from tpufem.mesh import BoxTetMesh
from tpufem.mesh.structured import compute_box_size_structured
from tpufem.fem.dia_op import build_operator
from tpufem.fem.dirichlet import DirichletBC
from tpufem.fem.space import FunctionSpace
from tpufem.la.amg import SAAMG, DenseMat
from tpufem.problems import common


def timeit(fn, x, reps=20, passes=3):
    y = fn(x); jax.block_until_ready(y)
    best = 1e30
    for _ in range(passes):
        t0 = time.perf_counter()
        out = x
        for _ in range(reps):
            out = fn(out) if out.shape == x.shape else fn(x)
        float(jnp.ravel(out)[-1])
        best = min(best, (time.perf_counter()-t0)/reps)
    return best


def main():
    nx, ny, nz, _ = compute_box_size_structured(500_000, True, 3, 1, 1)
    mesh = BoxTetMesh(nx, ny, nz)
    space = FunctionSpace(mesh, 1, bs=3)
    bc = DirichletBC.from_space(
        space, mesh.locate_boundary_facets(common.elasticity_bc_marker))
    dtype = jnp.float32
    A = build_operator(mesh, 1, "elasticity", bc_dofs=bc.flat_dofs(),
                       dtype=dtype)
    n = space.ndofs
    print(f"n = {n}  dims {nx}x{ny}x{nz}", flush=True)

    t0 = time.perf_counter()
    M = A.to_scipy()
    print(f"to_scipy: {time.perf_counter()-t0:.2f}s nnz={M.nnz}", flush=True)

    from tpufem.la.nullspace import build_near_nullspace
    nns = build_near_nullspace(space.scalar_dof_coords())

    cfg = Config(problem_type="elasticity", ndofs=500_000,
                 scaling_type="strong", dtype="float32",
                 solver=SolverOptions(pc_type="amg", ksp_rtol=1e-8,
                                      ksp_max_it=200))
    t0 = time.perf_counter()
    pc = SAAMG.setup((M.indptr, M.indices, M.data), bs=3, options=cfg.solver,
                     dtype=dtype, near_nullspace=nns, bc_mask=bc.mask(),
                     fine_factored=True)
    print(f"setup: {time.perf_counter()-t0:.2f}s levels {pc.level_sizes}",
          flush=True)
    print("phase:", {k: round(v, 2) for k, v in SAAMG.last_phase_s.items()},
          flush=True)

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    t = timeit(jax.jit(A.apply), x)
    print(f"fine stencil apply (interleaved): {t*1e3:8.3f} ms", flush=True)

    lv0 = pc.levels[0]

    def pt_piece(v):
        return jnp.zeros(pc.level_sizes[1], dtype=v.dtype).at[
            lv0.fcols].add(lv0.fw * v[:, None])
    t = timeit(jax.jit(pt_piece), x)
    print(f"factored P0^T scatter-add      : {t*1e3:8.3f} ms", flush=True)
    xc = jnp.asarray(rng.standard_normal(pc.level_sizes[1]).astype(np.float32))

    def p_piece(vc):
        return jnp.sum(lv0.fw * vc[lv0.fcols], axis=-1)
    t = timeit(jax.jit(p_piece), xc)
    print(f"factored P0 gather             : {t*1e3:8.3f} ms", flush=True)

    for i, lv in enumerate(pc.levels[1:], start=1):
        ni = pc.level_sizes[i]
        nc = pc.level_sizes[i + 1]
        xi = jnp.asarray(rng.standard_normal(ni).astype(np.float32))
        xcc = jnp.asarray(rng.standard_normal(nc).astype(np.float32))
        kind = ("dense" if isinstance(lv.A, DenseMat)
                else f"ELL K={lv.A.cols.shape[1]}")
        ta = timeit(jax.jit(lv.A.matvec), xi)
        tr = timeit(jax.jit(lv.PT.matvec), xi)
        tp = timeit(jax.jit(lv.P.matvec), xcc)
        print(f"level {i} ({ni:>7} -> {nc:>6}): A[{kind}] {ta*1e3:8.3f} ms  "
              f"PT {tr*1e3:8.3f} ms  P {tp*1e3:8.3f} ms", flush=True)

    vc = jax.jit(lambda r: pc.vcycle(r, fine_matvec=A.apply))
    t = timeit(vc, x)
    print(f"full V-cycle                   : {t*1e3:8.3f} ms", flush=True)


if __name__ == "__main__":
    main()
