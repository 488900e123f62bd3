"""Sharded problem constructors — the multi-device cube path the CLI
dispatches to when ``--num_shards > 1``.

The reference's driver IS the parallel program (every rank runs
src/main.cpp and PETSc solves across ranks); here the equivalent is one
SPMD program over a 1-D jax.sharding.Mesh (tpufem.parallel.slab).
Problem semantics:

- poisson / elasticity: assembled-operator CG + distributed geometric
  multigrid to ksp_rtol (reference poisson_problem.cpp:164-179,
  README.md:63-128);
- cgpoisson: unpreconditioned matrix-free CG, kmax=100 rtol=1e-6, with
  the Gdof/s throughput metric (cgpoisson_problem.cpp:236-242).
"""

from __future__ import annotations

import time
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpufem.config import Config
from tpufem.fem.dirichlet import DirichletBC
from tpufem.fem.space import FunctionSpace
from tpufem.parallel.slab import ShardedCubeSolver
from tpufem.problems import common
from tpufem.timing import Timer


def _global_rhs(space: FunctionSpace, bc, problem_name: str, dtype):
    """Global RHS as a host vector: assembled on-device for float32
    (one jitted mass-stencil apply + readback), host f64 otherwise."""
    if dtype == jnp.float32:
        if problem_name == "elasticity":
            from tpufem.problems.elasticity import \
                assemble_elasticity_rhs_structured_dev as dev_rhs
        else:
            from tpufem.problems.poisson import \
                assemble_poisson_rhs_structured_dev as dev_rhs
        return np.asarray(dev_rhs(space, bc, dtype))
    if problem_name == "elasticity":
        from tpufem.problems.elasticity import assemble_elasticity_rhs_np
        return assemble_elasticity_rhs_np(space)
    from tpufem.problems.poisson import assemble_poisson_rhs_np
    return assemble_poisson_rhs_np(space)


def problem_rowshard(mesh, order: int, cfg: Config, problem_name: str,
                     num_shards: int) -> common.Problem:
    """Row-sharded assembled path (unstructured meshes; cube order >= 2):
    distributed CG + SA-AMG with sharded fine level
    (tpufem.parallel.rowshard).  Reference: the spoke-mesh CI jobs run
    assembled Poisson + AMG on 2 ranks (ccpp.yml:102-117).

    ``cgpoisson`` runs the same row-sharded operator UNPRECONDITIONED to
    cg_rtol/cg_kmax with the Gdof/s metric: on the BC-zero subspace the
    eliminated operator's Krylov trajectory equals the rows-zero
    matrix-free action's (cgpoisson_problem.cpp:193-243)."""
    import numpy as np

    from tpufem.fem.assemble import assemble_operator
    from tpufem.parallel.rowshard import ShardedEllSolver

    dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32
    matfree = problem_name == "cgpoisson"
    base = "poisson" if matfree else problem_name
    bs = 3 if problem_name == "elasticity" else 1
    marker = (common.elasticity_bc_marker if problem_name == "elasticity"
              else common.poisson_bc_marker)
    solver = cfg.solver

    with Timer("ZZZ FunctionSpace"):
        space = FunctionSpace(mesh, order, bs=bs)
        _ = space.cell_dofs

    with Timer("ZZZ Create boundary conditions"):
        facets = mesh.locate_boundary_facets(marker)
        bc = DirichletBC.from_space(space, facets)

    with Timer("ZZZ Assemble matrix"):
        from tpufem.mesh import BoxTetMesh
        if isinstance(mesh, BoxTetMesh):
            # stencil -> CSR export skips the O(cells) host element-
            # tensor assembly (~36 s at 500k; equality pinned in
            # tests/test_dia_op.py::test_to_scipy_matches_assembled)
            from tpufem.fem.dia_op import DiaOperator
            op = DiaOperator.build(mesh, order, base,
                                   bc_dofs=bc.flat_dofs(),
                                   dtype=jnp.float64, device=False)
            M = op.to_scipy()
            csr = (M.indptr, M.indices, M.data)
        else:
            _A, csr = assemble_operator(space, bc, base, dtype=np.float64)

    with Timer("ZZZ Assemble vector"):
        if problem_name == "elasticity":
            from tpufem.problems.elasticity import \
                assemble_elasticity_rhs_np
            b_np = assemble_elasticity_rhs_np(space)
        else:
            from tpufem.problems.poisson import assemble_poisson_rhs_np
            b_np = assemble_poisson_rhs_np(space)
        b_np[bc.flat_dofs()] = 0.0 if matfree else bc.value

    # pure-Neumann deflation (the spoke mesh has no Dirichlet facets;
    # mirror of problems/poisson.make_solver's documented deviation)
    deflate = (problem_name == "poisson"
               and np.asarray(bc.flat_dofs()).size == 0)
    if deflate:
        b_np = b_np - b_np.mean()

    nns = None
    if problem_name == "elasticity":
        from tpufem.la.nullspace import build_near_nullspace
        with Timer("ZZZ Create near-nullspace"):
            nns = build_near_nullspace(space.scalar_dof_coords())

    if matfree:
        rtol = float(solver.extra.get("cg_rtol", 1e-6))
        maxit = int(solver.extra.get("cg_kmax", 100))
        solver._consumed.update(("cg_rtol", "cg_kmax"))
        precond = False
    else:
        rtol = float(solver.get("ksp_rtol"))
        maxit = int(solver.get("ksp_max_it"))
        precond = _resolve_sharded_precond(solver, "SA-AMG")

    with Timer("ZZZ Solver setup"):
        sh = ShardedEllSolver.build(
            space, bc, csr, b_np, num_shards, solver, dtype=dtype,
            near_nullspace=nns, rtol=rtol, maxit=maxit,
            precond=precond, deflate=deflate)

    multiproc = jax.process_count() > 1

    def solver_function(u0, rhs) -> Tuple[jnp.ndarray, int]:
        if multiproc:
            # multi-controller: x stays a global sharded array; report
            # the owned-masked distributed norm (la::norm allreduce,
            # reference main.cpp:229) instead of collecting
            import time as _time
            jax.block_until_ready(sh._run()[0])
            t0 = _time.perf_counter()
            x_loc, it, rel = sh._run()
            jax.block_until_ready(x_loc)
            dt = _time.perf_counter() - t0
            n2 = jax.jit(lambda m, v: jnp.sum(
                jnp.where(m, v, 0.0).astype(jnp.float64) ** 2
                if v.dtype == jnp.float64 else
                jnp.where(m, v, 0.0) ** 2))(sh.data["owned_mask"], x_loc)
            solver_function._last_norm = float(np.sqrt(float(n2)))
        else:
            x_loc, it, rel, dt = sh.solve_timed(reps=3)
        if matfree:
            gdofs = int(it) * space.ndofs / dt / 1e9
            print(f"CG matrix-free action processed: {gdofs} Gdof/s",
                  flush=True)
            problem_rowshard._last_gdofs = gdofs
        problem_rowshard._last_solve_s = dt
        return jnp.asarray(x_loc) if not multiproc else x_loc, int(it)

    if multiproc:
        return common.Problem(b=None, u=None,
                              solver_function=solver_function,
                              space=space, bc=bc)
    return common.Problem(b=jnp.asarray(b_np.astype(np.dtype(dtype))),
                          u=jnp.zeros(space.ndofs, dtype=dtype),
                          solver_function=solver_function,
                          space=space, bc=bc)


def _resolve_sharded_precond(solver, forced_name: str) -> bool:
    """Honor ``-pc_type none`` on the sharded paths; any other explicit
    choice is overridden by the path's multigrid and logged (the serial
    path honors jacobi etc. — the distributed programs implement only
    their multigrid and unpreconditioned CG)."""
    import logging
    pc_type = solver.get("pc_type")
    if pc_type == "none":
        return False
    if pc_type not in ("auto", "amg", "gmg"):
        logging.getLogger("tpufem").warning(
            "sharded path ignores '-pc_type %s' and uses %s "
            "(only 'none' is honored here)", pc_type, forced_name)
    return True


def problem(mesh, order: int, cfg: Config, problem_name: str,
            num_shards: int) -> common.Problem:
    dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32
    bs = 3 if problem_name == "elasticity" else 1
    matfree = problem_name == "cgpoisson"
    base = "poisson" if matfree else problem_name
    marker = (common.elasticity_bc_marker if problem_name == "elasticity"
              else common.poisson_bc_marker)
    solver = cfg.solver

    with Timer("ZZZ FunctionSpace"):
        space = FunctionSpace(mesh, order, bs=bs)

    with Timer("ZZZ Create boundary conditions"):
        facets = mesh.locate_boundary_facets(marker)
        bc = DirichletBC.from_space(space, facets)

    import jax
    multiproc = jax.process_count() > 1

    with Timer("ZZZ Assemble vector"):
        # multi-process: the RHS is built slab-locally inside
        # build_per_host (no process holds a global vector) — the
        # reference's per-rank assemble_vector (poisson_problem.cpp:146)
        b_global = None if multiproc else _global_rhs(space, bc, base,
                                                      dtype)

    if matfree:
        rtol = float(solver.extra.get("cg_rtol", 1e-6))
        maxit = int(solver.extra.get("cg_kmax", 100))
        solver._consumed.update(("cg_rtol", "cg_kmax"))
        precond = False
    else:
        rtol = float(solver.get("ksp_rtol"))
        maxit = int(solver.get("ksp_max_it"))
        precond = _resolve_sharded_precond(solver, "geometric multigrid")

    with Timer("ZZZ Assemble matrix"):
        if multiproc:
            # the mpirun -np N analogue: every process builds ONLY its
            # addressable shards (reference src/main.cpp:246,
            # mesh.cpp:164-180); covers the reference's full CI matrix —
            # order 1-3, assembled and matrix-free (ccpp.yml:56-117)
            sh = ShardedCubeSolver.build_per_host(
                mesh, num_shards, problem=base, order=order, dtype=dtype,
                rtol=rtol, maxit=maxit, precond=precond,
                coarse_limit=int(solver.get("amg_coarse_eq_limit")),
                smoother_degree=int(solver.get("amg_smoother_degree")),
                max_levels=int(solver.get("amg_max_levels")))
        else:
            sh = ShardedCubeSolver.build(
                mesh, num_shards, problem=base, order=order, dtype=dtype,
                rtol=rtol, maxit=maxit, precond=precond,
                coarse_limit=int(solver.get("amg_coarse_eq_limit")),
                smoother_degree=int(solver.get("amg_smoother_degree")),
                max_levels=int(solver.get("amg_max_levels")),
                b_global=b_global)

    def solver_function(u0, rhs) -> Tuple[jnp.ndarray, int]:
        if multiproc:
            # multi-controller: every process dispatches the SAME global
            # program; x stays a sharded global array (collecting to
            # host would need non-addressable shards).  The solution
            # norm is the owned-masked global reduction — the
            # reference's la::norm allreduce (main.cpp:229)
            import time as _time
            jax.block_until_ready(sh._run(sh.b_local)[0])
            t0 = _time.perf_counter()
            x_loc, it, rel = sh._run(sh.b_local)
            jax.block_until_ready(x_loc)
            problem._last_solve_s = _time.perf_counter() - t0
            if matfree:
                gdofs = int(it) * space.ndofs / problem._last_solve_s / 1e9
                print(f"CG matrix-free action processed: {gdofs} Gdof/s",
                      flush=True)
                problem._last_gdofs = gdofs
            n2 = jax.jit(lambda o, v: jnp.sum(
                jnp.where(o, v, 0.0).astype(jnp.float64) ** 2
                if v.dtype == jnp.float64 else
                jnp.where(o, v, 0.0) ** 2))(sh.owned, x_loc)
            solver_function._last_norm = float(np.sqrt(float(n2)))
            return x_loc, int(it)
        # compile outside the timed region (AOT analogue), then one
        # timing pass over repeated solves
        x, it, rel, dt = sh.solve_timed(reps=3)
        if matfree:
            gdofs = it * space.ndofs / dt / 1e9
            print(f"CG matrix-free action processed: {gdofs} Gdof/s",
                  flush=True)
            problem._last_gdofs = gdofs
        problem._last_solve_s = dt
        return jnp.asarray(x), it

    if multiproc:
        # the solver closure consumes its own slab-local RHS; Problem.b
        # is never read on this path, and materializing a global vector
        # would defeat the per-host build
        return common.Problem(b=None, u=None,
                              solver_function=solver_function,
                              space=space, bc=bc)
    bg = b_global.copy()
    bg[bc.flat_dofs()] = 0.0 if matfree else bc.value
    return common.Problem(b=jnp.asarray(bg.astype(np.dtype(dtype))),
                          u=jnp.zeros(space.ndofs, dtype=dtype),
                          solver_function=solver_function,
                          space=space, bc=bc)
