"""CLI driver — the ``dolfinx-scaling-test`` executable equivalent.

Rebuild of solve()/main() (reference: src/main.cpp:52-275): parses the
same double-hyphen app flags (main.cpp:57-74), passes single-hyphen
options through to the solver namespace (the PETSc options-DB analogue,
main.cpp:77-81, with a warn-on-unused audit replacing -options_left),
builds the mesh, dispatches to the problem, prints the reproducibility
summary, times the solve, optionally writes XDMF, prints the ZZZ timing
table, and reports Krylov iterations + solution norm.

Run:  python -m tpufem --problem_type poisson --ndofs 500000 --order 1
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import List, Optional, Tuple

import numpy as np

from tpufem import __version__
from tpufem.config import Config, SolverOptions
from tpufem.logutil import init_logging, int64_to_human
from tpufem.timing import REGISTRY, Timer, list_timings


def parse_args(argv: Optional[List[str]] = None) -> Config:
    parser = argparse.ArgumentParser(
        prog="tpufem", description="FEM scaling test",
        allow_abbrev=False)
    parser.add_argument("--problem_type", default="poisson",
                        help="problem (poisson, cgpoisson, or elasticity)")
    parser.add_argument("--mesh_type", default="cube",
                        help="mesh (cube or unstructured)")
    parser.add_argument("--scaling_type", default="weak",
                        help="scaling (weak or strong)")
    parser.add_argument("--ndofs", type=int, default=50000,
                        help="number of degrees of freedom")
    parser.add_argument("--order", type=int, default=1, help="polynomial order")
    parser.add_argument("--scatterer", default="neighbor",
                        help="ghost exchange schedule (neighbor or p2p)")
    parser.add_argument("--output", default="",
                        help="output directory (no output unless set)")
    parser.add_argument("--memory_profiling", action="store_true")
    parser.add_argument("--subcomm_partition", action="store_true")
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "float64", "mixed"])
    parser.add_argument("--num_shards", type=int, default=0,
                        help="device shards (0 = all visible devices)")
    args, unknown = parser.parse_known_args(argv)

    # single-hyphen pass-through -> solver options namespace
    # (the PETSc options DB analogue, reference main.cpp:77-81)
    solver = SolverOptions()
    i = 0
    while i < len(unknown):
        tok = unknown[i]
        if not tok.startswith("-"):
            raise SystemExit(f"unrecognized argument: {tok}")
        key = tok.lstrip("-")
        val: object = True

        def _is_number(s: str) -> bool:
            try:
                float(s)
                return True
            except ValueError:
                return False

        # a following token is this option's value unless it starts a
        # new flag; negative numbers ("-ksp_rtol -1e-6") are values
        if i + 1 < len(unknown) and (not unknown[i + 1].startswith("-")
                                     or _is_number(unknown[i + 1])):
            raw = unknown[i + 1]
            try:
                val = int(raw)
            except ValueError:
                try:
                    val = float(raw)
                except ValueError:
                    val = raw
            i += 1
        if hasattr(solver, key) and key not in ("extra",):
            setattr(solver, key, type(getattr(solver, key))(val)
                    if not isinstance(val, bool) else val)
        else:
            solver.extra[key] = val
        i += 1

    return Config(
        problem_type=args.problem_type, mesh_type=args.mesh_type,
        scaling_type=args.scaling_type, ndofs=args.ndofs, order=args.order,
        scatterer=args.scatterer, output=args.output,
        memory_profiling=args.memory_profiling,
        subcomm_partition=args.subcomm_partition, dtype=args.dtype,
        num_shards=args.num_shards, solver=solver)


@dataclasses.dataclass
class SolveReport:
    """What one CLI run measured (the printed summary, as values)."""

    iterations: int
    norm: float
    ndofs: int
    solve_s: float                    # wall of the ZZZ Solve stage
    rel: Optional[float] = None       # device-reported relative residual
    true_rel: Optional[float] = None  # f64 ||b - A x|| / ||b||
    refine_passes: int = 0
    gdofs: Optional[float] = None     # cgpoisson throughput


def solve(cfg: Config) -> Tuple[int, float]:
    """Run one configuration; returns (iterations, solution norm)."""
    r = run(cfg)
    return r.iterations, r.norm


def run(cfg: Config) -> SolveReport:
    """Run one configuration; returns its SolveReport."""
    import jax
    if cfg.dtype in ("float64", "mixed"):
        jax.config.update("jax_enable_x64", True)
    from tpufem.config import enable_compilation_cache
    enable_compilation_cache()

    # multi-process runtime (the MPI_Init analogue, reference
    # main.cpp:246): joins the jax.distributed cluster when coordinator
    # env vars are set; single-process otherwise.  Under multiple
    # processes jax.devices() below is the GLOBAL device list and the
    # sharded setup paths build only per-host-local data
    # (tpufem.parallel.multihost).
    from tpufem.parallel.multihost import init_from_env
    proc_id, proc_count = init_from_env()

    logger = init_logging(rank=proc_id)

    # warm the malloc pool in the background while setup waits on the
    # device (see tpufem.hostmem) — sized to the setup-phase working set
    from tpufem.hostmem import prefault, warm_vm
    prefault(min(2 << 30, max(256 << 20, 2048 * cfg.ndofs)),
             background=True)
    # large runs touch well beyond the pool: materialize the rest of the
    # host working set off the critical path (nice'd subprocess, stopped
    # when the run ends; see tpufem.hostmem.warm_vm)
    warm = None
    if cfg.ndofs >= 1_000_000 or cfg.mesh_type == "unstructured":
        warm = warm_vm(min(12 << 30, max(4 << 30, 8192 * cfg.ndofs)))
    try:
        return _solve(cfg, proc_id, proc_count, logger)
    finally:
        if warm is not None:
            warm.kill()
            warm.wait()


def _solve(cfg: Config, proc_id: int, proc_count: int, logger
           ) -> SolveReport:
    import jax
    num_shards = cfg.num_shards or len(jax.devices())

    # multi-shard execution: slab-sharded SPMD GMG on the cube path for
    # every order (scalar and elasticity; orders >= 2 add the sharded
    # p-coarsening level, tpufem.parallel.slab); unstructured meshes —
    # and cube meshes too small to carry a sharded multigrid chain —
    # use the row-sharded assembled path (tpufem.parallel.rowshard), so
    # every CLI configuration executes distributed under --num_shards
    use_sharded = num_shards > 1 and cfg.mesh_type == "cube"
    use_rowshard = num_shards > 1 and not use_sharded
    if (use_sharded or use_rowshard) and len(jax.devices()) < num_shards:
        raise SystemExit(
            f"num_shards={num_shards} but only {len(jax.devices())} "
            "devices are visible (for a virtual CPU mesh set "
            "JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_"
            f"device_count={num_shards})")
    if cfg.scatterer == "p2p":
        logger.info("scatterer=p2p: slab halos use one ppermute ring "
                    "either way; schedule identical to 'neighbor'")
    if cfg.subcomm_partition:
        logger.info("subcomm_partition: no-op under single-host SPMD "
                    "(one process drives the device mesh)")

    mem = None
    if cfg.memory_profiling:
        from tpufem.memprof import MemoryProfiler
        mem = MemoryProfiler().start()

    strong_scaling = cfg.scaling_type == "strong"

    with Timer("ZZZ Create Mesh"):
        if cfg.mesh_type == "cube":
            from tpufem.mesh import BoxTetMesh
            from tpufem.mesh.structured import compute_box_size_structured
            # lattice dims divisible by 2^levels so geometric multigrid
            # can coarsen (the dyadic factor doubles as the reference's
            # refinement parameter r, src/mesh.cpp:100-126)
            nx, ny, nz, r = compute_box_size_structured(
                cfg.ndofs, strong_scaling, cfg.dofs_per_node, cfg.order,
                num_shards)
            mesh = BoxTetMesh(nx, ny, nz)
            print(f"UnitCube ({nx >> r}x{ny >> r}x{nz >> r}) to be "
                  f"refined {r} times", flush=True)
        else:
            from tpufem.mesh.spoke import create_spoke_mesh
            mesh = create_spoke_mesh(cfg.ndofs, strong_scaling,
                                     cfg.dofs_per_node, num_shards)

    with Timer("ZZZ Create facets and facet->cell connectivity"):
        facets = mesh.boundary_faces()
        if cfg.mesh_type == "cube":
            mesh.boundary_facet_cells(facets)  # closed-form table, O(facets)
        else:
            from tpufem.problems.common import facet_to_cell
            facet_to_cell(mesh.cell_faces(), facets)

    from tpufem.problems import cgpoisson, elasticity, poisson
    problems = {"poisson": poisson.problem, "cgpoisson": cgpoisson.problem,
                "elasticity": elasticity.problem}
    if use_sharded and cfg.problem_type != "cgpoisson":
        from tpufem.parallel.slab import slab_gmg_viable
        if not slab_gmg_viable(
                mesh, num_shards, bs=cfg.dofs_per_node,
                coarse_limit=int(cfg.solver.get("amg_coarse_eq_limit")),
                max_levels=int(cfg.solver.get("amg_max_levels")),
                precond=cfg.solver.get("pc_type") != "none"):
            logger.info("cube mesh %dx%dx%d too small for a sharded "
                        "multigrid chain over %d slabs; using the "
                        "row-sharded path", mesh.Nx, mesh.Ny, mesh.Nz,
                        num_shards)
            use_sharded, use_rowshard = False, True
    if use_sharded:
        from tpufem.problems import sharded
        prob = sharded.problem(mesh, cfg.order, cfg, cfg.problem_type,
                               num_shards)
    elif use_rowshard:
        from tpufem.problems import sharded
        prob = sharded.problem_rowshard(mesh, cfg.order, cfg,
                                        cfg.problem_type, num_shards)
    else:
        prob = problems[cfg.problem_type](mesh, cfg.order, cfg)

    # reproducibility summary (reference main.cpp:172-206)
    import jaxlib
    num_dofs = prob.space.ndofs
    num_cells = mesh.num_cells_global
    line = "-" * 64
    print(line)
    print("Test problem summary")
    print(f"  tpufem version:  {__version__}")
    print(f"  jax version:     {jax.__version__}")
    print(f"  jaxlib version:  {jaxlib.__version__}")
    print(f"  backend:         {jax.default_backend()}")
    print(f"  dtype:           {cfg.dtype}")
    print(f"  Problem type:    {cfg.problem_type}")
    print(f"  Scaling type:    {cfg.scaling_type}")
    print(f"  Num processes:   {proc_count}")
    print(f"  Num shards:      {num_shards}")
    print(f"  Num cells:       {num_cells}{int64_to_human(num_cells)}")
    print(f"  Total degrees of freedom:               "
          f"{num_dofs}{int64_to_human(num_dofs)}")
    print(f"  Average degrees of freedom per shard:   "
          f"{num_dofs // num_shards}")
    print(line, flush=True)

    # -log_view analogue (every recommended reference config runs
    # PETSc's -log_view, README.md:71): the ZZZ table below is the
    # always-on stage summary; this flag additionally captures a
    # jax.profiler device/host trace of the solve for op-level
    # inspection (tensorboard / xprof reads the directory)
    log_view = cfg.solver.extra.get("log_view")
    cfg.solver._consumed.add("log_view")
    import contextlib as _ctx
    trace_dir = None
    if log_view:
        trace_dir = (log_view if isinstance(log_view, str)
                     else (cfg.output or ".") + "/tpufem-trace")
        trace_cm = jax.profiler.trace(trace_dir)
    else:
        trace_cm = _ctx.nullcontext()

    t0 = time.perf_counter()
    with Timer("ZZZ Solve"), trace_cm:
        x, num_iter = prob.solver_function(prob.u, prob.b)
        jax.block_until_ready(x)
    solve_s = time.perf_counter() - t0
    if trace_dir is not None:
        print(f"-log_view: profiler trace written to {trace_dir}",
              flush=True)

    if cfg.output:
        import os
        with Timer("ZZZ Output"):
            os.makedirs(cfg.output, exist_ok=True)
            from tpufem.io import write_xdmf
            fn = os.path.join(cfg.output, f"solution-{num_shards}.xdmf")
            write_xdmf(fn, mesh, np.asarray(x), bs=prob.space.bs,
                       space=prob.space)

    list_timings(ranks=num_shards)

    # multi-process solvers report the owned-masked distributed norm
    # themselves (the la::norm allreduce, reference main.cpp:229) —
    # their x is a global sharded array this process cannot gather
    sol_norm = getattr(prob.solver_function, "_last_norm", None)
    if sol_norm is None:
        from tpufem.la.vector import norm
        sol_norm = float(norm(x))
    print(f"*** Number of Krylov iterations: {num_iter}")
    print(f"*** Solution norm:  {sol_norm}", flush=True)
    true_rel = getattr(prob.solver_function, "_last_true_rel", None)
    passes = getattr(prob.solver_function, "_last_refine_passes", 0)
    if true_rel is not None:
        extra = getattr(prob.solver_function, "_last_refine_iters", 0)
        print(f"*** True residual ||b-Ax||/||b|| (f64): {true_rel:.3e}"
              f" ({passes} refinement pass(es), +{extra} iterations)",
              flush=True)

    cfg.solver.warn_options_left()
    if mem is not None:
        mem.stop()
    return SolveReport(
        iterations=int(num_iter), norm=float(sol_norm),
        ndofs=int(prob.space.ndofs), solve_s=solve_s,
        rel=getattr(prob.solver_function, "_last_rel", None),
        true_rel=true_rel, refine_passes=int(passes),
        gdofs=getattr(prob.solver_function, "_last_gdofs", None))


def main(argv: Optional[List[str]] = None) -> int:
    cfg = parse_args(argv)
    solve(cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
