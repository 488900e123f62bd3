"""Operator-form measurements on the GPU: the P2/P3 strip form against
the DIA form, and the spoke mesh's windowed fine operator against ELL.

    python benchmarks/operator_forms.py

For each operator form it traces a jitted chain of applies with
``jax.profiler`` and reports the device time per apply (the union of
kernel intervals on the GPU's streams, divided by the chain length), the
compulsory bytes of one apply (x read, y written, weights read once),
XLA's own bytes-accessed estimate, and the share of 3.35 TB/s (H100
SXM HBM3, NVIDIA data sheet) those bytes reach.  End to end it reports
cgpoisson Gdof/s with ``-use_strip 1`` and ``0`` and the spoke solve's
time per iteration with ``-amg_fine_window on`` and ``off``, with peak
device memory.  Prints one line per measurement; needs a GPU.
"""

from __future__ import annotations

import glob
import os
import statistics
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PEAK_BYTES_PER_S = 3.35e12
CHAIN = 50
N = {"p23": 500_000, "spoke": 150_000}   # the smoke test's widths


def busy_ns(trace_dir: str) -> float:
    """Device busy time of a trace: the union of the intervals of all
    events on the GPU planes' stream lines."""
    from jax.profiler import ProfileData
    path = glob.glob(os.path.join(trace_dir, "plugins", "profile", "*",
                                  "*.xplane.pb"))[0]
    spans = []
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            spans += [(e.start_ns, e.start_ns + e.duration_ns)
                      for e in line.events]
    spans.sort()
    total, end = 0.0, -1.0
    for s, e in spans:
        if s >= end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def time_apply(name: str, apply, x, weights) -> None:
    """Trace CHAIN applies x <- c * A x in one jitted loop."""
    import jax
    import jax.numpy as jnp
    from tpufem.aot import compile_aot
    c = 1.0 / float(jnp.max(jnp.abs(apply(jnp.ones_like(x)))) + 1.0)

    def chain(x):
        return jax.lax.fori_loop(0, CHAIN, lambda _, v: apply(v) * c, x)

    exe = compile_aot(chain, x)
    jax.block_until_ready(exe(x))
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(exe(x))
        walls.append((time.perf_counter() - t0) / CHAIN)
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            jax.block_until_ready(exe(x))
        dev_s = busy_ns(d) * 1e-9 / CHAIN
    one = compile_aot(apply, x)
    xla_bytes = (one.cost_analysis() or {}).get("bytes accessed", 0.0)
    wbytes = sum(int(np.prod(a.shape)) * a.dtype.itemsize
                 for a in jax.tree.leaves(weights)
                 if hasattr(a, "dtype") and a.dtype != jnp.bool_)
    need = 2 * x.size * x.dtype.itemsize + wbytes
    print(f"{name}: device {dev_s * 1e6:.1f} us/apply (host clock "
          f"{statistics.median(walls) * 1e6:.1f} us), compulsory bytes "
          f"{need}, XLA bytes accessed {xla_bytes:.0f}, share of 3.35 TB/s "
          f"{need / dev_s / PEAK_BYTES_PER_S:.3f}", flush=True)


def strip_vs_dia() -> None:
    import jax.numpy as jnp
    from tpufem.config import Config, SolverOptions
    from tpufem.fem.dia_op import build_operator
    from tpufem.fem.dirichlet import DirichletBC
    from tpufem.fem.space import FunctionSpace
    from tpufem.fem.strip_op import StripOperator
    from tpufem.mesh import BoxTetMesh
    from tpufem.mesh.structured import compute_box_size_structured
    from tpufem.problems import cgpoisson, common
    import contextlib
    rng = np.random.default_rng(0)
    for order in (2, 3):
        dims = compute_box_size_structured(N["p23"], True, 1, order, 1)[:3]
        mesh = BoxTetMesh(*dims)
        space = FunctionSpace(mesh, order)
        bc = DirichletBC.from_space(
            space, mesh.locate_boundary_facets(common.poisson_bc_marker))
        dia = build_operator(mesh, order, "poisson", bc_dofs=bc.flat_dofs(),
                             dtype=jnp.float32, bake_bc=True)
        sop = StripOperator.from_dia(dia, dtype=jnp.float32)
        x = jnp.asarray(rng.standard_normal(space.ndofs), jnp.float32)
        time_apply(f"P{order} {space.ndofs} DIA apply", dia.apply, x, dia)
        time_apply(f"P{order} {space.ndofs} strip apply", sop.apply_strips,
                   sop.to_strips(x), sop.strips)
        for use_strip in (1, 0):
            cfg = Config(problem_type="cgpoisson", ndofs=N["p23"],
                         scaling_type="strong", dtype="float32",
                         solver=SolverOptions(extra={"use_strip": use_strip}))
            with contextlib.redirect_stdout(sys.stderr):
                prob = cgpoisson.problem(mesh, order, cfg)
                _, it = prob.solver_function(prob.u, prob.b)
            print(f"cgpoisson P{order} -use_strip {use_strip}: {it} its, "
                  f"{prob.solver_function._last_gdofs:.3f} Gdof/s", flush=True)


def window_vs_ell() -> None:
    import contextlib
    import jax
    import jax.numpy as jnp
    from tpufem.config import Config, SolverOptions
    from tpufem.fem.assemble import assemble_operator
    from tpufem.fem.window_op import WindowedMatrix, rcm_csr
    from tpufem.mesh.spoke import create_spoke_mesh
    from tpufem.problems import poisson
    mesh = create_spoke_mesh(N["spoke"], True, 1, 1, verbose=False)
    from tpufem.fem.dirichlet import DirichletBC
    from tpufem.fem.space import FunctionSpace
    from tpufem.problems import common
    space = FunctionSpace(mesh, 1)
    bc = DirichletBC.from_space(
        space, mesh.locate_boundary_facets(common.poisson_bc_marker))
    ell, csr = assemble_operator(space, bc, "poisson", dtype=np.float32)
    perm, csr_w = rcm_csr(*csr)
    win = WindowedMatrix.from_csr(*csr_w, dtype=np.float32, perm=perm)
    x = jnp.asarray(np.random.default_rng(1).standard_normal(space.ndofs),
                    jnp.float32)
    time_apply(f"spoke {space.ndofs} ELL SpMV", ell.matvec, x, ell)
    time_apply(f"spoke {space.ndofs} windowed SpMV (W="
               f"{win.vals.shape[2] // win.C}, {win.nbytes_vals >> 20} MiB)",
               win.matvec, x, win)
    del win
    for mode in ("off", "on"):
        cfg = Config(problem_type="poisson", mesh_type="unstructured",
                     ndofs=N["spoke"], scaling_type="strong", dtype="float32",
                     solver=SolverOptions(ksp_rtol=1e-8, ksp_max_it=120,
                                          amg_fine_window=mode))
        with contextlib.redirect_stdout(sys.stderr):
            prob = poisson.problem(mesh, 1, cfg)
            t0 = time.perf_counter()
            _, it = prob.solver_function(prob.u, prob.b)
            first = time.perf_counter() - t0
        fn = prob.solver_function
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn.solve_async(prob.u, prob.b)
            jax.block_until_ready(out)
            walls.append(time.perf_counter() - t0)
        its = int(out[1])
        peak = (jax.devices()[0].memory_stats() or {}).get(
            "peak_bytes_in_use")
        print(f"spoke {space.ndofs} -amg_fine_window {mode}: {its} its, warm solve "
              f"{statistics.median(walls):.4f} s = "
              f"{statistics.median(walls) / its * 1e3:.3f} ms/iteration, "
              f"first solve (setup + compile + certify) {first:.2f} s, "
              f"true_rel {fn._last_true_rel:.3e}, peak_bytes_in_use "
              f"{peak}", flush=True)


def main() -> int:
    import jax
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("operator_forms: needs a GPU")
    from tpufem.config import enable_compilation_cache
    enable_compilation_cache()
    import subprocess
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    window_vs_ell()
    strip_vs_dia()
    return 0


if __name__ == "__main__":
    sys.exit(main())
