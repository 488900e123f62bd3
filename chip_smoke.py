"""Smoke test of tpufem on an NVIDIA GPU: the main solve paths end to end.

    python chip_smoke.py             # one card: phases a-i
    python chip_smoke.py --chips 4   # four cards: the sharded paths only

One process drives every card.  Each phase runs through the CLI's
``run()`` or the problem APIs a user would call, at the reference's
sizes (500k dofs per rank, 10M strong), and prints its wall time, its
backend compile time and its check.  Every operator the solves use is
also compared at full width with the float64 host reference
(``apply_np`` / scipy CSR).  Any failed check makes the exit code
non-zero; only a run whose every phase passed ends with the line

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

Without a GPU the script exits non-zero before any phase runs.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SEED = 0
CONTRACT = 1e-7          # true relative residual: 10 x ksp_rtol (1e-8)
RTOL = "1e-8"
# dofs: the reference's weak size per rank and strong-scaling total
# (README.md:63-146 of the reference), the P1 parity width, the spoke
# mesh of its CI matrix (ccpp.yml:102-117)
N = {"weak": 500_000, "strong": 10_000_000, "p1_parity": 2_100_000,
     "spoke": 150_000}


def parse_smi(text: str) -> list:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    output -> [(name, power limit)], one per card."""
    cards = []
    for line in text.strip().splitlines():
        name, _, limit = line.rpartition(",")
        if not name:
            raise ValueError(f"unexpected nvidia-smi line: {line!r}")
        cards.append((name.strip(), limit.strip()))
    if not cards:
        raise ValueError("nvidia-smi listed no card")
    return cards


def contract_line(platform: str, kind: str, count: int) -> str:
    """The last line of a passing run."""
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


class Phase:
    """One check: ``fn() -> (ok, message)``."""

    def __init__(self, key: str, title: str, fn):
        self.key, self.title, self.fn = key, title, fn


def phases_for(chips: int) -> list:
    if chips == 4:
        return [Phase("4a", "slab Poisson P1 GMG 2M (500k/card), 4 vs 1",
                      lambda: sharded_phase("poisson", 1, "cube")),
                Phase("4b", "slab elasticity P1 GMG 2M (500k/card), 4 vs 1",
                      lambda: sharded_phase("elasticity", 3, "cube")),
                Phase("4c", "row-sharded spoke Poisson 150k AMG, 4 vs 1",
                      lambda: sharded_phase("poisson", 1, "unstructured"))]
    # f32 phases first: float64 phases turn on jax_enable_x64 for the
    # rest of the process
    return [Phase("a", "Poisson P1 500k f32 CG+GMG", phase_a),
            Phase("d", "cgpoisson P2 510k / P3 517k f32", phase_d),
            Phase("e", "elasticity P1 500k f32 GMG and brick-AMG", phase_e),
            Phase("f", "elasticity P2 500k f32 GMG", phase_f),
            Phase("g", "Poisson P1 10M f32 CG+GMG", phase_g),
            Phase("h", "spoke Poisson 150k f32 CG+SA-AMG", phase_h),
            Phase("b", "Poisson P1 500k f64 CG+GMG", phase_b),
            Phase("c", "cgpoisson P1 500k f64 vs phase b", phase_c),
            Phase("i", "operator parity at full width, f32 and f64",
                  phase_i)]


# -- helpers ------------------------------------------------------------------

_COMPILE_S = [0.0]


def _on_duration(event: str, secs: float, **_kw) -> None:
    # the running phase's compiles; the parity programs compiling in the
    # background report their own times
    if (event == "/jax/core/compile/backend_compile_duration"
            and not threading.current_thread().name.startswith("parity")):
        _COMPILE_S[0] += secs


def cli_run(*argv: str):
    """One CLI run; its printed output goes to stderr."""
    from tpufem.cli import parse_args, run
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rep = run(parse_args(list(argv) + ["--num_shards", "1"]))
    sys.stderr.write(buf.getvalue())
    return rep


def _fmt(v) -> str:
    return "None" if v is None else f"{v:.3e}"


def _true_ok(rep) -> bool:
    return rep.true_rel is not None and rep.true_rel <= CONTRACT


def _cube(ndofs: int, bs: int, order: int, shards: int = 1,
          strong: bool = True):
    from tpufem.mesh import BoxTetMesh
    from tpufem.mesh.structured import compute_box_size_structured
    nx, ny, nz, _ = compute_box_size_structured(ndofs, strong, bs, order,
                                                shards)
    return BoxTetMesh(nx, ny, nz)


_SHARED = {}   # phase b's norm for phase c; the f32 parity programs


# -- one-card phases ----------------------------------------------------------

def phase_a():
    rep = cli_run("--problem_type", "poisson", "--ndofs", str(N["weak"]),
                  "--scaling_type", "strong", "-pc_type", "gmg",
                  "-ksp_rtol", RTOL)
    ok = 8 <= rep.iterations <= 15 and _true_ok(rep)
    return ok, (f"ndofs {rep.ndofs}, {rep.iterations} its (8-15), "
                f"true_rel {_fmt(rep.true_rel)} (<= 1e-7), "
                f"{rep.refine_passes} refinement pass(es), "
                f"solve {rep.solve_s:.3f} s")


def phase_b():
    rep = cli_run("--problem_type", "poisson", "--ndofs", str(N["weak"]),
                  "--scaling_type", "strong", "-pc_type", "gmg",
                  "-ksp_rtol", RTOL, "--dtype", "float64")
    _SHARED["b_norm"] = rep.norm
    ok = (rep.rel is not None and rep.rel <= 1e-8
          and rep.refine_passes == 0 and _true_ok(rep))
    return ok, (f"ndofs {rep.ndofs}, {rep.iterations} its, device rel "
                f"{_fmt(rep.rel)} (<= 1e-8), {rep.refine_passes} "
                f"refinement passes (0), true_rel {_fmt(rep.true_rel)} "
                f"(<= 1e-7), norm {rep.norm!r}")


def phase_c():
    # unpreconditioned CG needs ~10^3 iterations at 500k: run it to a
    # tight tolerance so its solution is comparable with phase b's
    rep = cli_run("--problem_type", "cgpoisson", "--ndofs", str(N["weak"]),
                  "--scaling_type", "strong", "--dtype", "float64",
                  "-cg_rtol", "1e-10", "-cg_kmax", "5000")
    b_norm = _SHARED.get("b_norm")
    if b_norm is None:
        return False, "phase b did not produce a norm"
    d = abs(rep.norm - b_norm) / abs(b_norm)
    return d <= 1e-6, (f"{rep.iterations} its, norm {rep.norm!r} vs phase b "
                       f"{b_norm!r}: rel diff {d:.3e} (<= 1e-6)")


def phase_d():
    import jax.numpy as jnp
    from tpufem.config import Config, SolverOptions
    from tpufem.fem.dia_op import build_operator
    from tpufem.problems import cgpoisson
    oks, msgs = [], []
    for order in (2, 3):
        mesh = _cube(N["weak"], 1, order)
        cfg = Config(problem_type="cgpoisson", ndofs=N["weak"],
                     scaling_type="strong", dtype="float32",
                     solver=SolverOptions())
        with contextlib.redirect_stdout(sys.stderr):
            prob = cgpoisson.problem(mesh, order, cfg)
            x, it = prob.solver_function(prob.u, prob.b)
        fn = prob.solver_function
        rel = fn._last_rel
        # the returned iterate against the float64 host operator: the
        # device's recurrence residual must describe the real residual
        A64 = build_operator(mesh, order, "poisson",
                             bc_dofs=prob.bc.flat_dofs(), dtype=jnp.float64,
                             device=False, bake_bc=True)
        b64 = np.asarray(prob.b, dtype=np.float64)
        r = b64 - A64.apply_np(np.asarray(x, dtype=np.float64))
        true_rel = float(np.linalg.norm(r) / np.linalg.norm(b64))
        ok = ((rel <= 1e-6 or it == 100) and rel < 1.0
              and abs(true_rel - rel) <= 0.1 * rel + 1e-5)
        oks.append(ok)
        msgs.append(f"P{order} ndofs {prob.space.ndofs}: {it} its (kmax "
                    f"100), rel {rel:.3e}, host f64 true_rel "
                    f"{true_rel:.3e}, {fn._last_gdofs:.3f} Gdof/s")
    return all(oks), "; ".join(msgs)


def phase_e():
    msgs, oks = [], []
    for pc in ("gmg", "amg"):
        rep = cli_run("--problem_type", "elasticity", "--ndofs", str(N["weak"]),
                      "--scaling_type", "strong", "-pc_type", pc,
                      "-ksp_rtol", RTOL, "-ksp_max_it", "200")
        oks.append(_true_ok(rep))
        msgs.append(f"{pc}: ndofs {rep.ndofs}, {rep.iterations} its, "
                    f"true_rel {_fmt(rep.true_rel)}, solve "
                    f"{rep.solve_s:.3f} s")
    return all(oks), "; ".join(msgs)


def phase_f():
    rep = cli_run("--problem_type", "elasticity", "--ndofs", str(N["weak"]),
                  "--scaling_type", "strong", "--order", "2",
                  "-pc_type", "gmg", "-ksp_rtol", RTOL, "-ksp_max_it", "200")
    return _true_ok(rep), (f"ndofs {rep.ndofs}, {rep.iterations} its, "
                           f"true_rel {_fmt(rep.true_rel)}, solve "
                           f"{rep.solve_s:.3f} s")


def phase_g():
    import jax
    rep = cli_run("--problem_type", "poisson", "--ndofs", str(N["strong"]),
                  "--scaling_type", "strong", "-pc_type", "gmg",
                  "-ksp_rtol", RTOL)
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    return _true_ok(rep), (f"ndofs {rep.ndofs}, {rep.iterations} its, "
                           f"true_rel {_fmt(rep.true_rel)}, solve "
                           f"{rep.solve_s:.3f} s, peak_bytes_in_use {peak}")


def phase_h():
    rep = cli_run("--problem_type", "poisson", "--mesh_type", "unstructured",
                  "--ndofs", str(N["spoke"]), "--scaling_type", "strong",
                  "-ksp_rtol", RTOL, "-ksp_max_it", "120")
    return _true_ok(rep), (f"ndofs {rep.ndofs}, {rep.iterations} its, "
                           f"device rel {_fmt(rep.rel)}, true_rel "
                           f"{_fmt(rep.true_rel)} after {rep.refine_passes} "
                           f"refinement pass(es), solve {rep.solve_s:.3f} s")


def parity_cases(dtype: str, sizes: dict):
    """[(name, device apply, host float64 reference, n, tolerance)] for
    the solve paths' operators at the given sizes."""
    import jax.numpy as jnp
    from tpufem.fem.assemble import assemble_operator
    from tpufem.fem.dia_op import build_operator
    from tpufem.fem.dirichlet import DirichletBC
    from tpufem.fem.space import FunctionSpace
    from tpufem.fem.strip_op import StripOperator
    from tpufem.mesh.spoke import create_spoke_mesh
    from tpufem.problems import common
    jdt = jnp.dtype(dtype)
    f32 = jdt == jnp.float32
    cases = []

    def cube_bc(mesh, order, bs, marker):
        space = FunctionSpace(mesh, order, bs=bs)
        return DirichletBC.from_space(space,
                                      mesh.locate_boundary_facets(marker))

    mesh = _cube(sizes["p1"], 1, 1)
    bc = cube_bc(mesh, 1, 1, common.poisson_bc_marker)
    op = build_operator(mesh, 1, "poisson", bc_dofs=bc.flat_dofs(),
                        dtype=jdt)
    ref = build_operator(mesh, 1, "poisson", bc_dofs=bc.flat_dofs(),
                         dtype=jnp.float64, device=False)
    cases.append(("P1 DiaOperator.apply", op.apply, ref.apply_np,
                  op.layout.ndofs, 2e-6 if f32 else 1e-12))

    for order in (2, 3):
        mesh = _cube(sizes[f"p{order}"], 1, order)
        bc = cube_bc(mesh, order, 1, common.poisson_bc_marker)
        ref = build_operator(mesh, order, "poisson", bc_dofs=bc.flat_dofs(),
                             dtype=jnp.float64, device=False)
        dia = build_operator(mesh, order, "poisson", bc_dofs=bc.flat_dofs(),
                             dtype=jdt)
        sop = StripOperator.from_dia(dia, dtype=jdt)
        cases.append((f"StripOperator.apply_strips P{order}",
                      lambda u, sop=sop: sop.from_strips(
                          sop.apply_strips(sop.to_strips(u)), dtype=u.dtype),
                      ref.apply_np, ref.layout.ndofs,
                      1e-5 if f32 else 1e-12))

    mesh = _cube(sizes["el2"], 3, 2)
    bc = cube_bc(mesh, 2, 3, common.elasticity_bc_marker)
    op = build_operator(mesh, 2, "elasticity", bc_dofs=bc.flat_dofs(),
                        dtype=jdt)
    ref = build_operator(mesh, 2, "elasticity", bc_dofs=bc.flat_dofs(),
                         dtype=jnp.float64, device=False)
    cases.append(("elasticity P2 per-permutation apply", op.apply,
                  ref.apply_np, 3 * FunctionSpace(mesh, 2).ndofs,
                  1e-5 if f32 else 1e-12))

    spoke = create_spoke_mesh(sizes["spoke"], True, 1, 1, verbose=False)
    space = FunctionSpace(spoke, 1)
    bc = DirichletBC.from_space(
        space, spoke.locate_boundary_facets(common.poisson_bc_marker))
    ell, csr = assemble_operator(space, bc, "poisson", dtype=np.dtype(dtype))
    import scipy.sparse as sp
    n = space.ndofs
    M64 = sp.csr_matrix((np.asarray(csr[2], dtype=np.float64), csr[1],
                         csr[0]), shape=(n, n))
    cases.append(("ELLMatrix SpMV (spoke)", ell.matvec, lambda v: M64 @ v,
                  n, 1e-5 if f32 else 1e-12))
    return cases


class Parity:
    """The parity programs of one dtype, compiled on worker threads as
    soon as they are built (XLA compiles them in parallel while the main
    thread runs other phases); ``check()`` runs them."""

    def __init__(self, dtype: str):
        import jax.numpy as jnp
        from tpufem.aot import lower
        sizes = {"p1": N["p1_parity"], "p2": N["weak"], "p3": N["weak"],
                 "el2": N["weak"], "spoke": N["spoke"]}
        self.cases = parity_cases(dtype, sizes)
        rng = np.random.default_rng(SEED)
        self.xs = [jnp.asarray(rng.standard_normal(c[3]), jnp.dtype(dtype))
                   for c in self.cases]
        lowered = [lower(c[1], x) for c, x in zip(self.cases, self.xs)]
        self._pool = ThreadPoolExecutor(len(lowered),
                                        thread_name_prefix="parity")
        self._compiled = [self._pool.submit(_timed_compile, low)
                          for low in lowered]

    def check(self) -> list:
        """[(name, n, rel-L2, max rel, tolerance, compile s, ok)]."""
        import jax
        out = []
        try:
            for (name, _, ref, n, tol), x, fut in zip(
                    self.cases, self.xs, self._compiled):
                exe, secs = fut.result()
                y = np.asarray(jax.block_until_ready(exe(x)),
                               dtype=np.float64)
                y_ref = ref(np.asarray(x, dtype=np.float64))
                err = float(np.linalg.norm(y - y_ref)
                            / np.linalg.norm(y_ref))
                emax = float(np.abs(y - y_ref).max() / np.abs(y_ref).max())
                out.append((name, n, err, emax, tol, secs, bool(err <= tol)))
        finally:
            self._pool.shutdown()
        return out


def _timed_compile(lowered):
    t0 = time.perf_counter()
    exe = lowered.compile()
    return exe, time.perf_counter() - t0


def phase_i():
    """Both dtypes; the f32 programs started compiling before phase a."""
    import jax
    jax.config.update("jax_enable_x64", True)
    p64 = Parity("float64")
    rows = [("f32",) + r for r in _SHARED.pop("parity32").check()]
    rows += [("f64",) + r for r in p64.check()]
    msgs = [f"{name} {dt} n={n}: rel-L2 {err:.3e}, max rel {emax:.3e} "
            f"(<= {tol:.0e}), compiled in {secs:.1f} s "
            f"{'ok' if ok else 'FAIL'}"
            for dt, name, n, err, emax, tol, secs, ok in rows]
    return all(r[-1] for r in rows), "; ".join(msgs)


# -- four-card phase ----------------------------------------------------------

def _host_system(mesh, order: int, ptype: str, space, bc):
    """float64 host twin (apply, b) of the system the sharded paths solve."""
    import jax.numpy as jnp
    if ptype == "elasticity":
        from tpufem.problems.elasticity import assemble_elasticity_rhs_np
        b = assemble_elasticity_rhs_np(space)
    else:
        from tpufem.problems.poisson import assemble_poisson_rhs_np
        b = assemble_poisson_rhs_np(space)
    b[bc.flat_dofs()] = bc.value
    from tpufem.mesh import BoxTetMesh
    if isinstance(mesh, BoxTetMesh):
        from tpufem.fem.dia_op import build_operator
        A = build_operator(mesh, order, ptype, bc_dofs=bc.flat_dofs(),
                           dtype=jnp.float64, device=False)
        return A.apply_np, b
    import scipy.sparse as sp
    from tpufem.fem.assemble import assemble_operator
    _, csr = assemble_operator(space, bc, ptype, dtype=np.float64)
    n = space.ndofs
    M = sp.csr_matrix((csr[2], csr[1], csr[0]), shape=(n, n))
    if bc.flat_dofs().size == 0:   # pure Neumann: the deflated system
        b = b - b.mean()
    return (lambda v: M @ v), b


def sharded_phase(ptype: str, bs: int, mesh_type: str):
    """The same float64 problem on 4 cards and on devices[:1]: iterations
    within 1, norms within 1e-6, both certified in f64 on the host."""
    import jax
    jax.config.update("jax_enable_x64", True)
    from tpufem.config import Config, SolverOptions
    from tpufem.problems import sharded
    if mesh_type == "cube":
        mesh = _cube(N["weak"], bs, 1, shards=4, strong=False)
    else:
        from tpufem.mesh.spoke import create_spoke_mesh
        mesh = create_spoke_mesh(N["spoke"], True, 1, 4, verbose=False)
    build = (sharded.problem if mesh_type == "cube"
             else sharded.problem_rowshard)

    def solve(S):
        cfg = Config(problem_type=ptype, mesh_type=mesh_type, ndofs=0,
                     dtype="float64", num_shards=S,
                     solver=SolverOptions(ksp_rtol=float(RTOL),
                                          ksp_max_it=500))
        prob = build(mesh, 1, cfg, ptype, S)
        x, it = prob.solver_function(prob.u, prob.b)
        return prob, np.asarray(x, dtype=np.float64), int(it)

    # the one-card run has no collectives, so it can compile and run
    # beside the four-card one
    with contextlib.redirect_stdout(sys.stderr), ThreadPoolExecutor(2) as ex:
        runs = {S: ex.submit(solve, S) for S in (4, 1)}
        runs = {S: f.result() for S, f in runs.items()}
    prob = runs[4][0]
    apply64, b64 = _host_system(mesh, 1, ptype, prob.space, prob.bc)
    got = {}
    for S, (_, x, it) in runs.items():
        true_rel = float(np.linalg.norm(b64 - apply64(x))
                         / np.linalg.norm(b64))
        got[S] = (it, float(np.linalg.norm(x)), true_rel, prob.space.ndofs)
    (i4, n4, t4, nd), (i1, n1, t1, _) = got[4], got[1]
    d = abs(n4 - n1) / abs(n1)
    ok = abs(i4 - i1) <= 1 and d <= 1e-6 and max(t4, t1) <= CONTRACT
    return ok, (f"ndofs {nd}: its {i4} (4 cards) vs {i1} (1), norm rel "
                f"diff {d:.3e} (<= 1e-6), true_rel {t4:.3e} / {t1:.3e} "
                f"(<= 1e-7)")


# -- driver -------------------------------------------------------------------

def gate(chips: int):
    """Refuse to run without `chips` GPUs; returns the devices."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX platform "
                         f"{devs[0].platform!r}); nothing was run")
    if len(devs) < chips:
        raise SystemExit(f"chip_smoke: --chips {chips} needs {chips} GPUs, "
                         f"JAX sees {len(devs)}")
    return devs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)

    devs = gate(args.chips)
    import jax
    import jaxlib
    from tpufem import native
    from tpufem.config import enable_compilation_cache
    cache = enable_compilation_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    parse_smi(smi)
    print(f"device_kind: {devs[0].device_kind} x {len(devs)}")
    for line in smi.strip().splitlines():
        print(f"nvidia-smi: {line}")
    print(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}, native "
          f"setup module: {native.have_native()}, compile cache: {cache}",
          flush=True)

    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    if args.chips == 1:
        _SHARED["parity32"] = Parity("float32")
    failed = []
    for ph in phases_for(args.chips):
        c0, t0 = _COMPILE_S[0], time.perf_counter()
        try:
            ok, msg = ph.fn()
        except Exception:
            traceback.print_exc()
            ok, msg = False, "raised (traceback on stderr)"
        wall = time.perf_counter() - t0
        print(f"[phase {ph.key}] {ph.title}: wall {wall:.1f} s, compile "
              f"{_COMPILE_S[0] - c0:.1f} s, {'PASS' if ok else 'FAIL'}: "
              f"{msg}", flush=True)
        if not ok:
            failed.append(ph.key)
    if failed:
        print(f"chip_smoke: FAILED phases {failed}", flush=True)
        return 1
    print(contract_line(devs[0].platform, devs[0].device_kind, len(devs)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
