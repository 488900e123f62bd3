"""Multi-host scaffolding: per-host (callback-materialized) slab build
must equal the single-host global build, and the builders must only run
for shards the process addresses.

Reference behavior: every MPI rank builds only its partition
(src/main.cpp:246, node-level subcommunicator src/mesh.cpp:164-180)."""

import json
import os
import socket
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tpufem.mesh import BoxTetMesh
from tpufem.parallel.slab import ShardedCubeSolver
from tpufem.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("problem,order,precond", [
    ("poisson", 1, True), ("elasticity", 1, True),
    ("poisson", 3, True),        # reference order-3 CI job, ccpp.yml:86-101
    ("poisson", 2, False),       # cgpoisson convention (matrix-free CG)
])
def test_per_host_build_matches_global(problem, order, precond):
    mesh = BoxTetMesh(8, 8, 16)
    kw = dict(problem=problem, order=order, dtype=jnp.float64, rtol=1e-8,
              maxit=60, precond=precond, gather_limit=500)
    a = ShardedCubeSolver.build(mesh, 4, **kw)
    b = ShardedCubeSolver.build_per_host(mesh, 4, **kw)
    scale = np.abs(np.asarray(a.b_local)).max()
    assert np.abs(np.asarray(b.b_local)
                  - np.asarray(a.b_local)).max() < 1e-12 * scale
    for la, lb in zip(a.levels, b.levels):
        assert np.allclose(np.asarray(lb.dinv), np.asarray(la.dinv),
                           rtol=1e-12)
        assert np.array_equal(np.asarray(lb.bc), np.asarray(la.bc))
        assert lb.iface == la.iface
    assert np.array_equal(np.asarray(b.owned), np.asarray(a.owned))
    xa, ita, _ = a.solve()
    xb, itb, relb = b.solve()
    assert ita == itb
    if precond:
        assert relb < 1e-8
    assert np.abs(xa - xb).max() < 1e-10 * max(np.abs(xa).max(), 1e-30)


def test_builders_run_for_addressable_shards_only():
    """make_sharded_rows must invoke the builder exactly once per
    addressable shard (single process: all of them, each once)."""
    calls = []

    def builder(s):
        calls.append(s)
        return np.full(3, float(s))

    arr = multihost.make_sharded_rows(4, (3,), np.float64, builder)
    assert sorted(calls) == [0, 1, 2, 3]
    assert np.allclose(np.asarray(arr)[:, 0], [0.0, 1.0, 2.0, 3.0])


_WORKER = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import jax
    pid = int(sys.argv[1]); port = sys.argv[2]; out = sys.argv[3]
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=2, process_id=pid)
    import jax.numpy as jnp
    sys.path.insert(0, os.getcwd())
    from tpufem.mesh import BoxTetMesh
    from tpufem.parallel import multihost
    from tpufem.parallel.slab import ShardedCubeSolver
    calls = []
    orig = multihost.make_sharded_rows
    def counting(S, shape, dtype, builder, devices=None):
        def wrapped(s):
            calls.append(s)
            return builder(s)
        return orig(S, shape, dtype, wrapped, devices)
    multihost.make_sharded_rows = counting
    sol = ShardedCubeSolver.build_per_host(
        BoxTetMesh(8, 8, 16), 4, problem="poisson", dtype=jnp.float64,
        rtol=1e-8, maxit=60, gather_limit=500)
    local = sorted(set(int(s) for s in
                       multihost.local_shard_indices(4)))
    built = sorted(set(calls))
    x_loc, it, rel = sol._run(sol.b_local)
    jax.block_until_ready(x_loc)
    json.dump({"pid": pid, "local": local, "built": built,
               "it": int(it), "rel": float(rel)}, open(out, "w"))
""")


def test_two_process_smoke():
    """2 processes x 4 virtual CPU devices: distributed init, per-host
    build (each process builds ONLY its 2 shards), converged solve."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ,
               JAX_PLATFORMS="cpu", JAX_PLATFORM_NAME="cpu",
               JAX_ENABLE_X64="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_COMPILATION_CACHE_DIR="")
    with tempfile.TemporaryDirectory() as td:
        script = os.path.join(td, "worker.py")
        open(script, "w").write(_WORKER)
        outs = [os.path.join(td, f"out{i}.json") for i in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, script, str(i), str(port), outs[i]],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE) for i in range(2)]
        rcs = [p.wait(timeout=600) for p in procs]
        if any(rc != 0 for rc in rcs):
            err = b"\n".join(p.stderr.read()[-2000:] for p in procs)
            if (b"distributed" in err or b"Gloo" in err
                    or b"UNIMPLEMENTED" in err or b"coordinator" in err):
                pytest.skip(f"multi-process CPU runtime unavailable: "
                            f"{err[-300:]!r}")
            raise AssertionError(err.decode(errors="replace"))
        res = [json.load(open(o)) for o in outs]
    for r in res:
        # each process built exactly its addressable shards
        assert r["built"] == r["local"], r
        assert len(r["local"]) == 2
        assert r["it"] < 60 and r["rel"] < 1e-8
    assert sorted(res[0]["local"] + res[1]["local"]) == [0, 1, 2, 3]


def _parse_cli(out: str):
    it = norm = None
    for ln in out.splitlines():
        if ln.startswith("*** Number of Krylov iterations:"):
            it = int(ln.split(":")[1])
        if ln.startswith("*** Solution norm:"):
            norm = float(ln.split(":")[1])
    assert it is not None and norm is not None, out[-2000:]
    return it, norm


def _cli_parity(args, nproc: int = 8):
    """Run the CLI once on a 1-process nproc-device mesh (golden) and
    once as nproc processes x 1 device over the distributed runtime;
    assert iteration-count + solution-norm parity
    (reference main.cpp:229-233)."""
    base_env = dict(os.environ, JAX_PLATFORMS="cpu",
                    JAX_PLATFORM_NAME="cpu", JAX_ENABLE_X64="1",
                    JAX_COMPILATION_CACHE_DIR="")
    for var in ("JAX_COORDINATOR_ADDRESS", "TPUFEM_NUM_PROCESSES",
                "TPUFEM_PROCESS_ID"):
        base_env.pop(var, None)

    # golden: one process driving an nproc-device mesh
    env1 = dict(base_env,
                XLA_FLAGS=f"--xla_force_host_platform_device_count={nproc}")
    r = subprocess.run([sys.executable, "-m", "tpufem"] + args,
                       env=env1, cwd=REPO, capture_output=True,
                       text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    it1, norm1 = _parse_cli(r.stdout)

    # nproc processes x 1 device each over the Gloo/distributed runtime
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for pid in range(nproc):
        env = dict(base_env,
                   XLA_FLAGS="--xla_force_host_platform_device_count=1",
                   JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   TPUFEM_NUM_PROCESSES=str(nproc),
                   TPUFEM_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tpufem"] + args, env=env,
            cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=900) for p in procs]
    rcs = [p.returncode for p in procs]
    if any(rc != 0 for rc in rcs):
        err = "\n".join(o[1][-1500:] for o in outs)
        if ("distributed" in err or "Gloo" in err
                or "UNIMPLEMENTED" in err or "coordinator" in err):
            pytest.skip(f"multi-process CPU runtime unavailable: "
                        f"{err[-300:]!r}")
        raise AssertionError(err)
    # every process prints the same iteration count + distributed norm
    for stdout, _ in outs:
        itn, normn = _parse_cli(stdout)
        assert itn == it1
        assert abs(normn - norm1) < 1e-8 * abs(norm1)


def test_eight_process_cli_parity():
    """The full CLI under 8 processes x 1 virtual device each — the
    ``mpirun -np 8`` analogue (reference ccpp.yml:73 scaled up) — must
    reproduce the 1-process 8-shard run's iteration count and solution
    norm (golden parity: reference main.cpp:229-233)."""
    _cli_parity(["--problem_type", "poisson", "--ndofs", "2000",
                 "--scaling_type", "weak", "--num_shards", "8",
                 "--dtype", "float64", "-ksp_rtol", "1e-8"])


def test_eight_process_cli_parity_order3():
    """Order-3 multi-process parity (the reference's --order 3 job on
    multiple ranks, ccpp.yml:86-101): exercises the per-host sharded
    p-coarsening level."""
    _cli_parity(["--problem_type", "poisson", "--ndofs", "2000",
                 "--scaling_type", "weak", "--num_shards", "8",
                 "--order", "3", "--dtype", "float64",
                 "-ksp_rtol", "1e-8"])


def test_eight_process_cli_parity_cgpoisson():
    """Matrix-free cgpoisson multi-process parity: per-host build with
    precond=False, Gdof/s metric printed by every process
    (cgpoisson_problem.cpp:236-242)."""
    _cli_parity(["--problem_type", "cgpoisson", "--ndofs", "2000",
                 "--scaling_type", "weak", "--num_shards", "8",
                 "--dtype", "float64"])


def test_eight_process_cli_parity_unstructured():
    """Unstructured (spoke) multi-process parity via the row-sharded
    path (reference's unstructured 2-rank CI job, ccpp.yml:102-117).
    The spoke problem is pure-Neumann; the constant nullspace is
    deflated (documented deviation), so both runs converge to the
    unique mean-zero solution."""
    _cli_parity(["--problem_type", "poisson", "--mesh_type",
                 "unstructured", "--ndofs", "1500",
                 "--scaling_type", "weak", "--num_shards", "8",
                 "--dtype", "float64", "-ksp_rtol", "1e-8"])
