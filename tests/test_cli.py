"""End-to-end CLI smoke tests mirroring the reference CI matrix
(.github/workflows/ccpp.yml): each job runs the full driver and checks
convergence + solution-norm sanity (the reference's implicit correctness
signals, src/main.cpp:232-233).  Sizes scaled down for the 1-vCPU host."""

import numpy as np
import pytest

from tpufem.cli import parse_args, solve


def run_cli(argv):
    cfg = parse_args(argv)
    return solve(cfg)


def test_poisson_weak_serial():
    """CI job 1 analogue (ccpp.yml:56-70), smaller dof count."""
    it, norm = run_cli(["--problem_type", "poisson", "--ndofs", "15000",
                        "--scaling_type", "weak", "--num_shards", "1",
                        "--dtype", "float64", "-ksp_rtol", "1e-8"])
    assert 0 < it < 60
    assert np.isfinite(norm) and norm > 1.0


def test_poisson_order3():
    """CI job 3 analogue (ccpp.yml:86-101): --order 3."""
    it, norm = run_cli(["--problem_type", "poisson", "--ndofs", "15000",
                        "--order", "3", "--num_shards", "1",
                        "--dtype", "float64", "-ksp_rtol", "1e-8"])
    assert 0 < it < 80
    assert np.isfinite(norm) and norm > 0.1


def test_poisson_unstructured():
    """CI job 4 analogue (ccpp.yml:102-117): spoke mesh + SA-AMG.

    Note: like the reference, the Poisson BC predicate (x in {0,1}
    planes) marks NO facets on the spoke geometry, so the system is
    singular Neumann; the reference CI checks only that the run
    completes (no -ksp_converged_reason).  Same contract here."""
    it, norm = run_cli(["--problem_type", "poisson", "--mesh_type",
                        "unstructured", "--ndofs", "4000",
                        "--num_shards", "1", "--dtype", "float64",
                        "-ksp_rtol", "1e-8", "-ksp_max_it", "50"])
    assert 0 < it <= 50
    assert np.isfinite(norm)


def test_elasticity_weak():
    """CI job analogue (ccpp.yml:133-156)."""
    it, norm = run_cli(["--problem_type", "elasticity", "--ndofs", "9000",
                        "--scaling_type", "strong", "--num_shards", "1",
                        "--dtype", "float64", "-ksp_rtol", "1e-8"])
    assert 0 < it < 100
    assert np.isfinite(norm) and norm > 1e-6


def test_elasticity_order3():
    """Elasticity order-3 CI analogue (ccpp.yml:162-176), reduced size."""
    it, norm = run_cli(["--problem_type", "elasticity", "--ndofs", "3000",
                        "--order", "3", "--scaling_type", "strong",
                        "--num_shards", "1", "--dtype", "float64"])
    assert 0 < it < 100
    assert np.isfinite(norm) and norm > 0


def test_elasticity_strong():
    """Elasticity strong-scaling CI analogue (ccpp.yml:177-197)."""
    it, norm = run_cli(["--problem_type", "elasticity", "--ndofs", "9000",
                        "--scaling_type", "strong", "--num_shards", "1",
                        "--dtype", "float64"])
    assert 0 < it < 80
    assert np.isfinite(norm) and norm > 0


def test_cgpoisson_runs():
    """cgpoisson (not in the reference CI; kmax=100 rtol=1e-6 defaults,
    cgpoisson_problem.cpp:233)."""
    it, norm = run_cli(["--problem_type", "cgpoisson", "--ndofs", "15000",
                        "--num_shards", "1", "--dtype", "float64"])
    assert 0 < it <= 100


def test_output_xdmf(tmp_path):
    out = str(tmp_path / "res")
    it, norm = run_cli(["--problem_type", "poisson", "--ndofs", "4000",
                        "--num_shards", "1", "--dtype", "float64",
                        "--output", out])
    import os
    assert os.path.exists(os.path.join(out, "solution-1.xdmf"))
    assert os.path.exists(os.path.join(out, "solution-1.h5"))
    import h5py
    with h5py.File(os.path.join(out, "solution-1.h5")) as f:
        assert f["/function/values"].shape[0] > 0
        assert f["/mesh/topology"].shape[1] == 4


def test_memory_profiling(capfd):
    """--memory_profiling: the [MEM] sampler thread logs VSIZE/RSS
    (reference: src/mem.cpp:18-38 via --memory_profiling)."""
    import logging
    records = []

    class Grab(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    lg = logging.getLogger("tpufem")
    lg.addHandler(Grab())
    lg.setLevel(logging.INFO)
    run_cli(["--problem_type", "poisson", "--ndofs", "3000",
             "--num_shards", "1", "--dtype", "float64",
             "--memory_profiling"])
    assert any("[MEM]" in m and "RSS" in m for m in records)


def test_poisson_sharded_matches_serial():
    """The -np 2 CI analogue (ccpp.yml:73): the sharded cube run must
    reproduce the serial iteration count and norm for the same mesh
    (strong scaling pins the global size)."""
    # 35937 = 33^3 vertices: the shard-divisibility constraint and the
    # unconstrained sizing both pick the 32x32x32 lattice, so the runs
    # solve the identical system
    args = ["--problem_type", "poisson", "--ndofs", "35937",
            "--scaling_type", "strong", "--dtype", "float64",
            "-ksp_rtol", "1e-8"]
    it8, norm8 = run_cli(args + ["--num_shards", "8"])
    it1, norm1 = run_cli(args + ["--num_shards", "1"])
    assert it8 == it1
    assert abs(norm8 - norm1) < 1e-8 * abs(norm1)


def test_elasticity_sharded():
    it, norm = run_cli(["--problem_type", "elasticity", "--ndofs", "4000",
                        "--num_shards", "8", "--dtype", "float64"])
    assert 0 < it < 80
    assert np.isfinite(norm) and norm > 0


def test_cgpoisson_sharded_matches_serial_norm():
    args = ["--problem_type", "cgpoisson", "--ndofs", "35937",
            "--scaling_type", "strong", "--dtype", "float64"]
    it8, norm8 = run_cli(args + ["--num_shards", "8"])
    it1, norm1 = run_cli(args + ["--num_shards", "1"])
    assert abs(it8 - it1) <= 1
    assert abs(norm8 - norm1) < 1e-5 * abs(norm1)


def test_sharded_order2_rowshard():
    """Higher orders execute the row-sharded assembled path (distributed
    SA-AMG); same CI bounds as the serial run."""
    it, norm = run_cli(["--problem_type", "poisson", "--ndofs", "15000",
                        "--order", "2", "--num_shards", "8",
                        "--dtype", "float64"])
    assert 0 < it < 80 and np.isfinite(norm)


def test_sharded_unstructured_rowshard():
    """The 2-rank spoke-mesh CI analogue (ccpp.yml:102-117): completes
    across shards (the spoke Neumann system is singular by design — the
    reference job, too, is a smoke test)."""
    it, norm = run_cli(["--problem_type", "poisson",
                        "--mesh_type", "unstructured", "--ndofs", "4000",
                        "--num_shards", "2", "--dtype", "float64",
                        "-ksp_max_it", "40"])
    assert 0 < it <= 40 and np.isfinite(norm)


def test_weak_scaling_iterations_flat():
    """Weak scaling (the reference's primary mode, mesh.cpp:86-90):
    growing the mesh with the shard count must keep CG+GMG iteration
    counts essentially constant (mesh-independent multigrid +
    shard-count-independent arithmetic)."""
    args = ["--problem_type", "poisson", "--ndofs", "15000",
            "--scaling_type", "weak", "--dtype", "float64",
            "-ksp_rtol", "1e-8"]
    it1, _ = run_cli(args + ["--num_shards", "1"])
    it8, _ = run_cli(args + ["--num_shards", "8"])
    assert abs(it8 - it1) <= 2


def test_negative_option_value():
    """'-key -1e-6' parses the negative number as the value."""
    cfg = parse_args(["--problem_type", "poisson", "-cg_damping", "-0.5"])
    assert cfg.solver.extra["cg_damping"] == -0.5


@pytest.mark.parametrize("order,option,value", [(1, "use_pallas", "1"),
                                                (2, "cg_kernel", "on")])
def test_removed_kernel_options_are_unused(order, option, value, caplog):
    """The removed kernel switches are no longer options: the
    -options_left audit reports them."""
    import logging
    with caplog.at_level(logging.WARNING, logger="tpufem"):
        it, norm = run_cli(["--problem_type", "cgpoisson", "--ndofs", "3000",
                            "--order", str(order), "--num_shards", "1",
                            f"-{option}", value])
    assert 0 < it <= 100 and np.isfinite(norm)
    assert any(f"unused solver option '{option}'" in r.getMessage()
               for r in caplog.records)
