"""Weak-scaling driver — the reference's primary measurement
(README.md:63-128 of the reference: N dofs per rank, rank count swept).

Runs the CLI solve at a fixed per-shard dof count over a sweep of shard
counts and prints the scaling table: iterations (must stay flat —
mesh-independent multigrid), solve seconds, and per-shard throughput.

On a multi-GPU host this measures scaling over the device links; on a
single-host dev box use the virtual CPU mesh:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python benchmarks/weak_scaling.py --ndofs 15000 --shards 1 2 4 8

(virtual devices share one CPU, so wall times do NOT scale — the table
then demonstrates iteration flatness and SPMD correctness, which is what
CI asserts; see tests/test_cli.py::test_weak_scaling_iterations_flat).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from tpufem.cli import parse_args as cli_parse, solve
from tpufem.timing import REGISTRY


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem_type", default="poisson")
    ap.add_argument("--ndofs", type=int, default=15000,
                    help="dofs per shard (weak scaling)")
    ap.add_argument("--order", type=int, default=1)
    ap.add_argument("--dtype", default="float64")
    ap.add_argument("--shards", type=int, nargs="+", default=[1, 2, 4, 8])
    args = ap.parse_args()

    rows = []
    for s in args.shards:
        REGISTRY.reset()
        t0 = time.perf_counter()
        it, norm = solve(cli_parse(
            ["--problem_type", args.problem_type,
             "--ndofs", str(args.ndofs), "--scaling_type", "weak",
             "--order", str(args.order), "--num_shards", str(s),
             "--dtype", args.dtype]))
        wall = time.perf_counter() - t0
        solve_s = dict((n, t) for n, _r, t in REGISTRY.rows()).get(
            "ZZZ Solve", float("nan"))
        rows.append((s, it, norm, solve_s, wall))

    print()
    print(f"{'shards':>7} {'iters':>6} {'norm':>22} {'solve_s':>9} "
          f"{'wall_s':>8}")
    for s, it, norm, solve_s, wall in rows:
        print(f"{s:>7} {it:>6} {norm:>22.12e} {solve_s:>9.3f} {wall:>8.1f}")
    its = [r[1] for r in rows]
    print(f"\niteration spread over {len(rows)} shard counts: "
          f"{min(its)}..{max(its)} (flat = mesh-independent multigrid)")


if __name__ == "__main__":
    main()
