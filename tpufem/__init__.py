"""tpufem — a finite element scaling framework in JAX.

A from-scratch rebuild of the capabilities of the FEniCS ``performance-test``
mini-app (DOLFINx scaling test) as an idiomatic JAX/XLA stack:

- structured tetrahedral box meshes as closed-form index arithmetic
  (no graph partitioner needed on the structured path),
- P1..P3 Lagrange elements (GLL-warped variant) tabulated at setup,
- element kernels as batched geometric-factor x reference-tensor
  contractions (large batched matrix products),
- assembly via gather/segment-sum (no atomics),
- from-scratch CG and smoothed-aggregation AMG solvers (replacing
  PETSc KSP/GAMG and Hypre BoomerAMG),
- SPMD over ``jax.sharding.Mesh`` with halo exchange through
  ``shard_map`` + ``ppermute`` (replacing MPI ghost scatters).

Reference behavior is specified by FEniCS/performance-test;
citations in docstrings point at the call sites that pin down semantics.
"""

__version__ = "0.4.0"

# NOTE: allocator tuning (tpufem.hostmem.tune_allocator) is applied by
# the entry points that need it (CLI, bench) — not at import, so merely
# importing the library never mutates process-global malloc state.

from tpufem.config import Config, SolverOptions  # noqa: F401
