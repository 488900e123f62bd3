"""Test configuration: run JAX on a virtual 8-device CPU mesh.

``--xla_force_host_platform_device_count`` gives the CPU backend 8
devices in one process, so the sharded paths run without a cluster (the
reference's analogue is `mpirun -np 2` on one machine,
.github/workflows/ccpp.yml:73).  The platform is pinned to the CPU
through both the environment and the config before any backend starts.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_PLATFORM_NAME"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# persistent XLA compile cache: CG/multigrid programs dominate suite
# time; cached reruns cut minutes to seconds.  JAX_COMPILATION_CACHE_DIR,
# when set, names the directory.
jax.config.update("jax_compilation_cache_dir",
                  os.environ.get("JAX_COMPILATION_CACHE_DIR")
                  or os.path.join(os.path.dirname(__file__), "..",
                                  ".jax_cache_cpu"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
