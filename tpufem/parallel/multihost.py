"""Multi-host (multi-process) execution scaffolding.

The reference is an MPI program: every rank initializes MPI, builds its
mesh partition, and PETSc spans ranks over the interconnect
(src/main.cpp:246,272; node-level subcommunicator at
src/mesh.cpp:164-180).  The JAX equivalent: a multi-host cluster is
driven by one PROCESS PER HOST, joined by ``jax.distributed.initialize``;
a ``jax.sharding.Mesh`` is then built over ``jax.devices()`` (the GLOBAL
device list), and the same SPMD programs (tpufem.parallel.slab /
rowshard) run unchanged — XLA routes the ``ppermute``/``psum``
collectives over the host's device links and over the network between
hosts.

Topology mapping (the "subcomm partitioning" analogue):
- the slab decomposition is a 1-D ring; orienting the shard axis so
  consecutive slabs sit on the same host keeps the halo ppermute inside
  a host except at host boundaries (one network hop per host pair per
  direction);
- the reference's node-leader subcommunicator trick (setup work done
  once per node) maps to the per-host builders below: under
  ``jax.make_array_from_callback`` each process materializes ONLY the
  shards it addresses — no host ever holds the global arrays.

This module is smoke-tested with multiple CPU processes
(tests/test_multihost.py spawns 2 processes x 4 virtual devices); one
process drives all the cards of a single host.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence, Tuple

import numpy as np


def init_from_env(coordinator_address: Optional[str] = None,
                  num_processes: Optional[int] = None,
                  process_id: Optional[int] = None) -> Tuple[int, int]:
    """Join (or start) the multi-process JAX runtime.

    The MPI_Init analogue (reference src/main.cpp:246).  With no
    arguments, ``jax.distributed.initialize`` reads the standard
    environment: JAX_COORDINATOR_ADDRESS plus — since jax's own cluster
    auto-detection only covers Slurm/OpenMPI/k8s — TPUFEM_NUM_PROCESSES
    and TPUFEM_PROCESS_ID for plain process launches (the ``mpirun -np
    N`` analogue used by tests/test_multihost.py).  Single-process runs
    return (0, 1) without touching the runtime.  Returns
    (process_index, process_count)."""
    import jax
    env_addr = (os.environ.get("JAX_COORDINATOR_ADDRESS")
                or os.environ.get("COORDINATOR_ADDRESS"))
    explicit = coordinator_address is not None or env_addr
    if explicit:
        if coordinator_address is None:
            coordinator_address = env_addr
        if num_processes is None and os.environ.get("TPUFEM_NUM_PROCESSES"):
            num_processes = int(os.environ["TPUFEM_NUM_PROCESSES"])
        if process_id is None and os.environ.get("TPUFEM_PROCESS_ID"):
            process_id = int(os.environ["TPUFEM_PROCESS_ID"])
        kw = dict(coordinator_address=coordinator_address)
        if num_processes is not None:
            kw.update(num_processes=num_processes, process_id=process_id)
        jax.distributed.initialize(**kw)
    return jax.process_index(), jax.process_count()


def shard_devices(nshards: int):
    """The 1-D shard axis over the GLOBAL device list, slab-ring
    oriented: jax.devices() orders devices process-major, so
    consecutive slabs share a host wherever possible and the halo ring
    crosses DCN only at host boundaries."""
    import jax
    devices = jax.devices()
    if len(devices) < nshards:
        raise ValueError(f"need {nshards} devices, have {len(devices)} "
                         f"across {jax.process_count()} processes")
    return devices[:nshards]


def local_shard_indices(nshards: int) -> np.ndarray:
    """Shard indices whose device is addressable from THIS process."""
    import jax
    devs = shard_devices(nshards)
    pid = jax.process_index()
    return np.asarray([s for s, d in enumerate(devs)
                       if d.process_index == pid], dtype=np.int64)


def make_sharded_rows(nshards: int, row_shape: Tuple[int, ...], dtype,
                      builder: Callable[[int], np.ndarray],
                      devices: Optional[Sequence] = None):
    """[S, *row_shape] global array, shard-partitioned on axis 0, where
    ``builder(s)`` produces shard s's row and is invoked ONLY for the
    shards this process addresses (per-host setup split — the
    subcommunicator-partitioning analogue, reference mesh.cpp:164-180).

    Returns a jax.Array laid out for ``shard_map(..., P("shard"))``."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    devs = list(devices) if devices is not None else shard_devices(nshards)
    mesh = Mesh(np.array(devs), ("shard",))
    sharding = NamedSharding(mesh, P("shard"))
    shape = (nshards,) + tuple(row_shape)

    def cb(index):
        s = index[0].start if index[0].start is not None else 0
        row = np.asarray(builder(int(s)), dtype=dtype)
        return row[None]

    return jax.make_array_from_callback(shape, sharding, cb,
                                        dtype=np.dtype(dtype))
