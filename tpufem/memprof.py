"""Memory profiler: background RSS/VSIZE sampler.

Equivalent of the reference's rank-0 daemon thread reading
``/proc/self/stat`` every 100 ms and logging ``VSIZE=..., RSS=...``
under a ``[MEM]`` pattern (reference: src/mem.cpp:18-38, started/joined
around solve() at src/main.cpp:104-107,236-240).  Reads
``/proc/self/statm``; ``device_memory_stats`` reports the accelerator's
own counters.
"""

from __future__ import annotations

import logging
import os
import threading

logger = logging.getLogger("tpufem")


def read_statm() -> tuple:
    """(VSIZE, RSS) of this process in bytes, from /proc/self/statm
    (fields 1-2, counted in pages)."""
    with open("/proc/self/statm") as f:
        size, resident = f.read().split()[:2]
    page = os.sysconf("SC_PAGE_SIZE")
    return int(size) * page, int(resident) * page


class MemoryProfiler:
    def __init__(self, interval_s: float = 0.1) -> None:
        self.interval = interval_s
        self._quit = threading.Event()
        self._thread: threading.Thread | None = None

    def _run(self) -> None:
        gb = 1.0 / (1 << 30)
        while not self._quit.is_set():
            vsize, rss = read_statm()
            logger.info("[MEM] VSIZE = %.3f GB, RSS = %.3f GB",
                        vsize * gb, rss * gb)
            self._quit.wait(self.interval)

    def start(self) -> "MemoryProfiler":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._quit.set()
            self._thread.join()
            self._thread = None


def device_memory_stats() -> dict:
    """Memory counters of the first local device (``peak_bytes_in_use``
    and friends); empty where the backend reports none."""
    import jax
    return jax.local_devices()[0].memory_stats() or {}
