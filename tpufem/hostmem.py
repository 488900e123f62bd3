"""Host-memory tuning for the setup phases.

Where a host provisions pages lazily, the FIRST touch of a fresh page
costs far more than a re-touch, so every GB of new allocation is paid
again the first time a process uses it.  The reference avoids this
class of cost with pooled native allocators (PETSc keeps and reuses its
buffers); the equivalents here:

- ``tune_allocator()``: glibc ``mallopt`` raises the mmap threshold and
  disables trim, so numpy's large setup temporaries are SERVED FROM THE
  HEAP POOL and reused across setup phases instead of being munmapped on
  free and re-faulted on the next allocation.  Called at package import;
  idempotent, no-op on non-glibc.
- ``prefault(nbytes, background=True)``: touch ``nbytes`` of heap once
  so the pool's pages are materialized before the setup phases need
  them.  Run in a daemon thread it overlaps device initialization and
  compilation, taking the fault cost off the critical path.  The buffer
  is freed immediately — with ``tune_allocator`` the pool retains the
  warmed pages.
- ``warm_vm(nbytes)``: page warm-up in a nice'd subprocess.  On a VM
  whose guest pages are provisioned on first touch, a page that ANY
  process has materialized stays in the guest allocator, so a fresh
  mmap in a different process then faults at kernel-zeroing speed.  The
  subprocess pays that one-time cost early and off the critical path;
  callers stop it when their run ends.
"""

from __future__ import annotations

import ctypes
import logging
import threading

logger = logging.getLogger("tpufem")

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3
_tuned = False


def tune_allocator() -> bool:
    """Raise glibc's mmap threshold (1 GiB) and disable heap trim so
    large numpy temporaries are pooled and reused.  Idempotent."""
    global _tuned
    if _tuned:
        return True
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        ok = (libc.mallopt(_M_MMAP_THRESHOLD, 1 << 30) == 1
              and libc.mallopt(_M_TRIM_THRESHOLD, 1 << 30) == 1)
    except Exception:  # pragma: no cover - non-glibc platforms
        ok = False
    _tuned = ok
    if not ok:  # pragma: no cover
        logger.debug("mallopt tuning unavailable; large numpy "
                     "temporaries will be re-faulted per allocation")
    return ok


_WARM_SRC = r"""
import mmap, os, sys, time
nbytes = int(sys.argv[1])
try:
    os.nice(19)
except OSError:
    pass
chunk = 256 << 20
done = 0
t0 = time.monotonic()
while done < nbytes:
    sz = min(chunk, nbytes - done)
    m = mmap.mmap(-1, sz, flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS)
    mv = memoryview(m)
    for off in range(0, sz, 4096):
        mv[off] = 1
    mv.release()
    m.close()  # pages return to the guest allocator, staying warm
    done += sz
sys.stderr.write("[warm_vm] %d MiB in %.1fs\n"
                 % (done >> 20, time.monotonic() - t0))
"""


def warm_vm(nbytes: int = 8 << 30):
    """Materialize ``nbytes`` of guest-physical pages in a nice'd
    subprocess (see module docstring).  Returns the Popen handle; the
    caller kills it when its run ends."""
    import subprocess
    import sys
    try:
        return subprocess.Popen(
            [sys.executable, "-c", _WARM_SRC, str(int(nbytes))],
            stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL, start_new_session=True)
    except Exception:  # pragma: no cover
        return None


def _touch(nbytes: int) -> None:
    # chunks BELOW the raised mmap threshold: a single >= 1 GiB buffer
    # would be served via mmap and munmapped on free (glibc always
    # unmaps mmap'd chunks), warming nothing; sub-threshold chunks grow
    # the brk heap, which the disabled trim retains.  All chunks stay
    # alive until the end so the heap grows to the full size.
    import numpy as np
    chunk = 256 << 20
    held = []
    try:
        for _ in range((nbytes + chunk - 1) // chunk):
            buf = np.empty(chunk, dtype=np.uint8)
            buf[::4096] = 1  # one write per 4 KiB page
            held.append(buf)
    except MemoryError:  # pragma: no cover
        pass
    finally:
        held.clear()


def prefault(nbytes: int = 1 << 30, background: bool = True):
    """Materialize ``nbytes`` of host pages in the malloc pool (one
    write per page).  ``background=True`` returns a started daemon
    thread (join it to be sure the pool is warm); False blocks."""
    tune_allocator()
    if not background:
        _touch(nbytes)
        return None
    th = threading.Thread(target=_touch, args=(nbytes,), daemon=True,
                          name="tpufem-prefault")
    th.start()
    return th
