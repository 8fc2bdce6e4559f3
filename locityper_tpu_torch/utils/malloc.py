"""Host allocator tuning for lazily-faulted VMs.

glibc returns large buffers to the kernel on free (mmap/munmap per
allocation >128 KiB and arena trimming), so every big numpy temporary
re-faults its pages.  On bare metal a fault is ~1 us; on lazily-backed VM
memory (ballooned / userfaultfd-served) it can be ~0.5 ms, making fresh
100 MB allocations tens of seconds.  Keeping freed pages in the arena pays
the fault cost once per page for the process lifetime.

The reference runtime (Rust, jemalloc-style retention) never hits this —
this is the Python-host counterpart.  Pinned host buffers come from
`cudaHostAlloc`, not from malloc, and are not affected.
No-op on non-glibc platforms.
"""
from __future__ import annotations

import ctypes
import logging

logger = logging.getLogger(__name__)

_done = False

# malloc.h constants (glibc).
M_TRIM_THRESHOLD = -1
M_MMAP_THRESHOLD = -3
M_MMAP_MAX = -4


def tune_host_allocator() -> bool:
    """Disable malloc's mmap path and arena trimming so freed pages stay
    resident.  Idempotent; returns True when applied."""
    global _done
    if _done:
        return True
    try:
        libc = ctypes.CDLL(None)
        mallopt = libc.mallopt
        mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
        mallopt.restype = ctypes.c_int
        ok = mallopt(M_MMAP_MAX, 0)
        ok &= mallopt(M_TRIM_THRESHOLD, 2**31 - 1)
        _done = bool(ok)
        if _done:
            logger.debug("host allocator tuned: mmap off, trim off")
        return _done
    except Exception:                       # pragma: no cover - non-glibc
        return False
