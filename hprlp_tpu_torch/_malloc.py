"""Host allocator tuning for giant-LP ingest (OPT-IN).

Copy of hprlp_tpu/_malloc.py, whose code tests/test_torch_copies.py pins
this module's to; `preheat` touches pages through the port's host library
(native.py, hprlp_parallel_touch from native/src/lane_fill.cpp).

The host pipeline (MPS parse, presolve, CSR and transpose, tile layout)
allocates and frees multi-GB numpy/C++ buffers per phase.  With glibc
defaults every large allocation is a fresh mmap that is munmapped on
free, so each phase re-faults its working set page by page; where minor
faults are expensive (VM guests; also bare metal under memory pressure)
kernel time can dominate the host side.

Tuning applied by tune_malloc() -- NEVER on import.  It runs only when
explicitly requested: HPRLP_MALLOC_TUNE=1 in the environment (read by
the package's __init__), or a direct call from an entry point that owns
the process (the CLI's --malloc-tune flag):

- mallopt(M_MMAP_MAX, 0) + huge M_TRIM_THRESHOLD / M_MMAP_THRESHOLD:
  all allocations come from the brk heap and freed pages are KEPT by the
  process, so later phases reuse hot pages instead of re-faulting.
  Process-local, dies with the process.
- transparent_hugepage=always: heap faults map 2 MB pages.  This is a
  HOST-GLOBAL kernel policy: it is only written when tune_malloc(thp=True)
  is called (or HPRLP_MALLOC_TUNE=1), the previous value is logged and
  restored at interpreter exit via atexit (and on SIGTERM).

Trade-off: peak RSS is held for the process lifetime (the heap never
shrinks back).  Right for a solver appliance / benchmark run; wrong for
memory-constrained co-tenancy -- hence opt-in.
"""
from __future__ import annotations

import atexit
import ctypes
import os
import sys

_done: dict = {}

# glibc mallopt parameter numbers (malloc.h).
_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3
_M_MMAP_MAX = -4

_THP_PATH = "/sys/kernel/mm/transparent_hugepage/enabled"


def _restore_thp(prev: str) -> None:
    try:
        with open(_THP_PATH, "w") as f:
            f.write(prev)
    except OSError:
        pass


def tune_malloc(thp: bool | None = None) -> dict:
    """Apply the allocator tuning once per process (explicit opt-in only);
    returns a report dict {"mallopt": bool, "thp": "always"|"unchanged"|...}.

    thp=True additionally enables transparent hugepages host-wide (kernel
    policy; previous value restored at exit).  Default: only when
    HPRLP_MALLOC_TUNE=1 is set in the environment.
    """
    if _done:
        return _done
    report = {"mallopt": False, "thp": "unchanged"}
    if os.environ.get("HPRLP_MALLOC_TUNE") == "0" or \
            not sys.platform.startswith("linux"):
        report["thp"] = "disabled"
        _done.update(report)
        return report
    if thp is None:
        thp = os.environ.get("HPRLP_MALLOC_TUNE") == "1"

    try:
        libc = ctypes.CDLL(None)
        ok = libc.mallopt(_M_TRIM_THRESHOLD, 2**31 - 1)
        ok &= libc.mallopt(_M_MMAP_THRESHOLD, 2**31 - 1)
        ok &= libc.mallopt(_M_MMAP_MAX, 0)
        report["mallopt"] = bool(ok)
    except Exception:
        pass

    if thp:
        try:
            with open(_THP_PATH) as f:
                cur = f.read()
            if "[always]" not in cur:
                # Extract the bracketed current policy, e.g.
                # "always [madvise] never" -> "madvise".
                prev = cur[cur.index("[") + 1:cur.index("]")] \
                    if "[" in cur else "madvise"
                with open(_THP_PATH, "w") as f:
                    f.write("always")
                print(f"[hprlp_tpu] transparent_hugepage: {prev} -> always "
                      f"(restored at exit)", file=sys.stderr)
                atexit.register(_restore_thp, prev)
                # atexit does not run on SIGTERM (how `timeout` kills a
                # benchmark): restore on TERM too, chaining any existing
                # handler.
                import signal

                prev_handler = signal.getsignal(signal.SIGTERM)

                def _on_term(signum, frame):
                    _restore_thp(prev)
                    if callable(prev_handler):
                        prev_handler(signum, frame)
                    else:
                        signal.signal(signal.SIGTERM, signal.SIG_DFL)
                        os.kill(os.getpid(), signal.SIGTERM)

                try:
                    signal.signal(signal.SIGTERM, _on_term)
                except ValueError:
                    pass  # non-main thread: atexit alone
            report["thp"] = "always"
        except OSError:
            pass  # not root / no THP: mallopt alone still pays

    _done.update(report)
    return report


def is_tuned() -> bool:
    """True when tune_malloc() has applied the brk-heap mallopt."""
    return bool(_done.get("mallopt"))


_preheated = 0


def preheat(n_bytes: int) -> int:
    """Pre-fault ~n_bytes of the brk heap in parallel (hugepage-advised).

    Page-zero faulting on the target VMs is single-thread-bound and slow
    (~130 MB/s measured — a fresh 1.8 GB numpy temporary costs ~13 s on
    first touch), while a parallel touch with THP runs ~13 GB/s.  With
    the brk tuning active, faulting the working set ONCE up front means
    every later multi-GB numpy temporary reuses hot pages.  No-op unless
    tune_malloc() ran (untuned processes would just mmap+munmap the
    block).  Returns the bytes actually preheated."""
    global _preheated
    if not is_tuned() or n_bytes <= _preheated:
        return 0
    try:
        from .native import get_lib

        lib = get_lib()
        if lib is None:
            return 0
        import numpy as np

        # Leave headroom: never preheat past ~40% of available memory.
        avail = None
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemAvailable:"):
                        avail = int(line.split()[1]) * 1024
                        break
        except OSError:
            pass
        target = int(n_bytes)
        if avail is not None:
            target = min(target, int(avail * 0.4))
        if target <= _preheated:
            return 0
        buf = np.empty(target, np.uint8)
        lib.hprlp_parallel_touch(buf, target)
        _preheated = max(_preheated, target)
        del buf
        return target
    except Exception:
        return 0
