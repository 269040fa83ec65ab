"""Tuned host-environment profile (``--tuned-host``; port of
``repro/launch/hostenv.py``).

Two host-side knobs that large training launchers ship in their run
scripts:

* ``LD_PRELOAD`` tcmalloc — the host_lru fault path and the dedup plans
  churn numpy temporaries every step; tcmalloc's thread caches beat glibc
  malloc on that churn, and the pipelined trainer's stage threads
  allocate concurrently.
* ``TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD`` — silence the per-allocation
  warnings the big host-store buffers would otherwise trigger.

The JAX package's ``TF_CPP_MIN_LOG_LEVEL`` and ``XLA_FLAGS`` set nothing
in torch and are dropped.

``LD_PRELOAD`` only takes effect at process start, so
``apply_tuned_host`` re-execs the interpreter exactly once (guarded by a
marker env var). When libtcmalloc is not installed the profile degrades to
the env-var-only subset — a no-op, never an error. Importing this module
changes nothing.
"""
from __future__ import annotations

import glob
import os
import sys

# marker: set on first application so the re-exec'd process (which inherits
# it) falls straight through instead of exec-looping
_MARKER = "REPRO_TORCH_TUNED_HOST"

# the exact soname launchers usually preload, then progressively looser
# fallbacks (minimal build, unversioned dev symlink, other arches)
_TCMALLOC_GLOBS = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/*/libtcmalloc.so*",
    "/usr/lib/*/libtcmalloc_minimal.so*",
    "/usr/lib/libtcmalloc*.so*",
    "/usr/local/lib/libtcmalloc*.so*",
)


def find_tcmalloc() -> str | None:
    """Path of the best installed libtcmalloc, or None when absent."""
    for pat in _TCMALLOC_GLOBS:
        hits = sorted(glob.glob(pat))
        if hits:
            return hits[0]
    return None


def tuned_env() -> dict:
    """The env-var subset of the profile, as a pure dict (no process
    mutation)."""
    return {"TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD": "60000000000"}


def apply_tuned_host() -> str:
    """Apply the profile to THIS process. Returns a status string:

    * ``"already"``     — marker set (we are the re-exec'd process);
    * ``"no-tcmalloc"`` — env vars applied, libtcmalloc absent (nothing to
      preload, no re-exec);
    * ``"preloaded"``   — env vars applied, tcmalloc already in LD_PRELOAD.

    When tcmalloc is found and not yet preloaded this re-execs the
    interpreter with LD_PRELOAD set and does NOT return.
    """
    if os.environ.get(_MARKER):
        return "already"
    os.environ.update(tuned_env())
    os.environ[_MARKER] = "1"
    lib = find_tcmalloc()
    if lib is None:
        return "no-tcmalloc"
    pre = os.environ.get("LD_PRELOAD", "")
    if lib in pre.split(":"):
        return "preloaded"
    os.environ["LD_PRELOAD"] = f"{lib}:{pre}" if pre else lib
    # sys.argv[0] is the script path under both `python x.py` and
    # `python -m pkg.mod`; PYTHONPATH is inherited so imports resolve
    os.execv(sys.executable, [sys.executable] + sys.argv)
    raise AssertionError("unreachable")  # pragma: no cover
