"""Profiling helpers (the reference measures performance only through its
google_benchmark binaries; on an accelerator the native tool is
jax.profiler —
SURVEY section 5)."""

from __future__ import annotations

import contextlib
import tempfile
import time
from typing import Optional

import jax


@contextlib.contextmanager
def trace_solve(log_dir: Optional[str] = None):
    """Capture a jax.profiler trace around a solve; view with XProf or
    tensorboard-plugin-profile.  Yields the trace directory (default: a
    new directory under $TMPDIR)."""
    if log_dir is None:
        log_dir = tempfile.mkdtemp(prefix="sip_oc_trace_")
    with jax.profiler.trace(log_dir):
        yield log_dir


def timed_block_until_ready(fn, *args, reps: int = 5):
    """Best/median wall time of a jitted callable (compile excluded)."""
    out = jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.time()
        out = jax.block_until_ready(fn(*args))
        times.append(time.time() - t0)
    times.sort()
    return out, {"best_s": times[0], "p50_s": times[len(times) // 2]}
