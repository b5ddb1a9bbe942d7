"""Tracing / profiling utilities.

The reference's only observability is print breadcrumbs + tqdm
(SURVEY.md section 5); here every pipeline records a structured
stage-timing ledger, and these helpers add (a) a reusable timer and
(b) a jax.profiler trace context for device timeline capture
(enable with HYPERRES_PROFILE_DIR=/path or the context manager).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional


class StageTimer:
    """Accumulates named stage wall-clock timings into a dict ledger."""

    def __init__(self, ledger: Optional[Dict] = None):
        self.ledger = ledger if ledger is not None else {}

    @contextlib.contextmanager
    def stage(self, name: str, **extra):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            rec = {"seconds": round(time.perf_counter() - t0, 6)}
            rec.update(extra)
            self.ledger[name] = rec


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str] = None):
    """jax.profiler trace context; no-op unless a directory is given or
    HYPERRES_PROFILE_DIR is set."""
    log_dir = log_dir or os.environ.get("HYPERRES_PROFILE_DIR")
    if not log_dir:
        yield
        return
    import jax
    with jax.profiler.trace(log_dir):
        yield
