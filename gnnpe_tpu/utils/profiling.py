"""Profiling and observability.

The reference's tracing is inline chrono spans printed via cout
(SURVEY.md §5) — stage timers here are gnnpe_tpu.utils.timers.  This
module adds the device-side pieces:

  * :func:`trace` — jax.profiler wrapper producing TensorBoard-
    loadable traces of a region (XLA op breakdown, HBM usage);
  * :func:`annotate` — named TraceAnnotation context so pipeline
    stages show up in the trace timeline;
  * :class:`MetricsLog` — structured (JSON-lines) metrics with
    monotonic step counter, replacing bare prints.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Optional


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace for the enclosed region."""
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str):
    """Label the enclosed device work in profiler timelines."""
    import jax
    with jax.profiler.TraceAnnotation(name):
        yield


class MetricsLog:
    """Append-only JSON-lines metrics (one object per event)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fh = open(path, "a") if path else None
        self._t0 = time.time()

    def log(self, event: str, **fields):
        rec = {"t": round(time.time() - self._t0, 6),
               "event": event, **fields}
        line = json.dumps(rec, sort_keys=True)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        return rec

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
