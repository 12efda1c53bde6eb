"""Profiling / metrics / structured logging.

The reference's observability is an FPS overlay + chrono timing + device printf
(SURVEY.md §5).  JAX-native equivalents:

* ``profile_trace``: context manager around ``jax.profiler`` emitting an xplane
  trace viewable in TensorBoard/XProf.
* ``FrameStats``: per-frame counters (rays cast, Mrays/s, wall ms) accumulated
  host-side around each jitted step and emitted as JSON lines.
* ``log``: structured stdout logging with a monotonic timestamp.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

import jax


def log(event: str, **fields) -> None:
    rec = {"t": time.monotonic(), "event": event}
    rec.update(fields)
    print(json.dumps(rec), file=sys.stderr, flush=True)


@contextlib.contextmanager
def profile_trace(logdir: str = "/tmp/raytracer_trace"):
    """Capture a device profile for the enclosed block (jax.profiler)."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()
        log("profile_trace_written", logdir=logdir)


@dataclass
class FrameStats:
    """Accumulates render statistics across frames; prints one JSON line each."""

    width: int
    height: int
    spp: int = 1
    frames: int = 0
    total_ms: float = 0.0
    _t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        ms = (time.perf_counter() - self._t0) * 1e3
        self.frames += 1
        self.total_ms += ms
        rays = self.width * self.height * self.spp
        log(
            "frame",
            frame=self.frames,
            ms=round(ms, 3),
            mrays_per_s=round(rays / ms / 1e3, 3),
        )
        return False

    @property
    def mean_ms(self) -> float:
        return self.total_ms / max(self.frames, 1)
