"""Failure detection + elastic recovery for long-running training.

The reference has no failure-handling story (a crashed CUDA kernel kills the
process and the work, SURVEY.md §5 marks this row non-parity); on shared or
preemptible accelerator machines worker crashes are routine, so this
framework treats them as first-class:

* **Failure detection.**  A supervisor runs the training loop in a worker
  subprocess and watches its structured stderr heartbeat (the one
  ``train_step`` JSON line per step that ``cli._train`` already emits via
  ``tracing.log``).  Two failure modes are detected: a CRASH (worker exits
  nonzero — a device-runtime fault, an OOM kill or a preemption)
  and a HANG (no heartbeat for ``hang_timeout_s`` — e.g. a stuck
  collective), which is resolved by killing the exact worker PID (never a
  pattern match) and reaping it before the next worker starts, so only one
  process holds the device at a time.  The supervisor itself never imports a
  backend: the worker is the only process that touches the device.
* **Elastic recovery.**  On failure the worker is relaunched with the SAME
  argv; the checkpoint/resume path (``checkpoint.load`` +
  ``--checkpoint-every``) makes the restart pick up from the last durable
  step, and ``--train-until`` gives the loop an absolute step target so a
  restarted worker converges to exactly the same final state as an
  uninterrupted run (training is a pure function of (params, target), so
  recomputed steps are bit-identical).  ``max_restarts`` bounds the retry
  budget (crash loops surface instead of spinning).

Fault injection for tests lives in ``cli._train`` behind ``RT_FAULT_AT_STEP``
/ ``RT_HANG_AT_STEP`` + a one-shot marker file — see
``tests/test_train_cli.py::test_elastic_recovery_*``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from . import tracing

# Only actual step PROGRESS counts as a heartbeat: startup chatter (e.g.
# checkpoint_restored) must not end the startup grace early, or the
# post-restore XLA recompile gets misjudged as a hang.
HEARTBEAT_EVENTS = ("train_step", "frame")


@dataclass
class SuperviseResult:
    completed: bool
    restarts: int
    failures: List[str] = field(default_factory=list)  # "crash rc=13" / "hang"
    last_step: Optional[int] = None


class _HeartbeatReader(threading.Thread):
    """Drains a worker's stderr, forwards it, and timestamps heartbeats."""

    def __init__(self, stream, sink):
        super().__init__(daemon=True)
        self._stream = stream
        self._sink = sink
        self.last_beat = time.monotonic()
        self.seen_any = False  # first heartbeat ends the startup grace
        self.last_step: Optional[int] = None

    def run(self):
        for line in self._stream:
            print(line, end="", file=self._sink, flush=True)
            if line.startswith("{"):
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if rec.get("event") in HEARTBEAT_EVENTS:
                    self.last_beat = time.monotonic()
                    self.seen_any = True
                    if "step" in rec:
                        self.last_step = int(rec["step"])


def run_supervised(worker_argv: Sequence[str], max_restarts: int = 3,
                   hang_timeout_s: float = 300.0,
                   startup_grace_s: float = 600.0,
                   poll_s: float = 0.2) -> SuperviseResult:
    """Run ``python -m raytracer.cli <worker_argv>`` under supervision.

    Restarts the worker on crash or heartbeat hang, up to ``max_restarts``
    times; returns once the worker exits 0 (completed) or the restart budget
    is exhausted.  Before the FIRST heartbeat of each attempt the (slow)
    startup path — jax import + XLA compile — is covered by
    ``startup_grace_s`` instead of ``hang_timeout_s``."""
    cmd = [sys.executable, "-m", "raytracer.cli", *worker_argv]
    result = SuperviseResult(completed=False, restarts=0)
    attempts = max_restarts + 1
    for attempt in range(attempts):
        if attempt:
            result.restarts += 1
            tracing.log("elastic_restart", attempt=attempt,
                        failures=result.failures)
        proc = subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True)
        reader = _HeartbeatReader(proc.stderr, sys.stderr)
        reader.start()
        hung = False
        while True:
            rc = proc.poll()
            if rc is not None:
                break
            limit = (hang_timeout_s if reader.seen_any
                     else max(hang_timeout_s, startup_grace_s))
            if time.monotonic() - reader.last_beat > limit:
                # kill the exact worker PID we started — never a pattern
                hung = True
                proc.kill()
                proc.wait()
                rc = proc.returncode
                break
            time.sleep(poll_s)
        reader.join(timeout=5.0)
        result.last_step = reader.last_step
        if not hung and rc == 0:
            result.completed = True
            tracing.log("elastic_done", restarts=result.restarts,
                        last_step=result.last_step)
            return result
        result.failures.append("hang" if hung else f"crash rc={rc}")
        tracing.log("elastic_failure", kind=result.failures[-1],
                    last_step=result.last_step)
    tracing.log("elastic_gave_up", restarts=result.restarts,
                failures=result.failures)
    return result
