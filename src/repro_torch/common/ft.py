"""Fault-tolerance primitives of the serve engine (a copy of the numpy-free
``repro/common/ft.py``, without ``PreemptionHandler``, which waits for the
training slice).

* ``StragglerMonitor`` — EWMA of step wall-time; flags steps slower than
  ``threshold×`` the moving average (the serve engine surfaces it via
  ``health()``).
* ``retry`` — bounded exponential-backoff retry for transient failures
  (the engine retries only ``TransientStepError``).
* ``Heartbeat`` — periodic liveness file; a controller can detect a hung
  host by mtime.  ``beat()`` writes atomically (tmp + ``os.replace``) so a
  monitor polling the file can never read a torn or empty beat.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional


class StragglerMonitor:
    def __init__(self, threshold: float = 2.0, alpha: float = 0.1):
        self.threshold = threshold
        self.alpha = alpha
        self.ewma: Optional[float] = None
        self.stragglers = 0
        self.last_report: Optional[str] = None

    def record(self, step: int, seconds: float) -> bool:
        slow = False
        if self.ewma is not None and seconds > self.threshold * self.ewma:
            self.stragglers += 1
            self.last_report = (
                f"step {step}: {seconds:.3f}s vs EWMA {self.ewma:.3f}s "
                f"(x{seconds / self.ewma:.1f}) — straggler"
            )
            slow = True
        self.ewma = (
            seconds
            if self.ewma is None
            else (1 - self.alpha) * self.ewma + self.alpha * seconds
        )
        return slow


def retry(fn: Callable, *, attempts: int = 3, base_delay: float = 0.1,
          exceptions=(IOError, OSError)):
    """Call fn() with bounded exponential backoff.  ``attempts`` must be
    >= 1 — silently returning ``None`` without ever calling ``fn`` would
    turn a mis-typed retry budget into a skipped checkpoint write."""
    if attempts < 1:
        raise ValueError(f"retry: attempts must be >= 1, got {attempts}")
    for i in range(attempts):
        try:
            return fn()
        except exceptions:
            if i == attempts - 1:
                raise
            if base_delay > 0:
                time.sleep(base_delay * (2 ** i))


class Heartbeat:
    """Periodic liveness file.  ``start``/``stop`` form a restartable pair:
    each ``start`` spins up a fresh thread+event, and ``stop`` joins the
    thread (the event wakes the ``wait`` immediately) so callers know no
    further beat can race a directory teardown.

    ``beat()`` is atomic: the timestamp lands in a sibling tmp file first
    and ``os.replace`` swaps it in, so a monitor that polls the path reads
    either the previous beat or the new one — never a torn/empty file
    (and a crash mid-beat leaves the previous beat intact)."""

    def __init__(self, path: str, interval: float = 30.0):
        self.path = path
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _run(self, stop: threading.Event):
        while not stop.wait(self.interval):
            self.beat()

    def beat(self):
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(str(time.time()))
        os.replace(tmp, self.path)

    def start(self):
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("Heartbeat already running")
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(self._stop,), daemon=True
        )
        self.beat()
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
