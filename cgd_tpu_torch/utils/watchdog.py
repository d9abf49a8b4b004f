"""Stall detection for device-bound runs, a copy of
``cgd_tpu/utils/watchdog.py`` (pure stdlib; pinned to the original by
tests/test_torch_port_serve.py).

A hung CUDA call (a wedged driver, a card that fell off the bus) blocks the
calling thread inside C exactly as a hung PJRT call does: no exception and
no signal reaches it. So the only useful behaviours are (a) diagnose loudly
and (b) get the process restarted so ``--resume`` continues from the last
completed segment (the sampler hands its resumable state to the
``state_sink`` after EVERY segment, before the frame is yielded).

``StallDetector`` is a context manager owning one daemon thread. The run
calls :meth:`pet` at every progress point (weight resolution, prompt
encoding, each sampler segment). If no pet arrives within ``timeout_s``:

1. a stall report (phase, seconds stalled, pid) is written to stderr and,
   when ``report_path`` is given, to a JSON file a supervisor can parse;
2. every thread's Python stack is dumped via :mod:`faulthandler` (shows
   which device call is blocked);
3. with ``exit_on_stall`` the process hard-exits with :data:`STALL_EXIT_CODE`
   (``os._exit``: a thread blocked in a CUDA call would swallow anything
   softer), which a supervisor tells apart from a crash and answers with a
   restart with ``--resume``.

Timeouts must exceed the worst legitimate gap between pets; on the card
that is the kernels' first build (``kernels/_build.py``: nvcc, tens of
seconds when not cached) inside the first sampling segment. There is no
default timeout: the CLI's and the daemon's ``--stall-timeout`` leave it off
unless asked for.
"""

from __future__ import annotations

import faulthandler
import json
import os
import sys
import threading
import time
from typing import Optional

STALL_EXIT_CODE = 117  # distinct from crash codes so supervisors can resume


class StallDetector:
    """Watchdog thread; ``pet()`` resets the countdown, ``timeout_s`` ends it.

    Usage::

        with StallDetector(600, exit_on_stall=True) as dog:
            dog.pet("resolve weights")
            params = resolve(...)
            for k, frame, x in sample_loop(...):
                dog.pet(f"segment ending at step {k}")

    A ``timeout_s`` of 0 (or None) disables the detector entirely — the
    context manager then does nothing, so call sites need no branching.
    """

    def __init__(
        self,
        timeout_s: Optional[float],
        *,
        exit_on_stall: bool = False,
        report_path: Optional[str] = None,
        on_stall=None,  # test hook: called instead of exiting when set
    ):
        self.timeout_s = float(timeout_s or 0)
        self.exit_on_stall = exit_on_stall
        self.report_path = report_path
        self.on_stall = on_stall
        self._phase = "startup"
        self._last_pet = time.monotonic()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stalled = False  # set before the stall action runs

    @property
    def enabled(self) -> bool:
        return self.timeout_s > 0

    def pet(self, phase: str) -> None:
        """Record progress; the countdown restarts and the report names
        ``phase`` if the NEXT gap stalls."""
        with self._lock:
            self._phase = phase
            self._last_pet = time.monotonic()

    def __enter__(self) -> "StallDetector":
        if self.enabled:
            self._thread = threading.Thread(
                target=self._watch, name="cgd-stall-detector", daemon=True
            )
            self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        return None

    # -- internals ----------------------------------------------------------
    def _watch(self) -> None:
        while not self._stop.wait(min(self.timeout_s / 4, 5.0)):
            with self._lock:
                phase, last = self._phase, self._last_pet
            stalled_for = time.monotonic() - last
            if stalled_for >= self.timeout_s:
                self.stalled = True
                self._report(phase, stalled_for)
                if self.on_stall is not None:
                    self.on_stall(phase, stalled_for)
                    return
                if self.exit_on_stall:
                    os._exit(STALL_EXIT_CODE)
                return  # report once, keep the process (user may be attached)

    def _report(self, phase: str, stalled_for: float) -> None:
        msg = (
            f"[cgd-tpu] STALL: no progress for {stalled_for:.1f}s "
            f"(limit {self.timeout_s:.1f}s) during '{phase}' — the device "
            f"backend is likely unresponsive. Resumable state (if "
            f"--checkpoint was given) is already on disk; restart with "
            f"--resume to continue."
        )
        print(msg, file=sys.stderr, flush=True)
        try:
            faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        except Exception:
            pass
        if self.report_path:
            try:
                with open(self.report_path, "w") as f:
                    json.dump(
                        {
                            "stalled": True,
                            "phase": phase,
                            "stalled_for_s": round(stalled_for, 1),
                            "timeout_s": self.timeout_s,
                            "pid": os.getpid(),
                            "exit_code": STALL_EXIT_CODE if self.exit_on_stall else None,
                        },
                        f,
                    )
            except OSError:
                pass  # reporting must never take down the run itself
