"""Preemption-aware checkpointing, a copy of `graphecho_tpu/utils/preemption.py`.

The reference has no failure handling (crash = manual restart from a
partially-saved network, SURVEY §5). On shared and spot GPU machines
preemption is routine, so the Trainer installs a SIGTERM/SIGINT hook that
requests a checkpoint at the next step boundary and exits cleanly.
"""

from __future__ import annotations

import signal
import threading
from typing import Callable, Optional


class PreemptionGuard:
    """`guard.should_stop` flips when SIGTERM/SIGINT arrives; the train loop
    checks it each step and saves before exiting."""

    def __init__(self, on_preempt: Optional[Callable[[], None]] = None,
                 signals=(signal.SIGTERM, signal.SIGINT)):
        self._stop = threading.Event()
        self._on_preempt = on_preempt
        self._installed = []
        for sig in signals:
            try:
                prev = signal.signal(sig, self._handler)
                self._installed.append((sig, prev))
            except ValueError:  # not in main thread
                pass

    def _handler(self, signum, frame):
        self._stop.set()
        if self._on_preempt is not None:
            self._on_preempt()

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()

    def uninstall(self):
        for sig, prev in self._installed:
            signal.signal(sig, prev)
        self._installed = []
