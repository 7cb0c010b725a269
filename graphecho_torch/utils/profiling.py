"""Tracing and timing, port of `graphecho_tpu/utils/profiling.py`.

  * `profile_trace(log_dir)`: `torch.profiler` over the block, CPU and (when
    there is a card) CUDA activity, written to `log_dir` as a Chrome trace
    (`trace.json`, loadable in Perfetto or `chrome://tracing`);
  * `annotate(name)`: a named range in that trace (`record_function`), the
    counterpart of the JAX package's `TraceAnnotation`; the train step marks
    its phases this way (`step.fpn_source`, `step.gmodule`, ...);
  * `StepTimer`: wall-clock seconds per step with the first steps left out
    as warm-up. Given the device it times, it synchronises CUDA before it
    reads the clock at both ends, so a step's time is the device's and not
    that of the launches alone.

`python -m graphecho_torch.profile_step` reads the same profiler into a
per-step breakdown.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional, Union

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """`with profile_trace('/tmp/trace'): step(...)` writes
    `/tmp/trace/trace.json`; yields the profiler, whose `key_averages()` the
    caller may read."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named range in a `profile_trace` (a no-op without a profiler)."""
    return record_function(name)


class StepTimer:
    """Rolling per-step timing that leaves out the first `warmup` steps (the
    kernel builds and cuDNN's autotuning)."""

    def __init__(self, warmup: int = 2, device: Optional[Union[str, torch.device]] = None):
        self.warmup = warmup
        self.device = None if device is None else torch.device(device)
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = 0.0
        self._t0: Optional[float] = None

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        dt = time.perf_counter() - self._t0
        self.count += 1
        if self.count > self.warmup:
            self.total += dt
            self.min = min(self.min, dt)
            self.max = max(self.max, dt)
        return False

    @property
    def mean(self) -> float:
        steady = self.count - self.warmup
        return self.total / steady if steady > 0 else float("nan")

    def stats(self) -> Dict[str, float]:
        return {"steps": self.count, "mean_s": self.mean, "min_s": self.min, "max_s": self.max}
