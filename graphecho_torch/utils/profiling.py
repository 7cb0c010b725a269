"""Tracing, port of `graphecho_tpu/utils/profiling.py`.

  * `profile_trace(log_dir)`: `torch.profiler` over the block, CPU and (when
    there is a card) CUDA activity, written to `log_dir` as a Chrome trace
    (`trace.json`, loadable in Perfetto or `chrome://tracing`);
  * `annotate(name)`: a named range in that trace (`record_function`), the
    counterpart of the JAX package's `TraceAnnotation`; the train step marks
    its phases and the graph head's parts this way (rules in `annotate`);
  * `innermost_spans(times, spans)`: the span each instant of a trace falls
    in; `profile_step` gives idle device time, launches and
    synchronisations to spans by it.

`python -m graphecho_torch.profile_step` reads the same profiler into a
per-step breakdown.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterable, List, Sequence, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

OUTSIDE = "outside spans"


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
    """A named range in a `profile_trace` (a few µs and no device work
    without a profiler). Every span of the train step opens through here,
    under these rules:

      * its name begins with `step.`: trace readers collect the program's
        spans by that prefix, and keep their device-side copies out of the
        device's kernels and busy time;
      * readers sum the host time of the graph head's phases, every name
        that begins with `step.sampling` or `step.gmodule` or is
        `step.tgcn`; a span inside them under such a name would count
        twice, so the GModule's parts are `step.gm.*`, the TGCN's
        `step.tg.*`, the node sampling's `step.nodes.*` and the batch's
        copies to the card `step.h2d`;
      * no span opens inside a loop body (a Lanczos, k-means or Sinkhorn
        iteration, a TGCN frame): a step opens a few dozen;
      * no span keeps a host clock of its own: the profiler's timeline,
        shared with the device events, is the one clock."""
    return record_function(name)


def innermost_spans(times: Sequence[float], spans: Iterable[Tuple[float, float, str]],
                    outside: str = OUTSIDE) -> List[str]:
    """For each instant of `times`, the name of the shortest span
    (start, end, name) whose [start, end) holds it, the innermost where spans
    nest, or `outside`. Spans and instants are matched by time alone, so a
    call made on another thread (autograd's backward) falls in the span the
    step's thread had open meanwhile."""
    spans = sorted(spans)
    out = [outside] * len(times)
    open_: List[Tuple[float, float, str]] = []  # (end, length, name)
    j = 0
    for i in sorted(range(len(times)), key=times.__getitem__):
        t = times[i]
        while j < len(spans) and spans[j][0] <= t:
            s, e, name = spans[j]
            open_.append((e, e - s, name))
            j += 1
        open_ = [o for o in open_ if o[0] > t]
        if open_:
            out[i] = min(open_, key=lambda o: o[1])[2]
    return out
