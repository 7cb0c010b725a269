"""A `torch.profiler` trace, reduced to what the per-layer metric readers
and the result line's `breakdown` take.

The arithmetic is the one the program's `profile_step` uses: device busy
time is the union of the device events' intervals, leaving out the
device-side copies of `record_function` spans (a span is no kernel, and it
would count the gaps between its kernels as busy); a kernel's function
name is read from its demangled name."""

from __future__ import annotations

import re
import time
from typing import Callable, Dict, Iterable, List, Sequence, Tuple

import torch

# device time of these host ops counts the kernels they and their children
# launched; an op nested in one of the same name is counted once
SUMMED_OPS = ("aten::cudnn_convolution", "aten::convolution_backward")


def kernel_base_name(name: str) -> str:
    """The function name of a demangled kernel name ('void ns::knn_kernel<...>(...)'
    -> 'knn_kernel'); the name itself where no form matches."""
    bare = name.replace("(anonymous namespace)", "")
    match = (re.search(r"::(\w+)\s*(?:<[^()]*>)?\(", bare)
             or re.match(r"void\s+(\w+)\s*(?:<[^()]*>)?\(", bare))
    return match.group(1) if match else name


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def idle_gaps(intervals: Sequence[Tuple[float, float]], start: float, stop: float
              ) -> List[Tuple[float, float]]:
    """The [start, stop) stretches in which no interval is running."""
    gaps, end = [], start
    for s, e in sorted(intervals):
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if stop > end:
        gaps.append((end, stop))
    return gaps


def _device_total(e) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        v = getattr(e, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def profile(fn: Callable[[], None], span_prefixes: Sequence[str]) -> Dict:
    """Run `fn` under the profiler (CPU and CUDA) with the card synchronised
    on both ends, and summarise: window and busy seconds, device events,
    device us by kernel function, by kernel name, and by the ops of
    `SUMMED_OPS`; host us by span (names starting with `span_prefixes`);
    device us idle, by the innermost span open on the host meanwhile."""
    cuda_on = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda_on:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if cuda_on:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    spans = [e for e in events if e.device_type != cuda and e.name.startswith(tuple(span_prefixes))]
    kernels = [e for e in events if e.device_type == cuda and not (
        getattr(e, "is_user_annotation", False) or e.name.startswith(tuple(span_prefixes)))]
    intervals = [(e.time_range.start, e.time_range.end) for e in kernels]
    by_function: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    calls: Dict[str, int] = {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        base = kernel_base_name(e.name)
        by_function[base] = by_function.get(base, 0.0) + us
        calls[base] = calls.get(base, 0) + 1
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    by_op: Dict[str, float] = {}
    for e in events:
        if e.device_type == cuda or e.name not in SUMMED_OPS:
            continue
        parent, nested = e.cpu_parent, False
        while parent is not None:
            if parent.name == e.name:
                nested = True
                break
            parent = parent.cpu_parent
        if not nested:
            by_op[e.name] = by_op.get(e.name, 0.0) + _device_total(e)
    span_us: Dict[str, float] = {}
    for e in spans:
        span_us[e.name] = span_us.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    # idle device time inside the traced window, by the innermost span open
    # on the host at the middle of each gap
    starts = [e.time_range.start for e in events if e.device_type != cuda]
    ends = [e.time_range.end for e in events if e.device_type != cuda]
    idle_by_span: Dict[str, float] = {}
    if intervals and starts:
        host_spans = sorted(((e.time_range.start, e.time_range.end, e.name) for e in spans),
                            key=lambda s: s[1] - s[0])
        for s, e in idle_gaps(intervals, min(starts), max(ends)):
            mid = 0.5 * (s + e)
            label = next((n for a, b, n in host_spans if a <= mid < b), "outside spans")
            idle_by_span[label] = idle_by_span.get(label, 0.0) + (e - s)
    return {"window_s": window_s, "busy_s": union_length(intervals) / 1e6,
            "device_events": len(kernels), "kernel_us": by_function, "kernel_calls": calls,
            "kernel_name_us": by_name, "op_device_us": by_op, "span_host_us": span_us,
            "idle_us_by_span": idle_by_span}


def breakdown(summary: Dict, top: int = 10) -> Dict[str, List]:
    """The result line's `breakdown`: the device operations that took most
    time and the idle device time by host span, in seconds."""
    ops = sorted(summary["kernel_name_us"].items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(summary["idle_us_by_span"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], us / 1e6] for n, us in ops],
            "idle_gaps": [[n, us / 1e6] for n, us in gaps]}
