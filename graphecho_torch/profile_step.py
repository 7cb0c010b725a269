"""Where a train step's time goes on the card.

    python -m graphecho_torch.profile_step --recipe camus --steps 5

Builds the recipe's trainer at full width (`camus_echo_config()` or
`cardiac_uda_config()`), runs warm-up steps, then times `--steps` steps with
the host clock (synchronized) and traces the same steps with
`torch.profiler`. Prints one JSON object: the steady step time, the device's
busy time per step (the union of its kernel intervals) and idle share, the
number of kernel launches per step, the host time in each phase of the step
and the device time by kernel name. It needs a CUDA device and fails without
one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Dict, List, Tuple

import torch

from graphecho_torch.config import camus_echo_config, cardiac_uda_config
from graphecho_torch.data.synthetic import SyntheticEchoData
from graphecho_torch.train.trainer import Trainer

RECIPES = {"camus": camus_echo_config, "cardiac": cardiac_uda_config}


def _busy_us(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def profile(recipe: str, steps: int = 5, warmup: int = 2, top: int = 15) -> Dict:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = RECIPES[recipe]()
    trainer = Trainer(cfg)
    trainer.init_state()
    data = SyntheticEchoData(cfg, seed=0)
    batches = [data.train_batch() for _ in range(warmup + steps)]
    for batch in batches[:warmup]:
        trainer._train_step(trainer.state, batch)

    host_ms = []
    for batch in batches[warmup:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer._train_step(trainer.state, batch)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in batches[warmup:]:
            trainer._train_step(trainer.state, batch)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / steps

    # device events, without the device-side copies of the `step.*` spans
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("step.")]
    intervals = [(e.time_range.start, e.time_range.end) for e in kernels]
    busy_ms = _busy_us(intervals) / 1e3 / steps
    by_name: Dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    total_us = sum(by_name.values()) or 1.0
    # host time in each phase of the step (`record_function` spans of
    # graphecho_torch.train.steps); a phase that synchronizes waits for the
    # device inside its span
    spans: Dict[str, float] = {}
    for e in prof.events():
        if e.name.startswith("step.") and e.device_type == torch.autograd.DeviceType.CPU:
            spans[e.name] = spans.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "recipe": recipe, "device": torch.cuda.get_device_name(0), "steps": steps,
        "step_ms": statistics.median(host_ms), "step_ms_all": host_ms,
        "traced_step_ms": traced_ms, "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / traced_ms),
        "kernel_launches_per_step": len(kernels) / steps,
        "host_ms_by_phase": {k: us / 1e3 / steps for k, us in sorted(spans.items())},
        "device_ms_by_kernel": [{"name": n[:120], "ms_per_step": us / 1e3 / steps,
                                 "share": us / total_us} for n, us in ranked],
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--recipe", choices=sorted(RECIPES), default="camus")
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--warmup", type=int, default=2)
    args = parser.parse_args()
    print(json.dumps(profile(args.recipe, args.steps, args.warmup)), flush=True)


if __name__ == "__main__":
    main()
