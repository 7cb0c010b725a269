"""Where a step's time goes on the card.

    python -m graphecho_torch.profile_step --recipe camus --steps 5

A step is one train step of a recipe's trainer at full width
(`camus_echo_config()` or `cardiac_uda_config()`; `camus_temporal` and
`cardiac_full` add the temporal branch, and the cycle loss to the latter, at
batch 8 + 8), or, for `--recipe pvig_s`,
one eval forward of `pvig_s(n_classes=1000)` on 32 random 224² images, or,
for `--recipe serve_float32` / `serve_bfloat16` / `serve_int8`, one forward
of the camus Predictor's inference function (`serve.py`, random weights, as
`python -m graphecho_torch.bench` builds it) on a resident batch of 256. Runs
warm-up steps, then times `--steps` steps with the host clock (synchronized)
and traces the same steps with `torch.profiler`. `--remat` and `--fused-fpn`
switch those model options on; `--bf16` computes the step's FPN and TGCN (or
pvig_s) in bf16 (`ModelConfig.compute_dtype`); `--deterministic` turns on
deterministic algorithms first (`device.deterministic_algorithms`, as
`train_rehearsal` does), to see what they cost. Prints one JSON object: the
steady step time, the peak device memory of the timed steps, the device's
busy time per step (the union of its kernel intervals) and idle share, the
number of kernel launches per step, the kNN-graph kernel's and the
pairwise-MLP kernels' launches and device time per step, the host time in
each phase of the step; by the innermost `step.*` span open at the time
(`by_span`), the device's idle time, the CUDA launch calls and the
host-device synchronisations per step; every CUDA API call
by name; and the 40 kernel names and host ops (by the kernels each launched
itself) with the most device time. It needs a CUDA device and fails
without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import statistics
import time
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from graphecho_torch.config import ExperimentConfig, camus_echo_config, cardiac_uda_config
from graphecho_torch.data.synthetic import SyntheticEchoData
from graphecho_torch.device import deterministic_algorithms
from graphecho_torch.models.vig import pvig_s
from graphecho_torch.train.trainer import Trainer
from graphecho_torch.utils.profiling import innermost_spans


def _batch_8_8(cfg: ExperimentConfig) -> ExperimentConfig:
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, batch_size=8,
                                                             target_batch_mult=1))


# the JAX package's profile recipes (`scripts/profile_train_step.py`): the
# paper's configs, and their full branch sets at batch 8 + 8 (clips 4 + 4)
RECIPES: Dict[str, Callable[[], ExperimentConfig]] = {
    "camus": camus_echo_config,
    "cardiac": cardiac_uda_config,
    "camus_temporal": lambda: _batch_8_8(camus_echo_config(temporal_graph=True)),
    "cardiac_full": lambda: _batch_8_8(cardiac_uda_config(temporal_graph=True, cyc_loss=True)),
}
PVIG_BATCH = 32
SERVE_BATCH = 256
SERVE_RECIPES = ("serve_float32", "serve_bfloat16", "serve_int8")
# the kernels of `csrc/pairwise_mlp.cu`; the last four are the names its
# forward and backward had before, so an older tree can be profiled with this
# script too
PAIRWISE_KERNELS = ("pairwise_fwd_kernel", "pairwise_bwd_kernel", "pairwise_finish_kernel",
                    "fwd_kernel", "bwd_da_kernel", "bwd_db_kernel", "finish_kernel")
# CUDA API calls (`cuda*`, `cu*`) that put work on a stream (cuDNN's batch
# norms launch cooperative kernels), and those that make the host wait for
# the card
LAUNCH_CALLS = re.compile(r"cudaLaunchKernel|cudaLaunchCooperativeKernel|cuLaunchKernel"
                          r"|cudaMemcpy\w*Async|cudaMemset\w*Async")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def kernel_base_name(name: str) -> str:
    """The function name of a demangled kernel name: `fwd_kernel` of
    'void (anonymous namespace)::fwd_kernel(float const*, ...)',
    `pairwise_bwd_kernel` of '... pairwise_bwd_kernel<true>(...)',
    `pairwise_fwd_kernel` of '...::pairwise_fwd_kernel<(anonymous
    namespace)::FwdTile<4, 4, 8, 8, 4, 16, 3> >(...)'; the name itself where
    no form matches."""
    bare = name.replace("(anonymous namespace)", "")
    match = (re.search(r"::(\w+)\s*(?:<[^()]*>)?\(", bare)
             or re.match(r"void\s+(\w+)\s*(?:<[^()]*>)?\(", bare))
    return match.group(1) if match else name


def _busy_us(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def by_span(spans: Sequence[Tuple[float, float, str]],
            calls: Sequence[Tuple[float, float, str]],
            busy: Sequence[Tuple[float, float]]) -> Dict[str, Dict]:
    """The device's idle time, the launch calls (`LAUNCH_CALLS`) and the
    synchronisations (`SYNC_CALLS`) of a trace, by the innermost span open
    at the time (`utils/profiling.py::innermost_spans`): an idle stretch by
    the span open at its middle, a call by the span open at its start,
    whatever thread made it. `spans` are the step's (start, end, name),
    `calls` the CUDA API calls (start, end, name), `busy` the
    device events' (start, end), all in µs on the profiler's clock. Only
    what lies between the first span's start and the last one's end counts,
    so the synchronisations that open and close a traced window are left
    out. Returns {"idle_us": {span: µs}, "launches": {span: count},
    "syncs": {span: [count, host µs]}}."""
    out: Dict[str, Dict] = {"idle_us": {}, "launches": {}, "syncs": {}}
    if not spans:
        return out
    lo, hi = min(s for s, _, _ in spans), max(e for _, e, _ in spans)
    gaps, end = [], lo
    for s, e in sorted(busy):
        if s >= hi:
            break
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if end < hi:
        gaps.append((end, hi))
    for (s, e), name in zip(gaps, innermost_spans([0.5 * (s + e) for s, e in gaps], spans)):
        out["idle_us"][name] = out["idle_us"].get(name, 0.0) + (e - s)
    calls = [c for c in calls if lo <= c[0] < hi]
    for (s, e, call), name in zip(calls, innermost_spans([c[0] for c in calls], spans)):
        if LAUNCH_CALLS.match(call):
            out["launches"][name] = out["launches"].get(name, 0) + 1
        elif call in SYNC_CALLS:
            n, us = out["syncs"].get(name, [0, 0.0])
            out["syncs"][name] = [n + 1, us + (e - s)]
    return out


def _step_fn(recipe: str, n: int, **model_options) -> Callable[[int], None]:
    """Step i (< n) of the recipe, its inputs made beforehand; `model_options`
    replace fields of its `ModelConfig` (remat, fused_fpn_forwards,
    compute_dtype)."""
    if recipe == "pvig_s":
        bf16 = model_options.get("compute_dtype") == "bfloat16"
        model = pvig_s(n_classes=1000, dtype=torch.bfloat16 if bf16 else None).eval()
        x = torch.randn(PVIG_BATCH, 3, 224, 224, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(0))

        def forward(i: int) -> None:
            with torch.no_grad():
                model(x)
        return forward
    if recipe in SERVE_RECIPES:
        from graphecho_torch.bench import camus_fpn_weights
        from graphecho_torch.serve import Predictor

        dtype = recipe.removeprefix("serve_")
        cfg, weights = camus_fpn_weights()
        pred = Predictor(cfg, weights, batch_size=SERVE_BATCH, quantize=dtype == "int8",
                         compute_dtype="bfloat16" if dtype == "int8" else dtype)
        x = torch.rand((SERVE_BATCH, *cfg.data.img_crop, 1), device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(0))

        def serve(i: int) -> None:
            with torch.inference_mode():
                pred._infer(x)
        return serve
    cfg = RECIPES[recipe]()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **model_options))
    trainer = Trainer(cfg)
    trainer.init_state()
    data = SyntheticEchoData(cfg, seed=0)
    batches = [data.train_batch() for _ in range(n)]
    return lambda i: trainer._train_step(trainer.state, batches[i])


def profile(recipe: str, steps: int = 5, warmup: int = 2, top: int = 40,
            **model_options) -> Dict:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    step = _step_fn(recipe, warmup + steps, **model_options)
    for i in range(warmup):
        step(i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    host_ms = []
    for i in range(warmup, warmup + steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(i)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)

    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(warmup, warmup + steps):
            step(i)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / steps

    # device events, without the device-side copies of `record_function` spans
    # (`step.*`, torch.optim's `Optimizer.step#...`): a span is no kernel, and
    # it would count the gaps between its kernels as busy
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not (e.is_user_annotation or e.name.startswith("step."))]
    intervals = [(e.time_range.start, e.time_range.end) for e in kernels]
    busy_ms = _busy_us(intervals) / 1e3 / steps
    by_name: Dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    total_us = sum(by_name.values()) or 1.0
    # host time in each phase of the step (`annotate` spans of
    # graphecho_torch.train.steps and the graph head); a phase that
    # synchronizes waits for the device inside its span
    host = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    step_spans = [(e.time_range.start, e.time_range.end, e.name) for e in host
                  if e.name.startswith("step.")]
    spans: Dict[str, float] = {}
    for s, e, name in step_spans:
        spans[name] = spans.get(name, 0.0) + (e - s)
    calls = [(e.time_range.start, e.time_range.end, e.name) for e in host
             if e.name.startswith("cu")]
    # every CUDA API call by name: where the launch calls by
    # span do not sum to the device events, the one `LAUNCH_CALLS` misses
    runtime_calls: Dict[str, int] = {}
    for _, _, name in calls:
        runtime_calls[name] = runtime_calls.get(name, 0) + 1
    attributed = by_span(step_spans, calls, intervals)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    # device time by the host op that launched it (its kernels, not its children's)
    by_op: Dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.self_device_time_total > 0:
            by_op[e.name] = by_op.get(e.name, 0.0) + e.self_device_time_total
    ranked_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    knn = [e for e in kernels if "knn" in e.name]
    pairwise: Dict[str, float] = {}
    n_pairwise = 0
    for e in kernels:
        name = kernel_base_name(e.name)
        if name in PAIRWISE_KERNELS:
            n_pairwise += 1
            pairwise[name] = pairwise.get(name, 0.0) + (e.time_range.end - e.time_range.start)
    return {
        "recipe": recipe, "model_options": model_options,
        "device": torch.cuda.get_device_name(0), "steps": steps,
        "deterministic_algorithms": torch.are_deterministic_algorithms_enabled(),
        "cublas_workspace_config": os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
        "step_ms": statistics.median(host_ms), "step_ms_all": host_ms,
        # the most device memory the timed steps held at once
        "peak_memory_gib": peak_gib,
        "traced_step_ms": traced_ms, "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / traced_ms),
        "kernel_launches_per_step": len(kernels) / steps,
        # the kNN-graph kernel (`csrc/knn.cu`), every kernel whose name holds "knn"
        "knn_kernels_per_step": len(knn) / steps,
        "knn_device_ms": sum(e.time_range.end - e.time_range.start for e in knn) / 1e3 / steps,
        # the pairwise-MLP kernels (`csrc/pairwise_mlp.cu`), by function name
        "pairwise_kernels_per_step": n_pairwise / steps,
        "pairwise_device_ms": sum(pairwise.values()) / 1e3 / steps,
        "pairwise_device_ms_by_kernel": {k: us / 1e3 / steps for k, us in sorted(pairwise.items())},
        "host_ms_by_phase": {k: us / 1e3 / steps for k, us in sorted(spans.items())},
        "idle_ms_by_span": {k: us / 1e3 / steps
                            for k, us in sorted(attributed["idle_us"].items())},
        "launches_by_span": {k: n / steps for k, n in sorted(attributed["launches"].items())},
        # [synchronisations, host ms] per step
        "syncs_by_span": {k: [n / steps, us / 1e3 / steps]
                          for k, (n, us) in sorted(attributed["syncs"].items())},
        "runtime_calls_per_step": {k: n / steps for k, n in sorted(runtime_calls.items())},
        "device_ms_by_kernel": [{"name": n[:120], "ms_per_step": us / 1e3 / steps,
                                 "share": us / total_us} for n, us in ranked],
        "device_ms_by_op": [{"name": n[:120], "ms_per_step": us / 1e3 / steps}
                            for n, us in ranked_ops],
    }


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--recipe", choices=sorted(RECIPES) + ["pvig_s", *SERVE_RECIPES],
                        default="camus")
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--warmup", type=int, default=2)
    parser.add_argument("--remat", action="store_true",
                        help="recompute the backbone blocks' activations in the backward")
    parser.add_argument("--fused-fpn", action="store_true",
                        help="one FPN call over the source, target and clip frames")
    parser.add_argument("--bf16", action="store_true",
                        help="compute the FPN and the TGCN (or pvig_s) in bf16")
    parser.add_argument("--deterministic", action="store_true",
                        help="deterministic algorithms and a fixed cuBLAS workspace, "
                             "as train_rehearsal runs")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.deterministic:
        deterministic_algorithms("cuda")  # before the recipe's first CUDA call
    options = {k: True for k, on in (("remat", args.remat),
                                     ("fused_fpn_forwards", args.fused_fpn)) if on}
    if args.bf16:
        options["compute_dtype"] = "bfloat16"
    print(json.dumps(profile(args.recipe, args.steps, args.warmup, **options)), flush=True)


if __name__ == "__main__":
    main()
