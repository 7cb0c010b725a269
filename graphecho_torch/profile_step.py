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
switch those model options on. Prints one JSON object: the steady step time,
the peak device memory of the timed steps, the device's busy time per step
(the union of its kernel intervals) and idle share, the number of kernel
launches per step, the
kNN-graph kernel's and the pairwise-MLP kernels' launches and device time per
step, the host time in each phase of the step and the device time by kernel
name. It needs a CUDA device and fails without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import statistics
import time
from typing import Callable, Dict, List, Tuple

import torch

from graphecho_torch.config import ExperimentConfig, camus_echo_config, cardiac_uda_config
from graphecho_torch.data.synthetic import SyntheticEchoData
from graphecho_torch.models.vig import pvig_s
from graphecho_torch.train.trainer import Trainer


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


def _step_fn(recipe: str, n: int, **model_options) -> Callable[[int], None]:
    """Step i (< n) of the recipe, its inputs made beforehand; `model_options`
    replace fields of its `ModelConfig` (remat, fused_fpn_forwards)."""
    if recipe == "pvig_s":
        model = pvig_s(n_classes=1000).eval()
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


def profile(recipe: str, steps: int = 5, warmup: int = 2, top: int = 15,
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
        "device_ms_by_kernel": [{"name": n[:120], "ms_per_step": us / 1e3 / steps,
                                 "share": us / total_us} for n, us in ranked],
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--recipe", choices=sorted(RECIPES) + ["pvig_s", *SERVE_RECIPES],
                        default="camus")
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--warmup", type=int, default=2)
    parser.add_argument("--remat", action="store_true",
                        help="recompute the backbone blocks' activations in the backward")
    parser.add_argument("--fused-fpn", action="store_true",
                        help="one FPN call over the source, target and clip frames")
    args = parser.parse_args()
    options = {k: True for k, on in (("remat", args.remat),
                                     ("fused_fpn_forwards", args.fused_fpn)) if on}
    print(json.dumps(profile(args.recipe, args.steps, args.warmup, **options)), flush=True)


if __name__ == "__main__":
    main()
