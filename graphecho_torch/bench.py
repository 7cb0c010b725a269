"""Inference benchmark of the port: EchoNet-sized frames through the σ>0.5
path, the path the JAX package's `bench.py` times.

    python -m graphecho_torch.bench [--device cuda] [--batches 64,128,256,512]
                                    [--dtypes float32,bfloat16,int8]

The model is the camus config's FPN (ResNet50 [3,4,5,3], 112², one class)
with random weights from a seeded `torch.Generator`, served by
`serve.Predictor` in each dtype (int8: the PTQ backbone, the head in bf16).
For each dtype and batch, one JSON line:
  * `forward_ms`: one forward of the inference function on a resident input,
    the median of 5 runs of 20 forwards; on the card timed with CUDA events
    around the 20, on the CPU with the host clock (`timer` says which);
  * `frames_per_s` from it;
  * `peak_memory_gib` (card only) over those runs;
  * `request_ms` and `request_frames_per_s`: `Predictor.predict` of one
    batch of float32 frames from the host, `_prep` and the copies both ways
    included, the median of 5;
  * `gflop_per_frame` (counted on the meta device) and `bound_ms`, the
    least time the card could take for the batch: the backbone's and the
    head's operations over the data sheet's dense peak of the dtype each
    runs in (the inputs and outputs are a few MB: operations bound it).
TF32 is off, so float32 is float32. The last line is
{"metric": "echonet_seg_inference_frames_per_sec", "value", "unit", "dtype",
"batch", "device", "power_limit"}: the forward's frames/s in bf16 at batch
256 when that was run, else at the first dtype and batch run.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from graphecho_torch import config as C
from graphecho_torch.device import resolve_device

REPS, FORWARDS, WARMUP = 5, 20, 3
# H100 SXM dense peaks (NVIDIA data sheet), operations per second; float32
# is the rate outside the tensor cores (TF32 off)
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}


def power_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def forward_ms(fn: Callable[[], object], device: torch.device, reps: int, forwards: int,
               warmup: int) -> float:
    """Median over `reps` runs of `forwards` calls of `fn`, ms per call: CUDA
    events on the card, the host clock elsewhere."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(forwards):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / forwards)
        else:
            t0 = time.perf_counter()
            for _ in range(forwards):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / forwards)
    return statistics.median(times)


def request_ms(pred, frames: np.ndarray, reps: int) -> float:
    """Median host ms of `pred.predict(frames)` over `reps` requests."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        pred.predict(frames)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def fpn_flops(cfg: C.ExperimentConfig) -> Tuple[int, int]:
    """FLOPs (two per multiply-add) of one frame through the FPN's backbone
    and through its head, counted on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    from graphecho_torch.train.steps import build_fpn

    with torch.device("meta"):
        fpn = build_fpn(cfg).eval()
    x = torch.empty((1, cfg.model.in_channels, *cfg.data.img_crop), device="meta")
    with torch.no_grad():
        with FlopCounterMode(display=False) as count:
            feats = fpn.back_bone(x)
        backbone = count.get_total_flops()
        with FlopCounterMode(display=False) as count:
            fpn.head(feats)
    return backbone, count.get_total_flops()


def bound_ms(flops: Tuple[int, int], batch: int, dtype: str) -> float:
    """The least ms the card could take for `batch` frames: the backbone at
    `dtype`'s peak, the head at its own dtype's (bf16 behind int8)."""
    backbone, head = flops
    head_dtype = "bfloat16" if dtype == "int8" else dtype
    return batch * (backbone / PEAK_OPS[dtype] + head / PEAK_OPS[head_dtype]) * 1e3


def camus_fpn_weights(seed: int = 0):
    """The camus config and its FPN's state dict, random from `seed`."""
    from graphecho_torch.models.initializers import initialize
    from graphecho_torch.train.steps import build_fpn

    cfg = C.camus_echo_config()
    fpn = build_fpn(cfg)
    initialize(fpn, torch.Generator().manual_seed(seed))
    return cfg, fpn.state_dict()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: cuda (raises without a card)")
    ap.add_argument("--batches", default="64,128,256,512")
    ap.add_argument("--dtypes", default="float32,bfloat16,int8")
    args = ap.parse_args(argv)
    from graphecho_torch.serve import Predictor

    device = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, weights = camus_fpn_weights()
    flops = fpn_flops(cfg)
    h, w = cfg.data.img_crop
    card = power_limit() if device.type == "cuda" else None
    rows = []
    for dtype in args.dtypes.split(","):
        for batch in map(int, args.batches.split(",")):
            quant = dtype == "int8"
            pred = Predictor(cfg, weights, batch_size=batch, quantize=quant, device=device,
                             compute_dtype="bfloat16" if quant else dtype)
            frames = np.random.RandomState(0).rand(batch, h, w, 1).astype(np.float32)
            x = torch.from_numpy(frames).to(device)
            if device.type == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            with torch.inference_mode():
                ms = forward_ms(lambda: pred._infer(x), device, REPS, FORWARDS, WARMUP)
            peak = (torch.cuda.max_memory_allocated() / 2 ** 30
                    if device.type == "cuda" else None)
            req = request_ms(pred, frames, REPS)
            row = {"dtype": dtype, "batch": batch, "forward_ms": ms,
                   "frames_per_s": batch / ms * 1e3, "peak_memory_gib": peak,
                   "request_ms": req, "request_frames_per_s": batch / req * 1e3,
                   "weight_bytes": pred.weight_bytes(),
                   "gflop_per_frame": sum(flops) / 1e9, "bound_ms": bound_ms(flops, batch, dtype),
                   "timer": "cuda events" if device.type == "cuda" else "host clock",
                   "device": str(device), "card": card}
            rows.append(row)
            print(json.dumps(row), flush=True)
            del pred, x
            if device.type == "cuda":
                torch.cuda.empty_cache()
    head = next((r for r in rows if (r["dtype"], r["batch"]) == ("bfloat16", 256)), rows[0])
    print(json.dumps({"metric": "echonet_seg_inference_frames_per_sec",
                      "value": head["frames_per_s"], "unit": "frames/s",
                      "dtype": head["dtype"], "batch": head["batch"],
                      "device": torch.cuda.get_device_name(device) if device.type == "cuda"
                      else "cpu", "power_limit": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
