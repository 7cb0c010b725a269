"""Smoke run of graphecho_torch on one NVIDIA GPU: builds the CUDA kernels,
holds each against its plain PyTorch version, drives the CAMUS->EchoNet and
CardiacUDA train steps at full width, with every branch (temporal TGCN,
64-frame cycle loss) too, serves both trained models in bf16, f32 and int8,
and runs the pvig_s ViG classifier.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. environment: torch/CUDA versions, TF32 switched off, the card's name and
     power limit from nvidia-smi;
  2. build: `nvcc` of every source in graphecho_torch/csrc, all at once;
  3. kernels: the pairwise-MLP forward (`launch_fwd`, b2 added in the
     kernel) and backward (`launch_bwd`: dA, dB, dw2, db2) against the plain
     version at (112,112,512), (560,560,512) and a ragged (70,50,40): forward
     atol 1e-4, gradients rtol/atol 1e-3 (the JAX package's own bounds), two
     runs of each bit-identical in every output; CUDA-event times (median of
     20 after warm-up) beside the least time the card could take. Then
     `kernel_exact` lines: integer inputs whose sums every version computes
     exactly (many a+b exactly 0), where the forward (also at 1x112x513) and
     the backward must equal the plain version bit for bit; and
     `kernel_nan` lines: NaN in one row of a and one of b at 112^2 and 560^2,
     where the forward must have NaN exactly where the plain version has it
     (as `jnp.maximum` gives it) and agree elsewhere within 1e-4, with the
     backward's NaN pattern beside the plain version's (recorded, not held);
  3b. knn: the kNN-graph kernel against its plain version at each pvig_s
     Grapher shape (batch 32, with the Grapher's relative-position bias), a
     ragged self graph without bias, a normalize=False case with k=45 and
     a per-image bias, the kernel's edges: k=1, k=64, M=k, and one query
     of one image, and the TGCN's frame-to-hidden-state graph (8 clips x 64
     nodes x 64 keys x 256, k=9) on random keys and on the all-zero keys of
     its first frame, where every distance ties and the neighbours must be
     columns 0..8 in order with no allowance. Neighbours must equal the plain
     version's in order; a position where they differ passes only as a near
     tie, the two picks' distances recomputed in float64 within 1e-5. Two
     runs bit-identical; times and bound as above. Then `knn_nan` lines: one
     NaN feature in a query row and one in a key row at the TGCN's shape and
     at Graphers 0-1 (with their bias): the NaN row takes columns 0..k-1 and
     the NaN key is nobody's neighbour, as in the plain version, the other
     rows within the near-tie rule;
  3c. knn ties: the kNN kernel on inputs whose distances are exact (one-hot
     and integer rows, all-zero rows with and without the Grapher's bias), key
     rows 3, 7 and 9 one row three times, and integer rows over 1,000 keys
     whose copies sit at columns 3, 500 and 999, in three key tiles:
     neighbours equal to the plain version's in order with no near-tie
     allowance, the copies of key 3 in column order;
  4. reference: one train step of a small config on the card against the
     same step on the CPU (plain versions), losses within rtol 1e-3;
  4b. temporal reference: the same with the temporal branch (momentum-queue
     TGCN) and the cycle loss on; the dropouts are the identity and both runs
     take one cycle start, so every loss key, `temporal_graph_loss` and
     `cyc_loss` included, must agree within rtol 1e-3, and the new queues
     within 1e-4, moved in the batch's columns only; the kNN kernel runs on
     the train path there (one launch a frame);
  5. camus: `train_camus_echo` with the paper's `camus_echo_config()`
     (ResNet50, 112², source batch 8, target batch 168, 112 nodes per class)
     for 3 steps and validation, launch counters zeroed just before and read
     just after; the trainer's state is saved for the serve phase; then
     steady-state step time and peak memory;
  6. cardiac: one step of `train_cardiac_uda` at full width (VGG16, 256²,
     five classes -> a 560x560 affinity), counted and saved the same way;
  6b. cardiac_full: one step and validation of `train_cardiac_uda(
     temporal_graph=True, cyc_loss=True)` at full width (batch 8+8, clips 4+4
     of 8 frames, one 64-frame cycle clip), counted the same way: 8 kNN
     launches (one a frame) and 2 of each pairwise-MLP entry (two GModule
     calls), every loss finite, `temporal_graph_loss` and `cyc_loss` not 0,
     the queues moved in no column but those the batch's `update_idx_*` name
     (in none: the paper's recipe has no clustering); then the steady step
     time (median of 2) and peak memory;
  6c. camus_temporal: one step of `train_camus_echo(temporal_graph=True)`
     (112², target batch 168: the 4x4 pyramid level pooled up to the 8x8
     grid), counted the same way;
  6d. serve: the two saved states served by `serve.Predictor` at batch 256,
     the launch counters zeroed before and read after (the serving path
     launches no hand kernel: 0 of each). camus (ResNet50, 112², one class)
     through `Predictor.from_checkpoint`: bf16, f32 and int8 Predictors on 300
     frames (a ragged second batch), masks of the right shape, bf16 vs f32
     and int8 vs both float masks agreeing on more than 98% of pixels; every
     int8 layer's int32 accumulators from the `_int_mm` route equal to the
     float64 plain route's bit for bit on one batch of 256; uint8 100x90
     frames through the resize; an empty request; `predict_video` of 128
     frames (split over the one card) equal to `predict` in bf16 and f32;
     `export_compiled` -> `load_exported` masks equal to the live
     Predictor's, bf16 and int8; a hot swap changes the masks and swapping
     back restores them; the int8 Predictor refuses a swap. cardiac (VGG16,
     256², five classes): the same three Predictors, agreement and the
     accumulators (16 frames). `serve_rates` lines: per config and dtype, the
     inference function's device frames/s at batch 256 (CUDA events), one
     request's frames/s from the host, peak memory, weight bytes;
  6e. cardiac_real: the real-data trainer. A CardiacUDA-shaped tree of
     `.nii.gz` volumes (Site_G, Site_R, Site_R_full; view 4; non-square
     288x352 frames, 64 a volume; filled organ labels, contours for
     Site_R_full) written with `data/formats.write_nifti`, indexed by
     `python -m graphecho_torch.data.infos`. `real_training.run_cardiac_uda`
     with the CLI's defaults (batch 8: 16 source frames, two steps an epoch)
     and every branch, for two epochs, counted as above: 2, 2 and 8 launches
     a step, every loss finite, `temporal_graph_loss` and `cyc_loss` not 0,
     the three validation dices finite (the Site_R_full video test fills its
     contours with `fill_poly`), the checkpoint tagged with the video test's
     dice. Then a save and a restore into a fresh Trainer on the card, bit-equal
     in every tensor and the CUDA generator, and one more step from each with
     bit-equal losses. Then `python -m graphecho_torch.train_cardiac_uda`
     as a subprocess, SIGTERMed at the end of epoch 0: it exits 0 with a
     checkpoint at step 2 + 1; run again, it resumes from there and ends
     three epochs later. Printed: the real-data step ms beside the synthetic
     cardiac_full step of this run, the loader's wait per step, peak memory,
     the checkpoint's size and its save and restore times;
  7. vig reference: a small DeepGCN on the card (kNN kernel) and on the CPU
     (plain kNN) from the same weights and images, logits within rtol 1e-3 /
     atol 1e-4;
  8. vig: `pvig_s(n_classes=1000)` at 224², eval forwards at batch 4 (the
     reference's smoke) and 32, then one train-mode forward with a backward of
     a cross-entropy at batch 32; the kNN launch counter zeroed before each
     forward and read after it (12 Graphers, 12 launches); steady eval
     images/s and peak memory.
Then the `kernels` summary line, each kernel at the shape the cardiac_full
path gives it (launches: per cardiac_full step, and in `launches_by_path` per
path driven, `cardiac_real step` and `serve` among them), the nvidia-smi
line, and last
{"ok": true, "device": {...}}. Any failure raises and the exit code is not 0;
without a CUDA device the script exits 1 before printing any result.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12
LOSS_KEYS = ("seg_loss", "dis_loss", "node_loss", "mat_loss_aff", "mat_loss_qu",
             "loss_adv_p2", "loss_adv_p3", "loss_adv_p4", "loss_adv_p5", "total_loss")
KERNEL_SHAPES = ((112, 112, 512), (560, 560, 512), (70, 50, 40))
# what the cardiac_full path gives the pairwise-MLP kernels (5 classes x 112 nodes)
MAIN_SHAPE = (560, 560, 512)
# what pvig_s's Graphers give the kNN kernel at batch 32: (Graphers, N queries,
# M keys or None for a self graph, C, k * dilation)
KNN_BATCH = 32
KNN_SHAPES = (("0-1", 3136, 196, 80, 9), ("2-3", 784, 196, 160, 9),
              ("4-7", 196, None, 400, 18), ("8-9", 196, None, 400, 27),
              ("10-11", 49, None, 640, 27))
# what the TGCN gives the kNN kernel per frame of a cardiac_full step: 2 x 4
# clips, the 8x8 node grid against the hidden state, 256 channels, k 9
TGCN_KNN = (8, 64, 64, 256, 9)
KNN_TIE_TOL = 1e-5
PVIG_S_PARAMS = 27_251_912
# the cardiac_real fixture: native frames (H, W, frames), non-square as real
# CardiacUDA frames may be; patients per site (Site_G: 36 give 32 train ids,
# two source batches of 16 an epoch)
REAL_SHAPE = (288, 352, 64)
# the serve phase: the Predictor's batch, a request of two batches (the
# second ragged), and the mask agreement held between dtypes
# (`tests/test_quant.py`'s bar). The states saved after 3 and 1 steps are
# barely trained: many of their logits sit near 0, where int8's error flips
# pixels, so int8 is held to the bar where |logit_f32| > SERVE_CONFIDENT and
# on every pixel once camus has trained SERVE_MORE_STEPS further.
SERVE_BATCH, SERVE_FRAMES, SERVE_AGREE = 256, 300, 0.98
SERVE_CONFIDENT, SERVE_MORE_STEPS = 0.5, 27
REAL_PATIENTS = {"Site_G": 36, "Site_R": 4, "Site_R_full": 2}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of `reps` CUDA-event timings of one call, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(ops: float, nbytes: float):
    """The least time the card could take: the larger of the operations over
    the FP32 peak and the bytes over the memory rate."""
    t_ops, t_bytes = ops / PEAK_FP32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# -------------------------------------------------------------------- phases
def phase_build():
    from graphecho_torch.ops import cuda_build

    sources = sorted(p.stem for p in cuda_build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        list(pool.map(cuda_build.build, sources))
    emit("build", sources=sources, seconds=time.perf_counter() - t0,
         per_source=dict(cuda_build.BUILD_SECONDS))


def bwd_work(n1: int, n2: int, k: int):
    """(operations, bytes) the pairwise-MLP backward needs at least: per
    (i, j, k) the add, the comparison and one accumulation each into S_A and
    S_B; per row of a or b and column k the multiply-add of dw2 and the
    scaling by w2; per (i, j) the add of db2. Each input (a, b, w2, g) read
    once and each output (dA, dB, dw2, db2) written once."""
    ops = 4 * n1 * n2 * k + 3 * (n1 + n2) * k + n1 * n2
    return ops, 4 * (2 * (n1 * k + n2 * k + k) + n1 * n2 + 1)


def check_backward(what: str, a, b, w2, g, exact: bool):
    """`launch_bwd` against the plain formulas: rtol/atol 1e-3, or equal bit
    for bit where `exact`; two runs bit-identical in all four outputs.
    Returns ({output: max abs err}, the four outputs)."""
    from graphecho_torch.ops import pairwise_mlp as pm

    got = pm.launch_bwd(a, b, w2, g)
    want = pm.pairwise_mlp_backward_reference(a, b, w2, g)
    errs = {}
    for name, x, w in zip(("dA", "dB", "dw2", "db2"), got, want):
        w = w.reshape(x.shape)
        diff = (x - w).abs()
        ok = torch.equal(x, w) if exact else bool((diff <= 1e-3 + 1e-3 * w.abs()).all())
        check(ok, f"{name} {what}: max abs err {diff.max().item()}"
                  + (" on exact inputs" if exact else ""))
        errs[name] = diff.max().item()
    again = pm.launch_bwd(a, b, w2, g)
    check(all(torch.equal(x, y) for x, y in zip(got, again)),
          f"backward {what}: two runs differ in their bits")
    return errs, got


def check_forward(what: str, a, b, w2, b2, exact: bool):
    """`launch_fwd` (b2 added in the kernel) against the plain version: atol
    1e-4, or equal bit for bit where `exact`; two runs bit-identical. Returns
    (max abs err, the output)."""
    from graphecho_torch.ops import pairwise_mlp as pm

    got = pm.launch_fwd(a, b, w2, b2)
    want = pm.pairwise_mlp(a, b, w2, b2)
    err = (got - want).abs().max().item()
    ok = torch.equal(got, want) if exact else err <= 1e-4
    check(ok, f"forward {what}: max abs err {err}" + (" on exact inputs" if exact else ""))
    check(torch.equal(got, pm.launch_fwd(a, b, w2, b2)),
          f"forward {what}: two runs differ in their bits")
    return err, got


def integer_inputs(n1: int, n2: int, k: int, gen: torch.Generator):
    """a, b in [-4, 4] (many a+b exactly 0), w2 in [-2, 2], g in [-3, 3]: every
    sum stays below 2^24, so each version computes it exactly."""
    def ints(lo, hi, *shape):
        return torch.randint(lo, hi + 1, shape, device="cuda", generator=gen).float()

    return ints(-4, 4, n1, k), ints(-4, 4, n2, k), ints(-2, 2, k), ints(-3, 3, n1, n2)


def nan_pattern(x: torch.Tensor, want: torch.Tensor):
    """(NaN where `want` has NaN and nowhere else, largest abs difference
    elsewhere)."""
    same = torch.equal(torch.isnan(x), torch.isnan(want))
    rest = ~torch.isnan(want)
    diff = (x[rest] - want[rest]).abs().max().item() if bool(rest.any()) else 0.0
    return same, diff


def phase_kernels():
    """Each kernel against the plain version on the card; returns the rows of
    the `kernels` line at the main path's shape."""
    from graphecho_torch.ops import pairwise_mlp as pm

    rows = {}
    for n1, n2, k in KERNEL_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(n1 * 7 + k)
        a, b = (torch.randn(n, k, device="cuda", generator=gen) for n in (n1, n2))
        w2 = torch.randn(k, device="cuda", generator=gen)
        b2 = torch.tensor(0.2, device="cuda")
        g = torch.randn(n1, n2, device="cuda", generator=gen)

        err_fwd, _ = check_forward(f"{n1}x{n2}x{k}", a, b, w2, b2, exact=False)
        errs, _ = check_backward(f"{n1}x{n2}x{k}", a, b, w2, g, exact=False)

        # forward: per (i, j, k) a+b, relu, *w2, +; per (i, j) + b2
        in_bytes = 4 * (n1 * k + n2 * k + k + 1)
        kernels = {
            "pairwise_mlp_fwd": (lambda: pm.launch_fwd(a, b, w2, b2),
                                 lambda: pm.pairwise_mlp(a, b, w2, b2),
                                 (4 * n1 * n2 * k + n1 * n2, in_bytes + 4 * n1 * n2), err_fwd,
                                 "graphecho_tpu/ops/pallas/pairwise_mlp_kernel.py:37"),
            "pairwise_mlp_bwd": (lambda: pm.launch_bwd(a, b, w2, g),
                                 lambda: pm.pairwise_mlp_backward_reference(a, b, w2, g),
                                 bwd_work(n1, n2, k), max(errs.values()),
                                 "graphecho_tpu/ops/pallas/pairwise_mlp_kernel.py:56,91"),
        }
        for name, (kernel, plain, (ops, nbytes), err, replaces) in kernels.items():
            # compare two versions inside one call, in turns
            plain_ms = cuda_ms(plain)
            ms = cuda_ms(kernel)
            ms = min(ms, cuda_ms(kernel))
            plain_ms = min(plain_ms, cuda_ms(plain))
            bound_ms, bound_by = bound(ops, nbytes)
            emit("kernel", name=name, shape=[n1, n2, k], max_abs_err=err,
                 errors=errs if name == "pairwise_mlp_bwd" else None, ms=ms,
                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, deterministic=True)
            if (n1, n2, k) == MAIN_SHAPE:
                rows[name] = {"name": name, "shape": [n1, n2, k], "route": "cuda",
                              "source": "graphecho_torch/csrc/pairwise_mlp.cu",
                              "replaces": replaces, "launches": 0, "max_abs_err": err,
                              "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by, "library_ms": None}

    # integer inputs: every version computes each sum exactly, so the kernels
    # must equal the plain version bit for bit
    for n1, n2, k in ((560, 560, 512), (70, 50, 40), (1, 112, 513)):
        gen = torch.Generator(device="cuda").manual_seed(n1 + 3 * k)
        a, b, w2, g = integer_inputs(n1, n2, k, gen)
        zeros = int(((a[:, None, :] + b[None, :, :]) == 0).sum())
        b2 = torch.tensor(0.25, device="cuda")
        _, out = check_forward(f"{n1}x{n2}x{k} exact", a, b, w2, b2, exact=True)
        emit("kernel_exact", name="pairwise_mlp_fwd", shape=[n1, n2, k], equal=True,
             max_abs_err=0.0, zero_sums=zeros, deterministic=True,
             max_abs_out=out.abs().max().item())
        if n1 == 1:  # the backward's cases stay as they were
            continue
        errs, got = check_backward(f"{n1}x{n2}x{k} exact", a, b, w2, g, exact=True)
        emit("kernel_exact", name="pairwise_mlp_bwd", shape=[n1, n2, k], equal=True,
             max_abs_err=max(errs.values()), zero_sums=zeros, deterministic=True,
             max_abs_dw2=got[2].abs().max().item())

    # NaN in one row of a and one row of b: the forward has NaN exactly where
    # the plain version (and jnp.maximum in the JAX package) has it; the
    # backward's pattern is recorded beside the plain version's
    for n1, n2, k in ((112, 112, 512), (560, 560, 512)):
        gen = torch.Generator(device="cuda").manual_seed(n1 + 5 * k)
        a, b = (torch.randn(n, k, device="cuda", generator=gen) for n in (n1, n2))
        w2 = torch.randn(k, device="cuda", generator=gen)
        g = torch.randn(n1, n2, device="cuda", generator=gen)
        b2 = torch.tensor(0.2, device="cuda")
        a[5, 7] = float("nan")
        b[n2 - 3, 11] = float("nan")
        got = pm.launch_fwd(a, b, w2, b2)
        want = pm.pairwise_mlp(a, b, w2, b2)
        same, diff = nan_pattern(got, want)
        check(same and diff <= 1e-4, f"forward NaN {n1}x{n2}x{k}: NaN where the plain version "
                                     f"has none or the reverse ({same}), else max abs err {diff}")
        check(torch.equal(got.nan_to_num(), pm.launch_fwd(a, b, w2, b2).nan_to_num()),
              f"forward NaN {n1}x{n2}x{k}: two runs differ in their bits")
        bwd = {}
        for name, x, w in zip(("dA", "dB", "dw2", "db2"), pm.launch_bwd(a, b, w2, g),
                              pm.pairwise_mlp_backward_reference(a, b, w2, g)):
            w = w.reshape(x.shape)
            same_b, diff_b = nan_pattern(x, w)
            bwd[name] = {"nan": int(torch.isnan(x).sum()), "plain_nan": int(torch.isnan(w).sum()),
                         "same_pattern": same_b, "max_abs_err_elsewhere": diff_b}
        emit("kernel_nan", name="pairwise_mlp_fwd", shape=[n1, n2, k],
             nan=int(torch.isnan(got).sum()), plain_nan=int(torch.isnan(want).sum()),
             same_pattern=same, max_abs_err_elsewhere=diff, backward=bwd)
    torch.cuda.synchronize()
    return rows


def knn_work(b, n, m, c, k, self_graph, rel_numel):
    """(operations, bytes) the kNN graph needs at least: 2 per multiply-add
    of the distance products; per (query, key) the subtraction, the addition,
    the bias and one comparison against the k-th best; 5 per input element to
    normalize it and sum its square; each input read once (x alone for a self
    graph) and the indices written once."""
    pair = 4 if rel_numel else 3
    rows = b * n if self_graph else b * (n + m)
    ops = 2 * b * n * m * c + pair * b * n * m + 5 * rows * c
    return ops, 4 * (rows * c + rel_numel + b * n * k)


def phase_knn():
    """The kNN kernel against its plain version on the card; returns its row
    of the `kernels` line at the TGCN's shape, the one the cardiac_full path
    gives it."""
    from graphecho_torch.models.vig import relative_pos_buffer
    from graphecho_torch.ops import knn

    cases = [(f"graphers {g}", KNN_BATCH, n, m, c, k, True, "grapher")
             for g, n, m, c, k in KNN_SHAPES]
    cases += [("ragged self", 2, 1000, None, 37, 16, True, None),
              ("normalize=False", 4, 500, 300, 64, 45, False, "per-image"),
              ("k=1", 4, 300, 196, 80, 1, True, "per-image"),
              ("k=64", 4, 300, 196, 80, 64, True, "per-image"),
              ("M=k", 4, 200, 27, 64, 27, True, None),
              ("N=1, B=1", 1, 1, 196, 400, 18, True, "per-image"),
              ("tgcn", *TGCN_KNN, True, None),
              ("tgcn frame 0 (zero keys)", *TGCN_KNN, True, "zero keys")]
    row = None
    for i, (name, b, n, m, c, k, normalize, rel_kind) in enumerate(cases):
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        scale = 1.0 if normalize else 0.1  # unnormalized rows: distances O(1)
        x = torch.randn(b, n, c, device="cuda", generator=gen) * scale
        y = None if m is None else torch.randn(b, m, c, device="cuda", generator=gen) * scale
        if rel_kind == "zero keys":  # the TGCN's first hidden state
            y.zero_()
        mm = n if m is None else m
        rel = None
        if rel_kind == "grapher":
            rel = relative_pos_buffer(c, n, mm, x.device)
        elif rel_kind == "per-image":
            rel = torch.randn(b, n, mm, device="cuda", generator=gen) * 0.1

        got = knn.launch_knn(x, y, k, normalize, rel)
        want = knn.knn_reference(x, y, k, normalize, rel)
        deterministic = torch.equal(got, knn.launch_knn(x, y, k, normalize, rel))
        check(deterministic, f"knn {name}: two runs differ in their bits")
        check(bool(((got >= 0) & (got < mm)).all()), f"knn {name}: index out of range")
        check(bool((torch.sort(got, dim=-1).values.diff(dim=-1) != 0).all()),
              f"knn {name}: a neighbour repeats in a row")
        rows_differ, gap = knn.knn_tie_gap(x, y, rel, normalize, got, want)
        check(gap <= KNN_TIE_TOL, f"knn {name}: {rows_differ} rows differ from the plain "
                                  f"version, float64 distance gap {gap} > {KNN_TIE_TOL}")
        if rel_kind == "zero keys":  # every distance ties: no near-tie allowance
            check(rows_differ == 0 and bool(
                (got == torch.arange(k, device="cuda", dtype=torch.int32)).all()),
                f"knn {name}: not columns 0..{k - 1} in order in every row")

        def kernel():
            return knn.launch_knn(x, y, k, normalize, rel)

        def plain():
            return knn.knn_reference(x, y, k, normalize, rel)

        plain_ms = cuda_ms(plain)
        ms = cuda_ms(kernel)
        ms = min(ms, cuda_ms(kernel))
        plain_ms = min(plain_ms, cuda_ms(plain))
        ops, nbytes = knn_work(b, n, mm, c, k, m is None, 0 if rel is None else rel.numel())
        bound_ms, bound_by = bound(ops, nbytes)
        emit("knn", case=name, b=b, n=n, m=mm, c=c, k=k, normalize=normalize,
             relative_pos=None if rel is None else list(rel.shape), rows=b * n,
             rows_differ=rows_differ, max_tie_gap=gap, deterministic=deterministic, ms=ms,
             plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        if name == "tgcn":
            row = {"name": "knn", "shape": [b, n, mm, c, k],
                   "route": "cuda", "source": "graphecho_torch/csrc/knn.cu",
                   "replaces": "graphecho_tpu/ops/pallas/knn_kernel.py:30", "launches": 0,
                   "max_abs_err": gap, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": None}
    torch.cuda.synchronize()
    return row


def phase_knn_nan():
    """One NaN feature in query row (0, 5) and one in key row (b - 1, 11), at
    the TGCN's shape and at Graphers 0-1 with their bias: the NaN row must
    take columns 0..k-1 and key 11 of the last image be nobody's neighbour,
    as in the plain version; every other row within the near-tie rule."""
    from graphecho_torch.models.vig import relative_pos_buffer
    from graphecho_torch.ops import knn

    for i, (name, b, n, m, c, k, grapher) in enumerate((("tgcn", *TGCN_KNN, False),
                                                        ("graphers 0-1", 2, 3136, 196, 80, 9,
                                                         True))):
        gen = torch.Generator(device="cuda").manual_seed(300 + i)
        x = torch.randn(b, n, c, device="cuda", generator=gen)
        y = torch.randn(b, m, c, device="cuda", generator=gen)
        x[0, 5, 7] = float("nan")
        y[b - 1, 11, 3] = float("nan")
        rel = relative_pos_buffer(c, n, m, x.device) if grapher else None
        got = knn.launch_knn(x, y, k, True, rel)
        want = knn.knn_reference(x, y, k, True, rel)
        first_k = torch.arange(k, device="cuda", dtype=torch.int32)
        nan_row_ok = torch.equal(got[0, 5], first_k) and torch.equal(want[0, 5], first_k)
        nan_key_used = int((got[b - 1] == 11).sum())
        rows_differ, gap = knn.knn_tie_gap(x, y, rel, True, got, want)
        emit("knn_nan", case=name, b=b, n=n, m=m, c=c, k=k,
             relative_pos=None if rel is None else list(rel.shape), nan_row_first_k=nan_row_ok,
             nan_key_neighbours=nan_key_used, plain_nan_key_neighbours=int(
                 (want[b - 1] == 11).sum()), rows=b * n, rows_differ=rows_differ,
             max_tie_gap=gap)
        check(nan_row_ok, f"knn_nan {name}: the NaN row is {got[0, 5].tolist()}, "
                          f"the plain version's {want[0, 5].tolist()}")
        check(nan_key_used == 0, f"knn_nan {name}: the NaN key is a neighbour {nan_key_used} times")
        check(gap <= KNN_TIE_TOL, f"knn_nan {name}: {rows_differ} rows differ from the plain "
                                  f"version, float64 distance gap {gap}")
    torch.cuda.synchronize()


def knn_tie_inputs(kind: str, b: int, n: int, m, c: int, gen: torch.Generator,
                   copies=(3, 7, 9)):
    """(x, y, relative_pos) on the card whose distances every version computes
    exactly, so that equal distances are equal in their bits and the order is
    set by the tie rule alone. The key rows `copies` (3, 7 and 9 unless
    given) are one row three times. The bias, where these inputs make one,
    repeats the first copy's column in the other two, so the three keys tie
    for every query.
      one-hot: each row a power of two times a unit vector of one of the first
        8 channels, so it normalizes exactly, and distances are 0 or 2, plus a
        shared bias in steps of 0.5;
      integer: rows of integers in [-2, 2] (not normalized), plus a per-image
        bias in steps of 0.25;
      zero: all rows 0, so every distance is 0;
      zero-grapher: all rows 0 and the Grapher's bias, so every distance is
        the bias.
    """
    from graphecho_torch.models.vig import relative_pos_buffer

    mm = n if m is None else m

    def rows(count):
        if kind == "one-hot":
            ch = torch.randint(0, 8, (b, count), device="cuda", generator=gen)
            scale = 2.0 ** torch.randint(-2, 4, (b, count), device="cuda", generator=gen)
            return torch.nn.functional.one_hot(ch, c).float() * scale[..., None]
        if kind == "integer":
            return torch.randint(-2, 3, (b, count, c), device="cuda", generator=gen).float()
        return torch.zeros(b, count, c, device="cuda")

    x = rows(n)
    y = None if m is None else rows(m)
    keys = x if y is None else y
    first, *others = copies
    for col in others:
        keys[:, col] = keys[:, first]
    rel = None
    if kind == "one-hot":
        rel = torch.randint(0, 4, (1, n, mm), device="cuda", generator=gen) * 0.5
    elif kind == "integer":
        rel = torch.randint(0, 5, (b, n, mm), device="cuda", generator=gen) * 0.25
    if rel is not None:
        for col in others:
            rel[..., col] = rel[..., first]
    if kind == "zero-grapher":
        rel = relative_pos_buffer(c, n, mm, x.device)
    return x, y, rel


def copies_in_column_order(idx: torch.Tensor, copies=(3, 7, 9)) -> bool:
    """Whether the copies of one key row come in column order in every row
    that holds all three, with nothing between them but keys tied with them
    (in ascending columns), and at least one row holds all three."""
    seen = 0
    first, middle, last = copies
    for row in idx.reshape(-1, idx.shape[-1]).tolist():
        if set(copies) <= set(row):
            run = row[row.index(first):row.index(last) + 1]
            if middle not in run or run != sorted(run):
                return False
            seen += 1
    return seen > 0


def phase_knn_ties():
    """The kNN kernel on exactly tied distances: its neighbours must equal the
    plain version's in order, with no near-tie allowance, and repeat in their
    bits."""
    from graphecho_torch.ops import knn

    # (kind, b, n, m or None for a self graph, c, k, normalize, key columns of the
    # copies); "integer" over 1000 keys puts its copies in different key tiles
    cases = (("one-hot", 2, 300, 200, 37, 45, True, (3, 7, 9)),
             ("integer", 2, 500, None, 24, 16, False, (3, 7, 9)),
             ("zero", 2, 196, None, 400, 18, True, (3, 7, 9)),
             ("zero-grapher", 2, 196, None, 400, 18, True, (3, 7, 9)),
             ("integer", 2, 300, 1000, 24, 64, False, (3, 500, 999)))
    for i, (kind, b, n, m, c, k, normalize, copies) in enumerate(cases):
        gen = torch.Generator(device="cuda").manual_seed(200 + i)
        x, y, rel = knn_tie_inputs(kind, b, n, m, c, gen, copies)
        got = knn.launch_knn(x, y, k, normalize, rel)
        want = knn.knn_reference(x, y, k, normalize, rel)
        check(torch.equal(got, knn.launch_knn(x, y, k, normalize, rel)),
              f"knn ties {kind}: two runs differ in their bits")
        rows_differ = int((got != want).any(-1).sum())
        check(rows_differ == 0, f"knn ties {kind}: {rows_differ} rows differ from the plain "
                                f"version on exact ties")
        if kind == "zero":  # no bias: every distance 0, so the first k columns
            check(bool((got == torch.arange(k, device="cuda", dtype=torch.int32)).all()),
                  "knn ties zero: not the first k columns in order")
        if kind != "zero-grapher":  # the Grapher's bias unties the copies
            check(copies_in_column_order(got, copies),
                  f"knn ties {kind}: keys {copies} are not neighbours in column order")
        emit("knn_ties", case=kind, copies=list(copies), b=b, n=n, m=n if m is None else m,
             c=c, k=k,
             normalize=normalize, relative_pos=None if rel is None else list(rel.shape),
             rows=b * n, rows_differ=rows_differ)
    torch.cuda.synchronize()


def _tiny_cfg():
    from graphecho_torch import config as C

    return C.ExperimentConfig(
        data=C.DataConfig(img_crop=(64, 64), batch_size=2, target_batch_mult=1),
        model=C.ModelConfig(backbone="VGG16", num_classes=2, fpn_channels=32,
                            semantic_channels=16,
                            vgg_spec=((8, 1), (16, 1), (16, 1), (32, 1), (32, 1))),
        gmodule=C.GModuleConfig(in_channels=32, num_classes=2, nodes_per_class=64,
                                dropout=0.0),
        dis=C.DiscriminatorConfig(in_channels=32))


def phase_reference():
    """One step of a small config on the card (kernels) and on the CPU (plain
    versions) from the same weights and batch: every loss within rtol 1e-3."""
    from graphecho_torch.train.state import create_train_state
    from graphecho_torch.train.steps import build_models, make_train_step

    cfg = _tiny_cfg()
    rng = np.random.RandomState(11)
    masks = np.zeros((2, 64, 64, 2), np.float32)
    masks[:, 8:40, 8:40, 1] = 1.0
    masks[..., 0] = 1.0 - masks[..., 1]
    batch = {"imgs_source": (rng.rand(2, 64, 64, 1) * 0.6).astype(np.float32),
             "imgs_target": (rng.rand(2, 64, 64, 1) * 0.6).astype(np.float32),
             "masks": masks}
    metrics = {}
    for dev in ("cpu", "cuda"):
        state = create_train_state(cfg, build_models(cfg), torch.device(dev))
        with torch.no_grad():  # target pseudo-labels far from the 0.5 threshold
            state.net.module.conv3.bias.copy_(torch.tensor([-8.0, 8.0]))
        out = make_train_step(cfg)(state, batch)
        metrics[dev] = {k: float(v) for k, v in out.items()}
    worst = 0.0
    for key, want in metrics["cpu"].items():
        got = metrics["cuda"][key]
        check(math.isfinite(got) and abs(got - want) <= 1e-3 * abs(want) + 1e-5,
              f"{key}: card {got} vs CPU {want}")
        worst = max(worst, abs(got - want))
    check(metrics["cpu"]["mat_loss_aff"] > 0,
          "the reference step left the affinity unused")
    emit("reference", card=metrics["cuda"], cpu=metrics["cpu"], max_abs_diff=worst)


def _temporal_batch(cfg, seed: int = 11):
    """`phase_reference`'s frames, one source and one target clip of the same
    scene and one cycle clip, NHWC."""
    rng = np.random.RandomState(seed)
    hw = cfg.data.img_crop[0]
    masks = np.zeros((2, hw, hw, 2), np.float32)
    masks[:, 8:40, 8:40, 1] = 1.0
    masks[..., 0] = 1.0 - masks[..., 1]
    t = cfg.tgcn.clip_shape[0]

    def frames(*lead):
        return (rng.rand(*lead, hw, hw, 1) * 0.6).astype(np.float32)

    return {"imgs_source": frames(2), "imgs_target": frames(2), "masks": masks,
            "temp_imgs_source": frames(1, t), "temp_imgs_target": frames(1, t),
            "temp_masks": np.repeat(masks[:1, None], t, axis=1),
            "update_idx_source": np.array([2], np.int32),
            "update_idx_target": np.array([5], np.int32),
            "cyc_imgs": frames(cfg.cycle.clip_length)}


def _moved_columns(state, queues0):
    """{domain: the queue columns that differ from `queues0`}."""
    return {name: sorted(((getattr(state, f"queue_{name}").cpu() - q0.cpu()).abs().amax(dim=0)
                          > 0).nonzero()[:, 0].tolist())
            for name, q0 in zip(("source", "target"), queues0)}


def phase_temporal_reference():
    """One step of a small config with the temporal branch (momentum-queue
    TGCN) and the cycle loss on the card (kernels) and on the CPU (plain
    versions), from the same weights and batch: every loss key within rtol
    1e-3. The dropouts are the identity and both runs take one cycle start,
    since the card's and the CPU's generators draw different numbers; the
    kNN kernel runs on the train path, once a frame."""
    import dataclasses

    from graphecho_torch import config as C
    from graphecho_torch.models import attention
    from graphecho_torch.ops import knn
    from graphecho_torch.ops import pairwise_mlp as pm
    from graphecho_torch.train import cycle
    from graphecho_torch.train.state import create_train_state
    from graphecho_torch.train.steps import build_models, make_train_step

    base = _tiny_cfg()
    cfg = dataclasses.replace(
        base, train=dataclasses.replace(base.train, temporal_graph=True, cyc_loss=True),
        tgcn=C.TGCNConfig(input_dim=32, hidden_dim=32, clip_shape=(4, 4, 4), knn_k=3,
                          cluster_method="momentum_queue", queue_size=6, source_class=6,
                          target_class=6))
    batch = _temporal_batch(cfg)
    dropout, draw_starts = attention.dropout, cycle.draw_starts
    attention.dropout = lambda x, *args, **kwargs: x
    cycle.draw_starts = lambda generator, n, *args: torch.full((n,), 3, dtype=torch.long)
    metrics, launches, queues, moved = {}, {}, {}, {}
    try:
        for dev in ("cpu", "cuda"):
            state = create_train_state(cfg, build_models(cfg), torch.device(dev))
            with torch.no_grad():  # target pseudo-labels far from the 0.5 threshold
                state.net.module.conv3.bias.copy_(torch.tensor([-8.0, 8.0]))
            queues0 = (state.queue_source.clone(), state.queue_target.clone())
            knn.reset_launch_counts()
            pm.reset_launch_counts()
            out = make_train_step(cfg)(state, batch)
            metrics[dev] = {k: float(v) for k, v in out.items()}
            launches[dev] = {**knn.LAUNCHES, **pm.LAUNCHES}
            queues[dev] = (state.queue_source.cpu(), state.queue_target.cpu())
            moved[dev] = _moved_columns(state, queues0)
    finally:
        attention.dropout, cycle.draw_starts = dropout, draw_starts
    worst = 0.0
    check(set(metrics["cpu"]) == set(metrics["cuda"]), "temporal reference: loss keys differ")
    for key, want in metrics["cpu"].items():
        got = metrics["cuda"][key]
        check(math.isfinite(got) and abs(got - want) <= 1e-3 * abs(want) + 1e-5,
              f"temporal reference {key}: card {got} vs CPU {want}")
        worst = max(worst, abs(got - want))
    for key in ("temporal_graph_loss", "cyc_loss", "tgcn_clustering_loss"):
        check(metrics["cpu"][key] != 0, f"temporal reference: {key} is 0")
    t = cfg.tgcn.clip_shape[0]
    check(launches["cuda"] == {"knn": t, "pairwise_mlp_fwd": 2, "pairwise_mlp_bwd": 2}
          and not any(launches["cpu"].values()),
          f"temporal reference launches: card {launches['cuda']}, CPU {launches['cpu']}")
    # the momentum queues: moved in the batch's columns only, alike on both
    check(moved["cuda"] == moved["cpu"] == {"source": [2], "target": [5]},
          f"temporal reference: queue columns moved {moved}")
    queue_diff = max((a - b).abs().max().item() for a, b in zip(queues["cuda"], queues["cpu"]))
    check(queue_diff <= 1e-4, f"temporal reference: queues differ by {queue_diff}")
    emit("temporal_reference", card=metrics["cuda"], cpu=metrics["cpu"], max_abs_diff=worst,
         queue_max_abs_diff=queue_diff, launches=launches["cuda"])


def _check_losses(means, what):
    for key in LOSS_KEYS:
        check(math.isfinite(means[key]), f"{what}: {key} = {means[key]}")


def _drive(entry, **kwargs):
    """Run an entry point with the launch counters zeroed just before and read
    just after; returns (trainer, launches, seconds)."""
    from graphecho_torch.ops import knn
    from graphecho_torch.ops import pairwise_mlp as pm

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pm.reset_launch_counts()
    knn.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = entry(**kwargs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return trainer, {**pm.LAUNCHES, **knn.LAUNCHES}, seconds


def _steady_step_ms(trainer, n: int = 3) -> float:
    """Median host time of `n` more train steps on pre-made batches."""
    from graphecho_torch.data.synthetic import SyntheticEchoData

    data = SyntheticEchoData(trainer.cfg, seed=7)
    batches = [data.train_batch() for _ in range(n)]
    times = []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer._train_step(trainer.state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_main(card: str, ckpt_root: Path):
    """camus and cardiac; each trainer's state after its steps is saved under
    `ckpt_root` for the serve phase. Returns camus's launches and
    {name: (cfg, checkpoint dir)}."""
    from graphecho_torch import entrypoints
    from graphecho_torch.train.checkpoint import CheckpointManager

    def save(name, trainer):
        CheckpointManager(str(ckpt_root / name)).save(trainer.state.step, trainer.state)
        ckpts[name] = (trainer.cfg, str(ckpt_root / name))

    ckpts = {}
    trainer, launches, seconds = _drive(entrypoints.train_camus_echo, num_epochs=1,
                                        steps_per_epoch=3, n_eval=4)
    save("camus", trainer)
    means = trainer.last_epoch_metrics
    _check_losses(means, "camus")
    dices = trainer.last_dices
    check(dices and all(math.isfinite(d) for d in dices.values()),
          f"camus dice {dices}")
    check(launches["pairwise_mlp_fwd"] >= 3 and launches["pairwise_mlp_bwd"] >= 3,
          f"camus: fewer than 3 launches of a kernel in 3 steps: {launches}")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = _steady_step_ms(trainer)
    emit("camus", losses={k: means[k] for k in LOSS_KEYS}, dice=dices, launches=launches,
         run_seconds=seconds, steady_step_ms=step_ms, peak_memory_gib=peak_gib,
         card=card, cfg="camus_echo_config()")
    camus_launches = launches
    del trainer
    torch.cuda.empty_cache()

    trainer, launches, seconds = _drive(entrypoints.train_cardiac_uda, num_epochs=1,
                                        steps_per_epoch=1, n_eval=2)
    save("cardiac", trainer)
    means = trainer.last_epoch_metrics
    _check_losses(means, "cardiac")
    for key in LOSS_KEYS[1:5]:
        check(means[key] != 0.0, f"cardiac: {key} is 0, the graph head did not run")
    check(launches["pairwise_mlp_fwd"] >= 1 and launches["pairwise_mlp_bwd"] >= 1,
          f"cardiac: a kernel never launched: {launches}")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = _steady_step_ms(trainer, n=2)
    check(all(math.isfinite(d) for d in trainer.last_dices.values()),
          f"cardiac dice {trainer.last_dices}")
    emit("cardiac", losses={k: means[k] for k in LOSS_KEYS}, dice=trainer.last_dices,
         launches=launches, run_seconds=seconds, steady_step_ms=step_ms, peak_memory_gib=peak_gib,
         card=card, cfg="cardiac_uda_config()")
    del trainer
    torch.cuda.empty_cache()
    return camus_launches, ckpts


def phase_full(card: str):
    """cardiac_full and camus_temporal: the paper's recipes with every branch,
    through the entry points at full width; returns cardiac_full's launches
    and steady step ms."""
    from graphecho_torch import entrypoints
    from graphecho_torch.config import cardiac_uda_config
    from graphecho_torch.data.synthetic import SyntheticEchoData
    from graphecho_torch.train.trainer import Trainer

    # the queues as the trainer starts them (its weights come from cfg.train.seed)
    start = Trainer(cardiac_uda_config(temporal_graph=True, cyc_loss=True))
    start.init_state()
    queues0 = (start.state.queue_source.clone(), start.state.queue_target.clone())
    del start
    trainer, launches, seconds = _drive(entrypoints.train_cardiac_uda, num_epochs=1,
                                        steps_per_epoch=1, n_eval=2, temporal_graph=True,
                                        cyc_loss=True)
    cfg, means = trainer.cfg, trainer.last_epoch_metrics
    _check_losses(means, "cardiac_full")
    for key in (k for k in means if k.endswith("loss")):  # the tgcn_* and temp_* parts too
        check(math.isfinite(means[key]), f"cardiac_full: {key} = {means[key]}")
    check(means["temporal_graph_loss"] != 0 and means["cyc_loss"] != 0,
          f"cardiac_full: temporal_graph_loss {means['temporal_graph_loss']}, "
          f"cyc_loss {means['cyc_loss']}")
    t = cfg.tgcn.clip_shape[0]
    check(launches == {"pairwise_mlp_fwd": 2, "pairwise_mlp_bwd": 2, "knn": t},
          f"cardiac_full: launches in one step {launches}, want 2, 2 and {t}")
    # the batch the entry point drew (its data seed is 123): the queues move
    # in no other columns than its update_idx_* name, and in those only with
    # the momentum queue (the paper's recipe clusters with none)
    batch = SyntheticEchoData(cfg, seed=123).train_batch()
    moved = _moved_columns(trainer.state, queues0)
    for name in moved:
        idx = sorted(set(batch[f"update_idx_{name}"].tolist()))
        check(moved[name] == (idx if cfg.tgcn.cluster_method == "momentum_queue" else []),
              f"cardiac_full: queue_{name} moved in columns {moved[name]}, update_idx {idx}")
    check(all(math.isfinite(d) for d in trainer.last_dices.values()),
          f"cardiac_full dice {trainer.last_dices}")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = _steady_step_ms(trainer, n=2)
    emit("cardiac_full", losses={k: means[k] for k in means if k.endswith("loss")},
         dice=trainer.last_dices, launches=launches, queue_columns_moved=moved,
         run_seconds=seconds, steady_step_ms=step_ms, peak_memory_gib=peak_gib, card=card,
         cfg="cardiac_uda_config(temporal_graph=True, cyc_loss=True)",
         clips=list(batch["temp_imgs_source"].shape[:2]), cyc_frames=len(batch["cyc_imgs"]))
    full_launches, full_step_ms = launches, step_ms
    del trainer
    torch.cuda.empty_cache()

    trainer, launches, seconds = _drive(entrypoints.train_camus_echo, num_epochs=1,
                                        steps_per_epoch=1, n_eval=2, temporal_graph=True)
    means = trainer.last_epoch_metrics
    _check_losses(means, "camus_temporal")
    check(math.isfinite(means["temporal_graph_loss"]) and means["temporal_graph_loss"] != 0,
          f"camus_temporal: temporal_graph_loss {means['temporal_graph_loss']}")
    t = trainer.cfg.tgcn.clip_shape[0]
    check(launches == {"pairwise_mlp_fwd": 2, "pairwise_mlp_bwd": 2, "knn": t},
          f"camus_temporal: launches in one step {launches}")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = _steady_step_ms(trainer, n=2)
    emit("camus_temporal", losses={k: means[k] for k in means if k.endswith("loss")},
         dice=trainer.last_dices, launches=launches, run_seconds=seconds,
         steady_step_ms=step_ms, peak_memory_gib=peak_gib, card=card,
         cfg="camus_echo_config(temporal_graph=True)")
    del trainer
    torch.cuda.empty_cache()
    return full_launches, full_step_ms


def _serve_frames(cfg, n: int, seed: int) -> np.ndarray:
    """`n` synthetic echo-like (H, W, 1) frames at the config's size."""
    from graphecho_torch.data.synthetic import synth_image_and_mask

    rng = np.random.RandomState(seed)
    h, w = cfg.data.img_crop
    return np.stack([synth_image_and_mask(rng, h, w, 1)[0] for _ in range(n)])


def _serve_rates(name: str, dtype: str, pred, frames: np.ndarray, card: str, reps: int,
                 forwards: int) -> None:
    """One `serve_rates` line: the inference function's device frames/s at
    the Predictor's batch (CUDA events, resident input), one request's
    frames/s from the host, peak memory, weight bytes, the backbone's
    device ms alone (for int8 the `_int_mm` route with its im2col and
    (de)quantisation, else cuDNN in the dtype) and the least time the card
    could take (`bench.bound_ms`)."""
    from graphecho_torch import bench

    batch = frames[:pred.batch_size]
    x = torch.from_numpy(batch).cuda()
    backbone = pred._infer.qb if dtype == "int8" else pred.fpn.back_bone
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        ms = bench.forward_ms(lambda: pred._infer(x), x.device, reps, forwards, 2)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        backbone_ms = bench.forward_ms(lambda: backbone(x.permute(0, 3, 1, 2)), x.device,
                                       reps, forwards, 1)
    req = bench.request_ms(pred, batch, reps)
    flops = bench.fpn_flops(pred.cfg)
    emit("serve_rates", cfg=name, dtype=dtype, batch=len(batch), forward_ms=ms,
         frames_per_s=len(batch) / ms * 1e3, request_ms=req,
         request_frames_per_s=len(batch) / req * 1e3, peak_memory_gib=peak,
         backbone_ms=backbone_ms, gflop_per_frame=sum(flops) / 1e9,
         bound_ms=bench.bound_ms(flops, len(batch), dtype), weight_bytes=pred.weight_bytes(),
         card=card)


def _check_accumulators(what: str, pred, frames: np.ndarray) -> int:
    """Every int8 layer's int32 accumulators, as the Predictor computes them
    on the card (`_int_mm`), against the float64 plain route on the same
    int8 inputs: equal bit for bit. Returns the number of layers held."""
    from graphecho_torch.quant.ptq import int8_conv_plain

    qb, held = pred._infer.qb, []

    def tap(name, x8, acc):
        lyr = qb.layer(name)
        check(x8.is_cuda and acc.dtype == torch.int32, f"{what}: {name} ran off the card")
        plain = int8_conv_plain(x8, lyr.wq, lyr.stride, lyr.padding)
        check(torch.equal(acc, plain), f"{what}: int8 accumulators of {name} differ from the "
              f"plain route in {(acc != plain).sum().item()} places")
        held.append(name)

    with torch.inference_mode():
        qb(torch.from_numpy(frames).cuda().permute(0, 3, 1, 2), tap=tap)
    check(held == qb.names, f"{what}: held {len(held)} of {len(qb.names)} int8 layers")
    return len(held)


def _agreement(preds: dict, frames: np.ndarray):
    """Each Predictor's masks of `frames`; their agreement on every pixel and
    where |logit_f32| > SERVE_CONFIDENT (int8 against both floats); the f32
    logits' |.| quantiles."""
    masks = {dt: p.predict(frames) for dt, p in preds.items()}
    fpn = preds["float32"].fpn
    with torch.inference_mode():
        x = torch.from_numpy(frames).cuda().permute(0, 3, 1, 2)
        logits = torch.cat([fpn(x[i:i + SERVE_BATCH])[0] for i in range(0, len(x),
                                                                         SERVE_BATCH)])
    abs_logit = logits.permute(0, 2, 3, 1).abs().cpu().numpy()
    pairs = [(a, b) for a, b in (("bfloat16", "float32"), ("int8", "float32"),
                                 ("int8", "bfloat16")) if a in masks and b in masks]
    agree = {f"{a}_vs_{b}": float((masks[a] == masks[b]).mean()) for a, b in pairs}
    sure = abs_logit > SERVE_CONFIDENT
    confident = {f"{a}_vs_{b}": float((masks[a] == masks[b])[sure].mean())
                 for a, b in pairs if a == "int8"}
    return masks, agree, confident, np.quantile(abs_logit, [0.01, 0.05, 0.1, 0.5]).tolist()


def _serve_more_trained(cfg, ckpt: str, card: str) -> None:
    """camus trained SERVE_MORE_STEPS steps further from its saved state (so
    that fewer logits sit near 0): int8 against f32 on every pixel."""
    from graphecho_torch.data.synthetic import SyntheticEchoData
    from graphecho_torch.serve import Predictor
    from graphecho_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    trainer = Trainer(cfg, checkpoint_dir=ckpt)
    trainer.init_state()
    data = SyntheticEchoData(cfg, seed=99)
    for _ in range(SERVE_MORE_STEPS):
        trainer._train_step(trainer.state, data.train_batch())
    trainer.ckpt.save(trainer.state.step, trainer.state)
    steps = trainer.state.step
    del trainer
    preds = {"float32": Predictor.from_checkpoint(cfg, ckpt, batch_size=SERVE_BATCH,
                                                  compute_dtype="float32")}
    preds["int8"] = Predictor.from_checkpoint(cfg, ckpt, batch_size=SERVE_BATCH, quantize=True)
    _, agree, confident, quantiles = _agreement(preds, _serve_frames(cfg, SERVE_FRAMES, seed=5))
    check(agree["int8_vs_float32"] > SERVE_AGREE,
          f"serve_camus after {steps} steps: int8 agreement {agree}")
    emit("serve_camus_trained", steps=steps, agreement=agree,
         agreement_where_confident=confident, abs_logit_quantiles_1_5_10_50=quantiles,
         seconds=time.perf_counter() - t0, card=card)
    del preds
    torch.cuda.empty_cache()


def _serve_config(name: str, cfg, ckpt: str, card: str, tmp: Path, full: bool,
                  acc_frames: int, reps: int, forwards: int) -> None:
    """The bf16, f32 and int8 Predictors of one trained checkpoint: masks of a
    ragged two-batch request, their agreement, the int8 accumulators; with
    `full`, uint8 frames through the resize, an empty request, video against
    batch, export and reload, and a hot swap."""
    from graphecho_torch.serve import Predictor, load_exported, prep_frames

    t0 = time.perf_counter()
    frames = _serve_frames(cfg, SERVE_FRAMES, seed=5)
    h, w = cfg.data.img_crop
    n_cls = cfg.model.num_classes
    preds = {"bfloat16": Predictor.from_checkpoint(cfg, ckpt, batch_size=SERVE_BATCH,
                                                   devices=["cuda"])}
    preds["float32"] = Predictor(cfg, preds["bfloat16"].variables, batch_size=SERVE_BATCH,
                                 compute_dtype="float32", devices=["cuda"])
    preds["int8"] = Predictor.from_checkpoint(cfg, ckpt, batch_size=SERVE_BATCH, quantize=True)
    masks, agree, confident, quantiles = _agreement(preds, frames)
    for dt, m in masks.items():
        check(m.shape == (SERVE_FRAMES, h, w, n_cls) and m.dtype == np.int8
              and set(np.unique(m)) <= {0, 1}, f"serve_{name} {dt}: masks {m.shape} {m.dtype}")
    check(agree["bfloat16_vs_float32"] > SERVE_AGREE
          and all(v > SERVE_AGREE for v in confident.values()),
          f"serve_{name}: agreement {agree}, where |logit_f32| > {SERVE_CONFIDENT}: {confident}")
    layers = _check_accumulators(f"serve_{name}", preds["int8"], frames[:acc_frames])
    out = dict(cfg=name, frames=SERVE_FRAMES, batch=SERVE_BATCH, agreement=agree,
               agreement_where_confident=confident, confident_margin=SERVE_CONFIDENT,
               abs_logit_quantiles_1_5_10_50=quantiles,
               positive_share={dt: float(m.mean()) for dt, m in masks.items()},
               int8_layers_bit_equal=layers, accumulator_frames=acc_frames)
    if full:
        pb, pq = preds["bfloat16"], preds["int8"]
        u8 = (np.random.RandomState(6).rand(20, 100, 90) * 255).astype(np.uint8)
        got = pb.predict(u8)
        check(got.shape == (20, h, w, n_cls) and np.array_equal(
            got, pb.predict(prep_frames(u8, (h, w)))), f"serve_{name}: uint8 100x90 frames")
        empty = pb.predict(np.zeros((0, h, w), np.float32))
        check(empty.shape == (0, h, w, n_cls) and empty.dtype == np.int8,
              f"serve_{name}: empty request {empty.shape}")
        for dt in ("bfloat16", "float32"):
            check(np.array_equal(preds[dt].predict_video(frames[:128]), masks[dt][:128]),
                  f"serve_{name} {dt}: predict_video differs from predict")
        export_s = {}
        for dt in ("bfloat16", "int8"):
            t1 = time.perf_counter()
            preds[dt].export_compiled(str(tmp / f"{name}_{dt}"))
            loaded = load_exported(str(tmp / f"{name}_{dt}"))
            check(np.array_equal(loaded.predict(frames), masks[dt]),
                  f"serve_{name} {dt}: the exported program's masks differ")
            export_s[dt] = time.perf_counter() - t1
        # a head bias that turns every pixel to the masks' minority value
        swapped = {k: v.clone() for k, v in pb.variables.items()}
        swapped["conv3.bias"] += 20.0 if masks["bfloat16"].mean() < 0.5 else -20.0
        original = pb.variables
        pb.variables = swapped
        check(not np.array_equal(pb.predict(frames[:8]), masks["bfloat16"][:8])
              and not np.array_equal(pb.predict_video(frames[:8]), masks["bfloat16"][:8]),
              f"serve_{name}: a hot swap left the masks as they were")
        pb.variables = original
        check(np.array_equal(pb.predict(frames), masks["bfloat16"]),
              f"serve_{name}: swapping the weights back did not restore the masks")
        try:
            pq.variables = swapped
            check(False, f"serve_{name}: the int8 Predictor took new weights")
        except ValueError as e:
            check("frozen" in str(e), f"serve_{name}: int8 refusal said {e}")
        out.update(uint8_frames=[100, 90], video_frames=128, export_and_load_s=export_s,
                   hot_swap=True)
    emit(f"serve_{name}", **out, seconds=time.perf_counter() - t0, card=card)
    for dt, p in preds.items():
        _serve_rates(name, dt, p, frames, card, reps, forwards)
    del preds
    torch.cuda.empty_cache()


def phase_serve(card: str, ckpts: dict) -> dict:
    """Serving from the trained checkpoints of phase_main: camus with every
    check, cardiac with the agreement and accumulator checks, then camus
    trained further. Returns the kernel launches the serving path made
    (none: it has no hand kernel)."""
    from graphecho_torch.ops import knn
    from graphecho_torch.ops import pairwise_mlp as pm

    tmp = Path(tempfile.mkdtemp(prefix="serve_"))
    try:
        pm.reset_launch_counts()
        knn.reset_launch_counts()
        cfg, ckpt = ckpts["camus"]
        _serve_config("camus", cfg, ckpt, card, tmp, full=True, acc_frames=SERVE_BATCH,
                      reps=3, forwards=5)
        cfg, ckpt = ckpts["cardiac"]
        _serve_config("cardiac", cfg, ckpt, card, tmp, full=False, acc_frames=16,
                      reps=2, forwards=1)
        launches = {**pm.LAUNCHES, **knn.LAUNCHES}
        # train steps launch the pairwise kernels: after the count
        _serve_more_trained(*ckpts["camus"], card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(not any(launches.values()), f"serve: kernel launches {launches}")
    return launches


def _cardiac_volume(seed: int, contour: bool):
    """One patient's view-4 video (H, W, frames) in uint8 and its labels:
    four organs, one a quadrant, beating a little; smooth, so gzip is quick.
    Labels are the filled organs, or their outlines where `contour`."""
    rng = np.random.RandomState(seed)
    h, w, t = REAL_SHAPE
    y = np.linspace(0, 1, h, dtype=np.float32)[:, None]
    x = np.linspace(0, 1, w, dtype=np.float32)[None, :]
    centers = np.array([[0.3, 0.3], [0.3, 0.7], [0.7, 0.3], [0.7, 0.7]]) + rng.uniform(
        -0.04, 0.04, (4, 2))
    radii = rng.uniform(0.09, 0.15, (4, 2))
    phase = rng.uniform(0, 2 * np.pi, 3)
    img = np.empty(REAL_SHAPE, np.uint8)
    lab = np.zeros(REAL_SHAPE, np.uint8)
    for f in range(t):
        beat = 1 + 0.1 * np.sin(2 * np.pi * f / 32 + phase[0])
        frame = 60 + 40 * np.sin(6 * x + phase[1] + 0.05 * f) * np.cos(5 * y + phase[2])
        for c, ((cy, cx), (ry, rx)) in enumerate(zip(centers, radii), 1):
            d = ((y - cy) / (ry * beat)) ** 2 + ((x - cx) / (rx * beat)) ** 2
            inside = d <= 1
            frame = np.where(inside, 140 + 20 * c, frame)
            lab[..., f][inside & (d >= 0.8) if contour else inside] = c
        img[..., f] = frame.astype(np.uint8)
    return img, lab


def write_cardiac_fixture(root: Path) -> Path:
    """A CardiacUDA-shaped tree root/<site>/<patient>/<patient>_4[_gt].nii.gz
    and its infos.npy, written by `python -m graphecho_torch.data.infos`."""
    from graphecho_torch.data.formats import write_nifti

    jobs = [(site, i) for site, n in REAL_PATIENTS.items() for i in range(n)]

    def write(job):
        site, i = job
        pdir = root / site / f"patient{i:04d}"
        pdir.mkdir(parents=True)
        seed = 1000 * list(REAL_PATIENTS).index(site) + i
        img, lab = _cardiac_volume(seed, contour=site == "Site_R_full")
        write_nifti(str(pdir / f"patient{i:04d}_4.nii.gz"), img)
        write_nifti(str(pdir / f"patient{i:04d}_4_gt.nii.gz"), lab)

    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(write, jobs))
    infos = root / "infos.npy"
    subprocess.run([sys.executable, "-m", "graphecho_torch.data.infos", "--root", str(root),
                    "--out", str(infos)], cwd=ROOT, check=True, capture_output=True, timeout=120)
    return infos


def _loader_item_ms(root: Path, infos: Path) -> dict:
    """Host ms of one item of each kind a cardiac_real step loads (16 source
    and 8 target frames, 4 + 4 clips, one cycle clip), read one at a time,
    and of reading one volume: where the loaders' time goes."""
    from graphecho_torch.config import cardiac_uda_config
    from graphecho_torch.data.cardiac_uda import SegCardiacUDADataset
    from graphecho_torch.data.formats import read_nifti

    cfg = cardiac_uda_config()
    d = cfg.data
    infos = np.load(infos, allow_pickle=True).item()
    dims = dict(spatial_size=d.img_res[0], crop_size=d.img_crop[0], view_num=(d.view_num,))
    kinds = {"frame": {},
             "clip": dict(single_frame=False, clip_length=d.clip_length,
                          total_length=d.total_length),
             "cycle_clip": dict(single_frame=False, clip_length=cfg.cycle.clip_length,
                                total_length=cfg.cycle.clip_length)}
    out = {}
    for name, kw in kinds.items():
        ds = SegCardiacUDADataset(infos, str(root), is_train=True, set_select=("Site_G",),
                                  **dims, **kw)
        t0 = time.perf_counter()
        for i in range(3):
            ds[i]
        out[name] = (time.perf_counter() - t0) / 3 * 1e3
    t0 = time.perf_counter()
    read_nifti(next(iter(infos.values()))["views_images"][d.view_num])
    out["read_nifti_volume"] = (time.perf_counter() - t0) * 1e3
    return out


def _state_tensors(state):
    """Every tensor of a TrainState by name, and its counters."""
    from graphecho_torch.train.checkpoint import COMPONENTS, TENSORS

    out = {"step": state.step, "epoch": state.epoch, "generator": state.generator.get_state()}
    for name in COMPONENTS:
        comp = getattr(state, name)
        if comp is not None:
            out.update({f"{name}.{k}": v for k, v in comp.module.state_dict().items()})
            for pid, st in comp.opt.state_dict()["state"].items():
                out.update({f"{name}.opt.{pid}.{k}": v for k, v in st.items()})
    out.update({name: getattr(state, name) for name in TENSORS if getattr(state, name) is not None})
    return out


def _bit_equal(a, b) -> list:
    """The names whose values differ (tensors compared bit for bit, and on
    their devices)."""
    return [k for k in a if not (a[k].device == b[k].device and torch.equal(a[k], b[k])
                                 if torch.is_tensor(a[k]) else a[k] == b[k])
            ] + sorted(set(a) ^ set(b))


def _run_cli(cmd, log: Path, stderr: Path, stop_after=None) -> int:
    """Run the CLI to its end; with `stop_after`, SIGTERM it once its log
    shows that text. Returns the exit code; the process never outlives this."""
    with open(stderr, "ab") as err:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=err, stderr=err)
        try:
            deadline = time.monotonic() + 600
            while stop_after is not None and proc.poll() is None:
                check(time.monotonic() < deadline, f"{stop_after!r} never showed in {log}")
                if log.exists() and stop_after in log.read_text():
                    proc.send_signal(signal.SIGTERM)
                    break
                time.sleep(0.05)
            return proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def phase_cardiac_real(card: str, synthetic_step_ms: float):
    """The real-data trainer at full width on a CardiacUDA-shaped tree:
    `run_cardiac_uda` with every branch, a save and restore on the card, and
    a SIGTERMed and resumed CLI run; returns the launches per step."""
    from graphecho_torch import real_training
    from graphecho_torch import train_cardiac_uda as cli
    from graphecho_torch.data.synthetic import SyntheticEchoData
    from graphecho_torch.train.checkpoint import CheckpointManager
    from graphecho_torch.train.trainer import Trainer

    tmp = Path(tempfile.mkdtemp(prefix="cardiac_real_"))
    try:
        t0 = time.perf_counter()
        root = tmp / "cardiac_uda"
        infos = write_cardiac_fixture(root)
        fixture_s = time.perf_counter() - t0
        item_ms = _loader_item_ms(root, infos)
        flags = ["--root", str(root), "--infos", str(infos), "--temporal-graph", "--cyc-loss"]

        # one in-process run, counted: two epochs of two steps
        args = cli.build_parser().parse_args(flags + ["--epochs", "2",
                                                      "--save-dir", str(tmp / "run")])
        trainer, launches, seconds = _drive(real_training.run_cardiac_uda, args=args)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        steps, spe = trainer.state.step, trainer.steps_per_epoch
        check(spe == 2 and steps == 4, f"cardiac_real: {steps} steps, {spe} an epoch")
        t = trainer.cfg.tgcn.clip_shape[0]
        per_step = {k: v / steps for k, v in launches.items()}
        check(per_step == {"pairwise_mlp_fwd": 2, "pairwise_mlp_bwd": 2, "knn": t},
              f"cardiac_real: launches {launches} in {steps} steps, want 2, 2 and {t} a step")
        means = trainer.last_epoch_metrics
        _check_losses(means, "cardiac_real")
        for key in (k for k in means if k.endswith("loss")):
            check(math.isfinite(means[key]), f"cardiac_real: {key} = {means[key]}")
        check(means["temporal_graph_loss"] != 0 and means["cyc_loss"] != 0,
              f"cardiac_real: temporal_graph_loss {means['temporal_graph_loss']}, "
              f"cyc_loss {means['cyc_loss']}")
        dices = trainer.last_dices
        check(set(dices) == {"Inner-Val", "Target Domain - Test", "Target Domain - Video Test"}
              and all(math.isfinite(d) for d in dices.values()), f"cardiac_real dice {dices}")
        tags = trainer.ckpt.metrics()
        check(trainer.ckpt.latest_step() == steps and tags["dice_metric"]
              == "Target Domain - Video Test" and tags["dice"] == dices[tags["dice_metric"]],
              f"cardiac_real: checkpoint {trainer.ckpt.latest_step()} tagged {tags}")

        # a save and a restore into a fresh Trainer on the card
        mgr = CheckpointManager(str(tmp / "card"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(steps, trainer.state)
        save_ms = (time.perf_counter() - t0) * 1e3
        ckpt_mib = os.path.getsize(mgr.directory + f"/{steps}.pt") / 2 ** 20
        fresh = Trainer(trainer.cfg, steps_per_epoch=spe)
        fresh.init_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.restore(fresh.state)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        check(fresh.state.generator.device.type == "cuda", "cardiac_real: generator not on CUDA")
        want, got = _state_tensors(trainer.state), _state_tensors(fresh.state)
        differ = _bit_equal(want, got)
        check(not differ, f"cardiac_real: restored state differs in {differ[:5]}")
        batch = SyntheticEchoData(trainer.cfg, seed=7).train_batch()
        losses = [{k: v.item() for k, v in tr._train_step(tr.state, batch).items()}
                  for tr in (trainer, fresh)]
        check(losses[0] == losses[1], f"cardiac_real: a step after restore differs: {losses}")
        del fresh, trainer
        torch.cuda.empty_cache()

        # a real preemption of the CLI, and its resume
        cmd = [sys.executable, "-m", "graphecho_torch.train_cardiac_uda", *flags,
               "--epochs", "3", "--save-dir", str(tmp / "cli"), "--log-dir", str(tmp / "log")]
        log, out = tmp / "log" / "train.log", tmp / "cli.out"
        t0 = time.perf_counter()
        rc = _run_cli(cmd, log, out, stop_after="epoch 0 |")
        check(rc == 0, f"cardiac_real: the SIGTERMed CLI exited {rc}: {out.read_text()[-2000:]}")
        stopped = [int(line.rsplit("at step ", 1)[1].split(":")[0])
                   for line in log.read_text().splitlines() if "preemption signal at step" in line]
        cli_ckpt = CheckpointManager(str(tmp / "cli"))
        check(stopped == [spe + 1] and cli_ckpt.latest_step() == spe + 1,
              f"cardiac_real: stopped at {stopped}, latest checkpoint {cli_ckpt.latest_step()}")
        n = stopped[0]
        rc = _run_cli(cmd, log, out)
        cli_s = time.perf_counter() - t0
        check(rc == 0, f"cardiac_real: the resumed CLI exited {rc}: {out.read_text()[-2000:]}")
        check(f"resumed from checkpoint step {n}" in log.read_text(),
              "cardiac_real: the second CLI run did not resume")
        check(cli_ckpt.latest_step() == n + 3 * spe,
              f"cardiac_real: resumed run ended at {cli_ckpt.latest_step()}, want {n + 3 * spe}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("cardiac_real", losses={k: means[k] for k in means if k.endswith("loss")}, dice=dices,
         checkpoint_tags=tags, launches=launches, steps=steps, launches_per_step=per_step,
         run_seconds=seconds, step_ms=means["step_seconds"] * 1e3,
         loader_wait_ms=means["loader_wait_seconds"] * 1e3, loader_item_ms=item_ms,
         synthetic_cardiac_full_step_ms=synthetic_step_ms, peak_memory_gib=peak_gib,
         fixture={"frames": list(REAL_SHAPE), "patients": REAL_PATIENTS,
                  "seconds": fixture_s},
         checkpoint_mib=ckpt_mib, save_ms=save_ms, restore_ms=restore_ms,
         restore_bit_equal=True, step_after_restore_equal=True,
         preempted_at_step=n, resumed_to_step=n + 3 * spe, cli_seconds=cli_s, card=card,
         cfg="train_cardiac_uda CLI defaults --temporal-graph --cyc-loss")
    return {k: int(v) for k, v in per_step.items()}


def phase_vig_reference():
    """A small DeepGCN on the card (kNN kernel) against the same model on the
    CPU (plain kNN): logits within rtol 1e-3 / atol 1e-4."""
    from graphecho_torch.models.initializers import initialize
    from graphecho_torch.models.vig import DeepGCN
    from graphecho_torch.ops import knn

    # 128² keeps k * dilation = 6 below the 16 nodes of the last stage
    kw = dict(blocks=(1, 1, 2, 1), channels=(16, 32, 48, 64), k=3, n_classes=10, img_size=128)
    cpu = initialize(DeepGCN(**kw), torch.Generator().manual_seed(5)).eval()
    card = DeepGCN(**kw)
    card.load_state_dict(cpu.state_dict())
    card = card.cuda().eval()
    x = torch.randn(2, 3, 128, 128, generator=torch.Generator().manual_seed(6))
    knn.reset_launch_counts()
    with torch.no_grad():
        want = cpu(x)
        got = card(x.cuda()).cpu()
    check(knn.LAUNCHES["knn"] == 5, f"vig reference: {knn.LAUNCHES} kNN launches for 5 Graphers")
    diff = (got - want).abs()
    check(bool(torch.isfinite(got).all()) and bool((diff <= 1e-4 + 1e-3 * want.abs()).all()),
          f"vig reference: card vs CPU logits differ by {diff.max().item()}")
    emit("vig_reference", config=kw, batch=2, max_abs_diff=diff.max().item(),
         knn_launches=knn.LAUNCHES["knn"])


def phase_vig(card: str) -> int:
    """pvig_s at full width: eval at batch 4 and 32, one train step's forward
    and backward at batch 32; returns the kNN launches of the batch-32 eval
    forward."""
    import torch.nn.functional as F

    from graphecho_torch.models.vig import pvig_s
    from graphecho_torch.ops import knn

    model = pvig_s(n_classes=1000).eval()
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == PVIG_S_PARAMS, f"pvig_s has {n_params} parameters")
    gen = torch.Generator(device="cuda").manual_seed(21)
    evals = {}
    for batch in (4, 32):
        x = torch.randn(batch, 3, 224, 224, device="cuda", generator=gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        knn.reset_launch_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits = model(x)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = knn.LAUNCHES["knn"]
        check(launches == 12, f"pvig_s eval batch {batch}: {launches} kNN launches, not 12")
        check(logits.shape == (batch, 1000) and bool(torch.isfinite(logits).all()),
              f"pvig_s eval batch {batch}: logits {tuple(logits.shape)} not finite")
        evals[batch] = {"knn_launches": launches, "first_forward_s": seconds,
                        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                        "logits_std": logits.std().item()}
    times = []
    with torch.no_grad():
        for i in range(12):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(x)
            torch.cuda.synchronize()
            if i >= 2:  # after two warm-up batches
                times.append(time.perf_counter() - t0)
    eval_ms = statistics.median(times) * 1e3

    model.train()
    labels = torch.randint(0, 1000, (32,), device="cuda", generator=gen)
    torch.cuda.reset_peak_memory_stats()
    knn.reset_launch_counts()
    t0 = time.perf_counter()
    logits = model(x, generator=gen)
    launches = knn.LAUNCHES["knn"]
    loss = F.cross_entropy(logits, labels)
    loss.backward()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    check(launches == 12, f"pvig_s train forward: {launches} kNN launches, not 12")
    check(bool(torch.isfinite(logits).all()) and math.isfinite(loss.item()),
          f"pvig_s train: loss {loss.item()}")
    grads = [p.grad for p in model.parameters()]
    check(all(g is not None and bool(torch.isfinite(g).all()) for g in grads),
          "pvig_s train: a gradient is missing or not finite")
    emit("vig", cfg="pvig_s(n_classes=1000)", img=224, parameters=n_params, eval=evals,
         eval_batch=32, eval_ms=eval_ms, eval_images_per_s=32 / (eval_ms / 1e3),
         train_batch=32, train_loss=loss.item(), train_knn_launches=launches,
         train_fwd_bwd_s=train_s, train_peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         grad_norm=torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).item(), card=card)
    return evals[32]["knn_launches"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    if not (ROOT / "graphecho_torch" / "csrc").is_dir():
        print(f"chip_smoke.py: graphecho_torch/ not found beside {Path(__file__).name}; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = nvidia_smi()
    emit("environment", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), nvidia_smi=card,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)

    phase_build()
    rows = phase_kernels()
    knn_row = phase_knn()
    phase_knn_nan()
    phase_knn_ties()
    phase_reference()
    phase_temporal_reference()
    ckpt_root = Path(tempfile.mkdtemp(prefix="trained_"))
    try:
        camus, ckpts = phase_main(card, ckpt_root)
        full, full_step_ms = phase_full(card)
        serve = phase_serve(card, ckpts)
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    real = phase_cardiac_real(card, full_step_ms)
    phase_vig_reference()
    pvig = phase_vig(card)
    rows["knn"] = knn_row
    # launches per cardiac_full step, this slice's path; beside them each path's
    for name, row in rows.items():
        row["launches"] = full[name]
        row["launches_by_path"] = {"cardiac_full step": full[name],
                                   "camus 3 steps": camus[name],
                                   "cardiac_real step": real[name],
                                   "serve": serve[name]}
    knn_row["launches_by_path"]["pvig_s forward"] = pvig
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
