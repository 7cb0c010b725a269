"""Smoke run of graphecho_torch on one NVIDIA GPU: builds the CUDA kernels,
holds each against its plain PyTorch version, and drives the CAMUS->EchoNet
and CardiacUDA train steps at full width.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. environment: torch/CUDA versions, TF32 switched off, the card's name and
     power limit from nvidia-smi;
  2. build: `nvcc` of every source in graphecho_torch/csrc, all at once;
  3. kernels: the pairwise-MLP forward and backward kernels against the plain
     version at (112,112,512), (560,560,512) and a ragged (70,50,40): forward
     atol 1e-4, gradients rtol/atol 1e-3 (the JAX package's own bounds), two
     backward runs bit-identical; CUDA-event times (median of 20 after warm-up)
     beside the least time the card could take;
  4. reference: one train step of a small config on the card against the
     same step on the CPU (plain versions), losses within rtol 1e-3;
  5. camus: `train_camus_echo` with the paper's `camus_echo_config()`
     (ResNet50, 112², source batch 8, target batch 168, 112 nodes per class)
     for 3 steps and validation, launch counters zeroed just before and read
     just after; then steady-state step time and peak memory;
  6. cardiac: one step of `train_cardiac_uda` at full width (VGG16, 256²,
     five classes -> a 560x560 affinity), counted the same way.
Then the `kernels` summary line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failure raises and the exit code is not 0;
without a CUDA device the script exits 1 before printing any result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
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
MAIN_SHAPE = (112, 112, 512)  # what the camus main path gives the kernels


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

        out = pm.launch_fwd(a, b, w2) + b2
        ref = pm.pairwise_mlp(a, b, w2, b2)
        err_fwd = (out - ref).abs().max().item()
        check(err_fwd <= 1e-4, f"forward {n1}x{n2}x{k}: max abs err {err_fwd}")

        da, dw2, db2 = pm.launch_bwd_da(a, b, w2, g)
        db = pm.launch_bwd_db(a, b, w2, g)
        r_da, r_db, r_dw2, r_db2 = pm.pairwise_mlp_backward_reference(a, b, w2, g)
        errs = {}
        for name, got, want in (("dA", da, r_da), ("dB", db, r_db), ("dw2", dw2, r_dw2),
                                ("db2", db2[0], r_db2)):
            diff = (got - want).abs()
            check(bool((diff <= 1e-3 + 1e-3 * want.abs()).all()),
                  f"{name} {n1}x{n2}x{k}: max abs err {diff.max().item()}")
            errs[name] = diff.max().item()
        again_da = pm.launch_bwd_da(a, b, w2, g)
        again_db = pm.launch_bwd_db(a, b, w2, g)
        deterministic = (all(torch.equal(x, y) for x, y in zip((da, dw2, db2), again_da))
                         and torch.equal(db, again_db))
        check(deterministic, f"backward {n1}x{n2}x{k}: two runs differ in their bits")

        # ops per (i, j, k) of each formula: fwd a+b, relu, *w2, +;
        # dA/dw2 a+b, >0, g*mask and its +, relu, g*relu and its +;
        # dB a+b, >0, g*mask and its +
        nijk = n1 * n2 * k
        in_bytes = 4 * (n1 * k + n2 * k + k)
        kernels = {
            "pairwise_mlp_fwd": (lambda: pm.launch_fwd(a, b, w2),
                                 lambda: pm.pairwise_mlp(a, b, w2, b2),
                                 4 * nijk, in_bytes + 4 * n1 * n2, err_fwd, 37),
            "pairwise_mlp_bwd_da": (lambda: pm.launch_bwd_da(a, b, w2, g),
                                    lambda: pm._plain_bwd_da(a, b, w2, g),
                                    7 * nijk, in_bytes + 4 * n1 * n2 + 4 * (n1 * k + k + 1),
                                    max(errs["dA"], errs["dw2"], errs["db2"]), 56),
            "pairwise_mlp_bwd_db": (lambda: pm.launch_bwd_db(a, b, w2, g),
                                    lambda: pm._plain_bwd_db(a, b, w2, g),
                                    4 * nijk, in_bytes + 4 * n1 * n2 + 4 * n2 * k,
                                    errs["dB"], 91),
        }
        for name, (kernel, plain, ops, nbytes, err, line) in kernels.items():
            # compare two versions inside one call, in turns
            plain_ms = cuda_ms(plain)
            ms = cuda_ms(kernel)
            ms = min(ms, cuda_ms(kernel))
            plain_ms = min(plain_ms, cuda_ms(plain))
            bound_ms, bound_by = bound(ops, nbytes)
            emit("kernel", name=name, shape=[n1, n2, k], max_abs_err=err, ms=ms,
                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                 deterministic=deterministic)
            if (n1, n2, k) == MAIN_SHAPE:
                rows[name] = {"name": name, "route": "cuda",
                              "source": "graphecho_torch/csrc/pairwise_mlp.cu",
                              "replaces": f"graphecho_tpu/ops/pallas/pairwise_mlp_kernel.py:{line}",
                              "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                              "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    torch.cuda.synchronize()
    return rows


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


def _check_losses(means, what):
    for key in LOSS_KEYS:
        check(math.isfinite(means[key]), f"{what}: {key} = {means[key]}")


def _drive(entry, **kwargs):
    """Run an entry point with the launch counters zeroed just before and read
    just after; returns (trainer, launches, seconds)."""
    from graphecho_torch.ops import pairwise_mlp as pm

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pm.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = entry(**kwargs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return trainer, dict(pm.LAUNCHES), seconds


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


def phase_main(card: str):
    from graphecho_torch import entrypoints

    trainer, launches, seconds = _drive(entrypoints.train_camus_echo, num_epochs=1,
                                        steps_per_epoch=3, n_eval=4)
    means = trainer.last_epoch_metrics
    _check_losses(means, "camus")
    dices = trainer.last_dices
    check(dices and all(math.isfinite(d) for d in dices.values()),
          f"camus dice {dices}")
    check(all(n >= 3 for n in launches.values()),
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
    means = trainer.last_epoch_metrics
    _check_losses(means, "cardiac")
    for key in LOSS_KEYS[1:5]:
        check(means[key] != 0.0, f"cardiac: {key} is 0, the graph head did not run")
    check(all(n >= 1 for n in launches.values()), f"cardiac: a kernel never launched: {launches}")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = _steady_step_ms(trainer, n=2)
    check(all(math.isfinite(d) for d in trainer.last_dices.values()),
          f"cardiac dice {trainer.last_dices}")
    emit("cardiac", losses={k: means[k] for k in LOSS_KEYS}, dice=trainer.last_dices,
         launches=launches, run_seconds=seconds, steady_step_ms=step_ms, peak_memory_gib=peak_gib,
         card=card, cfg="cardiac_uda_config()")
    return camus_launches


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
    phase_reference()
    launches = phase_main(card)
    for name, row in rows.items():
        row["launches"] = launches[name]
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
