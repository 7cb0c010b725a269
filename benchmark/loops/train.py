"""Closed-loop training: train steps back to back through
`Trainer.train_epoch`, the system's own loop.

Set-up builds the trainer with the benchmark's weights and step state, makes
a pool of batches on the host from the seed, and runs the first three steps,
each through `train_epoch` on its own pool batch: they compile and warm
every kernel, and they are the steps the plain reference follows. The
window then cycles the pool through one `train_epoch` call until
`--seconds` have passed, and ends on the synchronisation that call makes.
`step_ms` is the window over the steps completed in it. The sizes of the
pool, the weights and the state come from the reference's configuration;
the run stops where the program's configuration differs from it.

What `correct` compares, once the window has closed and the system's state
is freed (the cell's limits file names which of these readings count):
the total loss of each of the three first steps, and of the first step
alone; with the mix's `steady_loss_keys` (a list of loss terms for each
checked step), those terms at their steps; each leaf's first gradient as
the optimizer got it (read back from its state: Adam's first moment over
1 - beta1, SGD's momentum buffer), by the worst leaf (of every component,
or of the mix's `steady_grad_components`) and by each component's median
leaf; each leaf's change over the three steps, by the worst leaf, by the
median leaf and by each component's median leaf; the step's state (the
GModule's seed banks, the TGCN's queues) as it moved over the three steps,
and the seed banks after the first step. Norms are taken per leaf and
judged against the larger of that leaf's reference norm and the median
leaf's of its component. Leaves whose reference gradient is under a
thousandth of the median leaf's move by round-off alone and are left out
of the change."""

from __future__ import annotations

import gc
import math
import statistics
import time
from typing import Any, Dict, List

import numpy as np
import torch

from benchmark import experiment, weights, work
from benchmark.frames import frames
from benchmark.reference.uda.step import leaf_norms, median

COMPONENTS = (("fpn", "net"), ("gmodule", "gmn"), ("discriminator", "dis"), ("tgcn", "tgcn"))
STATE = ("sr_seed", "tg_seed", "queue_source", "queue_target")
BANKS = ("sr_seed", "tg_seed")  # the GModule's seed banks
CHECKED_STEPS = 3
MOVE_FLOOR = 1e-3  # of the median leaf's reference gradient


def make_batch(rng: np.random.Generator, cfg, bg_channel: bool) -> Dict[str, np.ndarray]:
    """One train batch of the step's contract (NHWC), every frame new."""
    d, t = cfg.data, cfg.train
    h, w = d.img_crop
    c = cfg.model.num_classes
    b = d.batch_size
    imgs, masks = frames(rng, b, h, w, c, bg_channel)
    batch = {"imgs_source": imgs, "masks": masks}
    if t.graph_matching:
        batch["imgs_target"] = frames(rng, b * d.target_batch_mult, h, w, c, bg_channel)[0]
    if t.temporal_graph:
        tl = cfg.tgcn.clip_shape[0]
        bc = max(b // 2, 1)
        src, src_masks = frames(rng, bc * tl, h, w, c, bg_channel)
        batch["temp_imgs_source"] = src.reshape(bc, tl, h, w, 1)
        batch["temp_imgs_target"] = frames(rng, bc * tl, h, w, c, bg_channel)[0].reshape(
            bc, tl, h, w, 1)
        batch["temp_masks"] = src_masks.reshape(bc, tl, h, w, c)
        n_idx = min(cfg.tgcn.source_class, cfg.tgcn.queue_size)
        batch["update_idx_source"] = rng.integers(0, n_idx, bc).astype(np.int32)
        batch["update_idx_target"] = rng.integers(0, n_idx, bc).astype(np.int32)
    if t.cyc_loss:
        batch["cyc_imgs"] = frames(rng, cfg.cycle.clip_length, h, w, c, bg_channel)[0]
    return batch


def _components(state) -> Dict[str, Any]:
    return {name: getattr(state, attr) for name, attr in COMPONENTS
            if getattr(state, attr) is not None}


def _first_grads(comp) -> Dict[str, torch.Tensor]:
    """Each parameter's first gradient, read back from the optimizer's state
    after one step."""
    out = {}
    for name, p in comp.module.named_parameters():
        st = comp.opt.state.get(p, {})
        if "exp_avg" in st:
            out[name] = st["exp_avg"] / (1.0 - comp.opt.param_groups[0]["betas"][0])
        elif "momentum_buffer" in st:
            out[name] = st["momentum_buffer"]
        else:  # no update reached this leaf
            out[name] = torch.full_like(p, math.nan)
    return out


def _leaf_gaps(got: Dict[str, Dict[str, float]], want: Dict[str, Dict[str, float]],
               keep=None) -> Dict[str, Dict[str, float]]:
    """|got - want| of each leaf over the larger of its own reference norm
    and its component's median leaf's, by component and leaf."""
    gaps: Dict[str, Dict[str, float]] = {}
    for comp, ref in want.items():
        med = median(list(ref.values()))
        gaps[comp] = {}
        for name, r in ref.items():
            if keep is not None and not keep[comp][name]:
                continue
            gap = abs(got[comp][name] - r) / max(r, med, 1e-30)
            gaps[comp][name] = gap if math.isfinite(gap) else math.inf
    return gaps


def _rel(a: float, b: float) -> float:
    gap = abs(a - b) / max(abs(b), 1e-30)
    return gap if math.isfinite(gap) else math.inf


def _state_gap(got: torch.Tensor, want: torch.Tensor, start: torch.Tensor) -> float:
    """How far the program's state lies from the reference's, over how far
    the reference's moved from the common start, or over its own norm where
    it did not move (a TGCN without clustering carries its queues unread)."""
    scale = torch.linalg.vector_norm((want - start).double())
    if scale == 0:
        scale = torch.linalg.vector_norm(want.double())
    gap = float(torch.linalg.vector_norm((got - want).double()) / scale.clamp_min(1e-30))
    return gap if math.isfinite(gap) else math.inf


def _host_probe(pool, device) -> Dict[str, float]:
    """The host's speed now: a fixed Python loop's ms, and the pageable
    copy of the first pool batch to the card in GB/s (median of 5)."""
    t = time.perf_counter()
    acc = 0
    for i in range(1_000_000):
        acc += i & 7
    out = {"python_loop_ms": (time.perf_counter() - t) * 1e3}
    if device.type == "cuda":
        nbytes = sum(v.nbytes for v in pool[0].values())
        times = []
        for _ in range(5):
            torch.cuda.synchronize(device)
            t = time.perf_counter()
            for v in pool[0].values():
                torch.from_numpy(v).to(device)
            torch.cuda.synchronize(device)
            times.append(time.perf_counter() - t)
        out["h2d_gb_per_s"] = nbytes / statistics.median(times) / 1e9
    try:
        with open("/proc/cpuinfo") as f:
            mhz = [float(line.split(":")[1]) for line in f if line.startswith("cpu MHz")]
        out["cpu_mhz"] = sum(mhz) / len(mhz) if mhz else math.nan
    except (OSError, ValueError):
        pass
    return out


class _GcClock:
    """The garbage collector's pauses while it is installed, by generation."""

    def __init__(self):
        self.seconds = [0.0, 0.0, 0.0]
        self.count = [0, 0, 0]
        self._t = 0.0

    def __call__(self, phase: str, info: Dict[str, int]) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            g = info["generation"]
            self.seconds[g] += time.perf_counter() - self._t
            self.count[g] += 1


def _window_note(intervals: List[float], gc_clock: _GcClock, before, after) -> Dict[str, Any]:
    """Per-step host times of the window and what the host was doing: to tell
    a stall (a few long steps, a collector's pause) from a drift (every step
    slower, a slower host)."""
    ms = [x * 1e3 for x in intervals]
    med = statistics.median(ms) if ms else math.nan
    return {"window": {
        "step_host_ms": [round(x, 1) for x in ms],
        "median_ms": med, "max_ms": max(ms, default=math.nan),
        "long_steps": sum(x > 1.25 * med for x in ms),
        "first_half_ms": statistics.median(ms[:len(ms) // 2]) if len(ms) > 1 else math.nan,
        "second_half_ms": statistics.median(ms[len(ms) // 2:]) if len(ms) > 1 else math.nan,
        "gc_pause_ms": [round(s * 1e3, 2) for s in gc_clock.seconds], "gc_count": gc_clock.count,
        "host_before": before, "host_after": after}}


def run(cell) -> Dict[str, Any]:
    from graphecho_torch import config as program_config
    from graphecho_torch.ops import knn as knn_op, pairwise_mlp, spectral
    from graphecho_torch.train.trainer import Trainer

    traffic = cell.traffic
    device = cell.device
    # float32 means float32: TF32 stays off for every cell of this loop
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    control = dict(traffic.get("control", {})) if cell.control else {}
    cfg = experiment.build(program_config, cell.config, traffic, cell.extra, control)
    ref_mod = experiment.reference(cell.config_name)
    ref_cfg = experiment.build(ref_mod.config, cell.config, traffic, cell.extra)
    differ = experiment.mismatches(
        cfg, experiment.build(ref_mod.config, cell.config, traffic, cell.extra, control))
    if differ:
        raise SystemExit(f"{cell.name}: the program's configuration is not the reference's: "
                         + "; ".join(differ))
    bg_channel = bool(cell.config.get("mask_bg_channel", False))

    trainer = Trainer(cfg, steps_per_epoch=1, device=device)
    state = trainer.init_state()
    comps = _components(state)
    init = weights.make({k: c.module for k, c in comps.items()}, cell.seed, device)
    for k, c in comps.items():
        c.module.load_state_dict(init[k])
    extra = weights.step_state(cell.seed, device, ref_cfg)
    for name in STATE:
        if getattr(state, name) is not None:
            setattr(state, name, extra[name].clone())
    state.generator.manual_seed(extra["generator_seed"])

    rng = np.random.default_rng(cell.seed)
    pool = [make_batch(rng, ref_cfg, bg_channel) for _ in range(int(traffic["pool"]))]

    losses: List[Dict[str, float]] = []
    first_grads = None
    for i in range(CHECKED_STEPS):
        means = trainer.train_epoch([pool[i]], i)
        losses.append(means)
        if i == 0:
            first_grads = {k: leaf_norms(_first_grads(c)) for k, c in comps.items()}
            moved1 = {name: getattr(state, name).clone() for name in BANKS}
        if cell.look is not None:
            cell.look.end_step("program")
    deltas = {k: leaf_norms({n: p.detach() - init[k][n] for n, p in c.module.named_parameters()})
              for k, c in comps.items()}
    moved = {name: getattr(state, name).clone() for name in STATE
             if getattr(state, name) is not None}
    del init
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - cell.t_start

    before = _host_probe(pool, device)
    marks: List[float] = []

    def window_batches():
        i = CHECKED_STEPS
        while True:
            marks.append(time.perf_counter())
            if marks[-1] - t0 >= cell.seconds:
                return
            yield pool[i % len(pool)]
            i += 1

    gc_clock = _GcClock()
    gc.callbacks.append(gc_clock)
    t0 = time.perf_counter()
    try:
        means = trainer.train_epoch(window_batches(), CHECKED_STEPS)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    finally:
        gc.callbacks.remove(gc_clock)
    cell.notes.append(_window_note([b - a for a, b in zip(marks, marks[1:])], gc_clock,
                                   before, _host_probe(pool, device)))
    n = int(means["steps"])
    step_s = window_s / max(n, 1)
    failed = 0 if math.isfinite(means.get("total_loss", math.nan)) else n

    summary: Dict[str, Any] = {}
    if cell.trace:
        from benchmark import trace

        k = int(traffic["trace_steps"])
        traced = [pool[(CHECKED_STEPS + n + i) % len(pool)] for i in range(k)]
        for op in (pairwise_mlp, knn_op, spectral):
            op.reset_launch_counts()

        def traced_steps():
            with torch.profiler.record_function("bench.train_epoch"):
                trainer.train_epoch(traced, CHECKED_STEPS + 1)

        summary = trace.profile(traced_steps, ("step.", "bench."))
        summary["units"] = k
        summary["kernel_launches"] = {**pairwise_mlp.LAUNCHES, **knn_op.LAUNCHES,
                                      **spectral.LAUNCHES}
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    del trainer, state, comps
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = check(cell, ref_mod, ref_cfg, pool, losses, first_grads, deltas, moved, moved1)
    if cell.trace:
        summary.update(step_s=step_s, memory_peak_bytes=memory_peak,
                       model_flops=work.train_step_flops(ref_cfg, ref_mod),
                       peak_ops=work.PEAK_OPS[ref_cfg.model.compute_dtype],
                       kernel_shapes=work.kernel_shapes(ref_cfg),
                       kernel_call_shapes=ref_mod.kernel_call_shapes(ref_cfg))
    return {"attempted": n, "failed": failed,
            "end_to_end": {"step_ms": step_s * 1e3, "setup_s": setup_s},
            "memory_peak_bytes": memory_peak, "summary": summary, "checks": checks}


def reference_steps(cell, ref_mod, ref_cfg, pool) -> Dict[str, Any]:
    """The plain reference's first three steps over the first three pool
    batches, from the same weights, state and generator seed: each step's
    losses, each leaf's first gradient and change, and the state it ends
    with."""
    device = cell.device
    with torch.device(device):
        ref = ref_mod.TrainReference(ref_cfg, device)
    init = weights.make(ref.models, cell.seed, device)
    for k, m in ref.models.items():
        m.load_state_dict(init[k])
    extra = weights.step_state(cell.seed, device, ref_cfg)
    for name in STATE:
        if name in extra:
            setattr(ref, name, extra[name].clone())
    ref.generator = torch.Generator(device=device).manual_seed(extra["generator_seed"])
    losses = []
    for i in range(CHECKED_STEPS):
        losses.append({k: float(v) for k, v in ref.step(pool[i]).items()})
        if i == 0:
            banks1 = {name: getattr(ref, name).clone() for name in BANKS}
        if cell.look is not None:
            cell.look.end_step("reference")
    out = {"losses": losses,
           "grads": {k: leaf_norms(o.first_grads) for k, o in ref.opts.items()},
           "deltas": {k: leaf_norms({n: p.detach() - init[k][n]
                                     for n, p in m.named_parameters()})
                      for k, m in ref.models.items()},
           "state": {name: (getattr(ref, name), extra[name]) for name in STATE
                     if name in extra},
           "banks1": {name: (banks1[name], extra[name]) for name in BANKS}}
    del ref, init
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def compare(cell, losses, first_grads, deltas, moved, moved1, ref) -> Dict[str, Any]:
    """Every reading of the program's three steps against the reference's,
    and the detail behind them."""
    ref_losses, ref_grads = ref["losses"], ref["grads"]
    keep = {k: {n: v >= MOVE_FLOOR * median(list(grads.values())) for n, v in grads.items()}
            for k, grads in ref_grads.items()}
    step_gaps = [_rel(a["total_loss"], b["total_loss"]) for a, b in zip(losses, ref_losses)]
    key_gaps = [{k: _rel(a[k], b[k]) for k in b if k in a} for a, b in zip(losses, ref_losses)]
    grads = _leaf_gaps(first_grads, ref_grads)
    moves = _leaf_gaps(deltas, ref["deltas"], keep)
    all_grads = {f"{c}/{n}": v for c, g in grads.items() for n, v in g.items()}
    all_moves = {f"{c}/{n}": v for c, g in moves.items() for n, v in g.items()}
    comp_med = {c: median(list(g.values())) for c, g in moves.items() if g}
    grad_med = {c: median(list(g.values())) for c, g in grads.items() if g}
    readings = {"loss_gap": max(step_gaps), "loss1_gap": step_gaps[0],
                "grad_gap": max(all_grads.values()),
                "grad_med_gap": median(list(all_grads.values())),
                "delta_gap": max(all_moves.values()),
                "delta_med_gap": median(list(all_moves.values())),
                "delta_comp_med_gap": max(comp_med.values()),
                "grad_comp_med_gap": max(grad_med.values())}
    held = cell.traffic.get("steady_grad_components")  # whose worst leaf no choice reaches
    if held:
        readings["grad_steady_gap"] = max(v for c in held for v in grads[c].values())
    steady = cell.traffic.get("steady_loss_keys")  # a list of loss terms per checked step
    if steady:
        readings["loss_steady_gap"] = max(key_gaps[i][k] for i, keys in enumerate(steady)
                                          for k in keys)
    state_gaps = {name: _state_gap(moved[name], *ref["state"][name]) for name in ref["state"]}
    for reading, names in (("seed_gap", BANKS), ("queue_gap", ("queue_source", "queue_target"))):
        if any(name in state_gaps for name in names):
            readings[reading] = max(state_gaps[name] for name in names if name in state_gaps)
    readings["seed1_gap"] = max(_state_gap(moved1[name], *ref["banks1"][name]) for name in BANKS)
    return {"readings": readings, "loss_gap_by_step": step_gaps, "loss_key_gaps": key_gaps,
            "delta_med_gap_by_component": comp_med,
            "grad_med_gap_by_component": grad_med,
            "worst_grad_by_component": {c: max(g.items(), key=lambda kv: kv[1])
                                        for c, g in grads.items() if g},
            "worst_delta_leaves": {c: max(g.items(), key=lambda kv: kv[1])
                                   for c, g in moves.items() if g},
            "state_gaps": state_gaps,
            "left_out_of_delta": sum(not v for c in keep.values() for v in c.values())}


def check(cell, ref_mod, ref_cfg, pool, losses, first_grads, deltas, moved, moved1
          ) -> List[List]:
    """Run the plain reference over the first three pool batches and return
    [name, reading, limit] for each number the cell's limits name."""
    ref = reference_steps(cell, ref_mod, ref_cfg, pool)
    found = compare(cell, losses, first_grads, deltas, moved, moved1, ref)
    cell.notes.append(found)
    if cell.look is not None:
        cell.notes.append({"look": cell.look.report()})
        with cell.look.replaying():
            replayed = reference_steps(cell, ref_mod, ref_cfg, pool)
        cell.notes.append({"replayed": compare(cell, losses, first_grads, deltas, moved,
                                               moved1, replayed),
                           "swapped": cell.look.swapped})
    readings = found["readings"]
    return [[name, readings[name], limit] for name, limit in cell.limits.items()]
