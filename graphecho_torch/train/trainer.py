"""Host-side Trainer, port of `graphecho_tpu/train/trainer.py`.

The reference `Trainer` contract (`train_camus_echo.py:45-515`,
`train_cardiac_uda.py:57-614`):

  * `train()` runs the epoch loop, one train step per batch, and validates
    after each epoch;
  * `validation(batches, name, is_video)` accumulates confusion counts with
    the reference's metric definitions (`train_camus_echo.py:402-417`), prints
    per-part dice and, for the cardiac variant, leaves out the BG channel;
  * full-state checkpoints (`train/checkpoint.py`, a superset of the
    reference's network-only saves) after each epoch, tagged with the
    selected validation dice; `init_state` resumes from the latest one;
  * a SIGTERM/SIGINT during `train()` stops the run after the current step
    with an emergency checkpoint (`utils/preemption.py`);
  * scalar summaries and, with `record_params`, parameter histograms
    (`utils/summary.py`).

Losses and counts stay on the device and come to the host once per epoch and
once per validation pass.

Data parallel (`use_mesh` or a `mesh`, `parallel/mesh.py`): one process per
device. Each rank's train batches are its row block of the global batch (the
per-rank loaders of `real_training.py` give them); eval batches are the
global ones on every rank. The state is broadcast from rank 0 after it is
built or restored; rank 0 alone writes checkpoints and summaries, and every
rank restores. A stop signal on any rank stops every rank after the same
step.
"""

from __future__ import annotations

import itertools
import logging
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

from graphecho_torch.config import ExperimentConfig
from graphecho_torch.device import resolve_device
from graphecho_torch.parallel.mesh import (Mesh, any_rank, create_mesh, replicate,
                                           replicate_generator)
from graphecho_torch.train.checkpoint import TENSORS, CheckpointManager
from graphecho_torch.train.metrics import overlap_metrics_from_counts
from graphecho_torch.train.state import TrainState, create_train_state
from graphecho_torch.train.steps import (build_models, check_supported, make_eval_step,
                                         make_train_step)
from graphecho_torch.utils.preemption import PreemptionGuard
from graphecho_torch.utils.summary import SummaryWriter
from graphecho_torch.utils.torch_import import load_reference_checkpoint


def _logger(name: str, log_path: Optional[str]) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    if not logger.handlers:
        if log_path:
            fh = logging.FileHandler(log_path)
            fh.setLevel(logging.INFO)
            fh.setFormatter(logging.Formatter(
                "%(asctime)s - %(name)s - %(levelname)s - %(message)s"))
            logger.addHandler(fh)
        logger.addHandler(logging.StreamHandler())
    return logger


def _timed(batches: Iterable[Dict[str, Any]], waits: List[float]):
    """`batches`, appending to `waits` the host seconds each `next` blocked."""
    it = iter(batches)
    while True:
        t0 = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            return
        waits.append(time.perf_counter() - t0)
        yield batch


def replicate_state(mesh: Mesh, state: TrainState) -> None:
    """Give every rank rank 0's state: the modules' parameters and buffers,
    the optimizers' tensors, the seed banks, the queues and the generator."""
    comps = state.components()
    replicate(mesh, itertools.chain(
        (t for c in comps for t in itertools.chain(c.module.parameters(), c.module.buffers())),
        (v for c in comps for st in c.opt.state.values() for v in st.values()
         if torch.is_tensor(v)),
        (getattr(state, n) for n in TENSORS if getattr(state, n) is not None)))
    replicate_generator(mesh, state.generator)


class Trainer:
    def __init__(self, cfg: ExperimentConfig, steps_per_epoch: int = 1,
                 device=None, mesh: Optional[Mesh] = None, use_mesh: bool = False,
                 log_path: Optional[str] = None,
                 checkpoint_dir: Optional[str] = None,
                 summary_dir: Optional[str] = None,
                 drop_bg_channel_in_eval: Optional[bool] = None):
        check_supported(cfg)
        self.cfg = cfg
        self.mesh = mesh if mesh is not None else (
            create_mesh(cfg.train.mesh_data) if use_mesh else None)
        self.is_chief = self.mesh is None or self.mesh.rank == 0
        self.device = resolve_device(device)
        self.steps_per_epoch = steps_per_epoch
        self.logger = _logger("graphecho_torch", log_path)
        if cfg.train.debug_nans:
            # the reference leaves detect_anomaly on (`train_camus_echo.py:39`)
            torch.autograd.set_detect_anomaly(True)
        self.models = build_models(cfg)
        if drop_bg_channel_in_eval is None:
            # the cardiac variant drops the BG channel (`train_cardiac_uda.py:399-400`);
            # the JAX package's rule, where the recipe's entry point does not say
            drop_bg_channel_in_eval = cfg.model.backbone == "VGG16"
        self._train_step = make_train_step(cfg, self.mesh)
        self._eval_step = make_eval_step(cfg, drop_bg_channel_in_eval, self.mesh)
        self.ckpt = CheckpointManager(checkpoint_dir) if checkpoint_dir else None
        self.summary = SummaryWriter(summary_dir) if summary_dir and self.is_chief else None
        self._preemption: Optional[PreemptionGuard] = None
        self._stopped = False
        self.state: Optional[TrainState] = None
        self.last_epoch_metrics: Dict[str, float] = {}
        self.last_dices: Dict[str, float] = {}

    # ------------------------------------------------------------------ setup
    def init_state(self, sample_batch: Optional[Dict[str, Any]] = None,
                   seed: Optional[int] = None,
                   torch_init: Optional[str] = None) -> TrainState:
        """Weights from the generator seeded with `cfg.train.seed` (or `seed`),
        replaced by the latest checkpoint's whole state when `checkpoint_dir`
        holds one, else, with `torch_init`, the FPN's from an upstream torch
        `.pth` (a torchvision ResNet or a GraphEcho checkpoint, the
        reference's `pretrained` knob, `utils/torch_import.py`).
        `sample_batch` is accepted for the JAX package's signature; the torch
        modules know their shapes without one."""
        state = create_train_state(self.cfg, self.models, self.device,
                                   self.steps_per_epoch, seed)
        if self.ckpt is not None and self.ckpt.restore(state) is not None:
            self.logger.info("resumed from checkpoint step %s", state.step)
        elif torch_init:
            skipped = load_reference_checkpoint(state.net.module, torch_init)
            self.logger.info("FPN initialized from torch checkpoint %s (%d keys skipped)",
                             torch_init, len(skipped))
        if self.mesh is not None:
            replicate_state(self.mesh, state)
        self.state = state
        return self.state

    # ------------------------------------------------------------------ train
    def train_epoch(self, batches: Iterable[Dict[str, Any]], epoch: int) -> Dict[str, float]:
        assert self.state is not None, "call init_state first"
        t0 = time.time()
        device_agg: Optional[Dict[str, torch.Tensor]] = None
        n = 0
        waits: List[float] = []
        for batch in _timed(batches, waits):
            metrics = self._train_step(self.state, batch)
            device_agg = metrics if device_agg is None else {
                k: device_agg[k] + v for k, v in metrics.items()}
            n += 1
            stop = self._preemption is not None and self._preemption.should_stop
            if self.mesh is not None and self.mesh.size > 1:
                # every rank stops after the same step (a host sync a step)
                stop = any_rank(self.mesh, stop)
            if stop:
                self.logger.warning("preemption signal at step %d: checkpointing + stop",
                                    self.state.step)
                self._stopped = True
                self._save(self.state.step)
                break
        else:  # the epoch ran to its end
            self.state.epoch = epoch + 1
        means: Dict[str, float] = {}
        if device_agg is not None:
            keys = list(device_agg)
            # one device -> host transfer for the whole epoch
            values = torch.stack([device_agg[k] for k in keys]).tolist()
            means = {k: v / n for k, v in zip(keys, values)}
        means["steps"] = n
        means["epoch_seconds"] = time.time() - t0
        means["step_seconds"] = means["epoch_seconds"] / max(n, 1)
        # host time blocked waiting for the loaders, per step
        means["loader_wait_seconds"] = sum(waits) / max(n, 1)
        if self.summary is not None:
            self.summary.add_scalars(means, self.state.step, "train/")
            if self.cfg.train.record_params:
                # per-parameter histograms (`train_camus_echo.py:307-310`)
                for name, p in self.state.net.module.named_parameters():
                    self.summary.add_histogram(f"params/{name}", p.detach().cpu().numpy(),
                                               self.state.step)
        self.logger.info("epoch %d | %d steps | loss %.4f | seg %.4f | %.1fs", epoch, n,
                         means.get("total_loss", float("nan")),
                         means.get("seg_loss", float("nan")), means["epoch_seconds"])
        self.last_epoch_metrics = means
        return means

    def train(self, batch_iter_fn: Callable[[], Iterable[Dict[str, Any]]],
              num_epochs: Optional[int] = None,
              eval_fns: Optional[Dict[str, Any]] = None,
              save_every: int = 1,
              select_metric: Optional[str] = None,
              on_epoch_end: Optional[Callable[[int, Dict[str, float],
                                               Dict[str, float]], None]] = None
              ) -> TrainState:
        """batch_iter_fn: a fresh finite batch iterator per epoch. eval_fns:
        name -> fn returning (imgs, masks) eval batches, or (fn, is_video).
        A checkpoint is saved after the epochs whose index `save_every`
        divides; select_metric names the eval set whose dice tags it (the
        reference tags saves with the VIDEO TEST dice,
        `train_cardiac_uda.py:371-372,572-587`; default: the last set). A
        SIGTERM/SIGINT stops the run after the current step with a
        checkpoint at that step."""
        num_epochs = num_epochs or self.cfg.train.num_epochs
        self._preemption = PreemptionGuard()
        self._stopped = False
        try:
            for epoch in range(num_epochs):
                means = self.train_epoch(batch_iter_fn(), epoch)
                if self._stopped:
                    break
                dices: Dict[str, float] = {}
                for name, fn in (eval_fns or {}).items():
                    fn, is_video = fn if isinstance(fn, tuple) else (fn, False)
                    dices[name] = self.validation(fn(), name, is_video=is_video)
                self.last_dices = dices
                if on_epoch_end is not None:
                    on_epoch_end(epoch, means, dices)
                if epoch % save_every == 0:
                    metrics = None
                    if dices:
                        sel = select_metric if select_metric in dices else next(reversed(dices))
                        metrics = {"dice": dices[sel], "dice_metric": sel,
                                   **{f"dice/{k}": v for k, v in dices.items()}}
                    self._save(self.state.step, metrics)
        finally:
            self._preemption.uninstall()
            self._preemption = None
        return self.state

    def _save(self, step: int, metrics: Optional[Dict[str, Any]] = None) -> None:
        """A checkpoint of the whole state, written by rank 0 alone."""
        if self.ckpt is not None and self.is_chief:
            self.ckpt.save(step, self.state, metrics=metrics)

    # ------------------------------------------------------------- validation
    def validation(self, batches: Iterable[Tuple[Any, Any]], name: str,
                   is_video: bool = False) -> float:
        """Returns dice (the reference selects models by it). Video batches
        (B,T,H,W,C) are flattened into the batch axis (`:384-387`)."""
        assert self.state is not None
        totals: Dict[str, torch.Tensor] = {}
        part_totals: Dict[str, Dict[str, torch.Tensor]] = {}
        loss_sum, n_batches = None, 0
        for imgs, masks in batches:
            imgs, masks = torch.as_tensor(imgs), torch.as_tensor(masks)
            if is_video:
                imgs = imgs.reshape(-1, *imgs.shape[-3:])
                masks = masks.reshape(-1, *masks.shape[-3:])
            counts, per_part, loss = self._eval_step(self.state, imgs, masks)
            loss_sum = loss if loss_sum is None else loss_sum + loss
            n_batches += 1
            for k, v in counts.items():
                totals[k] = totals.get(k, 0.0) + v
            for p, c in per_part.items():
                d = part_totals.setdefault(p, {})
                for k, v in c.items():
                    d[k] = d.get(k, 0.0) + v
        if not totals:
            self.logger.warning("validation [%s]: no batches, dice=0", name)
            return 0.0
        # one device -> host transfer for the pass
        keys = list(totals)
        parts = [(p, k) for p, c in part_totals.items() for k in c]
        host = torch.stack([loss_sum] + [totals[k] for k in keys]
                           + [part_totals[p][k] for p, k in parts]).tolist()
        loss_mean = host[0] / n_batches
        totals_h = dict(zip(keys, host[1:1 + len(keys)]))
        part_h: Dict[str, Dict[str, float]] = {}
        for (p, k), v in zip(parts, host[1 + len(keys):]):
            part_h.setdefault(p, {})[k] = v
        m = overlap_metrics_from_counts(totals_h)
        self.logger.info(
            "validation [%s] | loss %.4f | pixel_acc %.4f | dice %.4f | precision %.4f"
            " | specificity %.4f | recall %.4f", name, loss_mean, m.pixel_acc, m.dice,
            m.precision, m.specificity, m.recall)
        if self.cfg.train.seg_parts:
            for p, c in part_h.items():
                self.logger.info("  part %s dice %.4f", p, overlap_metrics_from_counts(c).dice)
        if self.summary is not None:
            self.summary.add_scalars({"dice": m.dice, "pixel_acc": m.pixel_acc},
                                     self.state.step, f"val/{name}/")
        return float(m.dice)
