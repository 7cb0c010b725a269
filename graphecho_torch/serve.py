"""Serving: a batch and video segmentation predictor, port of
`graphecho_tpu/serve.py`.

  * takes the FPN's weights as a state dict, or loads a train-state
    checkpoint (`train/checkpoint.py`);
  * bf16 compute by default (`compute_dtype="float32"` for f32), int8 PTQ
    with `quantize=True` (`graphecho_torch.quant`);
  * a fixed batch: every request runs in batches of `batch_size`, the last
    one zero-padded, so the card sees one shape;
  * video mode splits the frame axis over `devices`
    (`parallel/video_infer.py`);
  * `Predictor.export_compiled()` writes the inference graph with its
    weights (`torch.export`); `load_exported()` serves it without the
    model-building code of the port.

Frames come in as the JAX package's API takes them, (N, H, W[, 1]) float in
[0, 1] or uint8, and masks go out as (N, h, w, classes) int8 numpy arrays.
The Predictor runs on CUDA unless `device=` names another device; with no
card it raises (`device.resolve_device`).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from graphecho_torch.config import ExperimentConfig
from graphecho_torch.data.transforms import nearest_resize
from graphecho_torch.device import resolve_device

PROGRAM, META = "program.pt2", "meta.json"


def prep_frames(imgs, hw: Tuple[int, int]) -> np.ndarray:
    """(N, H, W) or (N, H, W, 1) frames in [0, 1] or uint8 -> (N, h, w, 1)
    float32 at the model's resolution, resized with the training pipeline's
    nearest semantics."""
    imgs = np.asarray(imgs)
    if imgs.ndim == 3:
        imgs = imgs[..., None]
    if imgs.dtype == np.uint8:
        imgs = imgs.astype(np.float32) / 255.0
    if imgs.shape[1:3] != tuple(hw):
        imgs = np.stack([nearest_resize(f, hw) for f in imgs]) if len(imgs) else \
            np.zeros((0, *hw, imgs.shape[3]), np.float32)
    return imgs.astype(np.float32)


def predict_batched(infer, x: np.ndarray, batch_size: int, device: torch.device,
                    num_classes: int) -> np.ndarray:
    """Run `infer` over `x` in zero-padded batches of `batch_size`."""
    n, h, w = x.shape[:3]
    if n == 0:
        return np.zeros((0, h, w, num_classes), np.int8)
    outs = []
    with torch.inference_mode():
        for i in range(0, n, batch_size):
            chunk = x[i:i + batch_size]
            pad = batch_size - chunk.shape[0]
            if pad:
                chunk = np.concatenate([chunk, np.zeros((pad,) + chunk.shape[1:], np.float32)])
            pred = infer(torch.from_numpy(chunk).to(device))
            outs.append(pred[:batch_size - pad].cpu().numpy())
    return np.concatenate(outs)


class Predictor:
    def __init__(self, cfg: ExperimentConfig, variables: Dict[str, torch.Tensor],
                 batch_size: int = 256, devices: Optional[Sequence] = None,
                 threshold: float = 0.5, quantize: bool = False,
                 calib_batches: Optional[Iterable] = None,
                 compute_dtype: str = "bfloat16", device=None):
        """`variables` is the FPN's state dict. `quantize=True` runs the
        backbone as int8 PTQ; `calib_batches`, an iterable of (B, H, W, 1)
        arrays, calibrates its activation scales (default: synthetic
        echo-like frames, `data/synthetic.py`; pass real frames from the
        deployment for the best int8 accuracy). The head runs in
        `compute_dtype`. `devices` splits `predict_video` over those devices;
        it is float-only, so `quantize` with `devices` raises rather than
        serve different numerics from `predict` and `predict_video`."""
        if quantize and devices is not None:
            raise ValueError(
                "Predictor(quantize=True, devices=...): the split video path is "
                "float-only; drop `devices` for int8 serving or `quantize` for "
                "split video inference")
        from graphecho_torch.train.steps import build_fpn

        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, compute_dtype=compute_dtype))
        self.cfg = cfg
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.threshold = threshold
        self._hw = tuple(cfg.data.img_crop)
        self._quantized = bool(quantize)
        self._variables = variables
        self.fpn = build_fpn(cfg).eval()
        self.fpn.load_state_dict(variables)
        self._video = None
        if quantize:
            from graphecho_torch.quant import make_quantized_infer, quantize_fpn_backbone

            if calib_batches is None:
                from graphecho_torch.data.synthetic import SyntheticEchoData

                probe = SyntheticEchoData(cfg, seed=0, batch_size=8)
                calib_batches = [probe.train_batch()["imgs_source"] for _ in range(4)]
            calib = [np.asarray(b, np.float32).transpose(0, 3, 1, 2) for b in calib_batches]
            # the float backbone stays on the host: the card holds the int8
            # kernels and the float head
            qb = quantize_fpn_backbone(self.fpn, calib, device=self.device)
            self._infer: nn.Module = make_quantized_infer(
                self.fpn, qb, threshold,
                bf16_features=compute_dtype == "bfloat16").to(self.device)
        else:
            from graphecho_torch.models.fpn import FPNMasks

            self._infer = FPNMasks(self.fpn.to(self.device), threshold)
            if devices is not None:
                from graphecho_torch.parallel.video_infer import make_video_infer

                self._video = make_video_infer(self.fpn, devices, threshold, batch_size)

    @property
    def variables(self) -> Dict[str, torch.Tensor]:
        return self._variables

    @variables.setter
    def variables(self, v: Dict[str, torch.Tensor]) -> None:
        """Hot-swap the serving weights: a float predictor loads them into
        its FPN, which the batch and the video path share. An int8 predictor
        refuses: its activation scales were calibrated for the weights it
        was built with, so a swap would serve miscalibrated numerics."""
        if self._quantized:
            raise ValueError(
                "int8 Predictor weights are frozen at construction "
                "(activation scales were calibrated for them); build a new "
                "Predictor(quantize=True) to serve updated weights")
        self.fpn.load_state_dict(v)
        self._variables = v

    @classmethod
    def from_checkpoint(cls, cfg: ExperimentConfig, checkpoint_dir: str,
                        **kwargs) -> "Predictor":
        """Restore the latest train-state checkpoint of `cfg` from
        `checkpoint_dir` and serve its FPN. The state is restored onto the
        Predictor's device, the kind of device a checkpoint's step generator
        was saved from (a CUDA generator's state does not load into a CPU
        one)."""
        from graphecho_torch.train.checkpoint import CheckpointManager
        from graphecho_torch.train.state import create_train_state
        from graphecho_torch.train.steps import build_models

        state_like = create_train_state(cfg, build_models(cfg),
                                        resolve_device(kwargs.get("device")))
        state = CheckpointManager(checkpoint_dir).restore(state_like)
        if state is None:
            raise FileNotFoundError(f"no checkpoint in {checkpoint_dir}")
        return cls(cfg, state.net.module.state_dict(), **kwargs)

    def _prep(self, imgs) -> np.ndarray:
        return prep_frames(imgs, self._hw)

    def predict(self, imgs) -> np.ndarray:
        """(N, H, W[, 1]) frames -> (N, h, w, num_classes) int8 masks."""
        return predict_batched(self._infer, self._prep(imgs), self.batch_size, self.device,
                               self.cfg.model.num_classes)

    def predict_video(self, frames) -> np.ndarray:
        """(T, H, W[, 1]) video -> (T, h, w, C) masks; split over `devices`
        when the Predictor was given them."""
        x = self._prep(frames)
        if self._video is None or len(x) == 0:
            return self.predict(x)
        pred, _ = self._video(torch.from_numpy(x))
        return pred.cpu().numpy()

    def weight_bytes(self) -> int:
        """Bytes of the weights the inference function reads."""
        return sum(t.numel() * t.element_size() for t in self._infer.state_dict().values())

    def export_compiled(self, path: str) -> None:
        """Write the batch inference function as a deployable artifact:
        `<path>/program.pt2`, the `torch.export` graph at this Predictor's
        batch with its weights (the threshold baked in; bf16 or int8 and
        scales), and `<path>/meta.json`. `load_exported(path)` serves it
        without the port's model-building code."""
        h, w = self._hw
        x = torch.zeros((self.batch_size, h, w, 1), device=self.device)
        with torch.inference_mode(False), torch.no_grad():
            program = torch.export.export(self._infer, (x,))
        os.makedirs(path, exist_ok=True)
        torch.export.save(program, os.path.join(path, PROGRAM))
        with open(os.path.join(path, META), "w") as f:
            json.dump({"batch_size": self.batch_size, "hw": [h, w],
                       "num_classes": self.cfg.model.num_classes,
                       "threshold": self.threshold,
                       "leaf_dtypes": [str(t.dtype).removeprefix("torch.")
                                       for t in program.state_dict.values()],
                       "compute_dtype": self.cfg.model.compute_dtype,
                       "quantized": self._quantized,
                       "device": str(self.device)}, f)


class ExportedPredictor:
    """Serves an `export_compiled()` artifact: the exported graph and its
    weights, no model code and no config tree. The same `predict()`
    contract as `Predictor` (any request size, padded to the exported
    batch)."""

    def __init__(self, module: Any, meta: Dict[str, Any]):
        self._module = module
        self.meta = meta
        self.batch_size = int(meta["batch_size"])
        self._hw = tuple(meta["hw"])
        self.num_classes = int(meta["num_classes"])
        self.threshold = float(meta["threshold"])
        self.device = torch.device(meta["device"])

    @classmethod
    def load(cls, path: str) -> "ExportedPredictor":
        with open(os.path.join(path, META)) as f:
            meta = json.load(f)
        return cls(torch.export.load(os.path.join(path, PROGRAM)).module(), meta)

    def predict(self, imgs) -> np.ndarray:
        return predict_batched(self._module, prep_frames(imgs, self._hw), self.batch_size,
                               self.device, self.num_classes)


def load_exported(path: str) -> ExportedPredictor:
    """Load a `Predictor.export_compiled()` artifact for serving."""
    return ExportedPredictor.load(path)
