"""Frame-split video segmentation inference, port of
`graphecho_tpu/parallel/video_infer.py`.

The reference's only sequence axis is the video's frame axis, flattened into
the batch (`train_cardiac_uda.py:384-387`). Per-frame FPN inference needs
nothing from other frames, so a video splits over devices along that axis:
each device segments one contiguous chunk with a replica of the weights, and
no device talks to another on the way.
"""

from __future__ import annotations

import copy
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import nn

from graphecho_torch.models.fpn import FPNMasks


def _canonical(device) -> torch.device:
    """`cuda` -> `cuda:<current>`, so that equal devices compare equal."""
    return torch.empty(0, device=device).device


def make_video_infer(fpn: nn.Module, devices: Sequence, threshold: float = 0.5,
                     batch_size: Optional[int] = None
                     ) -> Callable[[torch.Tensor], Tuple[torch.Tensor, int]]:
    """Returns `run(frames) -> (pred, T)`: (T, H, W, C) float frames to
    (T, H, W, classes) int8 masks on `devices[0]`, the frame axis split into
    one contiguous chunk per device, T padded with zero frames to a multiple
    of the device count. `fpn` runs on its own device; every other device
    holds a replica whose weights are copied from `fpn` on each call, so a
    hot swap of `fpn` reaches every device. With `batch_size`, each device
    runs its chunk in zero-padded batches of that size, the shape the
    caller's batch path runs (so both give the same masks bit for bit).
    `threshold` must be the batch path's."""
    devices = [_canonical(d) for d in devices]
    home = next(fpn.parameters()).device
    replicas = {d: FPNMasks(fpn if d == home else copy.deepcopy(fpn).to(d), threshold)
                for d in dict.fromkeys(devices)}

    def segment(infer: FPNMasks, chunk: torch.Tensor) -> torch.Tensor:
        if batch_size is None:
            return infer(chunk)
        outs = []
        for i in range(0, chunk.shape[0], batch_size):
            part = chunk[i:i + batch_size]
            pad = batch_size - part.shape[0]
            if pad:
                part = torch.cat([part, part.new_zeros((pad,) + part.shape[1:])])
            outs.append(infer(part)[:batch_size - pad])
        return torch.cat(outs)

    @torch.inference_mode()
    def run(frames: torch.Tensor) -> Tuple[torch.Tensor, int]:
        t, n = frames.shape[0], len(devices)
        pad = (-t) % n
        if pad:
            frames = torch.cat([frames, frames.new_zeros((pad,) + frames.shape[1:])])
        state = fpn.state_dict()
        for d, infer in replicas.items():
            if d != home:
                infer.fpn.load_state_dict(state)
        chunks = frames.chunk(n)
        preds = [segment(replicas[d], c.to(d)) for d, c in zip(devices, chunks)]
        pred = torch.cat([p.to(devices[0]) for p in preds])
        return pred[:t], t

    return run
