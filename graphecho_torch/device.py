"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names another.

    With no `device` argument and no CUDA device this raises instead of
    quietly running on the CPU: a CPU run is only ever asked for explicitly
    (`device="cpu"`, as the tests do)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "graphecho_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU explicitly")
    return torch.device("cuda")
