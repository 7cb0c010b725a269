"""Upstream torch checkpoints into the port's FPN, port of
`graphecho_tpu/utils/torch_import.py`.

Two upstream surfaces (`models/fpnseg.py`):

  * the `pretrained` knob: a torchvision model-zoo ResNet state dict loaded
    into the backbone (`fpnseg.py:279-287`), keys `conv1`, `bn1`,
    `layer{i}.{j}.conv1`, `layer{i}.{j}.downsample.0/1`;
  * whole GraphEcho checkpoints, `torch.save({'network': state_dict})`
    (`train_camus_echo.py:475-488`), keys `back_bone.*` (torchvision ResNet
    or VGG `block_{b}.{pos}` naming) plus the pyramid and semantic head.

The port's FPN names its parameters as upstream does, so the map is the JAX
package's key map without its layout transposes: a key goes where the port
has the same name. Kept from there:

  * a grey model (one input channel) takes an RGB `conv1.weight` summed over
    its input channels, exact for grey frames replicated to RGB;
  * keys the port lacks (the zoo's [3, 4, 6, 3] ResNet50 beyond the
    reference's [3, 4, 5, 3] quirk, the `fc` classifier, the ReLU and
    MaxPool positions of VGG) and shape mismatches are skipped and reported;
  * `module.` DDP prefixes and `num_batches_tracked` are dropped.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import torch
from torch import nn


def _fit(value: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """`value` shaped as `want`: an RGB stem summed to grey, else unchanged."""
    if (value.shape != want.shape and value.dim() == 4 and want.dim() == 4
            and want.shape[1] == 1 and value.shape[0] == want.shape[0]
            and value.shape[2:] == want.shape[2:]):
        return value.sum(dim=1, keepdim=True)
    return value


def fpn_state_from_torch(state_dict: Mapping[str, torch.Tensor], fpn: nn.Module
                         ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """An upstream state dict (a whole GraphEcho FPN, or a bare torchvision
    ResNet, which initialises the backbone only) -> (the port FPN's
    `state_dict` with the upstream values in place, the upstream keys
    skipped). Entries the upstream dict lacks keep `fpn`'s values."""
    is_full_fpn = any(k.removeprefix("module.").startswith("back_bone.") for k in state_dict)
    out = {k: v.detach().clone() for k, v in fpn.state_dict().items()}
    skipped: List[str] = []
    for key, value in state_dict.items():
        name = key.removeprefix("module.")
        if name.endswith("num_batches_tracked"):
            continue
        if not is_full_fpn:
            name = "back_bone." + name
        want = out.get(name)
        value = torch.as_tensor(value)
        if want is None:
            skipped.append(key)
            continue
        value = _fit(value, want)
        if value.shape != want.shape:
            skipped.append(key)
            continue
        out[name] = value.to(want.dtype).clone()
    return out, skipped


def load_reference_checkpoint(fpn: nn.Module, path: str) -> List[str]:
    """Load an upstream `net_{epoch}.pth` (possibly `{'network': ...}` with
    `module.` prefixes) or a torchvision zoo `.pth` into `fpn` in place.
    Returns the keys skipped."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "network" in obj:
        obj = obj["network"]
    sd, skipped = fpn_state_from_torch(obj, fpn)
    fpn.load_state_dict(sd)
    return skipped
