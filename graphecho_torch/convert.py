"""The weight bridge: flax variables of the JAX package -> the port's state dicts.

`from_flax` takes the JAX package's train-state trees as nested dicts of numpy
arrays (no JAX import is needed to call it) and returns what the port's
modules load with `load_state_dict`:

  * conv kernels HWIO -> OIHW, Dense kernels (in, out) -> (out, in);
  * BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var;
  * GroupNorm and LayerNorm scale/bias -> weight/bias;
  * the Affinity's split `fc1_wx`/`fc1_wy`/`fc1_b`/`fc2_w`/`fc2_b` are kept
    as they are (the port keeps the same split parameters and layouts).

The FPN's torch names are the reference's (`back_bone.layer1.0.conv1`,
`back_bone.block_1.0`, torchvision's `downsample.0/1`), so a state dict that
went through `graphecho_tpu/utils/torch_import.py` comes back unchanged. The
graph head and the discriminators keep the flax module names.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

_RESNET_BLOCK = re.compile(r"^layer(\d+)_block(\d+)$")
_VGG_CONV = re.compile(r"^block(\d+)_conv(\d+)$")
_BN_STATS = {"mean": "running_mean", "var": "running_var"}


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _leaf(name: str, value) -> tuple:
    """One flax leaf -> (torch leaf name, tensor)."""
    value = np.asarray(value)
    if name == "kernel":
        if value.ndim == 4:
            return "weight", _t(value.transpose(3, 2, 0, 1))  # HWIO -> OIHW
        return "weight", _t(value.T)  # Dense (in, out) -> (out, in)
    if name == "scale":
        return "weight", _t(value)
    return name, _t(value)


def _walk(tree: Mapping, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    """Flax param subtree -> torch names joined by '.'."""
    for key, value in tree.items():
        if isinstance(value, Mapping):
            _walk(value, f"{prefix}{key}.", out)
        else:
            leaf, tensor = _leaf(key, value)
            out[f"{prefix}{leaf}"] = tensor


def _bn(out, prefix: str, params: Mapping, stats: Mapping) -> None:
    _walk(params, prefix, out)
    for key, value in stats.items():
        out[prefix + _BN_STATS[key]] = _t(value)


def _backbone(params: Mapping, stats: Mapping, out: Dict[str, torch.Tensor]) -> None:
    pre = "back_bone."
    for name, sub in params.items():
        m = _RESNET_BLOCK.match(name)
        if m:
            block = f"{pre}layer{m.group(1)}.{m.group(2)}."
            for part, psub in sub.items():
                torch_part = {"conv_down": "downsample.0",
                              "bn_down": "downsample.1"}.get(part, part)
                if part.startswith("bn"):
                    _bn(out, f"{block}{torch_part}.", psub, stats[name][part])
                else:
                    _walk(psub, f"{block}{torch_part}.", out)
            continue
        m = _VGG_CONV.match(name)
        if m:
            # reference VGG blocks are Sequentials: conv at 3j, BN at 3j+1
            pos = 3 * (int(m.group(2)) - 1)
            block = f"{pre}block_{m.group(1)}."
            _walk(sub["Conv_0"], f"{block}{pos}.", out)
            _bn(out, f"{block}{pos + 1}.", sub["BatchNorm_0"],
                stats[name]["BatchNorm_0"])
        elif name == "bn1":
            _bn(out, f"{pre}bn1.", sub, stats["bn1"])
        else:  # the ResNet stem conv
            _walk(sub, f"{pre}{name}.", out)


def fpn_state_dict(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """The port FPN's state dict from the flax FPN's `params`/`batch_stats`."""
    out: Dict[str, torch.Tensor] = {}
    _backbone(params["backbone"], batch_stats["backbone"], out)
    _walk({k: v for k, v in params.items() if k != "backbone"}, "", out)
    return out


def module_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of a port module that keeps the flax module names (the
    GModule, a Discriminator)."""
    out: Dict[str, torch.Tensor] = {}
    _walk(params, "", out)
    return out


def from_flax(variables: Mapping[str, Any]) -> Dict[str, Any]:
    """Convert a JAX train state to the port's state dicts.

    `variables` holds any of the JAX `TrainState` fields as nested dicts of
    numpy arrays: `net_params` with `net_batch_stats`, `gmn_params`,
    `dis_params` (level -> params) and the seed banks `sr_seed`/`tg_seed`.
    Returns {"fpn": ..., "gmodule": ..., "dis": {level: ...}, "sr_seed": ...,
    "tg_seed": ...} for the fields present."""
    out: Dict[str, Any] = {}
    if "net_params" in variables:
        out["fpn"] = fpn_state_dict(variables["net_params"],
                                    variables["net_batch_stats"])
    if variables.get("gmn_params") is not None:
        out["gmodule"] = module_state_dict(variables["gmn_params"])
    if variables.get("dis_params") is not None:
        out["dis"] = {lvl: module_state_dict(p)
                      for lvl, p in variables["dis_params"].items()}
    for seed in ("sr_seed", "tg_seed"):
        if variables.get(seed) is not None:
            out[seed] = _t(variables[seed])
    return out
