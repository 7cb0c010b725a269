"""The weight bridge: flax variables of the JAX package -> the port's state dicts.

`from_flax` takes the JAX package's train-state trees as nested dicts of numpy
arrays (no JAX import is needed to call it) and returns what the port's
modules load with `load_state_dict`:

  * conv kernels HWIO -> OIHW, 1-D conv kernels (W, I, O) -> (O, I, W) (the
    ViG's grouped 1x1 convs: (1, Cin/groups, Cout) -> what `nn.Conv1d`
    loads), Dense kernels (in, out) -> (out, in);
  * BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var;
  * GroupNorm and LayerNorm scale/bias -> weight/bias;
  * the Affinity's split `fc1_wx`/`fc1_wy`/`fc1_b`/`fc2_w`/`fc2_b` are kept
    as they are (the port keeps the same split parameters and layouts).

`qparams_from_flax` carries the JAX package's int8 PTQ parameters
(`QuantizedBackbone.qparams()`) over to the port's int8 executor
(`graphecho_torch/quant/ptq.py`), by layer name.

The FPN's torch names are the reference's (`back_bone.layer1.0.conv1`,
`back_bone.block_1.0`, torchvision's `downsample.0/1`), so a state dict that
went through `graphecho_tpu/utils/torch_import.py` comes back unchanged. The
graph head, the discriminators and the ViG/DeepGCN keep the flax module names.
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
        if value.ndim == 3:
            return "weight", _t(value.transpose(2, 1, 0))  # 1-D conv WIO -> OIW
        if value.ndim == 2:
            return "weight", _t(value.T)  # Dense (in, out) -> (out, in)
        raise ValueError(f"kernel of rank {value.ndim}: shape {value.shape}")
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


def _walk_stats(tree: Mapping, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    """Flax `batch_stats` subtree -> running_mean/running_var by '.'-joined name."""
    for key, value in tree.items():
        if isinstance(value, Mapping):
            _walk_stats(value, f"{prefix}{key}.", out)
        else:
            out[prefix + _BN_STATS[key]] = _t(value)


def _bn(out, prefix: str, params: Mapping, stats: Mapping) -> None:
    _walk(params, prefix, out)
    _walk_stats(stats, prefix, out)


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


def vig_state_dict(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of the port's `models/vig.py::DeepGCN` from the flax
    DeepGCN's `params`/`batch_stats`: the names are the flax names, the
    `pos_embed` (1, H, W, C) becomes (1, C, H, W), GIN's `eps` passes as it is."""
    out: Dict[str, torch.Tensor] = {}
    _walk(params, "", out)
    _walk_stats(batch_stats, "", out)
    if "pos_embed" in out:
        out["pos_embed"] = out["pos_embed"].permute(0, 3, 1, 2).contiguous()
    return out


def tgcn_state_dict(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of the port's `models/tgcn.py::TGCN` from the flax TGCN's
    `params`/`batch_stats`: the flax names, and `pos_embed` (T, 1, H, W, C)
    as (T, 1, C, H, W). The LayerNorms of `node_dis` have no parameters."""
    out: Dict[str, torch.Tensor] = {}
    _walk(params, "", out)
    _walk_stats(batch_stats, "", out)
    out["pos_embed"] = out["pos_embed"].permute(0, 1, 4, 2, 3).contiguous()
    return out


def from_flax(variables: Mapping[str, Any]) -> Dict[str, Any]:
    """Convert a JAX train state to the port's state dicts.

    `variables` holds any of the JAX `TrainState` fields as nested dicts of
    numpy arrays: `net_params` with `net_batch_stats`, `gmn_params`,
    `dis_params` (level -> params), the seed banks `sr_seed`/`tg_seed`,
    `tgcn_params` with `tgcn_batch_stats`, the momentum queues
    `queue_source`/`queue_target`, and a DeepGCN's `vig_params` with
    `vig_batch_stats`. Returns {"fpn": ..., "gmodule": ..., "dis": {level:
    ...}, "tgcn": ..., "sr_seed": ..., "tg_seed": ..., "queue_source": ...,
    "queue_target": ..., "vig": ...} for the fields present."""
    out: Dict[str, Any] = {}
    if "net_params" in variables:
        out["fpn"] = fpn_state_dict(variables["net_params"],
                                    variables["net_batch_stats"])
    if variables.get("gmn_params") is not None:
        out["gmodule"] = module_state_dict(variables["gmn_params"])
    if variables.get("dis_params") is not None:
        out["dis"] = {lvl: module_state_dict(p)
                      for lvl, p in variables["dis_params"].items()}
    if variables.get("vig_params") is not None:
        out["vig"] = vig_state_dict(variables["vig_params"],
                                    variables.get("vig_batch_stats", {}))
    if variables.get("tgcn_params") is not None:
        out["tgcn"] = tgcn_state_dict(variables["tgcn_params"],
                                      variables.get("tgcn_batch_stats", {}))
    for name in ("sr_seed", "tg_seed", "queue_source", "queue_target"):
        if variables.get(name) is not None:
            out[name] = _t(variables[name])
    return out


_QCONV_RESNET = re.compile(r"^layer(\d+)_block(\d+)/(conv[123]|conv_down)$")


def _qlayer_name(name: str) -> str:
    """A JAX int8 layer name -> the port's (`layer1_block0/conv_down` ->
    `layer1.0.downsample.0`, `block2_conv3` -> `block_2.6`)."""
    m = _QCONV_RESNET.match(name)
    if m:
        part = "downsample.0" if m.group(3) == "conv_down" else m.group(3)
        return f"layer{m.group(1)}.{m.group(2)}.{part}"
    m = _VGG_CONV.match(name)
    if m:
        return f"block_{m.group(1)}.{3 * (int(m.group(2)) - 1)}"
    if name == "conv1":
        return name
    raise ValueError(f"unknown int8 layer {name!r}")


def qparams_from_flax(qparams: Mapping[str, Mapping[str, Any]]) -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX package's int8 `qparams()` (layer -> `wq` int8 HWIO,
    `w_scale`, `bias`, `in_scale`; numpy arrays) as the port's
    `QuantizedBackbone.load_qparams` takes them: port layer names, `wq` OIHW
    int8, the scales and biases float32 as they are."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, p in qparams.items():
        wq = np.asarray(p["wq"])
        if wq.dtype != np.int8:
            raise ValueError(f"{name}: wq is {wq.dtype}, not int8")
        out[_qlayer_name(name)] = {
            "wq": torch.from_numpy(np.ascontiguousarray(wq.transpose(3, 2, 0, 1))),
            "w_scale": _t(p["w_scale"]), "bias": _t(p["bias"]),
            "in_scale": _t(p["in_scale"]).reshape(())}
    return out
