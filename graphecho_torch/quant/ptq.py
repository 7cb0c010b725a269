"""Post-training int8 quantisation of the FPN backbones (inference only), port
of `graphecho_tpu/quant/ptq.py`.

The scheme is the JAX package's:
  * BatchNorm folded into the preceding conv (`fold_bn`);
  * per-output-channel symmetric int8 weights, scale max|w| / 127;
  * per-tensor symmetric int8 activations, scale absmax / 127 over a small
    calibration set (`QuantizedBackbone.calibrate`);
  * int8 x int8 -> int32 convolutions, then the dequantisation
    `acc * (x_scale * w_scale) + bias` in f32; everything that is not a
    conv (ReLU, residual adds, max-pools, the whole FPN head with its
    GroupNorms and resizes) stays float, the head through `FPNHead`.

The walk follows the port's backbone modules: the ResNet stem with its
-inf-bordered max-pool, every Bottleneck (`conv2` padded (1, 1) at stride s,
`downsample.0` at stride s unpadded), and each VGG block's convs as its
`block_spec` lays them out. Layers are named by their module path under
`back_bone` (`layer1.0.conv2`, `layer2.0.downsample.0`, `block_3.6`).

The int8 convolution has two routes, chosen by the device of its input:
  * on the card, `int8_conv_mm`: an im2col of the int8 activations made of
    tensor views, and `torch._int_mm` (cuBLASLt's int8 GEMM, int32
    accumulation). PyTorch has no int8 convolution, and `F.unfold` takes no
    int8. The JAX package's int8 conv is an XLA op, not a Pallas kernel;
    this is a library GEMM, not a hand kernel.
  * on the CPU, `int8_conv_plain`: `F.conv2d` in float64 on the int8 values.
    Every product and partial sum is an integer below 4608 * 127^2 < 2^53,
    so it is exact, and equal to the int32 accumulator bit for bit. (float32
    is not: the sums pass 2^24.)
Activations are NHWC inside the int8 backbone, so the im2col rows are
contiguous channel runs; the features come out as NCHW views.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from graphecho_torch.models.backbones import VGG16, BatchNorm2d, ResNet
from graphecho_torch.models.fpn import FPN, FPNHead, masks_nhwc

# one im2col chunk's int8 bytes: VGG block 1 at 256^2 is 37.7 MB a frame
IM2COL_BYTES = 1 << 30
Tap = Callable[[str, torch.Tensor, torch.Tensor], None]


def fold_bn(weight: torch.Tensor, bias: Optional[torch.Tensor], gamma: torch.Tensor,
            beta: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold BatchNorm (eval) into the preceding OIHW conv:
    y = gamma*(conv(x)+b - mu)/sqrt(var+eps) + beta
      = conv_{W*s}(x) + (b - mu)*s + beta,  s = gamma/sqrt(var+eps).
    The square root goes through float64: torch's vectorised float32 sqrt on
    the CPU is not correctly rounded, and the rounded float64 one is, as
    XLA's float32 sqrt is."""
    s = gamma / torch.sqrt((var + eps).double()).float()
    b0 = bias if bias is not None else 0.0
    return weight * s[:, None, None, None], (b0 - mean) * s + beta


def quant_weights(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 quantisation of an OIHW kernel."""
    scale = w.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12) / 127.0
    wq = torch.clamp(torch.round(w / scale[:, None, None, None]), -127, 127)
    return wq.to(torch.int8), scale


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """clip(round(x / scale), -127, 127) as int8; `torch.round` rounds half
    to even, as `jnp.round` does."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def int8_conv_plain(x8: torch.Tensor, wq: torch.Tensor, stride: Tuple[int, int],
                    padding: Tuple[int, int]) -> torch.Tensor:
    """int32 accumulators of the conv of NHWC int8 `x8` with OIHW int8 `wq`,
    computed exactly in float64."""
    y = F.conv2d(x8.permute(0, 3, 1, 2).double(), wq.double(), None, stride, padding)
    return y.to(torch.int32).permute(0, 2, 3, 1)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_conv_mm(x8: torch.Tensor, wq: torch.Tensor, stride: Tuple[int, int],
                 padding: Tuple[int, int]) -> torch.Tensor:
    """The same accumulators through an im2col and `torch._int_mm`.

    `_int_mm` takes (M, K) row-major times (K, N) column-major int8 with
    M > 16 and K, N multiples of 8: K and N are zero-padded (conv1 has
    K = 49, a VGG input conv K = 9) and a short M gets zero rows. The batch
    goes in chunks of at most `IM2COL_BYTES` of im2col."""
    o, _, kh, kw = wq.shape
    (sh, sw), (ph, pw) = stride, padding
    if ph or pw:
        x8 = F.pad(x8, (0, 0, pw, pw, ph, ph))
    b, hp, wp, c = x8.shape
    ho, wo = (hp - kh) // sh + 1, (wp - kw) // sw + 1
    k, kp, op = kh * kw * c, _round_up(kh * kw * c, 8), _round_up(o, 8)
    wmat = F.pad(wq.permute(0, 2, 3, 1).reshape(o, k), (0, kp - k, 0, op - o))
    per_chunk = max(1, IM2COL_BYTES // (ho * wo * kp))
    outs = []
    for i in range(0, b, per_chunk):
        xs = x8[i:i + per_chunk]
        if kh == kw == 1:
            cols = xs[:, ::sh, ::sw]
        else:  # (n, ho, wo, c, kh, kw) -> rows of (kh, kw, c), the weights' order
            cols = xs.unfold(1, kh, sh).unfold(2, kw, sw).permute(0, 1, 2, 4, 5, 3)
        cols = cols.reshape(-1, k)
        m = cols.shape[0]
        cols = F.pad(cols, (0, kp - k, 0, max(0, 17 - m)))
        outs.append(torch._int_mm(cols, wmat.t())[:m, :o])
    return torch.cat(outs).reshape(b, ho, wo, o)


def int8_conv(x8: torch.Tensor, wq: torch.Tensor, stride: Tuple[int, int],
              padding: Tuple[int, int]) -> torch.Tensor:
    """The int8 conv's int32 accumulators (NHWC): `_int_mm` for a CUDA
    tensor, the exact float64 plain version for a CPU tensor."""
    route = int8_conv_mm if x8.is_cuda else int8_conv_plain
    return route(x8, wq, stride, padding)


def _conv_float(t: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                stride: Tuple[int, int], padding: Tuple[int, int]) -> torch.Tensor:
    return F.conv2d(t.permute(0, 3, 1, 2), w, bias, stride, padding).permute(0, 2, 3, 1)


def _max_pool(t: torch.Tensor, k: int, s: int, p: int = 0) -> torch.Tensor:
    """NHWC max-pool; a padding border is -inf (`F.max_pool2d`'s own)."""
    return F.max_pool2d(t.permute(0, 3, 1, 2), k, s, p).permute(0, 2, 3, 1)


class QConv(nn.Module):
    """One BN-folded, int8-quantised conv. The buffers are what the int8
    forward reads (and what an export carries); the folded float kernel
    stays on the host as `w_float`, for calibration and as a reference."""

    def __init__(self, w_float: torch.Tensor, bias: torch.Tensor,
                 stride: Tuple[int, int], padding: Tuple[int, int]):
        super().__init__()
        wq, w_scale = quant_weights(w_float)
        self.register_buffer("wq", wq)
        self.register_buffer("w_scale", w_scale)
        self.register_buffer("bias", bias.detach().clone())
        self.register_buffer("in_scale", torch.zeros((), dtype=torch.float32))
        self.w_float = w_float.detach().cpu()
        self.stride, self.padding = tuple(stride), tuple(padding)

    def forward(self, t: torch.Tensor, name: str = "", tap: Optional[Tap] = None
                ) -> torch.Tensor:
        x8 = quantize(t, self.in_scale)
        acc = int8_conv(x8, self.wq, self.stride, self.padding)
        if tap is not None:
            tap(name, x8, acc)
        return acc.float() * (self.in_scale * self.w_scale) + self.bias


def _folded(conv: nn.Conv2d, bn: BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    with torch.no_grad():
        return fold_bn(conv.weight.float(), None if conv.bias is None else conv.bias.float(),
                       bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)


def _conv_bn_pairs(back_bone: nn.Module) -> Dict[str, Tuple[nn.Conv2d, BatchNorm2d]]:
    """Every (conv, its BatchNorm) of a port backbone, by the conv's path."""
    pairs: Dict[str, Tuple[nn.Conv2d, BatchNorm2d]] = {}
    if isinstance(back_bone, VGG16):
        for bi, (_, n_convs) in enumerate(back_bone.block_spec):
            block = getattr(back_bone, f"block_{bi + 1}")
            for ci in range(n_convs):
                pairs[f"block_{bi + 1}.{3 * ci}"] = (block[3 * ci], block[3 * ci + 1])
        return pairs
    if not isinstance(back_bone, ResNet):
        raise ValueError(f"no int8 walk for {type(back_bone).__name__}")
    pairs["conv1"] = (back_bone.conv1, back_bone.bn1)
    for si in range(4):
        for bi, blk in enumerate(getattr(back_bone, f"layer{si + 1}")):
            p = f"layer{si + 1}.{bi}."
            for j in (1, 2, 3):
                pairs[f"{p}conv{j}"] = (getattr(blk, f"conv{j}"), getattr(blk, f"bn{j}"))
            if blk.downsample is not None:
                pairs[f"{p}downsample.0"] = (blk.downsample[0], blk.downsample[1])
    return pairs


class QuantizedBackbone(nn.Module):
    """int8 executor of a trained FPN backbone. `self(x)` is the int8
    forward: (B, C_in, H, W) float -> the five float feature levels, NCHW,
    as the port's backbones return them. `float_forward(x)` runs the
    BN-folded float mirror."""

    def __init__(self, back_bone: nn.Module):
        super().__init__()
        if isinstance(back_bone, VGG16):
            self.kind, self.layout = "VGG16", tuple(n for _, n in back_bone.block_spec)
        else:
            self.kind = "resnet"
            self.layout = tuple(len(getattr(back_bone, f"layer{i + 1}")) for i in range(4))
        self.names: List[str] = []
        self.layers = nn.ModuleDict()
        for name, (conv, bn) in _conv_bn_pairs(back_bone).items():
            w, b = _folded(conv, bn)
            self.names.append(name)
            self.layers[name.replace(".", "_")] = QConv(w, b, conv.stride, conv.padding)

    def layer(self, name: str) -> QConv:
        return self.layers[name.replace(".", "_")]

    # ------------------------------------------------------------- params
    def qparams(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """Per layer: int8 OIHW `wq`, `w_scale` (O,), folded `bias` (O,) and
        the activation `in_scale` (0-d), as the JAX `qparams()` holds them."""
        return {n: {k: getattr(self.layer(n), k) for k in ("wq", "w_scale", "bias", "in_scale")}
                for n in self.names}

    def load_qparams(self, qparams: Dict[str, Dict[str, torch.Tensor]]) -> None:
        """Replace every layer's int8 weights and scales (e.g. the JAX
        package's, through `convert.qparams_from_flax`)."""
        if set(qparams) != set(self.names):
            raise ValueError(f"qparams name {sorted(set(qparams) ^ set(self.names))[:4]}")
        with torch.no_grad():
            for n, p in qparams.items():
                for k, v in p.items():
                    getattr(self.layer(n), k).copy_(v)

    # ------------------------------------------------------------- forward
    def _walk(self, x: torch.Tensor, conv: Callable[[str, torch.Tensor], torch.Tensor]
              ) -> List[torch.Tensor]:
        """The backbone's graph on NHWC `x`, each conv+BN as `conv(name, t)`."""
        relu = F.relu
        feats = []
        if self.kind == "VGG16":
            for bi, n_convs in enumerate(self.layout):
                for ci in range(n_convs):
                    x = relu(conv(f"block_{bi + 1}.{3 * ci}", x))
                x = _max_pool(x, 2, 2)
                feats.append(x)
            return feats
        x = _max_pool(relu(conv("conv1", x)), 3, 2, 1)
        feats.append(x)
        for si, blocks in enumerate(self.layout):
            for bi in range(blocks):
                p = f"layer{si + 1}.{bi}."
                out = relu(conv(p + "conv1", x))
                out = relu(conv(p + "conv2", out))
                out = conv(p + "conv3", out)
                identity = conv(p + "downsample.0", x) if p + "downsample.0" in self.names else x
                x = relu(out + identity)
            feats.append(x)
        return feats

    def forward(self, x: torch.Tensor, tap: Optional[Tap] = None) -> List[torch.Tensor]:
        """int8 forward; `tap(name, x8, acc)` sees each layer's int8 input and
        int32 accumulators."""
        feats = self._walk(x.permute(0, 2, 3, 1),
                           lambda name, t: self.layer(name)(t, name, tap))
        return [f.permute(0, 3, 1, 2) for f in feats]

    def _fparams(self) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        dev = self.layer(self.names[0]).bias.device
        return {n: (self.layer(n).w_float.to(dev), self.layer(n).bias) for n in self.names}

    def float_forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The BN-folded float mirror (NCHW in and out)."""
        fp = self._fparams()

        def conv(name, t):
            lyr = self.layer(name)
            return _conv_float(t, *fp[name], lyr.stride, lyr.padding)

        return [f.permute(0, 3, 1, 2) for f in self._walk(x.permute(0, 2, 3, 1), conv)]

    # --------------------------------------------------------- calibration
    @torch.no_grad()
    def calibrate(self, batches: Iterable) -> None:
        """Each layer's activation scale: the absmax of its float input over
        `batches` ((B, C_in, H, W) arrays or tensors), over 127."""
        fp = self._fparams()
        dev = fp[self.names[0]][1].device
        amax: Dict[str, float] = {}
        for batch in batches:
            seen: Dict[str, torch.Tensor] = {}

            def conv(name, t):
                seen[name] = t.abs().max()
                lyr = self.layer(name)
                return _conv_float(t, *fp[name], lyr.stride, lyr.padding)

            x = torch.as_tensor(batch, dtype=torch.float32).to(dev)
            self._walk(x.permute(0, 2, 3, 1), conv)
            for name, v in seen.items():
                amax[name] = max(amax.get(name, 0.0), float(v))
        for name in self.names:
            self.layer(name).in_scale.fill_(max(amax[name], 1e-12) / 127.0)


def quantize_fpn_backbone(fpn_module: FPN, calib_batches: Iterable,
                          device=None) -> QuantizedBackbone:
    """Fold and quantise a trained port FPN's backbone, on `device` (default:
    the FPN's), and calibrate its activation scales on `calib_batches`
    ((B, C_in, H, W) arrays or tensors)."""
    qb = QuantizedBackbone(fpn_module.back_bone)
    if device is not None:
        qb.to(device)
    qb.calibrate(calib_batches)
    return qb


class QuantizedInfer(nn.Module):
    """int8 backbone -> float FPN head -> σ > threshold: (B, H, W, C_in)
    float frames to (B, H, W, classes) int8 masks, the JAX package's
    inference contract. `bf16_features` casts the dequantised features to
    bf16 before the head (the serving configuration)."""

    def __init__(self, fpn: FPN, qb: QuantizedBackbone, threshold: float, bf16_features: bool):
        super().__init__()
        self.qb = qb
        self.head = FPNHead(fpn)
        self.threshold = threshold
        self.bf16_features = bf16_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.qb(x.permute(0, 3, 1, 2))
        if self.bf16_features:
            feats = [f.to(torch.bfloat16) for f in feats]
        logits, _ = self.head(feats)
        return masks_nhwc(logits, self.threshold)


def make_quantized_infer(fpn: FPN, qb: QuantizedBackbone, threshold: float = 0.5,
                         bf16_features: bool = False) -> QuantizedInfer:
    """The end-to-end int8 inference module over `fpn`'s head (its modules
    are shared, not copied)."""
    return QuantizedInfer(fpn, qb, threshold, bf16_features)
