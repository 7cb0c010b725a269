"""The yardstick's arithmetic: the data sheet's peaks, the least time a
kernel could take, the operations and bytes of the two hand-written
kernels, and the model FLOPs of a train step, counted on the reference
model of the configuration (`reference/<name>.py`).

Peaks are NVIDIA's for the H100 SXM, dense, at the full 700 W: 67 TFLOP/s
in float32 outside the tensor cores (TF32 off), 989 TFLOP/s in bf16,
1,979 TOP/s in int8, and 3.35 TB/s of HBM. A card below 700 W reaches
less; the result line gives the card's power limit beside the shares."""

from __future__ import annotations

from types import ModuleType
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
PEAK_BYTES = 3.35e12


def bound_s(ops: float, nbytes: float, dtype: str = "float32") -> float:
    """The least seconds the card could take: the larger of the operations
    over the peak of `dtype` and the bytes over the memory rate."""
    return max(ops / PEAK_OPS[dtype], nbytes / PEAK_BYTES)


def pairwise_fwd_work(n1: int, n2: int, k: int) -> Tuple[int, int]:
    """(operations, bytes) of M = sum_k w2[k] relu(a[i,k] + b[j,k]) + b2: per
    (i, j, k) the add, the relu, the multiply and the accumulate, per (i, j)
    the add of b2; a, b, w2 and b2 read once, M written once."""
    return 4 * n1 * n2 * k + n1 * n2, 4 * (n1 * k + n2 * k + k + 1) + 4 * n1 * n2


def pairwise_bwd_work(n1: int, n2: int, k: int) -> Tuple[int, int]:
    """(operations, bytes) of the pairwise-MLP backward: per (i, j, k) the
    add, the comparison and one accumulation each into S_A and S_B; per row
    of a or b and column k the multiply-add of dw2 and the scaling by w2;
    per (i, j) the add of db2. a, b, w2 and g read once, dA, dB, dw2 and db2
    written once."""
    ops = 4 * n1 * n2 * k + 3 * (n1 + n2) * k + n1 * n2
    return ops, 4 * (2 * (n1 * k + n2 * k + k) + n1 * n2 + 1)


def knn_work(b: int, n: int, m: int, c: int, k: int, self_graph: bool = False,
             rel_numel: int = 0) -> Tuple[int, int]:
    """(operations, bytes) of the kNN graph: 2 per multiply-add of the
    distance products; per (query, key) the subtraction, the addition, the
    bias and one comparison against the k-th best; 5 per input element to
    normalise it and sum its square; each input read once (x alone for a
    self graph) and the indices written once."""
    pair = 4 if rel_numel else 3
    rows = b * n if self_graph else b * (n + m)
    ops = 2 * b * n * m * c + pair * b * n * m + 5 * rows * c
    return ops, 4 * (rows * c + rel_numel + b * n * k)


def kernel_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """The shapes a train step of the reference experiment `cfg` gives the
    hand-written kernels: the GModule's affinity (every class's node slots
    on both sides, the MLP's 2d hidden width) and, with the temporal
    branch, the TGCN's kNN (2 x clips, the node grid against the hidden
    state, the hidden width, k)."""
    g = cfg.gmodule
    n = g.num_classes * g.nodes_per_class
    shapes = {"pairwise_mlp": (n, n, 2 * g.in_channels)}
    if cfg.train.temporal_graph:
        t, gh, gw = cfg.tgcn.clip_shape
        clips = 2 * max(cfg.data.batch_size // 2, 1)
        shapes["knn"] = (clips, gh * gw, gh * gw, cfg.tgcn.hidden_dim, cfg.tgcn.knn_k)
    return shapes


def traced_calls(s: Mapping[str, Any], counter: str) -> Optional[List[Tuple[int, ...]]]:
    """The shapes of the calls that the traced steps of summary `s` made
    through the wrapper whose launch counter is `counter`: the
    configuration's calls a step (its reference module's
    `kernel_call_shapes`) once for each traced step. None where the configuration lists none, or where their number is
    not the launches the wrapper counted."""
    per_step = s.get("kernel_call_shapes", {}).get(counter)
    launches = s.get("kernel_launches", {}).get(counter, 0)
    if not per_step or not launches:
        return None
    calls = [tuple(c) for c in per_step] * int(s.get("units", 0))
    return calls if len(calls) == launches else None


def _flops(fn, *args) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as count:
        fn(*args)
    return count.get_total_flops()


def frame_flops(cfg, ref_mod: ModuleType) -> Dict[str, int]:
    """FLOPs (two per multiply-add) of one frame through the FPN that the
    configuration's reference module `ref_mod` trains
    (`TrainReference.build_fpn`), its
    backbone alone, and one frame's four pyramid levels through the
    discriminators, counted on the meta device."""
    from benchmark.reference.uda.discriminator import Discriminator
    from benchmark.reference.uda.step import DIS_LEVELS

    with torch.device("meta"):
        fpn = ref_mod.TrainReference.build_fpn(cfg).eval()
        d = cfg.dis
        dis = Discriminator(d.num_convs, d.in_channels, d.grad_reverse_lambda,
                            d.grl_applied_domain)
    x = torch.empty((1, cfg.model.in_channels, *cfg.data.img_crop), device="meta")
    out = {"fpn": _flops(fpn, x), "backbone": _flops(fpn.back_bone, x)}
    with torch.no_grad():
        _, feats = fpn(x)
    # the discriminator takes a source and a target map: half of one call is a frame's
    out["discriminators"] = sum(_flops(dis, f, f) for f in feats[:len(DIS_LEVELS)]) // 2
    return out


def train_step_flops(cfg, ref_mod: ModuleType) -> int:
    """Model FLOPs of one train step of the reference experiment `cfg`, on
    the FPN of `ref_mod` (as `frame_flops`): the forward over every frame the
    step feeds (the FPN over source, target and clip frames, the
    discriminators over source and target, the backbone over the cycle
    clip) times 3 for the backward, with no recompute counted. The graph
    head's node-level work (well under 1% of it) is left out."""
    t, d = cfg.train, cfg.data
    f = frame_flops(cfg, ref_mod)
    src = d.batch_size
    tgt = d.batch_size * d.target_batch_mult if t.graph_matching else 0
    clips = 2 * max(d.batch_size // 2, 1) * cfg.tgcn.clip_shape[0] if t.temporal_graph else 0
    cyc = cfg.cycle.clip_length if t.cyc_loss else 0
    fwd = (src + tgt + clips) * f["fpn"] + cyc * f["backbone"]
    if t.discriminator:
        fwd += (src + tgt) * f["discriminators"]
    return 3 * fwd
