"""Plain reference of the `cardiac_pvig_s` configuration: the CardiacUDA
recipe (the temporal graph and the cycle loss) with a Pyramid ViG-S FPN
backbone (`pvig.py`) in float32.

Its Graphers take the program's graph of each call wherever it is a kNN
graph of their own distances up to near ties, and their own elsewhere
(`benchmark/vig_graphs.py`): building the experiment through `config` arms
the record of the program's graphs for the checked steps that follow, and
each `TrainReference` follows the last record from its first call on."""

from __future__ import annotations

from typing import Dict, List, Tuple

from benchmark.loops.train import CHECKED_STEPS
from benchmark.reference import pvig
from benchmark.reference.uda import config as uda_config
from benchmark.reference.uda import step
from benchmark.reference.uda.fpn import FPN
from benchmark.vig_graphs import GRAPHS


def backbone_calls(cfg) -> int:
    """The backbone's calls a train step: the source frames, the target
    frames, the clip frames, the cycle clip."""
    t = cfg.train
    return 1 + int(t.graph_matching) + int(t.temporal_graph) + int(t.cyc_loss)


class config:
    """The factory `configs/cardiac_pvig_s.json` names, `uda/config.py`'s;
    each experiment it builds arms the record of the program's next
    checked steps' Grapher graphs."""

    @staticmethod
    def cardiac_uda_config(**kwargs):
        cfg = uda_config.cardiac_uda_config(**kwargs)
        GRAPHS.arm(CHECKED_STEPS * backbone_calls(cfg) * sum(pvig.PVIG_S["blocks"]))
        return cfg


def build_fpn(cfg) -> FPN:
    m = cfg.model
    return FPN(num_classes=m.num_classes,
               back_bone=pvig.pvig_s(cfg.data.img_crop[0], m.in_channels, GRAPHS.choose),
               fpn_channels=m.fpn_channels, semantic_channels=m.semantic_channels,
               in_channels=m.in_channels)


class TrainReference(step.TrainReference):
    build_fpn = staticmethod(build_fpn)

    def __init__(self, cfg, device):
        GRAPHS.follow()
        super().__init__(cfg, device)


def grapher_knn_calls(frames: int, img_size: int) -> List[Tuple[int, ...]]:
    """The kNN graphs of one backbone call over `frames` frames, one a
    Grapher in order, each as `work.knn_work`'s arguments: (frames, nodes,
    keys, width, k·d, self graph, bias elements)."""
    s = pvig.PVIG_S
    calls, idx, side = [], 0, img_size // 4
    for i, (n_blk, ch) in enumerate(zip(s["blocks"], s["channels"])):
        if i > 0:
            side //= 2
        n = side * side
        r = pvig.REDUCE[i]
        m = n // (r * r)
        for _ in range(n_blk):
            kd = s["k"] * min(idx // 4 + 1, 49 // s["k"])
            calls.append((frames, n, m, ch, kd, r == 1, n * m))
            idx += 1
    return calls


def kernel_call_shapes(cfg) -> Dict[str, List[Tuple[int, ...]]]:
    """The uda step's calls (`uda/step.py`) with each backbone call's
    Grapher kNN graphs put in, in the order the step makes them: the FPN on
    the source frames, on the target frames, on the clip frames, then the
    TGCN's graphs, then the backbone on the cycle clip."""
    calls = step.kernel_call_shapes(cfg)
    t, d = cfg.train, cfg.data
    size = d.img_crop[0]
    knn = grapher_knn_calls(d.batch_size, size)
    if t.graph_matching:
        knn += grapher_knn_calls(d.batch_size * d.target_batch_mult, size)
    if t.temporal_graph:
        clips = 2 * max(d.batch_size // 2, 1) * cfg.tgcn.clip_shape[0]
        knn += grapher_knn_calls(clips, size) + calls.get("knn", [])
    if t.cyc_loss:
        knn += grapher_knn_calls(cfg.cycle.clip_length, size)
    calls["knn"] = knn
    return calls
