"""The tiny widths a CPU run of a cell takes: the same code paths as the
cell's, at a size a test run holds."""

from __future__ import annotations

import time

import torch

# the widths the CPU runs of a cell shrink to; the same code paths
TINY = {
    "cardiac.full-f32": {
        "data": {"img_crop": [64, 64], "batch_size": 4},
        "model": {"fpn_channels": 32, "semantic_channels": 16,
                  "vgg_spec": [[8, 1], [16, 1], [16, 1], [32, 1], [32, 1]]},
        "gmodule": {"in_channels": 32, "nodes_per_class": 16},
        "dis": {"in_channels": 32},
        "tgcn": {"input_dim": 32, "hidden_dim": 32, "clip_shape": [4, 4, 4]},
        "cycle": {"clip_length": 24}},
    "camus.paper-f32": {
        "data": {"img_crop": [64, 64], "batch_size": 2, "target_batch_mult": 2},
        "model": {"fpn_channels": 32, "semantic_channels": 16},
        "gmodule": {"in_channels": 32, "nodes_per_class": 16},
        "dis": {"in_channels": 32}},
    "camus.temporal-f32": {
        "data": {"img_crop": [64, 64], "batch_size": 2, "target_batch_mult": 2},
        "model": {"fpn_channels": 32, "semantic_channels": 16},
        "gmodule": {"in_channels": 32, "nodes_per_class": 16},
        "dis": {"in_channels": 32},
        "tgcn": {"input_dim": 32, "hidden_dim": 32, "clip_shape": [4, 4, 4]}},
}
SEED = 2 ** 31 + 11


def tiny_cell(workload: str, seed: int = SEED, trace: bool = False, control: bool = False,
              seconds: float = 0.3, bench=None):
    """A cell of `workload` at the tiny widths, on the CPU."""
    from benchmark import run

    bench = bench or run.load_benchmark()
    cell = run.make_cell(bench, workload, seed, seconds, trace, torch.device("cpu"),
                         time.perf_counter(), extra=TINY[workload], control=control)
    return bench, cell
