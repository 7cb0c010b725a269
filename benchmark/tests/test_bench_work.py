"""The yardstick's counts against hand arithmetic."""

from __future__ import annotations

import torch

from benchmark import experiment, work


def test_one_convolution_is_counted_as_two_flops_per_multiply_add():
    with torch.device("meta"):
        conv = torch.nn.Conv2d(3, 8, 3, padding=1)
    x = torch.empty(1, 3, 16, 16, device="meta")
    assert work._flops(conv, x) == 2 * 8 * 3 * 3 * 3 * 16 * 16


def test_pairwise_call_by_hand():
    n1, n2, k = 3, 4, 5
    # forward: add, relu, multiply, accumulate per (i, j, k); + b2 per (i, j)
    assert work.pairwise_fwd_work(n1, n2, k) == (4 * 60 + 12, 4 * (15 + 20 + 5 + 1) + 4 * 12)
    # backward: 4 per (i, j, k), 3 per row and column k, 1 per (i, j)
    assert work.pairwise_bwd_work(n1, n2, k) == (240 + 3 * 7 * 5 + 12,
                                                 4 * (2 * (15 + 20 + 5) + 12 + 1))


def test_knn_call_by_hand():
    # 2 x 3 queries against 2 x 4 keys of 5 channels, k 2, no bias
    ops, nbytes = work.knn_work(2, 3, 4, 5, 2)
    assert ops == 2 * 2 * 3 * 4 * 5 + 3 * 2 * 3 * 4 + 5 * 2 * (3 + 4) * 5
    assert nbytes == 4 * (2 * (3 + 4) * 5 + 2 * 3 * 2)


def test_bound_is_the_larger_of_operations_and_bytes():
    assert work.bound_s(67e12, 0) == 1.0
    assert work.bound_s(0, 3.35e12) == 1.0
    assert work.bound_s(989e12, 0, "bfloat16") == 1.0


def test_the_cells_kernel_shapes_and_step_flops():
    ref = experiment.reference("cardiac")
    conf = experiment.load_json("configs", "cardiac")
    cfg = experiment.build(ref.config, conf, experiment.load_json("traffic", "full-f32"))
    assert work.kernel_shapes(cfg) == {"pairwise_mlp": (560, 560, 512),
                                       "knn": (8, 64, 64, 256, 9)}
    f = work.frame_flops(cfg, ref)
    # 8 source + 8 target + 64 clip frames through the FPN, 64 through the
    # backbone, 16 through the discriminators, times 3
    assert work.train_step_flops(cfg, ref) == 3 * (80 * f["fpn"] + 64 * f["backbone"]
                                              + 16 * f["discriminators"])
