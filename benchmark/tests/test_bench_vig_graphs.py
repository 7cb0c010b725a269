"""The reference's Graphers follow the program's graphs only where they are
a kNN graph of the reference's own distances up to near ties
(`benchmark/vig_graphs.py`): on hand-built distances, on a tiny Pyramid ViG
against the program's with and without the Grapher faults, and through a
tiny run of the cell on the CPU."""

from __future__ import annotations

import contextlib
import time

import pytest
import torch

from benchmark import faults, run, vig_checks, weights
from benchmark.reference import pvig as ref_vig
from benchmark.vig_graphs import GRAPHS, TIE, Graphs

TINY = {"blocks": (2, 2, 6, 2), "channels": (8, 16, 24, 32), "k": 3}
CROP = 96
EXTRA = {"data": {"img_crop": [CROP, CROP], "batch_size": 2},
         "model": {"fpn_channels": 32, "semantic_channels": 16},
         "gmodule": {"in_channels": 32, "nodes_per_class": 8},
         "dis": {"in_channels": 32},
         "tgcn": {"input_dim": 32, "hidden_dim": 32, "clip_shape": [2, 6, 6]},
         "cycle": {"clip_length": 24}}
SEED = 2 ** 31 + 23


@pytest.fixture
def tiny(monkeypatch):
    """Both sides' Pyramid ViG-S shrunk to `TINY`; the program's graph
    builder as it was afterwards."""
    from graphecho_torch.models import fpn, vig

    monkeypatch.setattr(vig, "dilated_knn_graph", vig.dilated_knn_graph)
    for owner in (vig, fpn, ref_vig):
        monkeypatch.setattr(owner, "PVIG_S", dict(TINY))
    return vig


def _graphs(recorded):
    g = Graphs()
    g.recorded = [torch.tensor(r) for r in recorded]
    g.follow()
    return g


def test_a_near_tie_is_followed_and_a_far_one_is_not():
    # one row of five keys: 0 and 1 lie within the tie, 2 and 3 do not
    dist = torch.tensor([[[0.0, TIE / 2, 0.5, 0.5 + 2 * TIE, 3.0]]])
    g = _graphs([[[[1, 0]]], [[[0, 2]]], [[[0, 3]]]])
    assert g.choose(dist, 2, 1).tolist() == [[[1, 0]]]  # swapped within the tie
    assert g.choose(dist, 2, 1).tolist() == [[[0, 1]]]  # key 2 for key 1: not followed
    assert g.choose(dist, 2, 1).tolist() == [[[0, 1]]]
    assert [(c["followed"], c["rejected"]) for c in g.calls] == [(1, 0), (0, 1), (0, 1)]
    # at dilation 2 the chosen keys sit at ranks 0 and 2: (0, 2) is its own, (0, 1) is not
    g = _graphs([[[[0, 2]]], [[[0, 1]]]])
    assert g.choose(dist, 2, 2).tolist() == [[[0, 2]]]
    assert g.choose(dist, 2, 2).tolist() == [[[0, 2]]]
    assert [c["rejected"] for c in g.calls] == [0, 1]


def test_a_graph_that_does_not_line_up_is_not_followed():
    dist = torch.tensor([[[0.0, 0.0, 1.0], [1.0, 0.0, 0.0]]])
    # a key twice, a key out of range, another shape, then no record at all
    g = _graphs([[[[1, 1], [1, 2]]], [[[0, 1], [1, 7]]], [[[1, 0]]]])
    for _ in range(4):
        assert g.choose(dist, 2, 1).tolist() == [[[0, 1], [1, 2]]]
    assert [(c["rejected"], c["missing"]) for c in g.calls] == [
        (1, False), (1, False), (2, True), (2, True)]
    assert [s["over"] for s in g.report(2)] == [[2] * 4, [4] * 4]
    # on the meta device (the FLOP count) nothing is taken from the record
    g = _graphs([[[[2, 1]]]])
    assert g.choose(torch.empty(1, 1, 3, device="meta"), 2, 1).device.type == "meta"
    assert g.cursor == 0


def _forward(vig, fault=None):
    """One train-mode forward of a tiny program Pyramid ViG and of the
    reference's on the same weights, the reference following the program's
    graphs: what it did with each call's rows."""
    model = vig.PyramidViG(**TINY, img_size=CROP, in_channels=1).train()
    ref = ref_vig.PyramidViG(**TINY, img_size=CROP, in_channels=1, graph=GRAPHS.choose).train()
    init = weights.make({"b": model}, SEED, torch.device("cpu"))["b"]
    model.load_state_dict(init)
    ref.load_state_dict(init)
    x = torch.rand(2, 1, CROP, CROP, generator=torch.Generator().manual_seed(0))
    GRAPHS.arm(sum(TINY["blocks"]))
    with fault() if fault else contextlib.nullcontext(), torch.no_grad():
        model(x)
    GRAPHS.follow()
    with torch.no_grad():
        ref(x)
    return GRAPHS.report(1)[0]


def test_the_program_is_followed_and_its_faults_are_not(tiny):
    sound = _forward(tiny)
    assert (sound["rejected"], sound["missing"], sound["gap_max"]) == (0, 0, 0.0)
    for fault in (vig_checks.no_bias, vig_checks.dilation_1):
        broken = _forward(tiny, fault)
        assert broken["rejected"] > broken["rows"] // 10, (fault, broken)


@pytest.mark.parametrize("fault", [None, "vig_no_bias"])
def test_a_tiny_run_of_the_cell(tiny, fault):
    """The cell at tiny widths on the CPU: correct as the program is, with
    every Grapher row followed; not correct with the bias left out."""
    bench = run.load_benchmark()
    cell = run.make_cell(bench, "cardiac_pvig_s.full-f32", SEED, 0.2, False,
                         torch.device("cpu"), time.perf_counter(), extra=EXTRA)
    plant = vig_checks.FAULTS[fault]() if fault else contextlib.nullcontext()
    with plant, faults._patched(run, "run_cell", vig_checks.run_cell):
        result = run.run_cell(bench, cell)
    steps = cell.notes[-1]["vig_graphs"]
    assert [s["calls"] for s in steps] == [4 * sum(TINY["blocks"])] * 3
    if fault is None:
        assert result["correct"], result["checks"]
        assert sum(s["rejected"] + s["missing"] for s in steps) == 0, steps
    else:
        assert not result["correct"], result["checks"]
        assert all(s["rejected"] > s["rows"] // 10 for s in steps), steps
