"""The Pyramid ViG cell's faults (`benchmark/vig_checks.py`) plant what they
name in the program's Graphers, and leave them as they were on exit; on a
tiny backbone, on the CPU."""

from __future__ import annotations

import contextlib

import pytest
import torch

from benchmark import faults, vig_checks

TINY = {"blocks": (2, 2, 6, 2), "channels": (8, 16, 24, 32), "k": 3}


def _graph_calls(monkeypatch, fault=None):
    """The (k, dilation, bias given) of each Grapher's kNN graph in one
    forward of a tiny Pyramid ViG, with `fault` planted."""
    from graphecho_torch.models import vig

    seen = []
    graph = vig.dilated_knn_graph

    def recorded(x, y=None, k=9, dilation=1, relative_pos=None, *args, **kwargs):
        seen.append((k, dilation, relative_pos is not None))
        return graph(x, y, k, dilation, relative_pos, *args, **kwargs)

    monkeypatch.setattr(vig, "dilated_knn_graph", recorded)
    model = vig.PyramidViG(**TINY, img_size=96, in_channels=1).train()
    x = torch.randn(2, 1, 96, 96, generator=torch.Generator().manual_seed(0))
    with fault() if fault else contextlib.nullcontext(), torch.no_grad():
        model(x)
    return seen


@pytest.fixture(autouse=True)
def _restored():
    from graphecho_torch.models import vig

    before = (vig.dilated_knn_graph, vig.relative_pos_buffer)
    yield
    assert (vig.dilated_knn_graph, vig.relative_pos_buffer) == before


def test_the_faults_plant_what_they_name(monkeypatch):
    dilations = [1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3]
    assert _graph_calls(monkeypatch) == [(3, d, True) for d in dilations]
    assert _graph_calls(monkeypatch, vig_checks.no_bias) == [(3, d, False) for d in dilations]
    assert _graph_calls(monkeypatch, vig_checks.dilation_1) == [(3, 1, True)] * 12


def test_the_faults_join_the_train_loops_for_the_readings(monkeypatch):
    from benchmark import run

    seen = {}

    def fake_main(argv):
        seen["faults"] = dict(faults.FAULTS["train"])
        seen["run_cell"] = run.run_cell
        return 0

    monkeypatch.setattr(vig_checks.readings, "main", fake_main)
    before = run.run_cell
    assert vig_checks.main([]) == 0
    assert {"unchanged", "half_batch", "vig_no_bias", "vig_dilation_1"} <= set(seen["faults"])
    assert seen["run_cell"] is vig_checks.run_cell
    assert set(faults.FAULTS["train"]) == {"unchanged", "half_batch"}
    assert run.run_cell is before
