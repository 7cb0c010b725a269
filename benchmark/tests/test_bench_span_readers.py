"""The readers of the program's graph-head and batch-copy spans on synthetic
trace summaries: what each reads, and None where the trace holds nothing to
read (a program without the spans)."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def _reader(name: str):
    spec = importlib.util.spec_from_file_location(f"reader_{name}", METRICS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


IDLE = {"step.gmodule": 30_000.0, "step.gmodule_temporal": 20_000.0,
        "step.gm.fiedler": 9_000.0, "step.gm.kmeans": 1_000.0, "step.gm.seed_update": 500.0,
        "step.backward": 64_000.0, "step.sampling": 4_000.0, "step.tg.head": 700.0,
        "step.h2d": 300.0, "outside spans": 100.0}


def test_gmodule_idle_ms_sums_the_gmodule_and_its_parts_per_step():
    read = _reader("train.gmodule_idle_ms")
    assert read({"idle_us_by_span": IDLE, "units": 3}) == pytest.approx(60.5 / 3)
    # a program without the `step.gm.*` spans still reads its GModule phases
    assert read({"idle_us_by_span": {"step.gmodule": 6_000.0, "step.backward": 1.0},
                 "units": 2}) == pytest.approx(3.0)


def test_h2d_ms_reads_the_copies_host_time_per_step():
    read = _reader("train.h2d_ms")
    spans = {"step.h2d": 27_000.0, "step.fpn_source": 5_000.0, "step.sampling": 9.0}
    assert read({"span_host_us": spans, "units": 3}) == pytest.approx(9.0)


@pytest.mark.parametrize("name,key", [("train.gmodule_idle_ms", "idle_us_by_span"),
                                      ("train.h2d_ms", "span_host_us")])
def test_a_trace_without_the_spans_reads_none(name, key):
    read = _reader(name)
    assert read({}) is None
    assert read({key: {"step.backward": 5.0, "bench.train_epoch": 9.0}, "units": 3}) is None
    assert read({key: IDLE, "units": 0}) is None
