"""The readers of the Pyramid ViG cell, `vig.knn_roofline` and
`train.vig_idle_ms`, on hand-built trace summaries: what each reads, and
None where the trace holds nothing to read (a program without the
Graphers' kNN calls or the `step.vig.*` spans, or traced calls that are not
the launches the wrapper counted). And the cell's configuration: its calls
a step at the published shapes."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest

from benchmark import experiment, work

METRICS = Path(__file__).resolve().parents[1] / "metrics"
GRAPHER = (8, 4096, 256, 80, 9, False, 4096 * 256)
TGCN = (8, 64, 64, 256, 9)


def _reader(name: str):
    spec = importlib.util.spec_from_file_location(f"reader_{name}", METRICS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _summary(launches: int) -> dict:
    return {"kernel_call_shapes": {"knn": [GRAPHER, GRAPHER, TGCN]},
            "kernel_launches": {"knn": launches, "pairwise_mlp_fwd": 4},
            "kernel_us": {"knn_kernel": 400.0, "knn_select": 100.0, "pairwise_fwd": 9e3},
            "units": 2}


def test_knn_roofline_prices_each_traced_call_at_its_own_shape():
    read = _reader("vig.knn_roofline")
    least = 2 * (2 * work.bound_s(*work.knn_work(*GRAPHER)) + work.bound_s(*work.knn_work(*TGCN)))
    assert read(_summary(6)) == pytest.approx(100.0 * least / 500e-6)
    # the older reader prices every launch at the TGCN's shape
    old = _reader("knn_roofline")
    assert old(dict(_summary(6), kernel_shapes={"knn": TGCN})) < read(_summary(6))


@pytest.mark.parametrize("change", [
    {"kernel_launches": {"knn": 5}},  # a launch the configuration does not list
    {"kernel_launches": {}},  # the wrapper counted none
    {"kernel_call_shapes": {}},  # the configuration lists no kNN call
    {"kernel_us": {"pairwise_fwd": 9e3}},  # no kNN kernel ran on the card
    {"units": 0},
])
def test_knn_roofline_reads_none_where_the_calls_are_not_the_launches(change):
    assert _reader("vig.knn_roofline")(dict(_summary(6), **change)) is None
    assert _reader("vig.knn_roofline")({}) is None


IDLE = {"step.vig.grapher": 3_000.0, "step.vig.knn": 1_500.0, "step.vig.mrconv": 500.0,
        "step.vig.ffn": 700.0, "step.vig.stem": 200.0, "step.vig.down": 100.0,
        "step.fpn_source": 9_000.0, "step.backward": 64_000.0, "step.tg.recurrence": 800.0,
        "outside spans": 100.0}


def test_vig_idle_ms_sums_the_vig_spans_per_step():
    read = _reader("train.vig_idle_ms")
    spans = {n: 1.0 for n in IDLE}
    assert read({"idle_us_by_span": IDLE, "span_host_us": spans, "units": 3}) == pytest.approx(
        6.0 / 3)
    # the spans opened and the card never waited on them
    assert read({"idle_us_by_span": {"step.backward": 5.0}, "span_host_us": spans,
                 "units": 3}) == 0.0


def test_vig_idle_ms_reads_none_without_the_spans():
    read = _reader("train.vig_idle_ms")
    assert read({}) is None
    older = {"step.fpn_source": 1.0, "step.backward": 2.0}
    assert read({"idle_us_by_span": older, "span_host_us": older, "units": 3}) is None
    assert read({"idle_us_by_span": IDLE, "span_host_us": IDLE, "units": 0}) is None


def test_the_cells_kernel_calls_at_the_published_shapes():
    """56 kNN graphs a step: the 12 Graphers of each backbone call over 8,
    8, 64 and 64 frames, the TGCN's 8 between the clips and the cycle clip;
    the head's calls are the cardiac configuration's."""
    ref_mod = experiment.reference("cardiac_pvig_s")
    cfg = experiment.build(ref_mod.config, experiment.load_json("configs", "cardiac_pvig_s"),
                           experiment.load_json("traffic", "full-f32"))
    calls = ref_mod.kernel_call_shapes(cfg)
    knn = calls.pop("knn")
    cardiac = experiment.reference("cardiac")
    assert calls == {k: v for k, v in cardiac.kernel_call_shapes(cfg).items() if k != "knn"}
    assert len(knn) == 56 and knn[36:44] == [TGCN] * 8
    per_call = [(4096, 256, 80, 9, False), (4096, 256, 80, 9, False),
                (1024, 256, 160, 9, False), (1024, 256, 160, 9, False)] + [
                (256, 256, 400, 18, True)] * 4 + [(256, 256, 400, 27, True)] * 2 + [
                (64, 64, 640, 27, True)] * 2
    for frames, at in ((8, 0), (8, 12), (64, 24), (64, 44)):
        assert [c[1:6] for c in knn[at:at + 12]] == per_call
        assert all(c[0] == frames and c[6] == c[1] * c[2] for c in knn[at:at + 12])
    # the least time of a step's graphs, 1.83 ms
    least = sum(work.bound_s(*work.knn_work(*c)) for c in knn)
    assert least == pytest.approx(1.828e-3, rel=1e-3)
