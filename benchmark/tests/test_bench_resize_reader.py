"""The reader of the FPN's resize device time on synthetic trace summaries:
PyTorch's kernel, the program's own, and None where the trace holds
neither."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def _read(summary):
    spec = importlib.util.spec_from_file_location(
        "reader_resize", METRICS / "train.resize_device_ms.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(summary)


OTHERS = {"knn_kernel": 900.0, "sm90_xmma_fprop": 50_000.0}


@pytest.mark.parametrize("kernel", ["upsample_bilinear2d_out_frame",
                                    "upsample_bilinear2d_nhwc_out_frame",
                                    "resize_bilinear_kernel"])
def test_it_reads_the_resize_kernels_device_ms_per_step(kernel):
    summary = {"kernel_us": {**OTHERS, kernel: 120_000.0}, "units": 3}
    assert _read(summary) == pytest.approx(40.0)


def test_it_sums_both_kernels():
    summary = {"kernel_us": {**OTHERS, "upsample_bilinear2d_out_frame": 3_000.0,
                             "resize_bilinear_kernel": 1_500.0}, "units": 3}
    assert _read(summary) == pytest.approx(1.5)


def test_a_trace_without_either_kernel_reads_none():
    assert _read({}) is None
    assert _read({"kernel_us": OTHERS, "units": 3}) is None
    assert _read({"kernel_us": {"resize_bilinear_kernel": 10.0}, "units": 0}) is None
