"""The reduction of a traced slice, on events made by hand."""
from __future__ import annotations

import pytest

from portbench.trace import SLICE, Trace


def _trace():
    device = [("gemm_kernel", 10, 30), ("copy", 25, 40), ("stream_scatter_kernel", 60, 70),
              ("stream_scatter_kernel", 90, 95)]
    host = [(SLICE, 0, 100), ("portbench.data.epoch_scan_inputs", 40, 62),
            ("cudaGraphLaunch", 70, 72), ("aten::cat", 75, 99)]
    return Trace(device, host, 0, 100)


def test_busy_is_the_union():
    tr = _trace()
    assert tr.busy_intervals() == [(10, 40), (60, 70), (90, 95)]
    assert tr.busy_s == pytest.approx(45e-9)
    assert tr.span_s == pytest.approx(100e-9)


def test_seconds_by_name_and_top_ops():
    tr = _trace()
    assert tr.seconds([r"stream_scatter_kernel"]) == pytest.approx(15e-9)
    assert tr.top_ops(2) == [["gemm_kernel", pytest.approx(20e-9)],
                             ["copy", pytest.approx(15e-9)]]


def test_idle_gaps_by_host_activity():
    gaps = dict(_trace().idle_gaps())
    # 0-10 and 70-90 (the middle 80 falls in aten::cat), 40-60 in the data call,
    # 95-100 in aten::cat
    assert gaps == {"host idle": pytest.approx(10e-9),
                    "portbench.data.epoch_scan_inputs": pytest.approx(20e-9),
                    "aten::cat": pytest.approx(25e-9)}
