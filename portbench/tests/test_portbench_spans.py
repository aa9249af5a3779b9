"""The device's idle time the host left, split at the program's replay
spans (``spans.py``, ``metrics/launch_idle_ms.py``,
``metrics/epoch_idle_ms.py``), on a slice made by hand."""
from __future__ import annotations

import pytest

from portbench import spans
from portbench.bench import Context
from portbench.registry import Registry
from portbench.spans import idle_split, replay_name, waiting_gaps
from portbench.trace import SLICE, Trace

REPLAY = replay_name()
# the device idles 0-10, 30-50, 60-62, 64-80 and 90-100 (62 ns); two epochs'
# replays run 5-40 and 45-70, so the gap 30-50 straddles the first one's
# end; the host hands over work inside every gap but 60-62, which lies
# between two activities of one launch
DEVICE = [("gemm_kernel", 10, 30), ("copy", 50, 60), ("graph_node_a", 62, 64),
          ("stream_scatter_kernel", 80, 90)]
HOST = [(SLICE, 0, 100), ("kgcn.data.epoch_inputs", 0, 4), (REPLAY, 5, 40),
        ("cudaGraphLaunch", 8, 9), ("cudaMemcpyAsync", 44, 46),
        ("kgcn.train.read_back", 41, 44), (REPLAY, 45, 70), ("cudaGraphLaunch", 55, 57),
        ("cudaGraphLaunch", 57, 78), ("kgcn.train.unload", 71, 75),
        ("cudaStreamSynchronize", 85, 92), ("cudaMemsetAsync", 95, 96)]


def _read(metric, trace):
    return Registry().metric(metric).read(Context(trace=trace))


def test_only_gaps_in_which_the_host_hands_over_work_are_read():
    # 30-50 holds the copy's launch, 64-80 the end of a blocked launch,
    # 60-62 nothing; 90-100 a fill
    assert waiting_gaps(Trace(DEVICE, HOST, 0, 100)) == [(0, 10), (30, 50), (64, 80),
                                                         (90, 100)]


def test_idle_is_split_by_overlap_with_the_replays():
    # inside: 5-10, 30-40, 45-50, 64-70; outside: 0-5, 40-45, 70-80, 90-100
    assert idle_split(Trace(DEVICE, HOST, 0, 100)) == (26, 30, 2)


@pytest.mark.parametrize("family", ["rxn", "kg"])
def test_the_two_metrics_and_the_queued_gaps_make_up_the_idle_share(family):
    tr = Trace(DEVICE, HOST, 0, 100)
    launch = _read(f"launch_idle_ms.{family}", tr)
    epoch = _read(f"epoch_idle_ms.{family}", tr)
    assert launch == pytest.approx(26e-6 / 2) and epoch == pytest.approx(30e-6 / 2)
    idle_ms = _read(f"idle_share.{family}", tr) / 100 * tr.span_s * 1e3
    queued_ms = 2e-6  # 60-62
    assert launch + epoch == pytest.approx((idle_ms - queued_ms) / 2)


def test_the_replay_range_is_the_programs():
    assert REPLAY == "kgcn.train.replay"


@pytest.mark.parametrize("metric", ["launch_idle_ms.rxn", "epoch_idle_ms.kg"])
def test_nothing_to_read_without_replay_spans(metric):
    host = [ev for ev in HOST if ev[0] != REPLAY]
    assert _read(metric, Trace(DEVICE, host, 0, 100)) is None
    assert _read(metric, None) is None


def test_nothing_to_read_from_a_program_without_spans(monkeypatch):
    monkeypatch.setattr(spans, "replay_name", lambda: None)
    assert idle_split(Trace(DEVICE, HOST, 0, 100)) is None
