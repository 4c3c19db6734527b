"""Reading a profiler session: busy time as a union, user annotations left out, gaps named."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench.lib import trace


def event(name, start, end, device, annotation=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=DeviceType.CUDA if device else DeviceType.CPU,
                           is_user_annotation=annotation)


def test_busy_union_gaps_and_annotations():
    events = [
        event(trace.REQUEST_SPAN, 0, 100, device=False),
        event(trace.REQUEST_SPAN, 100, 200, device=False),
        event("cudaStreamSynchronize", 60, 90, device=False),
        # the span's copy on the device timeline is no operation
        event(trace.REQUEST_SPAN, 0, 200, device=True, annotation=True),
        event("k1", 10, 40, device=True),
        event("k2", 30, 50, device=True),   # overlaps k1: counted once
        event("k1", 120, 180, device=True),
        event("k3", 250, 300, device=True),  # after the window: left out
    ]
    rec = trace.read(SimpleNamespace(events=lambda: events))
    assert rec["window_s"] == pytest.approx(200e-6)
    assert rec["busy_s"] == pytest.approx((40 + 60) * 1e-6)
    assert rec["device_ops"] == 3
    ops = dict(rec["breakdown"]["device_ops"])
    assert ops == pytest.approx({"k1": 90e-6, "k2": 20e-6})
    gaps = rec["breakdown"]["idle_gaps"]
    # 50-120 (the sync spans its middle), 0-10 and 180-200
    assert gaps[0][0] == "cudaStreamSynchronize" and gaps[0][1] == pytest.approx(70e-6)
    assert sorted(g[1] for g in gaps) == pytest.approx([10e-6, 20e-6, 70e-6])


def test_no_device_event_reads_nothing():
    events = [event(trace.REQUEST_SPAN, 0, 100, device=False)]
    assert trace.read(SimpleNamespace(events=lambda: events)) is None
