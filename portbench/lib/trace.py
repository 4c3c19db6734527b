"""Reading a ``torch.profiler`` session of the window: device busy time, operations and idle gaps.

The traced window runs from the start of the first traced request's span
(``portbench.request``, recorded by ``lib/window.py``) to the end of the
last one. Device intervals are the CUDA events of the session (kernels,
copies, sets; not the spans' user annotations); busy time is their union inside the window, so overlapping
streams count once. An idle gap is a stretch of the window with no device
interval, named after the innermost host event that spans its middle: what
the host was doing while the card waited.
"""

from __future__ import annotations

from collections import defaultdict

REQUEST_SPAN = "portbench.request"


def _intervals(events, device: bool):
    """(start, end, name) of the host events, or of the device's operations:
    a ``record_function`` span's copy on the device timeline (a user
    annotation) is not an operation and is left out."""
    from torch.autograd import DeviceType

    want = DeviceType.CUDA if device else DeviceType.CPU
    return [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == want and e.time_range.end > e.time_range.start
            and not (device and (getattr(e, "is_user_annotation", False)
                                 or e.name == REQUEST_SPAN))]


def read(prof, top: int = 10) -> dict | None:
    """The session's record: window_s, busy_s, device_ops (count) and the
    breakdown (top device operations by summed time, longest idle gaps by
    host activity), times in seconds.
    None when the session recorded no request span or no device event."""
    events = prof.events()
    host = _intervals(events, device=False)
    spans = sorted((s, e) for s, e, name in host if name == REQUEST_SPAN)
    dev = sorted(_intervals(events, device=True))
    if not spans or not dev:
        return None
    t0, t1 = spans[0][0], max(e for _, e in spans)
    dev = [(max(s, t0), min(e, t1), n) for s, e, n in dev if e > t0 and s < t1]
    merged = []
    for s, e, _ in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    by_name = defaultdict(float)
    for s, e, name in dev:
        by_name[name] += e - s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = [(merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
            for i in range(len(merged) - 1)]
    gaps.append((merged[0][0] - t0, t0, merged[0][0]))
    gaps.append((t1 - merged[-1][1], merged[-1][1], t1))
    gaps = sorted((g for g in gaps if g[0] > 0), reverse=True)[:top]
    named = []
    for length, s, e in gaps:
        mid = 0.5 * (s + e)
        inner = min(((he - hs, name) for hs, he, name in host if hs <= mid <= he),
                    default=(0.0, "no host event"))
        named.append([inner[1], length / 1e6])
    return {
        "window_s": (t1 - t0) / 1e6,
        "busy_s": busy / 1e6,
        "device_ops": len(dev),
        "breakdown": {"device_ops": [[name[:160], t / 1e6] for name, t in ops],
                      "idle_gaps": named},
    }
