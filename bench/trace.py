"""The device trace of a few ticks: ``torch.profiler`` over a stretch of
ticks, reduced to what the per-layer metrics read.

* ``window_s``: the traced ticks' length on the profiler's clock, from the
  first ``bench.tick`` range's start to the last one's end;
* ``busy_s``: the time inside that stretch in which some device operation
  ran (operations that overlap count once);
* ``device_ops``: device seconds by operation name, largest first;
* ``in_span``: device seconds of the operations launched inside each
  ``bench.<span>`` range: those that run within the range's device-side
  extent, which the profiler records beside the host range;
* ``idle_gaps``: the device's idle seconds inside the stretch, summed by
  what the host was doing, the innermost ``bench.<span>`` range open at
  the gap's middle, largest first.
"""
from __future__ import annotations

import torch


def _annotation(evt) -> bool:
    name = getattr(evt, "name", None) or evt.key
    return (getattr(evt, "is_user_annotation", False)
            or name.startswith("bench."))


def _merge(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def profile(fn, device: str = "cuda") -> dict:
    """Run ``fn`` under the profiler and reduce its trace (on the CPU, the
    host's ranges alone)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    cuda = device != "cpu"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    sync()
    with torch_profile(activities=activities) as prof:
        fn()
        sync()

    events = prof.events()
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in events
                 if e.device_type != DeviceType.CPU and not _annotation(e))
    host = [(e.time_range.start, e.time_range.end, e.name)
            for e in events
            if e.device_type == DeviceType.CPU and e.name.startswith("bench.")]
    ticks = [(a, b) for a, b, n in host if n == "bench.tick"]
    lo = min((a for a, _ in ticks), default=0.0)
    hi = max((b for _, b in ticks), default=0.0)

    busy, gaps, end = 0.0, [], lo
    for a, b, _ in dev:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if a > end:
            gaps.append((end, a))
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))

    idle: dict[str, float] = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        open_ = [(h1 - h0, n) for h0, h1, n in host if h0 <= mid <= h1]
        label = min(open_)[1] if open_ else "host outside the spans"
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6

    extents: dict[str, list] = {}
    for e in events:
        if e.device_type != DeviceType.CPU and e.name.startswith("bench."):
            extents.setdefault(e.name[6:], []).append(
                (e.time_range.start, e.time_range.end))
    in_span = {}
    for name, iv in extents.items():
        merged = _merge(iv)
        in_span[name] = sum(max(0.0, min(b, y) - max(a, x))
                            for a, b, _ in dev for x, y in merged) / 1e6

    by_name: dict[str, float] = {}
    for evt in prof.key_averages():
        if (evt.device_type != DeviceType.CPU
                and evt.self_device_time_total > 0 and not _annotation(evt)):
            by_name[evt.key] = (by_name.get(evt.key, 0.0)
                                + evt.self_device_time_total / 1e6)
    return {"window_s": (hi - lo) / 1e6,
            "busy_s": busy / 1e6, "device_events": len(dev),
            "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1]),
            "in_span": in_span,
            "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1])}
