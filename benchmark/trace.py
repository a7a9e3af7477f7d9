"""
The traced window: ``torch.profiler`` over a fixed number of steps, its
Chrome trace read back into device time, kernels (each by the range its
launch sat in), and idle gaps.
"""
import bisect
import json
from collections import defaultdict
from pathlib import Path
from typing import NamedTuple

WINDOW = "bench:window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Trace(NamedTuple):
    window_s: float  # the traced window's length
    busy_s: float  # seconds in which a device operation ran
    n_kernels: int  # kernel launches completed in the window
    range_kernels: dict  # annotation -> {kernel name -> device seconds launched inside it}
    device_ops: list  # [[name, seconds], ...] the 10 longest by total
    idle_gaps: list  # [[what the host was doing, seconds], ...] the 10 longest by total


def record(fn, path: Path) -> Trace:
    """Profile ``fn`` (which ends with the device idle) on the CPU and the
    card, and read the trace; the trace file at ``path`` is removed."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            fn()
            if cuda:
                torch.cuda.synchronize()
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    try:
        return parse(json.loads(path.read_text()))
    finally:
        path.unlink(missing_ok=True)


def _merge(intervals: list[tuple[float, float]]) -> list[list[float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class _Spans:
    """Host spans of one thread, sorted by start; nesting is shallow, so
    a lookup walks back at most ``DEPTH`` spans from the last start."""

    DEPTH = 64

    def __init__(self, spans: list[tuple[float, float, str]]):
        self.spans = sorted(spans)
        self.starts = [s[0] for s in self.spans]

    def containing(self, t: float) -> list[str]:
        """Names of the spans containing ``t``, innermost first."""
        i = bisect.bisect_right(self.starts, t) - 1
        return [self.spans[j][2] for j in range(i, max(i - self.DEPTH, -1), -1)
                if self.spans[j][0] <= t < self.spans[j][1]]

    def innermost(self, t: float) -> str | None:
        names = self.containing(t)
        return names[0] if names else None


def parse(data: dict) -> Trace:
    """Times in a Chrome trace are microseconds."""
    events = [e for e in data.get("traceEvents", []) if e.get("ph") == "X"]
    win = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError("the trace holds no window range")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    main_tid = win[0].get("tid")
    dev, launches, ann, ops = [], {}, defaultdict(list), []
    for e in events:
        cat = e.get("cat")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur, e.get("name", ""), cat, e.get("args", {}).get("correlation")))
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (ts, e.get("tid"))
        elif cat == "user_annotation" and e.get("name") != WINDOW:
            ann[e.get("tid")].append((ts, ts + dur, e["name"]))
        elif cat == "cpu_op" and e.get("tid") == main_tid:
            ops.append((ts, ts + dur, e["name"]))
    dev = [d for d in dev if d[1] > w0 and d[0] < w1]
    busy = _merge([(max(a, w0), min(b, w1)) for a, b, *_ in dev])
    busy_us = sum(b - a for a, b in busy)

    ann = {tid: _Spans(spans) for tid, spans in ann.items()}
    range_us: dict = defaultdict(lambda: defaultdict(float))
    per_name: dict = defaultdict(float)
    n_kernels = 0
    for a, b, name, cat, corr in dev:
        per_name[name] += b - a
        if cat != "kernel":
            continue
        n_kernels += 1
        launch = launches.get(corr)
        if launch is None:
            continue
        if launch[1] in ann:
            for span_name in set(ann[launch[1]].containing(launch[0])):
                range_us[span_name][name] += b - a

    ops = _Spans(ops)
    main_ann = ann.get(main_tid, _Spans([]))
    gaps: dict = defaultdict(float)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        where = [x for x in (main_ann.innermost(a), ops.innermost(a)) if x]
        gaps["/".join(where) or "host"] += b - a

    def top(d):
        return [[k, v * 1e-6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return Trace(
        window_s=(w1 - w0) * 1e-6,
        busy_s=busy_us * 1e-6,
        n_kernels=n_kernels,
        range_kernels={r: {k: v * 1e-6 for k, v in d.items()} for r, d in range_us.items()},
        device_ops=top(per_name),
        idle_gaps=top(gaps),
    )

