"""
The live metrics plane: a stdlib-pure, thread-safe registry of counters,
gauges and histograms rendered as Prometheus text exposition (version
0.0.4), plus the process-wide device-time census.  Counterpart of
:mod:`magicsoup_tpu.telemetry.metrics`; for the same calls the rendered
text is byte-equal to the JAX package's.

- **Stdlib-pure.**  Nothing here imports torch, numpy or any other
  module of the package, so the file loads on its own.
- **Zero device sync.**  :func:`note_device_time` is fed from the
  fetch-ready callback the stepper and fleet fire when a dispatch's one
  step-record fetch resolves: device time is the commit-to-fetch-ready
  wall span the pipeline already waits for, never a new synchronize.
- **Exact conservation.**  Device time accumulates as integer
  microseconds, so an even split across tenants (remainder to the first)
  sums exactly to the process total.

Families are registered up front, label values escaped per the
exposition spec, one coarse lock; the hot loop only touches the separate
device-time lock.
"""
from __future__ import annotations

import threading

__all__ = [
    "CONTENT_TYPE",
    "MetricsRegistry",
    "device_time_stats",
    "note_device_time",
    "parse_exposition",
    "reset_device_time",
]

#: the Prometheus text exposition content type (/metrics responses)
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# ----------------------------------------------------------------- #
# process-wide device-time census                                   #
# ----------------------------------------------------------------- #
# mirrors recorder.py's note_fetch/fetch_stats: one lock-guarded pair
# of process accumulators, fed once per PHYSICAL dispatch (a fused
# fleet launch counts once, however many lanes rode it)
_device_lock = threading.Lock()
_device_time_us = 0
_device_dispatches = 0


def note_device_time(seconds: float) -> None:
    """Count one dispatch's commit-to-fetch-ready span (whole-µs).

    Called from the fetch worker's ready callback — once per physical
    device dispatch, before any consumer's ``result()`` returns, so a
    drained scheduler always has a settled census."""
    global _device_time_us, _device_dispatches
    us = max(0, int(round(float(seconds) * 1e6)))
    with _device_lock:
        _device_time_us += us
        _device_dispatches += 1


def device_time_stats() -> dict[str, int]:
    """Process-total measured device time (µs) and dispatches timed."""
    with _device_lock:
        return {
            "device_time_us": _device_time_us,
            "device_dispatches": _device_dispatches,
        }


def reset_device_time() -> None:
    """Zero the census (test isolation; see ``runtime.reset_counters``)."""
    global _device_time_us, _device_dispatches
    with _device_lock:
        _device_time_us = 0
        _device_dispatches = 0


# ----------------------------------------------------------------- #
# exposition format                                                 #
# ----------------------------------------------------------------- #

def escape_label_value(value: str) -> str:
    """Escape a label value per the exposition spec: backslash, quote,
    and newline (in that order — backslash first or the others double)."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _escape_help(text: str) -> str:
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _format_value(value) -> str:
    # integers render bare (no trailing .0) so counter lines are stable
    # byte-for-byte across scrapes that land on whole numbers
    if isinstance(value, bool):
        return str(int(value))
    if isinstance(value, int):
        return str(value)
    f = float(value)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labels_key(label_names, labels: dict) -> tuple:
    extra = set(labels) - set(label_names)
    if extra:
        raise ValueError(
            f"unknown label(s) {sorted(extra)}; declared {list(label_names)}"
        )
    return tuple(str(labels.get(name, "")) for name in label_names)


def _render_labels(label_names, key: tuple) -> str:
    if not label_names:
        return ""
    inner = ",".join(
        f'{name}="{escape_label_value(val)}"'
        for name, val in zip(label_names, key)
    )
    return "{" + inner + "}"


class _Family:
    __slots__ = ("name", "help", "kind", "label_names", "samples", "buckets")

    def __init__(self, name, help_text, kind, label_names, buckets=None):
        self.name = name
        self.help = help_text
        self.kind = kind
        self.label_names = tuple(label_names)
        # labels-key -> value (counter/gauge) or
        # labels-key -> [bucket_counts..., sum, count] (histogram)
        self.samples: dict[tuple, object] = {}
        self.buckets = None if buckets is None else tuple(buckets)


class MetricsRegistry:
    """Fixed-family metrics with Prometheus text rendering.

    Families are declared once (:meth:`counter` / :meth:`gauge` /
    :meth:`histogram`) and fed by ``inc``/``set``/``observe``.
    Counters fed from already-cumulative process totals (the runtime
    snapshot, the accounting ledger) use :meth:`set` — the registry
    pins that the stored value never decreases, so the rendered series
    keeps the counter contract whichever way it is fed.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    # -------------------------------------------------- declaration
    def _declare(self, name, help_text, kind, label_names, buckets=None):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.label_names != tuple(label_names):
                    raise ValueError(
                        f"metric {name!r} re-declared with a different "
                        "type or label set"
                    )
                return fam
            fam = _Family(name, help_text, kind, label_names, buckets)
            self._families[name] = fam
            return fam

    def counter(self, name, help_text, label_names=()):
        self._declare(name, help_text, "counter", label_names)
        return self

    def gauge(self, name, help_text, label_names=()):
        self._declare(name, help_text, "gauge", label_names)
        return self

    def histogram(self, name, help_text, buckets, label_names=()):
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError(f"histogram {name!r} needs at least one bucket")
        self._declare(name, help_text, "histogram", label_names, bounds)
        return self

    # ------------------------------------------------------ feeding
    def _family(self, name, kinds):
        fam = self._families.get(name)
        if fam is None:
            raise KeyError(f"metric {name!r} was never declared")
        if fam.kind not in kinds:
            raise ValueError(
                f"metric {name!r} is a {fam.kind}, not {'/'.join(kinds)}"
            )
        return fam

    def inc(self, name, amount=1, **labels):
        """Add ``amount`` (>= 0) to a counter series."""
        if amount < 0:
            raise ValueError(f"counter {name!r} increment must be >= 0")
        with self._lock:
            fam = self._family(name, ("counter",))
            key = _labels_key(fam.label_names, labels)
            fam.samples[key] = fam.samples.get(key, 0) + amount

    def set(self, name, value, **labels):
        """Set a gauge, or pin a counter to a process-cumulative total
        (monotone: a counter silently keeps its high-water mark)."""
        with self._lock:
            fam = self._family(name, ("counter", "gauge"))
            key = _labels_key(fam.label_names, labels)
            if fam.kind == "counter":
                prev = fam.samples.get(key, 0)
                value = value if value > prev else prev
            fam.samples[key] = value

    def observe(self, name, value, **labels):
        """Record one histogram observation."""
        with self._lock:
            fam = self._family(name, ("histogram",))
            key = _labels_key(fam.label_names, labels)
            state = fam.samples.get(key)
            if state is None:
                state = fam.samples[key] = [0] * len(fam.buckets) + [0.0, 0]
            value = float(value)
            for i, bound in enumerate(fam.buckets):
                if value <= bound:
                    state[i] += 1
            state[-2] += value
            state[-1] += 1

    # ---------------------------------------------------- rendering
    def render(self) -> str:
        """The full exposition document (families in declaration
        order, series in label-sorted order — stable across scrapes)."""
        with self._lock:
            lines: list[str] = []
            for fam in self._families.values():
                lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
                lines.append(f"# TYPE {fam.name} {fam.kind}")
                if fam.kind == "histogram":
                    self._render_histogram(fam, lines)
                    continue
                for key in sorted(fam.samples):
                    labels = _render_labels(fam.label_names, key)
                    value = _format_value(fam.samples[key])
                    lines.append(f"{fam.name}{labels} {value}")
            return "\n".join(lines) + "\n"

    def _render_histogram(self, fam: _Family, lines: list) -> None:
        for key in sorted(fam.samples):
            state = fam.samples[key]
            # bucket counts are stored cumulative-by-le (observe bumps
            # every bucket whose bound covers the value)
            for bound, n in zip(fam.buckets, state[:-2]):
                le = _format_value(bound)
                names = fam.label_names + ("le",)
                labels = _render_labels(names, key + (le,))
                lines.append(f"{fam.name}_bucket{labels} {n}")
            inf_labels = _render_labels(
                fam.label_names + ("le",), key + ("+Inf",)
            )
            lines.append(f"{fam.name}_bucket{inf_labels} {state[-1]}")
            base = _render_labels(fam.label_names, key)
            lines.append(f"{fam.name}_sum{base} {_format_value(state[-2])}")
            lines.append(f"{fam.name}_count{base} {state[-1]}")


# ----------------------------------------------------------------- #
# parsing (tests / smoke / capture folding)                         #
# ----------------------------------------------------------------- #

def _unescape_label_value(value: str) -> str:
    out = []
    i = 0
    while i < len(value):
        ch = value[i]
        if ch == "\\" and i + 1 < len(value):
            nxt = value[i + 1]
            out.append({"n": "\n", '"': '"', "\\": "\\"}.get(nxt, nxt))
            i += 2
            continue
        out.append(ch)
        i += 1
    return "".join(out)


def _parse_labels(blob: str) -> dict:
    labels: dict = {}
    i = 0
    while i < len(blob):
        eq = blob.index("=", i)
        name = blob[i:eq].strip().lstrip(",").strip()
        assert blob[eq + 1] == '"', f"malformed label at {blob[i:]!r}"
        j = eq + 2
        raw = []
        while blob[j] != '"':
            if blob[j] == "\\":
                raw.append(blob[j : j + 2])
                j += 2
                continue
            raw.append(blob[j])
            j += 1
        labels[name] = _unescape_label_value("".join(raw))
        i = j + 1
    return labels


def parse_exposition(text: str) -> dict:
    """Parse an exposition document back into
    ``{"types": {name: kind}, "helps": {name: text},
    "samples": [{"name", "labels", "value"}, ...]}``.

    A deliberately strict inverse of :meth:`MetricsRegistry.render`
    for the test/smoke/capture consumers — not a general scraper."""
    types: dict = {}
    helps: dict = {}
    samples: list = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            name, _, rest = line[len("# HELP ") :].partition(" ")
            helps[name] = rest
            continue
        if line.startswith("# TYPE "):
            name, _, kind = line[len("# TYPE ") :].partition(" ")
            types[name] = kind.strip()
            continue
        if line.startswith("#"):
            continue
        head, _, value = line.rpartition(" ")
        if "{" in head:
            name, _, blob = head.partition("{")
            labels = _parse_labels(blob.rstrip("}"))
        else:
            name, labels = head, {}
        samples.append(
            {"name": name, "labels": labels, "value": float(value)}
        )
    return {"types": types, "helps": helps, "samples": samples}


def sample_value(parsed: dict, name: str, **labels) -> float | None:
    """The value of one series in a :func:`parse_exposition` result
    (``None`` when absent) — label match is exact."""
    for s in parsed["samples"]:
        if s["name"] == name and s["labels"] == labels:
            return s["value"]
    return None
