"""Prometheus metrics registry (no external deps).

Implements the reference's observability surface (reference: README.md
"Metrics" table, router/src/metrics.rs): `tgi_*` counters, gauges, and
histograms, with each counter also exported under a `_total`-suffixed twin
for Prometheus naming convention (reference: metrics.rs:10-19). Rendered in
the text exposition format by `render()` for the /metrics endpoint.
"""

from __future__ import annotations

import bisect
import math
import threading
from collections import defaultdict

_lock = threading.Lock()
_counters: dict[tuple[str, tuple], float] = defaultdict(float)
_gauges: dict[tuple[str, tuple], float] = defaultdict(float)
_histograms: dict[tuple[str, tuple], "_Histogram"] = {}

# geometric-ish duration buckets, mirroring the custom bucketing the
# reference installs for its duration histograms (reference:
# router/src/server.rs:393-444)
DURATION_BUCKETS = [
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 25.0, 60.0, 120.0,
]
COUNT_BUCKETS = [1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096]


class _Histogram:
    __slots__ = ("buckets", "counts", "total", "count")

    def __init__(self, buckets):
        self.buckets = list(buckets)
        self.counts = [0] * len(self.buckets)
        self.total = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.buckets, value)
        if i < len(self.counts):
            self.counts[i] += 1
        self.total += value
        self.count += 1


def _labels_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def increment(name: str, value: float = 1.0, **labels) -> None:
    with _lock:
        _counters[(name, _labels_key(labels))] += value


def gauge_set(name: str, value: float, **labels) -> None:
    with _lock:
        _gauges[(name, _labels_key(labels))] = value


def observe(name: str, value: float, **labels) -> None:
    buckets = COUNT_BUCKETS if (
        name.endswith(("_tokens", "_length", "_count", "_size"))) else DURATION_BUCKETS
    key = (name, _labels_key(labels))
    with _lock:
        h = _histograms.get(key)
        if h is None:
            h = _histograms[key] = _Histogram(buckets)
        h.observe(value)


def touch_histogram(name: str, **labels) -> None:
    """Materialize a histogram series with zero observations."""
    buckets = COUNT_BUCKETS if (
        name.endswith(("_tokens", "_length", "_count", "_size"))) else DURATION_BUCKETS
    key = (name, _labels_key(labels))
    with _lock:
        if key not in _histograms:
            _histograms[key] = _Histogram(buckets)


def preregister() -> None:
    """Materialize event-driven series at zero so a /metrics scrape shows
    the full reference README table from boot (Prometheus zero-init
    convention; reference dashboards expect every series present).
    tgi_batch_concatenation_count and tgi_granular_batch_addition are
    deliberately absent — absorbed by the slot/paged engine design (no
    batch concatenation, no granular weight analysis; see
    proto/CONTRACT.md)."""
    zero_counters = [
        ("tgi_queue_jump", {}),
        ("tgi_prefill_weight_limit_exceeded", {}),
        ("tgi_prefill_padding_limit_exceeded", {}),
        ("tgi_prompt_load_failure", {}),
        ("tgi_request_cancelled", {}),
        ("tgi_request_failure", {"reason": "validation"}),
        ("tgi_batch_inference_failure",
         {"method": "next_token", "reason": "error"}),
        ("tgi_tokenize_request_count", {}),
        ("tgi_tokenize_request_input_count", {}),
    ]
    for name, labels in zero_counters:
        increment(name, 0.0, **labels)
    for name in ("tgi_prompt_load_duration",
                 "tgi_tokenize_request_duration",
                 "tgi_tokenize_request_tokens"):
        touch_histogram(name)
    gauge_set("tgi_queue_size", 0)
    gauge_set("tgi_batch_current_size", 0)
    gauge_set("tgi_batch_input_tokens", 0)
    gauge_set("tgi_batch_max_remaining_tokens", 0)


def reset() -> None:
    with _lock:
        _counters.clear()
        _gauges.clear()
        _histograms.clear()


def _fmt_labels(key: tuple) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


def render() -> str:
    """Prometheus text exposition format."""
    lines: list[str] = []
    with _lock:
        seen_types: set[str] = set()
        for (name, lk), val in sorted(_counters.items()):
            # counters are exported twice: bare and with _total suffix
            for out_name in (name, name + "_total"):
                if out_name not in seen_types:
                    lines.append(f"# TYPE {out_name} counter")
                    seen_types.add(out_name)
                lines.append(f"{out_name}{_fmt_labels(lk)} {_num(val)}")
        for (name, lk), val in sorted(_gauges.items()):
            if name not in seen_types:
                lines.append(f"# TYPE {name} gauge")
                seen_types.add(name)
            lines.append(f"{name}{_fmt_labels(lk)} {_num(val)}")
        for (name, lk), h in sorted(_histograms.items()):
            if name not in seen_types:
                lines.append(f"# TYPE {name} histogram")
                seen_types.add(name)
            cumulative = 0
            for b, c in zip(h.buckets, h.counts):
                cumulative += c
                le = _fmt_labels(lk + (("le", _num(b)),))
                lines.append(f"{name}_bucket{le} {cumulative}")
            le_inf = _fmt_labels(lk + (("le", "+Inf"),))
            lines.append(f"{name}_bucket{le_inf} {h.count}")
            lines.append(f"{name}_sum{_fmt_labels(lk)} {_num(h.total)}")
            lines.append(f"{name}_count{_fmt_labels(lk)} {h.count}")
    return "\n".join(lines) + "\n"


def _num(v) -> str:
    if isinstance(v, float):
        if v == math.inf:
            return "+Inf"
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return repr(v)
    return str(v)
