"""Distributed tracing with OTLP export — self-contained.

Counterpart of the reference's tracing pipeline (reference:
router/src/main.rs:215-264 builds an OTLP exporter + batch span processor
gated behind --otlp-endpoint; router/src/tracing.rs:29-44 extracts the W3C
context from gRPC metadata; grpc_server.rs:98-113 records timing fields on
request spans).

No OpenTelemetry SDK is required: spans are recorded by a small in-process
tracer and exported as OTLP/HTTP JSON (the standard `/v1/traces` protocol,
proto3-JSON encoding of ExportTraceServiceRequest) by a background thread.
Without `configure()` (config.otlp_endpoint unset), span() is a no-op with
zero overhead beyond a None check — matching the reference, which only
installs the OTLP layer when --otlp-endpoint is given.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
import urllib.request
from typing import Iterator, NamedTuple, Optional

logger = logging.getLogger(__name__)


class SpanContext(NamedTuple):
    trace_id: int   # 128-bit
    span_id: int    # 64-bit
    sampled: bool


def parse_traceparent(value: str) -> Optional[SpanContext]:
    """Parse a W3C `traceparent` header: 00-<32hex>-<16hex>-<2hex>."""
    try:
        parts = value.strip().split("-")
        if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
            return None
        trace_id = int(parts[1], 16)
        span_id = int(parts[2], 16)
        if trace_id == 0 or span_id == 0:
            return None
        return SpanContext(trace_id, span_id, bool(int(parts[3], 16) & 1))
    except ValueError:
        return None


def context_from_grpc_metadata(invocation_metadata) -> Optional[SpanContext]:
    """Extract the parent span context from gRPC metadata (reference:
    tracing.rs ExtractTelemetryContext)."""
    for md in invocation_metadata or []:
        if md.key.lower() == "traceparent":
            return parse_traceparent(md.value)
    return None


class Span:
    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start_ns",
                 "end_ns", "attributes")

    def __init__(self, name: str, trace_id: int, span_id: int,
                 parent_id: Optional[int]):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start_ns = time.time_ns()
        self.end_ns = 0
        self.attributes: dict = {}

    def set_attribute(self, key: str, value) -> None:
        self.attributes[key] = value


def _attr_value(v) -> dict:
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


class _OtlpHttpExporter:
    """Batching span exporter speaking OTLP/HTTP JSON to `/v1/traces`
    (the reference's opentelemetry-otlp + BatchSpanProcessor equivalent)."""

    def __init__(self, endpoint: str, service_name: str,
                 max_batch: int = 256, interval_s: float = 3.0):
        base = endpoint.rstrip("/")
        self.url = base if base.endswith("/v1/traces") else base + "/v1/traces"
        self.service_name = service_name
        self.max_batch = max_batch
        self.interval_s = interval_s
        self._buf: list[Span] = []
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._thread = threading.Thread(
            target=self._run, name="otlp-export", daemon=True)
        self._thread.start()

    def submit(self, span: Span) -> None:
        with self._lock:
            self._buf.append(span)
            full = len(self._buf) >= self.max_batch
        if full:
            self._wake.set()

    def _encode(self, spans: list[Span]) -> bytes:
        return json.dumps({
            "resourceSpans": [{
                "resource": {"attributes": [
                    {"key": "service.name",
                     "value": {"stringValue": self.service_name}}]},
                "scopeSpans": [{
                    "scope": {"name": "text-generation-inference-tpu"},
                    "spans": [{
                        "traceId": f"{s.trace_id:032x}",
                        "spanId": f"{s.span_id:016x}",
                        **({"parentSpanId": f"{s.parent_id:016x}"}
                           if s.parent_id else {}),
                        "name": s.name,
                        "kind": 2,   # SPAN_KIND_SERVER
                        "startTimeUnixNano": str(s.start_ns),
                        "endTimeUnixNano": str(s.end_ns),
                        "attributes": [
                            {"key": k, "value": _attr_value(v)}
                            for k, v in s.attributes.items()],
                    } for s in spans],
                }],
            }],
        }).encode()

    def _flush(self) -> None:
        with self._lock:
            spans, self._buf = self._buf, []
        if not spans:
            return
        body = self._encode(spans)
        req = urllib.request.Request(
            self.url, data=body,
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=5) as resp:
                resp.read()
        except Exception as e:   # collector down must never break serving
            logger.debug("OTLP export failed (%d spans dropped): %s",
                         len(spans), e)

    def _run(self) -> None:
        while not self._stop:
            self._wake.wait(timeout=self.interval_s)
            self._wake.clear()
            self._flush()
        self._flush()

    def shutdown(self) -> None:
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=5)


_exporter: Optional[_OtlpHttpExporter] = None


def configure(otlp_endpoint: Optional[str],
              service_name: str = "text-generation-inference-tpu") -> bool:
    """Install the OTLP exporter (reference: main.rs:215-264, gated behind
    --otlp-endpoint). Returns True if tracing is now active."""
    global _exporter
    if not otlp_endpoint:
        return False
    if _exporter is not None:
        _exporter.shutdown()
    _exporter = _OtlpHttpExporter(otlp_endpoint, service_name)
    logger.info("tracing: OTLP export to %s", _exporter.url)
    return True


def shutdown() -> None:
    global _exporter
    if _exporter is not None:
        _exporter.shutdown()
        _exporter = None


def flush() -> None:
    if _exporter is not None:
        _exporter._flush()


def enabled() -> bool:
    return _exporter is not None


def _rand_id(nbytes: int) -> int:
    v = 0
    while v == 0:
        v = int.from_bytes(os.urandom(nbytes), "big")
    return v


# current span per task/thread for parent linking of nested spans
_current = contextlib.nullcontext  # placeholder to keep name free
_local = threading.local()


@contextlib.contextmanager
def span(name: str, context: Optional[SpanContext] = None,
         **attributes) -> Iterator[Optional[Span]]:
    """Open a span. Parent resolution: explicit `context` (extracted from
    gRPC metadata) > enclosing span() on this thread > new root trace."""
    exp = _exporter
    if exp is None:
        yield None
        return
    parent: Optional[SpanContext] = context or getattr(_local, "ctx", None)
    if parent is not None:
        trace_id, parent_id = parent.trace_id, parent.span_id
    else:
        trace_id, parent_id = _rand_id(16), None
    s = Span(name, trace_id, _rand_id(8), parent_id)
    for k, v in attributes.items():
        s.set_attribute(k, v)
    prev = getattr(_local, "ctx", None)
    _local.ctx = SpanContext(trace_id, s.span_id, True)
    try:
        yield s
    finally:
        _local.ctx = prev
        s.end_ns = time.time_ns()
        exp.submit(s)


def record(s: Optional[Span], **attributes) -> None:
    """Record timing/size fields on an open span (mirrors the recorded
    fields of the reference's request spans, grpc_server.rs:98-113)."""
    if s is None:
        return
    for k, v in attributes.items():
        s.set_attribute(k, v)
