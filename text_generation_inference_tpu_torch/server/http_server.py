"""Minimal HTTP endpoint for /health and /metrics.

Counterpart of the reference's axum HTTP server (reference:
router/src/server.rs:446-487, router/src/health.rs). Health is two-level:
the passive flag + loop-freshness check answers immediately when the
batching loop is demonstrably live; otherwise a real 1-token dummy
generation is run through the pipeline (reference: health.rs:53-82), so a
wedged engine thread reports 503 instead of a stale "ok".
"""

from __future__ import annotations

import asyncio
import logging

from ..utils import metrics

logger = logging.getLogger(__name__)

# the loop ticks at least about once a second even when idle (wake-event
# timeout); a loop older than this is either wedged or mid-long-compile
LOOP_FRESH_S = 10.0
PROBE_TIMEOUT_S = 30.0


async def _health_status(batcher) -> bool:
    if batcher is None:
        return True
    if batcher.healthy and batcher.loop_age() < LOOP_FRESH_S:
        return True
    return await batcher.health_probe(timeout=PROBE_TIMEOUT_S)


async def _handle(batcher, reader: asyncio.StreamReader,
                  writer: asyncio.StreamWriter) -> None:
    try:
        request_line = await reader.readline()
        # drain headers
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
        parts = request_line.decode("latin1").split()
        path = parts[1] if len(parts) >= 2 else "/"
        if path == "/metrics":
            body = metrics.render().encode()
            status, ctype = "200 OK", "text/plain; version=0.0.4"
        elif path in ("/health", "/"):
            if await _health_status(batcher):
                body, status = b"ok", "200 OK"
            else:
                body, status = b"unhealthy", "503 Service Unavailable"
            ctype = "text/plain"
        else:
            body, status, ctype = b"not found", "404 Not Found", "text/plain"
        writer.write(
            f"HTTP/1.1 {status}\r\nContent-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n".encode()
            + body)
        await writer.drain()
    except Exception:
        logger.debug("http handler error", exc_info=True)
    finally:
        writer.close()


async def serve_http(batcher, port: int) -> asyncio.AbstractServer:
    server = await asyncio.start_server(
        lambda r, w: _handle(batcher, r, w), host="0.0.0.0", port=port)
    logger.info("HTTP server listening on :%d (/health, /metrics)", port)
    return server
