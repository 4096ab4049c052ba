"""Stdlib HTTP endpoint for the metrics registry.

``MetricsServer(port)`` serves the live registry from a daemon thread:

* ``GET /metrics``       -> Prometheus text exposition
* ``GET /metrics.json``  -> JSON snapshot (counters/gauges/histograms/events)

Used by ``launch.serve --metrics-port``; ``port=0`` binds an ephemeral
port (``server.port`` reports the real one -- handy in tests).
Counterpart of ``repro/obs/server.py``.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import export as _export

__all__ = ["MetricsServer"]


class _Handler(BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802 (http.server API)
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            body = _export.render_prometheus().encode()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif path in ("/metrics.json", "/snapshot"):
            body = json.dumps(_export.snapshot(), default=str).encode()
            ctype = "application/json"
        else:
            self.send_error(404, "try /metrics or /metrics.json")
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # silence per-request stderr noise
        pass


class MetricsServer:
    """Daemon-threaded HTTP server over the process-local registry."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="obs-metrics-server", daemon=True
        )
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False
