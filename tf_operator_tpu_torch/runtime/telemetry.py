"""Pod-side telemetry exporter (a copy of
``tf_operator_tpu/runtime/telemetry.py``).

- :class:`PodTelemetryServer` — a lightweight HTTP server over the
  process-global observability singletons:

      GET /metrics               Prometheus text (utils/metrics)
      GET /traces                finished spans as JSONL (utils/trace)
      GET /debug/flightrecorder  black-box rings (utils/flight)
      GET /debug/compiles        compile ledger (utils/costplane)
      GET /debug/memory          device-memory accountant (utils/costplane)
      GET /healthz               liveness

- :func:`maybe_start_from_env` — boots the server exactly once when
  ``TPUJOB_TELEMETRY_PORT`` names a positive port (the variable the
  JAX package's operator injects into a pod).  Without it there is NO
  server and NO port bind — telemetry is off by default.

- :func:`trace_context_from_env` — the stitching half: a parent span
  context in ``TPUJOB_TRACE_ID`` / ``TPUJOB_PARENT_SPAN_ID`` roots the
  train loop's trace under it.

Everything here is host-side (threads + sockets); nothing touches the
device, so serving telemetry from inside a training process adds no
sync to its step loop.
"""

from __future__ import annotations

import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

#: the environment the JAX package's ``bootstrap/tpu_env.py`` names
ENV_TELEMETRY_PORT = "TPUJOB_TELEMETRY_PORT"
ENV_TRACE_ID = "TPUJOB_TRACE_ID"
ENV_PARENT_SPAN_ID = "TPUJOB_PARENT_SPAN_ID"


def trace_context_from_env(environ=None) -> Tuple[Optional[str], Optional[str]]:
    """(trace_id, parent_span_id) from the environment, or (None, None)
    when it names none — the env twin of ``utils/trace.extract_headers``."""

    e = environ if environ is not None else os.environ
    return e.get(ENV_TRACE_ID) or None, e.get(ENV_PARENT_SPAN_ID) or None


class PodTelemetryServer:
    """Threaded HTTP exporter over one process's observability state.

    ``metrics`` / ``tracer`` / ``recorder`` default to the
    process-global singletons (the values every harness-launched
    trainer actually writes), injectable for tests.
    """

    def __init__(
        self,
        metrics=None,
        tracer=None,
        recorder=None,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        if metrics is None:
            from tf_operator_tpu_torch.utils.metrics import default_metrics

            metrics = default_metrics
        if tracer is None:
            from tf_operator_tpu_torch.utils.trace import default_tracer

            tracer = default_tracer
        if recorder is None:
            from tf_operator_tpu_torch.utils.flight import default_recorder

            recorder = default_recorder
        self.metrics = metrics
        self.tracer = tracer
        self.recorder = recorder
        outer = self

        class Handler(BaseHTTPRequestHandler):
            server_version = "tpu-pod-telemetry/1"

            def log_message(self, fmt, *args):  # quiet
                pass

            def _send(self, code: int, body: str, ctype: str) -> None:
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                try:
                    self.wfile.write(data)
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def do_GET(self):
                route = self.path.split("?")[0]
                try:
                    if route == "/healthz":
                        return self._send(200, "ok\n", "text/plain")
                    if route == "/metrics":
                        return self._send(
                            200, outer.metrics.exposition(), "text/plain"
                        )
                    if route == "/traces":
                        import io

                        buf = io.StringIO()
                        outer.tracer.store.export_jsonl(buf)
                        return self._send(
                            200, buf.getvalue(), "application/x-ndjson"
                        )
                    if route == "/debug/flightrecorder":
                        return self._send(
                            200,
                            outer.recorder.dump_text(),
                            "application/x-ndjson",
                        )
                    if route == "/debug/compiles":
                        import json

                        from tf_operator_tpu_torch.utils.costplane import (
                            default_costplane,
                        )

                        return self._send(
                            200,
                            json.dumps(
                                default_costplane.compiles.snapshot()
                            ),
                            "application/json",
                        )
                    if route == "/debug/memory":
                        import json

                        from tf_operator_tpu_torch.utils.costplane import (
                            default_costplane,
                        )

                        return self._send(
                            200,
                            json.dumps(default_costplane.hbm.snapshot()),
                            "application/json",
                        )
                    return self._send(404, "not found\n", "text/plain")
                except Exception as e:  # noqa: BLE001 - HTTP boundary
                    return self._send(
                        500, f"{type(e).__name__}: {e}\n", "text/plain"
                    )

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "PodTelemetryServer":
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                daemon=True,
                name="pod-telemetry",
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


#: the once-per-process server maybe_start_from_env boots
_started: Optional[PodTelemetryServer] = None
_start_lock = threading.Lock()


def maybe_start_from_env(environ=None) -> Optional[PodTelemetryServer]:
    """Boot the pod telemetry server when ``TPUJOB_TELEMETRY_PORT`` is
    set to a positive port; None (and no socket bind) otherwise.
    Idempotent — the first successful boot wins; later calls return it.
    A bind failure (port taken, restricted env) logs and disables
    rather than killing training: telemetry must never take the
    workload down."""

    global _started
    e = environ if environ is not None else os.environ
    raw = e.get(ENV_TELEMETRY_PORT, "")
    try:
        port = int(raw or "0")
    except ValueError:
        port = 0
    if port <= 0:
        return _started
    with _start_lock:
        if _started is not None:
            return _started
        try:
            _started = PodTelemetryServer(port=port).start()
        except OSError as exc:
            from tf_operator_tpu_torch.utils.logging import FieldLogger, _root

            FieldLogger(_root, component="telemetry").warning(
                "pod telemetry server disabled: cannot bind port %d: %s",
                port, exc,
            )
            return None
    return _started
