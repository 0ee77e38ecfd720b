"""Distributed tracing (a copy of ``tf_operator_tpu/utils/trace.py``):
one trace id from an HTTP request to the device dispatches it caused.

Counters and gauges (``utils/metrics.py``) give aggregate health, but
no way to see *where* one slow request spent its time.  This module is
the request-scoped half:

- **Span**: a named, timed operation with attributes, point-in-time
  events, and an ok/error status.  Context-manager; an exception
  leaving the block marks the span failed with the exception type.
- **Tracer**: mints ids and propagates the current span through
  ``contextvars`` (thread- and asyncio-safe), so code deep in a call
  stack parents its spans correctly without threading a span argument
  through every signature.  Ids are a tracer prefix + counter from a
  seedable RNG — seeded tracers are fully deterministic, which is what
  lets tests assert exact trace ids with no wall-clock/random flake.
- **TraceStore**: bounded in-memory buffer of finished spans grouped
  by trace id, with *tail sampling*: when the cap forces eviction, the
  oldest trace that is neither errored nor slow goes first, so the
  traces an operator actually wants (failures, latency outliers)
  survive load.  JSONL export for offline tooling.

Propagation contract (the wire half): HTTP carries the trace in two
headers, ``x-trace-id`` and ``x-parent-span-id``
(``inject_headers``/``extract_headers``).  The port's ``serve_lm``
adopts an incoming trace id (minting one otherwise), records a
``serve.generate`` server span, and echoes ``x-trace-id`` on EVERY
response, so one id stitches the HTTP request → the pool's
``queue.wait`` / ``admission`` / ``decode.window`` / ``retire``
lifecycle spans → the ledger's ``dispatch.<phase>`` spans.  Across
processes each side keeps its own store and the shared trace id links
their JSONL exports.
"""

from __future__ import annotations

import contextvars
import json
import random
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

#: the wire contract: trace id + parent span id request/response headers
TRACE_HEADER = "x-trace-id"
PARENT_HEADER = "x-parent-span-id"

#: the contextvar carrying the active span (shared by all tracers:
#: "the current operation" is a property of the execution context, not
#: of whichever tracer started it)
_current_span: contextvars.ContextVar[Optional["Span"]] = (
    contextvars.ContextVar("tpujob-current-span", default=None)
)


class Span:
    """One named, timed operation inside a trace.

    Use as a context manager (the normal path — exceptions mark the
    span errored and always end it) or call ``end()`` explicitly.
    ``end()`` is idempotent: long-lived streaming handlers end their
    span once the response is committed and a later duplicate end is
    a no-op.
    """

    __slots__ = (
        "trace_id", "span_id", "parent_id", "name", "kind",
        "start_unix", "start_mono", "duration", "attributes", "events",
        "status", "status_message", "_tracer", "_ctx_token",
    )

    def __init__(
        self,
        tracer: "Tracer",
        trace_id: str,
        span_id: str,
        parent_id: Optional[str],
        name: str,
        kind: str = "internal",
        attributes: Optional[Dict[str, Any]] = None,
        start_mono: Optional[float] = None,
    ):
        self._tracer = tracer
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.kind = kind  # internal | client | server | producer
        self.start_unix = time.time()
        self.start_mono = (
            time.monotonic() if start_mono is None else float(start_mono)
        )
        self.duration: Optional[float] = None
        self.attributes: Dict[str, Any] = dict(attributes or {})
        self.events: List[Dict[str, Any]] = []
        self.status = "ok"
        self.status_message = ""
        self._ctx_token: Optional[contextvars.Token] = None

    # -- recording ----------------------------------------------------------

    def set_attribute(self, key: str, value: Any) -> "Span":
        self.attributes[key] = value
        return self

    def add_event(self, name: str, **attrs: Any) -> "Span":
        self.events.append(
            {"name": name, "offset": time.monotonic() - self.start_mono,
             **attrs}
        )
        return self

    def set_error(self, message: str) -> "Span":
        self.status = "error"
        self.status_message = str(message)[:200]
        return self

    def end(self, end_mono: Optional[float] = None) -> None:
        if self.duration is not None:
            return  # idempotent
        end = time.monotonic() if end_mono is None else float(end_mono)
        self.duration = max(0.0, end - self.start_mono)
        self._tracer._finish(self)

    # -- context management -------------------------------------------------

    def __enter__(self) -> "Span":
        self._ctx_token = _current_span.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._ctx_token is not None:
            _current_span.reset(self._ctx_token)
            self._ctx_token = None
        if exc is not None and self.status == "ok":
            self.set_error(f"{type(exc).__name__}: {exc}")
        self.end()
        return False  # never swallow

    # -- export -------------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return {
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "parentId": self.parent_id,
            "name": self.name,
            "kind": self.kind,
            "startUnix": self.start_unix,
            "startMono": self.start_mono,
            "duration": self.duration,
            "attributes": dict(self.attributes),
            "events": list(self.events),
            "status": self.status,
            "statusMessage": self.status_message,
        }


class TraceStore:
    """Bounded store of FINISHED spans grouped by trace id, with tail
    sampling: eviction prefers dropping ok-and-fast traces, so error
    and slow traces survive until only protected traces remain (then
    oldest-first keeps memory bounded regardless).

    Knobs:
      - ``max_traces``: total traces retained;
      - ``max_spans_per_trace``: per-trace span cap — overflow spans
        are dropped and counted in the trace's ``droppedSpans`` so a
        truncated waterfall says so;
      - ``slow_seconds``: a trace with any span at least this long is
        "slow" and protected from preferential eviction.
    """

    def __init__(
        self,
        max_traces: int = 256,
        max_spans_per_trace: int = 512,
        slow_seconds: float = 1.0,
    ):
        self.max_traces = max(1, int(max_traces))
        self.max_spans_per_trace = int(max_spans_per_trace)
        self.slow_seconds = float(slow_seconds)
        self._lock = threading.Lock()
        #: trace id -> {"spans": [dict], "error": bool, "slow": bool,
        #:              "dropped": int, "first_unix": float}
        self._traces: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()

    def add(self, span: Span) -> None:
        self.add_dict(span.to_dict())

    def add_dict(self, d: Dict[str, Any]) -> None:
        """Fold one FINISHED span in exported-dict form (the shape
        ``Span.to_dict``/JSONL export emits) — the cross-process path:
        the telemetry scraper stitches pod-side spans into the
        operator's store through this, so ``/traces/<id>`` shows one
        reconcile→boot→train waterfall even though the training spans
        finished in another process."""

        trace_id = d.get("traceId")
        if not trace_id:
            return
        with self._lock:
            t = self._traces.get(trace_id)
            if t is None:
                t = {
                    "spans": [], "error": False, "slow": False,
                    "dropped": 0, "first_unix": d.get("startUnix", 0.0),
                }
                self._traces[trace_id] = t
                self._evict_locked(keep=trace_id)
            if len(t["spans"]) >= self.max_spans_per_trace:
                t["dropped"] += 1
            else:
                t["spans"].append(dict(d))
            if d.get("status") == "error":
                t["error"] = True
            duration = d.get("duration")
            if duration is not None and duration >= self.slow_seconds:
                t["slow"] = True

    def _evict_locked(self, keep: str) -> None:
        # ``keep`` is the just-inserted trace: it has no spans yet, so
        # it is never error/slow — without the exemption, a store full
        # of protected traces would evict every NEW trace at insertion
        # and wedge on its first max_traces errors forever
        while len(self._traces) > self.max_traces:
            victim = None
            for tid, t in self._traces.items():  # insertion = age order
                if tid != keep and not (t["error"] or t["slow"]):
                    victim = tid
                    break
            if victim is None:  # everything else protected: oldest goes
                victim = next(
                    tid for tid in self._traces if tid != keep
                )
            del self._traces[victim]

    # -- reads --------------------------------------------------------------

    def trace(self, trace_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            t = self._traces.get(trace_id)
            if t is None:
                return None
            return {
                "traceId": trace_id,
                "error": t["error"],
                "slow": t["slow"],
                "droppedSpans": t["dropped"],
                "spans": [dict(s) for s in t["spans"]],
            }

    def summaries(self, limit: int = 50) -> List[Dict[str, Any]]:
        """Newest-first trace summaries for list endpoints/dashboards."""

        with self._lock:
            items = list(self._traces.items())
        out = []
        for tid, t in reversed(items[-limit * 2:] if limit else items):
            spans = t["spans"]
            root = next(
                (s for s in spans if not s["parentId"]),
                spans[0] if spans else None,
            )
            total = max(
                (s["duration"] for s in spans if s["duration"] is not None),
                default=0.0,
            )
            out.append({
                "traceId": tid,
                "root": root["name"] if root else "?",
                "startUnix": t["first_unix"],
                "spanCount": len(spans),
                "droppedSpans": t["dropped"],
                "duration": total,
                "error": t["error"],
                "slow": t["slow"],
                "queueLatency": next(
                    (s["duration"] for s in spans
                     if s["name"] == "queue.wait"), None,
                ),
            })
            if limit and len(out) >= limit:
                break
        return out

    def export_jsonl(self, fileobj) -> int:
        """One finished span per line; returns the line count."""

        with self._lock:
            spans = [
                s for t in self._traces.values() for s in t["spans"]
            ]
        for s in spans:
            fileobj.write(json.dumps(s) + "\n")
        return len(spans)

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._traces)


class Tracer:
    """Span factory + contextvars propagation + id minting.

    ``seed`` makes the id sequence fully deterministic (tests pin
    exact ids); unseeded tracers get a random prefix so two
    processes' ids cannot collide.
    """

    def __init__(
        self,
        store: Optional[TraceStore] = None,
        seed: Optional[int] = None,
    ):
        self.store = store if store is not None else TraceStore()
        rng = random.Random(seed)
        self._prefix = f"{rng.getrandbits(32):08x}"
        self._lock = threading.Lock()
        self._counter = 0
        #: optional sink called with every finished span (exporters)
        self.on_finish: Optional[Callable[[Span], None]] = None

    def _next_id(self, tag: str) -> str:
        with self._lock:
            self._counter += 1
            return f"{tag}{self._prefix}{self._counter:06x}"

    def mint_trace_id(self) -> str:
        """A fresh trace id WITHOUT starting a span — the serving
        pool's request identity when a request arrives with no
        incoming trace context (every request gets a first-class id
        at submit; the HTTP path adopts ``x-trace-id`` instead).  Same id space as span-rooted traces, so the later
        lifecycle spans join it exactly like a remote trace."""

        return self._next_id("t")

    # -- span creation ------------------------------------------------------

    def start_span(
        self,
        name: str,
        *,
        kind: str = "internal",
        trace_id: Optional[str] = None,
        parent_id: Optional[str] = None,
        attributes: Optional[Dict[str, Any]] = None,
        start_mono: Optional[float] = None,
        root: bool = False,
    ) -> Span:
        """New span: child of the context's current span by default;
        ``root=True`` forces a fresh trace; explicit ``trace_id`` joins
        a remote trace (``parent_id`` from the wire, when sent)."""

        parent = None if root else _current_span.get()
        if trace_id is None:
            if parent is not None:
                trace_id = parent.trace_id
                parent_id = parent.span_id
            else:
                trace_id = self._next_id("t")
        elif parent_id is None and parent is not None and (
            parent.trace_id == trace_id
        ):
            parent_id = parent.span_id
        return Span(
            self, trace_id, self._next_id("s"), parent_id, name,
            kind=kind, attributes=attributes, start_mono=start_mono,
        )

    def span(self, name: str, **kw) -> Span:
        """``with tracer.span("pod.create") as sp:`` — the convenience
        spelling of start_span (the Span is its own context manager)."""

        return self.start_span(name, **kw)

    def _finish(self, span: Span) -> None:
        self.store.add(span)
        if self.on_finish is not None:
            self.on_finish(span)

    # -- context reads ------------------------------------------------------

    @staticmethod
    def current_span() -> Optional[Span]:
        return _current_span.get()

    @staticmethod
    def current_trace_id() -> Optional[str]:
        span = _current_span.get()
        return span.trace_id if span is not None else None


def current_trace_id() -> Optional[str]:
    """Module-level shorthand for exemplar linkage (metrics, logs)."""

    return Tracer.current_trace_id()


# -- wire propagation -------------------------------------------------------


def inject_headers(
    headers: Dict[str, str], span: Optional[Span] = None
) -> Dict[str, str]:
    """Stamp the active (or given) span's trace context into request
    headers; a no-op when nothing is being traced."""

    span = span if span is not None else _current_span.get()
    if span is not None:
        headers[TRACE_HEADER] = span.trace_id
        headers[PARENT_HEADER] = span.span_id
    return headers


def extract_headers(headers) -> Tuple[Optional[str], Optional[str]]:
    """(trace_id, parent_span_id) from an incoming request's headers
    (any mapping with a case-insensitive ``get``, e.g. http.client's)."""

    get = headers.get
    return get(TRACE_HEADER), get(PARENT_HEADER)


#: process-global default (mirrors utils.metrics.default_metrics):
#: in-process client+server share it, so one store holds the whole
#: waterfall; components accept an override for seeded-deterministic
#: tests
default_tracer = Tracer()
