"""Black-box flight recorder (a copy of ``tf_operator_tpu/utils/flight.py``):
what was this process doing just before it wedged or died?

The tracing/metrics/logging subsystems answer "how is the system doing"
while someone is watching.  This module answers the postmortem
question: bounded ring buffers of the most recent finished spans, log
records, and metric-delta snapshots are kept process-wide at ~zero
cost, and ``dump()`` writes them as one JSONL snapshot at the moment of
failure — wired to SIGTERM and the fatal-exception hook (``install``,
called from ``serve_lm.main`` only), the alert engine's firing
transitions, and ``serve_lm``'s ``/debug/flightrecorder``.

Everything here is host-side bookkeeping (appends to deques under a
lock); nothing touches the device, so the no-hot-sync invariant is
untouched by recording from the decode loop.

Determinism contract (test-pinned): ``records()``/``dump()`` emit a
single ``meta`` record followed by spans, then logs, then metric
deltas, each oldest-first; two dumps with no intervening activity are
identical except the meta record's wall-clock fields.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import tempfile
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional


def _ring_log_handler(recorder: "FlightRecorder"):
    """logging.Handler appending formatted records to the recorder's
    log ring (the Handler subclass is defined lazily so importing this
    module does not import logging config)."""

    import logging

    class Handler(logging.Handler):
        def emit(self, record):
            try:
                recorder.record_log(
                    level=record.levelname,
                    logger=record.name,
                    message=record.getMessage(),
                    fields=getattr(record, "fields", None),
                )
            except Exception:  # a recorder bug must never kill logging
                # counted, not logged: logging from a failing log
                # handler would recurse
                recorder._count_ring_errors()

    return Handler()


class FlightRecorder:
    """Bounded rings of recent spans / logs / metric deltas + dump().

    Attach points (all optional, all chainable):
      - ``attach_tracer(tracer)``: chains onto ``tracer.on_finish`` so
        every finished span's dict lands in the span ring;
      - ``attach_logger(logger)``: adds a ring handler to a stdlib
        logger (default: the ``tpujob`` root);
      - ``attach_metrics(metrics)``: remembers the registry so
        ``snapshot_metrics()`` can record counter/gauge deltas.
    """

    def __init__(
        self,
        max_spans: int = 256,
        max_logs: int = 512,
        max_snapshots: int = 32,
        max_requests: int = 16,
        max_arena_samples: int = 64,
    ):
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=max_spans)
        self._logs: deque = deque(maxlen=max_logs)
        self._snapshots: deque = deque(maxlen=max_snapshots)
        self._metrics = None
        self._last_counters: Dict[str, float] = {}
        self._dumps = 0
        #: serving-plane attach points — request autopsies
        #: (models/batching.RequestLog) and arena occupancy timelines
        #: (models/kv_blocks.ArenaTimeline).  Bounded deques: tests
        #: build handlers by the dozen against the process-global
        #: recorder, so stale sources age out instead of accumulating.
        self.max_requests = int(max_requests)
        self.max_arena_samples = int(max_arena_samples)
        self._request_logs: deque = deque(maxlen=8)
        self._arena_timelines: deque = deque(maxlen=8)
        #: recorder-internal failures (ring-handler emit errors, dump
        #: source errors) — surfaced in the dump meta record rather
        #: than swallowed.  Counted through _count_ring_errors so two
        #: concurrent dumps cannot lose an increment.
        self.ring_errors = 0

    def _count_ring_errors(self, n: int = 1) -> None:
        with self._lock:
            self.ring_errors += n

    # -- recording ----------------------------------------------------------

    def record_span(self, span) -> None:
        """Append one finished span (a Span or its dict)."""

        d = span.to_dict() if hasattr(span, "to_dict") else dict(span)
        with self._lock:
            self._spans.append(d)

    def record_log(
        self,
        level: str,
        logger: str,
        message: str,
        fields: Optional[Dict[str, Any]] = None,
    ) -> None:
        rec = {"level": level, "logger": logger, "message": message,
               "unix": time.time()}
        if fields:
            rec["fields"] = dict(fields)
        with self._lock:
            self._logs.append(rec)

    def snapshot_metrics(self, label: str = "") -> Dict[str, float]:
        """Record the delta of every counter/gauge since the previous
        snapshot (first call records absolute values).  Returns the
        delta dict.  No-op ({}) without an attached registry."""

        if self._metrics is None:
            return {}
        now = self._metrics.counters_snapshot()
        with self._lock:
            delta = {
                k: round(v - self._last_counters.get(k, 0.0), 6)
                for k, v in now.items()
                if v != self._last_counters.get(k, 0.0)
            }
            self._last_counters = now
            self._snapshots.append(
                {"label": label, "unix": time.time(), "delta": delta}
            )
        return delta

    # -- attach points ------------------------------------------------------

    def attach_tracer(self, tracer) -> None:
        prev = tracer.on_finish

        def chained(span):
            self.record_span(span)
            if prev is not None:
                prev(span)

        tracer.on_finish = chained

    def attach_logger(self, logger=None) -> None:
        import logging

        if logger is None:
            logger = logging.getLogger("tpujob")
        logger.addHandler(_ring_log_handler(self))

    def attach_metrics(self, metrics) -> None:
        self._metrics = metrics

    def attach_request_log(self, log) -> None:
        """Register a serving RequestLog: every dump carries its
        last-K request autopsies, so a post-mortem names the requests
        in flight when the episode fired."""

        with self._lock:
            self._request_logs.append(log)

    def attach_arena_timeline(self, timeline) -> None:
        """Register a KV-arena occupancy timeline: every dump carries
        its sample tail — the pressure history leading into the
        failure, not just the final gauge value."""

        with self._lock:
            self._arena_timelines.append(timeline)

    # -- export -------------------------------------------------------------

    def records(self) -> List[Dict[str, Any]]:
        """meta + spans + logs + metric snapshots + request autopsies
        + arena timelines, oldest-first within each section — the
        exact dump order (determinism contract).  The serving sections
        appear only when sources are attached and non-empty."""

        with self._lock:
            spans = list(self._spans)
            logs = list(self._logs)
            snaps = list(self._snapshots)
            dumps = self._dumps
            request_logs = list(self._request_logs)
            timelines = list(self._arena_timelines)
        source_errors = 0
        requests: List[Dict[str, Any]] = []
        for log in request_logs if self.max_requests > 0 else []:
            try:
                requests.extend(log.recent(self.max_requests))
            except Exception:  # a source bug must never kill a dump
                source_errors += 1
        # time-merge across logs BEFORE truncating: a plain per-log
        # concatenation would let the last-attached replica's entries
        # crowd every other replica out of the K-slot tail
        requests.sort(key=lambda e: e.get("submit_unix", 0.0))
        # the tail is the newest K ids with every entry of each: a roles
        # fleet logs each request on its prefill replica (the internal
        # publish) and on its decode replica, and a tail of K entries
        # would name K / 2 requests (the reference's does)
        ids = set(list(dict.fromkeys(e.get("id") for e in reversed(requests)))
                  [:self.max_requests])
        requests = [e for e in requests if e.get("id") in ids]
        arenas: List[Dict[str, Any]] = []
        for tl in timelines if self.max_arena_samples > 0 else []:
            try:
                snap = tl.snapshot(self.max_arena_samples)
                if snap["samples"]:
                    arenas.append(snap)
            except Exception:
                source_errors += 1
        if source_errors:
            self._count_ring_errors(source_errors)
        meta = {
            "type": "meta",
            "pid": os.getpid(),
            "unix": time.time(),
            "spans": len(spans),
            "logs": len(logs),
            "metricSnapshots": len(snaps),
            "requests": len(requests),
            "arenaTimelines": len(arenas),
            "priorDumps": dumps,
            "ringErrors": self.ring_errors,
        }
        out: List[Dict[str, Any]] = [meta]
        out.extend({"type": "span", **s} for s in spans)
        out.extend({"type": "log", **r} for r in logs)
        out.extend({"type": "metrics", **s} for s in snaps)
        out.extend({"type": "request", **r} for r in requests)
        out.extend({"type": "arena", **a} for a in arenas)
        return out

    def dump(self, fileobj=None, path: Optional[str] = None, reason: str = "") -> str:
        """Write the JSONL snapshot.  With ``path`` (or neither arg) a
        file under ``$TPUJOB_FLIGHT_DIR`` (default: the temporary
        directory, /tmp unless ``TMPDIR`` says otherwise) is created and
        its path returned; with ``fileobj`` the lines stream there and
        the return value is "".  Never raises — a dying process calls
        this from signal/excepthook context."""

        try:
            records = self.records()
            if reason:
                records[0]["reason"] = reason
            with self._lock:
                self._dumps += 1
                # the filename seq is THIS dump's increment: reading
                # self._dumps outside the lock would let two concurrent
                # dumps (two worker threads dying at once) compute the
                # same path and overwrite one postmortem
                seq = self._dumps
            if fileobj is not None:
                for r in records:
                    fileobj.write(json.dumps(r) + "\n")
                return ""
            if path is None:
                d = os.environ.get("TPUJOB_FLIGHT_DIR") or tempfile.gettempdir()
                os.makedirs(d, exist_ok=True)
                path = os.path.join(
                    d,
                    f"flight-{os.getpid()}-{seq}"
                    f"{'-' + reason if reason else ''}.jsonl",
                )
            with open(path, "w") as f:
                for r in records:
                    f.write(json.dumps(r) + "\n")
            return path
        except Exception:  # noqa: BLE001 - crash-path best effort
            return ""

    def dump_text(self) -> str:
        """The JSONL snapshot as one string (the HTTP endpoints)."""

        return "\n".join(json.dumps(r) for r in self.records()) + "\n"


#: process-global default (mirrors metrics/tracer defaults): the HTTP
#: debug endpoints and the watchdog read this instance
default_recorder = FlightRecorder()

_installed: Optional[FlightRecorder] = None
_install_lock = threading.Lock()


def install(
    recorder: Optional[FlightRecorder] = None,
    tracer=None,
    metrics=None,
    logger=None,
    signals: bool = True,
    excepthook: bool = True,
) -> FlightRecorder:
    """Register the recorder process-wide: tracer + logger + metrics
    attach, SIGTERM chains a dump before the previous handler runs,
    and a fatal (uncaught) exception dumps from sys.excepthook.
    Idempotent — a second install is a no-op that returns whichever
    recorder was ACTUALLY wired first (never an unwired argument)."""

    global _installed
    rec = recorder if recorder is not None else default_recorder
    with _install_lock:
        if _installed is not None:
            return _installed
        # wire UNDER the lock and publish only on success: a concurrent
        # install() must never be handed a recorder whose attaches
        # haven't run yet, and a wiring failure (e.g. signal.signal in
        # a restricted environment) must leave the slot free instead of
        # pinning a half-wired recorder forever
        _wire(rec, tracer, metrics, logger, signals, excepthook)
        _installed = rec
    return rec


def _wire(rec, tracer, metrics, logger, signals, excepthook) -> None:
    # the FALLIBLE wiring (signal.signal can raise in restricted
    # environments) runs FIRST so a failed install leaves nothing
    # attached — a retry then cannot chain on_finish / ring handlers
    # twice; the attaches at the bottom are plain assignments
    if signals and threading.current_thread() is threading.main_thread():
        prev_term = signal.getsignal(signal.SIGTERM)

        def on_term(signum, frame):
            rec.dump(reason="sigterm")
            if callable(prev_term):
                prev_term(signum, frame)
            elif prev_term == signal.SIG_DFL:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

        signal.signal(signal.SIGTERM, on_term)

    if excepthook:
        prev_hook = sys.excepthook

        def on_fatal(exc_type, exc, tb):
            rec.record_log(
                "FATAL", "excepthook", f"{exc_type.__name__}: {exc}"
            )
            rec.dump(reason="fatal")
            prev_hook(exc_type, exc, tb)

        sys.excepthook = on_fatal

        # most of this process's work runs on THREADS (watch loops,
        # kubelet sim, reconcile workers) — sys.excepthook never fires
        # for those; threading.excepthook does
        prev_thread_hook = threading.excepthook

        def on_thread_fatal(args):
            rec.record_log(
                "FATAL", "threading.excepthook",
                f"{args.exc_type.__name__}: {args.exc_value} "
                f"(thread {getattr(args.thread, 'name', '?')})",
            )
            rec.dump(reason="fatal-thread")
            prev_thread_hook(args)

        threading.excepthook = on_thread_fatal

    from tf_operator_tpu_torch.utils.metrics import default_metrics
    from tf_operator_tpu_torch.utils.trace import default_tracer

    rec.attach_tracer(tracer if tracer is not None else default_tracer)
    rec.attach_logger(logger)
    rec.attach_metrics(metrics if metrics is not None else default_metrics)
