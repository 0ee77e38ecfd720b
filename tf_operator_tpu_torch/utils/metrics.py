"""Metrics registry (a copy of ``tf_operator_tpu/utils/metrics.py``).

In-process counters, gauges and histograms with a Prometheus-style text
exposition, the closed serving ``DISPATCH_PHASES`` taxonomy, and the
``DispatchLedger`` that counts and times the serving pool's device
calls (``StepSyncLedger``, its training twin, is here so the module
stays whole).

What ``serving_dispatch_seconds`` times on CUDA: a ``with
ledger.dispatch(phase)`` block times the host wall of the block, that
is the kernels' enqueue plus any device->host fetch inside it.  The
pool's ``step`` block holds the window's one token fetch (``.cpu()``),
its ``admission`` block the first token's (``int()``), and the swap
copies are synchronous, so ``step``, ``admission``, ``swap_out`` and
``swap_in`` time the device work too; ``retire`` times only its
enqueue.  That is the ledger's contract: include the fetch you need in
the block, and the block times the round trip.
"""

from __future__ import annotations

import contextlib
import math
import threading
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple


#: default histogram buckets (seconds) — sync/span durations
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

#: serving-SLO buckets (seconds): user-facing latencies stretch past the
#: sync-duration range (a long generate behind a full pool takes
#: seconds to tens of seconds), so the SLO families get a longer tail
SLO_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

#: the serving DispatchLedger phase taxonomy — the closed set of
#: literal phases the serving decoders pass to ``ledger.dispatch()``.
#: Every phase here lowers to a ``dispatch.<phase>`` trace span (the
#: ledger derives the span name), and the request-autopsy /
#: waterfall layers key on those literal names, so a renamed phase
#: would silently orphan them.  tests/test_torch_serving_plane.py
#: holds the tuple equal to the JAX package's.
DISPATCH_PHASES = (
    "admission",  # pool fused prefill+sample+seat (one program)
    "prefill",    # legacy/chunked prompt chunks; speculative prefills
    "sample",     # legacy pool first-token sample
    "scatter",    # legacy pool seating scatter
    "step",       # pool K-step decode window; speculative host loop
    "retire",     # paged pool batched device-state reset
    "swap_out",   # preemption: victim block gather + rng fetch
    "swap_in",    # resume: swapped-block upload + device-row restore
    "migrate_out",  # prefill replica: prompt-block gather → fabric
    "migrate_in",   # decode replica: fabric-block upload into its arena
    "decode",     # chunked decoder budget loop
    "generate",   # speculative fused whole-generation program
    "round",      # speculative host-driven round loop
    "chunk",      # speculative scan loop
    "draft",      # paged speculative: draft prefill + K+1-step draft scan
    "verify",     # paged speculative: one multi-query target dispatch
)


def finite_summary(summary: Dict[str, float]) -> Dict[str, Any]:
    """JSON-safe histogram summary for the /slo endpoints: a quantile
    landing in the overflow bucket is ``float('inf')``, which
    ``json.dumps`` would emit as the non-JSON token ``Infinity`` and
    break strict parsers — map non-finite floats to None."""

    return {
        k: (None if isinstance(v, float) and not math.isfinite(v) else v)
        for k, v in summary.items()
    }


def _escape_label(value) -> str:
    """Prometheus text-format label-value escaping: backslash, double
    quote, and newline must be escaped or the exposition line is
    unparseable (the strict-parse test enforces this round-trips)."""

    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _label_str(labels: Tuple[Tuple[str, str], ...], extra: str = "") -> str:
    parts = [f'{k}="{_escape_label(v)}"' for k, v in labels]
    if extra:
        parts.append(extra)
    return ",".join(parts)


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = defaultdict(float)
        self._gauges: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
        self._observations: Dict[str, List[float]] = defaultdict(list)
        #: (name, labels) -> [buckets, counts[len(buckets)+1], sum, count]
        self._histograms: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], list] = {}
        #: per-family bucket config (set_buckets): consulted when a
        #: family's first observation arrives without explicit buckets
        self._family_buckets: Dict[str, Tuple[float, ...]] = {}
        #: name -> trace id of the most recent exemplar-carrying inc —
        #: the counter→trace link (OpenMetrics-exemplar-style): "this
        #: client has 14 errors" becomes "...and HERE is one of them"
        self._exemplars: Dict[str, str] = {}
        #: family name -> HELP text (describe()); families without one
        #: get an auto-generated line — the exposition emits # HELP and
        #: # TYPE for EVERY family either way (strict-parse pinned)
        self._help: Dict[str, str] = {}

    def describe(self, name: str, help_text: str) -> None:
        """Attach a ``# HELP`` line to a family.  Optional — families
        never described still get an auto HELP plus the correct
        ``# TYPE`` in the exposition."""

        with self._lock:
            self._help[name] = str(help_text)

    def inc(
        self, name: str, value: float = 1.0, *,
        exemplar: "str | None" = None, **labels: str,
    ) -> None:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self._counters[key] += value
            if exemplar:
                self._exemplars[name] = str(exemplar)

    def exemplar(self, name: str) -> "str | None":
        """Trace id recorded with the most recent increment of ``name``
        (None when no exemplar-carrying inc has happened)."""

        with self._lock:
            return self._exemplars.get(name)

    def set(self, name: str, value: float, **labels: str) -> None:
        """Gauge write (last-value-wins) — e.g. the API clients' last-
        error timestamps (backend/retry.py)."""

        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self._gauges[key] = float(value)

    def gauge(self, name: str, **labels: str) -> float:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            return self._gauges.get(key, 0.0)

    def clear_gauge(self, name: str, **labels: str) -> None:
        """Drop every series of gauge ``name`` whose labels contain
        ``labels`` (subset match; no labels = the whole family).
        Per-object gauges (autoscaler_desired_replicas{job=}) must not
        outlive their object — a deleted job exporting a stale desired
        count forever is a lie, and per-object label sets otherwise
        grow monotonically across churn."""

        with self._lock:
            for key in [
                k
                for k in self._gauges
                if k[0] == name
                and all(dict(k[1]).get(n) == str(v) for n, v in labels.items())
            ]:
                del self._gauges[key]

    def clear_counter(self, name: str, **labels: str) -> None:
        """Drop every series of counter ``name`` whose labels contain
        ``labels`` (subset match; no labels = the whole family) — the
        counter twin of ``clear_gauge``.  Exists for FEDERATED series
        (controller/telemetry.py): a counter mirrored from a pod that
        died must be swept, not exported frozen forever."""

        with self._lock:
            for key in [
                k
                for k in self._counters
                if k[0] == name
                and all(dict(k[1]).get(n) == str(v) for n, v in labels.items())
            ]:
                del self._counters[key]

    def clear_histogram(self, name: str, **labels: str) -> None:
        """``clear_gauge`` semantics for histogram series (federated
        staleness sweep)."""

        with self._lock:
            for key in [
                k
                for k in self._histograms
                if k[0] == name
                and all(dict(k[1]).get(n) == str(v) for n, v in labels.items())
            ]:
                del self._histograms[key]

    def merge_histogram(
        self,
        name: str,
        buckets: Tuple[float, ...],
        counts: List[int],
        sum_delta: float,
        count_delta: int,
        **labels: str,
    ) -> None:
        """Add pre-bucketed observations into one histogram series —
        the federation write (``counts`` has len(buckets)+1 per-bucket
        deltas, NOT cumulative).  Same-bucket series sum elementwise; a
        bucket-boundary mismatch REPLACES the series (the source pod
        restarted with a different config — summing positionally would
        lie, exactly the ``histogram_family_merged`` rule)."""

        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        bks = tuple(buckets)
        with self._lock:
            h = self._histograms.get(key)
            if h is None or h[0] != bks:
                self._histograms[key] = [
                    bks, list(counts), float(sum_delta), int(count_delta),
                ]
                return
            h[1] = [a + b for a, b in zip(h[1], counts)]
            h[2] += float(sum_delta)
            h[3] += int(count_delta)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            self._observations[name].append(value)

    def set_buckets(self, name: str, buckets: Tuple[float, ...]) -> None:
        """Per-family bucket config: every later observation of
        ``name`` (any label set) that does not pass explicit buckets
        uses these.  Call before the first observation — an existing
        series keeps the buckets it was created with."""

        with self._lock:
            self._family_buckets[name] = tuple(buckets)

    def observe_histogram(
        self,
        name: str,
        value: float,
        buckets: "Tuple[float, ...] | None" = None,
        *,
        exemplar: "str | None" = None,
        **labels: str,
    ) -> None:
        """Bounded-memory histogram (Prometheus bucket semantics) — use
        for unbounded-cardinality series like per-sync durations, where
        the raw-observation list of ``observe`` would leak.  Labeled:
        each label set is its own bucket series within the family
        (``serve_ttft_seconds{model="llama-tiny"}``).  ``exemplar``
        records a trace id against the FAMILY (same store and
        latest-write-wins semantics as ``inc``'s exemplars, surfaced
        as ``# exemplar`` comment lines — deliberately not per label
        set: one freshest reproduction per family is the contract the
        dashboard's deep-links parse) — "p99 TTFT is bad" deep-links
        to a request that lived it."""

        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        with self._lock:
            if exemplar:
                self._exemplars[name] = str(exemplar)
            h = self._histograms.get(key)
            if h is None:
                bks = (
                    tuple(buckets)
                    if buckets is not None
                    else self._family_buckets.get(name, DEFAULT_BUCKETS)
                )
                h = [bks, [0] * (len(bks) + 1), 0.0, 0]
                self._histograms[key] = h
            bks, counts, _, _ = h
            i = 0
            while i < len(bks) and value > bks[i]:
                i += 1
            counts[i] += 1
            h[2] += value
            h[3] += 1

    def histogram(self, name: str, **labels: str) -> Dict[str, float]:
        """Summary view of one histogram series: count, sum, approx
        p50/p99 (upper bucket bounds)."""

        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        with self._lock:
            h = self._histograms.get(key)
            if h is None:
                return {"count": 0}
            bks, counts, total, n = h[0], list(h[1]), h[2], h[3]
        return self._summarize(bks, counts, total, n)

    @staticmethod
    def _summarize(bks, counts, total, n) -> Dict[str, float]:
        def quantile(q: float) -> float:
            target = q * n
            acc = 0
            for i, c in enumerate(counts):
                acc += c
                if acc >= target:
                    return bks[i] if i < len(bks) else float("inf")
            return float("inf")

        return {
            "count": n,
            "sum": total,
            "mean": total / n if n else 0.0,
            "p50_le": quantile(0.5),
            "p99_le": quantile(0.99),
        }

    def histogram_family(self, name: str) -> Dict[Tuple[Tuple[str, str], ...], Dict[str, float]]:
        """Every label set of one histogram family, summarized — the
        /slo endpoint's read (``{(("model","x"),): {count, p50_le, ...}}``)."""

        with self._lock:
            items = [
                (labels, (h[0], list(h[1]), h[2], h[3]))
                for (n, labels), h in self._histograms.items()
                if n == name
            ]
        return {
            labels: self._summarize(bks, counts, total, cnt)
            for labels, (bks, counts, total, cnt) in items
        }

    def histogram_family_merged(
        self, name: str, drop: Tuple[str, ...] = ("replica", "role")
    ) -> Dict[Tuple[Tuple[str, str], ...], Dict[str, float]]:
        """``histogram_family`` with the ``drop`` label keys merged
        away: series differing only in those labels sum their bucket
        counts before summarization.  This is the /slo read under
        multi-replica serving: N per-replica
        ``serve_ttft_seconds{replica=...}`` series become ONE
        user-facing quantile summary instead of N disjoint ones.
        ``role`` rides in the default drop set: a
        disaggregated prefill/decode fleet splits its SLO series by
        phase role on /metrics, but the user still sees ONE p99 TTFT.
        Bucket-boundary mismatches (same family observed with
        different explicit buckets) keep those series separate — a
        positional sum would be a lie."""

        merged: Dict[Tuple[Tuple[str, str], ...], list] = {}
        with self._lock:
            items = [
                (labels, (h[0], list(h[1]), h[2], h[3]))
                for (n, labels), h in self._histograms.items()
                if n == name
            ]
        for labels, (bks, counts, total, cnt) in sorted(items):
            key = tuple((k, v) for k, v in labels if k not in drop)
            have = merged.get(key)
            if have is not None and have[0] == bks:
                have[1] = [a + b for a, b in zip(have[1], counts)]
                have[2] += total
                have[3] += cnt
            elif have is None:
                merged[key] = [bks, counts, total, cnt]
            else:
                # incompatible buckets: keep the series distinct under
                # its full label set rather than mis-merge
                merged[labels] = [bks, counts, total, cnt]
        return {
            labels: self._summarize(bks, counts, total, cnt)
            for labels, (bks, counts, total, cnt) in merged.items()
        }

    def counter(self, name: str, **labels: str) -> float:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            return self._counters.get(key, 0.0)

    def counter_series(self, name: str) -> Dict[Tuple[Tuple[str, str], ...], float]:
        """Every label set of one counter family with its value — the
        alert engine's windowed-increase read (utils/alerts.py)."""

        with self._lock:
            return {
                labels: v
                for (n, labels), v in self._counters.items()
                if n == name
            }

    def gauge_series(self, name: str) -> Dict[Tuple[Tuple[str, str], ...], float]:
        """Every label set of one gauge family with its value."""

        with self._lock:
            return {
                labels: v
                for (n, labels), v in self._gauges.items()
                if n == name
            }

    def histogram_raw(
        self, name: str
    ) -> Dict[Tuple[Tuple[str, str], ...], Tuple[Tuple[float, ...], List[int], float, int]]:
        """Raw (buckets, counts, sum, count) per label set of one
        histogram family — the burn-rate evaluator needs cumulative
        bucket counts, not the summarized quantiles."""

        with self._lock:
            return {
                labels: (h[0], list(h[1]), h[2], h[3])
                for (n, labels), h in self._histograms.items()
                if n == name
            }

    def total(self, name: str) -> float:
        """Sum of one counter across all of its label sets (e.g. every
        client's api_client_retries_total)."""

        with self._lock:
            return sum(
                v for (n, _), v in self._counters.items() if n == name
            )

    def summary(self, name: str) -> Dict[str, float]:
        with self._lock:
            vals = sorted(self._observations.get(name, []))
        if not vals:
            return {"count": 0}
        return {
            "count": len(vals),
            "min": vals[0],
            "max": vals[-1],
            "mean": sum(vals) / len(vals),
            "p50": vals[len(vals) // 2],
            "p99": vals[min(len(vals) - 1, int(len(vals) * 0.99))],
        }

    def _header(self, lines: List[str], emitted: set, name: str, kind: str) -> None:
        """# HELP + # TYPE once per family, immediately before its
        first sample (Prometheus requires family samples contiguous
        after their metadata; each section is name-sorted so they are).
        Newlines/backslashes in help text are escaped per the text
        format, keeping the exposition line-parseable."""

        if name in emitted:
            return
        emitted.add(name)
        help_text = self._help.get(name, f"{name} ({kind})")
        help_text = help_text.replace("\\", "\\\\").replace("\n", "\\n")
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {kind}")

    def exposition(self, families: "Optional[set]" = None) -> str:
        """Prometheus text format (label values escaped per the text
        exposition rules — see ``_escape_label``).  Every family is
        preceded by its ``# HELP`` / ``# TYPE`` metadata lines.
        ``families`` restricts the output to that name set (the
        /federate read) — ONE renderer serves both surfaces, so the
        formats can never drift."""

        def want(name: str) -> bool:
            return families is None or name in families

        lines = []
        emitted: set = set()
        with self._lock:
            for (name, labels), v in sorted(self._counters.items()):
                if not want(name):
                    continue
                self._header(lines, emitted, name, "counter")
                label_s = _label_str(labels)
                lines.append(f"{name}{{{label_s}}} {v}" if label_s else f"{name} {v}")
            for (name, labels), v in sorted(self._gauges.items()):
                if not want(name):
                    continue
                self._header(lines, emitted, name, "gauge")
                label_s = _label_str(labels)
                lines.append(f"{name}{{{label_s}}} {v}" if label_s else f"{name} {v}")
            for name, vals in sorted(self._observations.items()):
                if not want(name):
                    continue
                self._header(lines, emitted, name, "summary")
                lines.append(f"{name}_count {len(vals)}")
                lines.append(f"{name}_sum {sum(vals)}")
            for (name, labels), (bks, counts, total, n) in sorted(
                self._histograms.items()
            ):
                if not want(name):
                    continue
                self._header(lines, emitted, name, "histogram")
                label_s = _label_str(labels)
                suffix = f",{label_s}" if label_s else ""
                acc = 0
                for i, b in enumerate(bks):
                    acc += counts[i]
                    lines.append(f'{name}_bucket{{le="{b}"{suffix}}} {acc}')
                lines.append(f'{name}_bucket{{le="+Inf"{suffix}}} {n}')
                lines.append(
                    f"{name}_sum{{{label_s}}} {total}"
                    if label_s
                    else f"{name}_sum {total}"
                )
                lines.append(
                    f"{name}_count{{{label_s}}} {n}"
                    if label_s
                    else f"{name}_count {n}"
                )
            # exemplar links as comments: Prometheus text parsers skip
            # them, the dashboard reads them to deep-link error
            # counters to their trace waterfalls
            for name, tid in sorted(self._exemplars.items()):
                if not want(name):
                    continue
                lines.append(f'# exemplar {name} trace_id="{tid}"')
        return "\n".join(lines) + "\n"

    def counters_snapshot(self) -> Dict[str, float]:
        """Flat {\"name{labels}\": value} copy of every counter and
        gauge — the flight recorder diffs successive snapshots into
        metric-delta records."""

        out: Dict[str, float] = {}
        with self._lock:
            for (name, labels), v in self._counters.items():
                label_s = _label_str(labels)
                out[f"{name}{{{label_s}}}" if label_s else name] = v
            for (name, labels), v in self._gauges.items():
                label_s = _label_str(labels)
                out[f"{name}{{{label_s}}}" if label_s else name] = v
        return out


class DispatchLedger:
    """Device-dispatch accounting for the serving hot path.

    Every serving decoder wraps each group of device calls in
    ``dispatch(phase)``, which counts it and measures the host wall of
    the enqueue + any in-block host fetch (module docstring: what that
    covers on CUDA).  Dispatch COUNTS are platform-independent (the
    same call structure runs everywhere); the measured seconds are the
    host's share plus whatever device time an in-block fetch waits for.

    Phases are strings from the CLOSED ``DISPATCH_PHASES`` taxonomy
    (above — the single source of truth, one line of intent per
    phase): each lowers to a ``dispatch.<phase>`` span that the
    request-autopsy/waterfall layers key on.

    Optional sinks, both None-safe:
      - ``metrics``: every dispatch increments
        ``serving_dispatch_total{phase=...}`` and observes the labeled
        ``serving_dispatch_seconds{phase=...}`` histogram family, so
        ``/metrics`` exports the ledger live;
      - ``tracer``: when the calling thread is inside a trace (e.g. a
        serve_lm request span), each dispatch records a child span
        ``dispatch.<phase>`` — the per-request waterfall shows where
        the round trips went.  Pool dispatches run on the decode-loop
        thread, outside any request context; they carry their request
        id as a span attribute instead.
    """

    def __init__(
        self,
        metrics: "Metrics | None" = None,
        tracer=None,
        prefix: str = "serving_dispatch",
        span_prefix: str = "dispatch",
    ):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = defaultdict(int)
        self._seconds: Dict[str, float] = defaultdict(float)
        self.metrics = metrics
        self.tracer = tracer
        self.prefix = prefix
        self.span_prefix = span_prefix

    def record(self, phase: str, seconds: float, n: int = 1) -> None:
        with self._lock:
            self._counts[phase] += n
            self._seconds[phase] += seconds
        if self.metrics is not None:
            self.metrics.inc(f"{self.prefix}_total", float(n), phase=phase)
            # ONE labeled family per ledger (``serving_dispatch_seconds
            # {phase="step"}`` / ``train_sync_seconds{phase="window"}``)
            # — training and serving share the exposition shape the
            # SLO panel reads, instead of a name-mangled family per
            # phase
            self.metrics.observe_histogram(
                f"{self.prefix}_seconds", seconds, phase=phase
            )

    @contextlib.contextmanager
    def dispatch(self, phase: str, **attrs: Any):
        """``with ledger.dispatch("step"): fn(...)`` — count one device
        dispatch and time the block (include the host fetch of any
        value you need, so the measured seconds cover the full round
        trip, not just the async enqueue)."""

        span = None
        if self.tracer is not None:
            span = self.tracer.start_span(
                f"{self.span_prefix}.{phase}", kind="client",
                attributes=attrs or None,
            )
            span.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        except BaseException as exc:
            # a failed device call must show as a FAILED span — error
            # status is what tail sampling protects; closing it ok
            # would get the one trace worth keeping evicted
            if span is not None:
                span.__exit__(type(exc), exc, exc.__traceback__)
                span = None
            raise
        finally:
            dt = time.perf_counter() - t0
            if span is not None:
                span.__exit__(None, None, None)
            self.record(phase, dt)

    # -- reads -------------------------------------------------------------

    def count(self, phase: Optional[str] = None) -> int:
        with self._lock:
            if phase is not None:
                return self._counts.get(phase, 0)
            return sum(self._counts.values())

    def seconds(self, phase: Optional[str] = None) -> float:
        with self._lock:
            if phase is not None:
                return self._seconds.get(phase, 0.0)
            return sum(self._seconds.values())

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """{phase: {count, seconds, mean_ms}} — the machine-readable
        ledger benchmarks embed in their JSON output."""

        with self._lock:
            return {
                phase: {
                    "count": n,
                    "seconds": round(self._seconds[phase], 4),
                    "mean_ms": round(self._seconds[phase] / n * 1e3, 2),
                }
                for phase, n in sorted(self._counts.items())
                if n
            }

    def table(self, wall: Optional[float] = None) -> str:
        """Markdown ledger table: phase | dispatches | mean RTT | total.
        With ``wall``, appends the accounting row — dispatch seconds vs
        wall, i.e. how much of the wall the round trips explain."""

        lines = [
            "| phase | dispatches | mean ms/dispatch | total s |",
            "|---|---|---|---|",
        ]
        # subclasses may add "_"-prefixed meta rows (e.g. the sync
        # ledger's _steps summary) that are not dispatch phases
        snap = {
            k: v for k, v in self.snapshot().items() if not k.startswith("_")
        }
        for phase, row in snap.items():
            lines.append(
                f"| {phase} | {row['count']} | {row['mean_ms']} "
                f"| {row['seconds']} |"
            )
        total_n = sum(r["count"] for r in snap.values())
        total_s = sum(r["seconds"] for r in snap.values())
        tail = f"| **all** | {total_n} | — | {round(total_s, 4)} |"
        if wall is not None and wall > 0:
            tail = (
                f"| **all** | {total_n} | — | {round(total_s, 4)} "
                f"(= {total_s / wall:.0%} of {round(wall, 3)} s wall) |"
            )
        lines.append(tail)
        return "\n".join(lines)

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self._seconds.clear()


def _tensor_leaves(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensor_leaves(x)]
    return []


def _to_host(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


class StepSyncLedger(DispatchLedger):
    """Blocking host↔device sync accounting for the TRAINING hot path —
    the training-side generalization of the serving DispatchLedger.

    Serving's disease was dispatch count × RTT; training's is the dual:
    a single ``float(metrics["loss"])`` per step serializes host
    dispatch against device compute, so the step loop runs at one RTT
    per step regardless of model FLOPs.  This ledger turns "the step
    loop never waits on the device" into an auditable number: every
    value that crosses device→host in the training loop must go through
    :meth:`resolve`, which counts it, times it, and records whether the
    host actually had to WAIT (the arrays were not yet ready — a true
    blocking sync) or merely fetched finished results.

    Phase convention:
      ``step``    — a per-step resolve (the K=1 legacy/debug path; any
                    count here during steady state is the bug this
                    ledger exists to catch);
      ``window``  — the deferred every-K-steps resolve of the PREVIOUS
                    metrics window (steady state: the only fetches);
      ``final``   — the end-of-run resolve of the last window;
      ``summary`` — interval summary-writer scalar conversions;
      ``checkpoint`` — waits attributable to checkpoint save budgets.

    The steady-state invariant tests pin (the training twin of "1
    dispatch per request"): **count("step") == 0** for every
    steps_per_sync > 1 run — zero blocking syncs per steady-state step.

    Sinks mirror DispatchLedger: counters ``train_sync_total{phase=}``
    (+ ``train_sync_blocked_total`` when the host provably waited),
    the labeled ``train_sync_seconds{phase=}`` histogram family, and
    ``sync.<phase>`` trace spans.
    """

    def __init__(
        self,
        metrics: "Metrics | None" = None,
        tracer=None,
        prefix: str = "train_sync",
    ):
        super().__init__(
            metrics=metrics, tracer=tracer, prefix=prefix, span_prefix="sync"
        )
        self._blocked: Dict[str, int] = defaultdict(int)
        self._steps = 0

    def step(self, n: int = 1) -> None:
        """Mark ``n`` training steps dispatched (host-side counter — a
        device read here would be the very sync this ledger forbids)."""

        with self._lock:
            self._steps += n

    @property
    def steps(self) -> int:
        with self._lock:
            return self._steps

    def resolve(self, phase: str, tree):
        """THE sanctioned device→host fetch: returns host (numpy)
        values for ``tree``'s tensor leaves (nested dicts, lists and
        tuples keep their shape; other leaves pass through).  Counted
        under ``phase``; if the current CUDA stream still had work
        queued when the fetch started, the resolve is additionally
        counted as BLOCKED (the host waited on the device, not just on
        the copy)."""

        import torch

        ready = not (
            torch.cuda.is_available()
            and any(t.is_cuda for t in _tensor_leaves(tree))
            and not torch.cuda.current_stream().query()
        )
        with self.dispatch(phase, blocked=not ready):
            out = _to_host(tree)
        if not ready:
            with self._lock:
                self._blocked[phase] += 1
            if self.metrics is not None:
                self.metrics.inc(
                    f"{self.prefix}_blocked_total", 1.0, phase=phase
                )
        return out

    def blocked(self, phase: Optional[str] = None) -> int:
        """Resolves where the host provably WAITED on device compute
        (leaves not ready at fetch start).  Indicative, not pinned: on
        fast hosts a window's arrays often finish before the deferred
        resolve arrives, so blocked <= count by design."""

        with self._lock:
            if phase is not None:
                return self._blocked.get(phase, 0)
            return sum(self._blocked.values())

    def per_step(self, phase: Optional[str] = None) -> float:
        """Syncs per dispatched training step (count/steps; 0 when no
        steps were marked)."""

        n = self.count(phase)
        with self._lock:
            return n / self._steps if self._steps else 0.0

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """DispatchLedger's {phase: {count, seconds, mean_ms}} plus
        per-phase ``blocked`` and a ``_steps`` summary row — the shape
        a benchmark embeds in its output."""

        snap = super().snapshot()
        with self._lock:
            for phase, row in snap.items():
                row["blocked"] = self._blocked.get(phase, 0)
            steps = self._steps
        total = sum(r["count"] for r in snap.values())
        snap["_steps"] = {
            "count": steps,
            "syncs_per_step": round(total / steps, 4) if steps else 0.0,
        }
        return snap

    def reset(self) -> None:
        super().reset()
        with self._lock:
            self._blocked.clear()
            self._steps = 0


#: process-global default registry (controller accepts an override)
default_metrics = Metrics()
