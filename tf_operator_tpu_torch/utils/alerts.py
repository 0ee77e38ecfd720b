"""SLO alert engine (a copy of ``tf_operator_tpu/utils/alerts.py``):
the layer that CONSUMES the metrics the serving plane emits.

Labeled counter/gauge/histogram families, serving SLO histograms and a
flight recorder are an instrument panel, but without an evaluator an
operator has to eyeball /metrics to know a server is unhealthy.  This module closes the observe→act gap with a
declarative rule set evaluated on the shared registry:

- :class:`BurnRateRule` — Google-SRE multi-window multi-burn-rate over
  a labeled histogram family: "p99 of serve_request_seconds{route=} must
  stay under T" becomes an error budget (the fraction of requests
  allowed over T), and the rule fires only when the budget is burning
  faster than ``burn_threshold`` over BOTH a short and a long window —
  the short window for detection latency, the long one so a single
  latency blip cannot page.
- :class:`ThresholdRule` — plain predicates over counters and gauges:
  counter increase over a window (watchdog stalls, circuit-breaker
  opens), gauge level (admission queue depth), and gauge AGE for
  staleness signals (seconds since ``checkpoint_last_success_unix``).

Each rule runs an alert lifecycle state machine::

    inactive -> pending -> firing -> resolved -> inactive
                   \\________/          (breach cleared)
                (breach must hold for ``for_seconds``)

evaluated by :meth:`AlertEngine.evaluate_once` — pure enough for tests
to drive with synthetic clocks — or by a background evaluator thread
(:meth:`AlertEngine.start`, the watchdog pattern).  Everything here is
HOST-side arithmetic over registry snapshots; nothing touches the
device, so the training/serving no-hot-sync invariants are unaffected.

On the pending→firing transition the engine:

- increments ``alerts_fired_total{rule=}`` and sets
  ``alert_state{rule=}`` to 2 (0 inactive, 1 pending, 2 firing),
- warn-logs the breach with its measured value,
- dumps the flight recorder ONCE per episode (the same
  once-per-episode contract as the watchdog) so the black box captures
  the window *around* the violation,
- invokes every :meth:`AlertEngine.subscribe` callback — the
  controller uses this to re-enqueue jobs so the ``Degraded``
  condition lands in ``TPUJob.status`` promptly.

Cumulative-to-windowed: Prometheus-style families are monotonic
cumulative series, so windowed rates come from a bounded per-rule
history of (timestamp, cumulative-value) samples recorded at each
evaluation tick; the increase over a window is the difference against
the newest sample at least ``window`` old.  A window with less than
``MIN_COVERAGE`` of its span observed never breaches — you cannot
claim a one-hour burn from thirty seconds of data, and a cold start
must not page.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from tf_operator_tpu_torch.utils.logging import FieldLogger, _root

#: alert lifecycle states, in order of escalation
STATES = ("inactive", "pending", "firing", "resolved")

#: numeric alert_state{rule=} gauge values
_STATE_VALUE = {"inactive": 0.0, "pending": 1.0, "firing": 2.0, "resolved": 0.0}

#: a window never breaches until this fraction of its span is covered
#: by recorded history (cold-start false-positive guard)
MIN_COVERAGE = 0.5

#: ThresholdRule kinds
THRESHOLD_KINDS = ("counter_increase", "gauge", "gauge_age")


@dataclass
class BurnRateRule:
    """Multi-window burn-rate rule over one labeled histogram family.

    The SLO: at least ``objective_ratio`` of observations must be
    <= ``objective_le`` seconds (``objective_le`` should be a bucket
    bound of the family — the straddling bucket is otherwise counted
    as bad, i.e. conservatively).  The error budget is
    ``1 - objective_ratio``; the burn rate over a window is
    (bad fraction in window) / budget, and the rule breaches when the
    burn exceeds ``burn_threshold`` on BOTH windows.
    """

    name: str
    family: str
    objective_le: float
    objective_ratio: float = 0.99
    #: label filter: a series participates when these items are a
    #: subset of its labels; {} aggregates every series of the family
    labels: Dict[str, str] = field(default_factory=dict)
    #: (short, long) window seconds, strictly increasing
    windows: Tuple[float, float] = (300.0, 3600.0)
    burn_threshold: float = 6.0
    for_seconds: float = 0.0
    severity: str = "page"

    @property
    def kind(self) -> str:
        return "burn_rate"

    @property
    def metric(self) -> str:  # the lint gate's uniform accessor
        return self.family


@dataclass
class ThresholdRule:
    """Predicate over a counter or gauge family.

    Kinds:
      ``counter_increase`` — sum of matching series' increase over
        ``window`` seconds > ``threshold``;
      ``gauge``     — worst (max) matching gauge level > ``threshold``;
      ``gauge_age`` — ``now - value`` of the OLDEST matching gauge
        > ``threshold`` where the gauge holds a unix timestamp
        (e.g. ``checkpoint_last_success_unix``); an unset/zero gauge
        never breaches — "no checkpoint configured" is not "stale".

    ``window`` applies to ``counter_increase`` ONLY; gauge kinds
    evaluate the instantaneous registry snapshot (a gauge/age already
    IS a level, not a rate) — use ``for_seconds`` for dwell.
    """

    name: str
    metric: str
    kind: str = "counter_increase"
    labels: Dict[str, str] = field(default_factory=dict)
    threshold: float = 0.0
    window: float = 600.0
    for_seconds: float = 0.0
    severity: str = "ticket"


def validate_rule(rule) -> None:
    """Raise ValueError on a malformed rule — called by the engine at
    construction (and by the JAX package's rule lint on its copy of
    the default set), so a bad rule fails the process at boot, not silently at the
    first evaluation."""

    if not getattr(rule, "name", ""):
        raise ValueError("rule has no name")
    pre = f"rule {rule.name!r}: "
    if not rule.metric:
        raise ValueError(pre + "empty metric/family")
    if not isinstance(rule.labels, dict):
        raise ValueError(pre + "labels must be a dict")
    if rule.for_seconds < 0 or not math.isfinite(rule.for_seconds):
        raise ValueError(pre + f"bad for_seconds {rule.for_seconds!r}")
    if isinstance(rule, BurnRateRule):
        if not (0.0 < rule.objective_ratio < 1.0):
            raise ValueError(
                pre + f"objective_ratio {rule.objective_ratio!r} not in (0,1)"
            )
        if not (math.isfinite(rule.objective_le) and rule.objective_le > 0):
            raise ValueError(pre + f"bad objective_le {rule.objective_le!r}")
        if len(rule.windows) != 2:
            raise ValueError(pre + "windows must be (short, long)")
        s, l = rule.windows
        if not (0 < s < l) or not math.isfinite(l):
            raise ValueError(
                pre + f"windows must be ordered finite positives, got {rule.windows}"
            )
        if not (math.isfinite(rule.burn_threshold) and rule.burn_threshold > 0):
            raise ValueError(pre + f"bad burn_threshold {rule.burn_threshold!r}")
    elif isinstance(rule, ThresholdRule):
        if rule.kind not in THRESHOLD_KINDS:
            raise ValueError(pre + f"unknown kind {rule.kind!r}")
        if not math.isfinite(rule.threshold):
            raise ValueError(pre + f"bad threshold {rule.threshold!r}")
        if rule.kind == "counter_increase" and not (
            math.isfinite(rule.window) and rule.window > 0
        ):
            raise ValueError(pre + f"bad window {rule.window!r}")
    else:
        raise ValueError(pre + f"unknown rule type {type(rule).__name__}")


def default_rules(
    short: float = 300.0, long: float = 3600.0
) -> List[Any]:
    """The stock rule set over the registry's families.  ``short``/``long``
    parameterize every burn window (and the counter windows) so tests
    and sims can shrink the whole set coherently.

    The rule names and families are the JAX package's
    (tests/test_torch_serving_plane.py holds them equal), so a rule
    can never silently orphan.
    """

    return [
        # -- user-facing serving SLOs (serve_lm + batching pool) -------
        BurnRateRule(
            "serve-request-latency-burn",
            family="serve_request_seconds",
            objective_le=10.0, objective_ratio=0.99,
            labels={"route": "/generate"},
            windows=(short, long), burn_threshold=6.0,
            severity="page",
        ),
        BurnRateRule(
            "serve-queue-wait-burn",
            family="serve_queue_wait_seconds",
            objective_le=2.5, objective_ratio=0.95,
            windows=(short, long), burn_threshold=6.0,
            severity="page",
        ),
        BurnRateRule(
            "serve-ttft-burn",
            family="serve_ttft_seconds",
            objective_le=5.0, objective_ratio=0.95,
            windows=(short, long), burn_threshold=6.0,
            severity="page",
        ),
        # -- control-plane SLO (operator job API) ----------------------
        BurnRateRule(
            "api-request-latency-burn",
            family="api_request_seconds",
            objective_le=1.0, objective_ratio=0.99,
            windows=(short, long), burn_threshold=6.0,
            severity="ticket",
        ),
        # -- threshold rules over health counters and gauges ----------
        ThresholdRule(
            "watchdog-stall",
            metric="watchdog_stall_total",
            kind="counter_increase", threshold=0.0, window=long,
            severity="page",
        ),
        ThresholdRule(
            "api-client-circuit-open",
            metric="api_client_circuit_open_total",
            kind="counter_increase", threshold=0.0, window=short,
            severity="ticket",
        ),
        ThresholdRule(
            "admission-queue-depth",
            metric="serve_admission_queue_depth",
            kind="gauge", threshold=64.0,
            severity="ticket",
        ),
        ThresholdRule(
            # paged-serving memory headroom: the arena is nearly
            # exhausted — admission is about to gate on blocks free.
            # The gauge is (in-use + queued demand)/usable refreshed per decode window, so a burst
            # ramps through 0.9 instead of step-functioning past it.
            # Worst replica drives it (gauge kind takes the max
            # matching level); the stock serving autoscaling policy
            # binds the same family so the alert and the scale-up act
            # on one number
            "kv-blocks-pressure",
            metric="kv_blocks_pressure",
            kind="gauge", threshold=0.9,
            severity="ticket",
        ),
        ThresholdRule(
            # sustained mid-decode preemption: the paged
            # pool's budget-on-demand oversubscription is losing its
            # gamble often enough that seats are thrashing through the
            # host swap arena — interactive TTFT is about to burn.
            # The stock serving autoscaling policy binds this rule so
            # sustained swapping scales replicas OUT before the SLO
            # pages; a handful of preemptions per window is the
            # mechanism working as designed and stays quiet.
            "serve-preemption-rate",
            metric="serve_preemptions_total",
            kind="counter_increase", threshold=8.0, window=short,
            severity="ticket",
        ),
        ThresholdRule(
            # cross-pod fabric peer health: a remote prefix
            # pull died at the socket (connect refused / mid-body
            # reset).  The pull path already fell back to recompute —
            # requests still succeed — so this tickets rather than
            # pages, but a peer that stays dead means every shared
            # prefix is being recomputed and the fleet hit rate is
            # quietly zero.  Scoped to reason="peer_dead": index 404s
            # (stale catalog) and corrupt payloads are normal churn the
            # content hash absorbs.
            "fabric-peer-unreachable",
            metric="kv_fabric_pull_failures_total",
            kind="counter_increase", threshold=0.0, window=short,
            labels={"reason": "peer_dead"},
            severity="ticket",
        ),
        ThresholdRule(
            "checkpoint-stale",
            metric="checkpoint_last_success_unix",
            kind="gauge_age", threshold=1800.0,
            severity="ticket",
        ),
        ThresholdRule(
            # fleet-queue starvation: some gang has been
            # parked in the scheduler queue longer than the threshold.
            # The gauge holds the STABLE queued-since stamp per queued
            # job (controller/scheduler.py clears it on admit), so
            # gauge_age measures the oldest wait directly; an empty
            # queue never breaches.  This is the observe half whose act
            # half is the scheduler's own age-boost — if this fires,
            # the boost isn't winning against the high-priority churn
            # and a human (or the autoscaler shrinking someone) has to
            # make room.
            "gang-queue-stall",
            metric="scheduler_queued_since_unix",
            kind="gauge_age", threshold=900.0,
            severity="ticket",
        ),
        ThresholdRule(
            # device cost plane: the compile ledger is
            # registering compiles faster than any healthy steady
            # state explains — a width-class/K-class thrash is
            # recompiling the fleet and every cache miss stalls its
            # serving window for the full trace+compile wall.  The
            # threshold clears a normal pool boot (admission widths +
            # step + retire ≈ a handful) so only a SUSTAINED storm
            # inside the short window fires; the autoscaler refuses
            # to scale while this fires (scaling a recompiling fleet
            # just multiplies the recompiles).
            "compile-storm",
            metric="compile_total",
            kind="counter_increase", threshold=8.0, window=short,
            severity="page",
        ),
        ThresholdRule(
            # device cost plane: the step-time sentinel's
            # drift ratio — rolling p50 of the decode.window /
            # train_sync wall over the warmup-frozen reference p50.
            # 1.5 means the median window is 50% slower than the
            # baseline this process established at startup: a real
            # regression (new code path, chip contention, silent
            # de-fusion), not tail jitter — the p50, unlike the p99,
            # does not false-positive on a noisy CI box (the clean
            # soak pins that).  Gauge kind takes the worst signal.
            "step-time-regression",
            metric="step_time_drift_ratio",
            kind="gauge", threshold=1.5,
            severity="ticket",
        ),
    ]


class Alert:
    """Runtime state of one rule: the lifecycle machine plus the last
    measured value — what /alerts serializes."""

    __slots__ = (
        "rule", "state", "since", "pending_since", "firing_since",
        "episodes", "value", "message",
    )

    def __init__(self, rule):
        self.rule = rule
        self.state = "inactive"
        self.since = 0.0
        self.pending_since: Optional[float] = None
        self.firing_since: Optional[float] = None
        self.episodes = 0
        self.value: Dict[str, float] = {}
        self.message = ""

    def to_dict(self) -> Dict[str, Any]:
        r = self.rule
        out: Dict[str, Any] = {
            "name": r.name,
            "kind": r.kind,
            "metric": r.metric,
            "labels": dict(r.labels),
            "severity": r.severity,
            "state": self.state,
            "since": self.since,
            "episodes": self.episodes,
            "value": dict(self.value),
            "message": self.message,
        }
        if isinstance(r, BurnRateRule):
            out["objectiveLe"] = r.objective_le
            out["objectiveRatio"] = r.objective_ratio
            out["windows"] = list(r.windows)
            out["burnThreshold"] = r.burn_threshold
        else:
            out["threshold"] = r.threshold
            if r.kind == "counter_increase":  # see ThresholdRule: gauge
                out["window"] = r.window      # kinds have no window
        return out


class AlertEngine:
    """Evaluate a rule set against a metrics registry.

    ``evaluate_once(now)`` is the whole engine (tests drive it with a
    synthetic clock); ``start()`` runs it on a daemon thread every
    ``interval`` seconds.  ``now`` is a unix timestamp — gauge_age
    rules compare it against wall-clock gauges, so synthetic clocks
    must be unix-shaped.
    """

    def __init__(
        self,
        rules: Optional[List[Any]] = None,
        metrics=None,
        recorder=None,
        interval: float = 5.0,
        resolved_hold: float = 300.0,
    ):
        rules = list(rules) if rules is not None else default_rules()
        seen = set()
        for r in rules:
            validate_rule(r)
            if r.name in seen:
                raise ValueError(f"duplicate rule name {r.name!r}")
            seen.add(r.name)
        if metrics is None:
            from tf_operator_tpu_torch.utils.metrics import default_metrics

            metrics = default_metrics
        self.metrics = metrics
        self._recorder = recorder
        self.interval = float(interval)
        self.resolved_hold = float(resolved_hold)
        self._lock = threading.Lock()
        self._alerts: Dict[str, Alert] = {r.name: Alert(r) for r in rules}
        #: rule name -> deque[(unix, cumulative sample)] — burn rules
        #: sample (bad_cum, total_cum); counter rules sample the summed
        #: counter.  Bounded by pruning past the rule's longest window.
        self._history: Dict[str, deque] = {r.name: deque() for r in rules}
        self._callbacks: List[Callable[[Alert, str, str], None]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._log = FieldLogger(_root, component="alerts")
        #: flight-recorder dump paths, newest last (tests read it)
        self.dumps: List[str] = []

    # -- reads --------------------------------------------------------------

    def alerts(self) -> List[Alert]:
        with self._lock:
            return list(self._alerts.values())

    def firing(self) -> List[Alert]:
        with self._lock:
            return [a for a in self._alerts.values() if a.state == "firing"]

    def alert(self, name: str) -> Optional[Alert]:
        """The live Alert for one rule name (None = not registered) —
        the autoscaler's signal-binding read."""

        with self._lock:
            return self._alerts.get(name)

    def snapshot(self) -> Dict[str, Any]:
        """The /alerts JSON body: every alert, firing first."""

        items = sorted(
            (a.to_dict() for a in self.alerts()),
            key=lambda d: (-_STATE_VALUE[d["state"]], d["name"]),
        )
        return {
            "alerts": items,
            "firing": sorted(
                d["name"] for d in items if d["state"] == "firing"
            ),
        }

    def subscribe(self, fn: Callable[[Alert, str, str], None]) -> None:
        """``fn(alert, old_state, new_state)`` on every transition.
        Called from the evaluator thread — keep it cheap and non-raising
        (exceptions are logged and swallowed; the engine must outlive
        its consumers)."""

        with self._lock:
            self._callbacks.append(fn)

    def unsubscribe(self, fn: Callable[[Alert, str, str], None]) -> None:
        """Detach a subscribe()d callback (no-op if absent).  Consumers
        sharing a long-lived engine (the process-global
        ``default_engine``) MUST detach on shutdown or the engine pins
        them alive and keeps invoking them forever."""

        with self._lock:
            try:
                self._callbacks.remove(fn)
            except ValueError:
                pass

    # -- evaluation ---------------------------------------------------------

    def evaluate_once(self, now: Optional[float] = None) -> List[str]:
        """One sweep: measure every rule, run the state machines.
        Returns the names that transitioned this sweep."""

        now = time.time() if now is None else float(now)
        transitioned: List[str] = []
        with self._lock:
            alerts = list(self._alerts.values())
        self.metrics.inc("alert_evaluations_total")
        for alert in alerts:
            try:
                breach, value, msg = self._measure(alert.rule, now)
            except Exception as e:  # noqa: BLE001 - engine outlives rule bugs
                self._log.error(
                    "alert rule %s evaluation failed: %s: %s",
                    alert.rule.name, type(e).__name__, e,
                )
                continue
            alert.value = value
            if self._step_state(alert, breach, msg, now):
                transitioned.append(alert.rule.name)
            # written every sweep, not just on transitions: the series
            # existing at all is the scrape-level signal "the engine is
            # evaluating this rule" — absent() checks must be able to
            # tell a quiet engine from one that never started
            self.metrics.set(
                "alert_state", _STATE_VALUE[alert.state], rule=alert.rule.name
            )
        return transitioned

    def _step_state(self, alert: Alert, breach: bool, msg: str, now: float) -> bool:
        old = alert.state
        rule = alert.rule
        if breach:
            alert.message = msg
            if old == "resolved":
                # flap absorption: a breach returning inside
                # resolved_hold re-enters firing as the SAME episode —
                # no dwell, but also no new dump / Warning-path
                # episode / alerts_fired_total increment.  Without
                # this, a signal oscillating around its threshold with
                # for_seconds=0 would mint an episode (and a full
                # recorder disk dump) every other evaluation tick.
                alert.state = "firing"
                alert.since = now
                self._log.warning(
                    "alert %s re-entered firing (same episode)", rule.name
                )
            else:
                if old == "inactive":
                    alert.state = "pending"
                    alert.pending_since = now
                    alert.since = now
                if alert.state == "pending" and (
                    now - (alert.pending_since or now) >= rule.for_seconds
                ):
                    alert.state = "firing"
                    alert.firing_since = now
                    alert.since = now
                    alert.episodes += 1
                    self._on_firing(alert, msg)
        else:
            if old == "pending":
                alert.state = "inactive"
                alert.since = now
                alert.pending_since = None
                # /alerts must not keep serving a breach message on a
                # rule that went back to inactive
                alert.message = ""
            elif old == "firing":
                alert.state = "resolved"
                alert.since = now
                alert.message = ""
                self._log.info(
                    "alert %s resolved after %.1fs",
                    rule.name, now - (alert.firing_since or now),
                )
                self.metrics.inc("alerts_resolved_total", rule=rule.name)
            elif (
                old == "resolved"
                and now - alert.since >= self.resolved_hold
            ):
                alert.state = "inactive"
                alert.since = now
        changed = alert.state != old
        if changed:
            with self._lock:  # snapshot: subscribe/unsubscribe race
                callbacks = list(self._callbacks)
            for fn in callbacks:
                try:
                    fn(alert, old, alert.state)
                except Exception as e:  # noqa: BLE001 - see subscribe()
                    self._log.error(
                        "alert callback failed for %s: %s: %s",
                        rule.name, type(e).__name__, e,
                    )
        return changed

    def _on_firing(self, alert: Alert, msg: str) -> None:
        rule = alert.rule
        self.metrics.inc("alerts_fired_total", rule=rule.name)
        self._log.warning(
            "ALERT FIRING: %s (%s, severity=%s) — %s",
            rule.name, rule.kind, rule.severity, msg,
        )
        recorder = self._recorder
        if recorder is None:
            from tf_operator_tpu_torch.utils.flight import default_recorder

            recorder = default_recorder
        # once-per-episode black-box dump (the watchdog contract): the
        # rings captured here hold the window AROUND the violation
        recorder.snapshot_metrics(label=f"alert:{rule.name}")
        recorder.record_log(
            "WARNING", "alerts", f"alert {rule.name} firing: {msg}",
            fields={"rule": rule.name, "value": dict(alert.value)},
        )
        path = recorder.dump(reason=f"alert-{rule.name.replace('/', '_')}")
        if path:
            self.dumps.append(path)
            # bounded path list: a long-lived engine must not be a
            # memory-growth vector (file creation itself is already
            # rate-limited to one per genuine episode — see the
            # resolved-state flap absorption in _step_state)
            del self.dumps[:-64]
            self._log.warning("flight recorder dumped to %s", path)

    # -- measurement --------------------------------------------------------

    def _measure(self, rule, now: float):
        """(breach, value-dict, message) for one rule at ``now``."""

        if isinstance(rule, BurnRateRule):
            return self._measure_burn(rule, now)
        if rule.kind == "counter_increase":
            total = self._sum_series(
                self.metrics.counter_series(rule.metric), rule.labels
            )
            self._push(rule.name, now, total, rule.window)
            inc, elapsed = self._increase(rule.name, now, rule.window)
            # no MIN_COVERAGE here: an event-counter increase between
            # any two samples inside the window is real regardless of
            # how much of the window history covers — stall/circuit
            # counters move rarely and a coverage gate would hide the
            # first episode after boot
            breach = elapsed > 0 and inc > rule.threshold
            return (
                breach,
                {"increase": inc},
                f"{rule.metric} increased {inc:g} in {elapsed:.0f}s "
                f"(> {rule.threshold:g})",
            )
        if rule.kind == "gauge":
            series = self._match(
                self.metrics.gauge_series(rule.metric), rule.labels
            )
            level = max((v for _, v in series), default=0.0)
            return (
                level > rule.threshold,
                {"level": level},
                f"{rule.metric} at {level:g} (> {rule.threshold:g})",
            )
        # gauge_age: stalest matching timestamp gauge
        series = [
            (lbl, v)
            for lbl, v in self._match(
                self.metrics.gauge_series(rule.metric), rule.labels
            )
            if v > 0
        ]
        if not series:
            return False, {"age": 0.0}, ""
        age = max(now - v for _, v in series)
        return (
            age > rule.threshold,
            {"age": age},
            f"{rule.metric} is {age:.0f}s old (> {rule.threshold:g}s)",
        )

    def _measure_burn(self, rule: BurnRateRule, now: float):
        bad, total = self._burn_sample(rule)
        self._push(rule.name, now, (bad, total), rule.windows[1])
        budget = 1.0 - rule.objective_ratio
        burns: List[float] = []
        covered = True
        for w in rule.windows:
            (d_bad, d_total), elapsed = self._increase2(rule.name, now, w)
            if not elapsed or elapsed < w * MIN_COVERAGE:
                covered = False
            frac = (d_bad / d_total) if d_total > 0 else 0.0
            burns.append(frac / budget)
        value = {
            "burnShort": round(burns[0], 3),
            "burnLong": round(burns[1], 3),
        }
        breach = covered and all(b > rule.burn_threshold for b in burns)
        msg = (
            f"{rule.family}{rule.labels or ''} burning error budget at "
            f"{burns[0]:.1f}x/{burns[1]:.1f}x over {rule.windows[0]:g}s/"
            f"{rule.windows[1]:g}s (threshold {rule.burn_threshold:g}x, "
            f"objective p{rule.objective_ratio * 100:g} <= {rule.objective_le:g}s)"
        )
        return breach, value, msg

    def _burn_sample(self, rule: BurnRateRule) -> Tuple[float, float]:
        """Aggregate (bad_cum, total_cum) over the family's matching
        series: bad = observations ABOVE objective_le (the straddling
        bucket counts as bad — conservative)."""

        bad = total = 0.0
        for labels, (bks, counts, _sum, n) in self.metrics.histogram_raw(
            rule.family
        ).items():
            if not self._labels_match(labels, rule.labels):
                continue
            good = 0
            for i, b in enumerate(bks):
                if b <= rule.objective_le:
                    good += counts[i]
                else:
                    break
            bad += n - good
            total += n
        return bad, total

    # -- history helpers ----------------------------------------------------

    def _push(self, name: str, now: float, sample, max_window: float) -> None:
        hist = self._history[name]
        hist.append((now, sample))
        horizon = now - max_window - 2 * max(self.interval, 1.0)
        while hist and hist[0][0] < horizon:
            hist.popleft()

    def _baseline(self, name: str, now: float, window: float):
        """Newest sample at least ``window`` old; else the oldest."""

        hist = self._history[name]
        if len(hist) < 2:
            return None
        target = now - window
        best = None
        for t, v in hist:
            if t <= target:
                best = (t, v)
            else:
                break
        return best if best is not None else hist[0]

    def _increase(self, name: str, now: float, window: float):
        base = self._baseline(name, now, window)
        if base is None:
            return 0.0, 0.0
        t0, v0 = base
        t1, v1 = self._history[name][-1]
        return max(0.0, v1 - v0), t1 - t0

    def _increase2(self, name: str, now: float, window: float):
        base = self._baseline(name, now, window)
        if base is None:
            return (0.0, 0.0), 0.0
        t0, (b0, n0) = base
        t1, (b1, n1) = self._history[name][-1]
        return (max(0.0, b1 - b0), max(0.0, n1 - n0)), t1 - t0

    @staticmethod
    def _labels_match(series_labels: Tuple[Tuple[str, str], ...], want: Dict[str, str]) -> bool:
        d = dict(series_labels)
        return all(d.get(k) == str(v) for k, v in want.items())

    def _match(self, series: Dict, want: Dict[str, str]):
        return [
            (lbl, v) for lbl, v in series.items()
            if self._labels_match(lbl, want)
        ]

    def _sum_series(self, series: Dict, want: Dict[str, str]) -> float:
        return sum(v for _, v in self._match(series, want))

    # -- evaluator thread ---------------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "AlertEngine":
        if self.running:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="alert-evaluator"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.evaluate_once()
            except Exception as e:  # noqa: BLE001 - the engine must outlive bugs
                self._log.error(
                    "alert sweep failed: %s: %s", type(e).__name__, e
                )


#: process-global default (mirrors metrics/tracer/flight/watchdog
#: defaults): the kubesim debug endpoint and any binary that doesn't
#: build its own engine read this instance.  NOT started — evaluation
#: is opt-in (``default_engine.start()`` or the operator/serving boot).
default_engine = AlertEngine()
