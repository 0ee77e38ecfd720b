"""Stall watchdog (a copy of ``tf_operator_tpu/utils/watchdog.py``): a
stalled train loop or serving pool driver must produce a diagnosis, not
silence.

Hot loops register a :class:`Heartbeat` and call ``beat()`` once per
iteration (a host-side ``time.monotonic`` write — nothing here touches
the device).  A started :class:`Watchdog` checks every heartbeat against its deadline on a
background thread; the first missed deadline of a stall episode

  - increments ``watchdog_stall_total{heartbeat=...}``,
  - warn-logs the stall WITH the trace id the heartbeat last carried
    (exemplar linkage: the log names the waterfall that was in flight),
  - dumps every thread's stack plus the flight recorder's rings
    (utils/flight.py) to one JSONL postmortem file, under the flight
    recorder's directory (``$TPUJOB_FLIGHT_DIR``, else the temporary directory).

A later beat ends the episode (and logs recovery), so a slow-but-alive
loop produces one diagnosis per stall, not a log storm.

Registration is always cheap and safe: heartbeats are plain objects;
nothing fires unless a watchdog was started (``start()`` — opt-in, the
serving binary starts one when ``TPUJOB_WATCHDOG=1``).
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Dict, List, Optional

from tf_operator_tpu_torch.utils.logging import FieldLogger, _root
from tf_operator_tpu_torch.utils.trace import current_trace_id


class Heartbeat:
    """One monitored loop.  ``beat()`` per iteration; ``deadline``
    seconds without a beat = stalled."""

    __slots__ = ("name", "deadline", "last", "beats", "trace_id", "stalled")

    def __init__(self, name: str, deadline: float):
        self.name = name
        self.deadline = float(deadline)
        self.last = time.monotonic()
        self.beats = 0
        self.trace_id: Optional[str] = None
        self.stalled = False

    def beat(self) -> None:
        # capture BEFORE stamping the time: the id names the work the
        # loop was doing when it last checked in
        self.trace_id = current_trace_id() or self.trace_id
        self.last = time.monotonic()
        self.beats += 1


def thread_stacks() -> str:
    """Plain-text dump of every thread's current stack, each headed by
    its thread's name."""

    import sys

    names = {t.ident: t.name for t in threading.enumerate()}
    chunks = []
    for tid, frame in sys._current_frames().items():
        chunks.append(
            f"--- thread {names.get(tid, '?')} (id {tid}) ---\n"
            + "".join(traceback.format_stack(frame))
        )
    return "\n".join(chunks)


class Watchdog:
    def __init__(
        self,
        metrics=None,
        recorder=None,
        check_interval: float = 1.0,
        default_deadline: float = 60.0,
    ):
        self._lock = threading.Lock()
        self._beats: Dict[str, Heartbeat] = {}
        self._metrics = metrics
        self._recorder = recorder
        self.check_interval = float(check_interval)
        self.default_deadline = float(default_deadline)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._log = FieldLogger(_root, component="watchdog")
        #: paths of postmortem dumps written (newest last; tests read it)
        self.dumps: List[str] = []

    # -- registration -------------------------------------------------------

    def register(self, name: str, deadline: Optional[float] = None) -> Heartbeat:
        """Create (or replace) the named heartbeat.  Replacing resets
        the clock — re-registration after a crash-restart is a fresh
        episode, not an instant stall."""

        hb = Heartbeat(name, deadline if deadline is not None else self.default_deadline)
        with self._lock:
            self._beats[name] = hb
        return hb

    def unregister(self, name: str) -> None:
        with self._lock:
            self._beats.pop(name, None)

    def heartbeats(self) -> Dict[str, Heartbeat]:
        with self._lock:
            return dict(self._beats)

    # -- monitoring ---------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "Watchdog":
        if self.running:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="stall-watchdog"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.check_interval):
            try:
                self.check_once()
            except Exception as e:  # noqa: BLE001 - the watchdog must outlive bugs
                self._log.error("watchdog sweep failed: %s: %s",
                                type(e).__name__, e)

    def check_once(self, now: Optional[float] = None) -> List[str]:
        """One deadline sweep (pure-ish, tests drive it directly).
        Returns the names that newly entered a stall this sweep."""

        now = time.monotonic() if now is None else now
        newly_stalled: List[str] = []
        with self._lock:
            beats = list(self._beats.values())
        for hb in beats:
            overdue = now - hb.last
            if overdue > hb.deadline:
                if not hb.stalled:
                    hb.stalled = True
                    newly_stalled.append(hb.name)
                    self._on_stall(hb, overdue)
            elif hb.stalled:
                hb.stalled = False
                self._log.info(
                    "heartbeat %s recovered after stall", hb.name
                )
        return newly_stalled

    def _on_stall(self, hb: Heartbeat, overdue: float) -> None:
        if self._metrics is not None:
            self._metrics.inc("watchdog_stall_total", heartbeat=hb.name)
        self._log.warning(
            "STALL: heartbeat %s silent %.1fs (deadline %.1fs, beats=%d) "
            "[trace=%s]",
            hb.name, overdue, hb.deadline, hb.beats, hb.trace_id or "-",
        )
        recorder = self._recorder
        if recorder is None:
            from tf_operator_tpu_torch.utils.flight import default_recorder

            recorder = default_recorder
        # the postmortem: metric deltas since the last snapshot, every
        # thread's stack (as a log record so it rides the same dump),
        # then the rings
        recorder.snapshot_metrics(label=f"stall:{hb.name}")
        recorder.record_log(
            "WARNING", "watchdog", f"thread stacks at stall of {hb.name}",
            fields={"stacks": thread_stacks(), "trace": hb.trace_id},
        )
        path = recorder.dump(reason=f"stall-{hb.name.replace('/', '_')}")
        if path:
            self.dumps.append(path)
            self._log.warning("flight recorder dumped to %s", path)


#: process-global default (mirrors metrics/tracer/flight defaults).
#: NOT started: registration is free; monitoring is opt-in via
#: ``default_watchdog.start()`` or TPUJOB_WATCHDOG=1 in ``serve_lm``.
default_watchdog = Watchdog()


def maybe_start_from_env(metrics=None) -> Optional[Watchdog]:
    """Start the default watchdog when TPUJOB_WATCHDOG=1 (deadline
    override via TPUJOB_WATCHDOG_DEADLINE seconds).  ``serve_lm.main``
    calls this once at boot."""

    import os

    if os.environ.get("TPUJOB_WATCHDOG") != "1":
        return None
    if metrics is not None:
        default_watchdog._metrics = metrics
    elif default_watchdog._metrics is None:
        from tf_operator_tpu_torch.utils.metrics import default_metrics

        default_watchdog._metrics = default_metrics
    import math

    dl = os.environ.get("TPUJOB_WATCHDOG_DEADLINE")
    if dl:
        # a typo in an opt-in diagnostics knob must not take the
        # binary down at boot, and nan/inf/<=0 would silently disarm
        # the watchdog (or stall-storm every heartbeat) — warn and
        # keep the default for anything but a finite positive float
        try:
            parsed = float(dl)
        except ValueError:
            parsed = None
        if parsed is not None and math.isfinite(parsed) and parsed > 0:
            default_watchdog.default_deadline = parsed
        else:
            default_watchdog._log.warning(
                "ignoring malformed TPUJOB_WATCHDOG_DEADLINE=%r "
                "(want seconds as a finite positive float); keeping %.0fs",
                dl, default_watchdog.default_deadline,
            )
    return default_watchdog.start()
