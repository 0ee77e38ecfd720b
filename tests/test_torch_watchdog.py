"""The port's stall watchdog (``tf_operator_tpu_torch/utils/watchdog.py``)
and ``train_loop``'s records against the JAX package's, on the CPU: the
twin of ``tests/test_watchdog.py``.

- The deadline sweep: the same heartbeats, silences and beats give the
  same newly stalled names, stall counters and dumps on both copies; the
  postmortem holds the same sections (meta, the stall's metric deltas,
  the thread stacks as a log record) in the same order.
- ``train_loop`` (K = 1, K > 1 on a fixed batch, K > 1 on an iterator;
  trainers that step one batch at a time, as the port's does): the same
  losses, sync-ledger counts by phase, span names and heartbeat beats as
  the JAX loop.
- A frozen ``train_loop`` (its data iterator hangs) dumps its last
  spans and every thread's stack.

The postmortem lands under the flight recorder's directory,
``$TPUJOB_FLIGHT_DIR``, in both copies.
"""

import collections
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from tf_operator_tpu.runtime import harness as j_harness
from tf_operator_tpu.utils import flight as j_flight
from tf_operator_tpu.utils import metrics as j_metrics
from tf_operator_tpu.utils import trace as j_trace
from tf_operator_tpu.utils import watchdog as j_watchdog

from tf_operator_tpu_torch.runtime import harness
from tf_operator_tpu_torch.utils import flight, metrics, trace, watchdog
from tf_operator_tpu_torch.utils.watchdog import Watchdog, thread_stacks

torch.set_num_threads(2)

#: (JAX modules, port modules): metrics, flight, trace, watchdog
SIDES = ((j_metrics, j_flight, j_trace, j_watchdog), (metrics, flight, trace, watchdog))


@pytest.fixture
def flight_dirs(tmp_path, monkeypatch):
    """Both copies' postmortems under ``tmp_path`` (``$TPUJOB_FLIGHT_DIR``)."""

    monkeypatch.setenv("TPUJOB_FLIGHT_DIR", str(tmp_path))
    return tmp_path


def _dog(m, f, w, **kw):
    """(registry, watchdog) of one copy over a fresh registry and recorder."""

    reg = m.Metrics()
    return reg, w.Watchdog(metrics=reg, recorder=f.FlightRecorder(), **kw)


def _dogs(**kw):
    """One of each copy: [JAX, port]."""

    return [_dog(m, f, w, **kw) for m, f, _, w in SIDES]


def test_fresh_heartbeat_not_stalled():
    for _, dog in _dogs():
        dog.register("a", deadline=5.0)
        assert dog.check_once() == []


def test_missed_deadline_fires_once_per_episode(flight_dirs):
    sections = []
    for reg, dog in _dogs():
        hb = dog.register("loop", deadline=0.01)
        hb.last -= 1.0
        assert dog.check_once() == ["loop"]
        assert dog.check_once() == []
        assert reg.counter("watchdog_stall_total", heartbeat="loop") == 1.0
        assert len(dog.dumps) == 1
        with open(dog.dumps[0]) as f:
            records = [json.loads(x) for x in f]
        stacks = [r for r in records if r["type"] == "log"]
        sections.append(([r["type"] for r in records], records[0]["reason"],
                         [(r["message"], sorted(r["fields"])) for r in stacks]))
    assert sections[1] == sections[0]
    assert sections[1][1] == "stall-loop"
    # the port's dump (the last side's) under $TPUJOB_FLIGHT_DIR
    assert os.path.dirname(dog.dumps[0]) == str(flight_dirs)


def test_beat_ends_episode_and_next_stall_refires(flight_dirs):
    for reg, dog in _dogs():
        hb = dog.register("loop", deadline=0.01)
        hb.last -= 1.0
        assert dog.check_once() == ["loop"]
        hb.beat()
        assert dog.check_once() == []
        hb.last -= 1.0
        assert dog.check_once() == ["loop"]
        assert reg.counter("watchdog_stall_total", heartbeat="loop") == 2.0
        assert len(dog.dumps) == 2


def test_heartbeat_captures_trace_id():
    ids = []
    for _, _, t, w in SIDES:
        tracer = t.Tracer(seed=11)
        hb = w.Watchdog().register("traced")
        with tracer.span("work"):
            hb.beat()
        ids.append(hb.trace_id)
    assert ids[1] is not None and ids[1].startswith("t")
    assert ids[1] == ids[0]  # one seed, one id sequence


def test_unregister_silences():
    for _, dog in _dogs():
        hb = dog.register("gone", deadline=0.01)
        hb.last -= 1.0
        dog.unregister("gone")
        assert dog.check_once() == []


def test_thread_stacks_names_this_test_and_its_thread():
    text = thread_stacks()
    assert "test_thread_stacks_names_this_test_and_its_thread" in text
    assert f"--- thread {threading.current_thread().name} " in text


def test_background_thread_start_stop(flight_dirs):
    reg, dog = _dog(metrics, flight, watchdog, check_interval=0.02)
    hb = dog.register("bg", deadline=0.05)
    dog.start()
    try:
        assert dog.running
        deadline = time.time() + 5.0
        while time.time() < deadline and not dog.dumps:
            time.sleep(0.02)
        assert dog.dumps, "background sweep never detected the stall"
        assert reg.counter("watchdog_stall_total", heartbeat="bg") == 1.0
    finally:
        dog.stop()
    assert not dog.running and hb.stalled


def test_maybe_start_from_env_reads_the_jax_variables(monkeypatch):
    monkeypatch.delenv("TPUJOB_WATCHDOG", raising=False)
    assert watchdog.maybe_start_from_env() is None
    reg = metrics.Metrics()
    deadline = watchdog.default_watchdog.default_deadline
    monkeypatch.setenv("TPUJOB_WATCHDOG", "1")
    monkeypatch.setenv("TPUJOB_WATCHDOG_DEADLINE", "7.5")
    try:
        dog = watchdog.maybe_start_from_env(metrics=reg)
        assert dog is watchdog.default_watchdog and dog.running
        assert dog.default_deadline == 7.5 and dog._metrics is reg
    finally:
        watchdog.default_watchdog.stop()
        watchdog.default_watchdog.default_deadline = deadline
        watchdog.default_watchdog._metrics = None


# -- train_loop against the JAX loop ---------------------------------------------


class FakeTrainer:
    """The JAX test's trainer (a deterministic loss series), stepping one
    batch at a time; ``tensors`` returns the losses as tensors, as the
    port's trainer does."""

    def __init__(self, losses, tensors=False):
        self._losses = list(losses)
        self._i = 0
        self.tensors = tensors

    def train_step(self, batch):
        v = self._losses[self._i]
        self._i += 1
        return {"loss": torch.tensor(v) if self.tensors else v}


def _series(n):
    return [2.0 - 0.05 * i for i in range(n)]


class _RecordingWatchdog:
    """Wraps a watchdog: keeps the heartbeat the loop registered."""

    def __init__(self, dog):
        self.dog, self.hb = dog, None

    def register(self, name, deadline=None):
        self.hb = self.dog.register(name, deadline)
        return self.hb

    def unregister(self, name):
        self.dog.unregister(name)


LOOP_CASES = {
    "k1-fixed": dict(steps=6, k=1, iterator=False),
    "k3-fixed": dict(steps=10, k=3, iterator=False),
    "k4-iterator": dict(steps=9, k=4, iterator=True),
}


def _run_loop(side, case):
    m, _, t, w = SIDES[side]
    loop = (j_harness, harness)[side].train_loop
    reg, tracer = m.Metrics(), t.Tracer(seed=3)
    ledger = m.StepSyncLedger(metrics=reg, tracer=tracer)
    dog = _RecordingWatchdog(w.Watchdog())
    batch = ({"x": i} for i in range(case["steps"])) if case["iterator"] else {"x": 0}
    losses = loop(FakeTrainer(_series(case["steps"]), tensors=side == 1), batch,
                  case["steps"], steps_per_sync=case["k"], assert_decreasing=False,
                  tracer=tracer, sync_ledger=ledger, watchdog=dog)
    spans = [s for summary in tracer.store.summaries(50)
             for s in tracer.store.trace(summary["traceId"])["spans"]]
    return losses, ledger, spans, dog.hb, reg


@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_train_loop_records_equal_the_jax_loop(case):
    want = _run_loop(0, LOOP_CASES[case])
    got = _run_loop(1, LOOP_CASES[case])
    assert np.allclose(got[0], want[0])
    counts = [{p: r["count"] for p, r in led.snapshot().items()} for led in (got[1], want[1])]
    assert counts[0] == counts[1]
    names = [collections.Counter(s["name"] for s in spans) for spans in (got[2], want[2])]
    assert names[0] == names[1]
    assert got[3].beats == want[3].beats and got[3].name == want[3].name
    reg = got[4]
    k, steps = LOOP_CASES[case]["k"], LOOP_CASES[case]["steps"]
    windows = -(-steps // k)
    assert got[3].beats == windows
    assert got[1].count("step" if k == 1 else "window") + got[1].count("final") == windows
    assert reg.gauge("train_window_steps_per_second") > 0
    # the sentinel: one observation of the window's per-step wall a step
    hist = reg.gauge_series("step_time_p50_seconds")
    assert {dict(lab)["signal"] for lab in hist} == {"train_sync"}


def test_train_loop_stats_carry_the_ledger_sentinel_and_beats():
    stats = {}
    # 16 windows: the sentinel freezes its drift reference at the 16th
    steps, k = 80, 5
    harness.train_loop(FakeTrainer(_series(steps), tensors=True), {"x": 0}, steps,
                       steps_per_sync=k, stats=stats, tracer=trace.Tracer(seed=1),
                       sync_ledger=metrics.StepSyncLedger(metrics=metrics.Metrics()),
                       watchdog=Watchdog())
    snap = stats["sentinel"].snapshot()["train_sync"]
    assert snap["observations"] == steps // k and snap["drift_ratio"] is not None
    assert stats["heartbeat_beats"] == steps // k
    assert stats["sync_ledger"].count("window") == steps // k - 1
    assert stats["sync_ledger"].count("final") == 1
    assert [n for n, _ in stats["resolved_at"]] == list(range(5, steps + 1, 5))


@pytest.mark.parametrize("k", [1, 4, 8])
def test_train_loop_feeds_the_sentinel_once_a_window(k):
    """As the JAX loop does: one ``train_sync`` observation a K-step
    window (the last window may be short), its wall over its steps."""

    stats, steps = {}, 30
    harness.train_loop(FakeTrainer(_series(steps), tensors=True), {"x": 0}, steps,
                       steps_per_sync=k, stats=stats, tracer=trace.Tracer(seed=2),
                       sync_ledger=metrics.StepSyncLedger(metrics=metrics.Metrics()),
                       watchdog=Watchdog())
    windows = -(-steps // k)
    assert stats["sentinel"].snapshot()["train_sync"]["observations"] == windows
    assert stats["heartbeat_beats"] == windows


def test_frozen_train_loop_dumps_last_spans(flight_dirs):
    """The acceptance e2e: a train loop frozen mid-run (its data
    iterator hangs) stops heartbeating; the watchdog dumps the flight
    recorder, and the dump holds the stalled loop's last spans and
    every thread's stack."""

    m = metrics.Metrics()
    tracer = trace.Tracer(seed=5)
    recorder = flight.FlightRecorder()
    recorder.attach_tracer(tracer)
    recorder.attach_metrics(m)
    dog = Watchdog(metrics=m, recorder=recorder, check_interval=0.05)
    release = threading.Event()

    def batches():
        for i in range(4):
            yield {"x": i}
        release.wait(timeout=30.0)  # the freeze
        raise RuntimeError("unfrozen: end the thread")

    def run():
        try:
            harness.train_loop(
                FakeTrainer(_series(64), tensors=True), batches(), 64, steps_per_sync=2,
                assert_decreasing=False, tracer=tracer, watchdog=dog,
                sync_ledger=metrics.StepSyncLedger(metrics=m, tracer=tracer))
        except RuntimeError:
            pass

    t = threading.Thread(target=run, daemon=True)
    t.start()
    dog.start()
    try:
        deadline = time.time() + 10.0
        hb = None
        while time.time() < deadline:
            hb = dog.heartbeats().get("train.train")
            if hb is not None and hb.beats >= 1:
                break
            time.sleep(0.02)
        assert hb is not None and hb.beats >= 1, "loop never started"
        hb.deadline = 0.2
        deadline = time.time() + 10.0
        while time.time() < deadline and not dog.dumps:
            time.sleep(0.05)
        assert dog.dumps, "watchdog never dumped on the frozen loop"
    finally:
        release.set()
        dog.stop()
        t.join(timeout=10.0)
    assert not t.is_alive()
    assert m.counter("watchdog_stall_total", heartbeat="train.train") == 1.0
    with open(dog.dumps[0]) as f:
        records = [json.loads(x) for x in f]
    span_names = {r["name"] for r in records if r["type"] == "span"}
    assert {"train.step", "data.load"} <= span_names
    stack_logs = [r for r in records
                  if r["type"] == "log" and "thread stacks" in r["message"]]
    assert stack_logs and "release.wait" in stack_logs[0]["fields"]["stacks"]


# -- the pod telemetry server ---------------------------------------------------


def test_pod_telemetry_server_serves_the_jax_routes():
    """The copy of ``runtime/telemetry.py`` against the JAX one: each
    route's status and content type, the same exposition for the same
    counter, the spans and flight dump, and ``/debug/compiles`` /
    ``/debug/memory`` with the JAX keys over the process cost plane."""

    import urllib.error
    import urllib.request

    from tf_operator_tpu.runtime import telemetry as j_telemetry

    from tf_operator_tpu_torch.runtime import telemetry

    answers = []
    for (m, _, t, _), tel in zip(SIDES, (j_telemetry, telemetry)):
        reg, tracer = m.Metrics(), t.Tracer(seed=3)
        reg.inc("train_dcn_bytes_total", 512.0, fabric="dcn")
        with tracer.span("train unit"):
            pass
        srv = tel.PodTelemetryServer(metrics=reg, tracer=tracer).start()
        try:
            got = {}
            for route in ("/healthz", "/metrics", "/traces", "/debug/flightrecorder",
                          "/debug/compiles", "/debug/memory", "/nope"):
                try:
                    with urllib.request.urlopen(srv.url + route, timeout=30) as r:
                        got[route] = (r.status, r.headers["Content-Type"], r.read().decode())
                except urllib.error.HTTPError as exc:
                    got[route] = (exc.code, exc.headers["Content-Type"], "")
            answers.append(got)
        finally:
            srv.stop()
    want, got = answers
    assert {r: v[:2] for r, v in got.items()} == {r: v[:2] for r, v in want.items()}
    assert got["/nope"][0] == 404 and got["/healthz"][2].startswith("ok")
    assert got["/metrics"][2] == want["/metrics"][2]
    assert [json.loads(x)["name"] for x in got["/traces"][2].splitlines()] == ["train unit"]
    assert json.loads(got["/debug/flightrecorder"][2].splitlines()[0])["type"] == "meta"
    for route in ("/debug/compiles", "/debug/memory"):
        assert sorted(json.loads(got[route][2])) == sorted(json.loads(want[route][2]))


def test_telemetry_env_contract():
    from tf_operator_tpu_torch.runtime import telemetry

    assert telemetry.maybe_start_from_env(environ={}) is None
    assert telemetry.maybe_start_from_env(environ={"TPUJOB_TELEMETRY_PORT": "0"}) is None
    assert telemetry.maybe_start_from_env(environ={"TPUJOB_TELEMETRY_PORT": "x"}) is None
    env = {"TPUJOB_TRACE_ID": "tabc", "TPUJOB_PARENT_SPAN_ID": "sdef"}
    assert telemetry.trace_context_from_env(environ=env) == ("tabc", "sdef")
    assert telemetry.trace_context_from_env(environ={}) == (None, None)


def test_train_loop_roots_its_trace_under_the_environment(monkeypatch):
    monkeypatch.setenv("TPUJOB_TRACE_ID", "tparent")
    monkeypatch.setenv("TPUJOB_PARENT_SPAN_ID", "sparent")
    tracer = trace.Tracer(seed=2)
    harness.train_loop(FakeTrainer(_series(4), tensors=True), {"x": 0}, 4,
                       steps_per_sync=2, assert_decreasing=False, tracer=tracer,
                       sync_ledger=metrics.StepSyncLedger(metrics=metrics.Metrics()),
                       watchdog=Watchdog())
    spans = tracer.store.trace("tparent")["spans"]
    root = [s for s in spans if s["name"] == "train train"]
    assert len(root) == 1 and root[0]["parentId"] == "sparent"
