"""The port's serving-plane records against the JAX package's, on the CPU.

- The copies (``utils/metrics``, ``utils/trace``, ``utils/flight``,
  ``utils/alerts``, ``RequestLog``, ``ArenaTimeline``): the same calls
  give the same exposition, entries, snapshots, rule names, firings and
  dump sections.
- The pools (``llama_tiny``, float32, one bridged flax param tree;
  greedy, given trace ids; a shared-prefix mix and two pressured
  cases): equal autopsy integers, span-name multisets, metric family
  names and label keys, SLO histogram counts by tier, preemption
  counters and swap bytes.
- The servers (the ``servers`` fixture of ``test_torch_serving.py``):
  ``request_id`` and the echoed ``x-trace-id``, the autopsy endpoints
  and their 404, and the keys of ``/slo``, ``/debug/arena`` and
  ``/alerts``.
- The port's twin of ``test_lint_no_hot_sync.py`` over the pool's step
  and swap paths, and the dispatch blocks that hold the fetches they
  time.

Deliberate differences pinned here: ``/metrics`` lacks the JAX server's
``serve_pool_compiles`` line; on the CPU it lacks the compile ledger's
families (``COSTPLANE_FAMILIES``), because the port records a compile
only where a kernel is built, loaded or first launched, which never
happens here (on the card ``chip_smoke.py`` phase 7 reads them); and
the flight recorder dumps under ``$TPUJOB_FLIGHT_DIR``, or the
temporary directory where the JAX copy's default is /tmp.
"""

import ast
import collections
import json
import os
import tempfile
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tf_operator_tpu.models.batching import (
    PagedContinuousBatchingDecoder as JaxPool,
    RequestLog as JaxRequestLog,
)
from tf_operator_tpu.models.kv_blocks import ArenaTimeline as JaxTimeline
from tf_operator_tpu.utils import alerts as j_alerts
from tf_operator_tpu.utils import flight as j_flight
from tf_operator_tpu.utils import metrics as j_metrics
from tf_operator_tpu.utils.trace import Tracer as JaxTracer

from tf_operator_tpu_torch import serve_lm
from tf_operator_tpu_torch.models import batching
from tf_operator_tpu_torch.models.batching import RequestLog
from tf_operator_tpu_torch.models.kv_blocks import ArenaTimeline
from tf_operator_tpu_torch.utils import alerts, flight, metrics
from tf_operator_tpu_torch.utils.trace import TRACE_HEADER, Tracer

from test_torch_serving import servers, tiny  # noqa: F401  (fixtures)

torch.set_num_threads(2)

#: the cost plane's compile families, left out of the comparisons on the
#: CPU: the JAX pool records its jit compiles there; the port records a
#: compile only where a kernel is built, loaded or first launched (never
#: on the CPU), and what a process recorded before depends on the tests
#: it ran, so the port side leaves them out too
COSTPLANE_FAMILIES = {"compile_seconds", "compile_total"}


# -- the copies -------------------------------------------------------------

#: call sequences applied to both registries: (method, args, kwargs)
METRIC_CALLS = {
    "counters": [
        ("inc", ("serve_requests_total",), {"status": "200"}),
        ("inc", ("serve_requests_total",), {"status": "200"}),
        ("inc", ("serve_requests_total", 2.0), {"status": "400"}),
        ("inc", ("kv_swap_bytes_total", 4096.0), {"direction": "out"}),
        ("inc", ("serve_preemptions_total",), {"tier": "batch", "model": "m",
                                                "replica": "0", "exemplar": "t-1"}),
        ("describe", ("serve_requests_total", "requests\nby status"), {}),
    ],
    "gauges": [
        ("set", ("kv_blocks_free", 12.0), {"model": "m", "replica": "0", "role": "unified"}),
        ("set", ("kv_blocks_free", 9.0), {"model": "m", "replica": "0", "role": "unified"}),
        ("set", ("serve_tokens_in_flight", 40.0), {"model": 'a"b\\c'}),
        ("set", ("alert_state", 1.0), {"rule": "x"}),
        ("clear_gauge", ("alert_state",), {}),
    ],
    "histograms": [
        ("set_buckets", ("serve_ttft_seconds", metrics.SLO_BUCKETS), {}),
        ("observe_histogram", ("serve_ttft_seconds", 0.3), {"tier": "batch", "mode": "pool",
                                                             "model": "m", "exemplar": "t-2"}),
        ("observe_histogram", ("serve_ttft_seconds", 7.0), {"tier": "interactive",
                                                             "mode": "pool", "model": "m"}),
        ("observe_histogram", ("serve_ttft_seconds", 90.0), {"tier": "batch", "mode": "pool",
                                                              "model": "m"}),
        ("observe_histogram", ("serving_dispatch_seconds", 0.004), {"phase": "step"}),
        ("observe_histogram", ("serve_queue_wait_seconds", 0.01, (0.1, 1.0)), {"model": "m"}),
    ],
    "mixed": [
        ("observe", ("startup_seconds", 1.5), {}),
        ("observe", ("startup_seconds", 0.5), {}),
        ("merge_histogram", ("serve_ttft_seconds", (0.1, 1.0), [1, 2, 3], 9.0, 6),
         {"replica": "1", "model": "m"}),
        ("merge_histogram", ("serve_ttft_seconds", (0.1, 1.0), [0, 1, 0], 0.5, 1),
         {"replica": "2", "model": "m"}),
        ("inc", ("alert_evaluations_total",), {}),
        ("set", ("serve_admission_queue_depth", 3.0), {"model": "m"}),
    ],
}


@pytest.mark.parametrize("calls", sorted(METRIC_CALLS))
def test_metrics_copy_gives_the_same_exposition(calls):
    jm, pm = j_metrics.Metrics(), metrics.Metrics()
    for name, args, kw in METRIC_CALLS[calls]:
        getattr(jm, name)(*args, **kw)
        getattr(pm, name)(*args, **kw)
    assert pm.exposition() == jm.exposition()
    assert pm.counters_snapshot() == jm.counters_snapshot()
    for fam in ("serve_ttft_seconds", "serve_queue_wait_seconds"):
        assert pm.histogram_family_merged(fam) == jm.histogram_family_merged(fam)
        assert pm.histogram_raw(fam) == jm.histogram_raw(fam)


def test_dispatch_ledger_copy_counts_and_exports_alike():
    assert metrics.DISPATCH_PHASES == j_metrics.DISPATCH_PHASES
    jm, pm = j_metrics.Metrics(), metrics.Metrics()
    jl = j_metrics.DispatchLedger(metrics=jm, tracer=JaxTracer(seed=0))
    pl = metrics.DispatchLedger(metrics=pm, tracer=Tracer(seed=0))
    for ledger in (jl, pl):
        for phase in ("admission", "step", "step", "retire"):
            with ledger.dispatch(phase, replica="0"):
                pass
        with pytest.raises(RuntimeError):
            with ledger.dispatch("swap_out"):
                raise RuntimeError("device call failed")
    for phase in ("admission", "step", "retire", "swap_out", "swap_in"):
        assert pl.count(phase) == jl.count(phase)
    assert pm.counters_snapshot() == jm.counters_snapshot()
    assert {k: v["count"] for k, v in pl.snapshot().items()} == {
        k: v["count"] for k, v in jl.snapshot().items()}
    # outside a request span each dispatch roots a trace of its own
    assert len(pl.tracer.store.summaries(50)) == len(jl.tracer.store.summaries(50)) == 5


def test_step_sync_ledger_resolves_tensors_to_host():
    ledger = metrics.StepSyncLedger(metrics=metrics.Metrics())
    ledger.step(2)
    out = ledger.resolve("window", {"loss": torch.tensor(2.5),
                                    "parts": [torch.ones(2, dtype=torch.bfloat16), 3]})
    assert out["loss"] == np.float32(2.5) and out["parts"][1] == 3
    np.testing.assert_array_equal(out["parts"][0], np.ones(2, np.float32))
    assert ledger.count("window") == 1 and ledger.blocked() == 0
    assert ledger.snapshot()["_steps"] == {"count": 2, "syncs_per_step": 0.5}


def _log_mutations(log, capacity_case):
    """The pool's calls on a RequestLog, and the two rules: an id
    collision demotes the older entry to ``<id>~<rid>``; eviction spares
    entries still in flight."""

    a = log.open(id="t-a", rid=0, tier="batch", prompt_tokens=5)
    log.count_dispatch(a, "admission")
    log.update(a, state="active", slot=0, admission={"width": 5, "blocks_reserved": 2})
    log.add_window(a, 8)
    log.count_preempt(a, swapped_blocks=2)
    log.add_swap(a, 1)
    log.count_dispatch(a, "swap_out")
    b = log.open(id="t-b", rid=1, tier="interactive")
    log.add_window(b, 4)
    log.update(a, state="active", slot=1)
    log.count_dispatch(a, "retire", 2)
    log.update(a, state="done", retire={"blocks_freed": 3}, tokens=9)
    if capacity_case == "collision":
        log.open(id="t-a", rid=2)  # a client reused the trace id
    elif capacity_case == "eviction":
        for i in range(3, 7):
            e = log.open(id=f"t-{i}", rid=i)
            if i < 5:
                log.update(e, state="done")
    return log


@pytest.mark.parametrize("case", ["lifecycle", "collision", "eviction"])
def test_request_log_copy_gives_the_same_entries(case, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    cap = 3 if case == "eviction" else 256
    jlog = _log_mutations(JaxRequestLog(capacity=cap), case)
    plog = _log_mutations(RequestLog(capacity=cap), case)
    assert plog.recent(50) == jlog.recent(50)
    assert (len(plog), plog.evicted) == (len(jlog), jlog.evicted)
    for rid in ("t-a", "t-a~0", "t-b", "t-5"):
        assert plog.get(rid) == jlog.get(rid)
    assert plog.recent(0) == [] and plog.recent(-1) == []
    if case == "collision":
        assert plog.get("t-a~0")["state"] == "done" and plog.get("t-a")["rid"] == 2
    if case == "eviction":
        # the queued entry t-b outlives newer finished ones
        assert plog.get("t-b") is not None and plog.get("t-3") is None


def test_arena_timeline_copy_gives_the_same_snapshot(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    samples = [dict(free=10, live=6, prefix_cached=2, queued_demand=0, seats_active=1),
               dict(free=10, live=6, prefix_cached=2, queued_demand=0, seats_active=1),
               dict(free=8, live=8, prefix_cached=2, queued_demand=4, seats_active=2,
                    swapped=3),
               dict(free=12, live=4, prefix_cached=2, queued_demand=0, seats_active=0)]
    jt = JaxTimeline(capacity=2, block_size=16, usable=16, replica="0")
    pt = ArenaTimeline(capacity=2, block_size=16, usable=16, replica="0")
    for s in samples:
        jt.sample(**s)
        pt.sample(**s)
    assert pt.snapshot() == jt.snapshot()
    assert pt.snapshot(1) == jt.snapshot(1) and pt.tail(0) == [] == jt.tail(0)
    assert pt.dropped == jt.dropped == 1 and len(pt) == 2


def _alert_registry(mod, state):
    m = mod.Metrics()
    if state in ("pressure", "both"):
        m.set("kv_blocks_pressure", 0.95, model="m", replica="0", role="unified")
        m.set("serve_admission_queue_depth", 80.0, model="m")
    return m


def _feed(m, state, t):
    if state in ("preemptions", "both"):
        m.inc("serve_preemptions_total", 5.0, tier="batch", model="m", replica="0")
    if state in ("ttft", "both"):
        for _ in range(20):
            m.observe_histogram("serve_ttft_seconds", 30.0 if t % 2 else 0.1,
                                tier="batch", mode="pool", model="m")


@pytest.mark.parametrize("state", ["quiet", "pressure", "preemptions", "ttft", "both"])
def test_alert_rules_copy_fire_alike(state, monkeypatch, tmp_path):
    assert [r.name for r in alerts.default_rules()] == [
        r.name for r in j_alerts.default_rules()]
    monkeypatch.setenv("TPUJOB_FLIGHT_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    runs = []
    for mod, rules, rec in ((metrics, alerts, flight), (j_metrics, j_alerts, j_flight)):
        m = _alert_registry(mod, state)
        engine = rules.AlertEngine(rules.default_rules(short=20.0, long=40.0), metrics=m,
                                   recorder=rec.FlightRecorder())
        transitions = []
        for t in range(0, 130, 5):  # a unix-shaped clock, never the thread
            _feed(m, state, t)
            transitions.append(engine.evaluate_once(1.7e9 + t))
        runs.append((transitions, engine.snapshot(), len(engine.dumps)))
    assert runs[0] == runs[1]
    fired = runs[0][1]["firing"]
    want = {"quiet": [], "pressure": ["admission-queue-depth", "kv-blocks-pressure"],
            "preemptions": ["serve-preemption-rate"]}
    if state in want:
        assert fired == want[state]
    else:
        assert "serve-ttft-burn" in fired


def _fill_recorder(rec, tracer, log, timeline, m):
    rec.attach_tracer(tracer)
    rec.attach_metrics(m)
    rec.attach_request_log(log)
    rec.attach_arena_timeline(timeline)
    with tracer.start_span("serve.generate", kind="server"):
        with tracer.start_span("dispatch.step"):
            pass
    rec.record_log("WARNING", "alerts", "alert x firing", fields={"rule": "x"})
    m.inc("serve_requests_total", status="200")
    rec.snapshot_metrics(label="a")
    m.inc("serve_requests_total", status="200")
    rec.snapshot_metrics(label="b")
    log.add_window(log.open(id="t-1", rid=0), 8)
    timeline.sample(free=3, live=5, prefix_cached=1, queued_demand=2, seats_active=1)


@pytest.mark.parametrize("flight_dir", [None, "flights"])
def test_flight_recorder_copy_dumps_the_same_sections(monkeypatch, tmp_path, flight_dir):
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    dumps = []
    for rec, tracer, log, tl, m in (
            (flight.FlightRecorder(), Tracer(seed=0), RequestLog(), ArenaTimeline(),
             metrics.Metrics()),
            (j_flight.FlightRecorder(), JaxTracer(seed=0), JaxRequestLog(), JaxTimeline(),
             j_metrics.Metrics())):
        _fill_recorder(rec, tracer, log, tl, m)
        dumps.append([json.loads(line) for line in rec.dump_text().splitlines()])
    port, jax_ = dumps
    assert [r["type"] for r in port] == [r["type"] for r in jax_] == [
        "meta", "span", "span", "log", "metrics", "metrics", "request", "arena"]
    for p, j in zip(port, jax_):
        assert sorted(p) == sorted(j)
        if p["type"] in ("meta", "log", "metrics", "request", "arena"):
            assert p == j
    # the dump's directory: $TPUJOB_FLIGHT_DIR (made when missing), else
    # the temporary directory
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    want = str(tmp_path / flight_dir) if flight_dir else str(tmp_path)
    if flight_dir:
        monkeypatch.setenv("TPUJOB_FLIGHT_DIR", want)
    else:
        monkeypatch.delenv("TPUJOB_FLIGHT_DIR", raising=False)
    path = flight.FlightRecorder().dump(reason="test")
    assert os.path.dirname(path) == want and path.endswith("-test.jsonl")


# -- the pools --------------------------------------------------------------

VOCAB, MAX_LEN = 256, 64


def _prompt(r, n):
    return r.integers(0, VOCAB, n).astype(np.int32)


def _scenario(name):
    """(pool kwargs, waves of (trace id, prompt, budget, tier)): each
    wave is submitted, then the pool steps once; then it runs out."""

    r = np.random.default_rng(5)
    if name == "shared-prefix":
        shared = _prompt(r, 16)
        waves = [[("s-0", _prompt(r, 5), 10, "batch"),
                  ("s-1", np.concatenate([shared, _prompt(r, 3)]), 12, "batch")],
                 [("s-2", _prompt(r, 9), 6, "interactive"),
                  ("s-3", np.concatenate([shared, _prompt(r, 7)]), 10, "batch")],
                 [("s-4", _prompt(r, 3), 1, "batch")]]
        return dict(slots=2, steps_per_sync=4, kv_block_size=8, kv_blocks=24), waves
    if name == "preempt":
        # tests/test_torch_preemption.py's scenario: batch A decodes two
        # windows in a 4-block arena, an interactive admission preempts it
        waves = [[("p-a", _prompt(r, 6), 24, "batch")], [],
                 [("p-i", _prompt(r, 33), 8, "interactive")]]
        return dict(slots=4, steps_per_sync=8, kv_block_size=16, kv_blocks=4), waves
    # the pressured mix: five batch requests in a tight arena, then two
    # interactive arrivals a window apart
    batch = [(f"m-{i}", _prompt(r, n), b, "batch")
             for i, (n, b) in enumerate(((6, 30), (11, 20), (3, 40), (17, 12), (9, 26)))]
    waves = [batch, [], [("m-i1", _prompt(r, 20), 10, "interactive")], [],
             [("m-i2", _prompt(r, 5), 16, "interactive")]]
    return dict(slots=4, steps_per_sync=4, kv_block_size=8, kv_blocks=14), waves


SCENARIOS = ("shared-prefix", "preempt", "pressured-mix")


def _drive(pool, waves):
    for wave in waves:
        for tid, prompt, budget, tier in wave:
            pool.submit(prompt, budget, tier=tier, trace_id=tid)
        pool.step()
    pool.run()


@pytest.fixture(scope="module")
def pool_runs(tiny):  # noqa: F811
    """Per scenario: (JAX pool, port pool, trace ids), both driven the
    same way with the full records plane (seeded tracers)."""

    jm, params, model = tiny
    cache = {}

    def run(name):
        if name not in cache:
            kw, waves = _scenario(name)
            jreg = j_metrics.Metrics()
            jpool = JaxPool(jm, params, paged_kernel="off", model_label="llama",
                            ledger=j_metrics.DispatchLedger(jreg, JaxTracer(seed=0)),
                            metrics=jreg, **kw)
            pool = serve_lm.make_pool(model, model_label="llama", tracer=Tracer(seed=0), **kw)
            _drive(jpool, waves)
            _drive(pool, waves)
            cache[name] = (jpool, pool, [w[0] for wave in waves for w in wave])
        return cache[name]

    return run


def _autopsy_ints(entry):
    adm = entry["admission"] or {}
    return {
        "tokens": entry["tokens"], "windows": entry["windows"],
        "dispatches": entry["dispatches"], "preempted": entry["preempted"],
        "swapped_blocks": entry["swapped_blocks"], "tier": entry["tier"],
        "state": entry["state"], "blocks_reserved": adm.get("blocks_reserved"),
        "prefix_hit_tokens": adm.get("prefix_hit_tokens"),
        "blocks_freed": (entry["retire"] or {}).get("blocks_freed"),
        "prompt_tokens": entry["prompt_tokens"], "max_new_tokens": entry["max_new_tokens"],
    }


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_pool_autopsies_match_the_jax_pool(pool_runs, scenario):
    jpool, pool, tids = pool_runs(scenario)
    assert pool.preemptions == jpool.preemptions
    if scenario != "shared-prefix":
        assert pool.preemptions >= 1, "the scenario failed to preempt"
    for tid in tids:
        got, want = pool.request_log.get(tid), jpool.request_log.get(tid)
        assert sorted(got) == sorted(want)
        assert _autopsy_ints(got) == _autopsy_ints(want), tid
        assert got["ttft_seconds"] > 0 and got["queue_wait_seconds"] >= 0
    assert sum(pool.request_log.get(t)["preempted"] for t in tids) == pool.preemptions
    if scenario == "shared-prefix":
        assert pool.request_log.get("s-3")["admission"]["prefix_hit_tokens"] == 16


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_pool_spans_match_the_jax_pool(pool_runs, scenario):
    jpool, pool, tids = pool_runs(scenario)
    for tid in tids:
        got = pool.tracer.store.trace(tid)["spans"]
        want = jpool.tracer.store.trace(tid)["spans"]
        assert collections.Counter(s["name"] for s in got) == collections.Counter(
            s["name"] for s in want), tid
        by_id = {s["spanId"]: s for s in got}
        for s in got:
            if s["name"].startswith("dispatch."):
                # a request's dispatches nest under its lifecycle span
                assert by_id[s["parentId"]]["name"] == s["name"][len("dispatch."):]


def _families(reg):
    """{family: {frozenset of label keys, ...}} of a registry."""

    out = collections.defaultdict(set)
    with reg._lock:
        series = list(reg._counters) + list(reg._gauges) + list(reg._histograms)
    for name, labels in series:
        out[name].add(frozenset(k for k, _ in labels))
    return dict(out)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_pool_metric_families_match_the_jax_pool(pool_runs, scenario):
    jpool, pool, _ = pool_runs(scenario)
    want = {k: v for k, v in _families(jpool.metrics).items() if k not in COSTPLANE_FAMILIES}
    got = {k: v for k, v in _families(pool.metrics).items() if k not in COSTPLANE_FAMILIES}
    assert got == want
    assert COSTPLANE_FAMILIES <= set(_families(jpool.metrics))


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_pool_slo_counts_and_counters_match_the_jax_pool(pool_runs, scenario):
    jpool, pool, tids = pool_runs(scenario)
    for fam in ("serve_queue_wait_seconds", "serve_ttft_seconds",
                "serve_time_per_output_token_seconds"):
        counts = [{dict(k)["tier"]: v["count"] for k, v in p.metrics.histogram_family(fam).items()}
                  for p in (pool, jpool)]
        assert counts[0] == counts[1]
        assert sum(counts[0].values()) == len(tids)
    for name in ("serve_preemptions_total", "kv_swap_bytes_total",
                 "serve_prefix_cache_hits_total", "serve_prefix_cache_misses_total"):
        assert pool.metrics.counter_series(name) == jpool.metrics.counter_series(name), name
    if pool.preemptions:
        series = pool.metrics.counter_series("serve_preemptions_total")
        assert {dict(k)["tier"] for k in series} == {"batch"}
        assert sum(series.values()) == pool.preemptions
        swap = pool.metrics.counter_series("kv_swap_bytes_total")
        assert swap[(("direction", "out"),)] == swap[(("direction", "in"),)] == sum(
            e["bytes"] for e in pool.swap_log if e["direction"] == "out")
    snap = pool.timeline.snapshot()
    assert snap["samples"][-1]["swapped"] == 0 and snap["usable"] == pool.alloc.usable
    if pool.preemptions:
        assert max(s["swapped"] for s in snap["samples"]) > 0
    for phase in ("admission", "step", "retire", "swap_out", "swap_in"):
        assert pool.ledger.count(phase) == jpool.ledger.count(phase), phase


def test_bare_pool_counts_dispatches_and_records_no_metrics_or_spans(tiny):  # noqa: F811
    _, _, model = tiny
    kw, waves = _scenario("preempt")
    pool = batching.PagedContinuousBatchingDecoder(model, **kw)
    _drive(pool, waves)
    assert pool.metrics is None and pool.tracer is None
    assert pool.ledger.count("step") > 0 and pool.ledger.count("swap_in") == 1
    # ids minted without a tracer, as the JAX pool mints them
    bare = pool.request_log.recent(1)[0]
    assert bare["id"] == "p-i" and pool.request_log.get("p-a")["preempted"] == 1
    rid = pool.submit(np.arange(4, dtype=np.int32), 2)
    pool.run()
    assert pool.request_log.get(f"treq-0-{rid}")["state"] == "done"


# -- the servers ------------------------------------------------------------


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read(), dict(exc.headers)


def _post(port, body, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        method="POST", headers=headers or {},
    )
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read()), dict(resp.headers)


def _sample_names(text):
    names = set()
    for line in text.splitlines():
        if line and not line.startswith("#"):
            names.add(line.split("{")[0].split(" ")[0])
    return names


def test_servers_answer_request_ids_and_echo_trace_ids(servers):  # noqa: F811
    port, jport, _ = servers
    body = {"prompt": "the records plane ", "max_new_tokens": 6}
    for p in (port, jport):
        code, got, headers = _post(p, body)
        assert code == 200 and got["request_id"]
        assert headers[TRACE_HEADER] == got["request_id"]
        code, got, headers = _post(p, body, {TRACE_HEADER: f"client-trace-{p}"})
        assert got["request_id"] == headers[TRACE_HEADER] == f"client-trace-{p}"
        # both servers end the serve.generate span when the handler
        # returns, after the reply is written: read until it has ended
        deadline = time.monotonic() + 30
        while True:
            code, raw, _ = _get(p, f"/traces/client-trace-{p}")
            names = {s["name"] for s in json.loads(raw)["spans"]}
            if "serve.generate" in names or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        assert {"serve.generate", "queue.wait", "admission", "dispatch.admission",
                "decode.window", "retire"} <= names


def test_servers_serve_the_same_autopsies_and_404(servers):  # noqa: F811
    port, jport, _ = servers
    answers = []
    for p in (port, jport):
        _, got, _ = _post(p, {"prompt": "autopsy of a request ", "max_new_tokens": 5})
        code, raw, _ = _get(p, f"/requests/{got['request_id']}")
        assert code == 200
        answers.append(json.loads(raw))
        code, raw, _ = _get(p, "/requests")
        assert code == 200 and json.loads(raw)["requests"][0]["id"] == got["request_id"]
    assert sorted(answers[0]) == sorted(answers[1])
    assert _autopsy_ints(answers[0]) == _autopsy_ints(answers[1])
    missing = [_get(p, "/requests/no-such-request") for p in (port, jport)]
    assert missing[0][0] == missing[1][0] == 404
    assert json.loads(missing[0][1]) == json.loads(missing[1][1])


@pytest.mark.parametrize("path", ["/slo", "/debug/arena", "/alerts"])
def test_servers_read_endpoints_have_the_same_keys(servers, path):  # noqa: F811
    port, jport, _ = servers
    _post(port, {"prompt": "keys ", "max_new_tokens": 3})
    _post(jport, {"prompt": "keys ", "max_new_tokens": 3})
    got, want = [json.loads(_get(p, path)[1]) for p in (port, jport)]
    assert sorted(got) == sorted(want)
    if path == "/slo":
        assert sorted(got["histograms"]) == sorted(want["histograms"])
        assert sorted(got["gauges"]) == sorted(want["gauges"])
        ttft = got["histograms"]["serve_ttft_seconds"]
        assert {row["tier"] for row in ttft} <= {"batch", "interactive"} and ttft
    if path == "/debug/arena":
        assert got["fabric"] is None is want["fabric"]
        assert sorted(got["replicas"][0]) == sorted(want["replicas"][0])
    if path == "/alerts":
        assert sorted(a["name"] for a in got["alerts"]) == sorted(
            a["name"] for a in want["alerts"])


def test_servers_metrics_and_flight_recorder(servers):  # noqa: F811
    port, jport, pool = servers
    _post(port, {"prompt": "families ", "max_new_tokens": 3})
    _post(jport, {"prompt": "families ", "max_new_tokens": 3})
    got, want = [_get(p, "/metrics")[1].decode() for p in (port, jport)]
    costplane = {n for n in _sample_names(want) if n.split("_bucket")[0].split("_sum")[0]
                 .split("_count")[0] in COSTPLANE_FAMILIES}
    # the one deliberate difference beside the cost plane
    assert _sample_names(want) - _sample_names(got) - costplane == {"serve_pool_compiles"}
    assert _sample_names(got) <= _sample_names(want)
    ok = pool.metrics.counter("serve_requests_total", status="200")
    assert f'serve_requests_total{{status="200"}} {ok}' in got
    code, raw, headers = _get(port, "/debug/flightrecorder")
    assert code == 200 and headers["Content-Type"] == "application/x-ndjson"
    records = [json.loads(line) for line in raw.decode().splitlines()]
    assert records[0]["type"] == "meta"
    assert {r["id"] for r in records if r["type"] == "request"}
    assert _get(port, "/debug/compiles")[0] == 200


def test_server_reads_never_take_the_pool_lock(servers):  # noqa: F811
    """The read endpoints go through the records' own locks: with the
    pool's lock held (a decode window in progress), each still answers."""

    port, _, pool = servers
    with pool._lock:
        for path in ("/metrics", "/slo", "/requests", "/debug/arena", "/alerts",
                     "/traces", "/debug/flightrecorder"):
            assert _get(port, path)[0] == 200, path


def test_building_a_server_installs_nothing_process_wide(tiny):  # noqa: F811
    """``flight.install`` (SIGTERM and excepthook dumps) belongs to
    ``main()``; ``build_handler`` attaches to the recorder only, and
    the alert engine's thread is not started."""

    import signal
    import sys
    import threading

    _, _, model = tiny
    before = (signal.getsignal(signal.SIGTERM), sys.excepthook, threading.excepthook)
    server = serve_lm.Server(serve_lm.make_pool(model, slots=1, kv_block_size=16))
    try:
        assert (signal.getsignal(signal.SIGTERM), sys.excepthook,
                threading.excepthook) == before
        assert flight._installed is None
        assert server.alert_engine._thread is None
    finally:
        server.httpd.server_close()
    with pytest.raises(ValueError, match="make_pool"):
        serve_lm.Server(batching.PagedContinuousBatchingDecoder(model, slots=1,
                                                                kv_block_size=16))


# -- the hot-sync lint twin ---------------------------------------------------

#: the pools' steps (the contiguous window, the paged plain and
#: speculative windows), admission, growth, swap and records paths:
#: none may read a CUDA tensor outside a ``with ...dispatch(...)`` block
HOT_METHODS = {
    "step", "_plain_window", "_spec_window", "_seat_mask", "_count_spec",
    "_admit_fused", "_scatter", "_seat_row", "_observe_window",
    "_write_growth", "_grow_seats_locked", "_grow_row", "_alloc_blocks_locked",
    "_preempt_seat_locked", "_admit_swapped", "_plan_resume_locked",
    "_pick_victim_locked", "_demote_queued_locked", "_plan_admission",
    "_swap_out", "_swap_in", "_retire_device_locked", "_finish_locked",
    "_update_gauges_locked", "_update_kv_gauges", "_queued_blocks",
    "_observe_first_token", "_emit_span", "_count_swap_bytes",
    "_migrate_in_locked", "_fabric_host", "_count_migrate_bytes", "publish_to_fabric",
}
#: attribute calls that read a device tensor on the host
FORBIDDEN_ATTRS = {"item", "cpu", "tolist", "numpy"}


def _forbidden(call):
    f = call.func
    if isinstance(f, ast.Attribute):
        if f.attr in FORBIDDEN_ATTRS:
            return f.attr
        if f.attr == "synchronize" and isinstance(f.value, ast.Attribute) \
                and f.value.attr == "cuda":
            return "torch.cuda.synchronize"
    return None


def _dispatch_phase(node):
    """The phase of a ``with <...>.dispatch("<phase>", ...)`` statement,
    else None."""

    if not isinstance(node, ast.With):
        return None
    for item in node.items:
        e = item.context_expr
        if isinstance(e, ast.Call) and isinstance(e.func, ast.Attribute) \
                and e.func.attr == "dispatch" and e.args \
                and isinstance(e.args[0], ast.Constant):
            return e.args[0].value
    return None


#: the pool classes whose bodies the lint walks (the paged pool and the
#: contiguous pool it extends)
POOL_CLASSES = ("ContinuousBatchingDecoder", "PagedContinuousBatchingDecoder")


def find_hot_syncs(tree, methods, classes=POOL_CLASSES):
    offenders, seen = [], set()

    def visit(node, inside):
        if isinstance(node, ast.Call) and not inside:
            name = _forbidden(node)
            if name:
                offenders.append(f"{fn.name}:{node.lineno} {name}")
        if _dispatch_phase(node) is not None:
            # the header runs before the timed window opens
            for item in node.items:
                visit(item.context_expr, inside)
            for child in node.body:
                visit(child, True)
            return
        for child in ast.iter_child_nodes(node):
            visit(child, inside)

    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name in classes:
            for fn in node.body:
                if isinstance(fn, ast.FunctionDef) and fn.name in methods:
                    seen.add(fn.name)
                    for child in ast.iter_child_nodes(fn):
                        visit(child, False)
    return offenders, seen


def _pool_tree():
    with open(batching.__file__) as f:
        return ast.parse(f.read(), batching.__file__)


def test_no_device_reads_outside_dispatch_in_the_pool_hot_path():
    offenders, seen = find_hot_syncs(_pool_tree(), HOT_METHODS)
    assert seen == HOT_METHODS, f"renamed or gone: {HOT_METHODS - seen}"
    assert not offenders, offenders


def test_walker_catches_a_planted_sync():
    src = (
        "class PagedContinuousBatchingDecoder:\n"
        "    def step(self):\n"
        "        n = self._lengths_dev[0].item()\n"            # offender
        "        with self.dispatch('step'):\n"
        "            host = toks.cpu().numpy()\n"              # sanctioned
        "        with self.dispatch(x.tolist()[0]):\n"         # offender: header
        "            pass\n"
        "        torch.cuda.synchronize()\n"                   # offender
        "        return host.tolist()\n"                       # offender
        "    def helper(self):\n"
        "        return self._lengths_dev.cpu()\n"             # not hot: ignored
        "class Other:\n"
        "    def step(self):\n"
        "        return t.item()\n"                            # other class: ignored
    )
    offenders, seen = find_hot_syncs(ast.parse(src), {"step"})
    assert seen == {"step"}
    assert [o.split(" ")[1] for o in offenders] == ["item", "tolist", "torch.cuda.synchronize",
                                                    "tolist"]
    # and it catches a sync planted in each pool's real step
    tree = _pool_tree()
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == "step":
            node.body.insert(0, ast.parse("self._lengths_dev.cpu()").body[0])
    offenders, _ = find_hot_syncs(tree, HOT_METHODS)
    assert [o.split(" ")[1] for o in offenders] == ["cpu"] * len(POOL_CLASSES)


def test_dispatch_blocks_hold_the_fetches_they_time():
    """What serving_dispatch_seconds times on CUDA (utils/metrics.py):
    the step block holds the window's one fetch, the verify block the
    speculative window's, the admission and sample blocks their first
    token's, the swap and fabric-migration blocks their synchronous
    copies; the retire, draft, prefill and scatter blocks hold no fetch
    and time their enqueue."""

    holds = collections.defaultdict(set)
    for node in ast.walk(_pool_tree()):
        phase = _dispatch_phase(node)
        if phase is None:
            continue
        for child in ast.walk(ast.Module(body=node.body, type_ignores=[])):
            if isinstance(child, ast.Call):
                f = child.func
                holds[phase].add(f.attr if isinstance(f, ast.Attribute) else
                                 getattr(f, "id", ""))
    assert set(holds) == {"admission", "step", "draft", "verify", "retire", "swap_out",
                          "swap_in", "prefill", "sample", "scatter", "migrate_out",
                          "migrate_in"}
    assert "cpu" in holds["step"] and "cpu" in holds["verify"] and "int" in holds["admission"]
    assert "int" in holds["sample"]
    for phase in ("prefill", "scatter"):
        assert not holds[phase] & (FORBIDDEN_ATTRS | {"int", "_swap_out", "copy_"}), phase
    assert not holds["draft"] & (FORBIDDEN_ATTRS | {"int", "_swap_out", "copy_"})
    assert "_swap_out" in holds["swap_out"] and "_swap_in" in holds["swap_in"]
    assert "_swap_out" in holds["migrate_out"] and "_swap_in" in holds["migrate_in"]
    assert not holds["retire"] & (FORBIDDEN_ATTRS | {"int", "_swap_out", "copy_"})
    assert set(holds) <= set(metrics.DISPATCH_PHASES)
