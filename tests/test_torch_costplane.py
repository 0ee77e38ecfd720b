"""The port's device cost plane (``tf_operator_tpu_torch/utils/costplane.py``)
against the JAX package's, on the CPU: the twin of ``tests/test_costplane.py``.

- The compile ledger: the same ``record`` / ``note`` / ``wrap`` calls give
  the same events, groupings and families; ``mirror`` keeps a server's
  registry in step with the process ledger.
- The accountant: the same component calls give the same rows and
  gauges; ``register_tree`` counts a storage once (a tied or viewed
  weight); ``program_tmp`` is the device's peak less the resident
  components, read at snapshot; the pool's ``kv_arena`` and the
  server's ``weights`` equal the JAX pool's and server's bytes for one
  tiny llama.
- The sentinel: the same observation sequences give the same snapshots
  and gauges; ``step-time-regression`` fires on the port's drift gauge
  through the port's alert engine, and ``compile-storm`` on the port's
  ledger, each with one flight-recorder dump; a clean soak fires nothing.
- ``serve_lm``'s ``/debug/compiles``, ``/debug/memory`` and
  ``/debug/profile`` answer with the JAX server's keys, statuses and
  errors (400, 404, 409, 503, and a profile on the CPU).
- A warmed pool replays new prompt widths with no new compile event.

Deliberate differences pinned here: on the CPU the live bytes are unknown
(``backend_bytes`` has no entry, coverage is None), so the coverage
contract (>= 0.95) is read on the card (``chip_smoke.py`` phase 7); the
port has no ``note_compiled`` (``program_tmp`` is read at snapshot);
the port's compile families are the process ledger's, mirrored into a
server's registry.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tf_operator_tpu.models.batching import PagedContinuousBatchingDecoder as JaxPool
from tf_operator_tpu.utils import alerts as j_alerts
from tf_operator_tpu.utils import costplane as j_cost
from tf_operator_tpu.utils import flight as j_flight
from tf_operator_tpu.utils import metrics as j_metrics

from tf_operator_tpu_torch import serve_lm
from tf_operator_tpu_torch.models.batching import PagedContinuousBatchingDecoder
from tf_operator_tpu_torch.ops import _build
from tf_operator_tpu_torch.utils import alerts, costplane, flight, metrics
from tf_operator_tpu_torch.utils.costplane import (
    HBM_COMPONENTS,
    CompileLedger,
    CostPlane,
    HBMAccountant,
    StepTimeSentinel,
    process_compile_count,
)

from test_torch_serving import servers, tiny  # noqa: F401  (fixtures)

torch.set_num_threads(2)

#: the storm client's widths (the JAX test's): every admission a new class
STORM_WIDTHS = (3, 5, 7, 9, 11, 13, 17, 19, 23, 29)


def _gauge(reg, family, **labels):
    for lab, v in reg.gauge_series(family).items():
        if dict(lab) == labels:
            return v
    return None


def _events(ledger):
    """The ledger's events without their wall-clock fields."""

    return [{k: v for k, v in e.items() if k not in ("when", "first_call_seconds")}
            for e in ledger.snapshot()["events"]]


def _ledgers():
    jm, pm = j_metrics.Metrics(), metrics.Metrics()
    return (jm, j_cost.CompileLedger(metrics=jm)), (pm, CompileLedger(metrics=pm))


# -- the compile ledger -----------------------------------------------------


def test_wrap_registers_exactly_the_first_call():
    arg = np.zeros((2, 3), np.float32)
    for _, led in _ledgers():
        calls = []

        def fn(x):
            calls.append(1)
            return x

        timed = led.wrap(fn, "pool.admit", trigger="width=4")
        for _ in range(3):
            timed(arg)
        assert len(calls) == 3 and led.total() == 1 and timed.__wrapped__ is fn
    (_, jl), (_, pl) = _ledgers()
    for led in (jl, pl):
        led.wrap(lambda x, y: x, "pool.admit", trigger="width=4")(
            arg, {"b": np.ones(5, np.int32)})
    assert _events(pl) == _events(jl)
    (ev,) = pl.snapshot()["events"]
    assert ev["shapes"] == ["f32[2,3]", "i32[5]"] and ev["first_call_seconds"] >= 0.0
    # a tensor is described as an array is
    assert costplane.abstract_shapes((torch.zeros(2, 3, dtype=torch.bfloat16),)) == [
        "bf16[2,3]"]


def test_note_counts_with_honestly_absent_wall():
    for _, led in _ledgers():
        ev = led.note("paged.swap_gather", trigger="ids=8")
        assert ev["first_call_seconds"] == 0.0 and led.total() == 1


def test_ring_is_bounded_and_newest_first():
    snaps = []
    for cls, reg in ((j_cost.CompileLedger, j_metrics.Metrics),
                     (CompileLedger, metrics.Metrics)):
        led = cls(metrics=reg(), ring=4)
        for i in range(6):
            led.record("p", trigger=f"width={i}")
        snap = led.snapshot()
        assert snap["total"] == 6 and len(led.snapshot(limit=2)["events"]) == 2
        snaps.append(([e["seq"] for e in snap["events"]], snap["byProgram"]))
    assert snaps[0] == snaps[1] and snaps[1][0] == [6, 5, 4, 3]


def test_snapshot_groups_by_program_and_trigger():
    bys = []
    for _, led in _ledgers():
        for prog, trig in (("paged.admit", "width=8"), ("paged.admit", "width=8"),
                           ("paged.admit", "width=16"), ("paged.step", "K=8")):
            led.record(prog, trigger=trig)
        bys.append(led.snapshot()["byProgram"])
    assert bys[0] == bys[1]
    assert bys[1]["paged.admit"]["byTrigger"] == {"width=8": 2, "width=16": 1}


def test_every_ledger_feeds_the_process_counter():
    before = process_compile_count()
    a, b = CompileLedger(metrics=metrics.Metrics()), CompileLedger(metrics=metrics.Metrics())
    a.record("x")
    b.record("y")
    b.note("z")
    assert process_compile_count() == before + 3
    assert a.snapshot()["processTotal"] >= before + 3


def test_compile_metrics_emitted_with_pinned_labels():
    regs = []
    for reg, led in _ledgers():
        led.record("paged.admit", trigger="width=8", seconds=0.25)
        led.record("csrc/paged_attention.cu", trigger="load", seconds=0.002)
        regs.append(reg)
    assert regs[1].exposition() == regs[0].exposition()
    series = regs[1].counter_series("compile_total")
    assert {dict(lab)["trigger"] for lab in series} == {"width=8", "load"}


def test_mirror_copies_the_ledger_families_and_keeps_them_in_step():
    own, server = metrics.Metrics(), metrics.Metrics()
    led = CompileLedger(metrics=own)
    led.record("csrc/paged_attention.cu", "nvcc", seconds=3.5)
    led.record("ops.paged_attention", "k_new=1,splits=2,bf16", seconds=0.01)
    plane = CostPlane(metrics=server, compiles=led)
    assert plane.compiles is led
    led.record("ops.quant_matmul", "route=kernel,bfloat16", seconds=0.02)
    for fam in ("compile_total", "compile_seconds"):
        assert server.exposition({fam}) == own.exposition({fam})
    assert server.counter("compile_total", program="ops.quant_matmul",
                          trigger="route=kernel,bfloat16") == 1.0
    led.mirror(server)  # a second mirror of the same registry adds nothing
    assert server.exposition({"compile_total"}) == own.exposition({"compile_total"})


# -- the accountant -----------------------------------------------------------


def test_unknown_component_is_a_programming_error():
    for acc in (j_cost.HBMAccountant(metrics=j_metrics.Metrics()),
                HBMAccountant(metrics=metrics.Metrics())):
        with pytest.raises(ValueError):
            acc.set_component("activations", 1)
        with pytest.raises(ValueError):
            acc.add_component("scratch", 1)
    assert HBM_COMPONENTS == j_cost.HBM_COMPONENTS


def test_snapshot_sorts_worst_headroom_first():
    rows = []
    for acc in (j_cost.HBMAccountant(metrics=j_metrics.Metrics(), limit_bytes=1000),
                HBMAccountant(metrics=metrics.Metrics(), limit_bytes=1000)):
        acc.set_component("weights", 600, device="dev:a")
        acc.add_component("kv_arena", 100, device="dev:b")
        acc.add_component("kv_arena", 50, device="dev:b")
        snap = acc.snapshot()
        # the JAX backend's own devices sort after both (headroom 1000)
        rows.append([r for r in snap["devices"] if r["device"].startswith("dev:")])
    assert rows[1] == rows[0]
    assert [r["device"] for r in rows[1]] == ["dev:a", "dev:b"]
    assert rows[1][0]["headroom_bytes"] == 400 and rows[1][1]["components"]["kv_arena"] == 150


def test_gauges_emitted_per_device_and_component():
    regs = []
    for reg, acc in ((j_metrics.Metrics(), j_cost.HBMAccountant),
                     (metrics.Metrics(), HBMAccountant)):
        acc(metrics=reg, limit_bytes=1000).set_component("weights", 600, device="dev:a")
        regs.append(reg)
    for fam in ("hbm_component_bytes", "hbm_device_limit_bytes", "hbm_headroom_bytes"):
        assert regs[1].gauge_series(fam) == regs[0].gauge_series(fam)
    assert _gauge(regs[1], "hbm_headroom_bytes", device="dev:a") == 400.0


def test_register_tree_accounts_host_leaves_and_counts_a_storage_once():
    tree = {"w": np.zeros(10, np.float32), "b": np.zeros(4, np.float32)}
    for acc in (j_cost.HBMAccountant(metrics=j_metrics.Metrics()),
                HBMAccountant(metrics=metrics.Metrics())):
        acc.register_tree("weights", tree)
        rows = {d["device"]: d for d in acc.snapshot()["devices"]}
        assert rows["host"]["components"]["weights"] == 56
    # a tied weight (one parameter under two modules) and a view count once
    emb = torch.nn.Embedding(16, 8)
    head = torch.nn.Linear(8, 16, bias=False)
    head.weight = emb.weight
    model = torch.nn.ModuleDict({"emb": emb, "head": head})
    acc = HBMAccountant(metrics=metrics.Metrics())
    acc.register_tree("weights", [model, {"view": emb.weight.data[:4]}])
    assert costplane.tree_device_bytes(model) == {"cpu": 16 * 8 * 4}
    rows = {d["device"]: d for d in acc.snapshot()["devices"]}
    assert rows["cpu"]["components"]["weights"] == 16 * 8 * 4
    assert rows["cpu"]["backend_bytes"] is None and rows["cpu"]["coverage"] is None


def test_program_tmp_is_the_peak_less_the_resident(monkeypatch):
    """The port's counterpart of ``note_compiled``'s peak: read at
    snapshot from the device's ``max_memory_allocated``; a later, lower
    peak replaces it (a peak, never a sum); it counts toward headroom
    and not toward coverage."""

    peaks = {"cuda:0": 1000}
    monkeypatch.setattr(HBMAccountant, "peak_bytes", staticmethod(peaks.get))
    monkeypatch.setattr(HBMAccountant, "backend_bytes", staticmethod(lambda: {"cuda:0": 650}))
    acc = HBMAccountant(metrics=metrics.Metrics(), limit_bytes=2000)
    acc.set_component("weights", 600, device="cuda:0")
    acc.add_component("kv_arena", 50, device="cuda:0")
    (row,) = acc.snapshot()["devices"]
    assert row["components"]["program_tmp"] == 350
    assert row["headroom_bytes"] == 2000 - 1000 and row["coverage"] == 1.0
    peaks["cuda:0"] = 800
    (row,) = acc.snapshot()["devices"]
    assert row["components"]["program_tmp"] == 150


def test_device_limit_is_read_once_and_cached(monkeypatch):
    calls = []

    def mem_get_info(idx):
        calls.append(idx)
        return (10, 80)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    reg = metrics.Metrics()
    acc = HBMAccountant(metrics=reg)
    for n in range(5):
        acc.set_component("swap_staging", n, device="cuda:0")
    assert calls == [0] and _gauge(reg, "hbm_device_limit_bytes", device="cuda:0") == 80.0
    assert _gauge(reg, "hbm_headroom_bytes", device="cuda:0") == 76.0
    assert acc.device_limit("host:0") is None


def test_pool_arena_and_server_weights_equal_the_jax_bytes(tiny, servers):  # noqa: F811
    jm, params, model = tiny
    jcp = j_cost.CostPlane(metrics=j_metrics.Metrics())
    JaxPool(jm, params, slots=2, kv_block_size=8, kv_blocks=24, paged_kernel="off",
            costplane=jcp)
    jcp.hbm.register_tree("weights", params)
    pool = serve_lm.make_pool(model, slots=2, kv_block_size=8, kv_blocks=24)

    def bytes_of(snap, comp):
        return sum(d["components"][comp] for d in snap["devices"])

    # the JAX arena tree also holds one int32 cache_index placeholder a
    # layer; the port's arena is the K and V blocks alone
    placeholders = 4 * model.cfg.n_layers
    jsnap, psnap = jcp.hbm.snapshot(), pool.costplane.hbm.snapshot()
    assert bytes_of(psnap, "kv_arena") == bytes_of(jsnap, "kv_arena") - placeholders > 0
    assert bytes_of(psnap, "weights") == bytes_of(jsnap, "weights") > 0
    assert bytes_of(psnap, "weights") == sum(
        t.numel() * t.element_size() for t in model.state_dict().values())
    # the servers' accountants, over HTTP: the same weights and arena
    port, jport, _ = servers
    got, want = [json.loads(_get(p, "/debug/memory")[1]) for p in (port, jport)]
    assert sorted(got) == sorted(want)
    assert bytes_of(got, "kv_arena") == bytes_of(want, "kv_arena") - placeholders
    assert bytes_of(got, "weights") == bytes_of(want, "weights")


# -- the sentinel ---------------------------------------------------------------


SENTINEL_SEQUENCES = {
    "freeze": [("decode.window", 0.1)] * 4 + [("decode.window", 0.4)] * 10,
    "drift": [("decode.window", 0.1)] * 4 + [("decode.window", 0.2)] * 8,
    "p99-jitter": [("decode.window", 0.1)] * 4 + [("decode.window", dt) for dt in (
        0.1, 0.1, 5.0, 0.1, 0.1, 5.0, 0.1, 0.1)],
    "two-signals": [(sig, dt) for i in range(9) for sig, dt in (
        ("train_sync", 0.01 * (i + 1)), ("decode.window", 0.2 + 0.01 * (i % 3)))],
}


@pytest.mark.parametrize("case", sorted(SENTINEL_SEQUENCES))
def test_sentinel_snapshots_equal_the_jax_copy(case):
    jm, pm = j_metrics.Metrics(), metrics.Metrics()
    js = j_cost.StepTimeSentinel(metrics=jm, window=8, warmup=4)
    ps = StepTimeSentinel(metrics=pm, window=8, warmup=4)
    for sig, dt in SENTINEL_SEQUENCES[case]:
        js.observe(sig, dt)
        ps.observe(sig, dt)
        assert ps.reference(sig) == js.reference(sig)
    assert ps.snapshot() == js.snapshot()
    assert pm.exposition() == jm.exposition()
    if case == "drift":
        assert _gauge(pm, "step_time_drift_ratio", signal="decode.window") == pytest.approx(2.0)
    if case == "p99-jitter":
        assert _gauge(pm, "step_time_p99_seconds", signal="decode.window") == 5.0
        assert _gauge(pm, "step_time_drift_ratio", signal="decode.window") == pytest.approx(1.0)


def test_reset_rebaselines_a_signal():
    s = StepTimeSentinel(metrics=metrics.Metrics(), window=8, warmup=4)
    for _ in range(6):
        s.observe("train_sync", 0.1)
        s.observe("decode.window", 0.2)
    s.reset("train_sync")
    assert s.reference("train_sync") is None and "train_sync" not in s.snapshot()
    assert s.reference("decode.window") is not None
    s.reset()
    assert s.snapshot() == {}


# -- the stock rules go live on the port's families -----------------------------


def _engines(tmp_path, monkeypatch):
    """(JAX side, port side): each a registry, an alert engine over the
    stock rules with shrunk windows, and a recorder."""

    monkeypatch.setenv("TPUJOB_FLIGHT_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(flight.tempfile, "gettempdir", lambda: str(tmp_path / "port"))
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    out = []
    for mod_m, mod_a, mod_f in ((j_metrics, j_alerts, j_flight), (metrics, alerts, flight)):
        reg = mod_m.Metrics()
        rec = mod_f.FlightRecorder()
        rec.attach_metrics(reg)
        out.append((reg, mod_a.AlertEngine(mod_a.default_rules(short=0.5, long=1.5),
                                           metrics=reg, recorder=rec)))
    return out


def test_compile_storm_fires_on_the_port_ledger_once(tmp_path, monkeypatch):
    sides = _engines(tmp_path, monkeypatch)
    t0 = time.time()
    states = []
    for (reg, engine), ledger_cls in zip(sides, (j_cost.CompileLedger, CompileLedger)):
        ledger = ledger_cls(metrics=reg)
        engine.evaluate_once(now=t0)
        for w in STORM_WIDTHS:
            ledger.wrap(lambda ids: ids, "paged.admit", trigger=f"width={w}")(
                np.zeros((w,), np.int32))
        engine.evaluate_once(now=t0 + 0.05)
        fired = engine.alert("compile-storm").state
        engine.evaluate_once(now=t0 + 2.0)
        states.append((fired, engine.alert("compile-storm").state, len(engine.dumps)))
        prog = ledger.snapshot()["byProgram"]["paged.admit"]
        assert prog["byTrigger"] == {f"width={w}": 1 for w in STORM_WIDTHS}
    assert states[1] == states[0] == ("firing", "resolved", 1)
    records = [json.loads(x) for x in open(sides[1][1].dumps[0])]
    assert records[0]["reason"] == "alert-compile-storm"


def test_step_time_regression_fires_on_the_port_drift_gauge(tmp_path, monkeypatch):
    sides = _engines(tmp_path, monkeypatch)
    t0 = time.time()
    states = []
    for (reg, engine), cls in zip(sides, (j_cost.StepTimeSentinel, StepTimeSentinel)):
        sentinel = cls(metrics=reg, window=8, warmup=4)
        for _ in range(4):
            sentinel.observe("decode.window", 0.1)
        engine.evaluate_once(now=t0)
        before = engine.alert("step-time-regression").state
        for _ in range(8):
            sentinel.observe("decode.window", 0.2)
        engine.evaluate_once(now=t0 + 0.1)
        states.append((before, engine.alert("step-time-regression").state, len(engine.dumps)))
    assert states[1] == states[0] == ("inactive", "firing", 1)


def test_clean_soak_with_boot_compiles_fires_nothing(tmp_path, monkeypatch):
    (_, _), (reg, engine) = _engines(tmp_path, monkeypatch)
    fired = []
    engine.subscribe(lambda a, old, new: fired.append((a.rule.name, new)))
    ledger = CompileLedger(metrics=reg)
    t0 = time.time()
    engine.evaluate_once(now=t0)
    # a card boot's records: four builds and loads, a handful of classes
    for name in _build.sources():
        ledger.record(f"csrc/{name}.cu", "nvcc", seconds=20.0)
        ledger.record(f"csrc/{name}.cu", "load", seconds=0.01)
    sentinel = StepTimeSentinel(metrics=reg, window=8, warmup=4)
    for _ in range(16):
        sentinel.observe("decode.window", 0.01)
    for dt in (0.1, 0.3, 0.6, 1.0, 2.0, 4.0):
        engine.evaluate_once(now=t0 + dt)
    assert all(a.state == "inactive" for a in engine.alerts())
    assert fired == [] and engine.dumps == []


# -- serve_lm's endpoints against the JAX server's ---------------------------


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                 data=json.dumps(body).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_servers_debug_compiles_and_memory_keys(servers):  # noqa: F811
    port, jport, pool = servers
    for p in (port, jport):
        _post(p, {"prompt": "cost plane ", "max_new_tokens": 4})
    for path in ("/debug/compiles", "/debug/memory"):
        got, want = [json.loads(_get(p, path)[1]) for p in (port, jport)]
        assert sorted(got) == sorted(want), path
    got, want = [json.loads(_get(p, "/debug/memory")[1]) for p in (port, jport)]
    assert sorted(got["devices"][0]) == sorted(want["devices"][0])
    assert set(got["devices"][0]["components"]) == set(HBM_COMPONENTS)
    compiles = json.loads(_get(port, "/debug/compiles")[1])
    # the server serves the process ledger, where the kernels record
    assert compiles["total"] == costplane.default_costplane.compiles.total()
    assert pool.costplane.compiles is costplane.default_costplane.compiles


@pytest.fixture
def profile_servers(tiny, tmp_path, monkeypatch):  # noqa: F811
    """A fresh port server and JAX handler (idle pools), artifacts under
    ``tmp_path``."""

    from http.server import ThreadingHTTPServer

    from tests.testutil import load_serve_lm
    from tf_operator_tpu_torch.device import resolve_device

    jm, params, model = tiny
    monkeypatch.setenv("TPUJOB_PROFILE_DIR", str(tmp_path))
    handler = load_serve_lm().build_handler(jm, params, max_len=64, batching_slots=1,
                                            paged_kernel="off")
    jserver = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=jserver.serve_forever, daemon=True).start()
    server = serve_lm.Server(serve_lm.make_pool(model, slots=1, kv_block_size=16)).start()
    assert resolve_device("cpu").type == "cpu"
    try:
        yield server.port, jserver.server_address[1]
    finally:
        server.close()
        jserver.shutdown()
        jserver.server_close()


def test_debug_profile_answers_as_the_jax_server(profile_servers, tmp_path):
    port, jport = profile_servers
    for path, code in (("/debug/profile?seconds=abc", 400), ("/debug/profile?seconds=0", 400),
                       ("/debug/profile?seconds=31", 400), ("/debug/profile", 503),
                       ("/debug/profileX", 404)):
        got, want = [_get(p, path) for p in (port, jport)]
        assert got[0] == want[0] == code, path
        if code != 404:
            assert json.loads(got[1]) == json.loads(want[1]), path
    answers = {}
    for p in (port, jport):
        # eight long requests through the one seat keep the loop busy for
        # the whole capture, which starts as soon as one is queued
        gens = [threading.Thread(target=_post, args=(p, {"prompt": f"profile me {i} ",
                                                         "max_new_tokens": 48}))
                for i in range(8)]
        for t in gens:
            t.start()
        deadline = time.time() + 30
        while time.time() < deadline:
            status, body = _get(p, "/debug/profile?seconds=0.5")
            if status != 503:
                break
            time.sleep(0.005)
        for t in gens:
            t.join(timeout=120)
        assert status == 200, body
        answers[p] = json.loads(body)
    got, want = answers[port], answers[jport]
    assert sorted(got) == sorted(want) and sorted(got["costplane"]) == sorted(want["costplane"])
    art = got["artifact"]
    assert os.path.dirname(art) == str(tmp_path)
    assert os.path.basename(art).startswith(
        f"serve-profile-c{got['costplane']['compiles_at_start']}-")
    assert sorted(os.listdir(art)) == ["COSTPLANE.json", "trace.json"]
    with open(os.path.join(art, "trace.json")) as f:
        trace = json.load(f)
    # the driver thread's ops are in the trace (on the CPU the capture
    # records every thread, from the request's)
    assert any(str(e.get("name", "")).startswith("aten::") for e in trace["traceEvents"])
    with open(os.path.join(art, "COSTPLANE.json")) as f:
        assert json.load(f) == got["costplane"]


def test_debug_profile_is_refused_while_another_capture_runs(tiny):  # noqa: F811
    """409 while the capture lock is held, checked after the idle check
    (a queued request makes the loop busy: no driver runs here)."""

    from http.server import ThreadingHTTPServer

    _, _, model = tiny
    pool = serve_lm.make_pool(model, slots=1, kv_block_size=16)
    handler = serve_lm.build_handler(pool, [])
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        assert _get(httpd.server_address[1], "/debug/profile")[0] == 503
        pool.submit(np.arange(5, dtype=np.int32), 3)
        with handler.profiler.busy:
            code, body = _get(httpd.server_address[1], "/debug/profile?seconds=1")
        assert code == 409 and "already running" in json.loads(body)["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_the_decode_loop_keeps_stepping_while_a_capture_stops(tiny, tmp_path,  # noqa: F811
                                                             monkeypatch):
    """The capture starts, stops and exports on the request's thread:
    while its stop runs, the pool's driver thread completes windows (a
    stop on the driver thread would hold them, and this one would wait
    out its deadline with none)."""

    _, _, model = tiny
    monkeypatch.setenv("TPUJOB_PROFILE_DIR", str(tmp_path))
    pool = serve_lm.make_pool(model, slots=1, steps_per_sync=2, kv_block_size=16)
    real, grew = serve_lm._profiler, []

    def slow_stop(device):
        prof = real(device)
        stop = prof.__exit__

        def __exit__(*exc):
            w0, deadline = pool.windows, time.monotonic() + 60
            while pool.windows < w0 + 2 and time.monotonic() < deadline:
                time.sleep(0.005)
            grew.append(pool.windows - w0)
            return stop(*exc)

        prof.__exit__ = __exit__
        return prof

    monkeypatch.setattr(serve_lm, "_profiler", slow_stop)
    server = serve_lm.Server(pool).start()
    try:
        rids = [pool.submit(np.arange(1, 9, dtype=np.int32) + i, 48) for i in range(12)]
        status, body = _get(server.port, "/debug/profile?seconds=0.1")
        assert status == 200, body
        assert grew and grew[0] >= 2
        last = server.profiler.last
        assert last["stop_s"] > 0 and last["stopping"][0] == last["recording"][1]
        for rid in rids:
            assert pool.result_wait(rid, timeout=120) is not None
    finally:
        server.close()


def test_the_device_gate_quiets_its_workers_and_holds_new_ones_out():
    """``quiet()`` waits for the workers inside ``work()`` and keeps a
    worker that arrives meanwhile waiting until it ends."""

    gate, order = serve_lm.DeviceGate(), []
    inside, release = threading.Event(), threading.Event()

    def worker():
        with gate.work():
            inside.set()
            release.wait(10)
            order.append("first worker out")

    def quieter():
        with gate.quiet():
            order.append("quiet in")
            time.sleep(0.2)
            order.append("quiet out")

    def late():
        with gate.work():
            order.append("late worker in")

    threads = [threading.Thread(target=worker)]
    threads[0].start()
    assert inside.wait(10)
    threads.append(threading.Thread(target=quieter))
    threads[1].start()
    deadline = time.monotonic() + 10
    while not gate._waiting and time.monotonic() < deadline:
        time.sleep(0.001)
    threads.append(threading.Thread(target=late))
    threads[2].start()
    time.sleep(0.1)
    assert order == []
    release.set()
    for t in threads:
        t.join(10)
    assert order == ["first worker out", "quiet in", "quiet out", "late worker in"]


def test_a_card_capture_starts_and_stops_with_the_device_work_quiet(monkeypatch, tmp_path):
    """On a card the profiler's start and stop each run inside
    ``DEVICE_GATE.quiet()`` after a device synchronize, so a decode
    window in flight finishes first; the recording lets workers in."""

    marks = []

    class Profiler:
        def __enter__(self):
            marks.append(("start", serve_lm.DEVICE_GATE._quiet))

        def __exit__(self, *exc):
            marks.append(("stop", serve_lm.DEVICE_GATE._quiet))

        def export_chrome_trace(self, path):
            open(path, "w").close()

    monkeypatch.setattr(serve_lm, "_profiler", lambda device: Profiler())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: marks.append("sync"))
    window_out = threading.Event()

    def window():
        with serve_lm.DEVICE_GATE.work():
            time.sleep(0.2)
            marks.append("window out")
        window_out.set()

    t = threading.Thread(target=window)
    t.start()
    time.sleep(0.05)
    capture = serve_lm.ProfileCapture(torch.device("cuda"))
    capture.capture(0.3, str(tmp_path / "trace.json"))
    t.join(10)
    assert marks == ["window out", "sync", ("start", True), "sync", ("stop", True)]
    assert not serve_lm.DEVICE_GATE._quiet
    with serve_lm.DEVICE_GATE.work():  # the gate is open again
        pass


# -- a warmed pool records no compile event on new prompt widths ------------------


def test_warmed_pool_replays_new_widths_with_no_compile_event(tiny):  # noqa: F811
    """The twin of the JAX steady-state pin: after a warm batch, a second
    batch of NEW prompt widths records nothing in the process ledger, and
    the pool registers no compile of its own (eager PyTorch builds no
    program per width).  On the CPU no kernel launches, so the warm batch
    records nothing either; ``tests/test_torch_cuda.py`` pins the card's
    K4 classes the same way."""

    _, _, model = tiny
    pool = PagedContinuousBatchingDecoder(model, slots=4, steps_per_sync=4, kv_block_size=16,
                                          metrics=metrics.Metrics())
    ledger = costplane.default_costplane.compiles
    r = np.random.default_rng(3)

    def batch(lens):
        rids = [pool.submit(r.integers(0, 256, n).astype(np.int32), 6) for n in lens]
        pool.run()
        return [pool.result(rid) for rid in rids]

    before = ledger.total()
    assert all(len(out) > 0 for out in batch([5, 17, 33]))
    assert ledger.total() == before
    assert all(len(out) > 0 for out in batch([6, 19, 40, 2]))
    assert ledger.total() == before, ledger.snapshot(limit=8)["events"]
    assert pool.costplane.compiles.total() == 0
