"""The port's multi-replica and disaggregated serving against the JAX
package's, on the CPU (``llama_tiny``, float32, one bridged flax param
tree; the cases of ``tests/test_disaggregated.py``, each against the
port).

- Rows: a ``prefill=1,decode=1`` fleet of port pools over one
  ``PrefixFabric`` gives the rows of a uniform port pool, greedy and
  sampled, and the JAX fleet's greedy rows; ``PoolRouter`` over two port
  pools routes the same requests to the same replicas as over two JAX
  pools, with the same rows.
- Accounting: the decode replica never prefills (admission, step,
  retire, migrate_in only), the prefill replica never steps; internal
  publishes stay out of the SLO histograms; the autopsy names both
  replicas and counts the migrated blocks; route spans carry phase and
  role; the ``kv_blocks_*`` gauges split by role.
- Failures: a prefill replica dying mid-publish, or a driver that never
  steps, degrades to the decode replica recomputing (same rows, one
  counted failure); an evicted chain head with a live tail pulls without
  leaking; a fabric too small for the chain recomputes.
- ``serve_lm``: ``parse_roles`` and the fleet flags' errors are the JAX
  server's; a ``--roles`` server over HTTP answers as the JAX server
  does (the autopsy, ``/debug/arena``, ``/debug/fabric``, one merged TTFT
  row on ``/slo``, and the ``/metrics`` families but the JAX server's
  ``serve_pool_compiles`` and the cost plane's compile families); two
  port servers share blocks over HTTP, and a dead peer degrades to
  recompute.
"""

import json
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import jax

from tf_operator_tpu.models.batching import PagedContinuousBatchingDecoder as JaxPool
from tf_operator_tpu.models.pool_router import PoolRouter as JaxRouter
from tf_operator_tpu.models.prefix_cache import PrefixFabric as JaxFabric
from tf_operator_tpu.utils import metrics as j_metrics

from tf_operator_tpu_torch import serve_lm
from tf_operator_tpu_torch.models.batching import PagedContinuousBatchingDecoder
from tf_operator_tpu_torch.models.pool_router import PoolRouter
from tf_operator_tpu_torch.models.prefix_cache import PrefixFabric, chain_keys
from tf_operator_tpu_torch.utils.metrics import DispatchLedger, Metrics
from tf_operator_tpu_torch.utils.trace import Tracer

from test_torch_serving import tiny  # noqa: F401  (fixture)
from test_torch_serving_plane import COSTPLANE_FAMILIES, _get, _post

torch.set_num_threads(2)

VOCAB, MAX_LEN, BS = 256, 64, 16


class _Fleet:
    """1 prefill + 1 decode replica over one fabric, with a driver thread
    each (a disaggregated submit blocks on the prefill replica's
    publish, so something must step it).  ``make(role, label, fabric,
    ledger)`` builds a pool of either package."""

    def __init__(self, make, fabric, metrics, tracer=None, router_cls=PoolRouter):
        self.metrics, self.fabric = metrics, fabric
        self.prefill = make("prefill", "p0", fabric, tracer)
        self.decode = make("decode", "d0", fabric, tracer)
        self.router = router_cls([self.prefill, self.decode], tracer=tracer)
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._drive, args=(p,), daemon=True)
                         for p in (self.prefill, self.decode)]

    def _drive(self, pool):
        while not self._stop.is_set():
            if pool.step() == 0:
                time.sleep(0.002)

    def __enter__(self):
        for t in self._threads:
            t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        for t in self._threads:
            if t.is_alive():
                t.join(timeout=30)
        return False


def _port_fleet(model, metrics=None, tracer=None, slots=4, kv_blocks=None):
    metrics = metrics if metrics is not None else Metrics()
    fabric = PrefixFabric(metrics=metrics, model_label="t")

    def make(role, label, fab, tr):
        return PagedContinuousBatchingDecoder(
            model, slots=slots, kv_block_size=BS, kv_blocks=kv_blocks, metrics=metrics,
            ledger=DispatchLedger(metrics=metrics, tracer=tr), model_label="t",
            replica_label=label, role=role, fabric=fab)

    return _Fleet(make, fabric, metrics, tracer)


def _uniform(model, slots=4):
    return PagedContinuousBatchingDecoder(model, slots=slots, kv_block_size=BS)


def _mixed_trace(r, n=6):
    """Long prompts (multi-block, some sharing a system prefix) mixed with
    short single-block ones (``tests/test_disaggregated.py``'s)."""

    sys_prefix = r.randint(0, VOCAB, size=(32,)).astype(np.int32)
    trace = []
    for i in range(n):
        if i % 3 == 2:
            prompt = r.randint(0, VOCAB, size=(6,)).astype(np.int32)
        elif i % 2 == 0:
            tail = r.randint(0, VOCAB, size=(int(r.randint(3, 9)),))
            prompt = np.concatenate([sys_prefix, tail.astype(np.int32)])
        else:
            prompt = r.randint(0, VOCAB, size=(38,)).astype(np.int32)
        trace.append((prompt, int(r.choice([4, 8]))))
    return trace


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _fleet_rows(fleet, trace, temp=0.0):
    rids = [fleet.router.submit(p, b, temperature=temp, trace_id=f"ti-{j}",
                                generator=_gen(100 + j) if temp > 0 else None)
            for j, (p, b) in enumerate(trace)]
    return [fleet.router.result_wait(rid, timeout=300) for rid in rids]


def _uniform_rows(pool, trace, temp=0.0):
    rids = [pool.submit(p, b, temperature=temp, generator=_gen(100 + j) if temp > 0 else None)
            for j, (p, b) in enumerate(trace)]
    pool.run()
    return [pool.result(r) for r in rids]


@pytest.fixture(scope="module")
def jax_fleet_rows(tiny):  # noqa: F811
    """The JAX fleet's greedy rows on the greedy trace (its pools on the
    gather emulation)."""

    jm, params, _ = tiny
    trace = _mixed_trace(np.random.RandomState(11))
    metrics = j_metrics.Metrics()
    fabric = JaxFabric(metrics=metrics, model_label="t")

    def make(role, label, fab, tr):
        return JaxPool(jm, params, slots=4, kv_block_size=BS, paged_kernel="off",
                       metrics=metrics, ledger=j_metrics.DispatchLedger(metrics=metrics),
                       model_label="t", replica_label=label, role=role, fabric=fab)

    with _Fleet(make, fabric, metrics, router_cls=JaxRouter) as fleet:
        rids = [fleet.router.submit(p, b, trace_id=f"ti-{j}") for j, (p, b) in enumerate(trace)]
        rows = [fleet.router.result_wait(rid, timeout=600) for rid in rids]
    return trace, rows, fleet


@pytest.mark.parametrize("temp", [0.0, 0.9])
def test_disaggregated_rows_match_uniform_and_the_jax_fleet(tiny, jax_fleet_rows, temp):  # noqa: F811
    _, _, model = tiny
    trace, jrows, jfleet = jax_fleet_rows
    with _port_fleet(model) as fleet:
        rows = _fleet_rows(fleet, trace, temp)
    assert all(r is not None for r in rows)
    assert fleet.fabric.snapshot()["publishes"] > 0
    assert fleet.decode.ledger.count("migrate_in") > 0
    for got, want in zip(rows, _uniform_rows(_uniform(model), trace, temp)):
        assert np.array_equal(got, want), (got, want)
    if temp == 0.0:
        for got, want in zip(rows, jrows):
            assert np.array_equal(got, want), (got, want)
        # the same handshake: the same blocks published and pulled
        assert fleet.fabric.snapshot()["publishes"] == jfleet.fabric.snapshot()["publishes"]
        assert fleet.decode.ledger.count("migrate_in") == \
            jfleet.decode.ledger.snapshot()["migrate_in"]["count"]
    fleet.prefill.alloc.check()
    fleet.decode.alloc.check()


def test_decode_replica_never_prefills_and_the_prefill_replica_never_steps(tiny):  # noqa: F811
    _, _, model = tiny
    trace = _mixed_trace(np.random.RandomState(3))
    with _port_fleet(model) as fleet:
        rids = [fleet.router.submit(p, b, trace_id=f"da-{j}") for j, (p, b) in enumerate(trace)]
        outs = [fleet.router.result_wait(rid, timeout=300) for rid in rids]
    assert all(o is not None for o in outs)
    dec = {ph: v["count"] for ph, v in fleet.decode.ledger.snapshot().items()}
    pre = {ph: v["count"] for ph, v in fleet.prefill.ledger.snapshot().items()}
    assert set(dec) <= {"admission", "step", "retire", "migrate_in"}, dec
    assert dec["migrate_in"] > 0 and dec["admission"] == len(trace)
    assert set(pre) <= {"admission", "retire", "migrate_out"}, pre
    assert pre["migrate_out"] > 0 and fleet.prefill.windows == 0
    windows = sum(fleet.router.request_autopsy(f"da-{j}")["windows"] for j in range(len(trace)))
    assert windows >= dec["step"]


def test_internal_publishes_never_pollute_user_slo(tiny):  # noqa: F811
    _, _, model = tiny
    trace = _mixed_trace(np.random.RandomState(5), n=4)
    with _port_fleet(model) as fleet:
        for rid in [fleet.router.submit(p, b) for p, b in trace]:
            assert fleet.router.result_wait(rid, timeout=300) is not None
    for fam in ("serve_ttft_seconds", "serve_queue_wait_seconds",
                "serve_time_per_output_token_seconds"):
        series = fleet.metrics.histogram_family(fam)
        assert sum(s["count"] for s in series.values()) == len(trace), fam
        assert {dict(k)["role"] for k in series} == {"decode"}
    assert fleet.prefill.ledger.count("admission") > 0  # the internal requests ran


def test_autopsy_names_both_replicas_and_counts_migration(tiny):  # noqa: F811
    _, _, model = tiny
    tracer = Tracer(seed=0)
    r = np.random.RandomState(9)
    sys_prefix = r.randint(0, VOCAB, size=(32,)).astype(np.int32)
    long_prompt = np.concatenate([sys_prefix, r.randint(0, VOCAB, size=(5,)).astype(np.int32)])
    short_prompt = r.randint(0, VOCAB, size=(6,)).astype(np.int32)
    with _port_fleet(model, tracer=tracer) as fleet:
        rid_l = fleet.router.submit(long_prompt, 4, trace_id="long")
        rid_s = fleet.router.submit(short_prompt, 4, trace_id="short")
        assert fleet.router.result_wait(rid_l, timeout=300) is not None
        assert fleet.router.result_wait(rid_s, timeout=300) is not None
    a = fleet.router.request_autopsy("long")
    assert (a["prefill_replica"], a["decode_replica"], a["migrated_blocks"]) == ("p0", "d0", 2)
    assert a["dispatches"].get("migrate_in") == 1 and a["internal"] is False
    s = fleet.router.request_autopsy("short")
    assert (s["prefill_replica"], s["decode_replica"], s["migrated_blocks"]) == ("d0", "d0", 0)
    spans = tracer.store.trace("long")["spans"]
    phases = {sp["attributes"]["phase"]: sp["attributes"] for sp in spans
              if sp["name"] == "route"}
    assert set(phases) == {"prefill", "decode"}
    assert (phases["prefill"]["role"], phases["prefill"]["replica"]) == ("prefill", "p0")
    assert (phases["decode"]["role"], phases["decode"]["replica"]) == ("decode", "d0")
    assert any(sp["name"] == "migrate" for sp in spans)
    # the prefill replica's internal entry is the older one under the id
    internal = fleet.prefill.request_log.get("long")
    assert internal["internal"] is True and internal["tokens"] == 1


def test_role_labelled_pressure_gauges_and_timelines(tiny):  # noqa: F811
    _, _, model = tiny
    m = Metrics()
    with _port_fleet(model, metrics=m) as fleet:
        prompt = np.random.RandomState(2).randint(0, VOCAB, size=(40,)).astype(np.int32)
        assert fleet.router.result_wait(fleet.router.submit(prompt, 8), timeout=300) is not None
    series = m.gauge_series("kv_blocks_pressure")
    for rep, role in (("p0", "prefill"), ("d0", "decode")):
        assert any(dict(k).get("replica") == rep and dict(k).get("role") == role
                   for k in series), (rep, role, series)
    assert {s["role"] for s in fleet.router.arena_snapshots()} == {"prefill", "decode"}
    assert {s["replica"] for s in fleet.router.arena_snapshots()} == {"p0", "d0"}


def _reference_row(model, prompt, budget):
    pool = _uniform(model)
    rid = pool.submit(prompt, budget)
    pool.run()
    return pool.result(rid)


def test_prefill_death_mid_publish_degrades_to_local_recompute(tiny):  # noqa: F811
    _, _, model = tiny
    m = Metrics()
    prompt = np.random.RandomState(4).randint(0, VOCAB, size=(40,)).astype(np.int32)
    ref = _reference_row(model, prompt, 6)
    with _port_fleet(model, metrics=m) as fleet:
        def dead_publish(*a, **k):
            raise RuntimeError("prefill replica died mid-publish")

        fleet.prefill.publish_to_fabric = dead_publish
        out = fleet.router.result_wait(fleet.router.submit(prompt, 6), timeout=300)
    assert out is not None and np.array_equal(out, ref)
    assert m.counter("serve_fabric_publish_failures_total", model="t") == 1.0
    assert fleet.decode.ledger.count("migrate_in") == 0


def test_dead_prefill_driver_times_out_into_recompute(tiny):  # noqa: F811
    _, _, model = tiny
    m = Metrics()
    prompt = np.random.RandomState(8).randint(0, VOCAB, size=(40,)).astype(np.int32)
    ref = _reference_row(model, prompt, 6)
    fleet = _port_fleet(model, metrics=m)
    fleet.router.publish_timeout = 0.5
    fleet._threads[1].start()  # the decode driver only: nobody steps the prefill pool
    try:
        out = fleet.router.result_wait(fleet.router.submit(prompt, 6), timeout=300)
    finally:
        fleet.__exit__()
    assert out is not None and np.array_equal(out, ref)
    assert m.counter("serve_fabric_publish_failures_total", model="t") == 1.0


def test_evicted_head_with_live_tail_pulls_without_leaking(tiny):  # noqa: F811
    _, _, model = tiny
    prompt = np.random.RandomState(10).randint(0, VOCAB, size=(40,)).astype(np.int32)
    with _port_fleet(model) as fleet:
        assert fleet.router.result_wait(fleet.router.submit(prompt, 6), timeout=300) is not None
        with fleet.decode._lock:
            assert fleet.decode.prefix.evict_lru(need=1) == 1
        out2 = fleet.router.result_wait(fleet.router.submit(prompt, 6), timeout=300)
    assert out2 is not None and np.array_equal(out2, _reference_row(model, prompt, 6))
    fleet.decode.alloc.check()
    while fleet.decode.prefix.evict_lru(need=64):
        pass
    assert fleet.decode.alloc.in_use == 0


def test_fabric_capacity_eviction_degrades_to_recompute(tiny):  # noqa: F811
    _, _, model = tiny
    trace = _mixed_trace(np.random.RandomState(6), n=4)
    fleet = _port_fleet(model)
    fleet.fabric.capacity_blocks = 1
    with fleet:
        outs = [fleet.router.result_wait(rid, timeout=300)
                for rid in [fleet.router.submit(p, b) for p, b in trace]]
    assert fleet.fabric.snapshot()["evictions"] > 0
    for got, want in zip(outs, _uniform_rows(_uniform(model), trace)):
        assert np.array_equal(got, want)


def test_concurrent_submits_through_the_handshake_stay_exact(tiny):  # noqa: F811
    """Twelve threads submit at once through a disaggregated fleet, with
    a short switch interval: prompts that share a two-block prefix race
    their publishes on the one fabric.  Every row equals a uniform
    pool's, the router's ids are unique, each distinct chain key is
    published once, and both pools' allocators conserve their blocks."""

    import sys

    _, _, model = tiny
    r = np.random.RandomState(12)
    shared = r.randint(0, VOCAB, size=(32,)).astype(np.int32)
    trace = [(np.concatenate([shared, r.randint(0, VOCAB, size=(3 + i % 5,)).astype(np.int32)]),
              3 + i % 4) for i in range(12)]
    rids, errors = [None] * len(trace), []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with _port_fleet(model) as fleet:
            def submit(i):
                try:
                    rids[i] = fleet.router.submit(*trace[i])
                except Exception as exc:  # noqa: BLE001 - asserted below
                    errors.append(exc)

            threads = [threading.Thread(target=submit, args=(i,)) for i in range(len(trace))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            assert not errors and not any(t.is_alive() for t in threads)
            rows = [fleet.router.result_wait(rid, timeout=300) for rid in rids]
    finally:
        sys.setswitchinterval(old)
    assert len(set(rids)) == len(trace)
    for got, want in zip(rows, _uniform_rows(_uniform(model), trace)):
        assert np.array_equal(got, want)
    keys = {k for p, _ in trace for k in chain_keys(p, BS)}
    assert fleet.fabric.snapshot()["publishes"] == len(keys) == len(fleet.fabric)
    fleet.prefill.alloc.check()
    fleet.decode.alloc.check()


# -- the unified router against the JAX router -------------------------------


def _router_waves():
    r = np.random.default_rng(21)
    shared = r.integers(0, VOCAB, 16).astype(np.int32)
    mk = lambda n: r.integers(0, VOCAB, n).astype(np.int32)  # noqa: E731
    return [[(mk(9), 6), (np.concatenate([shared, mk(5)]), 8)],
            [(mk(30), 4), (np.concatenate([shared, mk(3)]), 5)],
            [(mk(5), 10), (mk(17), 3)]]


def test_router_routes_and_rows_match_the_jax_router(tiny):  # noqa: F811
    jm, params, model = tiny
    out = {}
    for side in ("port", "jax"):
        if side == "port":
            pools = [PagedContinuousBatchingDecoder(model, slots=2, steps_per_sync=4,
                                                    kv_block_size=BS, kv_blocks=12,
                                                    replica_label=str(i)) for i in range(2)]
            router = PoolRouter(pools)
        else:
            pools = [JaxPool(jm, params, slots=2, steps_per_sync=4, kv_block_size=BS,
                             kv_blocks=12, paged_kernel="off", replica_label=str(i))
                     for i in range(2)]
            router = JaxRouter(pools)
        rids, routes = [], []
        for wave in _router_waves():
            for prompt, budget in wave:
                rid = router.submit(prompt, budget)
                rids.append(rid)
                routes.append(router._route[rid][0])
            router.step_all()
        router.run()
        out[side] = (routes, [router.result(rid) for rid in rids])
    assert out["port"][0] == out["jax"][0]
    assert len(set(out["port"][0])) == 2  # both replicas served
    for got, want in zip(out["port"][1], out["jax"][1]):
        assert np.array_equal(got, want)


# -- serve_lm -----------------------------------------------------------------


ROLE_SPECS = ["prefill=1,decode=2", "unified=2", "prefill=2", "prefill=1,decode=x", "chef=1",
              "", "prefill=-1,decode=1", "decode=2", "prefill", " unified = 1 ,"]


@pytest.mark.parametrize("spec", ROLE_SPECS)
def test_parse_roles_matches_the_jax_server(spec):
    from tests.testutil import load_serve_lm

    outs = []
    for parse in (serve_lm.parse_roles, load_serve_lm().parse_roles):
        try:
            outs.append(parse(spec))
        except ValueError as exc:
            outs.append(("ValueError", str(exc)))
    assert outs[0] == outs[1]


FLEET_FLAG_ERRORS = {
    "replicas without batching": (["--replicas", "2"], "--replicas requires --batching SLOTS"),
    "roles without batching": (["--roles", "unified=2"], "--roles requires --batching SLOTS"),
    "bad roles": (["--batching", "2", "--roles", "decode=2"], "bad --roles: "),
    "roles against replicas": (["--batching", "2", "--roles", "prefill=1,decode=1",
                                "--replicas", "3"],
                               "--roles declares 2 replicas but --replicas says 3"),
    "peers without batching": (["--fabric-peers", ""], "--fabric-peers requires --batching SLOTS"),
    "port without batching": (["--fabric-port", "1"], "--fabric-port requires --batching SLOTS"),
}


@pytest.mark.parametrize("case", sorted(FLEET_FLAG_ERRORS))
def test_fleet_flags_exit_with_the_jax_messages(case):
    argv, want = FLEET_FLAG_ERRORS[case]
    args = serve_lm.build_parser().parse_args(["--device", "cpu"] + argv)
    with pytest.raises(SystemExit) as got:
        serve_lm.fleet_of(args)
    assert str(got.value).startswith(want)


def test_fleet_of_reads_the_injected_fabric_port(monkeypatch):
    parse = serve_lm.build_parser().parse_args
    monkeypatch.setenv(serve_lm.ENV_FABRIC_PORT, "7001")
    fleet = serve_lm.fleet_of(parse(["--batching", "2"]))
    assert (fleet["fabric_port"], fleet["fabric_peers"]) == (7001, [])
    # soft without --batching: a non-fleet invocation ignores it
    assert serve_lm.fleet_of(parse([]))["fabric_peers"] is None
    fleet = serve_lm.fleet_of(parse(["--batching", "2", "--roles", "prefill=1,decode=2",
                                     "--fabric-peers", "a:1, b:2"]))
    assert fleet == {"replicas": 3, "roles": ["prefill", "decode", "decode"],
                     "fabric_port": 7001, "fabric_peers": ["a:1", "b:2"]}


def test_speculative_fleet_builds_a_draft_arena_per_replica(tiny):  # noqa: F811
    """``--speculative --replicas 2``: every replica speculates with the one
    draft module and its own draft arena, as the JAX server hands each
    replica its ``spec_pool_kw``; a request through the router speculates
    on the replica it lands on."""

    _, _, model = tiny
    args = serve_lm.build_parser().parse_args(
        ["--device", "cpu", "--batching", "2", "--replicas", "2", "--speculative",
         "--speculative-force", "--spec-k", "2"])
    draft = serve_lm.load_model(model.device, max_len=MAX_LEN, quantize="int8",
                                what="speculative draft")
    router = serve_lm.build_decoder(model, args, draft=draft)
    pools = router.pools
    assert all(p.spec_enabled and p.spec_k == 2 for p in pools)
    assert pools[0]._draft_arena[0][0].data_ptr() != pools[1]._draft_arena[0][0].data_ptr()
    ptrs = [[t.data_ptr() for t in p._draft_pmodel.state_dict().values()] for p in pools]
    assert ptrs[0] == ptrs[1]  # one draft module's weights
    weights = pools[0].costplane.hbm.snapshot()["devices"][0]["components"]
    assert weights["kv_arena"] == sum(
        sum(t.nbytes for pair in arena for t in pair)
        for p in pools for arena in (p._arena, p._draft_arena))
    rid = router.submit(np.arange(1, 20, dtype=np.int32), 5, tier="interactive")
    router.run()
    assert router.result(rid) is not None
    assert sum(p.spec_windows for p in pools) > 0


def _families(text):
    """{family: {label keys, ...}} of an exposition's samples."""

    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name = line.split("{")[0].split(" ")[0]
        keys = frozenset(kv.split("=")[0] for kv in line.split("{", 1)[1].split("}")[0]
                         .split(",")) if "{" in line else frozenset()
        out.setdefault(name, set()).add(keys)
    return out


@pytest.fixture(scope="module")
def role_servers(tiny):  # noqa: F811
    """A ``--roles prefill=1,decode=1`` fleet behind the port's server and
    behind the JAX server's handler, over the same weights: (port's
    port, JAX server's port, the port's router)."""

    jm, params, model = tiny
    from tests.testutil import load_serve_lm

    handler = load_serve_lm().build_handler(jm, params, max_len=MAX_LEN, batching_slots=2,
                                            replicas=2, roles=["prefill", "decode"],
                                            paged_kernel="off")
    jserver = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=jserver.serve_forever, daemon=True).start()
    router = serve_lm.make_pool(model, slots=2, kv_block_size=BS, replicas=2,
                                roles=["prefill", "decode"])
    server = serve_lm.Server(router).start()
    try:
        yield server.port, jserver.server_address[1], router
    finally:
        server.close()
        jserver.shutdown()
        jserver.server_close()


def test_roles_server_answers_as_the_jax_server(role_servers):
    port, jport, router = role_servers
    body = {"prompt": "x" * 40, "max_new_tokens": 6}
    answers = [_post(p, body)[1] for p in (port, jport)]
    assert answers[0]["sample"] == answers[1]["sample"] and len(answers[0]["sample"]) == 6
    autopsies = [json.loads(_get(p, f"/requests/{a['request_id']}")[1])
                 for p, a in zip((port, jport), answers)]
    for a in autopsies:
        assert (a["prefill_replica"], a["decode_replica"], a["migrated_blocks"]) == ("0", "1", 2)
    assert sorted(autopsies[0]) == sorted(autopsies[1])
    # /requests lists what the JAX server lists: the user request on its
    # decode replica and the internal publish prefill, flagged, on the
    # prefill replica (/requests/<id> resolves to the newer, the user's)
    listings = [[(e["replica"], e["internal"], e["tokens"])
                 for e in json.loads(_get(p, "/requests")[1])["requests"]
                 if e["id"] == a["request_id"]] for p, a in zip((port, jport), answers)]
    assert listings[0] == listings[1] == [("1", False, 6), ("0", True, 1)]
    arenas = [json.loads(_get(p, "/debug/arena")[1]) for p in (port, jport)]
    for arena in arenas:
        assert arena["fabric"]["publishes"] >= 2
        assert {r["role"] for r in arena["replicas"]} == {"prefill", "decode"}
    assert sorted(arenas[0]["fabric"]) == sorted(arenas[1]["fabric"])
    fabrics = [_get(p, "/debug/fabric") for p in (port, jport)]
    assert fabrics[0][0] == fabrics[1][0] == 200
    assert sorted(json.loads(fabrics[0][1])) == sorted(json.loads(fabrics[1][1]))
    text = _get(port, "/metrics")[1].decode()
    for rep, role in (("0", "prefill"), ("1", "decode")):
        assert f'kv_blocks_pressure{{model="unknown",replica="{rep}",role="{role}"}}' in text
    assert 'kv_migrate_bytes_total{direction="in",transport="local"}' in text
    assert "kv_fabric_blocks" in text
    # a seeded request through the handshake: its generator on the fleet's
    # device, the same sample again
    seeded = {"prompt": "z" * 20, "max_new_tokens": 5, "temperature": 0.8, "seed": 7}
    assert _post(port, seeded)[1]["sample"] == _post(port, seeded)[1]["sample"]
    slo = json.loads(_get(port, "/slo")[1])
    rows = slo["histograms"]["serve_ttft_seconds"]
    assert slo["replicas"] == 2
    assert len(rows) == 1 and rows[0]["count"] == 3
    assert "role" not in rows[0] and "replica" not in rows[0]


def test_roles_server_metric_families_match_the_jax_server(role_servers):
    port, jport, _ = role_servers
    for p in (port, jport):
        _post(p, {"prompt": "y" * 37, "max_new_tokens": 3})
    got, want = [_families(_get(p, "/metrics")[1].decode()) for p in (port, jport)]

    def family(name):
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix):
                return name[: -len(suffix)]
        return name

    skip = COSTPLANE_FAMILIES | {"serve_pool_compiles"}
    want = {k: v for k, v in want.items() if family(k) not in skip}
    got = {k: v for k, v in got.items() if family(k) not in skip}
    assert got == want


def test_debug_fabric_404_without_a_fabric_is_the_jax_answer(tiny):  # noqa: F811
    _, _, model = tiny
    server = serve_lm.Server(serve_lm.make_pool(model, slots=2, kv_block_size=BS,
                                                replicas=2)).start()
    try:
        code, raw, _ = _get(server.port, "/debug/fabric")
        assert code == 404
        assert json.loads(raw) == {"error": "no prefix fabric (start with --roles "
                                            "prefill=... or --fabric-peers)"}
        assert _get(server.port, "/debug/arena")[0] == 200
        assert {"serving.pool0", "serving.pool1"} <= set(
            serve_lm.default_watchdog.heartbeats())
    finally:
        server.close()


def _pod(model, argv):
    """One ``serve_lm`` pod as ``main`` builds it (the decoder from the
    flags, the server, the fabric server), in this process."""

    args = serve_lm.build_parser().parse_args(["--device", "cpu", "--batching", "2",
                                               "--max-len", str(MAX_LEN)] + argv)
    fleet = serve_lm.fleet_of(args)
    server = serve_lm.Server(serve_lm.build_decoder(model, args)).start()
    return server, serve_lm.start_fabric_server(server, fleet)


def test_two_pods_share_blocks_over_http_and_a_dead_peer_recomputes(tiny):  # noqa: F811
    _, _, model = tiny
    a, fab_a = _pod(model, ["--fabric-port", "0", "--fabric-peers", ""])
    b, fab_b = _pod(model, ["--fabric-peers", fab_a.addr])
    prompt = "the cross-pod fabric shares this" + "!"  # 33 bytes: two full blocks
    pods = [a, b]
    try:
        got_a = _post(a.port, {"prompt": prompt, "max_new_tokens": 6})[1]
        got_b = _post(b.port, {"prompt": prompt, "max_new_tokens": 6})[1]
        assert got_a["sample"] == got_b["sample"]
        autopsy = json.loads(_get(b.port, f"/requests/{got_b['request_id']}")[1])
        assert autopsy["pulled_blocks"] == 2 and autopsy["fabric_peer"] == fab_a.addr
        assert autopsy["dispatches"]["migrate_in"] == 1
        assert "prefill" not in autopsy["dispatches"]
        text = _get(b.port, "/metrics")[1].decode()
        block = b.replicas[0]._block_host_bytes
        assert 'kv_fabric_pulls_total{model="llama-tiny",outcome="hit"} 2.0' in text
        assert f'kv_migrate_bytes_total{{direction="in",transport="http"}} {2.0 * block}' in text
        fabric = json.loads(_get(b.port, "/debug/fabric")[1])["fabric"]
        assert fabric["pulls"]["hit"] == 2 and fabric["peers"][0]["up"] is True
        # A gone: B's cached index still names the third block, which A
        # published for a longer prompt that B never saw
        longer = prompt + "w" * 16
        _post(a.port, {"prompt": longer, "max_new_tokens": 2})
        b.fabric.refresh_peers()
        fab_a.stop()
        a.close()
        fab_a, pods = None, [b]
        got = _post(b.port, {"prompt": longer, "max_new_tokens": 2})
        assert got[0] == 200
        text = _get(b.port, "/metrics")[1].decode()
        assert 'kv_fabric_pull_failures_total{model="llama-tiny",reason="peer_dead"}' in text
        fabric = json.loads(_get(b.port, "/debug/fabric")[1])["fabric"]
        assert fabric["pull_failures"]["peer_dead"] >= 1 and fabric["peers"][0]["up"] is False
    finally:
        for srv in (fab_a, fab_b):
            if srv is not None:
                srv.stop()
        for pod in pods:
            pod.close()
            if pod.fabric is not None:
                pod.fabric.stop()
