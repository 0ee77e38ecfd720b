"""The port's prefix-cache fabric, its wire and its HTTP tier against the
JAX package's, on the CPU (no model runs here: the arenas are zeros of a
``llama_tiny`` geometry).

- The wire: ``encode_block`` gives the JAX bytes for the same block, on a
  12-layer arena (the JAX leaves sort ``layer_10`` before ``layer_2``)
  in float32 and in bf16, and each side decodes the other's bytes.
- The codec's faults: each maps to its ``PULL_FAILURE_REASONS`` entry
  (the cases of ``tests/test_fabric_service.py``).
- ``FleetFabric`` and ``FabricServer``: a pull lands locally, a miss, the
  template, a stale index, a reset peer, a 500, announcements, the
  routes and their statuses; a JAX server serves the port's client and
  the port's server the JAX client.
- ``PrefixFabric``: the same put / get / pin / evict sequence gives the
  same snapshots in both packages; pins are leases.
- ``backend/retry``: the copy's budget and backoff are the JAX policy's.
"""

import dataclasses
import hashlib
import json
import random
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tf_operator_tpu.backend import retry as j_retry
from tf_operator_tpu.backend.kubesim import FaultInjector
from tf_operator_tpu.models import fabric_service as j_fs
from tf_operator_tpu.models import llama_tiny as j_llama_tiny
from tf_operator_tpu.models.batching import _decode_variant as j_decode_variant
from tf_operator_tpu.models.decode import paged_arena as j_paged_arena
from tf_operator_tpu.models.llama import LlamaLM as JaxLlama
from tf_operator_tpu.models.prefix_cache import PrefixFabric as JaxFabric
from tf_operator_tpu.utils.metrics import Metrics as JaxMetrics

from tf_operator_tpu_torch.backend import retry
from tf_operator_tpu_torch.models import fabric_service as fs
from tf_operator_tpu_torch.models.fabric_service import (
    PULL_FAILURE_REASONS,
    WIRE_VERSION,
    FabricServer,
    FleetFabric,
    PullError,
    arena_template,
    decode_block,
    encode_block,
)
from tf_operator_tpu_torch.models.prefix_cache import PrefixFabric, chain_keys
from tf_operator_tpu_torch.utils.metrics import Metrics

torch.set_num_threads(2)

KEY = chain_keys(np.arange(16), 16)[0]
KEY2 = chain_keys(np.arange(32), 16)[1]
KEY3 = chain_keys(np.arange(48), 16)[2]

#: the small arena of the codec cases: 2 layers, Hkv 2, bs 4, D 4
LAYERS, HKV, BS, D = 2, 2, 4, 4
NBYTES = LAYERS * 2 * HKV * BS * D * 4


def _arena(layers=LAYERS, dtype=torch.float32, num_blocks=8, hkv=HKV, bs=BS, d=D):
    return [(torch.zeros((num_blocks, hkv, bs, d), dtype=dtype),
             torch.zeros((num_blocks, hkv, bs, d), dtype=dtype)) for _ in range(layers)]


def _block(seed=0, layers=LAYERS):
    rng = np.random.default_rng(seed)
    return [tuple(rng.standard_normal((1, HKV, BS, D)).astype(np.float32) for _ in range(2))
            for _ in range(layers)]


def _fleet(local=None, peers=(), metrics=None, **kw):
    kw.setdefault("request_timeout", 5.0)
    fab = FleetFabric(local if local is not None else PrefixFabric(model_label="t"),
                      peers=peers, metrics=metrics if metrics is not None else Metrics(),
                      model_label="t", **kw)
    fab.register_template(_arena())
    return fab


def _fast_policy():
    """Zero backoff: a chaos case spends its retry budget at once."""

    return retry.fabric_pull_policy(base_delay=0.0, max_delay=0.0)


def _equal_blocks(got, want):
    assert len(got) == len(want)
    for (gk, gv), (wk, wv) in zip(got, want):
        np.testing.assert_array_equal(gk, wk)
        np.testing.assert_array_equal(gv, wv)


# -- the wire against the JAX package's -------------------------------------

#: the 12-layer llama_tiny geometry: the JAX leaves sort layer_10 and
#: layer_11 between layer_1 and layer_2
WIRE_LAYERS = 12


def _jax_arena(dtype):
    m = j_llama_tiny(vocab_size=256, max_len=64, dtype=dtype)
    m = JaxLlama(dataclasses.replace(m.cfg, n_layers=WIRE_LAYERS))
    return j_paged_arena(j_decode_variant(m), 3, 16)


def _jax_block(arena, seed):
    """A JAX record's tree: random rows where the arena has K/V leaves,
    scalars where it has its ``cache_index`` placeholders."""

    rng = np.random.default_rng(seed)

    def leaf(x):
        if x.ndim != 4:
            return np.zeros((), x.dtype)
        return rng.standard_normal((1,) + x.shape[1:]).astype(np.float32).astype(x.dtype)

    return jax.tree_util.tree_map(leaf, arena)


def _port_kv(tree):
    """The port's host form of a JAX record tree: per layer (K, V) in
    numeric order, bf16 as its uint16 words."""

    def host(a):
        a = np.asarray(a)
        return a.view(np.uint16) if str(a.dtype) == "bfloat16" else a

    return [(host(tree[f"layer_{i}"]["self_attn"]["cached_key"]),
             host(tree[f"layer_{i}"]["self_attn"]["cached_value"]))
            for i in range(WIRE_LAYERS)]


WIRE_DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dtype", sorted(WIRE_DTYPES))
def test_wire_bytes_match_the_jax_codec_both_ways(dtype):
    jdt, tdt = WIRE_DTYPES[dtype]
    jarena = _jax_arena(jdt)
    tree = _jax_block(jarena, 3)
    nbytes = sum(leaf.nbytes for leaf in jax.tree_util.tree_leaves(tree) if leaf.ndim == 4)
    kv = _port_kv(tree)
    assert fs.block_nbytes(kv) == nbytes
    want = j_fs.encode_block(KEY, {"kv": tree, "nbytes": nbytes})
    got = encode_block(KEY, {"kv": kv, "nbytes": nbytes})
    assert got == want
    header = json.loads(got[: got.index(b"\n")])
    assert {m["dtype"] for m in header["leaves"]} == {dtype}
    # the JAX order: layer_0, layer_1, layer_10, layer_11, layer_2, ...
    assert fs.wire_order(WIRE_LAYERS)[4:6] == [(10, 0), (10, 1)]
    # each side decodes the other's bytes
    parena = _arena(WIRE_LAYERS, tdt, num_blocks=3, hkv=2, bs=16, d=32)
    back, nb = decode_block(want, arena_template(parena))
    assert nb == nbytes
    _equal_blocks(back, kv)
    jleaves, jtreedef = jax.tree_util.tree_flatten(jarena)
    jtemplate = (jtreedef, [(x.ndim == 4, tuple(x.shape), str(np.dtype(x.dtype)))
                            for x in jleaves])
    jtree, jnb = j_fs.decode_block(got, jtemplate)
    assert jnb == nbytes
    for a, b in zip(jax.tree_util.tree_leaves(jtree), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_host_block_holds_bf16_as_its_words():
    t = torch.randn(1, HKV, BS, D).to(torch.bfloat16)
    ((k, v),) = fs.host_block([(t, t)])
    assert k.dtype == np.uint16 and k.shape == (1, HKV, BS, D)
    back = torch.from_numpy(k.view(np.int16)).view(torch.bfloat16)
    assert torch.equal(back, t)
    assert fs.wire_dtype(torch.bfloat16) == ("bfloat16", np.dtype(np.uint16))
    assert fs.wire_dtype("float32") == ("float32", np.dtype(np.float32))


# -- the codec's faults -------------------------------------------------------


def _body():
    return encode_block(KEY, {"kv": _block(1), "nbytes": NBYTES})


def _rewrite(body, edit):
    nl = body.index(b"\n")
    header = json.loads(body[:nl])
    edit(header)
    return json.dumps(header).encode() + body[nl:]


def test_roundtrip_header_and_payload():
    body = _body()
    header = json.loads(body[: body.index(b"\n")])
    assert header["v"] == WIRE_VERSION and header["key"] == KEY.hex()
    assert header["nbytes"] == NBYTES and len(header["leaves"]) == 2 * LAYERS
    kv, nbytes = decode_block(body, arena_template(_arena()))
    _equal_blocks(kv, _block(1))
    assert nbytes == NBYTES


def _lying_length_prefix(body):
    # the payload cut mid-leaf with an honest hash: the prefix lies
    nl = body.index(b"\n")
    header = json.loads(body[:nl])
    payload = body[nl + 1:][:200]
    header["sha256"] = hashlib.sha256(payload).hexdigest()
    return json.dumps(header).encode() + b"\n" + payload


def _bit_flip(body):
    b = bytearray(body)
    b[-1] ^= 0x40
    return bytes(b)


CODEC_FAULTS = {
    "bit_flip": (_bit_flip, "corrupt"),
    "wire_version": (lambda b: _rewrite(b, lambda h: h.update(v=WIRE_VERSION + 1)), "corrupt"),
    "lying_length_prefix": (_lying_length_prefix, "short_read"),
    "bad_dtype": (lambda b: _rewrite(b, lambda h: h["leaves"][0].update(dtype="not-a-dtype!!")),
                  "corrupt"),
    "leaf_count": (lambda b: _rewrite(b, lambda h: h.update(leaves=h["leaves"][:1])), "corrupt"),
    "unparseable_header": (lambda b: b"{not json\n" + b, "corrupt"),
    "wrong_dtype": (lambda b: _rewrite(b, lambda h: h["leaves"][0].update(dtype="float16")),
                    "corrupt"),
}


@pytest.mark.parametrize("fault", sorted(CODEC_FAULTS))
def test_codec_faults_map_to_their_reason(fault):
    mutate, reason = CODEC_FAULTS[fault]
    body = mutate(_body())
    with pytest.raises(PullError) as got:
        decode_block(body, arena_template(_arena()))
    assert got.value.reason == reason
    # the JAX codec reads the same fault the same way (the JAX-package
    # cases; a dtype name the JAX build knows is not a fault of its own)
    if fault not in ("wrong_dtype", "unparseable_header"):
        assert reason in j_fs.PULL_FAILURE_REASONS


def test_no_template_is_its_own_reason():
    with pytest.raises(PullError) as got:
        decode_block(b"{}\n", None)
    assert got.value.reason == "no_template"


def test_taxonomy_and_version_are_the_jax_ones():
    assert PULL_FAILURE_REASONS == j_fs.PULL_FAILURE_REASONS
    assert WIRE_VERSION == j_fs.WIRE_VERSION
    assert len(set(PULL_FAILURE_REASONS)) == len(PULL_FAILURE_REASONS)


# -- the client and server tiers ----------------------------------------------


def test_remote_pull_hit_lands_locally():
    A = _fleet()
    A.local.put(KEY, _block(1), NBYTES)
    srv = FabricServer(A).start()
    try:
        mB = Metrics()
        B = _fleet(peers=[srv.addr], metrics=mB)
        assert KEY in B and KEY not in B.local
        rec = B.get(KEY, pin=True)
        assert rec["transport"] == "http" and rec["peer"] == srv.addr
        assert rec["nbytes"] == NBYTES
        _equal_blocks(rec["kv"], _block(1))
        assert B.pulls == {"hit": 1, "miss": 0, "failed": 0}
        assert B.bytes_pulled == NBYTES
        assert mB.counter("kv_fabric_pulls_total", model="t", outcome="hit") == 1
        assert mB.gauge("kv_fabric_peer_up", peer=srv.addr) == 1.0
        B.unpin(KEY)
        again = B.get(KEY)
        assert again is not None and "transport" not in again and B.pulls["hit"] == 1
        snap = B.snapshot()
        assert snap["pulls"]["hit"] == 1 and snap["bytes_pulled"] == NBYTES
        assert snap["peers"][0]["up"] is True
    finally:
        srv.stop()


def test_fleet_wide_miss_counts_miss_and_local_only_counts_nothing():
    A = _fleet()
    srv = FabricServer(A).start()
    try:
        B = _fleet(peers=[srv.addr])
        assert B.get(KEY) is None
        assert B.pulls == {"hit": 0, "miss": 1, "failed": 0}
    finally:
        srv.stop()
    C = _fleet()
    assert C.get(KEY) is None
    assert C.pulls == {"hit": 0, "miss": 0, "failed": 0}


def test_pull_before_template_counts_no_template():
    A = _fleet()
    A.local.put(KEY, _block(1), NBYTES)
    srv = FabricServer(A).start()
    try:
        B = FleetFabric(PrefixFabric(model_label="t"), peers=[srv.addr], metrics=Metrics(),
                        model_label="t")
        assert B.get(KEY) is None
        assert B.pull_failures == {"no_template": 1} and B.pulls["failed"] == 1
    finally:
        srv.stop()


def test_stale_index_404_counts_not_found():
    A = _fleet(local=PrefixFabric(capacity_blocks=1, model_label="t"))
    A.local.put(KEY, _block(1), NBYTES)
    srv = FabricServer(A).start()
    try:
        mB = Metrics()
        B = _fleet(peers=[srv.addr], metrics=mB, index_ttl_seconds=3600.0)
        B.refresh_peers()
        A.local.put(KEY2, _block(2), NBYTES)  # evicts KEY behind B's cached index
        assert KEY not in A.local
        assert B.get(KEY) is None
        assert B.pulls == {"hit": 0, "miss": 0, "failed": 1}
        assert B.pull_failures == {"not_found": 1}
        assert mB.counter("kv_fabric_pull_failures_total", model="t", reason="not_found") == 1
        snap = B.snapshot()
        assert snap["peers"][0]["keys"] == 0 and snap["peers"][0]["up"] is True
    finally:
        srv.stop()


def test_peer_reset_mid_pull_counts_peer_dead_then_recovers():
    A = _fleet()
    A.local.put(KEY, _block(1), NBYTES)
    faults = FaultInjector(seed=7)
    srv = FabricServer(A, faults=faults).start()
    try:
        mB = Metrics()
        B = _fleet(peers=[srv.addr], metrics=mB, policy=_fast_policy())
        B.refresh_peers()
        faults.add(path="^/fabric/blocks/", mode="reset")
        assert B.get(KEY) is None
        assert B.pulls["failed"] == 1 and B.pull_failures == {"peer_dead": 1}
        assert mB.counter("kv_fabric_pull_failures_total", model="t", reason="peer_dead") == 1
        assert mB.gauge("kv_fabric_peer_up", peer=srv.addr) == 0.0
        assert faults.total_injected() >= 1
        faults.clear()
        rec = B.get(KEY)
        assert rec is not None and rec["transport"] == "http"
        assert mB.gauge("kv_fabric_peer_up", peer=srv.addr) == 1.0
    finally:
        srv.stop()


def test_http_500_counts_http_error_and_a_dead_peer_counts_peer_dead():
    A = _fleet()
    A.local.put(KEY, _block(1), NBYTES)
    faults = FaultInjector(seed=7)
    srv = FabricServer(A, faults=faults).start()
    B = _fleet(peers=[srv.addr], policy=_fast_policy(), index_ttl_seconds=3600.0)
    try:
        B.refresh_peers()
        faults.add(path="^/fabric/blocks/", mode="error", status=500)
        assert B.get(KEY) is None
        assert B.pull_failures == {"http_error": 1}
    finally:
        srv.stop()
    # the peer gone, its announced key still cached: refused connections
    assert B.get(KEY) is None
    assert B.pull_failures == {"http_error": 1, "peer_dead": 1}


def test_handle_publish_merges_and_discovers():
    B = _fleet()
    B.set_advertise("127.0.0.1:1")
    B.handle_publish({"advertise": "127.0.0.1:2", "keys": [KEY.hex(), "zz-not-hex"],
                      "generation": 3})
    assert B.snapshot()["peers"] == [
        {"peer": "127.0.0.1:2", "up": True, "keys": 1, "generation": 3}]
    B.handle_publish({"advertise": "127.0.0.1:1", "keys": [KEY2.hex()]})
    B.handle_publish({"keys": [KEY2.hex()]})
    assert len(B.snapshot()["peers"]) == 1


def test_put_announces_to_peers_over_the_wire():
    B = _fleet()
    srvB = FabricServer(B).start()
    B.set_advertise(srvB.addr)
    A = _fleet(peers=[srvB.addr])
    srvA = FabricServer(A).start()
    A.set_advertise(srvA.addr)
    try:
        A.put(KEY, _block(1), NBYTES)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            peers = {p["peer"]: p for p in B.snapshot()["peers"]}
            if peers.get(srvA.addr, {}).get("keys"):
                break
            time.sleep(0.01)
        else:
            pytest.fail("the announcement never reached the peer")
        rec = B.get(KEY)
        assert rec is not None and rec["peer"] == srvA.addr
    finally:
        A.stop()
        srvA.stop()
        srvB.stop()


def _status(url, data=None):
    try:
        req = urllib.request.Request(url, data=data, method="POST" if data else "GET")
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def test_server_routes_and_statuses():
    A = _fleet()
    A.local.put(KEY, _block(1), NBYTES)
    srv = FabricServer(A).start()
    A.set_advertise(srv.addr)
    try:
        code, body = _status(f"{srv.url}/fabric/index")
        idx = json.loads(body)
        assert code == 200 and idx == {"v": WIRE_VERSION, "model": "t", "advertise": srv.addr,
                                       "generation": 1, "keys": [KEY.hex()]}
        code, body = _status(f"{srv.url}/fabric/blocks/{KEY.hex()}")
        kv, nb = decode_block(body, A._template)
        assert code == 200 and nb == NBYTES
        _equal_blocks(kv, _block(1))
        assert A.local.snapshot()["pinned"] == 0  # the encode's pin released
        assert _status(f"{srv.url}/healthz") == (200, b"ok\n")
        for path, want in ((f"/fabric/blocks/{KEY2.hex()}", 404), ("/fabric/blocks/zz", 400),
                           ("/nope", 404)):
            assert _status(srv.url + path)[0] == want, path
        assert _status(f"{srv.url}/fabric/publish", b"not json")[0] == 400
        assert _status(f"{srv.url}/fabric/publish", b'{"keys": []}')[0] == 200
    finally:
        srv.stop()


# -- across the two packages over HTTP -----------------------------------------


def _jax_fleet(peers=()):
    fab = j_fs.FleetFabric(JaxFabric(model_label="t"), peers=peers, metrics=JaxMetrics(),
                           model_label="t", request_timeout=5.0)
    return fab


@pytest.mark.parametrize("dtype", sorted(WIRE_DTYPES))
def test_port_client_pulls_from_a_jax_server_and_the_reverse(dtype):
    jdt, tdt = WIRE_DTYPES[dtype]
    jarena = _jax_arena(jdt)
    tree = _jax_block(jarena, 5)
    nbytes = sum(leaf.nbytes for leaf in jax.tree_util.tree_leaves(tree) if leaf.ndim == 4)
    kv = _port_kv(tree)
    parena = _arena(WIRE_LAYERS, tdt, num_blocks=3, hkv=2, bs=16, d=32)
    # a JAX pod serves, the port pulls
    J = _jax_fleet()
    J.local.put(KEY, tree, nbytes)
    jsrv = j_fs.FabricServer(J).start()
    # a port pod serves, the JAX client pulls
    P = FleetFabric(PrefixFabric(model_label="t"), metrics=Metrics(), model_label="t")
    P.local.put(KEY2, kv, nbytes)
    psrv = FabricServer(P).start()
    try:
        B = FleetFabric(PrefixFabric(model_label="t"), peers=[jsrv.addr], metrics=Metrics(),
                        model_label="t", request_timeout=5.0)
        B.register_template(parena)
        rec = B.get(KEY)
        assert rec is not None and rec["transport"] == "http" and rec["nbytes"] == nbytes
        _equal_blocks(rec["kv"], kv)
        JB = _jax_fleet(peers=[psrv.addr])
        JB.register_template(jarena)
        jrec = JB.get(KEY2)
        assert jrec is not None and jrec["transport"] == "http" and jrec["nbytes"] == nbytes
        for a, b in zip(jax.tree_util.tree_leaves(jrec["kv"]), jax.tree_util.tree_leaves(tree)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        # the two servers' catalogs have the JAX document's keys
        code, body = _status(f"{psrv.url}/fabric/index")
        jcode, jbody = _status(f"{jsrv.url}/fabric/index")
        assert code == jcode == 200 and set(json.loads(body)) == set(json.loads(jbody))
    finally:
        jsrv.stop()
        psrv.stop()


# -- PrefixFabric against the JAX copy ---------------------------------------


def _fabric_sequence(fab, now):
    """One put / get / pin / evict / expiry sequence; the snapshots after
    each step."""

    snaps = []
    fab.put(KEY, "a", 10)
    fab.put(KEY2, "b", 20)
    snaps.append(fab.snapshot())
    fab.get(KEY, pin=True)  # pinned, and now the most recent
    fab.put(KEY3, "c", 30)  # over capacity: KEY2 goes
    snaps.append(fab.snapshot())
    fab.record(True)
    fab.record(False)
    fab.put(KEY3, "c", 30)  # idempotent
    snaps.append(fab.snapshot())
    now[0] = 11.0  # the lease expires
    fab.put(KEY2, "b", 20)  # KEY (LRU, no longer pinned) goes
    snaps.append(fab.snapshot())
    fab.get(KEY3, pin=True)
    fab.unpin(KEY3)
    snaps.append((fab.snapshot(), fab.index_keys(), len(fab), KEY in fab, KEY2 in fab))
    return snaps


def test_prefix_fabric_copy_gives_the_jax_snapshots():
    out = []
    for cls, reg in ((PrefixFabric, Metrics()), (JaxFabric, JaxMetrics())):
        now = [0.0]
        fab = cls(capacity_blocks=2, metrics=reg, model_label="t", pin_ttl_seconds=10.0,
                  clock=lambda: now[0])
        out.append((_fabric_sequence(fab, now), reg.exposition()))
    assert out[0] == out[1]


def test_live_lease_blocks_eviction_until_its_ttl():
    now = [0.0]
    fab = PrefixFabric(capacity_blocks=1, model_label="t", pin_ttl_seconds=10.0,
                       clock=lambda: now[0])
    fab.put(KEY, _block(1), NBYTES)
    assert fab.get(KEY, pin=True) is not None
    fab.put(KEY2, _block(2), NBYTES)
    assert KEY in fab and fab.snapshot()["pin_expiries"] == 0
    now[0] = 11.0
    fab.put(KEY3, _block(3), NBYTES)
    assert KEY not in fab
    snap = fab.snapshot()
    assert (snap["pin_expiries"], snap["pinned"], snap["blocks"]) == (1, 0, 1)


def test_unpin_releases_before_the_ttl_and_generation_stamps():
    fab = PrefixFabric(capacity_blocks=1, model_label="t", pin_ttl_seconds=10.0,
                       clock=lambda: 0.0)
    assert fab.index_keys() == ([], 0)
    fab.put(KEY, _block(1), NBYTES)
    fab.get(KEY, pin=True)
    fab.unpin(KEY)
    fab.put(KEY2, _block(2), NBYTES)
    assert KEY not in fab and KEY2 in fab and fab.snapshot()["pin_expiries"] == 0
    keys, gen = fab.index_keys()
    fab.put(KEY2, _block(2), NBYTES)  # idempotent: no bump, no count
    assert fab.index_keys() == (keys, gen) and fab.snapshot()["publishes"] == 2


# -- the retry copy ------------------------------------------------------------


class _Flaky:
    def __init__(self, failures, exc):
        self.failures, self.exc, self.calls = failures, exc, 0

    def __call__(self):
        self.calls += 1
        if self.calls <= self.failures:
            raise self.exc
        return "ok"


RETRY_CASES = {
    "recovers": (2, ConnectionRefusedError("refused")),
    "gives_up": (5, ConnectionResetError("reset")),
    "semantic_404": (1, type("E404", (Exception,), {"status": 404})()),
    "retry_after_503": (1, type("E503", (Exception,), {"status": 503, "retry_after": 0.5})()),
}


@pytest.mark.parametrize("case", sorted(RETRY_CASES))
def test_retry_copy_behaves_as_the_jax_policy(case):
    assert retry.FABRIC_PULL_POLICY_ARGS == j_retry.FABRIC_PULL_POLICY_ARGS
    assert retry.RETRYABLE_STATUS == j_retry.RETRYABLE_STATUS
    failures, exc = RETRY_CASES[case]
    runs = []
    for mod, reg in ((retry, Metrics()), (j_retry, JaxMetrics())):
        sleeps = []
        policy = mod.fabric_pull_policy(rng=random.Random(3), sleep=sleeps.append,
                                        clock=lambda: 0.0)
        fn = _Flaky(failures, exc)
        try:
            outcome = policy.call(fn, client="fabric", metrics=reg)
        except Exception as e:  # noqa: BLE001 - compared across the two
            outcome = type(e).__name__
        counts = {k: v for k, v in reg.counters_snapshot().items()
                  if "last_error_unixtime" not in k}  # a wall-clock stamp
        runs.append((outcome, fn.calls, sleeps, counts))
    assert runs[0] == runs[1]
