"""The port's contiguous slot pool (``ContinuousBatchingDecoder``) and
``serve_lm``'s fallback to it, against the JAX package's, on the CPU
(``llama_tiny``, float32, one bridged flax param tree).

The load-bearing property is slot isolation: a request's tokens are the
same alone or interleaved with others, whatever slot it takes, across
the rolling cache's wrap too.  Beside it: rows equal ``generate`` and
the JAX pool's (full cache and rolling window), with the JAX pool's
dispatch phases and counts (``admission`` and ``step``; a rolling cache's
staged ``prefill``, ``sample`` and ``scatter``); staggered arrivals,
more requests than slots, ``result_wait``, sampling, top_k, int8
weights, threaded submitters beside a driver thread, the SLO
observations, an admission failure that requeues, the staging permits.
``serve_lm --batching`` on a windowed ``model.json`` artifact prints
the JAX server's fallback line and serves the contiguous pool;
``--speculative`` there is refused with the JAX server's message.

Deliberate difference pinned here: without a rolling cache the port
admits at the prompt's exact length (the JAX pool pads to a power of
two and rolls its index back): the same greedy tokens.  The port's pool
registers its slot stack as ``kv_arena`` on its cost plane.
"""

import json
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from tf_operator_tpu.models import llama_tiny as j_llama_tiny
from tf_operator_tpu.models.batching import ContinuousBatchingDecoder as JaxSlotPool
from tf_operator_tpu.models.registry import describe_model
from tf_operator_tpu.utils import metrics as j_metrics

from tf_operator_tpu_torch import serve_lm
from tf_operator_tpu_torch.device import resolve_device
from tf_operator_tpu_torch.models.batching import (
    TOP_K_MAX,
    ContinuousBatchingDecoder,
)
from tf_operator_tpu_torch.models.decode import generate, window_chunks
from tf_operator_tpu_torch.models.llama import LlamaLM, llama_tiny
from tf_operator_tpu_torch.models.weights import from_flax_params
from tf_operator_tpu_torch.ops.quant import quantize_state
from tf_operator_tpu_torch.utils import metrics

torch.set_num_threads(2)

VOCAB, MAX_LEN, WINDOW = 96, 48, 8


def _bridged(window=None, vocab=VOCAB):
    jm = j_llama_tiny(vocab_size=vocab, max_len=MAX_LEN, window=window, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, flax.core.meta.unbox(params))
    cfg = llama_tiny(vocab_size=vocab, max_len=MAX_LEN, window=window, dtype=torch.float32)
    return jm, params, LlamaLM.from_state_dict(cfg, from_flax_params(params), "cpu")


@pytest.fixture(scope="module")
def tiny():
    return _bridged()


@pytest.fixture(scope="module")
def windowed():
    return _bridged(window=WINDOW)


def _prompts(lens, seed=7):
    r = np.random.RandomState(seed)
    return [r.randint(0, VOCAB, size=(n,)).astype(np.int32) for n in lens]


def _run(model, mix, slots=3, **kw):
    pool = ContinuousBatchingDecoder(model, slots=slots, **kw)
    rids = [pool.submit(p, n) for p, n in mix]
    pool.run()
    return pool, [pool.result(r) for r in rids]


def _generate(model, prompt, n):
    return generate(model, torch.as_tensor(prompt[None].astype(np.int64)), n).numpy()[0]


# -- isolation ----------------------------------------------------------------------


@pytest.mark.parametrize("which", ["full", "windowed"])
def test_alone_equals_interleaved(tiny, windowed, which):
    _, _, model = tiny if which == "full" else windowed
    # 13 and 21 exceed the window (8): their prefill chunks and wrap
    prompts = _prompts([13, 5, 21])
    solo = [_run(model, [(p, 6)])[1][0] for p in prompts]
    _, together = _run(model, [(p, 6) for p in prompts])
    for got, want in zip(together, solo):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("which", ["full", "windowed"])
def test_rows_and_dispatches_equal_generate_and_the_jax_pool(tiny, windowed, which):
    jm, params, model = tiny if which == "full" else windowed
    mix = [(p, n) for p, n in zip(_prompts([13, 5, 21, 9, 3]), (5, 7, 4, 1, 6))]
    jpool = JaxSlotPool(jm, params, slots=2, steps_per_sync=4)
    jrids = [jpool.submit(p, n) for p, n in mix]
    jpool.run()
    want = [jpool.result(r) for r in jrids]
    pool, got = _run(model, mix, slots=2, steps_per_sync=4)
    for (p, n), g, w in zip(mix, got, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, _generate(model, p, n))
    for phase in ("admission", "step", "prefill", "sample", "scatter"):
        assert pool.ledger.count(phase) == jpool.ledger.count(phase), phase
    staged = which == "windowed"
    assert pool.ledger.count("admission") == (0 if staged else len(mix))
    assert pool.ledger.count("scatter") == (len(mix) - 1 if staged else 0)  # budget 1: no seat


def test_a_free_slots_rows_are_never_read(tiny):
    """Poison every free slot's rows with NaN: the seated requests'
    tokens stay the same."""

    _, _, model = tiny
    prompts = _prompts([6, 11])
    want = [_generate(model, p, 9) for p in prompts]
    pool = ContinuousBatchingDecoder(model, slots=4, steps_per_sync=3)
    rids = [pool.submit(p, 9) for p in prompts]
    pool.step()  # seats both in slots 0 and 1
    for k, v in pool._cache.layers:
        k[2:] = float("nan")
        v[2:] = float("nan")
    pool.run()
    for rid, w in zip(rids, want):
        np.testing.assert_array_equal(pool.result(rid), w)


def test_staggered_arrivals(tiny):
    _, _, model = tiny
    p1, p2 = _prompts([6, 4])
    want = _run(model, [(p2, 5)], slots=2)[1][0]
    pool = ContinuousBatchingDecoder(model, slots=2)
    r1 = pool.submit(p1, 10)
    for _ in range(3):
        pool.step()
    r2 = pool.submit(p2, 5)
    pool.run()
    np.testing.assert_array_equal(pool.result(r2), want)
    assert pool.result(r1).shape == (6 + 10,)


def test_more_requests_than_slots(tiny):
    _, _, model = tiny
    prompts = _prompts([4, 6, 3, 5, 7])
    pool, rows = _run(model, [(p, 4) for p in prompts], slots=2)
    for row, p in zip(rows, prompts):
        np.testing.assert_array_equal(row, _generate(model, p, 4))
    assert pool.ledger.count("admission") == len(prompts)
    assert not pool._active and not pool._queue


def test_result_wait_blocks_until_done(tiny):
    _, _, model = tiny
    pool = ContinuousBatchingDecoder(model, slots=2)
    rid = pool.submit(_prompts([5])[0], 4)
    assert pool.result_wait(rid, timeout=0.05) is None  # not stepped yet
    got = {}
    t = threading.Thread(target=lambda: got.update(row=pool.result_wait(rid, timeout=120)))
    t.start()
    pool.run()
    t.join(timeout=120)
    assert got["row"] is not None and got["row"].shape == (9,)
    with pytest.raises(KeyError):
        pool.result(rid)


# -- sampling and validation ---------------------------------------------------------------


def test_sampling_repeats_per_generator_and_top_k_1_is_greedy(tiny):
    _, _, model = tiny
    p = _prompts([6])[0]

    def sampled(seed, **kw):
        pool = ContinuousBatchingDecoder(model, slots=2)
        rid = pool.submit(p, 5, temperature=0.8, generator=torch.Generator().manual_seed(seed),
                          **kw)
        pool.run()
        return pool.result(rid)

    np.testing.assert_array_equal(sampled(42), sampled(42))
    pool = ContinuousBatchingDecoder(model, slots=2)
    greedy = pool.submit(p, 5)
    topk = pool.submit(p, 5, temperature=1.3, top_k=1, generator=torch.Generator())
    pool.run()
    np.testing.assert_array_equal(pool.result(topk), pool.result(greedy))


def test_rejects_overflow_bad_args_and_top_k(tiny):
    _, _, model = tiny
    pool = ContinuousBatchingDecoder(model, slots=2)
    for args, kw in (((np.zeros((0,), np.int32), 2), {}),
                     ((np.zeros((40,), np.int32), 20), {}),
                     ((np.zeros((4,), np.int32), 2), {"temperature": -1}),
                     ((np.zeros((4,), np.int32), 2), {"temperature": 0.5}),
                     ((np.zeros((4,), np.int32), 2), {"temperature": 0.5, "top_k": 0,
                                                      "generator": torch.Generator()}),
                     ((np.zeros((4,), np.int32), 2),
                      {"temperature": 0.5, "top_k": TOP_K_MAX + 1,
                       "generator": torch.Generator()})):
        with pytest.raises(ValueError):
            pool.submit(*args, **kw)
    assert not pool._queue and pool._rid == 0


def test_int8_slot_isolation(tiny):
    _, params, model = tiny
    int8 = LlamaLM.from_state_dict(model.cfg, quantize_state(from_flax_params(params)), "cpu")
    assert any(k.endswith("kernel_q") for k in int8.state_dict())
    p1, p2 = _prompts([5, 7])
    want = _run(int8, [(p1, 4)], slots=2)[1][0]
    _, rows = _run(int8, [(p1, 4), (p2, 4)], slots=2)
    np.testing.assert_array_equal(rows[0], want)
    np.testing.assert_array_equal(rows[0], _generate(int8, p1, 4))


def test_rolling_window_slot_isolation_across_the_wrap(windowed):
    """Three seats wrap their rolling caches at different positions
    (prompts of 13, 5 and 21 over a window of 8, 20 tokens each): each
    row equals its solo row and the windowed ``generate``."""

    _, _, model = windowed
    prompts = _prompts([13, 5, 21], seed=11)
    _, rows = _run(model, [(p, 20) for p in prompts], slots=3, steps_per_sync=3)
    for row, p in zip(rows, prompts):
        np.testing.assert_array_equal(row, _run(model, [(p, 20)], slots=2)[1][0])
        np.testing.assert_array_equal(row, _generate(model, p, 20))


# -- concurrency, records and failures ----------------------------------------------------


@pytest.mark.parametrize("which", ["full", "windowed"])
def test_threaded_submitters_with_a_driver_thread(tiny, windowed, which):
    _, _, model = tiny if which == "full" else windowed
    pool = ContinuousBatchingDecoder(model, slots=3)
    stop, results, errors = threading.Event(), {}, []

    def drive():
        try:
            while not stop.is_set():
                if pool.step() == 0:
                    stop.wait(0.002)
        except Exception as exc:  # surfaced below
            errors.append(("driver", repr(exc)))
            stop.set()

    def submitter(tid):
        try:
            r = np.random.RandomState(tid)
            for j in range(4):
                p = r.randint(0, VOCAB, size=(3 + (tid + j) % 11,)).astype(np.int32)
                budget = 2 + j % 3
                row = pool.result_wait(pool.submit(p, budget), timeout=300)
                np.testing.assert_array_equal(row, _generate(model, p, budget))
                results[(tid, j)] = row
        except Exception as exc:  # surfaced below
            errors.append((tid, repr(exc)))

    driver = threading.Thread(target=drive, daemon=True)
    driver.start()
    threads = [threading.Thread(target=submitter, args=(t,)) for t in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    stop.set()
    driver.join(timeout=30)
    assert not errors, errors
    assert len(results) == 12


@pytest.mark.parametrize("which", ["full", "windowed"])
def test_slo_observations_per_request_equal_the_jax_pools(tiny, windowed, which):
    jm, params, model = tiny if which == "full" else windowed
    regs = (j_metrics.Metrics(), metrics.Metrics())
    pools = (JaxSlotPool(jm, params, slots=2, metrics=regs[0], model_label="llama"),
             ContinuousBatchingDecoder(model, slots=2, metrics=regs[1], model_label="llama"))
    for pool, reg in zip(pools, regs):
        rids = [pool.submit(p, 4) for p in _prompts([5, 7, 4])]
        with pool._lock:
            # the gauges while queued: 3 requests x 4-token budgets (the
            # staged path has sampled each one's first token already)
            want = 9.0 if which == "windowed" else 12.0
            assert reg.gauge("serve_tokens_in_flight", model="llama") == want
        pool.run()
        assert all(pool.result(r) is not None for r in rids)
        for fam in ("serve_queue_wait_seconds", "serve_ttft_seconds",
                    "serve_time_per_output_token_seconds"):
            assert reg.histogram(fam, model="llama", mode="pool", tier="batch")["count"] == 3
        assert reg.gauge("serve_admission_queue_depth", model="llama") == 0.0
        assert reg.gauge("serve_tokens_in_flight", model="llama") == 0.0
    autopsies = [p.request_log.recent(10) for p in pools]
    assert [a["dispatches"] for a in autopsies[1]] == [a["dispatches"] for a in autopsies[0]]
    assert [a["tokens"] for a in autopsies[1]] == [a["tokens"] for a in autopsies[0]]


def test_an_admission_failure_requeues_the_request(tiny, monkeypatch):
    _, _, model = tiny
    pool = ContinuousBatchingDecoder(model, slots=2)
    real, blown = pool._admit_fused, []

    def flaky(req, slot):
        if not blown:
            blown.append(True)
            raise RuntimeError("out of memory (simulated)")
        return real(req, slot)

    monkeypatch.setattr(pool, "_admit_fused", flaky)
    p = _prompts([5])[0]
    rid = pool.submit(p, 3)
    with pytest.raises(RuntimeError):
        pool.step()
    with pool._lock:
        assert pool._queue and pool._queue[0].rid == rid
    pool.run()
    np.testing.assert_array_equal(pool.result(rid), _generate(model, p, 3))


def test_a_rolling_cache_keeps_the_staged_path(windowed):
    """Submit prefills eagerly under at most 2 x slots permits; the rest
    queue unprimed and prime at admission; nothing blocks, and every
    admission is a scatter."""

    _, _, model = windowed
    pool = ContinuousBatchingDecoder(model, slots=1)  # 2 permits
    prompts = _prompts([4, 6, 3, 5, 13])
    t0 = time.monotonic()
    rids = [pool.submit(p, 3) for p in prompts]
    assert time.monotonic() - t0 < 60
    with pool._lock:
        staged = sum(r.staged is not None for r in pool._queue)
        raw = sum(r.staged is None for r in pool._queue)
    assert staged == 2 and raw == 3
    pool.run()
    assert pool.ledger.count("admission") == 0
    assert pool.ledger.count("scatter") == len(prompts)
    assert pool.ledger.count("sample") == len(prompts)
    # the binary chunks capped at the window: 4 | 4+2 | 2+1 | 4+1 | 8+4+1
    assert pool.ledger.count("prefill") == sum(
        len(window_chunks(p.size, WINDOW)) for p in prompts) == 10
    for rid, p in zip(rids, prompts):
        np.testing.assert_array_equal(pool.result(rid), _generate(model, p, 3))
    # every permit came back
    assert all(pool._staging.acquire(blocking=False) for _ in range(2))


def test_the_slot_stack_is_the_pools_kv_arena(windowed):
    _, _, model = windowed
    pool = ContinuousBatchingDecoder(model, slots=3, metrics=metrics.Metrics())
    cfg = model.cfg
    want = 3 * cfg.n_layers * 2 * cfg.kv_heads * WINDOW * cfg.head_dim * 4  # float32
    snap = pool.costplane.hbm.snapshot()
    (row,) = snap["devices"]
    assert row["components"]["kv_arena"] == want
    bare = ContinuousBatchingDecoder(model, slots=1,
                                     ledger=metrics.DispatchLedger(metrics=None))
    assert bare.metrics is None and bare.costplane is None


# -- serve_lm's fallback -----------------------------------------------------------------


@pytest.fixture(scope="module")
def byte_windowed():
    """A windowed model over the 256 byte ids, as serve_lm serves."""

    return _bridged(window=WINDOW, vocab=256)


@pytest.fixture(scope="module")
def windowed_artifact(byte_windowed, tmp_path_factory):
    jm, params, _ = byte_windowed
    art = tmp_path_factory.mktemp("windowed")
    flat = {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(params)}
    np.savez(art / "params.npz", **flat)
    (art / "model.json").write_text(json.dumps(describe_model(jm)))
    return str(art)


def test_a_windowed_artifact_serves_the_contiguous_pool(byte_windowed, windowed_artifact,
                                                        capsys):
    from tests.testutil import load_serve_lm

    jm, params, _ = byte_windowed
    handler = load_serve_lm().build_handler(jm, params, MAX_LEN, batching_slots=2,
                                            paged_kernel="off", model_label="llama")
    jline = capsys.readouterr().out
    jserver = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=jserver.serve_forever, daemon=True).start()
    args = serve_lm.build_parser().parse_args([
        "--device", "cpu", "--artifact", windowed_artifact, "--batching", "2",
        "--max-len", str(MAX_LEN)])
    model = serve_lm.load_model(resolve_device("cpu"), max_len=args.max_len,
                                artifact=args.artifact)
    assert model.cfg.window == WINDOW
    pool = serve_lm.build_decoder(model, args)
    line = capsys.readouterr().out
    assert type(pool) is ContinuousBatchingDecoder and pool.slots == 2
    assert "paged pool unavailable (" in line and "serving the contiguous slot pool" in line
    assert line.strip() == [ln for ln in jline.splitlines() if "paged pool" in ln][0]
    server = serve_lm.Server(pool).start()
    try:
        body = {"prompt": "a prompt longer than the window ", "max_new_tokens": 12}
        for p in (server.port, jserver.server_address[1]):
            req = urllib.request.Request(f"http://127.0.0.1:{p}/generate",
                                         data=json.dumps(body).encode(), method="POST")
            with urllib.request.urlopen(req, timeout=120) as resp:
                body[p] = json.loads(resp.read())
        got, want = body[server.port], body[jserver.server_address[1]]
        assert got["sample"] == want["sample"] and set(got) == set(want)
        entry = pool.request_log.get(got["request_id"])
        assert entry["dispatches"]["scatter"] == 1 and entry["state"] == "done"
    finally:
        server.close()
        jserver.shutdown()
        jserver.server_close()


def test_speculative_on_a_windowed_model_is_refused(windowed):
    from tests.testutil import load_serve_lm

    jm, params, model = windowed
    with pytest.raises(ValueError) as want:
        load_serve_lm().build_handler(jm, params, MAX_LEN, batching_slots=2,
                                      paged_kernel="off", speculative=True)
    args = serve_lm.build_parser().parse_args(["--device", "cpu", "--batching", "2",
                                               "--speculative"])
    with pytest.raises(ValueError) as got:
        serve_lm.build_decoder(model, args, draft=model)
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("--speculative requires the paged pool: ")


def test_speculative_alone_still_serves_four_seats():
    parser = serve_lm.build_parser()
    assert serve_lm.slots_of(parser.parse_args([])) == 0
    assert serve_lm.slots_of(parser.parse_args(["--speculative"])) == 4
    assert serve_lm.slots_of(parser.parse_args(["--batching", "6"])) == 6
