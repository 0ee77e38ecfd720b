"""The port's lazy reservation, growth, preemption with host swap, and
SLO tiers against the JAX pool's, on the CPU (``llama_tiny``, float32,
one bridged flax param tree).  Each case mirrors one of
``tests/test_preemption.py``.

The load-bearing pins:

- token identity: a preempted-then-resumed request decodes exactly as
  an undisturbed one, greedy (and as the JAX pool, on its gather
  emulation and its Pallas kernel in interpret mode) and seeded (the
  port's generator draws differ from threefry's, so against the port's
  own undisturbed run);
- the same mix gives the JAX pool's preemption count, swap bytes,
  dispatches and per-request tokens, under both reserve modes and both
  tiers;
- lazy admits strictly more than worst-case at the same arena, with the
  same tokens; worst-case alone never grows or preempts;
- the tier policy: interactive is admitted first and preempts batch,
  batch never starves past the age boost;
- a growth window is still one ``step`` dispatch; a swap-exempt pin
  cannot wedge the pool; a full swap arena parks a seat without a copy;
  random two-tier churn conserves blocks and completes.

Prompts hold no shared prefixes where counts are compared with the JAX
pool: its admission trims shared blocks that its power-of-two prefill
width would push past max_len, and the port prefills at the exact
length (a deliberate difference that must not show up as a fault).
"""

import time

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from tf_operator_tpu.models import llama_tiny as j_llama_tiny
from tf_operator_tpu.models.batching import (
    PagedContinuousBatchingDecoder as JaxPool,
)

from tf_operator_tpu_torch.models.batching import PagedContinuousBatchingDecoder as Pool
from tf_operator_tpu_torch.models.llama import LlamaLM, llama_tiny
from tf_operator_tpu_torch.models.weights import from_flax_params

torch.set_num_threads(2)

VOCAB, MAX_LEN = 96, 64


@pytest.fixture(scope="module")
def tiny():
    jm = j_llama_tiny(vocab_size=VOCAB, max_len=MAX_LEN, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 4), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, flax.core.meta.unbox(params))
    cfg = llama_tiny(vocab_size=VOCAB, max_len=MAX_LEN, dtype=torch.float32)
    model = LlamaLM.from_state_dict(cfg, from_flax_params(params), "cpu")
    return jm, params, model


def _prompt(r, n):
    return r.integers(0, VOCAB, n).astype(np.int32)


def _drained(pool):
    pool.alloc.check()
    assert len(pool.swap) == 0 and pool.swap.swapped_blocks == 0
    assert not pool._active and not pool._queue


def _records(pool):
    """The pool's request autopsies by request id."""

    return {rec["rid"]: rec for rec in pool.request_log.recent(256)}


def _counts(pool):
    """The pool's dispatch counts by phase, from its ledger."""

    return {phase: row["count"] for phase, row in pool.ledger.snapshot().items()}


def _preempt_scenario(pool, a_kw=None):
    """``tests/test_preemption.py:60-102``: batch request A decodes two
    windows in a 4-block arena, then an interactive admission that needs
    3 blocks preempts it.  Returns (A's rid, the interactive rid)."""

    r = np.random.default_rng(3)
    prompt_a, prompt_i = _prompt(r, 6), _prompt(r, 33)
    a = pool.submit(prompt_a, 24, **(a_kw or {}))
    pool.step()
    pool.step()
    i = pool.submit(prompt_i, 8, tier="interactive")
    pool.run()
    return a, i


@pytest.mark.parametrize("case", ["greedy-off", "greedy-interpret", "seeded"])
def test_preempted_then_resumed_is_token_identical(tiny, case):
    jm, params, model = tiny
    seeded = case == "seeded"

    def a_kw():
        if not seeded:
            return {}
        return dict(temperature=0.9, top_k=40, generator=torch.Generator().manual_seed(5))

    r = np.random.default_rng(3)
    solo = Pool(model, slots=4, kv_block_size=16, steps_per_sync=8)
    rid = solo.submit(_prompt(r, 6), 24, **a_kw())
    solo.run()
    want = solo.result(rid)

    pool = Pool(model, slots=4, kv_block_size=16, kv_blocks=4, steps_per_sync=8)
    a, i = _preempt_scenario(pool, a_kw())
    assert pool.preemptions == 1, "scenario failed to preempt"
    got_a, got_i = pool.result(a), pool.result(i)
    np.testing.assert_array_equal(got_a, want)
    assert got_i.shape == (41,)
    recs = _records(pool)
    assert (recs[a]["tier"], recs[a]["preempted"]) == ("batch", 1)
    assert recs[a]["swapped_blocks"] == 2 and recs[a]["tokens"] == 24
    assert (recs[i]["tier"], recs[i]["preempted"]) == ("interactive", 0)
    assert pool.ledger.count("swap_out") == pool.ledger.count("swap_in") == 1
    assert pool.swap.bytes_out_total == pool.swap.bytes_in_total > 0
    assert [(e["direction"], e["blocks"]) for e in pool.swap_log] == [("out", 2), ("in", 2)]
    _drained(pool)
    if seeded:
        return
    jpool = JaxPool(jm, params, slots=4, kv_block_size=16, kv_blocks=4, steps_per_sync=8,
                    paged_kernel=case.split("-")[1])
    ja, ji = _preempt_scenario(jpool)
    assert jpool.preemptions == pool.preemptions
    np.testing.assert_array_equal(got_a, jpool.result(ja))
    np.testing.assert_array_equal(got_i, jpool.result(ji))
    # the same private blocks crossed the host link, in float32 both sides
    assert jpool.swap.bytes_out_total == pool.swap.bytes_out_total


def _mix_run(pool, waves):
    """Submit each wave, then step once; run to the end.  Returns the
    rows in submit order."""

    rids = []
    for wave in waves:
        for prompt, budget, tier in wave:
            rids.append(pool.submit(prompt, budget, tier=tier))
        pool.step()
    pool.run()
    return [pool.result(rid) for rid in rids]


def _mix():
    """Five batch requests in a tight arena (growth pressure), then two
    interactive arrivals a window apart (admission pressure)."""

    r = np.random.default_rng(21)
    batch = [(_prompt(r, n), b, "batch") for n, b in ((6, 30), (11, 20), (3, 40), (17, 12), (9, 26))]
    return [batch, [], [(_prompt(r, 20), 10, "interactive")], [],
            [(_prompt(r, 5), 16, "interactive")]]


@pytest.mark.parametrize("reserve", ["lazy", "worst-case"])
def test_the_same_mix_preempts_and_decodes_as_the_jax_pool(tiny, reserve):
    jm, params, model = tiny
    kw = dict(slots=4, kv_block_size=8, kv_blocks=14, steps_per_sync=4, reserve=reserve)
    jpool = JaxPool(jm, params, paged_kernel="off", **kw)
    pool = Pool(model, **kw)
    want = _mix_run(jpool, _mix())
    got = _mix_run(pool, _mix())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert pool.preemptions == jpool.preemptions
    if reserve == "lazy":
        assert pool.preemptions >= 2
    assert pool.swap.bytes_out_total == jpool.swap.bytes_out_total
    assert pool.swap.bytes_in_total == jpool.swap.bytes_in_total
    got = _counts(pool)
    assert got == {phase: jpool.ledger.count(phase) for phase in got}
    victims = [rec for rec in _records(pool).values() if rec["preempted"]]
    assert all(rec["tier"] == "batch" for rec in victims)  # batch never preempts interactive
    _drained(pool)


def test_lazy_and_worst_case_modes_are_token_identical(tiny):
    _, _, model = tiny
    r = np.random.default_rng(11)
    reqs = [(_prompt(r, n), b) for n, b in [(6, 30), (20, 14), (9, 24)]]
    outs = {}
    for reserve in ("worst-case", "lazy"):
        pool = Pool(model, slots=4, kv_block_size=16, reserve=reserve)
        rids = [pool.submit(p, b) for p, b in reqs]
        pool.run()
        outs[reserve] = [pool.result(rid) for rid in rids]
        _drained(pool)
    for a, b in zip(outs["lazy"], outs["worst-case"]):
        np.testing.assert_array_equal(a, b)


def test_lazy_admits_strictly_more_than_worst_case(tiny):
    jm, params, model = tiny
    r = np.random.default_rng(5)
    prompts = [_prompt(r, 6) for _ in range(5)]
    seated = {}
    for reserve in ("worst-case", "lazy"):
        for name, cls, extra in (("port", Pool, (model,)), ("jax", JaxPool, (jm, params))):
            pool = cls(*extra, slots=8, kv_block_size=16, kv_blocks=8, reserve=reserve)
            for p in prompts:
                pool.submit(p, 40)  # worst case: 3 blocks
            pool._admit()
            seated[name, reserve] = len(pool._active)
    assert seated["port", "worst-case"] == seated["jax", "worst-case"] == 2  # 8 // 3
    assert seated["port", "lazy"] == seated["jax", "lazy"] == 4  # commit 2 blocks each


def test_worst_case_mode_never_grows_or_preempts_alone(tiny):
    _, _, model = tiny
    r = np.random.default_rng(6)
    pool = Pool(model, slots=4, kv_block_size=16, kv_blocks=8, reserve="worst-case")
    rids = [pool.submit(_prompt(r, 6), 40) for _ in range(3)]
    committed = {}
    while pool.step() or pool._queue:
        for slot, refs in pool._seat_refs.items():
            req = pool._active[slot]
            assert committed.setdefault(req.rid, len(refs)) == len(refs) == 3
    assert all(pool.result(rid) is not None for rid in rids)
    assert pool.preemptions == 0
    assert pool.ledger.count("swap_out") == pool.ledger.count("swap_in") == 0
    _drained(pool)


def test_interactive_admitted_ahead_of_batch_queue(tiny):
    jm, params, model = tiny
    seen = []
    for pool in (Pool(model, slots=4, kv_block_size=16, kv_blocks=3),
                 JaxPool(jm, params, slots=4, kv_block_size=16, kv_blocks=3)):
        r = np.random.default_rng(8)
        # every request commits 2 of the 3 blocks: one fits at a time;
        # the interactive submit comes last and is seated first
        b1 = pool.submit(_prompt(r, 20), 8)
        b2 = pool.submit(_prompt(r, 20), 8)
        i1 = pool.submit(_prompt(r, 20), 8, tier="interactive")
        pool._admit()
        with pool._lock:
            seen.append(({q.rid for q in pool._active.values()},
                         [q.rid for q in pool._queue]))
        assert seen[-1] == ({i1}, [b1, b2])  # batch keeps FIFO within its rank
        pool.run()
        assert all(pool.result(rid) is not None for rid in (b1, b2, i1))
        pool.alloc.check()


def test_batch_never_starves_past_the_age_boost(tiny):
    _, _, model = tiny
    r = np.random.default_rng(9)
    pool = Pool(model, slots=2, kv_block_size=16, kv_blocks=2, steps_per_sync=4,
                age_boost_seconds=0.25)
    batch = pool.submit(_prompt(r, 6), 8)
    interactive = []
    done_at_backlog = None
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline:
        with pool._lock:
            queued_i = sum(1 for q in pool._queue if q.tier == "interactive")
        while queued_i < 2 and len(interactive) < 200:  # keep >= 2 interactive queued
            interactive.append(pool.submit(_prompt(r, 20), 8, tier="interactive"))
            queued_i += 1
        pool.step()
        if pool.result_wait(batch, timeout=0) is not None:
            with pool._lock:
                done_at_backlog = sum(1 for q in pool._queue if q.tier == "interactive")
            break
    assert done_at_backlog is not None, "batch request starved past the age boost bound"
    assert done_at_backlog >= 1  # it won through the backlog, not after it
    pool.run()
    pool.alloc.check()


def test_growth_window_is_still_one_dispatch(tiny):
    _, _, model = tiny
    pool = Pool(model, slots=2, kv_block_size=16, steps_per_sync=8)
    rid = pool.submit(np.arange(6, dtype=np.int32) % VOCAB, 48)
    pool.step()  # admission + window 1
    grew = False
    for _ in range(4):  # windows 2..5 cross into blocks 3 and 4
        committed0 = len(pool._seat_refs[0])
        before = _counts(pool)
        pool.step()
        grew |= len(pool._seat_refs[0]) > committed0
        after = _counts(pool)
        assert after == dict(before, step=before["step"] + 1)  # growth adds no dispatch
    assert grew, "scenario never crossed a block boundary"
    pool.run()
    assert pool.result(rid) is not None
    assert set(_counts(pool)) == {"admission", "step", "retire"}
    pool.alloc.check()


def test_swap_exempt_pin_cannot_wedge_the_pool(tiny):
    """A preempted queued request holds its prefix-published blocks
    (swap-exempt; the cache cannot evict them at refcount 2), and an
    admission needing the whole arena could gate the queue forever with
    no seat to preempt.  Demotion copies the queued holder's live blocks
    to the host, the cache entries become evictable, the admission
    proceeds, and the demoted request still resumes token-identically."""

    jm, params, model = tiny
    r = np.random.default_rng(23)
    prompt_a, prompt_b = _prompt(r, 33), _prompt(r, 33)  # 2 publishable blocks each
    solo = Pool(model, slots=2, kv_block_size=16, steps_per_sync=8)
    sa = solo.submit(prompt_a, 24)
    solo.run()
    want_a = solo.result(sa)

    rows = []
    for pool in (Pool(model, slots=2, kv_block_size=16, kv_blocks=4, steps_per_sync=8),
                 JaxPool(jm, params, slots=2, kv_block_size=16, kv_blocks=4, steps_per_sync=8)):
        a = pool.submit(prompt_a, 24)  # commits all 4
        pool.step()  # progress (victim-eligible) + 2 blocks published
        assert len(pool.prefix) == 2
        i = pool.submit(prompt_b, 24, tier="interactive")
        pool.run()
        assert pool.preemptions >= 1
        rows.append((pool.result(a), pool.result(i), pool.preemptions))
        pool.alloc.check()
        assert len(pool.swap) == 0 and pool.swap.swapped_blocks == 0
        if isinstance(pool, Pool):
            # more blocks swapped than the seat's eviction alone moved:
            # the demotion copied its pins too
            assert _records(pool)[a]["swapped_blocks"] >= 3
    np.testing.assert_array_equal(rows[0][0], want_a)
    for got, want in zip(rows[0], rows[1]):
        np.testing.assert_array_equal(got, want)


def test_growth_preempts_among_batch_seats(tiny):
    """No interactive request: three batch seats outgrow the arena, and
    growth preempts a batch seat of its own tier (most blocks, least
    progress first); the victim resumes with its tokens intact."""

    jm, params, model = tiny
    r = np.random.default_rng(31)
    reqs = [(_prompt(r, n), b) for n, b in ((5, 40), (9, 36), (4, 44))]
    solo = Pool(model, slots=3, kv_block_size=8, steps_per_sync=4)
    srids = [solo.submit(p, b) for p, b in reqs]
    solo.run()
    want = [solo.result(rid) for rid in srids]
    outs = []
    for pool in (Pool(model, slots=3, kv_block_size=8, kv_blocks=10, steps_per_sync=4),
                 JaxPool(jm, params, slots=3, kv_block_size=8, kv_blocks=10, steps_per_sync=4,
                         paged_kernel="off")):
        rids = [pool.submit(p, b) for p, b in reqs]
        pool.run()
        outs.append(([pool.result(rid) for rid in rids], pool.preemptions))
        pool.alloc.check()
    (got, n_port), (jgot, n_jax) = outs
    assert n_port == n_jax >= 1
    for g, j, w in zip(got, jgot, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, j)


def test_full_swap_arena_parks_a_seat_without_a_copy(tiny):
    """``swap_blocks=0``: no victim is eligible, so the grower that
    cannot be fed leaves its seat with every block still live (no copy,
    nothing freed), resumes when the other seat retires, and decodes
    the tokens of an undisturbed run."""

    jm, params, model = tiny
    r = np.random.default_rng(41)
    reqs = [(_prompt(r, 6), 20), (_prompt(r, 6), 10)]
    solo = Pool(model, slots=2, kv_block_size=8, steps_per_sync=4)
    srids = [solo.submit(p, b) for p, b in reqs]
    solo.run()
    want = [solo.result(rid) for rid in srids]
    kw = dict(slots=2, kv_block_size=8, kv_blocks=4, steps_per_sync=4, swap_blocks=0)
    outs = []
    for pool in (Pool(model, **kw), JaxPool(jm, params, paged_kernel="off", **kw)):
        rids = [pool.submit(p, b) for p, b in reqs]
        pool.run()
        outs.append([pool.result(rid) for rid in rids])
        assert pool.preemptions == 1
        assert pool.swap.bytes_out_total == pool.swap.bytes_in_total == 0
        pool.alloc.check()
    port = Pool(model, **kw)
    rids = [port.submit(p, b) for p, b in reqs]
    port.run()
    assert port.ledger.count("swap_out") == 0 and port.ledger.count("swap_in") == 1
    assert _records(port)[rids[0]]["preempted"] == 1
    assert _records(port)[rids[0]]["swapped_blocks"] == 0
    for got, jgot, w in zip(outs[0], outs[1], want):
        np.testing.assert_array_equal(got, w)
        np.testing.assert_array_equal(got, jgot)


@pytest.mark.parametrize("seed", [17, 18])
def test_random_two_tier_churn_conserves_and_completes(tiny, seed):
    _, _, model = tiny
    r = np.random.default_rng(seed)
    pool = Pool(model, slots=6, kv_block_size=16, kv_blocks=6, steps_per_sync=8,
                age_boost_seconds=0.5)
    rids = []
    for k in range(12):
        tier = "interactive" if k % 4 == 0 else "batch"
        p = _prompt(r, int(r.integers(4, 24)))
        budget = int(r.choice([8, 24, 40]))
        rids.append(pool.submit(p, budget, tier=tier))
        if k % 3 == 0:
            pool.step()
            pool.alloc.check()
            assert pool.alloc.in_use <= pool.alloc.usable
    pool.run()
    for rid in rids:
        assert pool.result(rid) is not None
    _drained(pool)
    # published prefix blocks are the only live remainder
    assert pool.alloc.in_use == len(pool.prefix)
    assert pool.swap.bytes_out_total == pool.swap.bytes_in_total
