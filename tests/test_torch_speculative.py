"""The port's speculative paged decoding against the JAX pool's, on the
CPU (``llama_tiny``, float32, vocab 96; one bridged flax param tree for
the target, a second init as the divergent draft, and JAX's
``quantize_tree`` of the target as the int8 self-draft).  Each case
mirrors one of ``tests/test_speculative_paged.py``.

The load-bearing pins:

- token identity: the speculating pool's greedy tokens equal the plain
  pool's and the JAX speculating pool's (its gather emulation and its
  Pallas kernel in interpret mode), across acceptance and rollback, and
  through a prefix-hit admission;
- the records: a mixed window is 3 dispatches (step, draft, verify), an
  all-speculating one 2; the ledger's counts by phase, every autopsy,
  the span names and the ``serve_spec_*`` counters equal the JAX pool's;
- a preempted speculating seat (swapped, or parked live when the swap
  arena refuses) resumes with the tokens and the draft proposals of an
  undisturbed run, greedy and seeded;
- rejection sampling holds to its law: the emitted token is distributed
  as the target's p, whatever the draft's q;
- every configuration that cannot speculate raises at construction,
  with the JAX pool's message;
- ``serve_lm``: a typo'd ``--spec-tiers`` fails startup, the guard reads
  the port's own record, and ``/metrics`` carries the JAX server's
  families with speculation on.

Prompts hold no shared prefixes where counts are compared with the JAX
pool, apart from one whose padded width stays inside max_len (the JAX
pool trims shared blocks past it; the port prefills at the exact
length).
"""

import collections
import json
import os
import subprocess
import sys
import threading
import types
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from tf_operator_tpu.models import llama_tiny as j_llama_tiny
from tf_operator_tpu.models.batching import PagedContinuousBatchingDecoder as JaxPool
from tf_operator_tpu.ops import quant as jquant
from tf_operator_tpu.utils import metrics as j_metrics
from tf_operator_tpu.utils.trace import Tracer as JaxTracer

from tf_operator_tpu_torch import serve_lm
from tf_operator_tpu_torch.models import batching
from tf_operator_tpu_torch.models.batching import PagedContinuousBatchingDecoder as Pool
from tf_operator_tpu_torch.models.llama import LlamaLM, llama_tiny
from tf_operator_tpu_torch.models.weights import from_flax_params
from tf_operator_tpu_torch.utils.trace import Tracer

torch.set_num_threads(2)

VOCAB, MAX_LEN = 96, 64

#: families the JAX pool's device cost plane writes; not ported
COSTPLANE_FAMILIES = {"compile_seconds", "compile_total", "hbm_component_bytes",
                      "step_time_p50_seconds", "step_time_p99_seconds"}


def _bridge(tree, max_len=MAX_LEN, vocab=VOCAB, **kw):
    cfg = llama_tiny(vocab_size=vocab, max_len=max_len, dtype=torch.float32, **kw)
    return LlamaLM.from_state_dict(cfg, from_flax_params(tree), "cpu")


@pytest.fixture(scope="module")
def tiny():
    """(JAX module, target params, divergent draft params, int8 draft
    params) and the port's (target, divergent draft, int8 self-draft)."""

    jm = j_llama_tiny(vocab_size=VOCAB, max_len=MAX_LEN, dtype=jnp.float32)
    init = jnp.zeros((1, 4), jnp.int32)

    def params(key):
        tree = jm.init(jax.random.PRNGKey(key), init)["params"]
        return jax.tree_util.tree_map(np.asarray, flax.core.meta.unbox(tree))

    p, dp = params(1), params(2)
    qp = jquant.quantize_tree(p)
    return (jm, p, dp, qp), (_bridge(p), _bridge(dp), _bridge(qp))


def _prompt(r, n):
    return r.integers(0, VOCAB, n).astype(np.int32)


def _drained(pool):
    pool.alloc.check()
    assert len(pool.swap) == 0 and pool.swap.swapped_blocks == 0
    assert not pool._active and not pool._queue
    assert not pool._draft_refs


def _counts(pool):
    return {phase: row["count"] for phase, row in pool.ledger.snapshot().items()}


def _run(pool, reqs, tier="interactive"):
    rids = [pool.submit(p, b, tier=tier) for p, b in reqs]
    pool.run()
    return [pool.result(rid) for rid in rids]


# -- token identity ----------------------------------------------------------

#: (draft, the JAX pool's paged kernel, spec_k, prompts (length, budget))
IDENTITY_CASES = {
    "divergent-off": ("divergent", "off", 3, ((6, 24), (11, 17), (3, 9))),
    "int8-self-draft-interpret": ("int8", "interpret", 4, ((6, 24), (11, 17), (3, 9),
                                                            (20, 30))),
}


@pytest.mark.parametrize("case", sorted(IDENTITY_CASES))
def test_greedy_identity_across_accept_and_rollback(tiny, case):
    (jm, params, dparams, qparams), (model, divergent, int8) = tiny
    which, kernel, k, shape = IDENTITY_CASES[case]
    r = np.random.default_rng(4)
    reqs = [(_prompt(r, n), b) for n, b in shape]
    want = _run(Pool(model, slots=4, kv_block_size=16, steps_per_sync=8), reqs)
    draft = divergent if which == "divergent" else int8
    spec = Pool(model, slots=4, kv_block_size=16, steps_per_sync=8, draft_model=draft,
                spec_k=k)
    got = _run(spec, reqs)
    jpool = JaxPool(jm, params, slots=4, kv_block_size=16, steps_per_sync=8,
                    paged_kernel=kernel, draft_model=jm,
                    draft_params=dparams if which == "divergent" else qparams, spec_k=k)
    jgot = _run(jpool, reqs)
    for g, w, j in zip(got, want, jgot):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, j)
    snap = spec.spec_snapshot()
    assert snap["spec_rollbacks"] >= 1, "no proposal was rejected"
    if which == "int8":
        assert snap["spec_accepted"] >= 1, "no proposal was accepted"
    # the JAX pool's accounting, integer for integer, plus the port's key
    jsnap = jpool.spec_snapshot()
    assert set(snap) == set(jsnap) | {"launches_per_token"}
    assert {key: snap[key] for key in jsnap} == jsnap
    assert snap["launches_per_token"] == 0.0  # the CPU runs the plain versions
    assert _counts(spec) == {p: row["count"] for p, row in jpool.ledger.snapshot().items()}
    _drained(spec)


def test_self_draft_is_accepted_where_a_divergent_draft_is_not(tiny):
    """The divergent draft's proposals are rejected, the int8 self-draft's
    mostly accepted, and so the self-draft needs fewer dispatches a
    token (below one)."""

    _, (model, divergent, int8) = tiny
    r = np.random.default_rng(4)
    reqs = [(_prompt(r, n), b) for n, b in ((6, 24), (11, 17), (3, 9), (20, 30))]
    snaps = {}
    for name, draft in (("divergent", divergent), ("int8", int8)):
        pool = Pool(model, slots=4, kv_block_size=16, steps_per_sync=8, draft_model=draft)
        _run(pool, reqs)
        snaps[name] = pool.spec_snapshot()
    assert snaps["divergent"]["acceptance_rate"] < 0.2 < 0.7 < snaps["int8"]["acceptance_rate"]
    assert snaps["int8"]["dispatches_per_token"] < min(
        1.0, snaps["divergent"]["dispatches_per_token"])


# -- the records ---------------------------------------------------------------


def _mixed_waves():
    """(pool kwargs, waves of (trace id, prompt, budget, tier)): an
    interactive pair sharing a 16-token prefix (the second admitted
    through a prefix hit), two batch requests decoding plainly in the
    same windows, a budget-1 interactive request."""

    r = np.random.default_rng(9)
    shared = _prompt(r, 16)
    waves = [[("i-0", np.concatenate([shared, _prompt(r, 3)]), 14, "interactive"),
              ("b-0", _prompt(r, 7), 12, "batch")],
             [("i-1", np.concatenate([shared, _prompt(r, 5)]), 10, "interactive"),
              ("b-1", _prompt(r, 4), 9, "batch")],
             [("i-2", _prompt(r, 5), 1, "interactive")]]
    return dict(slots=4, steps_per_sync=4, kv_block_size=8, kv_blocks=40), waves


def _drive(pool, waves, each_step=None):
    def step():
        before = _counts(pool)
        pool.step()
        if each_step is not None:
            each_step(before, _counts(pool))

    for wave in waves:
        for tid, prompt, budget, tier in wave:
            pool.submit(prompt, budget, tier=tier, trace_id=tid)
        step()
    while pool._queue or pool._active:
        step()


def _autopsy_ints(entry):
    adm = entry["admission"] or {}
    return {
        "tokens": entry["tokens"], "windows": entry["windows"],
        "dispatches": entry["dispatches"], "preempted": entry["preempted"],
        "swapped_blocks": entry["swapped_blocks"], "tier": entry["tier"],
        "state": entry["state"], "blocks_reserved": adm.get("blocks_reserved"),
        "prefix_hit_tokens": adm.get("prefix_hit_tokens"),
        "blocks_freed": (entry["retire"] or {}).get("blocks_freed"),
    }


def _families(reg):
    out = collections.defaultdict(set)
    with reg._lock:
        series = list(reg._counters) + list(reg._gauges) + list(reg._histograms)
    for name, labels in series:
        out[name].add(frozenset(k for k, _ in labels))
    return dict(out)


@pytest.fixture(scope="module")
def mixed_runs(tiny):
    """The mixed-tier scenario through the JAX pool and the port's
    ``serve_lm`` pool (full records, seeded tracers, the divergent draft),
    and the port's dispatch deltas of each step that admitted nothing.

    The divergent draft is a float32 model, so both pools' proposals are
    the same argmaxes.  The int8 self-draft's are not always: the JAX
    pool runs its draft on dequantized weights, ``x @ (q * s)``, where
    the port's int8 path runs ``(x @ q) * s``, and a near tie can flip a
    proposal (never a token: the target decides)."""

    (jm, params, dparams, _), (model, divergent, _) = tiny
    kw, waves = _mixed_waves()
    jreg = j_metrics.Metrics()
    jpool = JaxPool(jm, params, paged_kernel="off", model_label="llama",
                    ledger=j_metrics.DispatchLedger(jreg, JaxTracer(seed=0)), metrics=jreg,
                    draft_model=jm, draft_params=dparams, spec_k=3, **kw)
    pool = serve_lm.make_pool(model, model_label="llama", tracer=Tracer(seed=0),
                              draft_model=divergent, spec_k=3, **kw)
    deltas = []

    def window(before, after):
        if after.get("admission", 0) == before.get("admission", 0):
            deltas.append({p: after.get(p, 0) - before.get(p, 0)
                           for p in ("step", "draft", "verify")})

    _drive(jpool, waves)
    _drive(pool, waves, window)
    return jpool, pool, waves, deltas


def test_mixed_windows_are_three_dispatches_and_all_speculating_two(mixed_runs):
    _, pool, _, deltas = mixed_runs
    mixed = [d for d in deltas if d["step"]]
    spec_only = [d for d in deltas if not d["step"] and d["verify"]]
    assert mixed and spec_only, deltas
    assert all(d == {"step": 1, "draft": 1, "verify": 1} for d in mixed)
    assert all(d == {"step": 0, "draft": 1, "verify": 1} for d in spec_only)
    _drained(pool)


def test_ledger_autopsies_and_spans_match_the_jax_pool(mixed_runs):
    jpool, pool, waves, _ = mixed_runs
    assert _counts(pool) == {p: row["count"] for p, row in jpool.ledger.snapshot().items()}
    tids = [w[0] for wave in waves for w in wave]
    for tid in tids:
        got, want = pool.request_log.get(tid), jpool.request_log.get(tid)
        assert sorted(got) == sorted(want)
        assert _autopsy_ints(got) == _autopsy_ints(want), tid
        spans = [collections.Counter(s["name"] for s in p.tracer.store.trace(tid)["spans"])
                 for p in (pool, jpool)]
        assert spans[0] == spans[1], tid
    drafts = {tid: pool.request_log.get(tid)["dispatches"].get("draft", 0) for tid in tids}
    # one draft prefill a speculating admission (none for budget 1 or batch)
    assert drafts == {"i-0": 1, "b-0": 0, "i-1": 1, "b-1": 0, "i-2": 0}
    assert pool.request_log.get("i-1")["admission"]["prefix_hit_tokens"] == 16
    assert pool.ledger.count("draft") == pool.ledger.count("verify") + 2
    assert pool.ledger.count("verify") == pool.spec_windows


def test_spec_counters_and_families_match_the_jax_pool(mixed_runs):
    jpool, pool, _, _ = mixed_runs
    for name in ("serve_spec_proposed_total", "serve_spec_accepted_total",
                 "serve_spec_rollbacks_total"):
        assert pool.metrics.counter_series(name) == jpool.metrics.counter_series(name), name
    series = pool.metrics.counter_series("serve_spec_proposed_total")
    assert series == {(("model", "llama"), ("tier", "interactive")): pool.spec_proposed}
    want = {k: v for k, v in _families(jpool.metrics).items() if k not in COSTPLANE_FAMILIES}
    assert _families(pool.metrics) == want


def test_mixed_tokens_equal_the_plain_pool_and_the_jax_pool(tiny, mixed_runs):
    _, (model, _, _) = tiny
    jpool, pool, waves, _ = mixed_runs
    kw, _ = _mixed_waves()
    plain = Pool(model, **kw)
    _drive(plain, waves)

    def rids(p):  # trace id -> the pool's request id
        return {e["id"]: e["rid"] for e in p.request_log.recent(64)}

    spec_rids, jax_rids, plain_rids = rids(pool), rids(jpool), rids(plain)
    assert len(spec_rids) == 5
    for tid, rid in spec_rids.items():
        got = pool.result(rid)
        np.testing.assert_array_equal(got, jpool.result(jax_rids[tid]))
        np.testing.assert_array_equal(got, plain.result(plain_rids[tid]))


# -- preemption ----------------------------------------------------------------


def _spy_proposals(monkeypatch, pool):
    """Each speculating seat's proposals, window by window, by rid."""

    seen = collections.defaultdict(list)
    orig = batching._spec_accept

    def spy(logits, drafts, *args):
        for slot, req in pool._active.items():
            if pool._spec_req(req):
                seen[req.rid].append(drafts[slot].tolist())
        return orig(logits, drafts, *args)

    monkeypatch.setattr(batching, "_spec_accept", spy)
    return seen


def _sampled(seeded):
    if not seeded:
        return {}
    return dict(temperature=0.9, top_k=40, generator=torch.Generator().manual_seed(5))


@pytest.mark.parametrize("case", ["greedy", "seeded"])
def test_preempted_speculating_seat_resumes_identically(tiny, monkeypatch, case):
    """A speculating batch seat A (target and draft blocks, 4 in a 4-block
    arena) decodes two windows; a plain interactive admission preempts
    it, swapping its target and draft blocks to the host; it resumes into
    fresh ids with the tokens and the proposals of an undisturbed run."""

    _, (model, _, int8) = tiny
    seeded = case == "seeded"
    r = np.random.default_rng(3)
    prompt_a, prompt_i = _prompt(r, 6), _prompt(r, 33)
    kw = dict(slots=4, kv_block_size=16, steps_per_sync=8, draft_model=int8,
              spec_tiers=("batch",))
    solo = Pool(model, **kw)
    solo_seen = _spy_proposals(monkeypatch, solo)
    s = solo.submit(prompt_a, 24, **_sampled(seeded))
    solo.run()
    want = solo.result(s)

    pool = Pool(model, kv_blocks=4, **kw)
    seen = _spy_proposals(monkeypatch, pool)
    a = pool.submit(prompt_a, 24, **_sampled(seeded))
    pool.step()
    pool.step()
    i = pool.submit(prompt_i, 8, tier="interactive")
    pool.run()
    assert pool.preemptions == 1, "the scenario failed to preempt"
    np.testing.assert_array_equal(pool.result(a), want)
    assert pool.result(i).shape == (41,)
    assert seen[a] == solo_seen[s] and len(seen[a]) >= 3
    log = {e["rid"]: e for e in pool.request_log.recent(8)}
    # both twins crossed the host link: 2 target + 2 draft blocks
    assert log[a]["preempted"] == 1 and log[a]["swapped_blocks"] == 4
    assert [(e["direction"], e["blocks"]) for e in pool.swap_log] == [
        ("out", 2), ("out", 2), ("in", 2), ("in", 2)]
    assert pool.swap.bytes_out_total == pool.swap.bytes_in_total > 0
    _drained(pool)


def test_parked_speculating_seat_keeps_its_draft_live(tiny, monkeypatch):
    """``swap_blocks=0``: a speculating grower that cannot be fed parks
    with its target and draft blocks live (no copy), resumes when the
    other seat retires, and continues with the tokens and proposals of
    an undisturbed run."""

    _, (model, _, int8) = tiny
    r = np.random.default_rng(41)
    reqs = [(_prompt(r, 6), 20), (_prompt(r, 6), 10)]
    kw = dict(slots=2, kv_block_size=8, steps_per_sync=4, draft_model=int8, spec_k=3)
    solo = Pool(model, **kw)
    solo_seen = _spy_proposals(monkeypatch, solo)
    srids = [solo.submit(p, b, tier="interactive") for p, b in reqs]
    solo.run()
    want = [solo.result(x) for x in srids]
    pool = Pool(model, kv_blocks=8, swap_blocks=0, **kw)
    seen = _spy_proposals(monkeypatch, pool)
    parked = []
    preempt = pool._preempt_seat_locked

    def logged(slot, reason):
        rid = pool._active[slot].rid
        freed = preempt(slot, reason)
        parked.append((rid, reason, len(pool.swap.peek(rid)["draft_live"]), freed))
        return freed

    pool._preempt_seat_locked = logged
    rids = [pool.submit(p, b, tier="interactive") for p, b in reqs]
    pool.run()
    assert parked and all(reason == "park" and dlive > 0 and freed == 0
                          for _, reason, dlive, freed in parked), parked
    for rid, srid, w in zip(rids, srids, want):
        np.testing.assert_array_equal(pool.result(rid), w)
        assert seen[rid] == solo_seen[srid]
    assert pool.swap.bytes_out_total == pool.swap.bytes_in_total == 0
    _drained(pool)


# -- rejection sampling ---------------------------------------------------------


def test_rejection_sampling_holds_to_its_law():
    """Synthetic p and q (V 8, K 2): 20,000 seats draw d1 ~ q1, d2 ~ q2
    and run the acceptance; the first emitted token (d1 if accepted,
    else the correction) must be distributed as p1, and the second (d2
    or the correction, where d1 was accepted) as p2.  Chi-square with 7
    degrees of freedom under 30 (a p-value near 1e-4) on a fixed seed."""

    v, k, n = 8, 2, 20_000
    g = torch.Generator().manual_seed(11)
    p_logits = torch.randn((k + 1, v), generator=g) * 1.5
    q_logits = torch.randn((k, v), generator=g) * 1.5
    p = torch.softmax(p_logits, -1)
    q = torch.softmax(q_logits, -1)
    drafts = torch.stack([torch.multinomial(q[t], n, replacement=True, generator=g)
                          for t in range(k)], dim=1)
    logits = p_logits[None].expand(n, k + 1, v).contiguous()
    gens = {s: torch.Generator().manual_seed(1000 + s) for s in range(n)}
    temps = torch.ones(n)
    top_ks = torch.zeros(n, dtype=torch.int32)
    m, corr = batching._spec_accept(logits, drafts, q[None].expand(n, k, v).contiguous(),
                                    temps, top_ks, gens)
    first = torch.where(m >= 1, drafts[:, 0], corr)
    second = torch.where(m >= 2, drafts[:, 1], corr)[m >= 1]

    def chi2(tokens, dist):
        obs = torch.bincount(tokens, minlength=v).double()
        exp = dist.double() * len(tokens)
        return float(((obs - exp) ** 2 / exp).sum())

    assert chi2(first, p[0]) < 30.0
    assert chi2(second, p[1]) < 30.0
    assert 0 < int((m >= 1).sum()) < n  # both acceptance and rejection occur


def test_top_k_1_is_greedy():
    """top_k 1 at any temperature accepts and corrects exactly as the
    greedy path does."""

    g = torch.Generator().manual_seed(2)
    s, k, v = 64, 3, 12
    logits = torch.randn((s, k + 1, v), generator=g)
    drafts = torch.where(torch.rand((s, k), generator=g) < 0.6,
                         logits[:, :k].argmax(-1), torch.randint(0, v, (s, k), generator=g))
    greedy = batching._spec_accept(logits, drafts, None, torch.zeros(s),
                                   torch.zeros(s, dtype=torch.int32), {})
    q = torch.nn.functional.one_hot(drafts, v).float()  # a top_k 1 draft's q
    sampled = batching._spec_accept(logits, drafts, q, torch.full((s,), 0.7),
                                    torch.ones(s, dtype=torch.int32),
                                    {i: torch.Generator().manual_seed(i) for i in range(s)})
    assert torch.equal(greedy[0], sampled[0]) and torch.equal(greedy[1], sampled[1])
    assert 0 < int((greedy[0] == k).sum()) < s


# -- construction ----------------------------------------------------------------


@pytest.mark.parametrize("case", ["typo-tier", "spec-k-0", "missing-draft", "max-len",
                                  "cannot-page", "other-device"])
def test_construction_raises_instead_of_serving_plainly(tiny, case):
    (jm, params, dparams, _), (model, divergent, _) = tiny
    kw, jkw = dict(draft_model=divergent), dict(draft_model=jm, draft_params=dparams)
    if case == "typo-tier":
        kw["spec_tiers"] = jkw["spec_tiers"] = ("interactiv",)
    elif case == "spec-k-0":
        kw["spec_k"] = jkw["spec_k"] = 0
    elif case == "missing-draft":
        kw["draft_model"] = LlamaLM(model.cfg, device="meta")
        jkw["draft_params"] = None
    elif case == "max-len":
        kw["draft_model"] = _bridge(dparams, max_len=2 * MAX_LEN)
        jkw["draft_model"] = j_llama_tiny(vocab_size=VOCAB, max_len=2 * MAX_LEN,
                                          dtype=jnp.float32)
    elif case == "cannot-page":
        kw["draft_model"] = _bridge(dparams, window=16)
    else:
        # a draft on another device (none exists here: a stand-in)
        kw["draft_model"] = types.SimpleNamespace(device=torch.device("cuda", 0),
                                                  cfg=divergent.cfg)
    with pytest.raises(ValueError) as got:
        Pool(model, slots=2, kv_block_size=16, **kw)
    if case in ("typo-tier", "spec-k-0", "max-len"):
        with pytest.raises(ValueError) as want:
            JaxPool(jm, params, slots=2, kv_block_size=16, paged_kernel="off", **jkw)
        assert str(got.value) == str(want.value)
    elif case == "missing-draft":
        assert "draft_model requires draft" in str(got.value)
    elif case == "cannot-page":
        assert "draft model cannot page" in str(got.value)
    else:
        assert "on one device" in str(got.value)


# -- serve_lm --------------------------------------------------------------------

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_typod_spec_tier_fails_startup():
    proc = subprocess.run(
        [sys.executable, "-m", "tf_operator_tpu_torch.serve_lm", "--device", "cpu",
         "--model", "llama-tiny", "--max-len", "64", "--port", "0", "--speculative",
         "--speculative-force", "--spec-tiers", "interactiv"],
        cwd=ROOT, capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode != 0
    assert "not SLO tiers" in proc.stderr
    assert "serving on" not in proc.stdout


@pytest.mark.parametrize("value, force, refused", [
    (0.62, False, True), (0.62, True, False), (1.0, False, False), (1.7, False, False),
    (None, False, False),
], ids=["slower", "slower-forced", "even", "faster", "no-record"])
def test_speculative_guard_reads_the_ports_record(tmp_path, value, force, refused):
    ledger = tmp_path / "spec_measured.json"
    if value is not None:
        ledger.write_text(json.dumps({"spec_paged_speedup": {
            "value": value, "card": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W",
            "date": "2026-01-01", "artifact": "chip_smoke.py phase 7d"}}))
    argv = ["--speculative"] + (["--speculative-force"] if force else [])
    args = serve_lm.build_parser().parse_args(argv)
    if refused:
        with pytest.raises(SystemExit, match="--speculative refused: .* 0.62x"):
            serve_lm.refuse_speculative(args, str(ledger))
    else:
        serve_lm.refuse_speculative(args, str(ledger))
    assert serve_lm.speculative_slowdown(str(ledger))[0] == value
    # the default record is the port's own, never the JAX pool's ledger
    assert serve_lm.SPEC_RECORD == os.path.join(ROOT, "tf_operator_tpu_torch",
                                                "spec_measured.json")


def test_speculative_flags_reach_the_pool(tiny):
    _, (model, _, int8) = tiny
    parser = serve_lm.build_parser()
    args = parser.parse_args(["--speculative", "--spec-k", "3", "--spec-tiers",
                              "interactive,batch"])
    assert serve_lm.slots_of(args) == 4  # --speculative alone: 4 seats
    pool = serve_lm.build_pool(model, args, draft=int8)
    assert (pool.slots, pool.spec_k, pool.spec_tiers) == (4, 3, ("interactive", "batch"))
    assert serve_lm.slots_of(parser.parse_args([])) == 8
    assert serve_lm.slots_of(parser.parse_args(["--speculative", "--batching", "6"])) == 6
    assert serve_lm.load_draft(model, parser.parse_args(["--quantize", "int8"])) is model
    with pytest.raises(ValueError, match="not SLO tiers"):
        serve_lm.build_pool(model, parser.parse_args(["--speculative", "--spec-tiers",
                                                      "interactiv"]), draft=int8)


@pytest.fixture(scope="module")
def spec_servers(tmp_path_factory):
    """The JAX server's speculative handler and the port's speculating
    server over the same byte-level llama_tiny, each with its int8
    self-draft: (port's port, JAX server's port, port's pool)."""

    from tests.testutil import load_serve_lm

    jm = j_llama_tiny(vocab_size=256, max_len=MAX_LEN, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 4), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, flax.core.meta.unbox(params))
    handler = load_serve_lm().build_handler(jm, params, max_len=MAX_LEN, batching_slots=2,
                                            paged_kernel="off", speculative=True, spec_k=4)
    jserver = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=jserver.serve_forever, daemon=True).start()
    model = _bridge(params, vocab=256)
    draft = _bridge(jquant.quantize_tree(params), vocab=256)
    pool = serve_lm.make_pool(model, slots=2, kv_block_size=16, draft_model=draft, spec_k=4)
    server = serve_lm.Server(pool).start()
    try:
        yield server.port, jserver.server_address[1], pool
    finally:
        server.close()
        jserver.shutdown()
        jserver.server_close()


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                 data=json.dumps(body).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=240) as resp:
        return resp.status, json.loads(resp.read())


def _metrics(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=60) as resp:
        return resp.read().decode()


def _sample_names(text):
    return {line.split("{")[0].split(" ")[0] for line in text.splitlines()
            if line and not line.startswith("#")}


def _series(text, name, **labels):
    want = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    head = f"{name}{{{want}}} " if want else f"{name} "
    return next((float(line[len(head):]) for line in text.splitlines()
                 if line.startswith(head)), 0.0)


def test_spec_servers_answer_alike_with_the_jax_metric_families(spec_servers):
    port, jport, _ = spec_servers
    body = {"prompt": "the speculative pool ", "max_new_tokens": 16, "tier": "interactive"}
    (code, got), (jcode, want) = _post(port, body), _post(jport, body)
    assert code == jcode == 200 and got["sample"] == want["sample"]
    texts = [_metrics(p) for p in (port, jport)]
    costplane = {n for n in _sample_names(texts[1]) if n.split("_bucket")[0].split("_sum")[0]
                 .split("_count")[0] in COSTPLANE_FAMILIES}
    assert _sample_names(texts[1]) - _sample_names(texts[0]) - costplane == {
        "serve_pool_compiles"}
    assert _sample_names(texts[0]) <= _sample_names(texts[1])
    for name in ("serve_spec_acceptance_rate", "serve_spec_dispatches_per_token",
                 "serve_spec_proposed_total", "serve_spec_accepted_total"):
        assert name in _sample_names(texts[0]), name


def test_one_interactive_request_pays_one_unpaired_draft(spec_servers):
    port, _, pool = spec_servers
    before = _metrics(port)
    _post(port, {"prompt": "one more request ", "max_new_tokens": 12, "tier": "interactive"})
    after = _metrics(port)

    def delta(phase):
        return (_series(after, "serving_dispatch_total", phase=phase)
                - _series(before, "serving_dispatch_total", phase=phase))

    assert delta("draft") == delta("verify") + 1 and delta("verify") >= 1
    assert delta("step") == 0
    assert _series(after, "serve_spec_dispatches_per_token") == pytest.approx(
        pool.spec_snapshot()["dispatches_per_token"], abs=1e-4)
