"""The port's chunked serving decoder, its prompt cache, the rolling
window cache and ``serve_lm``'s default mode against the JAX package's,
on the CPU (``llama_tiny``, float32, one bridged flax param tree).

- ``ChunkedServingDecoder``: greedy rows equal the JAX decoder's exactly
  (full cache and rolling window), with the same ``prefill`` and
  ``decode`` dispatch counts; chunked prefill equals one-shot prefill;
  seeded sampling repeats and stays in range, top_k 1 is greedy;
  concurrent request threads; the JAX decoder's validation messages;
  widths capped at the window.
- The prompt cache: a hit is exact and skips prefill, LRU eviction, the
  ``mode="chunked"`` counters equal the JAX decoder's, a decode after a
  hit leaves the stored entry as it was, and two threads hitting one
  entry at once both get the miss's row.
- The rolling cache: window-sized, positions -1 when empty; an apply
  wider than the window is refused; a windowed ``generate`` across the
  wrap equals a full recompute and the JAX rows.
- ``serve_lm``: no ``--batching`` serves the chunked decoder over HTTP
  with the JAX server's samples, keys, no-pool endpoints and
  ``/metrics`` families; ``--prompt-cache`` beside ``--batching`` is
  refused; the flags match the JAX server's or are listed.

Deliberate differences pinned here: the port decodes exactly
``max_new_tokens`` steps (the JAX decoder rounds its budget up to a power
of two and keeps the first n: the same tokens); it compiles nothing, so
it has no ``compile_count`` and ``/metrics`` has no
``serve_decoder_compiles`` line (nor, on the CPU, the compile ledger's
families); samples draw from a ``torch.Generator``.
"""

import ast
import json
import os
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from tf_operator_tpu.models import generate as j_generate
from tf_operator_tpu.models import llama_tiny as j_llama_tiny
from tf_operator_tpu.models import decode as j_decode
from tf_operator_tpu.utils import metrics as j_metrics

from tf_operator_tpu_torch import serve_lm
from tf_operator_tpu_torch.models import decode
from tf_operator_tpu_torch.models.decode import (
    ChunkedServingDecoder,
    decode_variant,
    generate,
    init_cache,
)
from tf_operator_tpu_torch.models.llama import LlamaLM, llama_tiny
from tf_operator_tpu_torch.models.weights import from_flax_params
from tf_operator_tpu_torch.utils import metrics

torch.set_num_threads(2)

VOCAB, MAX_LEN, WINDOW = 256, 64, 8


def _bridged(window=None, seed=1):
    """(JAX model, numpy params, the port's model) of one init."""

    jm = j_llama_tiny(vocab_size=VOCAB, max_len=MAX_LEN, window=window, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, flax.core.meta.unbox(params))
    cfg = llama_tiny(vocab_size=VOCAB, max_len=MAX_LEN, window=window, dtype=torch.float32)
    return jm, params, LlamaLM.from_state_dict(cfg, from_flax_params(params), "cpu")


@pytest.fixture(scope="module")
def tiny():
    return _bridged()


@pytest.fixture(scope="module")
def windowed():
    return _bridged(window=WINDOW, seed=2)


def _prompt(p_len, seed=0, batch=1):
    return np.random.RandomState(seed).randint(0, VOCAB, size=(batch, p_len)).astype(np.int32)


def _port(arr):
    return torch.as_tensor(arr.astype(np.int64))


def _recompute(model, prompt, n):
    """No-cache greedy: the full forward over the growing row."""

    ids = _port(prompt)
    with torch.inference_mode():
        for _ in range(n):
            nxt = model(ids)[:, -1].argmax(-1)
            ids = torch.cat([ids, nxt[:, None]], dim=1)
    return ids.numpy()


# -- the chunk widths ----------------------------------------------------------


@pytest.mark.parametrize("n", [1, 5, 37, 64, 100])
def test_chunk_widths_equal_the_jax_ones(n):
    assert decode.binary_chunks(n) == j_decode.binary_chunks(n)
    for cap in (None, 8, 16):
        assert decode.window_chunks(n, cap) == j_decode.window_chunks(n, cap)
    for window in (None, 8, 12, MAX_LEN):
        cfg = llama_tiny(vocab_size=VOCAB, max_len=MAX_LEN, window=window)
        jcfg = j_llama_tiny(vocab_size=VOCAB, max_len=MAX_LEN, window=window).cfg
        assert decode.max_window_chunk(cfg) == j_decode.max_window_chunk(jcfg)


# -- the chunked decoder ---------------------------------------------------------


@pytest.mark.parametrize("p_len", [37, 63])
def test_chunked_prefill_equals_one_shot(tiny, p_len):
    _, _, model = tiny
    dmodel = decode_variant(model)
    prompt = _port(_prompt(p_len, seed=p_len))
    dec = ChunkedServingDecoder(model)
    assert len(dec._chunks(p_len)) > 1
    with torch.inference_mode():
        cache, off = init_cache(dmodel, 1), 0
        for w in dec._chunks(p_len):
            last = dmodel(prompt[:, off : off + w], cache=cache)[:, -1]
            off += w
        one_shot = dmodel(prompt, cache=init_cache(dmodel, 1))[:, -1]
    torch.testing.assert_close(last, one_shot, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("which", ["full", "windowed"])
def test_greedy_rows_and_dispatches_equal_the_jax_decoder(tiny, windowed, which):
    jm, params, model = tiny if which == "full" else windowed
    jdec = j_decode.ChunkedServingDecoder(jm, params, ledger=j_metrics.DispatchLedger())
    dec = ChunkedServingDecoder(model)
    for p_len, n in ((1, 7), (5, 7), (21, 9), (37, 6)):
        prompt = _prompt(p_len, seed=p_len, batch=2)
        want = np.asarray(jdec.generate(jnp.asarray(prompt), n))
        got = dec.generate(_port(prompt), n).numpy()
        np.testing.assert_array_equal(got, want)
    for phase in ("prefill", "decode"):
        assert dec.ledger.count(phase) == jdec.ledger.count(phase), phase


def test_decodes_exactly_the_budget_and_keeps_the_leading_tokens(tiny):
    """The port decodes ``max_new_tokens`` steps, where the JAX decoder
    decodes a power-of-two budget (64 for 33) and keeps the first n:
    the kept tokens are the same, and a longer request's leading tokens
    are a shorter one's."""

    jm, params, model = tiny
    dec = ChunkedServingDecoder(model)
    calls = []
    forward = dec.dmodel.forward

    def counted(*a, **kw):
        calls.append(a[0].shape[1])
        return forward(*a, **kw)

    dec.dmodel.forward = counted
    prompt = _prompt(20, seed=3)
    long = dec.generate(_port(prompt), 33).numpy()
    assert calls == decode.binary_chunks(20) + [1] * 32
    assert not hasattr(dec, "compile_count")
    np.testing.assert_array_equal(
        long, np.asarray(j_decode.ChunkedServingDecoder(jm, params).generate(
            jnp.asarray(prompt), 33)))
    short = dec.generate(_port(prompt), 12).numpy()
    np.testing.assert_array_equal(long[:, : 20 + 12], short)


def test_sampling_repeats_stays_in_range_and_top_k_1_is_greedy(tiny):
    _, _, model = tiny
    dec = ChunkedServingDecoder(model)
    prompt = _port(_prompt(13, seed=1))

    def sampled(seed, **kw):
        g = torch.Generator().manual_seed(seed)
        return dec.generate(prompt, 6, temperature=0.8, generator=g, **kw).numpy()

    a, b = sampled(3, top_k=8), sampled(3, top_k=8)
    np.testing.assert_array_equal(a, b)
    gen = a[:, 13:]
    assert gen.shape == (1, 6) and gen.min() >= 0 and gen.max() < VOCAB
    np.testing.assert_array_equal(sampled(4, top_k=1), dec.generate(prompt, 6).numpy())
    # draws stay in the top-k support of the logits they came from
    toks = sampled(5, top_k=3)[0]
    with torch.inference_mode():
        logits = model(torch.as_tensor(toks[None]))[0, 12:-1] / 0.8
    top3 = torch.topk(logits, 3).indices.numpy()
    assert all(t in row for t, row in zip(toks[13:], top3))


def test_concurrent_request_threads(tiny):
    """serve_lm's request threads run the decoder at once: each row
    equals the row of the same request alone."""

    _, _, model = tiny
    dec = ChunkedServingDecoder(model, prompt_cache=4)
    prompts = [_prompt(int(n), seed=i) for i, n in enumerate((3, 17, 9, 30, 17, 3))]
    solo = [generate(model, _port(p), 5).numpy() for p in prompts]
    out = [None] * len(prompts)
    errors = []

    def one(i):
        try:
            out[i] = dec.generate(_port(prompts[i]), 5).numpy()
        except Exception as exc:  # surfaced below
            errors.append(repr(exc))

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    for got, want in zip(out, solo):
        np.testing.assert_array_equal(got, want)
    assert dec._prompt_cache.hits + dec._prompt_cache.misses == len(prompts)


def test_validation_messages_are_the_jax_decoders(tiny):
    jm, params, model = tiny
    jdec = j_decode.ChunkedServingDecoder(jm, params)
    dec = ChunkedServingDecoder(model)
    for args, kw in (((np.zeros((1, 4), np.int32), 4), {"temperature": -0.5}),
                     ((np.zeros((1, 4), np.int32), 61), {}),
                     ((np.zeros((1, 0), np.int32), 4), {}),
                     ((np.zeros((1, 4), np.int32), 0), {})):
        with pytest.raises(ValueError) as want:
            jdec.generate(jnp.asarray(args[0]), args[1], **kw)
        with pytest.raises(ValueError) as got:
            dec.generate(_port(args[0]), args[1], **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="torch.Generator"):
        dec.generate(_port(np.zeros((1, 4), np.int32)), 4, temperature=0.5)


# -- the rolling window cache ------------------------------------------------------


def test_rolling_cache_is_window_sized(tiny, windowed):
    cache = init_cache(windowed[2], 3)
    assert cache.layers[0][0].shape == (3, 2, WINDOW, 32)  # the window, not max_len
    assert cache.pos.shape == (3, WINDOW) and (cache.pos == -1).all()
    full = init_cache(tiny[2], 1)
    assert full.pos is None and full.layers[0][0].shape[2] == MAX_LEN


def test_oversized_single_apply_is_refused(windowed):
    _, _, model = windowed
    dmodel = decode_variant(model)
    with pytest.raises(ValueError, match="window"):
        dmodel(torch.zeros((1, 2 * WINDOW), dtype=torch.long), cache=init_cache(dmodel, 1))
    with pytest.raises(ValueError, match="rolling"):
        # a rolling model on a non-rolling cache
        dmodel(torch.zeros((1, 2), dtype=torch.long),
               cache=decode.DecodeCache(init_cache(dmodel, 1).layers))


def test_widths_are_capped_at_the_window(windowed):
    jm, params, model = windowed
    dec = ChunkedServingDecoder(model)
    assert max(dec._chunks(37)) <= WINDOW
    assert dec._chunks(37) == j_decode.ChunkedServingDecoder(jm, params)._chunks(37)


@pytest.mark.parametrize("p_len", [5, 8, 21])
def test_windowed_generate_across_the_wrap(windowed, p_len):
    """Positions run past the window (8): the rows equal the full
    recompute and the JAX ``generate``, p_len 21 prefilling in three
    window-sized chunks."""

    jm, params, model = windowed
    prompt = _prompt(p_len, seed=1, batch=2)
    got = generate(model, _port(prompt), 8).numpy()
    np.testing.assert_array_equal(got, _recompute(model, prompt, 8))
    np.testing.assert_array_equal(
        got, np.asarray(j_generate(jm, params, jnp.asarray(prompt), max_new_tokens=8)))


def test_set_cache_index_rolls_back(tiny, windowed):
    _, _, model = tiny
    dmodel = decode_variant(model)
    prompt = _port(_prompt(12, seed=6))
    with torch.inference_mode():
        cache = init_cache(dmodel, 1)
        dmodel(prompt, cache=cache)
        decode.set_cache_index(cache, 7)
        rolled = dmodel(prompt[:, 7:9], cache=cache)
        fresh = init_cache(dmodel, 1)
        dmodel(prompt[:, :7], cache=fresh)
        want = dmodel(prompt[:, 7:9], cache=fresh)
    torch.testing.assert_close(rolled, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="rolling"):
        decode.set_cache_index(init_cache(windowed[2], 1), 0)


# -- the prompt cache ---------------------------------------------------------------


def test_hit_is_exact_and_skips_prefill(tiny):
    _, _, model = tiny
    dec = ChunkedServingDecoder(model, prompt_cache=4)
    prompt = _port(_prompt(9))
    first = dec.generate(prompt, 6).numpy()
    prefills = dec.ledger.count("prefill")
    assert dec.prompt_cache_hits == 0
    np.testing.assert_array_equal(dec.generate(prompt, 6).numpy(), first)
    assert dec.prompt_cache_hits == 1 and dec.ledger.count("prefill") == prefills
    longer = dec.generate(prompt, 11).numpy()  # a new budget: still a hit
    assert dec.prompt_cache_hits == 2 and longer.shape == (1, 20)
    np.testing.assert_array_equal(longer[:, :15], first)
    assert dec.ledger.count("decode") == 3


def test_lru_eviction_and_distinct_prompts(tiny):
    _, _, model = tiny
    dec = ChunkedServingDecoder(model, prompt_cache=2)
    prompts = [_port(_prompt(7, seed=s)) for s in (5, 6, 7)]
    outs = [dec.generate(p, 4).numpy() for p in prompts]
    assert dec.prompt_cache_hits == 0
    np.testing.assert_array_equal(dec.generate(prompts[2], 4).numpy(), outs[2])
    assert dec.prompt_cache_hits == 1
    # prompts[0] was evicted: a miss that prefills again
    np.testing.assert_array_equal(dec.generate(prompts[0], 4).numpy(), outs[0])
    assert dec.prompt_cache_hits == 1 and dec._prompt_cache.evictions == 2


@pytest.mark.parametrize("which", ["full", "windowed"])
def test_prompt_cache_counters_equal_the_jax_decoders(tiny, windowed, which):
    jm, params, model = tiny if which == "full" else windowed
    jm_reg, reg = j_metrics.Metrics(), metrics.Metrics()
    jdec = j_decode.ChunkedServingDecoder(jm, params, prompt_cache=2,
                                          ledger=j_metrics.DispatchLedger(metrics=jm_reg))
    dec = ChunkedServingDecoder(model, prompt_cache=2,
                                ledger=metrics.DispatchLedger(metrics=reg))
    prompts = [_prompt(n, seed=n) for n in (5, 11, 5, 20, 11, 5)]
    for p in prompts:
        want = np.asarray(jdec.generate(jnp.asarray(p), 4))
        np.testing.assert_array_equal(dec.generate(_port(p), 4).numpy(), want)
    for name in ("serve_prefix_cache_hits_total", "serve_prefix_cache_misses_total",
                 "serve_prefix_cache_evictions_total"):
        assert reg.counter(name, mode="chunked") == jm_reg.counter(name, mode="chunked"), name
    assert dec.prompt_cache_hits == jdec.prompt_cache_hits > 0
    for phase in ("prefill", "decode"):
        assert dec.ledger.count(phase) == jdec.ledger.count(phase), phase


@pytest.mark.parametrize("which", ["full", "windowed"])
def test_a_decode_after_a_hit_leaves_the_entry_unchanged(tiny, windowed, which):
    _, _, model = tiny if which == "full" else windowed
    dec = ChunkedServingDecoder(model, prompt_cache=2)
    prompt = _port(_prompt(21, seed=8))
    first = dec.generate(prompt, 12).numpy()
    (entry,) = dec._prompt_cache._entries.values()
    layers, pos, last = entry
    kept = ([(k.clone(), v.clone()) for k, v in layers],
            None if pos is None else pos.clone(), last.clone())
    for _ in range(2):
        np.testing.assert_array_equal(dec.generate(prompt, 12).numpy(), first)
    for (k, v), (k0, v0) in zip(layers, kept[0]):
        assert torch.equal(k, k0) and torch.equal(v, v0)
    assert torch.equal(last, kept[2]) and (pos is None or torch.equal(pos, kept[1]))
    assert dec.prompt_cache_hits == 2


def test_two_threads_hitting_one_entry_get_the_misses_row(tiny):
    _, _, model = tiny
    dec = ChunkedServingDecoder(model, prompt_cache=2)
    prompt = _port(_prompt(15, seed=9))
    want = dec.generate(prompt, 10).numpy()
    barrier = threading.Barrier(2)
    out = [None, None]

    def one(i):
        barrier.wait()
        out[i] = dec.generate(prompt, 10).numpy()

    threads = [threading.Thread(target=one, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for got in out:
        np.testing.assert_array_equal(got, want)
    assert dec.prompt_cache_hits == 2


def test_prompt_cache_is_off_by_default(tiny):
    _, _, model = tiny
    dec = ChunkedServingDecoder(model)
    prompt = _port(_prompt(6))
    dec.generate(prompt, 3)
    dec.generate(prompt, 3)
    assert dec.prompt_cache_hits == 0 and dec.ledger.count("prefill") == 2 * len(
        decode.binary_chunks(6))


# -- serve_lm's default mode ---------------------------------------------------------


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                 data=json.dumps(body).encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read()), dict(exc.headers)


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=120) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def _names(text):
    return {line.split("{")[0].split(" ")[0] for line in text.splitlines()
            if line and not line.startswith("#")}


@pytest.fixture(scope="module")
def chunked_servers(tiny, tmp_path_factory):
    """The JAX server's chunked handler (its default, ``batching_slots=0``)
    and the port's server built from ``serve_lm``'s default flags, with
    ``--prompt-cache 2``, over the same weights: (port, JAX port,
    decoder)."""

    from tests.testutil import load_serve_lm

    jm, params, model = tiny
    handler = load_serve_lm().build_handler(jm, params, MAX_LEN, prompt_cache=2,
                                            model_label="llama")
    jserver = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=jserver.serve_forever, daemon=True).start()
    args = serve_lm.build_parser().parse_args(["--device", "cpu", "--prompt-cache", "2"])
    decoder = serve_lm.build_decoder(model, args)
    assert isinstance(decoder, ChunkedServingDecoder)
    server = serve_lm.Server(decoder, model_label="llama").start()
    try:
        yield server.port, jserver.server_address[1], decoder
    finally:
        server.close()
        jserver.shutdown()
        jserver.server_close()


def test_the_default_mode_is_chunked_over_http(chunked_servers):
    port, jport, decoder = chunked_servers
    before = decoder.ledger.count("decode")
    for body in ({"prompt": "the sharded tensor ", "max_new_tokens": 12},
                 {"prompt": "the sharded tensor ", "max_new_tokens": 12},
                 {"prompt": "a seeded one ", "max_new_tokens": 8, "seed": 3, "top_k": 300},
                 {"prompt": "stop here", "max_new_tokens": 10, "stop": "e"}):
        (code, got, headers), (jcode, want, _) = _post(port, body), _post(jport, body)
        assert code == jcode == 200
        assert set(got) == set(want) == {"prompt", "sample", "seed"}
        assert headers["x-trace-id"]
        if "seed" in body:
            assert got["seed"] == want["seed"]
        else:
            assert got["sample"] == want["sample"]
    assert decoder.ledger.count("decode") == before + 4
    assert decoder.prompt_cache_hits >= 1
    for bad in ({"prompt": ""}, {"prompt": "x" * 60, "max_new_tokens": 8},
                {"prompt": "x", "top_k": 0}, {"prompt": "x", "tier": "gold"}):
        (code, got, _), (jcode, want, _) = _post(port, bad), _post(jport, bad)
        assert code == jcode == 400 and got == want


def test_chunked_metrics_families_equal_the_jax_servers(chunked_servers):
    from test_torch_serving_plane import COSTPLANE_FAMILIES

    port, jport, decoder = chunked_servers
    body = {"prompt": "families of the chunked mode ", "max_new_tokens": 5}
    for p in (port, jport):
        _post(p, body)
        _post(p, body)
    got, want = [_get(p, "/metrics")[1].decode() for p in (port, jport)]
    costplane = {n for n in _names(want) if n.split("_bucket")[0].split("_sum")[0]
                 .split("_count")[0] in COSTPLANE_FAMILIES}
    assert _names(want) - _names(got) - costplane == {"serve_decoder_compiles"}
    assert _names(got) <= _names(want)
    assert f"serve_prompt_cache_hits {decoder.prompt_cache_hits}" in got
    reg = decoder.ledger.metrics
    assert reg.counter("serve_prefix_cache_hits_total", mode="chunked") == \
        decoder.prompt_cache_hits
    for fam in ("serve_ttft_seconds", "serve_queue_wait_seconds",
                "serve_time_per_output_token_seconds"):
        series = reg.histogram_family_merged(fam)
        assert {dict(labels)["mode"] for labels in series} == {"chunked"}, fam


@pytest.mark.parametrize("path", ["/requests", "/requests/no-such-id", "/debug/arena", "/slo",
                                  "/alerts", "/debug/compiles", "/debug/memory"])
def test_chunked_endpoints_answer_the_jax_no_pool_shapes(chunked_servers, path):
    port, jport, _ = chunked_servers
    _post(port, {"prompt": "shapes ", "max_new_tokens": 3})
    _post(jport, {"prompt": "shapes ", "max_new_tokens": 3})
    (code, raw), (jcode, jraw) = _get(port, path), _get(jport, path)
    assert code == jcode
    got, want = json.loads(raw), json.loads(jraw)
    assert sorted(got) == sorted(want)
    if path in ("/requests", "/debug/arena", "/requests/no-such-id"):
        assert got == want
    if path == "/slo":
        assert sorted(got["gauges"]) == sorted(want["gauges"])
        ttft = got["histograms"]["serve_ttft_seconds"]
        assert ttft and {row["mode"] for row in ttft} == {"chunked"}


def test_chunked_debug_profile_has_no_idle_refusal(chunked_servers, tmp_path, monkeypatch):
    monkeypatch.setenv("TPUJOB_PROFILE_DIR", str(tmp_path))
    port, jport, _ = chunked_servers
    code, raw = _get(port, "/debug/profile?seconds=0.2")
    assert code == 200, raw
    body = json.loads(raw)
    assert sorted(os.listdir(body["artifact"])) == ["COSTPLANE.json", "trace.json"]


def test_prompt_cache_beside_batching_is_refused(tiny):
    from tests.testutil import load_serve_lm

    jm, params, model = tiny
    with pytest.raises(ValueError) as want:
        load_serve_lm().build_handler(jm, params, MAX_LEN, batching_slots=2, prompt_cache=2)
    args = serve_lm.build_parser().parse_args(["--device", "cpu", "--batching", "2",
                                               "--prompt-cache", "2"])
    with pytest.raises(ValueError) as got:
        serve_lm.build_decoder(model, args)
    assert str(got.value) == str(want.value)


def _jax_flags():
    """{flag: default} of the JAX server's parser (``examples/serve_lm.py``
    ``main``), read from its source: the parser is built inside ``main``."""

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples", "serve_lm.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    flags = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            kw = {k.arg: ast.literal_eval(k.value) for k in node.keywords
                  if k.arg in ("default", "action")}
            # argparse's own default: False for store_true, else None
            store_true = kw.get("action") == "store_true"
            flags[node.args[0].value] = kw.get("default", False if store_true else None)
    return flags


#: the port's own flags, and the JAX server's flags it leaves out
PORT_ONLY_FLAGS = {"--model", "--init-seed", "--steps-per-sync", "--device"}
#: the seeded shapes of the port-only --model: llama's and the decoder zoo's
PORT_ONLY_MODELS = ["llama-7b", "llama-tiny", "gpt-small", "gpt-tiny", "moe-tiny",
                    "moe-gpt-small"]
NOT_PORTED_FLAGS = {"--platform"}


def test_flags_match_the_reference_or_are_listed(capsys):
    jax_flags = _jax_flags()
    parser = serve_lm.build_parser()
    port = {a.option_strings[0]: a.default for a in parser._actions if a.option_strings
            and a.option_strings[0] != "-h"}
    assert set(port) - set(jax_flags) == PORT_ONLY_FLAGS
    assert set(jax_flags) - set(port) == NOT_PORTED_FLAGS
    for flag in set(port) & set(jax_flags):
        assert port[flag] == jax_flags[flag], flag
    # --artifact is optional where the JAX server requires it
    assert parser.parse_args([]).artifact is None
    model = next(a for a in parser._actions if a.option_strings == ["--model"])
    assert list(model.choices) == PORT_ONLY_MODELS and model.default == "llama-tiny"
    for mode in ("auto", "on"):
        assert parser.parse_args(["--paged-kernel", mode]).paged_kernel == mode
    for mode in ("off", "interpret"):
        with pytest.raises(SystemExit):
            parser.parse_args(["--paged-kernel", mode])
        assert "no fallback" in capsys.readouterr().err
