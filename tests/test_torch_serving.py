"""The port's paged pool and HTTP server against the JAX package's, on
the CPU (``llama_tiny``, float32, one bridged flax param tree).

Greedy tokens must match byte for byte: the port's pool against JAX's
``PagedContinuousBatchingDecoder(reserve="worst-case")`` on both its
gather emulation (``paged_kernel="off"``) and the Pallas kernel in
interpret mode, and the port's ``/generate`` against the JAX server's
pool handler.
"""

import json
import os
import subprocess
import sys
import threading
import types
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

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
from tf_operator_tpu.models.registry import describe_model

from tf_operator_tpu_torch import resolve_device
from tf_operator_tpu_torch.models.batching import PagedContinuousBatchingDecoder
from tf_operator_tpu_torch.models.decode import generate
from tf_operator_tpu_torch.models.llama import LlamaLM, llama_tiny
from tf_operator_tpu_torch.models.weights import from_flax_params, load_npz
from tf_operator_tpu_torch.ops.quant import quantize_state
from tf_operator_tpu_torch.parallel.checkpoint import export_params
from tf_operator_tpu_torch import serve_lm

torch.set_num_threads(2)

VOCAB, MAX_LEN, BS = 256, 64, 8


@pytest.fixture(scope="module")
def tiny():
    jm = j_llama_tiny(vocab_size=VOCAB, max_len=MAX_LEN, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(11), jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, flax.core.meta.unbox(params))
    cfg = llama_tiny(vocab_size=VOCAB, max_len=MAX_LEN, dtype=torch.float32)
    model = LlamaLM.from_state_dict(cfg, from_flax_params(params), "cpu")
    return jm, params, model


def _mix():
    """More requests than slots; prompt lengths at the block edge
    (7, 8, 9 with bs 8); two requests sharing a two-block prefix (the
    second admits after the first published it); a budget-1 request."""

    r = np.random.default_rng(0)
    shared = r.integers(0, VOCAB, 2 * BS)
    return [
        (r.integers(0, VOCAB, 7), 9),
        (np.concatenate([shared, r.integers(0, VOCAB, 5)]), 6),
        (r.integers(0, VOCAB, 8), 1),
        (np.concatenate([shared, r.integers(0, VOCAB, 3)]), 7),
        (r.integers(0, VOCAB, 9), 5),
    ]


def _run_port(model, mix):
    pool = PagedContinuousBatchingDecoder(
        model, slots=2, steps_per_sync=4, kv_block_size=BS, kv_blocks=24,
    )
    rids = [pool.submit(p, n) for p, n in mix]
    pool.run()
    pool.alloc.check()
    return pool, [pool.result(r) for r in rids]


@pytest.mark.parametrize("paged_kernel", ["off", "interpret"])
def test_pool_is_token_identical_to_jax(tiny, paged_kernel):
    jm, params, model = tiny
    mix = _mix()
    jpool = JaxPool(
        jm, params, slots=2, steps_per_sync=4, kv_block_size=BS, kv_blocks=24,
        paged_kernel=paged_kernel, reserve="worst-case",
    )
    jrids = [jpool.submit(p, n) for p, n in mix]
    jpool.run()
    want = [jpool.result(r) for r in jrids]
    pool, got = _run_port(model, mix)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # the second shared-prefix request mapped both published blocks
    recent = {rec["rid"]: rec for rec in pool.recent}
    assert recent[3]["prefix_tokens"] == 2 * BS
    assert recent[1]["prefix_tokens"] == 0
    assert pool.prefix.hits == jpool.prefix.hits
    # the same schedule: one admission per request, the same windows and
    # retire batches as the JAX pool's dispatch ledger
    assert dict(pool.dispatches) == {
        phase: jpool.ledger.count(phase) for phase in ("admission", "step", "retire")}


def test_pool_matches_port_generate_and_frees_everything(tiny):
    _, _, model = tiny
    mix = _mix()
    pool, got = _run_port(model, mix)
    for (p, n), g in zip(mix, got):
        want = generate(model, torch.as_tensor(p[None].astype(np.int64)), n).numpy()[0]
        np.testing.assert_array_equal(g, want)
    # every seat retired: only prefix-cache references stay live
    assert pool.alloc.in_use == len(pool.prefix)
    assert not pool._active and not pool._queue
    assert (pool._tables_dev == 0).all() and (pool._lengths_dev == 0).all()


def test_pool_sampling_law(tiny):
    _, _, model = tiny
    prompt = np.arange(5, 17)

    def one(seed, **kw):
        pool = PagedContinuousBatchingDecoder(model, slots=2, steps_per_sync=3,
                                              kv_block_size=BS)
        g = torch.Generator().manual_seed(seed)
        rid = pool.submit(prompt, 8, temperature=0.9, generator=g, **kw)
        pool.run()
        return pool.result(rid)[len(prompt):]

    greedy_pool = PagedContinuousBatchingDecoder(model, slots=1, kv_block_size=BS)
    rid = greedy_pool.submit(prompt, 8)
    greedy_pool.run()
    greedy = greedy_pool.result(rid)[len(prompt):]
    np.testing.assert_array_equal(one(1, top_k=1), greedy)
    np.testing.assert_array_equal(one(2), one(2))
    # draws stay inside the top-k support of the logits they came from
    toks = one(3, top_k=3)
    seq = torch.as_tensor(np.concatenate([prompt, toks])[None].astype(np.int64))
    with torch.inference_mode():
        logits = model(seq)[0, len(prompt) - 1 : -1] / 0.9
    top3 = torch.topk(logits, 3).indices.numpy()
    assert all(t in row for t, row in zip(toks, top3))


def test_pool_refuses_what_could_never_fit(tiny):
    _, _, model = tiny
    pool = PagedContinuousBatchingDecoder(model, slots=2, kv_block_size=BS, kv_blocks=2)
    with pytest.raises(ValueError, match="KV blocks"):
        pool.submit(np.arange(20), 4)
    with pytest.raises(ValueError, match="Generator"):
        pool.submit(np.arange(3), 4, temperature=0.5)
    with pytest.raises(ValueError, match="top_k"):
        pool.submit(np.arange(3), 4, temperature=0.5, top_k=65,
                    generator=torch.Generator())
    with pytest.raises(ValueError, match="divide"):
        PagedContinuousBatchingDecoder(model, kv_block_size=7)


def _post(port, payload, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(payload).encode(),
        method="POST", headers=headers or {},
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def test_serve_lm_matches_the_jax_server(tiny, tmp_path):
    jm, params, _ = tiny
    npz = tmp_path / "params.npz"
    flat = {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(params)}
    np.savez(npz, **flat)
    desc = describe_model(jm)
    (tmp_path / "model.json").write_text(json.dumps(desc))

    from tests.testutil import load_serve_lm

    handler = load_serve_lm().build_handler(
        jm, params, max_len=MAX_LEN, batching_slots=2, paged_kernel="off",
    )
    jserver = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=jserver.serve_forever, daemon=True).start()

    model = serve_lm.load_model(resolve_device("cpu"), max_len=MAX_LEN,
                                artifact=str(tmp_path))
    pool = PagedContinuousBatchingDecoder(model, slots=2, kv_block_size=16)
    server = serve_lm.Server(pool).start()
    try:
        body = {"prompt": "the sharded tensor ", "max_new_tokens": 12, "seed": 4}
        code, got = _post(server.port, body)
        jcode, want = _post(jserver.server_address[1], body)
        assert code == jcode == 200
        assert got == {"prompt": want["prompt"], "sample": want["sample"],
                       "seed": want["seed"]}
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/healthz", timeout=30) as resp:
            assert json.loads(resp.read()) == {"ok": True}
        bad_tier = {"error": "tier must be 'interactive' or 'batch'"}
        for bad, headers in (({"prompt": "", "max_new_tokens": 4}, None),
                             ({"prompt": "x" * 60, "max_new_tokens": 8}, None),
                             ({"prompt": "x", "temperature": -1}, None),
                             ({"prompt": "x", "stop": 3}, None),
                             ({"prompt": "x", "tier": "gold"}, None),
                             # a falsy body tier is validated, not replaced
                             ({"prompt": "x", "tier": ""}, {"x-slo-tier": "batch"}),
                             ({"prompt": "x"}, {"x-slo-tier": "interactiv"}),
                             ({"prompt": "x", "tier": "platinum"}, {"x-slo-tier": "batch"})):
            code, got = _post(server.port, bad, headers)
            jcode, want = _post(jserver.server_address[1], bad, headers)
            assert code == jcode == 400
            assert got == want
            if "tier" in bad or headers:
                assert got == bad_tier
        # the body's valid tier wins over a bad header, in both servers
        body = {"prompt": "the sharded tensor ", "max_new_tokens": 12, "tier": "batch"}
        code, got = _post(server.port, body, {"x-slo-tier": "gold"})
        jcode, want = _post(jserver.server_address[1], body, {"x-slo-tier": "gold"})
        assert code == jcode == 200 and got["sample"] == want["sample"]
    finally:
        server.close()
        jserver.shutdown()
        jserver.server_close()


def test_interactive_tier_is_refused_until_slo_tiers_are_ported(tiny):
    """A deliberate difference: the JAX server serves ``interactive``
    with priority admission; the port has no SLO tiers yet and answers
    a 400 that says so, from the body or the header, rather than serve
    the request as batch."""

    _, _, model = tiny
    pool = PagedContinuousBatchingDecoder(model, slots=2, kv_block_size=16)
    server = serve_lm.Server(pool).start()
    try:
        for body, headers in (({"prompt": "x", "tier": "interactive"}, None),
                              ({"prompt": "x"}, {"x-slo-tier": "interactive"})):
            code, got = _post(server.port, body, headers)
            assert code == 400
            assert got == {"error": serve_lm.INTERACTIVE_REFUSED}
            assert "not ported" in got["error"]
        code, got = _post(server.port, {"prompt": "x", "max_new_tokens": 2},
                          {"x-slo-tier": "batch"})
        assert code == 200 and len(got["sample"]) == 2
        assert pool.dispatches["admission"] == 1
    finally:
        server.close()


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["float", "int8"])
def test_serve_lm_cli_serves_an_export_params_artifact(tiny, tmp_path, quantize):
    """``python -m tf_operator_tpu_torch.serve_lm --artifact DIR``, the
    JAX server's flag, serves the directory ``export_params`` wrote; with
    ``--quantize int8`` it serves the int8 model (the greedy bytes of the
    same model quantized in this process)."""

    _, _, model = tiny
    export_params(types.SimpleNamespace(model=model), str(tmp_path))
    prompt = "the sharded tensor "
    ids = torch.as_tensor([list(prompt.encode())])
    ref = model
    if quantize:
        ref = LlamaLM.from_state_dict(model.cfg, quantize_state(load_npz(
            str(tmp_path / "params.npz"))), "cpu")
    want = generate(ref, ids, 12)[0, len(prompt):]
    argv = [sys.executable, "-m", "tf_operator_tpu_torch.serve_lm", "--artifact", str(tmp_path),
            "--device", "cpu", "--port", "0", "--max-len", str(MAX_LEN), "--batching", "2"]
    if quantize:
        argv += ["--quantize", quantize]
    proc = subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        lines = [proc.stdout.readline()]
        if quantize:
            assert lines[0].startswith("int8 weights-only quantization: params "), lines
            lines.append(proc.stdout.readline())
        assert lines[-1].startswith("serving on 127.0.0.1:"), lines + [proc.stdout.read()]
        port = int(lines[-1].split(":")[1].split()[0])
        code, got = _post(port, {"prompt": prompt, "max_new_tokens": 12})
        assert code == 200
        assert got["sample"] == bytes(want.tolist()).decode("ascii", "replace")
    finally:
        proc.kill()
        proc.communicate(timeout=60)


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lm.main(["--model", "llama-tiny", "--port", "0"])
    assert resolve_device("cpu") == torch.device("cpu")
