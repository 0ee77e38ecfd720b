"""The port's paged pool and HTTP server against the JAX package's, on
the CPU (``llama_tiny``, float32, one bridged flax param tree).

Greedy tokens must match byte for byte: the port's pool against JAX's
``PagedContinuousBatchingDecoder`` on both its gather emulation
(``paged_kernel="off"``) and the Pallas kernel in interpret mode, and
the port's ``/generate`` against the JAX server's pool handler, in both
SLO tiers.  Both pools reserve lazily by default; below the default
arena both admit what their ``reserve="worst-case"`` mode queues, with
the same tokens.  Preemption and swap are held in
``tests/test_torch_preemption.py``.
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
    recent = {rec["rid"]: rec for rec in pool.request_log.recent(256)}
    assert recent[3]["admission"]["prefix_hit_tokens"] == 2 * BS
    assert recent[1]["admission"]["prefix_hit_tokens"] == 0
    assert pool.prefix.hits == jpool.prefix.hits
    # the same schedule: one admission per request, the same windows and
    # retire batches as the JAX pool's dispatch ledger
    phases = ("admission", "step", "retire")
    assert {phase: pool.ledger.count(phase) for phase in phases} == {
        phase: jpool.ledger.count(phase) for phase in phases}


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


@pytest.fixture(scope="module")
def servers(tiny, tmp_path_factory):
    """The JAX server's pool handler and the port's server over the same
    exported weights: (port's port, JAX server's port, port's pool)."""

    jm, params, _ = tiny
    art = tmp_path_factory.mktemp("artifact")
    flat = {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(params)}
    np.savez(art / "params.npz", **flat)
    (art / "model.json").write_text(json.dumps(describe_model(jm)))

    from tests.testutil import load_serve_lm

    handler = load_serve_lm().build_handler(
        jm, params, max_len=MAX_LEN, batching_slots=2, paged_kernel="off",
    )
    jserver = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=jserver.serve_forever, daemon=True).start()

    model = serve_lm.load_model(resolve_device("cpu"), max_len=MAX_LEN,
                                artifact=str(art))
    pool = serve_lm.make_pool(model, slots=2, kv_block_size=16)
    server = serve_lm.Server(pool).start()
    try:
        yield server.port, jserver.server_address[1], pool
    finally:
        server.close()
        jserver.shutdown()
        jserver.server_close()


def test_serve_lm_matches_the_jax_server(servers):
    port, jport, _ = servers
    body = {"prompt": "the sharded tensor ", "max_new_tokens": 12, "seed": 4}
    code, got = _post(port, body)
    jcode, want = _post(jport, body)
    assert code == jcode == 200
    assert set(got) == set(want) == {"prompt", "sample", "seed", "request_id"}
    assert {k: got[k] for k in ("prompt", "sample", "seed")} == {
        k: want[k] for k in ("prompt", "sample", "seed")}
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as resp:
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
        code, got = _post(port, bad, headers)
        jcode, want = _post(jport, bad, headers)
        assert code == jcode == 400
        assert got == want
        if "tier" in bad or headers:
            assert got == bad_tier
    # the body's valid tier wins over a bad header, in both servers
    body = {"prompt": "the sharded tensor ", "max_new_tokens": 12, "tier": "batch"}
    code, got = _post(port, body, {"x-slo-tier": "gold"})
    jcode, want = _post(jport, body, {"x-slo-tier": "gold"})
    assert code == jcode == 200 and got["sample"] == want["sample"]


@pytest.mark.parametrize("how", ["body", "header"])
def test_interactive_tier_is_served_as_the_jax_server_serves_it(servers, how):
    """``tier: interactive``, from the body or the ``x-slo-tier`` header,
    is served with the JAX server's greedy sample and reaches the pool
    as that tier; a body ``batch`` wins over the header."""

    port, jport, pool = servers
    for body in ({"prompt": "an interactive request ", "max_new_tokens": 10},
                 {"prompt": "and another ", "max_new_tokens": 6, "seed": 9}):
        headers = None
        if how == "body":
            body = dict(body, tier="interactive")
        else:
            headers = {"x-slo-tier": "interactive"}
        code, got = _post(port, body, headers)
        jcode, want = _post(jport, body, headers)
        assert code == jcode == 200
        assert got["sample"] == want["sample"]
        last = pool.request_log.recent(1)[0]
        assert (last["tier"], last["preempted"], last["state"]) == ("interactive", 0, "done")
    code, got = _post(port, {"prompt": "x", "max_new_tokens": 2, "tier": "batch"},
                      {"x-slo-tier": "interactive"})
    assert code == 200 and len(got["sample"]) == 2
    assert pool.request_log.recent(1)[0]["tier"] == "batch"


def test_kv_swap_blocks_flag_reaches_the_pool(tiny):
    """``--kv-swap-blocks N`` caps the pool's swap arena at N blocks, as
    the JAX server's flag does; without it the arena is unbounded and
    the pool reserves lazily."""

    _, _, model = tiny
    parser = serve_lm.build_parser()
    args = parser.parse_args(["--device", "cpu", "--batching", "2", "--kv-block-size", "8",
                              "--kv-swap-blocks", "3"])
    pool = serve_lm.build_pool(model, args)
    assert pool.swap.capacity_blocks == 3
    assert pool.swap.admit(3) and not pool.swap.admit(4)
    assert (pool.reserve, pool.slots, pool.block_size) == ("lazy", 2, 8)
    pool = serve_lm.build_pool(model, parser.parse_args(["--device", "cpu", "--batching", "8"]))
    assert pool.swap.capacity_blocks is None and pool.reserve == "lazy"


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


def test_lazy_jax_pool_admits_what_the_worst_case_port_queues(tiny):
    """Below slots x max_len / block blocks, both pools in their default
    ``reserve="lazy"`` (the JAX server builds its pool with no
    ``reserve``) admit two requests at once, and preempt one as they
    grow; in ``reserve="worst-case"`` both queue the second.  The greedy
    tokens are the same in all four runs and equal the port's
    ``generate``."""

    jm, params, model = tiny
    r = np.random.default_rng(1)
    mix = [(r.integers(0, VOCAB, 9), 20), (r.integers(0, VOCAB, 9), 20)]
    # each request's worst case is ceil((9 + 20) / 8) = 4 blocks: the six
    # usable blocks hold one worst case, and two prompts' blocks + 1
    kv_blocks = 6
    assert kv_blocks < 2 * MAX_LEN // BS
    want = [generate(model, torch.as_tensor(p[None].astype(np.int64)), n).numpy()[0]
            for p, n in mix]
    seated = {1: ("worst-case",), 2: ("lazy",)}
    for reserve in ("lazy", "worst-case"):
        kw = {} if reserve == "lazy" else {"reserve": reserve}
        jpool = JaxPool(jm, params, slots=2, steps_per_sync=4, kv_block_size=BS,
                        kv_blocks=kv_blocks, **kw)
        pool = PagedContinuousBatchingDecoder(model, slots=2, steps_per_sync=4,
                                              kv_block_size=BS, kv_blocks=kv_blocks, **kw)
        assert jpool.reserve == pool.reserve == reserve
        outs = []
        for p_ in (jpool, pool):
            rids = [p_.submit(p, n) for p, n in mix]
            p_.step()
            n_seated = len(p_._active)
            assert reserve in seated[n_seated] and len(p_._queue) == 2 - n_seated
            p_.run()
            p_.alloc.check()
            outs.append([p_.result(rid) for rid in rids])
        # lazy: the two seats outgrow the six blocks and one is preempted
        assert pool.preemptions == jpool.preemptions == (reserve == "lazy")
        for got, jgot, w in zip(outs[1], outs[0], want):
            np.testing.assert_array_equal(got, jgot)
            np.testing.assert_array_equal(got, w)
