"""Decoding on the live sharded weights (``Trainer.generate``, the port
of ``tf_operator_tpu/parallel/trainer.py`` ``Trainer.generate``) against
the JAX package, on the CPU in float32: the two reference tests
``tests/test_decode.py`` ``test_trainer_generate_moe_ep_sharded`` (the
moe on ``{"dp": 4, "ep": 2}``) and
``test_trainer_sharded_generate_matches_gathered`` (llama on ``{"tp": 2,
"fsdp": 2, "dp": 2}``), on their own meshes.

Both sides start from the JAX ``Trainer``'s initial params, bridged into
the port, and train the same steps of sgd with momentum on one seeded
batch repeated (the reference tests' 12 steps for llama, 6 for the moe:
the repeated rows give the greedy argmax real margins); the port as the
8 ranks of one gloo world (``tests/torch_model_parallel.py``'s worker,
which imports no JAX).  Then, on every rank:

- the greedy ids of ``Trainer.generate`` on the live shards (tp-split
  heads and vocab columns, ep-split experts, fsdp shards gathered a
  module at a time) equal, token for token, the ids of
  ``models/decode.generate`` on a copy of the gathered weights, and the
  JAX ``Trainer.generate`` on the same mesh;
- they are [B, P + N] int64 with the prompt as their prefix, and every
  rank returns the same ids; sampled ids drawn from a generator seeded
  by the rank are the same on every rank too (each step broadcasts the
  mesh's first rank's draw);
- sampling without a generator raises; a rank's cache holds its K/V
  heads (Hkv / tp);
- a rolling-window llama (window 8 < max_len, a prompt longer than the
  window) decodes under tp as its gathered copy does.
"""

import json
import sys

import numpy as np
import pytest
import torch
from torch_world import run_world

import torch_model_parallel as mp

torch.set_num_threads(2)

MESHES = {"llama": {"tp": 2, "fsdp": 2, "dp": 2}, "moe": {"dp": 4, "ep": 2}}
#: each family's rows, steps, batch seed and new tokens, and the prompt
#: shape: the reference tests' (sequence length 24)
SEQ = 24
SHAPES = {"llama": dict(rows=4, steps=12, seed=0, new=8),
          "moe": dict(rows=8, steps=6, seed=3, new=6)}
PROMPT_ROWS, PROMPT_LEN = 2, 6
WINDOW, WINDOW_PROMPT = 8, 10


def _data(family):
    shape = SHAPES[family]
    ids = np.random.RandomState(shape["seed"]).randint(
        0, mp.VOCAB, size=(shape["rows"], SEQ)).astype(np.int32)
    return ids, {"input_ids": np.repeat(ids[None], shape["steps"], 0)}


def _jax_generate(family, data, prompt, new):
    """The JAX ``Trainer`` on the family's mesh, trained on ``data``,
    then its ``generate``: (its initial params as a port state, the ids)."""

    import jax.numpy as jnp

    run = mp.jax_trainer(family, MESHES[family], data)
    jt = run["trainer"]
    for step in range(len(data["input_ids"])):
        jt.train_step(jt.shard_batch({"input_ids": data["input_ids"][step]}))
    out = jt.generate(jnp.asarray(prompt.astype(np.int32)), max_new_tokens=new)
    return run["initial"], np.asarray(out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_decode")
    specs, jax_ids = [], {}
    for family in ("llama", "moe"):
        ids, data = _data(family)
        prompt = ids[:PROMPT_ROWS, :PROMPT_LEN]
        state, jax_ids[family] = _jax_generate(family, data, prompt, SHAPES[family]["new"])
        mp.save_state(state, str(tmp / f"{family}_state.npz"))
        np.savez(tmp / f"{family}_batches.npz", **data)
        specs.append({"name": family, "family": family, "mesh": MESHES[family], "seq": SEQ,
                      "state": str(tmp / f"{family}_state.npz"),
                      "batches": str(tmp / f"{family}_batches.npz"),
                      "generate": {"prompt": prompt.tolist(), "new": SHAPES[family]["new"]}})
    ids, _ = _data("llama")
    specs.append({"name": "llama_window", "family": "llama", "mesh": MESHES["llama"],
                  "seq": SEQ, "window": WINDOW, "state": str(tmp / "llama_state.npz"),
                  "batches": str(tmp / "llama_batches.npz"),
                  "generate": {"prompt": ids[:PROMPT_ROWS, :WINDOW_PROMPT].tolist(),
                               "new": SHAPES["llama"]["new"]}})
    (tmp / "spec.json").write_text(json.dumps(specs))
    outs = run_world(8, [sys.executable, "-m", "torch_model_parallel", str(tmp / "spec.json")],
                     timeout=400)
    ranks = {s["name"]: [json.loads((tmp / f"{s['name']}_rank{r}.json").read_text())
                         for r in range(8)] for s in specs}
    prompts = {s["name"]: np.asarray(s["generate"]["prompt"]) for s in specs}
    return {"ranks": ranks, "jax": jax_ids, "prompts": prompts, "outs": outs}


@pytest.mark.parametrize("family", sorted(MESHES))
def test_sharded_generate_equals_the_gathered_copy_and_jax(runs, family):
    want = runs["jax"][family]
    assert want.shape == (PROMPT_ROWS, PROMPT_LEN + SHAPES[family]["new"])
    for rec in runs["ranks"][family]:
        assert {k: v for k, v in rec["mesh"].items() if v > 1} == MESHES[family]
        gen = rec["generate"]
        np.testing.assert_array_equal(gen["sharded"], gen["gathered"])
        np.testing.assert_array_equal(gen["sharded"], want)


@pytest.mark.parametrize("name", ["llama", "moe", "llama_window"])
def test_every_rank_returns_the_same_ids_with_the_prompt_as_prefix(runs, name):
    ranks, prompt = runs["ranks"][name], runs["prompts"][name]
    for rec in ranks:
        gen = rec["generate"]
        assert gen["dtype"] == "torch.int64"
        assert gen["sharded"] == ranks[0]["generate"]["sharded"]
        # rank-seeded generators: the first rank's draws on every rank
        assert gen["sampled"] == ranks[0]["generate"]["sampled"]
        for ids in (gen["sharded"], gen["sampled"]):
            ids = np.asarray(ids)
            np.testing.assert_array_equal(ids[:, :prompt.shape[1]], prompt)
            assert ids.min() >= 0 and ids.max() < mp.VOCAB
    assert ranks[0]["generate"]["sampled"] != ranks[0]["generate"]["sharded"]


@pytest.mark.parametrize("name", ["llama", "moe"])
def test_sampling_needs_a_generator_and_the_cache_holds_the_ranks_heads(runs, name):
    heads = {"llama": 2 // 2, "moe": 4}[name]  # llama_tiny's 2 KV heads over tp 2
    for rec in runs["ranks"][name]:
        assert "explicit torch.Generator" in rec["generate"]["raises"]
        assert rec["generate"]["cache_heads"] == heads


def test_a_rolling_window_llama_decodes_under_tp(runs):
    for rec in runs["ranks"]["llama_window"]:
        gen = rec["generate"]
        assert len(gen["sharded"][0]) == WINDOW_PROMPT + SHAPES["llama"]["new"]
        np.testing.assert_array_equal(gen["sharded"], gen["gathered"])
