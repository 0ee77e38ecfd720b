"""The port's moe family (models/moe.py: ``MoeMlp``, ``MoeLM``,
``moe_lm_loss``) against the JAX package's, on the CPU, at ``moe_tiny``'s
widths (2 layers, hidden 128, 4 experts, vocab 128), and ``llama_pretrain
--family moe`` alone and as a 2-rank job.

One flax param tree is bridged into the port (``from_flax_params``);
both sides get the same seeded numpy inputs.  Tolerances, each as max
|port - JAX| over max |JAX| unless said otherwise:

- forward logits: float32 1e-5, bf16 2e-2 (``torch_zoo.FWD_TOL``);
- the routed MLP alone, float32, at a training capacity that drops
  tokens (the rigged router of ``tests/test_decode.py``'s
  ``test_decode_routing_is_dropless``, capacity_factor 0.25, and a
  seeded random router at the same capacity) and at the dropless decode
  capacity: output 1e-5 and the same dropped rows (no expert output);
  its auxiliary loss rtol 1e-5;
- ``moe_lm_loss`` at dropout 0 (float32): the loss, ``xent`` and
  ``moe_aux_loss`` rtol 1e-5, every gradient as
  ``torch_zoo.assert_grads_match``; three ``Trainer`` steps against the
  JAX ``Trainer``: loss rtol 1e-5, grad norm rtol 1e-4;
- greedy tokens exactly (float32): ``generate``, the chunked decoder and
  the contiguous pool against JAX ``generate``, slot isolation in the
  pool, and int8 (per-expert scales bit for bit against
  ``quantize_array(reduce_axes=(1,))`` and ``quantize_tree``; the state
  dequantized to bf16 before it is loaded, as ``materialize_tree``)
  logits atol 1e-4 and tokens against JAX ``generate`` on the quantized
  tree;
- the 2-rank gloo job (dp 2, ep 1) against one process on the same
  global batch, dropout 0, bf16: each loss rtol 1e-3 (``chip_smoke.py``'s
  DIST_LOSS_RTOL), the load-balance fractions taken over the global
  batch (a differentiable all-reduce).
"""

import dataclasses
import json
import os
import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_world import run_world

from tf_operator_tpu.models import moe as jmoe
from tf_operator_tpu.models.decode import generate as j_generate
from tf_operator_tpu.models.gpt import gpt_small as j_gpt_small
from tf_operator_tpu.models.transformer import TransformerConfig as JConfig
from tf_operator_tpu.ops import quant as jquant

import torch_zoo as zoo
from tf_operator_tpu_torch import llama_pretrain
from tf_operator_tpu_torch.models import moe
from tf_operator_tpu_torch.models.batching import ContinuousBatchingDecoder
from tf_operator_tpu_torch.models.decode import ChunkedServingDecoder, generate
from tf_operator_tpu_torch.models.gpt import gpt_small
from tf_operator_tpu_torch.models.transformer import TransformerConfig
from tf_operator_tpu_torch.models.weights import from_flax_params, init_params
from tf_operator_tpu_torch.ops import quant_matmul as qm
from tf_operator_tpu_torch.ops.quant import QTensor, quantize_array, quantize_state

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tiny():
    return zoo.bridged("moe", seed=1)


@pytest.mark.parametrize("dtype", sorted(zoo.DTYPES))
def test_forward_matches_jax(dtype):
    params = zoo.jax_params("moe", seed=2)
    tdtype, jdtype = zoo.DTYPES[dtype]
    x = zoo.ids(3, (2, 24))
    want = zoo.jax_model("moe", jdtype).apply({"params": params}, jnp.asarray(x))
    model = zoo.port_model("moe", from_flax_params(params), tdtype)
    got = model(torch.as_tensor(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 24, zoo.VOCAB)
    assert zoo.rel(got.numpy(), want) <= zoo.FWD_TOL[dtype]


# -- the routed MLP ----------------------------------------------------------------

#: tests/test_decode.py's rig: E 8, capacity_factor 0.25 -> training
#: capacity max(int(24 / 16), 4) = 4 at s 24
MLP_BASE = dict(vocab_size=32, hidden=16, n_heads=2, head_dim=8, n_layers=1, mlp_dim=32,
                max_len=64, dropout=0.0)


def _mlp_pair(rigged, seed):
    jcfg = jmoe.MoeConfig(base=JConfig(dtype=jnp.float32, **MLP_BASE), num_experts=8,
                          capacity_factor=0.25)
    x = np.random.RandomState(seed).rand(2, 24, 16).astype(np.float32)
    params = zoo.unbox(jmoe.MoeMlp(jcfg).init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"])
    if rigged:
        kernel = np.zeros((16, 8), np.float32)
        kernel[:, 0] = 10.0
        params["router"]["kernel"] = kernel
    pcfg = moe.MoeConfig(base=TransformerConfig(dtype=torch.float32, **MLP_BASE),
                         num_experts=8, capacity_factor=0.25)
    mlp = moe.MoeMlp(pcfg, trainable=True)
    mlp.load_state_dict({"router.kernel": torch.tensor(params["router"]["kernel"]),
                         "wi": torch.tensor(params["wi"]), "wo": torch.tensor(params["wo"])})
    return jcfg, params, x, mlp


def _jax_mlp(jcfg, params, x, decode):
    if decode:
        jcfg = dataclasses.replace(jcfg, base=dataclasses.replace(jcfg.base, decode=True))
    out, mutated = jmoe.MoeMlp(jcfg).apply({"params": params}, jnp.asarray(x),
                                           mutable=["losses"])
    return np.asarray(out), float(jax.tree_util.tree_leaves(mutated["losses"])[0])


@pytest.mark.parametrize("rigged", [True, False], ids=["rigged", "random"])
def test_routed_mlp_drops_the_tokens_the_reference_drops(rigged):
    jcfg, params, x, mlp = _mlp_pair(rigged, seed=3)
    assert mlp.capacity(24, decode=False) == 4 and mlp.capacity(24, decode=True) == 24
    rows = {}
    for decode in (False, True):
        want, want_aux = _jax_mlp(jcfg, params, x, decode)
        with torch.no_grad():
            got, aux = mlp(torch.as_tensor(x), decode=decode)
        assert zoo.rel(got.numpy(), want) <= 1e-5
        np.testing.assert_allclose(float(aux), want_aux, rtol=1e-5)
        dropped = np.abs(want).sum(-1) < 1e-6
        np.testing.assert_array_equal(np.abs(got.numpy()).sum(-1) < 1e-6, dropped)
        rows[decode] = dropped
    assert not rows[True].any(), "decode must be dropless"
    if rigged:
        # every token picks expert 0 (and then expert 1): rows past the
        # capacity-4 buckets get no expert output in training
        assert not rows[False][:, :4].any() and rows[False][:, 4:].all()
    else:
        assert rows[False].any(), "the capacity binds at this seed"


def test_one_hot_of_an_unrouted_position_is_zeros():
    got = moe._one_hot(torch.tensor([-1, 0, 3, 4, 9]), 4)
    want = np.asarray(jax.nn.one_hot(jnp.asarray([-1, 0, 3, 4, 9]), 4))
    np.testing.assert_array_equal(got.numpy(), want)


# -- the loss and training -------------------------------------------------------


def test_loss_aux_and_gradients_match_jax_grad():
    params = zoo.jax_params("moe", seed=4)
    batch = {"input_ids": zoo.ids(5, (2, 20))}
    jloss, jmetrics, jgrads = zoo.jax_loss_and_grads("moe", params, batch)
    model = zoo.port_model("moe", from_flax_params(params), trainable=True, dropout=0.0)
    loss, metrics = moe.moe_lm_loss(model, {"input_ids": torch.as_tensor(batch["input_ids"])})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-5)
    for key in ("xent", "moe_aux_loss"):
        np.testing.assert_allclose(float(metrics[key]), jmetrics[key], rtol=1e-5)
    np.testing.assert_allclose(float(metrics["token_accuracy"]), jmetrics["token_accuracy"])
    assert float(metrics["moe_aux_loss"]) > 0
    zoo.assert_grads_match(model, jgrads)


def test_trainer_matches_the_jax_trainer():
    pm, jm = zoo.trainer_matches("moe")
    np.testing.assert_allclose(float(pm["moe_aux_loss"]), float(jm["moe_aux_loss"]), rtol=1e-5)


# -- decoding ---------------------------------------------------------------


def test_cached_greedy_matches_jax_generate(tiny):
    jm, params, model = tiny
    prompt = zoo.ids(6, (2, 5))
    want = np.asarray(j_generate(jm, params, jnp.asarray(prompt), max_new_tokens=8))
    np.testing.assert_array_equal(generate(model, torch.as_tensor(prompt), 8).numpy(), want)
    long_prompt = zoo.ids(7, (1, 37))
    want = np.asarray(j_generate(jm, params, jnp.asarray(long_prompt), max_new_tokens=6))
    got = ChunkedServingDecoder(model).generate(torch.as_tensor(long_prompt), 6).numpy()
    np.testing.assert_array_equal(got, want)


def test_slot_isolation_and_jax_generate(tiny):
    # each seat routes its own token: occupancy must not change a
    # request's expert paths or tokens (tests/test_batching.py's moe case)
    jm, params, model = tiny
    prompts = [zoo.ids(30 + i, (n,)) for i, n in enumerate((6, 9))]
    solo = []
    for p in prompts:
        pool = ContinuousBatchingDecoder(model, slots=2)
        rid = pool.submit(p, max_new_tokens=5)
        pool.run()
        solo.append(np.asarray(pool.result(rid)))
    pool = ContinuousBatchingDecoder(model, slots=2)
    rids = [pool.submit(p, max_new_tokens=5) for p in prompts]
    pool.run()
    for rid, p, want in zip(rids, prompts, solo):
        np.testing.assert_array_equal(np.asarray(pool.result(rid)), want)
        jwant = np.asarray(j_generate(jm, params, jnp.asarray(p)[None], max_new_tokens=5))[0]
        np.testing.assert_array_equal(want, jwant)


# -- int8 --------------------------------------------------------------------


def test_expert_scales_are_per_expert_and_bit_exact():
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (4, 64, 32), jnp.float32))
    w = w * np.asarray([1.0, 2.0, 4.0, 8.0], np.float32)[:, None, None]
    want = jquant.quantize_array(jnp.asarray(w), reduce_axes=(1,))
    got = quantize_array(torch.from_numpy(w), reduce_axes=(1,))
    assert tuple(got.scale.shape) == (4, 1, 32)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    err = (got.materialize(torch.float32) - torch.from_numpy(w)).abs() / got.scale
    assert float(err.max()) <= 0.51


def test_quantize_state_is_quantize_tree(tiny):
    _, params, _ = tiny
    want = from_flax_params(jquant.quantize_tree(params))
    got = quantize_state(from_flax_params(params))
    assert set(got) == set(want)
    quantized = {n for n, t in got.items() if isinstance(t, QTensor)}
    assert quantized == {n for n, t in want.items() if isinstance(t, QTensor)}
    assert {n.rsplit(".", 1)[-1] for n in quantized} >= {"wi", "wo"}
    assert not any("router" in n for n in quantized)  # 128 x 4 < 4096 elements
    for n in quantized:
        np.testing.assert_array_equal(got[n].q.numpy(), want[n].q.numpy())
        np.testing.assert_array_equal(got[n].scale.numpy(), want[n].scale.numpy())


def test_int8_decode_matches_jax(tiny):
    jm, params, _ = tiny
    qparams = jquant.quantize_tree(params)
    model = zoo.port_model("moe", quantize_state(from_flax_params(params)))
    # dequantized before it is loaded: no int8 kernel, K7 off the path
    assert not any(n.endswith("kernel_q") for n, _ in model.named_buffers())
    x = zoo.ids(8, (2, 12))
    want = jm.apply({"params": jquant.materialize_tree(qparams)}, jnp.asarray(x))
    qm.plain_calls.clear()
    got = model(torch.as_tensor(x))
    assert not qm.plain_calls
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    prompt = zoo.ids(9, (2, 5))
    want = np.asarray(j_generate(jm, qparams, jnp.asarray(prompt), max_new_tokens=6))
    np.testing.assert_array_equal(generate(model, torch.as_tensor(prompt), 6).numpy(), want)


# -- shapes, layout, init ----------------------------------------------------------


def _moe_gpt_small_jax():
    base = j_gpt_small(vocab_size=256, max_len=1024).cfg
    return jmoe.MoeLM(jmoe.MoeConfig(base=base, num_experts=8))


def test_full_width_shapes_equal_the_jax_models():
    for jm, pcfg in ((jmoe.moe_tiny(vocab_size=256, max_len=128),
                      moe.moe_tiny(vocab_size=256, max_len=128)),
                     (_moe_gpt_small_jax(),
                      moe.MoeConfig(base=gpt_small(vocab_size=256, max_len=1024),
                                    num_experts=8))):
        abstract = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                                  jnp.zeros((1, 8), jnp.int32)))["params"]
        flat = flax.traverse_util.flatten_dict(abstract, sep="/")
        model = moe.MoeLM(pcfg, device="meta")
        got = {model.flax_path(n): tuple(p.shape) for n, p in model.named_parameters()}
        assert got == {k: tuple(v.value.shape) for k, v in flat.items()}
    n = sum(int(np.prod(s)) for s in got.values())
    experts = sum(int(np.prod(s)) for k, s in got.items() if k.endswith(("/wi", "/wo")))
    assert 0.47e9 < n < 0.49e9 and experts == 12 * 2 * 8 * 768 * 3072


@pytest.mark.parametrize("fsdp", [2, 4, pytest.param({"tp": 2}, id="tp2"),
                                  pytest.param({"ep": 2}, id="ep2"),
                                  pytest.param({"dp": 2, "ep": 2}, id="dp2-ep2"),
                                  pytest.param({"fsdp": 2, "ep": 2, "tp": 2}, id="fsdp2-ep2-tp2")])
def test_logical_shardings_match_the_jax_trainer_layout(fsdp):
    zoo.logical_shardings_match("moe", fsdp)


def test_init_params_follows_flax_fan_in_for_expert_stacks():
    cfg = moe.moe_tiny(256, 64, num_experts=4)
    state = init_params(cfg, 0, "cpu", trainable=True, family=moe.MoeLM)
    assert set(state) == {n for n, _ in moe.MoeLM(cfg, device="meta").named_parameters()}
    wi, wo = state["layers.0.moe.wi"], state["layers.0.moe.wo"]
    # lecun normal over fan-in = in x E (flax counts the stacked axis)
    assert 0.9 < float(wi.std()) * (128 * 4) ** 0.5 < 1.1
    assert 0.9 < float(wo.std()) * (256 * 4) ** 0.5 < 1.1
    assert 0.8 < float(state["layers.1.moe.router.kernel"].std()) * 128 ** 0.5 < 1.2
    assert 0.015 < float(state["pos_embed"].std()) < 0.025


def test_sequence_parallelism_is_refused():
    class SpMesh:
        shape = {"sp": 2}

    base = TransformerConfig(**{**moe.moe_tiny().base.__dict__, "mesh": SpMesh()})
    # ported (tests/test_torch_sp_zoo.py trains moe over sp): MoeLM builds
    # on an sp mesh; the encoder families keep the refusal
    assert moe.MoeLM(moe.MoeConfig(base=base), device="meta").cfg.sp_enabled
    from tf_operator_tpu_torch.models.vit import ViT, ViTConfig

    with pytest.raises(NotImplementedError, match="ViT runs with sp 1"):
        ViT(ViTConfig(base=base), device="meta")


# -- llama_pretrain --family moe ----------------------------------------------------

STEPS, ROWS, SEQ = 3, 4, 32


def _argv(data_dir, rows=ROWS, steps=STEPS):
    return ["--device", "cpu", "--family", "moe", "--seq-len", str(SEQ),
            "--batch-per-device", str(rows), "--steps", str(steps), "--steps-per-sync", "1",
            "--data-dir", data_dir, "--generate", "0"]


def test_llama_pretrain_family_moe_trains_exports_and_samples(tmp_path, capsys):
    data = str(tmp_path / "text")
    args = llama_pretrain.parse_args(_argv(data, rows=8, steps=20)[:-2] + [
        "--generate", "12", "--export-dir", str(tmp_path / "art")])
    out = llama_pretrain.run(args)
    losses = out["losses"]
    assert len(losses) == 20 and sum(losses[-5:]) / 5 < losses[0]
    assert isinstance(out["trainer"].model, moe.MoeLM)
    assert out["trainer"].model.cfg.dropout == 0.1  # moe_tiny's, the reference's
    text = capsys.readouterr().out
    assert "[moe bytes dp=1 ep=1 E=4]" in text and "sample: " in text
    assert len(out["sample"]) == 12
    desc = json.loads((tmp_path / "art" / "model.json").read_text())
    assert desc["family"] == "moe" and desc["moe"]["num_experts"] == 4
    flat = np.load(tmp_path / "art" / "params.npz")
    assert flat["layer_0/moe/wi"].shape == (4, 128, 256)


def test_llama_pretrain_refuses_moe_with_llama_only_flags():
    for extra in (["--model", "llama-wide"], ["--experts", "0"]):
        with pytest.raises(SystemExit):
            llama_pretrain.parse_args(["--family", "moe"] + extra)
    # --sp is not one of them: the moe family ignores it, as the reference's does,
    # while the llama family still refuses an sp that does not divide the sequence
    assert llama_pretrain.parse_args(["--family", "moe", "--sp", "2"]).sp == 2
    with pytest.raises(SystemExit):
        llama_pretrain.parse_args(["--family", "llama", "--sp", "3", "--seq-len", "64"])
    assert llama_pretrain.moe_mesh_shape(4, 2) == {"ep": 1, "dp": 2}
    assert llama_pretrain.moe_mesh_shape(8, 1) == {"ep": 1, "dp": 1}


def worker(data_dir, out_dir, tag, *extra):
    from tf_operator_tpu_torch.runtime.bootstrap import world

    out = llama_pretrain.run(llama_pretrain.parse_args(_argv(data_dir) + list(extra)),
                             dropout=0.0)
    rank, n = world()
    trainer = out["trainer"]
    rec = {"losses": out["losses"], "world": [rank, n], "mesh": trainer.mesh.shape,
           "group": trainer.model.batch_group is not None}
    with open(os.path.join(out_dir, f"{tag}{rank}.json"), "w") as f:
        json.dump(rec, f)


@pytest.mark.parametrize("tag,extra", [("rank", []),
                                       ("sp", ["--sp", "2", "--sp-impl", "ulysses"])])
def test_moe_job_matches_one_process(tmp_path, tag, extra):
    """A 2-rank moe job trains at the reference's ``{"ep": 1, "dp": 2}``
    with the losses of one process on both ranks' rows, with or without
    ``--sp`` (the reference's moe mesh does not read it)."""

    data = str(tmp_path / "text")
    outs = run_world(2, [sys.executable, "-m", "tests.test_torch_moe", data, str(tmp_path),
                         tag] + extra, timeout=300)
    ranks = [json.loads((tmp_path / f"{tag}{i}.json").read_text()) for i in range(2)]
    # one process on both ranks' rows at once, from the same seeded weights
    want = llama_pretrain.run(llama_pretrain.parse_args(_argv(data, rows=2 * ROWS)),
                              dropout=0.0)["losses"]
    for i, rec in enumerate(ranks):
        assert rec["world"] == [i, 2], outs[i][-2000:]
        assert rec["mesh"]["ep"] == 1 and rec["mesh"]["dp"] == 2 and rec["group"]
        assert {k: v for k, v in rec["mesh"].items() if v > 1} == {"dp": 2}
        assert "[moe bytes dp=2 ep=1 E=4]" in outs[i]
        np.testing.assert_allclose(rec["losses"], want, rtol=1e-3)
        assert rec["losses"] == ranks[0]["losses"]  # the global mean on every rank


if __name__ == "__main__":
    worker(*sys.argv[1:])
