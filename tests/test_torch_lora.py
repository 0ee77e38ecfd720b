"""The port's LoRA (models/lora.py, ``parallel/checkpoint``'s merged
export and loaders, the ``lora_finetune`` entry) against the JAX
package's, on the CPU at the tiny families' widths.

One flax param tree is bridged into the port
(``models/weights.from_flax_params``; adapters through
``lora_from_flax``); both sides get the same seeded numpy inputs.
Tolerances:

- the selection (keys and shapes) equals the JAX ``lora_init``'s on the
  same base trees (llama, gpt, moe tiny; the default min_size and 1):
  exactly;
- the zero delta at init: the port's logits through ``LoraModel`` equal
  the base model's bit for bit;
- ``merge_lora`` at nonzero ``b`` against the JAX merge: max |port -
  JAX| <= 1e-6 of the largest kernel element (float32; the rank-r
  product summed in another order);
- ``LoraModel``'s logits and the gradients of every ``a`` and ``b``
  against ``jax.grad`` of ``llama_loss`` through the JAX
  ``LoraModel.apply`` (float32 config): logits 1e-5 of the largest,
  each gradient 1e-5 of its tensor's largest element plus 1e-7 of the
  largest of them all (float32 backward sums in another order);
- three ``Trainer`` steps against the JAX ``Trainer`` over the same
  LoRA model (AdamW, clip): loss rtol 1e-5 a step; the base bit for bit
  unchanged; the optimizer's moments on the adapters only;
- the export of a LoRA trainer: the merged tree under the base family's
  ``model.json``, loaded back to logits equal to the LoRA model's
  (rtol 1e-6);
- ``lora_finetune --device cpu`` end to end at tiny size: the
  reference's startup line with the counts the JAX ``lora_init`` gives
  on the same base, the step lines, the sample and the export.
"""

import json
import types

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models import gpt as jgpt
from tf_operator_tpu.models import llama as jllama
from tf_operator_tpu.models import moe as jmoe
from tf_operator_tpu.models.lora import LoraModel as JLoraModel
from tf_operator_tpu.models.lora import lora_init as j_lora_init
from tf_operator_tpu.models.lora import merge_lora as j_merge_lora
from tf_operator_tpu.parallel import Trainer as JTrainer
from tf_operator_tpu.parallel import TrainerConfig as JTrainerConfig
from tf_operator_tpu.parallel import make_mesh as j_make_mesh

from tf_operator_tpu_torch import lora_finetune
from tf_operator_tpu_torch.models import gpt, llama, moe
from tf_operator_tpu_torch.models.lora import (
    DEFAULT_MIN_SIZE,
    LoraModel,
    lora_init,
    merge_lora,
)
from tf_operator_tpu_torch.models.registry import model_from_description
from tf_operator_tpu_torch.models.weights import (
    from_flax_params,
    lora_from_flax,
    lora_to_flax,
)
from tf_operator_tpu_torch.parallel.checkpoint import (
    export_merged_params,
    export_params,
    load_model_description,
    load_params,
)
from tf_operator_tpu_torch.parallel.trainer import Trainer, TrainerConfig

torch.set_num_threads(2)

VOCAB, MAX_LEN, RANK = 128, 64, 4
#: the JAX tiny families and the port's configs, float32, dropout 0
JAX_MODELS = {
    "llama": lambda: jllama.llama_tiny(vocab_size=VOCAB, max_len=MAX_LEN, dtype=jnp.float32),
    "gpt": lambda: jgpt.gpt_tiny(vocab_size=VOCAB, max_len=MAX_LEN, dtype=jnp.float32,
                                 dropout=0.0),
    "moe": lambda: jmoe.moe_tiny(vocab_size=VOCAB, max_len=MAX_LEN),
}
PORT = {
    "llama": (llama.LlamaLM, lambda: llama.llama_tiny(VOCAB, MAX_LEN, dtype=torch.float32)),
    "gpt": (gpt.CausalLM, lambda: gpt.gpt_tiny(VOCAB, MAX_LEN, dtype=torch.float32,
                                               dropout=0.0)),
    "moe": (moe.MoeLM, lambda: moe.moe_tiny(VOCAB, MAX_LEN)),
}
LOGITS_TOL = 1e-5
GRAD_TOL, GRAD_FLOOR = 1e-5, 1e-7
MERGE_TOL = 1e-6


def _unbox(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.meta.unbox(tree))


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(0, VOCAB, shape).astype(np.int32)


def _jax_base(family, seed=1):
    jm = JAX_MODELS[family]()
    params = _unbox(jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"])
    return jm, params


def _port_base(family, params):
    cls, cfg = PORT[family]
    return cls.from_state_dict(cfg(), from_flax_params(params), "cpu", trainable=True)


def _jax_adapters(params, seed=0, b_scale=0.0, min_size=DEFAULT_MIN_SIZE):
    """The JAX ``lora_init``'s adapters (numpy), ``b`` drawn at
    ``b_scale`` where it is nonzero (the reference's b starts at 0)."""

    ad = _unbox(j_lora_init(params, jax.random.PRNGKey(seed), RANK, min_size=min_size))
    r = np.random.default_rng(seed + 100)
    for ab in ad.values():
        if b_scale:
            ab["b"] = (r.standard_normal(ab["b"].shape) * b_scale).astype(np.float32)
    return ad


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# -- selection and merge ------------------------------------------------------

@pytest.mark.parametrize("min_size", [DEFAULT_MIN_SIZE, 1])
@pytest.mark.parametrize("family", sorted(JAX_MODELS))
def test_selection_matches_jax_lora_init(family, min_size):
    _, params = _jax_base(family)
    want = j_lora_init(params, jax.random.PRNGKey(0), RANK, min_size=min_size)
    base = _port_base(family, params)
    got = lora_init(dict(base.named_parameters()), torch.Generator().manual_seed(0), RANK,
                    min_size=min_size, flax_path=base.flax_path)
    assert sorted(got) == sorted(want)
    for k in want:
        for part in ("a", "b"):
            assert tuple(got[k][part].shape) == tuple(want[k][part].shape), (k, part)
    # the law: a ~ N(0, 0.02), b = 0
    a = torch.cat([ab["a"].reshape(-1) for ab in got.values()])
    assert all(not ab["b"].any() for ab in got.values())
    assert 0.018 < float(a.std()) < 0.022
    # LoraModel selects the same
    lora = LoraModel(base, rank=RANK, min_size=min_size)
    assert sorted(lora.adapter_tree()) == sorted(want)


def test_query_adapter_takes_every_axis_but_the_last_as_input():
    _, params = _jax_base("llama")
    lora = LoraModel(_port_base("llama", params), rank=RANK)
    ab = lora.adapter_tree()["layer_0/self_attn/query/kernel"]
    # query [E 128, H 4, D 32]: a [128 * 4, r], b [r, 32]
    assert tuple(ab["a"].shape) == (512, RANK) and tuple(ab["b"].shape) == (RANK, 32)


@pytest.mark.parametrize("family", ["llama", "gpt"])
def test_zero_delta_at_init_is_bitwise(family):
    _, params = _jax_base(family)
    base = _port_base(family, params)
    ids = torch.as_tensor(_ids(3, (2, 24)))
    lora = LoraModel(base, rank=RANK, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        want = base(ids)
        got = lora(ids)
        merged = lora.merged_params()
    assert torch.equal(got, want)
    for name, p in base.named_parameters():
        assert torch.equal(merged[name], p), name


def test_merge_matches_the_jax_merge_at_nonzero_b():
    _, params = _jax_base("llama")
    ad = _jax_adapters(params, b_scale=0.05)
    want = from_flax_params(_unbox(j_merge_lora(params, ad, alpha=16.0)))
    base = {n: t for n, t in from_flax_params(params).items()}
    got = merge_lora(base, lora_from_flax(ad), alpha=16.0)
    assert set(got) == set(want)
    moved = 0
    for name, w in want.items():
        err = float((got[name] - w).abs().max())
        assert err <= MERGE_TOL * float(w.abs().max()), name
        moved += int(not torch.equal(w, base[name]))
    assert moved == len(ad)
    # the bridge both ways
    back = lora_to_flax(lora_from_flax(ad))
    for k, ab in ad.items():
        np.testing.assert_array_equal(back[k]["a"], ab["a"])
        np.testing.assert_array_equal(back[k]["b"], ab["b"])


def test_logits_and_adapter_gradients_match_jax():
    jm, params = _jax_base("llama")
    ad = _jax_adapters(params, b_scale=0.05)
    ids = _ids(4, (2, 24))
    jlora = JLoraModel(jm, params, rank=RANK, alpha=16.0)
    want_logits = np.asarray(jlora.apply({"params": ad}, jnp.asarray(ids)))
    state = types.SimpleNamespace(apply_fn=jlora.apply)
    batch = {"input_ids": jnp.asarray(ids)}

    def loss_of(a):
        return jllama.llama_loss(a, state, batch, jax.random.PRNGKey(0), train=False)[0]

    jloss, jgrads = jax.value_and_grad(loss_of)(ad)
    lora = LoraModel(_port_base("llama", params), rank=RANK, alpha=16.0,
                     adapters=lora_from_flax(ad))
    logits = lora(torch.as_tensor(ids))
    assert _rel(logits.detach().numpy(), want_logits) <= LOGITS_TOL
    loss, _ = llama.llama_loss(lora.train(), {"input_ids": torch.as_tensor(ids)})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    jg = _unbox(jgrads)
    floor = GRAD_FLOOR * max(np.abs(g).max() for ab in jg.values() for g in ab.values())
    for k, ab in lora.adapter_tree().items():
        for part in ("a", "b"):
            want = jg[k][part]
            err = np.abs(ab[part].grad.numpy() - want).max()
            assert err <= GRAD_TOL * np.abs(want).max() + floor, (k, part)
    # only the adapters took gradients
    assert all(p.grad is None for p in lora.model.parameters())


# -- training and export ------------------------------------------------------

TRAIN_CFG = TrainerConfig(learning_rate=1e-2, weight_decay=1e-4, grad_clip=1.0)


def test_trainer_steps_move_only_the_adapters_as_the_jax_trainer():
    jm, params = _jax_base("llama")
    batches = [{"input_ids": _ids(s, (4, 16))} for s in (11, 12, 13)]
    jcfg = JTrainerConfig(**{f: getattr(TRAIN_CFG, f) for f in (
        "learning_rate", "weight_decay", "warmup_steps", "total_steps", "grad_clip",
        "optimizer", "accum_steps")})
    jlora = JLoraModel(jm, params, rank=RANK)
    jt = JTrainer(jlora, jcfg, j_make_mesh({"dp": 1}, devices=jax.devices()[:1]),
                  jllama.llama_loss, batches[0], init_args=(batches[0]["input_ids"],),
                  shardings="fsdp")
    base = _port_base("llama", params)
    before = {n: p.detach().clone() for n, p in base.named_parameters()}
    lora = LoraModel(base, rank=RANK, adapters=lora_from_flax(_unbox(jt.state.params)))
    trainer = Trainer(lora, TRAIN_CFG, llama.llama_loss)
    start = {n: p.detach().clone() for n, p in zip(trainer.names, trainer.params)}
    for batch in batches:
        jmx = jt.train_step(jt.shard_batch(batch))
        pm = trainer.train_step(batch)
        np.testing.assert_allclose(float(pm["loss"]), float(jmx["loss"]), rtol=1e-5)
    for n, p in base.named_parameters():
        assert torch.equal(p, before[n]), n
        assert not p.requires_grad
    assert all(n.startswith("adapters.") for n in trainer.names)
    assert all(not torch.equal(p, start[n]) for n, p in zip(trainer.names, trainer.params)
               if n.endswith(".b"))
    opt = trainer.optimizer
    assert len(opt._mu) == len(opt._nu) == len(trainer.params)
    assert [tuple(m.shape) for m in opt._mu] == [tuple(p.shape) for p in trainer.params]


def test_export_of_a_lora_trainer_writes_the_merged_base(tmp_path):
    _, params = _jax_base("llama")
    ad = _jax_adapters(params, b_scale=0.05)
    base = _port_base("llama", params)
    lora = LoraModel(base, rank=RANK, adapters=lora_from_flax(ad))
    trainer = Trainer(lora, TRAIN_CFG, llama.llama_loss)
    out = export_params(trainer, str(tmp_path / "tuned"))
    desc = load_model_description(out)
    assert desc["family"] == "llama"
    state = load_params(out)
    assert set(state) == {n for n, _ in base.named_parameters()}
    with np.load(tmp_path / "tuned" / "params.npz") as f:
        assert not any("adapters" in k or k.endswith(("/a", "/b")) for k in f.files)
    cls, cfg = model_from_description(desc)
    served = cls.from_state_dict(cfg, state, "cpu")
    ids = torch.as_tensor(_ids(6, (2, 20)))
    with torch.no_grad():
        want = lora(ids)
        got = served(ids)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    # the export of the JAX merge is the same artifact's state
    jmerged = from_flax_params(_unbox(j_merge_lora(params, ad)))
    for name, w in jmerged.items():
        assert float((state[name] - w).abs().max()) <= MERGE_TOL * float(w.abs().max()), name
    assert load_model_description(str(tmp_path)) is None


def test_the_reference_errors():
    _, params = _jax_base("llama")
    base = _port_base("llama", params)
    named = dict(base.named_parameters())
    with pytest.raises(ValueError, match="rank must be >= 1, got 0"):
        lora_init(named, torch.Generator(), 0)
    with pytest.raises(ValueError, match="no kernels selected for LoRA"):
        lora_init(named, torch.Generator(), RANK, min_size=10**9)
    with pytest.raises(ValueError, match="no kernels selected for LoRA"):
        LoraModel(base, rank=RANK, min_size=10**9)
    serving = llama.LlamaLM.from_state_dict(llama.llama_tiny(VOCAB, MAX_LEN),
                                            from_flax_params(params), "cpu")
    with pytest.raises(ValueError, match="float32 storage"):
        LoraModel(serving, rank=RANK)


# -- the entry ------------------------------------------------------------------

def test_lora_finetune_on_the_cpu_end_to_end(tmp_path, capsys):
    jm, params = _jax_base("llama")
    base = llama.LlamaLM.from_state_dict(llama.llama_tiny(VOCAB, MAX_LEN),
                                         from_flax_params(params), "cpu")
    base_dir = export_merged_params(base, dict(base.state_dict()), str(tmp_path / "base"))
    argv = ["--device", "cpu", "--base", base_dir, "--steps", "3", "--rank", "4",
            "--seq-len", "32", "--batch", "4", "--data-dir", str(tmp_path / "text"),
            "--export-dir", str(tmp_path / "tuned")]
    run = lora_finetune.run(lora_finetune.parse_args(argv))
    out = capsys.readouterr().out.splitlines()
    # the reference's counts on the same base
    jad = j_lora_init(params, jax.random.PRNGKey(0), 4)
    n_adapter = sum(x.size for x in jax.tree_util.tree_leaves(jad))
    n_base = sum(x.size for x in jax.tree_util.tree_leaves(params))
    assert (run["n_adapter"], run["n_base"]) == (n_adapter, n_base)
    assert out[0] == f"base: family=llama from {base_dir}"
    assert out[1] == (f"training {n_adapter:,} adapter params over a frozen "
                      f"{n_base:,}-param base ({n_adapter / n_base:.2%})")
    assert [ln.split()[:2] for ln in out[2:4]] == [["step", "0"], ["step", "2"]]
    assert out[4].startswith("sample: ") and len(run["sample_ids"]) == 32
    assert out[5] == f"exported merged artifact to {tmp_path / 'tuned'}"
    assert all(np.isfinite(run["losses"]))
    assert json.loads((tmp_path / "tuned" / "model.json").read_text())["family"] == "llama"
    # the sample is greedy on the merged weights (a serving model)
    from tf_operator_tpu_torch.models.decode import generate

    served = llama.LlamaLM.from_state_dict(llama.llama_tiny(VOCAB, MAX_LEN),
                                           load_params(str(tmp_path / "tuned")), "cpu")
    prompt = torch.as_tensor(np.frombuffer(lora_finetune.PROMPT.encode(), np.uint8)
                             .astype(np.int64))[None]
    assert generate(served, prompt, 32)[0, prompt.shape[1]:].tolist() == run["sample_ids"]


def test_lora_finetune_refuses_a_base_without_a_description(tmp_path):
    with pytest.raises(SystemExit, match="has no model.json"):
        lora_finetune.run(lora_finetune.parse_args(
            ["--device", "cpu", "--base", str(tmp_path)]))
