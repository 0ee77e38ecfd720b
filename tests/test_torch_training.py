"""The port's training path against the JAX package's, on the CPU.

- the optimizer chain (clip -> adamw | sgd, warmup-cosine schedule,
  MultiSteps accumulation) against the JAX trainer's optax chain on the
  same parameters and gradient sequences: float32, atol 1e-6 on the
  parameters (the same float32 arithmetic in another order);
- the whole step: the JAX ``Trainer`` and the port's on ``llama_tiny``
  (float32 config) from the same bridged initial parameters and the
  same batches, 3 steps: loss rtol 1e-5 and grad norm rtol 1e-4 per
  step (float32 forward and backward summed in another order), the
  parameters after step 3 atol 2e-5 (three Adam updates of at most
  lr = 1e-3 each, whose per-element steps g / (|g| + eps) amplify
  float32 differences of the gradient where |g| is small);
- schedule, clip and decay mask, the chunked loss, the export -> serve
  round trip, describe_model, the corpus bytes and the entry point.
"""

import json
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tf_operator_tpu.data.text import _generate_corpus as j_generate_corpus
from tf_operator_tpu.data.text import ensure_text as j_ensure_text
from tf_operator_tpu.models import llama_loss as j_llama_loss
from tf_operator_tpu.models import llama_tiny as j_llama_tiny
from tf_operator_tpu.models.registry import describe_model as j_describe_model
from tf_operator_tpu.parallel import Trainer as JTrainer
from tf_operator_tpu.parallel import TrainerConfig as JTrainerConfig
from tf_operator_tpu.parallel import make_mesh
from tf_operator_tpu.parallel.trainer import make_optimizer as j_make_optimizer

from tf_operator_tpu_torch import llama_pretrain
from tf_operator_tpu_torch.data import text
from tf_operator_tpu_torch.models.decode import generate
from tf_operator_tpu_torch.models.llama import (
    LlamaLM,
    llama_loss,
    llama_loss_chunked,
    llama_tiny,
    llama_wide,
)
from tf_operator_tpu_torch.models.registry import describe_model, model_from_description
from tf_operator_tpu_torch.models.transformer import set_dropout_rng
from tf_operator_tpu_torch.models.weights import from_flax_params, init_params, load_npz
from tf_operator_tpu_torch.parallel.checkpoint import export_params
from tf_operator_tpu_torch.parallel.trainer import (
    Optimizer,
    Trainer,
    TrainerConfig,
    global_norm,
    learning_rate_at,
)
from tf_operator_tpu_torch.serve_lm import load_model

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

VOCAB, SEQ, BATCH = 256, 32, 4
PARAM_SHAPES = {"embedding": (16, 8), "kernel3": (8, 2, 4), "scale": (8,), "bias": (3,)}


def _fields(cfg):
    return {f: getattr(cfg, f) for f in ("learning_rate", "weight_decay", "warmup_steps",
                                         "total_steps", "grad_clip", "optimizer", "accum_steps")}


OPT_CASES = {
    "adamw_warmup_clip_decay": TrainerConfig(learning_rate=0.05, weight_decay=0.1,
                                             warmup_steps=2, total_steps=5, grad_clip=0.5),
    "adamw_constant_noclip": TrainerConfig(learning_rate=0.01, weight_decay=0.0,
                                           grad_clip=0.0),
    "sgd_momentum": TrainerConfig(learning_rate=0.1, optimizer="sgd", warmup_steps=1,
                                  total_steps=4, grad_clip=1.0),
    "adamw_accum2": TrainerConfig(learning_rate=0.05, weight_decay=0.1, warmup_steps=1,
                                  total_steps=4, grad_clip=0.5, accum_steps=2),
}


@pytest.mark.parametrize("name", sorted(OPT_CASES))
def test_optimizer_matches_the_jax_optax_chain(name):
    cfg = OPT_CASES[name]
    r = np.random.default_rng(sorted(OPT_CASES).index(name))
    params = {k: r.standard_normal(s).astype(np.float32) for k, s in PARAM_SHAPES.items()}
    steps = [{k: (r.standard_normal(s) * 0.5).astype(np.float32) for k, s in PARAM_SHAPES.items()}
             for _ in range(6)]
    tx = j_make_optimizer(JTrainerConfig(**_fields(cfg)))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.tensor(params[k])) for k in sorted(params)]
    opt = Optimizer(cfg, tp)
    for grads in steps:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step([torch.tensor(grads[k]) for k in sorted(grads)])
        for k, p in zip(sorted(params), tp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), atol=1e-6,
                                       rtol=1e-6, err_msg=k)
    assert opt.count == len(steps) // cfg.accum_steps


def test_schedule_matches_optax():
    for cfg in (TrainerConfig(learning_rate=3e-3, warmup_steps=10, total_steps=25),
                TrainerConfig(learning_rate=1e-2, warmup_steps=4, total_steps=2),
                TrainerConfig(learning_rate=1e-2)):
        if cfg.warmup_steps:
            sched = optax.warmup_cosine_decay_schedule(
                0.0, cfg.learning_rate, cfg.warmup_steps,
                max(cfg.total_steps, cfg.warmup_steps + 1))
        else:
            sched = optax.constant_schedule(cfg.learning_rate)
        for count in range(40):
            np.testing.assert_allclose(learning_rate_at(cfg, count), float(sched(count)),
                                       rtol=1e-6, atol=1e-12)
    # the first update of a warmed-up run has learning rate 0
    assert learning_rate_at(TrainerConfig(warmup_steps=3), 0) == 0.0


@pytest.mark.parametrize("clip", [0.1, 100.0])
def test_clip_matches_optax_clip_by_global_norm(clip):
    r = np.random.default_rng(7)
    grads = [r.standard_normal(s).astype(np.float32) for s in ((5, 3), (7,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(clip).update([jnp.asarray(g) for g in grads], None)
    opt = Optimizer(TrainerConfig(grad_clip=clip),
                    [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads])
    got = opt._clip([torch.tensor(g) for g in grads])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(float(global_norm([torch.tensor(g) for g in grads])),
                               float(optax.global_norm(grads)), rtol=1e-6)


def test_decay_mask_is_ndim_above_one_including_the_embedding():
    model = LlamaLM(llama_tiny(vocab_size=VOCAB), device="meta", trainable=True)
    opt = Optimizer(TrainerConfig(), [p for p in model.parameters()])
    names = [n for n, _ in model.named_parameters()]
    mask = dict(zip(names, opt.decay))
    assert mask == {n: p.ndim > 1 for n, p in model.named_parameters()}
    assert mask["tok_embed.embedding"] and mask["layers.0.self_attn.query.kernel"]
    assert not mask["layers.0.ln_self.scale"] and not mask["ln_final.scale"]


def test_unported_options_raise():
    model = LlamaLM(llama_tiny(vocab_size=VOCAB), device="meta", trainable=True)
    params = list(model.parameters())
    with pytest.raises(NotImplementedError):
        Optimizer(TrainerConfig(optimizer="adafactor"), params)
    with pytest.raises(ValueError, match="trainable"):
        Trainer(LlamaLM(llama_tiny(vocab_size=VOCAB), device="meta"), TrainerConfig(), llama_loss)


def _batches(seed, n):
    r = np.random.default_rng(seed)
    return [{"input_ids": r.integers(0, VOCAB, (BATCH, SEQ)).astype(np.int32)} for _ in range(n)]


def _jax_trainer(cfg, batch):
    mesh = make_mesh({"dp": 1}, devices=jax.devices()[:1])
    model = j_llama_tiny(vocab_size=VOCAB, max_len=SEQ, mesh=mesh, dtype=jnp.float32)
    return JTrainer(model, JTrainerConfig(**_fields(cfg)), mesh, j_llama_loss, batch,
                    init_args=(batch["input_ids"],), shardings="logical")


#: learning rates at which three warmed-up, clipped updates move the
#: parameters well above float32 rounding (adamw moves each element by
#: about lr per update, sgd by lr times a clipped gradient element)
TRAINER_LR = {"adamw": 1e-3, "sgd": 0.5}
#: error of a tensor's total update (after - before), in the L2 norm,
#: relative to the norm of JAX's update of that tensor (adam's update
#: g / sqrt(g^2) is sensitive to rounding where g is near its eps, so
#: single elements of the embedding differ by ~1 %)
UPDATE_RTOL = 1e-3


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_trainer_matches_the_jax_trainer(optimizer):
    cfg = TrainerConfig(learning_rate=TRAINER_LR[optimizer], weight_decay=0.1,
                        warmup_steps=2, total_steps=6, grad_clip=0.5, optimizer=optimizer)
    batches = _batches(1, 3)
    jt = _jax_trainer(cfg, batches[0])
    params = jax.tree_util.tree_map(np.asarray, flax.core.meta.unbox(jt.state.params))
    initial = {k: t.numpy().copy() for k, t in from_flax_params(params).items()}
    tcfg = llama_tiny(vocab_size=VOCAB, max_len=SEQ, dtype=torch.float32)
    model = LlamaLM.from_state_dict(tcfg, from_flax_params(params), "cpu", trainable=True)
    pt = Trainer(model, cfg, llama_loss)
    clipped = 0
    for batch in batches:
        jm = jt.train_step(jt.shard_batch(batch))
        pm = pt.train_step(batch)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(pm["token_accuracy"]), float(jm["token_accuracy"]))
        clipped += float(jm["grad_norm"]) > cfg.grad_clip
    assert clipped, "the clip never triggered: the test would not cover it"
    want = from_flax_params(jax.tree_util.tree_map(np.asarray,
                                                   flax.core.meta.unbox(jt.state.params)))
    got = dict(pt.model.named_parameters())
    assert set(got) == set(want)
    smallest_update = np.inf
    for name, t in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), t.numpy(), atol=2e-5,
                                   err_msg=name)
        want_delta = t.numpy() - initial[name]
        got_delta = got[name].detach().numpy() - initial[name]
        scale = np.linalg.norm(want_delta)
        err = np.linalg.norm(got_delta - want_delta)
        assert err <= UPDATE_RTOL * scale, (
            f"{name}: update error {err:.3g} > {UPDATE_RTOL} x update norm {scale:.3g}")
        smallest_update = min(smallest_update, np.abs(want_delta).max())
    # every tensor moved well past the atol above, so the update is seen
    assert smallest_update > 10 * 2e-5, f"smallest largest update {smallest_update:.3g}"


def test_chunked_loss_equals_full_loss():
    cfg = llama_tiny(vocab_size=VOCAB, max_len=33, dtype=torch.float32)
    state = init_params(cfg, 3, "cpu", trainable=True)
    batch = {"input_ids": torch.as_tensor(
        np.random.default_rng(2).integers(0, VOCAB, (2, 33)))}
    out = {}
    for name, fn in (("full", llama_loss), ("chunked", lambda m, b: llama_loss_chunked(m, b, 8))):
        model = LlamaLM.from_state_dict(cfg, state, "cpu", trainable=True)
        loss, metrics = fn(model, batch)
        loss.backward()
        out[name] = (loss.item(), metrics["token_accuracy"].item(),
                     {n: p.grad.clone() for n, p in model.named_parameters()})
    np.testing.assert_allclose(out["chunked"][0], out["full"][0], rtol=1e-6)
    assert out["chunked"][1] == out["full"][1]
    for n, g in out["full"][2].items():
        torch.testing.assert_close(out["chunked"][2][n], g, atol=1e-6, rtol=1e-5)


def test_trainable_and_serving_storage():
    cfg = llama_tiny(vocab_size=VOCAB)
    state = init_params(cfg, 0, "cpu", trainable=True)
    train = LlamaLM.from_state_dict(cfg, state, "cpu", trainable=True)
    serve = LlamaLM.from_state_dict(cfg, state, "cpu")
    assert train.training and not serve.training
    for (n, p), (_, s) in zip(train.named_parameters(), serve.named_parameters()):
        assert p.dtype == torch.float32 and p.requires_grad, n
        assert not s.requires_grad
        assert s.dtype == (torch.float32 if n.endswith("scale") else torch.bfloat16), n
        assert p.data_ptr() != state[n].data_ptr()  # a trainable model copies
    ids = torch.as_tensor(np.random.default_rng(0).integers(0, VOCAB, (2, 16)))
    with torch.no_grad():
        torch.testing.assert_close(train(ids), serve(ids), atol=0, rtol=0)
    # dropout acts only in a training forward, with the model's generator
    dropout = LlamaLM.from_state_dict(llama_tiny(vocab_size=VOCAB, dropout=0.1), state, "cpu",
                                      trainable=True)
    with torch.no_grad():
        torch.testing.assert_close(dropout(ids), train(ids), atol=0, rtol=0)
        with pytest.raises(ValueError, match="dropout_rng"):
            dropout(ids, train=True)
        set_dropout_rng(dropout, torch.Generator().manual_seed(0))
        assert not torch.equal(dropout(ids, train=True), train(ids))
        torch.testing.assert_close(dropout.eval()(ids), train(ids), atol=0, rtol=0)


def test_export_serves_what_training_left(tmp_path):
    cfg = llama_tiny(vocab_size=VOCAB, max_len=64)
    model = LlamaLM.from_state_dict(cfg, init_params(cfg, 4, "cpu", trainable=True), "cpu",
                                    trainable=True)
    trainer = Trainer(model, TrainerConfig(learning_rate=1e-2), llama_loss)
    for batch in _batches(5, 2):
        trainer.train_step(batch)
    export_params(trainer, str(tmp_path))
    with open(tmp_path / "model.json") as f:
        desc = json.load(f)
    assert model_from_description(desc) == (LlamaLM, cfg)
    served = load_model(torch.device("cpu"), max_len=64, artifact=str(tmp_path))
    flat = np.load(tmp_path / "params.npz")
    assert "layer_0/self_attn/query/kernel" in flat.files
    assert all(flat[k].dtype == np.float32 for k in flat.files)
    for n, t in load_npz(str(tmp_path / "params.npz")).items():
        torch.testing.assert_close(t, dict(model.named_parameters())[n].detach(), atol=0, rtol=0)
    prompt = torch.as_tensor([list(b"the sharded ")])
    torch.testing.assert_close(generate(served, prompt, 12), generate(model, prompt, 12))


@pytest.mark.parametrize("cfg", [llama_tiny(vocab_size=VOCAB, max_len=64), llama_wide()],
                         ids=["tiny", "wide"])
def test_describe_model_round_trips_and_matches_jax(cfg):
    d = describe_model(LlamaLM(cfg, device="meta"))
    assert json.loads(json.dumps(d)) == d
    assert model_from_description(d) == (LlamaLM, cfg)
    if cfg.hidden == 128:
        jm = j_llama_tiny(vocab_size=VOCAB, max_len=64)
        assert j_describe_model(jm) == d


def test_wide_config_matches_bench():
    import bench

    want = bench.llama_wide_config(2048)
    got = llama_wide(max_len=2048)
    for f in ("vocab_size", "hidden", "n_heads", "head_dim", "n_layers", "mlp_dim", "max_len",
              "dropout", "rope", "attn_bias", "n_kv_heads", "window"):
        assert getattr(got, f) == getattr(want, f), f


def test_corpus_matches_jax(tmp_path):
    for seed in (0, 3):
        assert text._generate_corpus(5000, seed) == j_generate_corpus(5000, seed)
    j_ensure_text(str(tmp_path / "jax"), n_chars=1 << 14, seq_len=64)
    text.ensure_text(str(tmp_path / "port"), n_chars=1 << 14, seq_len=64)
    a = np.load(tmp_path / "jax" / "tokens.npy")
    b = np.load(tmp_path / "port" / "tokens.npy")
    np.testing.assert_array_equal(a, b)
    # an epoch visits every window once, in a fresh order
    loader = text.TextBatches(str(tmp_path / "port"), 8, seed=1, num_epochs=2)
    epochs = [np.concatenate([x["input_ids"] for x in list(loader)[i * 32:(i + 1) * 32]])
              for i in range(2)]
    for e in epochs:
        assert sorted(map(bytes, e)) == sorted(map(bytes, b))
    assert not np.array_equal(epochs[0], epochs[1])


def test_entry_point_trains_on_the_cpu(tmp_path, capsys):
    argv = ["--device", "cpu", "--model", "llama-tiny", "--seq-len", "32",
            "--batch-per-device", "8", "--steps", "20", "--steps-per-sync", "4", "--data-dir", str(tmp_path / "data"),
            "--export-dir", str(tmp_path / "art"), "--generate", "8"]
    assert llama_pretrain.main(argv) == 0
    out = capsys.readouterr().out
    assert "loss" in out and "sample:" in out
    assert sorted(os.listdir(tmp_path / "art")) == ["model.json", "params.npz"]
    # sequence parallelism is ported: --sp must divide the sequence
    args = llama_pretrain.parse_args(argv + ["--sp", "2", "--sp-impl", "ulysses"])
    assert (args.sp, args.sp_impl) == (2, "ulysses")
    # --family moe trains moe_tiny: beside a llama shape it is refused, and
    # it ignores --sp, as the reference does
    assert llama_pretrain.parse_args(argv + ["--family", "moe"]).family == "moe"
    assert llama_pretrain.parse_args(argv + ["--family", "moe", "--sp", "3"]).family == "moe"
    for bad in (["--sp", "3"], ["--sp", "0"], ["--sp-impl", "tree"],
                ["--family", "moe", "--model", "llama-wide"]):
        with pytest.raises(SystemExit):
            llama_pretrain.parse_args(argv + bad)
    # outside a job there is no sp line to split over
    with pytest.raises(ValueError, match="does not divide the job's 1 processes"):
        llama_pretrain.run(llama_pretrain.parse_args(argv + ["--sp", "2"]))


def test_the_reference_manifest_argv_parses():
    """The job manifest's command line for the JAX llama_pretrain, with
    the JAX harness's flag names, parses on the port's entry point."""

    import yaml

    with open(os.path.join(ROOT, "examples", "manifests", "llama_pretrain.yaml")) as f:
        spec = yaml.safe_load(f)["spec"]["tpuReplicaSpecs"]["Worker"]["template"]["spec"]
    command = spec["containers"][0]["command"]
    assert command[:2] == ["python3", "examples/llama_pretrain.py"]
    args = llama_pretrain.parse_args(command[2:])
    assert command[command.index("--batch-per-device") + 1] == "4"
    assert (args.batch_per_device, args.steps, args.seq_len, args.generate) == (4, 40, 128, 32)


def test_eval_step_and_benchmark():
    cfg = llama_tiny(vocab_size=VOCAB, max_len=SEQ, dtype=torch.float32)
    model = LlamaLM.from_state_dict(cfg, init_params(cfg, 6, "cpu", trainable=True), "cpu",
                                    trainable=True)
    trainer = Trainer(model, TrainerConfig(learning_rate=1e-2), llama_loss)
    batch = _batches(8, 1)[0]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    m = trainer.eval_step(batch)
    assert model.training
    assert all(torch.equal(p, before[n]) for n, p in model.named_parameters())
    with torch.no_grad():
        want, _ = llama_loss(model, {"input_ids": torch.as_tensor(batch["input_ids"])})
    assert float(m["loss"]) == float(want)
    out = trainer.benchmark(batch, steps=6, warmup=1)
    assert trainer.host_step == 7 and trainer.optimizer.count == 7
    assert out["step_ms"] > 0 and out["examples_per_sec"] == pytest.approx(
        BATCH * out["steps_per_sec"])
