"""Shared pieces of the decoder-zoo tests (``test_torch_gpt.py``,
``test_torch_moe.py``, ``test_torch_zoo_serving.py``): the JAX package's
``gpt_tiny`` / ``moe_tiny`` and the port's, one flax param tree bridged
into the port (``models/weights.from_flax_params``: the llama family's
names), seeded numpy inputs, and the comparisons the files share: the
loss and gradients, three ``Trainer`` steps against the JAX ``Trainer``
(float32, AdamW, warmup, clip: loss rtol 1e-5, grad norm rtol 1e-4 a
step, as ``tests/test_torch_encoders.py`` holds the encoders) and the
logical shardings against the JAX trainer's layout."""

import dataclasses
import types

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch

from tf_operator_tpu.models import gpt as jgpt
from tf_operator_tpu.models import moe as jmoe
from tf_operator_tpu.parallel import Trainer as JTrainer
from tf_operator_tpu.parallel import TrainerConfig as JTrainerConfig
from tf_operator_tpu.parallel import make_mesh as j_make_mesh
from tf_operator_tpu.parallel import mesh as jmesh
from tf_operator_tpu.parallel import sharding as jsharding

from tf_operator_tpu_torch.models import gpt, moe
from tf_operator_tpu_torch.models.weights import from_flax_params
from tf_operator_tpu_torch.parallel import mesh, sharding
from tf_operator_tpu_torch.parallel.trainer import Trainer, TrainerConfig

VOCAB, MAX_LEN = 128, 64
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
#: forward logits, max |port - JAX| over max |JAX|: float32 products
#: summed in another order over two layers; bf16 activations rounded at
#: other points (as tests/test_torch_encoders.py holds the encoders)
FWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
FAMILIES = ("gpt", "moe")
PORT_CLS = {"gpt": gpt.CausalLM, "moe": moe.MoeLM}


def unbox(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.meta.unbox(tree))


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def ids(seed, shape, vocab=VOCAB):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def jax_model(family, jdtype=jnp.float32, vocab=VOCAB, max_len=MAX_LEN, dropout=0.1,
              mesh=None, **moe_kw):
    """The JAX package's tiny model of ``family`` at ``jdtype`` and
    ``dropout`` (moe: ``moe_kw`` are MoeConfig fields)."""

    if family == "gpt":
        return jgpt.gpt_tiny(vocab_size=vocab, max_len=max_len, dtype=jdtype, dropout=dropout,
                             mesh=mesh)
    m = jmoe.moe_tiny(vocab_size=vocab, max_len=max_len, mesh=mesh, **moe_kw)
    return jmoe.MoeLM(dataclasses.replace(
        m.moe, base=dataclasses.replace(m.moe.base, dtype=jdtype, dropout=dropout)))


def port_config(family, dtype=torch.float32, vocab=VOCAB, max_len=MAX_LEN, dropout=0.1,
                **moe_kw):
    if family == "gpt":
        return gpt.gpt_tiny(vocab, max_len, dtype=dtype, dropout=dropout)
    return moe.moe_tiny(vocab, max_len, dtype=dtype, dropout=dropout, **moe_kw)


def jax_params(family, seed=0, vocab=VOCAB, max_len=MAX_LEN, **moe_kw):
    jm = jax_model(family, vocab=vocab, max_len=max_len, **moe_kw)
    return unbox(jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"])


def port_model(family, state, dtype=torch.float32, trainable=False, **kw):
    return PORT_CLS[family].from_state_dict(port_config(family, dtype, **kw), state, "cpu",
                                            trainable=trainable)


def bridged(family, seed=0, vocab=VOCAB, max_len=MAX_LEN, dtype=torch.float32, **moe_kw):
    """(JAX model, its params, the port's serving model on them)."""

    params = jax_params(family, seed, vocab, max_len, **moe_kw)
    jm = jax_model(family, vocab=vocab, max_len=max_len, **moe_kw)
    model = port_model(family, from_flax_params(params), dtype, vocab=vocab,
                       max_len=max_len, **moe_kw)
    return jm, params, model


JAX_LOSS = {"gpt": jgpt.lm_loss, "moe": jmoe.moe_lm_loss}
PORT_LOSS = {"gpt": gpt.lm_loss, "moe": moe.moe_lm_loss}


def jax_loss_and_grads(family, params, batch, **moe_kw):
    """The JAX loss, its metrics and gradients at dropout 0."""

    jm = jax_model(family, dropout=0.0, **moe_kw)
    state = types.SimpleNamespace(apply_fn=jm.apply)

    def loss_of(p):
        loss, aux = JAX_LOSS[family](p, state, batch, jax.random.PRNGKey(0), train=False)
        return loss, aux["metrics"]

    (loss, metrics), grads = jax.value_and_grad(loss_of, has_aux=True)(params)
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


def assert_grads_match(model, jgrads):
    """Every gradient within 1e-4 of its tensor's largest element plus
    1e-6 of the model's largest gradient element (float32 backward sums
    in another order; the key biases' gradients are zero in exact
    arithmetic and both sides leave float32 noise there)."""

    want = {n: t.numpy() for n, t in from_flax_params(jgrads).items()}
    assert set(want) == {n for n, _ in model.named_parameters()}
    floor = 1e-6 * max(np.abs(g).max() for g in want.values())
    for name, p in model.named_parameters():
        err = np.abs(p.grad.numpy() - want[name]).max()
        assert err <= 1e-4 * np.abs(want[name]).max() + floor, name


def save_jax_artifact(jm, params, directory):
    """An ``export_params``-shaped artifact the JAX package's model and
    params make: ``params.npz`` of flat flax paths and ``model.json`` of
    its ``describe_model``."""

    import json

    from tf_operator_tpu.models.registry import describe_model

    flat = {"/".join(str(k.key) for k in path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_leaves_with_path(params)}
    np.savez(directory / "params.npz", **flat)
    (directory / "model.json").write_text(json.dumps(describe_model(jm)))
    return str(directory)


#: the trainer step's config (tests/test_torch_encoders.py's)
TRAIN_CFG = TrainerConfig(learning_rate=1e-3, weight_decay=0.1, warmup_steps=2, total_steps=6,
                          grad_clip=0.5, optimizer="adamw")


def jax_trainer(family, batch, **moe_kw):
    one = j_make_mesh({"dp": 1}, devices=jax.devices()[:1])
    jcfg = JTrainerConfig(**{f: getattr(TRAIN_CFG, f) for f in (
        "learning_rate", "weight_decay", "warmup_steps", "total_steps", "grad_clip",
        "optimizer", "accum_steps")})
    return JTrainer(jax_model(family, dropout=0.0, **moe_kw), jcfg, one,
                    JAX_LOSS[family], batch, init_args=(batch["input_ids"],),
                    shardings="logical")


def trainer_matches(family, **moe_kw):
    batches = [{"input_ids": ids(s, (4, 16))} for s in (11, 12, 13)]
    jt = jax_trainer(family, batches[0], **moe_kw)
    model = port_model(family, from_flax_params(unbox(jt.state.params)),
                       trainable=True, dropout=0.0, **moe_kw)
    pt = Trainer(model, TRAIN_CFG, PORT_LOSS[family])
    for batch in batches:
        jm = jt.train_step(jt.shard_batch(batch))
        pm = pt.train_step(batch)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    assert pt.optimizer.count == 3
    return pm, jm


def _jspec(sharding_or_spec, ndim):
    spec = getattr(sharding_or_spec, "spec", sharding_or_spec)
    out = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return tuple(tuple(e) if isinstance(e, list) else e for e in out)


def logical_shardings_match(family, fsdp, **moe_kw):
    """The port's logical specs of ``family`` equal the JAX trainer's on a
    mesh of ``fsdp`` ranks over fsdp, or of the shape ``fsdp`` names
    (a dict: the tp and ep meshes too)."""

    shape = fsdp if isinstance(fsdp, dict) else {"fsdp": fsdp}
    n = int(np.prod(list(shape.values())))
    jm = jmesh.make_mesh(shape, devices=jax.devices()[:n])
    jmodel = jax_model(family, mesh=jm, **moe_kw)
    abstract = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                  jnp.zeros((n, 8), jnp.int32)))["params"]
    with jm, fnn.logical_axis_rules(list(jsharding.LOGICAL_RULES)):
        sh = flax.traverse_util.flatten_dict(jsharding.logical_shardings(abstract, jm), sep="/")
    flat = flax.traverse_util.flatten_dict(abstract, sep="/")
    model = PORT_CLS[family](port_config(family, **moe_kw), device="meta", trainable=True)
    shapes = {n: p.shape for n, p in model.named_parameters()}
    got = sharding.logical_shardings(shapes, mesh.make_mesh(shape, world=n))
    assert {model.flax_path(n) for n in got} == set(flat)
    for name, spec in got.items():
        path = model.flax_path(name)
        assert spec == _jspec(sh[path], len(flat[path].value.shape)), name
    for ax in shape:
        if ax != "dp":
            assert any(ax in str(s) for s in got.values()), ax
