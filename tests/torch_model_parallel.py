"""Shared pieces of the tensor- and expert-parallel tests
(``test_torch_tensor_parallel.py``, ``test_torch_expert_parallel.py``):
the six transformer families at test scale, their batches, and the
worker that trains them as the ranks of a gloo world
(``python -m torch_model_parallel SPEC``; it imports torch and the port
only, so a rank starts without JAX), and the JAX ``Trainer`` the runs
are held against (:func:`jax_run`, which imports JAX when called).

A spec is a JSON list of runs: ``{"name", "family", "mesh", "state"
(an npz of port names), "batches" (an npz of arrays [steps, rows, ...]),
"dropout", "moe" (MoeConfig fields), "shardings" (the ``Trainer``'s
rule, ``"logical"`` by default), "export", "guard", "out", "seq" (the
decoder families' length, ``SEQ`` by default), "sp_impl" (the schedule
of a mesh with sp above 1, whose model is built on it), "fault"
(``"moe_sp_prefix"``: moe's capacity scan without the earlier sp ranks'
counts, the planted fault its test must see), "window" (a decoder's
sliding window), "generate" (after the steps, decode ``{"prompt": [B,
P] ids, "new": N}`` with ``Trainer.generate`` on the live shards and
with ``models/decode.generate`` from the gathered copy:
:func:`_generate`)}``.  Each
rank of a run writes ``{out}/{name}_rank{r}.json``: the step metrics, the
shapes of the parameters it holds, a digest of each parameter it keeps
whole (bitwise equality across a tp or ep line), the seed of its
dropout generator and the collective stages; rank 0 also writes
``{name}_params.npz`` (``Trainer.full_params``) and, with ``export``, an
``export_params`` artifact under ``{name}_artifact``."""

import hashlib
import json
import os
import sys

import numpy as np
import torch

from tf_operator_tpu_torch.models import bert, gpt, llama, moe, t5, vit

VOCAB, SEQ, ENC, DEC, IMAGE, CLASSES = 128, 16, 12, 8, 32, 10
STEPS = 3
#: the runs' optimizer: sgd with momentum, no warmup, the default clip
TRAIN_CFG = dict(learning_rate=1e-2, weight_decay=1e-4, warmup_steps=0, total_steps=10_000,
                 grad_clip=1.0, optimizer="sgd", momentum=0.9)
FAMILIES = ("llama", "gpt", "moe", "bert", "t5", "vit")
#: each family's port class, config, loss and the batch keys of its
#: forward's inputs
PORT = {
    "llama": (llama.LlamaLM,
              lambda d, seq=SEQ, **kw: llama.llama_tiny(VOCAB, seq, dtype=d, **kw),
              llama.llama_loss),
    "gpt": (gpt.CausalLM, lambda d, seq=SEQ, **kw: gpt.gpt_tiny(VOCAB, seq, dtype=d, **kw),
            gpt.lm_loss),
    "moe": (moe.MoeLM, lambda d, seq=SEQ, **kw: moe.moe_tiny(VOCAB, seq, dtype=d, **kw),
            moe.moe_lm_loss),
    "bert": (bert.BertForPretraining, lambda d, **kw: bert.bert_tiny(VOCAB, SEQ, dtype=d, **kw),
             bert.mlm_loss),
    "t5": (t5.T5, lambda d, **kw: t5.t5_tiny(VOCAB, dtype=d, **kw), t5.seq2seq_loss),
    "vit": (vit.ViT, lambda d, **kw: vit.vit_tiny(IMAGE, CLASSES, dtype=d, **kw), vit.vit_loss),
}
INIT_KEYS = {"llama": ("input_ids",), "gpt": ("input_ids",), "moe": ("input_ids",),
             "bert": ("input_ids",), "t5": ("encoder_ids", "decoder_ids"), "vit": ("image",)}


def batches(family, rows, seed, steps=STEPS, seq=SEQ):
    """``steps`` seeded global batches of ``rows`` rows: {key: [steps,
    rows, ...]} (the decoder families' of length ``seq``)."""

    r = np.random.default_rng(seed)
    if family in ("llama", "gpt", "moe"):
        return {"input_ids": r.integers(0, VOCAB, (steps, rows, seq)).astype(np.int32)}
    if family == "bert":
        labels = np.where(r.random((steps, rows, SEQ)) < 0.3,
                          r.integers(0, VOCAB, (steps, rows, SEQ)), -100).astype(np.int32)
        labels[:, :, 0] = r.integers(0, VOCAB, (steps, rows))  # one label a row at least
        return {"input_ids": r.integers(0, VOCAB, (steps, rows, SEQ)).astype(np.int32),
                "labels": labels}
    if family == "t5":
        return {"encoder_ids": r.integers(0, VOCAB, (steps, rows, ENC)).astype(np.int32),
                "decoder_ids": r.integers(0, VOCAB, (steps, rows, DEC)).astype(np.int32),
                "targets": r.integers(0, VOCAB, (steps, rows, DEC)).astype(np.int32)}
    return {"image": r.random((steps, rows, IMAGE, IMAGE, 3)).astype(np.float32),
            "label": r.integers(0, CLASSES, (steps, rows)).astype(np.int32)}


def port_model(family, state, dropout=0.0, dtype=torch.float32, **kw):
    """``kw``: the config's other fields (``seq``, MoeConfig fields, an
    sp ``mesh`` and ``sp_impl``)."""

    cls, build, _ = PORT[family]
    return cls.from_state_dict(build(dtype, dropout=dropout, **kw), state, "cpu",
                               trainable=True)


def _no_prefix(counts, line):
    """``moe.route_offsets`` with the earlier ranks' counts left out (the
    planted fault ``moe_sp_prefix``)."""

    return torch.zeros_like(counts), ORIGINAL_ROUTE_OFFSETS(counts, line)[1]


ORIGINAL_ROUTE_OFFSETS = moe.route_offsets


def save_state(state, path) -> None:
    """A port state (name -> tensor) as an npz under the port's names."""

    np.savez(path, **{k: np.asarray(v, np.float32) for k, v in state.items()})


def load_state(path):
    with np.load(path) as f:
        return {k: torch.as_tensor(f[k]) for k in f.files}


def digest(t: torch.Tensor) -> str:
    return hashlib.sha1(t.detach().contiguous().numpy().tobytes()).hexdigest()


def _run(spec, out_dir):
    from tf_operator_tpu_torch.parallel.checkpoint import export_params
    from tf_operator_tpu_torch.parallel.mesh import make_mesh
    from tf_operator_tpu_torch.parallel.trainer import Trainer, TrainerConfig
    from tf_operator_tpu_torch.runtime.bootstrap import world

    rank, n = world()
    family = spec["family"]
    mesh = make_mesh(spec["mesh"])
    kw = dict(spec.get("moe", {}))
    if family in ("llama", "gpt", "moe"):
        kw["seq"] = spec.get("seq", SEQ)
    if spec.get("window"):
        kw["window"] = spec["window"]
    gathered_kw = dict(kw)
    if mesh.shape["sp"] > 1:
        kw.update(mesh=mesh, sp_impl=spec.get("sp_impl", "ring"))
    model = port_model(family, load_state(spec["state"]), spec.get("dropout", 0.0), **kw)
    trainer = Trainer(model, TrainerConfig(**TRAIN_CFG), PORT[family][2], mesh=mesh,
                      shardings=spec.get("shardings", "logical"))
    with np.load(spec["batches"]) as f:
        data = {k: f[k] for k in f.files}
    rec = {"rank": rank, "world": n, "mesh": dict(mesh.shape),
           "dropout_seed": trainer.dropout_rng.initial_seed()}
    if spec.get("guard"):
        try:
            trainer.shard_batch({k: v[0] for k, v in data.items()})
            rec["guard"] = "did not fire"
        except ValueError as e:
            rec["guard"] = str(e)
    metrics = []
    if spec.get("fault") == "moe_sp_prefix":
        moe.route_offsets = _no_prefix
    try:
        for step in range(len(next(iter(data.values())))):
            m = trainer.train_step(trainer.shard_global_batch({k: v[step]
                                                               for k, v in data.items()}))
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        moe.route_offsets = ORIGINAL_ROUTE_OFFSETS
    rec["metrics"] = metrics
    rec["shapes"] = {n_: list(p.shape) for n_, p in zip(trainer.names, trainer.params)}
    rec["masters"] = {n_: list(t.shape) for n_, t in zip(trainer.names, trainer.masters)}
    rec["whole"] = {n_: digest(t) for n_, t, dims in zip(trainer.names, trainer.masters,
                                                          trainer._model_dims) if not dims}
    if spec.get("generate"):
        rec["generate"] = _generate(trainer, family, gathered_kw, spec["generate"], rank)
    rec["stages"] = sorted(trainer.collective_stats.by_stage)
    full = trainer.full_params()
    if rank == 0:
        np.savez(os.path.join(out_dir, f"{spec['name']}_params.npz"),
                 **{k: v.numpy() for k, v in full.items()})
    if spec.get("export"):
        export_params(trainer, os.path.join(out_dir, f"{spec['name']}_artifact"))
    with open(os.path.join(out_dir, f"{spec['name']}_rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def _jax_model(family, mesh, dropout=0.0, sp_impl="ring", seq=SEQ, **moe_kw):
    import dataclasses

    import jax.numpy as jnp

    from tf_operator_tpu.models import bert as jbert
    from tf_operator_tpu.models import gpt as jgpt
    from tf_operator_tpu.models import llama as jllama
    from tf_operator_tpu.models import moe as jmoe
    from tf_operator_tpu.models import t5 as jt5
    from tf_operator_tpu.models import vit as jvit

    kw = dict(dtype=jnp.float32, dropout=dropout, sp_impl=sp_impl)
    if family == "llama":
        if dropout:
            raise ValueError("llama_tiny trains at dropout 0")
        return jllama.llama_tiny(vocab_size=VOCAB, max_len=seq, mesh=mesh, dtype=jnp.float32,
                                 sp_impl=sp_impl)
    if family == "gpt":
        return jgpt.gpt_tiny(vocab_size=VOCAB, max_len=seq, mesh=mesh, **kw)
    if family == "moe":
        m = jmoe.moe_tiny(vocab_size=VOCAB, max_len=seq, mesh=mesh, **moe_kw)
        return jmoe.MoeLM(dataclasses.replace(m.moe, base=dataclasses.replace(m.moe.base, **kw)))
    if family == "bert":
        return jbert.bert_tiny(vocab_size=VOCAB, max_len=SEQ, mesh=mesh, **kw)
    if family == "t5":
        return jt5.t5_tiny(vocab_size=VOCAB, mesh=mesh, **kw)
    return jvit.vit_tiny(image_size=IMAGE, n_classes=CLASSES, mesh=mesh, **kw)


def jax_loss(family):
    from tf_operator_tpu.models import bert as jbert
    from tf_operator_tpu.models import gpt as jgpt
    from tf_operator_tpu.models import llama as jllama
    from tf_operator_tpu.models import moe as jmoe
    from tf_operator_tpu.models import t5 as jt5
    from tf_operator_tpu.models import vit as jvit

    return {"llama": jllama.llama_loss, "gpt": jgpt.lm_loss, "moe": jmoe.moe_lm_loss,
            "bert": jbert.mlm_loss, "t5": jt5.seq2seq_loss, "vit": jvit.vit_loss}[family]


def to_port(family, tree):
    """A flax param tree (numpy leaves) as the port's state."""

    from tf_operator_tpu_torch.models.weights import family_state_from_flax, from_flax_params

    if family in ("llama", "gpt", "moe"):
        return from_flax_params(tree)
    return family_state_from_flax(tree)


def jax_run(family, shape, data, sp_impl="ring", **moe_kw):
    """The JAX ``Trainer(shardings="logical")`` over a mesh of ``shape``
    on the host devices, at dropout 0 and ``TRAIN_CFG`` (a decoder
    family's length ``data``'s, its sp schedule ``sp_impl``), through the
    steps of ``data`` ({key: [steps, rows, ...]}): {"initial": its
    initial params as a port state, "metrics": a dict a step, "final":
    its params after the steps (port names, numpy), "shards": the shape
    of each param's shard on a device (port names)}."""

    return jax_train(jax_trainer(family, shape, data, sp_impl, **moe_kw), data)


def jax_trainer(family, shape, data, sp_impl="ring", **moe_kw):
    """:func:`jax_run`'s trainer, built and initialised, before its steps:
    {"trainer", "family", "initial", "shards"} (those two as
    :func:`jax_run` gives them)."""

    import jax

    from tf_operator_tpu.parallel import Trainer as JTrainer
    from tf_operator_tpu.parallel import TrainerConfig as JTrainerConfig
    from tf_operator_tpu.parallel import make_mesh as j_make_mesh

    n = int(np.prod(list(shape.values())))
    mesh = j_make_mesh(shape, devices=jax.devices()[:n])
    first = {k: v[0] for k, v in data.items()}
    seq = {"seq": first["input_ids"].shape[-1]} if family in ("llama", "gpt", "moe") else {}
    jt = JTrainer(_jax_model(family, mesh, sp_impl=sp_impl, **seq, **moe_kw),
                  JTrainerConfig(**TRAIN_CFG), mesh,
                  jax_loss(family), first, init_args=tuple(first[k] for k in INIT_KEYS[family]),
                  shardings="logical")
    boxed = _boxed(jt)
    shards = jax.tree_util.tree_map(
        lambda leaf: np.empty(leaf.sharding.shard_shape(leaf.shape), np.float32), boxed)
    return {"trainer": jt, "family": family, "initial": to_port(family, _unbox(jt)),
            "shards": {k: tuple(v.shape) for k, v in to_port(family, shards).items()}}


def _boxed(jt):
    import flax

    return flax.core.meta.unbox(jt.state.params)


def _unbox(jt):
    import jax

    return jax.tree_util.tree_map(np.asarray, _boxed(jt))


def jax_train(run, data):
    """:func:`jax_trainer`'s ``run`` through the steps of ``data``: the run
    with "metrics" and "final" added (:func:`jax_run`)."""

    jt = run.pop("trainer")
    run["metrics"] = [{k: float(v) for k, v in jt.train_step(
        jt.shard_batch({k: v[s] for k, v in data.items()})).items()}
        for s in range(len(next(iter(data.values()))))]
    run["final"] = {k: v.numpy() for k, v in to_port(run["family"], _unbox(jt)).items()}
    return run


def _generate(trainer, family, kw, gen, rank):
    """Greedy ids of ``gen["prompt"]`` from ``Trainer.generate`` on the
    live shards (``sharded``) and from ``models/decode.generate`` on a
    float32 copy of the gathered weights (``gathered``); sampled ids
    drawn from a generator seeded by the rank (``sampled``: the mesh's
    first rank's draws on every rank); the refusal of sampling without a
    generator; the K/V heads of the rank's cache."""

    from tf_operator_tpu_torch.models import decode

    prompt = torch.as_tensor(np.asarray(gen["prompt"], np.int64))
    n = gen["new"]
    sharded = trainer.generate(prompt, n)
    sampled = trainer.generate(prompt, n, temperature=0.8, top_k=16,
                               generator=torch.Generator().manual_seed(100 + rank))
    try:
        trainer.generate(prompt, 2, temperature=0.7)
        raises = "did not raise"
    except ValueError as e:
        raises = str(e)
    cache = decode.init_cache(decode.decode_variant(trainer.model), 1)
    cls, build, _ = PORT[family]
    full = {k: v.clone() for k, v in trainer.full_params().items()}
    trainer.release()
    gathered = decode.generate(cls.from_state_dict(build(torch.float32, **kw), full, "cpu"),
                               prompt, n)
    return {"sharded": sharded.tolist(), "gathered": gathered.tolist(),
            "sampled": sampled.tolist(), "raises": raises,
            "cache_heads": int(cache.layers[0][0].shape[1]), "dtype": str(sharded.dtype)}


def main(path):
    from tf_operator_tpu_torch.runtime.bootstrap import initialize

    torch.set_num_threads(1)
    initialize("cpu")
    with open(path) as f:
        specs = json.load(f)
    for spec in specs:
        _run(spec, os.path.dirname(path))


if __name__ == "__main__":
    main(sys.argv[1])
