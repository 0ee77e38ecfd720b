"""Pipeline parallelism of the port (parallel/pipeline.py,
models/pipelined_lm.py, the ``gpt_pipeline`` entry) in real gloo worlds
on the CPU, against the JAX package's GPipe schedule on the conftest's
virtual CPU devices.

Two worlds run one after the other, each rank a process of this file
(``python -m tests.test_torch_pipeline DIR``, ``tests/torch_world.py``):
2 ranks ({"pp": 2}) and 4 ranks ({"pp": 2, "dp": 2}); then
``gpt_pipeline --pp 2`` as a 2-process job, beside its one-process run.
The test process computes the JAX side on meshes of the same shape.  Sizes: the JAX
package's own pipeline test (a toy stage of width 16; vocab 64, hidden
32, 2 heads of 16, 4 layers, ids [8, 16], microbatches 2).  Tolerances,
max |port - JAX| over max |JAX| unless stated:

- ``pipeline_apply`` with the reference test's toy stage, each rank's
  stage: the output and the gradients of the stage parameters and of
  the input, 1e-5 (float32 sums in another order);
- ``PipelinedLM`` with gpt blocks and with llama blocks (rope, GQA,
  swiglu), float32: logits 1e-5, the loss rtol 1e-6, every gradient
  (each rank's stage and the replicated leaves) 1e-4 of its tensor's
  largest element plus 1e-6 of the largest of them all; bf16 (the
  config's default): logits 2e-2, the reference test's bound;
- pp 2 x dp 2: the toy stage as above, and three ``optax.adamw``-form
  steps of the gpt blocks (float32) against the JAX step on the same
  mesh shape: each loss rtol 1e-5, every rank's the same;
- one process at pp 1: the pipelined forward against the port's
  ``lm_reference_apply`` (1e-6) and the JAX ``lm_reference_apply``
  (1e-5);
- the flash attention's calls a rank (its plain versions here): the
  stage's layers x the microbatches each, forward, dQ and dK/dV (no
  bubble tick runs its stage); a rank's stage bytes half of the stack's;
- the reference's three errors, with its messages;
- ``gpt_pipeline --pp 2`` as a 2-process job: the reference's tag
  line, the same losses on both ranks, within 2e-2 of the one process
  at pp 1 (bf16, the same ids), and exit 2 where pp does not divide the
  processes.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_world import ROOT, World

torch.set_num_threads(2)

D = 16
VOCAB, HIDDEN, HEADS, HEAD_DIM, LAYERS, SEQ, ROWS, MB = 64, 32, 2, 16, 4, 16, 8, 2
TOY_ROWS, TOY_MB = 8, 4
ADAM_LR, ADAM_STEPS = 1e-3, 3
FAMILIES = ("gpt", "llama")
#: gpt_pipeline's job: steps (every step resolved) and rows a rank
JOB_STEPS, JOB_ROWS = 20, 8


def _cfg_kw(family):
    llama = family == "llama"
    return dict(vocab_size=VOCAB, hidden=HIDDEN, n_heads=HEADS, head_dim=HEAD_DIM,
                n_layers=LAYERS, mlp_dim=2 * HIDDEN, max_len=SEQ, rope=llama,
                attn_bias=not llama, n_kv_heads=1 if llama else None)


def _activation(family):
    return "swiglu" if family == "llama" else "relu"


def _toy_stages(n, seed=3):
    r = np.random.RandomState(seed)
    return [{"w": (r.randn(D, D) * 0.3).astype(np.float32),
             "b": (r.randn(D) * 0.1).astype(np.float32)} for _ in range(n)]


def _toy_x():
    return np.random.RandomState(2).randn(TOY_ROWS, D).astype(np.float32)


def _ids():
    return np.random.default_rng(0).integers(0, VOCAB, (ROWS, SEQ)).astype(np.int32)


def _port_stage_fn(p, h):
    return h + torch.relu(h @ p["w"] + p["b"])


# -- the worker (each rank) ---------------------------------------------------

def _port_model(family, state, mesh, dtype=torch.float32):
    from tf_operator_tpu_torch.models.pipelined_lm import PipelinedLM
    from tf_operator_tpu_torch.models.transformer import TransformerConfig

    model = PipelinedLM(TransformerConfig(dtype=dtype, **_cfg_kw(family)), mesh,
                        microbatches=MB, activation=_activation(family))
    model.load_state_dict(state, strict=True)
    return model


def worker(out_dir):
    from tf_operator_tpu_torch.gpt_pipeline import _Loop
    from tf_operator_tpu_torch.models.weights import pipelined_state_from_flax
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.parallel.mesh import make_mesh
    from tf_operator_tpu_torch.parallel.pipeline import pipeline_apply
    from tf_operator_tpu_torch.parallel.trainer import Optimizer, TrainerConfig
    from tf_operator_tpu_torch.runtime.bootstrap import initialize, world

    initialize("cpu")
    rank, n = world()
    shape = {"pp": 2} if n == 2 else {"pp": 2, "dp": 2}
    mesh = make_mesh(shape)
    stage = mesh.index(("pp",), rank)
    dp_index = mesh.index(("dp",), rank) if n == 4 else 0
    dp = shape.get("dp", 1)
    rec = {"rank": rank, "stage": stage, "dp_index": dp_index}
    got = {}

    # the toy stage
    p = {k: torch.tensor(v, requires_grad=True) for k, v in _toy_stages(2)[stage].items()}
    rows = TOY_ROWS // dp
    x = torch.tensor(_toy_x()[dp_index * rows:(dp_index + 1) * rows], requires_grad=True)
    y = pipeline_apply(_port_stage_fn, p, x, mesh, microbatches=TOY_MB,
                       batch_axes=("dp", "fsdp") if dp > 1 else None)
    (y ** 2).sum().backward()
    got.update({"toy/y": y.detach().numpy(), "toy/dx": x.grad.numpy(),
                "toy/dw": p["w"].grad.numpy(), "toy/db": p["b"].grad.numpy()})

    trees = dict(np.load(os.path.join(out_dir, "trees.npz")))
    ids = torch.as_tensor(_ids())
    if n == 2:
        for family in FAMILIES:
            tree = {k.split(":", 1)[1]: v for k, v in trees.items()
                    if k.startswith(f"{family}:")}
            model = _port_model(family, pipelined_state_from_flax(tree, stage, 2), mesh)
            before = mesh.stats.snapshot()
            fa.plain_calls.clear()
            logits = model(ids)
            loss = model.loss(ids)
            rec[f"{family}_fwd_calls"] = dict(fa.plain_calls)
            fa.plain_calls.clear()
            loss.backward()
            rec[f"{family}_bwd_calls"] = dict(fa.plain_calls)
            rec[f"{family}_stages"] = {
                k: {"calls": v["calls"] - before.get(k, {}).get("calls", 0),
                    "route": v.get("route")} for k, v in mesh.stats.snapshot().items()}
            rec[f"{family}_loss"] = float(loss.detach())
            rec[f"{family}_stage_bytes"] = model.stage_bytes()
            rec[f"{family}_stage_layers"] = len(model.stages)
            got[f"{family}/logits"] = logits.detach().numpy()
            for name, t in model.named_parameters():
                got[f"{family}/grad/{name}"] = t.grad.numpy()
            bf16 = _port_model(family, pipelined_state_from_flax(tree, stage, 2), mesh,
                               torch.bfloat16)
            with torch.no_grad():
                got[f"{family}/logits_bf16"] = bf16(ids).numpy()
    else:
        tree = {k.split(":", 1)[1]: v for k, v in trees.items() if k.startswith("gpt:")}
        model = _port_model("gpt", pipelined_state_from_flax(tree, stage, 2), mesh)
        params = list(model.parameters())
        loop = _Loop(model, Optimizer(TrainerConfig(learning_rate=ADAM_LR, weight_decay=1e-4,
                                                    grad_clip=0.0),
                                      params, decay=[True] * len(params)))
        local = ids[dp_index * (ROWS // dp):(dp_index + 1) * (ROWS // dp)]
        rec["adamw_losses"] = [float(loop.train_step(local)["loss"])
                               for _ in range(ADAM_STEPS)]
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **got)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


# -- the JAX side -------------------------------------------------------------

def _jax():
    import jax

    return jax


def _jax_mesh(shape):
    jax = _jax()
    from tf_operator_tpu.parallel import make_mesh

    n = int(np.prod(list(shape.values())))
    return make_mesh(shape, devices=jax.devices()[:n])


def _jax_toy(shape):
    """The reference's pipeline on the toy stages: y and the gradients
    of (y ** 2).sum() by stage and for x."""

    jax = _jax()
    import jax.numpy as jnp

    from tf_operator_tpu.parallel import pipeline_apply, stack_stage_params

    mesh = _jax_mesh(shape)
    stacked = stack_stage_params([{k: jnp.asarray(v) for k, v in s.items()}
                                  for s in _toy_stages(2)])
    x = jnp.asarray(_toy_x())
    axes = ("dp", "fsdp") if "dp" in shape else None

    def fn(p, h):
        return h + jax.nn.relu(h @ p["w"] + p["b"])

    def loss(sp, xx):
        y = pipeline_apply(fn, sp, xx, mesh, microbatches=TOY_MB, batch_axes=axes)
        return (y ** 2).sum(), y

    with mesh:
        (_, y), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
            stacked, x)
    return {"y": np.asarray(y), "dx": np.asarray(gx),
            "dw": np.asarray(gp["w"]), "db": np.asarray(gp["b"])}


def _jax_lm(family, shape, dtype="float32"):
    jax = _jax()
    import jax.numpy as jnp

    from tf_operator_tpu.models.pipelined_lm import PipelinedLM as JPL
    from tf_operator_tpu.models.transformer import TransformerConfig as JCfg

    mesh = _jax_mesh(shape)
    cfg = JCfg(dtype=getattr(jnp, dtype), **_cfg_kw(family))
    return JPL(cfg, mesh, microbatches=MB, activation=_activation(family)), mesh


def _unbox(tree):
    import flax

    jax = _jax()
    return jax.tree_util.tree_map(np.asarray, flax.core.meta.unbox(tree))


def _flat(tree):
    import flax

    return flax.traverse_util.flatten_dict(tree, sep="/")


def _jax_side():
    """{family: JAX params (unboxed) and results} at pp 2, and the adamw
    losses at pp 2 x dp 2."""

    jax = _jax()
    import jax.numpy as jnp
    import optax

    from tf_operator_tpu.models.pipelined_lm import lm_reference_apply as j_ref

    ids = jnp.asarray(_ids())
    out = {}
    for family in FAMILIES:
        jm, mesh = _jax_lm(family, {"pp": 2})
        params = jm.init(jax.random.PRNGKey(7 if family == "gpt" else 8))
        with mesh:
            logits = np.asarray(jax.jit(jm.apply)(params, ids))
            loss, grads = jax.jit(jax.value_and_grad(jm.loss))(params, ids)
        jb, bmesh = _jax_lm(family, {"pp": 2}, "bfloat16")
        with bmesh:
            logits_bf16 = np.asarray(jax.jit(jb.apply)(params, ids))
        out[family] = {"params": _unbox(params), "logits": logits, "loss": float(loss),
                       "grads": _unbox(grads), "logits_bf16": logits_bf16,
                       "reference": np.asarray(j_ref(jm, params, ids))}
    jm, mesh = _jax_lm("gpt", {"pp": 2, "dp": 2})
    params = jm.shard_params(jax.tree_util.tree_map(jnp.asarray, out["gpt"]["params"]))
    tx = optax.adamw(ADAM_LR)
    with mesh:
        opt = jax.jit(tx.init)(params)

    @jax.jit
    def step(p, o, b):
        loss, grads = jax.value_and_grad(jm.loss)(p, b)
        updates, o = tx.update(grads, o, p)
        return optax.apply_updates(p, updates), o, loss

    losses = []
    with mesh:
        for _ in range(ADAM_STEPS):
            params, opt, loss = step(params, opt, ids)
            losses.append(float(loss))
    out["adamw_losses"] = losses
    return out


def _job_argv(pp, *extra):
    return [sys.executable, "-m", "tf_operator_tpu_torch.gpt_pipeline", "--device", "cpu",
            "--pp", str(pp), "--steps", str(JOB_STEPS), "--steps-per-sync", "1",
            "--batch-per-device", str(JOB_ROWS), *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = {n: tmp_path_factory.mktemp(f"pp{n}") for n in (2, 4)}
    jax_side = _jax_side()
    trees = {f"{family}:{k}": v for family in FAMILIES
             for k, v in _flat(jax_side[family]["params"]).items()}
    for d in tmp.values():
        np.savez(d / "trees.npz", **trees)
    # one world at a time (at most 4 processes beside this one: the suite
    # runs other files' worlds meanwhile); the JAX toy runs during the first
    argv = [sys.executable, "-m", "tests.test_torch_pipeline"]
    first = World(2, argv + [str(tmp[2])], timeout=180)
    toys = {2: _jax_toy({"pp": 2}), 4: _jax_toy({"pp": 2, "dp": 2})}
    outs = {2: first.wait()}
    outs[4] = World(4, argv + [str(tmp[4])], timeout=180).wait()
    job = World(2, _job_argv(2), timeout=180)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    one = subprocess.run(_job_argv(1), cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=180)
    ranks = {n: [json.loads((tmp[n] / f"rank{i}.json").read_text()) for i in range(n)]
             for n in (2, 4)}
    arrays = {n: [dict(np.load(tmp[n] / f"rank{i}.npz")) for i in range(n)] for n in (2, 4)}
    return {"jax": jax_side, "toys": toys, "outs": outs, "ranks": ranks, "arrays": arrays,
            "job": job.wait(), "one": one}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# -- the schedule ---------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_pipeline_apply_matches_the_jax_schedule(runs, n):
    want = runs["toys"][n]
    dp = 1 if n == 2 else 2
    rows = TOY_ROWS // dp
    for rec, got in zip(runs["ranks"][n], runs["arrays"][n]):
        s, d = rec["stage"], rec["dp_index"]
        mine = slice(d * rows, (d + 1) * rows)
        assert _rel(got["toy/y"], want["y"][mine]) <= 1e-5
        assert _rel(got["toy/dx"], want["dx"][mine]) <= 1e-5
        # the stage's gradient over this rank's rows; over dp the sum is
        # the global one
        dw = sum(a["toy/dw"] for r, a in zip(runs["ranks"][n], runs["arrays"][n])
                 if r["stage"] == s)
        db = sum(a["toy/db"] for r, a in zip(runs["ranks"][n], runs["arrays"][n])
                 if r["stage"] == s)
        assert _rel(dw, want["dw"][s]) <= 1e-5
        assert _rel(db, want["db"][s]) <= 1e-5


@pytest.mark.parametrize("family", FAMILIES)
def test_pipelined_lm_matches_the_jax_forward_and_gradients(runs, family):
    from tf_operator_tpu_torch.models.weights import pipelined_state_from_flax

    want = runs["jax"][family]
    ranks, arrays = runs["ranks"][2], runs["arrays"][2]
    grads = {s: pipelined_state_from_flax(want["grads"], s, 2) for s in (0, 1)}
    floor = 1e-6 * max(float(g.abs().max()) for g in grads[0].values())
    for rec, got in zip(ranks, arrays):
        assert _rel(got[f"{family}/logits"], want["logits"]) <= 1e-5
        assert _rel(got[f"{family}/logits_bf16"], want["logits_bf16"]) <= 2e-2
        np.testing.assert_allclose(rec[f"{family}_loss"], want["loss"], rtol=1e-6)
        mine = grads[rec["stage"]]
        names = {k[len(f"{family}/grad/"):] for k in got if k.startswith(f"{family}/grad/")}
        assert names == set(mine)
        for name, g in mine.items():
            err = np.abs(got[f"{family}/grad/{name}"] - g.numpy()).max()
            assert err <= 1e-4 * float(g.abs().max()) + floor, (rec["rank"], name)
    # both ranks return the same output and loss
    np.testing.assert_array_equal(arrays[0][f"{family}/logits"], arrays[1][f"{family}/logits"])
    assert ranks[0][f"{family}_loss"] == ranks[1][f"{family}_loss"]


def test_each_rank_runs_its_stage_once_a_microbatch(runs):
    for family in FAMILIES:
        for rec in runs["ranks"][2]:
            # 2 layers a stage x 2 microbatches; no bubble tick runs.  The
            # worker made two forwards (the logits, then the loss)
            want = LAYERS // 2 * MB
            assert rec[f"{family}_fwd_calls"] == {"flash_attention_fwd": 2 * want}
            assert rec[f"{family}_bwd_calls"] == {"flash_attention_bwd_dq": want,
                                                  "flash_attention_bwd_dkv": want}
            assert rec[f"{family}_stage_layers"] == LAYERS // 2
    one = _one_stage(runs, "gpt")
    for rec in runs["ranks"][2]:
        assert rec["gpt_stage_bytes"] * 2 == one.stage_bytes()


@pytest.mark.parametrize("family", FAMILIES)
def test_the_stages_collectives_are_counted(runs, family):
    # a forward makes M + S - 2 ppermutes and shares its output once, a
    # backward M + S - 2 more and shares the input's gradient once; two
    # forwards (logits, loss) and one backward
    want = {"pp_ppermute": 3 * (MB + 2 - 2), "pp_share_broadcast": 2,
            "pp_input_grad_broadcast": 1}
    for rec in runs["ranks"][2]:
        stages = rec[f"{family}_stages"]
        assert {k: v["calls"] for k, v in stages.items() if v["calls"]} == want
        # gloo on CPU tensors: the ppermute on the tensors' device
        assert stages["pp_ppermute"]["route"] == "device"


def test_pp_dp_adamw_steps_match_the_jax_step(runs):
    want = runs["jax"]["adamw_losses"]
    losses = [r["adamw_losses"] for r in runs["ranks"][4]]
    assert all(x == losses[0] for x in losses)
    np.testing.assert_allclose(losses[0], want, rtol=1e-5)
    assert losses[0][-1] < losses[0][0]


# -- one process --------------------------------------------------------------

def _one_stage(runs, family):
    """The port's model at pp 1 (one process, every layer) on the JAX
    params."""

    from tf_operator_tpu_torch.models.weights import pipelined_state_from_flax

    params = runs["jax"][family]["params"]
    return _port_model(family, pipelined_state_from_flax(params, 0, 1), None)


@pytest.mark.parametrize("family", FAMILIES)
def test_one_stage_matches_the_sequential_oracles(runs, family):
    from tf_operator_tpu_torch.models.pipelined_lm import lm_reference_apply

    model = _one_stage(runs, family)
    ids = torch.as_tensor(_ids())
    with torch.no_grad():
        got = model(ids).numpy()
        ref = lm_reference_apply(model, ids).numpy()
    assert _rel(got, ref) <= 1e-6
    assert _rel(ref, runs["jax"][family]["reference"]) <= 1e-5
    assert _rel(got, runs["jax"][family]["logits"]) <= 1e-5


def test_stack_and_pipelined_match_the_reference_helpers():
    jax = _jax()
    import jax.numpy as jnp

    from tf_operator_tpu.parallel import stack_stage_params as j_stack

    from tf_operator_tpu_torch.parallel.pipeline import (
        pipeline_apply,
        pipelined,
        stack_stage_params,
    )

    stages = _toy_stages(3)
    got = stack_stage_params([{k: torch.tensor(v) for k, v in s.items()} for s in stages])
    want = j_stack([{k: jnp.asarray(v) for k, v in s.items()} for s in stages])
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # one stage (no mesh): the partial application is pipeline_apply
    p = {k: torch.tensor(v) for k, v in stages[0].items()}
    x = torch.tensor(_toy_x())
    fn = pipelined(_port_stage_fn, None, TOY_MB)
    np.testing.assert_array_equal(fn(p, x).numpy(),
                                  pipeline_apply(_port_stage_fn, p, x, None,
                                                 microbatches=TOY_MB).numpy())
    np.testing.assert_allclose(fn(p, x).numpy(), _port_stage_fn(p, x).numpy(), rtol=1e-6)
    del jax


# -- the errors -----------------------------------------------------------------

def test_the_reference_errors():
    jax = _jax()
    import jax.numpy as jnp

    from tf_operator_tpu.parallel import pipeline_apply as j_pipeline_apply
    from tf_operator_tpu.parallel import stack_stage_params as j_stack

    from tf_operator_tpu_torch.models.pipelined_lm import PipelinedLM, lm_reference_apply
    from tf_operator_tpu_torch.models.transformer import TransformerConfig
    from tf_operator_tpu_torch.parallel.mesh import make_mesh
    from tf_operator_tpu_torch.parallel.pipeline import pipeline_apply

    kw = dict(_cfg_kw("gpt"), n_layers=3)
    with pytest.raises(ValueError, match="n_layers 3 not divisible by pp 2"):
        PipelinedLM(TransformerConfig(**kw), make_mesh({"pp": 2}, world=2))
    stages = [{k: torch.tensor(v) for k, v in s.items()} for s in _toy_stages(4)]
    jstages = j_stack([{k: jnp.asarray(v) for k, v in s.items()} for s in _toy_stages(4)])
    toy = lambda p, h: h  # noqa: E731
    for shape, rows, local, m, axes in (({"pp": 4, "dp": 2}, 10, 10, 3, None),
                                        ({"pp": 2, "dp": 4}, 8, 2, 4, ("dp", "fsdp"))):
        n = int(np.prod(list(shape.values())))
        with pytest.raises(ValueError) as want:
            j_pipeline_apply(toy, jstages, jnp.zeros((rows, D)), _jax_mesh(shape),
                             microbatches=m, batch_axes=axes)
        with pytest.raises(ValueError) as got:
            pipeline_apply(toy, stages[0], torch.zeros(local, D), make_mesh(shape, world=n),
                           microbatches=m, batch_axes=axes)
        assert str(got.value) == str(want.value)
    # the sequential oracle needs every layer
    model = PipelinedLM(TransformerConfig(**_cfg_kw("gpt")), make_mesh({"pp": 2}, world=2))
    with pytest.raises(ValueError, match="sequential oracle"):
        lm_reference_apply(model, torch.zeros(1, 4, dtype=torch.long))
    # the trainer goes on refusing pp; other model axes beside pp are refused
    from tf_operator_tpu_torch.parallel.sharding import check_mesh

    with pytest.raises(NotImplementedError, match="pipelined_lm.PipelinedLM"):
        check_mesh(make_mesh({"pp": 2}, world=2))
    with pytest.raises(NotImplementedError, match="tp=2"):
        PipelinedLM(TransformerConfig(**_cfg_kw("gpt")), make_mesh({"pp": 2, "tp": 2}, world=4))


# -- the entry ------------------------------------------------------------------

def _loss_lines(out):
    return [ln for ln in out.splitlines() if "[gpt pp=" in ln]


def test_gpt_pipeline_job_prints_the_reference_tag_and_equal_losses(runs):
    outs = runs["job"]
    lines = [_loss_lines(o) for o in outs]
    for r, got in enumerate(lines):
        assert len(got) == 1 and got[0].startswith(f"process {r}/2 [gpt pp=2 dp=1 mb=4]: "
                                                   f"steps 0..{JOB_STEPS} loss ")
    first, last = (float(v) for v in lines[0][0].split("loss ")[1].split(" -> "))
    assert last < first
    assert lines[0][0].split("]:")[1] == lines[1][0].split("]:")[1]
    one = runs["one"]
    assert one.returncode == 0, one.stdout + one.stderr
    o_first, o_last = (float(v) for v in _loss_lines(one.stdout)[0]
                       .split("loss ")[1].split(" -> "))
    np.testing.assert_allclose([first, last], [o_first, o_last], rtol=2e-2)


def test_gpt_pipeline_exits_2_where_pp_does_not_divide_the_processes():
    env = {k: v for k, v in os.environ.items() if not k.startswith("TPUJOB_")}
    proc = subprocess.run(_job_argv(2), cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 2
    assert "1 devices not divisible by pp=2" in proc.stderr


if __name__ == "__main__":
    worker(sys.argv[1])
