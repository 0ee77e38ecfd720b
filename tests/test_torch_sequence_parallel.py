"""Sequence parallelism of the port (ops/ring_attention.py,
ops/ulysses_attention.py, the sp-aware loss, trainer and data) in real
gloo worlds on the CPU, against the JAX package and the port's one
process.

Two worlds run at once, each rank a process of this file (``python -m
tests.test_torch_sequence_parallel WORKER DIR``, ``tests/torch_world.py``):
2 ranks (sp 2) and 4 ranks (sp 4 for attention, {"sp": 2, "fsdp": 2}
for training).  Meanwhile the test process computes the JAX side on its
virtual CPU devices (``use_flash=False``: the XLA schedules).

- attention: ``ring_attention`` (the plain ring, and the flash ring's
  autograd through the kernels' plain versions) and ``ulysses_attention``
  on each rank's chunk, against the JAX functions on a ``{"sp": n, "dp":
  -1}`` mesh from the same float32 numpy inputs: the forward and the
  grads of q, k and v, reassembled along the sequence, within atol 2e-5.
  Causal and not, GQA (whose KV heads split over sp 2 and not over sp
  4), and a window whose hops include boundary blocks; the refusals (a
  sequence that does not divide, heads that do not split);
- ``llama_tiny`` (float32) trained 6 steps over {"sp": 2} and {"sp": 2,
  "fsdp": 2} with each schedule, from the JAX trainer's weights:
  against the port's one process on the global batch (loss, grad norm
  and token accuracy within 1e-5 relative, each weight within 1e-5
  relative in the L2 norm, ``tests/test_torch_multiprocess.py``'s) and
  against the JAX ``Trainer`` on the same mesh (loss rtol 1e-5, grad
  norm rtol 1e-4, each tensor's update within 1e-3 of the JAX update's
  norm);
- the loss: the ranks' shares of ``llama_loss`` and ``llama_loss_chunked``
  sum to the one process's loss on the global batch;
- the data: the rows and chunks the ranks train on, reassembled, are
  the one process's global batch for the same seed; ``llama_pretrain
  --sp 2 --sp-impl ring|ulysses`` as a 2-rank job (bf16) against the
  one process's losses.
"""

import functools
import json
import os
import sys

import numpy as np
import pytest
import torch
from torch_world import World

torch.set_num_threads(2)

VOCAB, SEQ, BATCH, STEPS = 256, 32, 4, 6
#: attention inputs: [B, H, S, D], KV heads by case
B, H, S, D = 2, 4, 32, 16
#: the window of the windowed ring: boundary hops at sp 2 and sp 4
WINDOW = 20
#: name -> (schedule, causal, kv heads, window, use_flash)
ATTN_CASES = {
    "ring_causal_gqa": ("ring", True, 2, None, None),
    "ring_full": ("ring", False, 4, None, None),
    "ring_window_gqa": ("ring", True, 2, WINDOW, None),
    "flash_ring_causal_gqa": ("ring", True, 2, None, True),
    "flash_ring_full": ("ring", False, 4, None, True),
    "flash_ring_window_gqa": ("ring", True, 2, WINDOW, True),
    "ulysses_causal_gqa": ("ulysses", True, 2, None, None),
    "ulysses_full": ("ulysses", False, 4, None, None),
    "ulysses_window": ("ulysses", True, 4, WINDOW, None),
}
#: the training meshes of each world
LLAMA_MESHES = {2: {"sp": 2}, 4: {"sp": 2, "fsdp": 2}}
IMPLS = ("ring", "ulysses")
#: llama_pretrain --sp 2 (bf16) against one process: DIST_LOSS_RTOL of
#: chip_smoke.py, the same bf16 rounding of sums split between ranks
PRETRAIN_RTOL = 1e-3


def _pretrain_args(batch_per_device, data_dir, *extra):
    from tf_operator_tpu_torch import llama_pretrain

    return llama_pretrain.parse_args(
        ["--device", "cpu", "--model", "llama-tiny", "--seq-len", str(SEQ), "--batch-per-device",
         str(batch_per_device), "--steps", "3", "--steps-per-sync", "1", "--generate", "0",
         "--data-dir", str(data_dir), *extra])


def _attn_inputs(hkv):
    r = np.random.default_rng(hkv)
    q, k, v = (r.standard_normal(s).astype(np.float32)
               for s in ((B, H, S, D), (B, hkv, S, D), (B, hkv, S, D)))
    g = r.standard_normal((B, H, S, D)).astype(np.float32)
    return q, k, v, g


def _llama_cfg():
    from tf_operator_tpu_torch.parallel.trainer import TrainerConfig

    return TrainerConfig(learning_rate=1e-3, weight_decay=0.1, warmup_steps=2, total_steps=6,
                         grad_clip=0.5, optimizer="adamw")


# -- the worker (each rank) ---------------------------------------------------

def worker(out_dir):
    from tf_operator_tpu_torch import llama_pretrain
    from tf_operator_tpu_torch.data.text import TextBatches, as_lm_batches
    from tf_operator_tpu_torch.models.llama import (
        LlamaLM,
        llama_loss,
        llama_loss_chunked,
        llama_tiny,
    )
    from tf_operator_tpu_torch.models.weights import load_npz
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.ops import ring_attention as ra
    from tf_operator_tpu_torch.ops.ring_attention import ring_attention
    from tf_operator_tpu_torch.ops.ulysses_attention import ulysses_attention
    from tf_operator_tpu_torch.parallel.mesh import make_mesh
    from tf_operator_tpu_torch.parallel.sharding import sequence_chunk
    from tf_operator_tpu_torch.parallel.trainer import Trainer
    from tf_operator_tpu_torch.runtime.bootstrap import initialize, world
    from tf_operator_tpu_torch.runtime.harness import batch_sizes, gather_params

    initialize("cpu")
    rank, n = world()
    rec = {}
    mesh = make_mesh({"sp": n})
    got = {}
    for name, (impl, causal, hkv, window, use_flash) in ATTN_CASES.items():
        fa.plain_calls.clear()
        ra.boundary_blocks.clear()
        q, k, v, g = (torch.tensor(sequence_chunk(a, mesh, rank, dim=2))
                      for a in _attn_inputs(hkv))
        q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
        fn = ring_attention if impl == "ring" else ulysses_attention
        out = fn(q, k, v, mesh, causal=causal, window=window, use_flash=use_flash)
        (out * g).sum().backward()
        for field, t in (("out", out), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
            got[f"{name}/{field}"] = t.detach().numpy()
        rec[name] = {"plain_calls": dict(fa.plain_calls),
                     "boundary_blocks": dict(ra.boundary_blocks)}
    np.savez(os.path.join(out_dir, f"attn{rank}.npz"), **got)
    rec["attn_stages"] = mesh.stats.snapshot()

    batches = np.load(os.path.join(out_dir, "batches.npy"))
    for impl in IMPLS:
        lmesh = make_mesh(LLAMA_MESHES[n])
        cfg = llama_tiny(vocab_size=VOCAB, max_len=SEQ, dtype=torch.float32, mesh=lmesh,
                         sp_impl=impl)
        model = LlamaLM.from_state_dict(cfg, load_npz(os.path.join(out_dir, "init.npz")),
                                        "cpu", trainable=True)
        trainer = Trainer(model, _llama_cfg(), llama_loss, mesh=lmesh, shardings="logical")
        local = BATCH // trainer.batch_ranks
        rows = slice(trainer.batch_index * local, (trainer.batch_index + 1) * local)
        metrics = [trainer.train_step(trainer.shard_batch({"input_ids": b[rows]}))
                   for b in batches]
        rec[impl] = {k: [float(m[k]) for m in metrics]
                     for k in ("loss", "grad_norm", "token_accuracy")}
        rec[impl]["stages"] = trainer.collective_stats.snapshot()
        params = gather_params(trainer)
        if rank == 0:
            np.savez(os.path.join(out_dir, f"llama_{impl}.npz"),
                     **{k: v.numpy() for k, v in params.items()})

    # both losses' shares at the initial weights, summed over the world
    model = LlamaLM.from_state_dict(cfg, load_npz(os.path.join(out_dir, "init.npz")), "cpu",
                                    trainable=True)
    ids = trainer.shard_batch({"input_ids": batches[0][rows]})
    shares = []
    for fn in (llama_loss, functools.partial(llama_loss_chunked, n_chunks=3)):
        loss, m = fn(model, ids)
        shares.append(torch.stack([loss.detach(), m["token_accuracy"]]))
    shares = torch.stack(shares)
    torch.distributed.all_reduce(shares)
    rec["loss_shares"] = (shares / trainer.batch_ranks).tolist()

    # the data: llama_pretrain's rows and chunks of the global batch
    data_dir = os.path.join(out_dir, "text")
    global_batch, rows = batch_sizes(2, lmesh)
    shard = (trainer.batch_index, trainer.batch_ranks)
    first = next(iter(as_lm_batches(TextBatches(data_dir, global_batch, shard=shard))))
    rec["data"] = {"global_batch": global_batch, "rows": rows,
                   "batch_index": trainer.batch_index,
                   "sp_index": lmesh.index(("sp",), rank),
                   "chunk": trainer.shard_batch(first)["input_ids"].tolist()}
    if n == 2:
        for impl in IMPLS:
            out = llama_pretrain.run(_pretrain_args(2, data_dir, "--sp", "2", "--sp-impl", impl))
            rec[f"pretrain_{impl}"] = out["losses"]
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


# -- the fixture: both worlds and the JAX side --------------------------------

def _jax_attention(n):
    """{case/field: array} of the JAX schedules on an sp-n mesh."""

    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.ops.ring_attention import ring_attention
    from tf_operator_tpu.ops.ulysses_attention import ulysses_attention
    from tf_operator_tpu.parallel import make_mesh

    mesh = make_mesh({"sp": n, "dp": -1}, devices=jax.devices()[:n])
    out = {}
    for name, (impl, causal, hkv, window, _) in ATTN_CASES.items():
        fn = ring_attention if impl == "ring" else ulysses_attention
        q, k, v, g = (jnp.asarray(a) for a in _attn_inputs(hkv))

        @jax.jit
        def fwd_bwd(q, k, v, g):
            o, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, mesh, causal=causal, window=window,
                                                use_flash=False), q, k, v)
            return (o, *vjp(g))

        for field, t in zip(("out", "dq", "dk", "dv"), fwd_bwd(q, k, v, g)):
            out[f"{name}/{field}"] = np.asarray(t)
    return out


def _jax_trainers(tmp, batches):
    """The JAX trainers of every (world, schedule), all from one seed;
    the initial weights written for the workers."""

    import flax
    import jax

    from tf_operator_tpu.models import llama_loss as j_llama_loss
    from tf_operator_tpu.models import llama_tiny as j_llama_tiny
    from tf_operator_tpu.parallel import Trainer as JTrainer
    from tf_operator_tpu.parallel import TrainerConfig as JTrainerConfig
    from tf_operator_tpu.parallel import make_mesh as j_make_mesh

    from tf_operator_tpu_torch.models.weights import from_flax_params

    cfg = _llama_cfg()
    jcfg = JTrainerConfig(**{f: getattr(cfg, f) for f in (
        "learning_rate", "weight_decay", "warmup_steps", "total_steps", "grad_clip",
        "optimizer", "accum_steps")})
    first = {"input_ids": batches[0]}
    unbox = lambda t: jax.tree_util.tree_map(np.asarray, flax.core.meta.unbox(t))  # noqa: E731
    trainers = {}
    for n, shape in LLAMA_MESHES.items():
        jmesh = j_make_mesh(shape, devices=jax.devices()[:n])
        for impl in IMPLS:
            model = j_llama_tiny(vocab_size=VOCAB, max_len=SEQ, mesh=jmesh,
                                 dtype=jax.numpy.float32, sp_impl=impl)
            trainers[n, impl] = JTrainer(model, jcfg, jmesh, j_llama_loss, first,
                                         init_args=(first["input_ids"],), shardings="logical")
    inits = [from_flax_params(unbox(t.state.params)) for t in trainers.values()]
    return trainers, inits, unbox


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from tf_operator_tpu_torch import llama_pretrain
    from tf_operator_tpu_torch.data.text import ensure_text
    from tf_operator_tpu_torch.models.llama import LlamaLM, llama_loss, llama_tiny
    from tf_operator_tpu_torch.models.weights import from_flax_params, save_npz
    from tf_operator_tpu_torch.parallel.trainer import Trainer

    tmp = {n: tmp_path_factory.mktemp(f"sp{n}") for n in LLAMA_MESHES}
    r = np.random.default_rng(13)
    batches = r.integers(0, VOCAB, (STEPS, BATCH, SEQ)).astype(np.int32)
    trainers, inits, unbox = _jax_trainers(tmp, batches)
    initial = inits[0]
    for d in tmp.values():
        np.save(d / "batches.npy", batches)
        save_npz(initial, str(d / "init.npz"))
        ensure_text(str(d / "text"), seq_len=SEQ)
    worlds = {n: World(n, [sys.executable, "-m", "tests.test_torch_sequence_parallel",
                           str(tmp[n])], timeout=300) for n in LLAMA_MESHES}
    # the JAX side and the one process while the worlds run
    jax_attn = {n: _jax_attention(n) for n in LLAMA_MESHES}
    jax_runs = {}
    for key, jt in trainers.items():
        jm = [jt.train_step(jt.shard_batch({"input_ids": b})) for b in batches]
        jax_runs[key] = {"metrics": {k: [float(m[k]) for m in jm]
                                     for k in ("loss", "grad_norm", "token_accuracy")},
                         "params": from_flax_params(unbox(jt.state.params))}
    one_model = LlamaLM.from_state_dict(
        llama_tiny(vocab_size=VOCAB, max_len=SEQ, dtype=torch.float32), initial, "cpu",
        trainable=True)
    with torch.no_grad():
        loss, m = llama_loss(one_model, {"input_ids": torch.tensor(batches[0])})
    one_loss = [float(loss), float(m["token_accuracy"])]
    one = Trainer(one_model, _llama_cfg(), llama_loss)
    om = [one.train_step({"input_ids": b}) for b in batches]
    pretrain_one = llama_pretrain.run(_pretrain_args(4, tmp[2] / "text"))
    outs = {n: w.wait() for n, w in worlds.items()}
    ranks = {n: [json.loads((tmp[n] / f"rank{i}.json").read_text()) for i in range(n)]
             for n in LLAMA_MESHES}
    return {"tmp": tmp, "outs": outs, "ranks": ranks, "batches": batches,
            "initial": initial, "inits": inits, "jax_attn": jax_attn, "jax": jax_runs,
            "one": {k: [float(m[k]) for m in om] for k in ("loss", "grad_norm",
                                                            "token_accuracy")},
            "one_params": {n: p.detach().numpy() for n, p in one.model.named_parameters()},
            "pretrain_one": pretrain_one["losses"], "one_loss": one_loss}


def _gathered(runs, n, key):
    """The ranks' chunks of ``key`` concatenated along the sequence (at
    sp n over n ranks, rank r holds chunk r)."""

    parts = [np.load(runs["tmp"][n] / f"attn{r}.npz")[key] for r in range(n)]
    return np.concatenate(parts, axis=2)


# -- attention ----------------------------------------------------------------

@pytest.mark.parametrize("n", sorted(LLAMA_MESHES))
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_sp_attention_matches_the_jax_schedule(runs, case, n):
    want = runs["jax_attn"][n]
    for field in ("out", "dq", "dk", "dv"):
        key = f"{case}/{field}"
        np.testing.assert_allclose(_gathered(runs, n, key), want[key], atol=2e-5, rtol=0,
                                   err_msg=key)
    impl, causal, hkv, window, use_flash = ATTN_CASES[case]
    for rec in runs["ranks"][n]:
        calls = rec[case]
        if impl == "ring" and use_flash:
            # the flash ring: the flash functions' plain versions, no plain ring
            assert "ring_attention_plain" not in calls["plain_calls"]
            assert calls["plain_calls"]["flash_attention_fwd"] >= 1
        elif impl == "ring":
            assert calls["plain_calls"] == {"ring_attention_plain": 1}
        else:
            assert calls["plain_calls"] == {"ulysses_attention_plain": 1}
    if window is not None and impl == "ring" and use_flash:
        # the band's edge crosses a hop of the last rank: one boundary
        # block forward, one backward
        blocks = runs["ranks"][n][n - 1][case]["boundary_blocks"]
        assert blocks["window_block_fwd"] == blocks["window_block_bwd"] >= 1, blocks


def test_flash_ring_plain_route_matches_the_plain_ring(runs):
    for n in LLAMA_MESHES:
        for case in ("causal_gqa", "full", "window_gqa"):
            for field in ("out", "dq", "dk", "dv"):
                np.testing.assert_allclose(_gathered(runs, n, f"flash_ring_{case}/{field}"),
                                           _gathered(runs, n, f"ring_{case}/{field}"),
                                           atol=2e-5, rtol=0)


def test_sp_collectives_are_counted_by_stage(runs):
    for n in LLAMA_MESHES:
        stages = runs["ranks"][n][0]["attn_stages"]
        assert set(stages) == {"ring_ppermute", "ulysses_all_to_all"}
        # gloo on CPU tensors: both on the tensors' device
        assert {s["route"] for s in stages.values()} == {"device"}
        # Ulysses: 4 all-to-alls forward and 4 backward a call
        uly = sum(1 for c in ATTN_CASES.values() if c[0] == "ulysses")
        assert stages["ulysses_all_to_all"]["calls"] == 8 * uly
        # the ring: K and V make n - 1 hops forward; backward, the plain
        # ring sends dK and dV home (n - 1 hops each) and the flash ring
        # moves K, V, dK, dV n - 1 hops and dK, dV one more
        plain = sum(1 for c in ATTN_CASES.values() if c[0] == "ring" and not c[4])
        flash = sum(1 for c in ATTN_CASES.values() if c[0] == "ring" and c[4])
        want = plain * 4 * (n - 1) + flash * (6 * (n - 1) + 2)
        assert stages["ring_ppermute"]["calls"] == want


def test_sp_collective_routes_are_fixed_per_backend(monkeypatch):
    """What ``ppermute`` and ``all_to_all`` call, recorded with a fake
    group of 4: one ``batch_isend_irecv`` of a send to the next rank and
    a receive from the one before (shift 1), one ``all_to_all_single`` of
    the parts stacked; the route read from ``host_staged`` before the
    call (gloo's ppermute of a CUDA tensor through the host, everything
    else on the tensors' device) and recorded beside the stage."""

    import torch.distributed as dist

    from tf_operator_tpu_torch.parallel import collectives as c

    assert c.host_staged("ppermute", "gloo", "cuda")
    for kind, backend, dev in (("ppermute", "gloo", "cpu"), ("ppermute", "nccl", "cuda"),
                               ("all_to_all", "gloo", "cpu"), ("all_to_all", "gloo", "cuda"),
                               ("all_to_all", "nccl", "cuda")):
        assert not c.host_staged(kind, backend, dev), (kind, backend, dev)
    calls = []

    class P2POp:
        def __init__(self, op, t, peer, group):
            calls.append((op.__name__, peer, group, t.device.type))
            self.op, self.t = op, t

    class Done:
        def wait(self):
            pass

    def batch_isend_irecv(ops):
        ops[1].t.copy_(ops[0].t + 1)
        return [Done(), Done()]

    def all_to_all_single(out, inp, group=None):
        calls.append(("all_to_all_single", tuple(inp.shape), group))
        out.copy_(inp)

    for name, fn in (("P2POp", P2POp), ("batch_isend_irecv", batch_isend_irecv),
                     ("all_to_all_single", all_to_all_single),
                     ("get_process_group_ranks", lambda g: [4, 5, 6, 7]),
                     ("get_rank", lambda: 5), ("get_world_size", lambda g: 4),
                     ("get_backend", lambda g: "gloo")):
        monkeypatch.setattr(dist, name, fn)
    stats = c.CollectiveStats()
    x = torch.arange(8.0).reshape(2, 4)
    torch.testing.assert_close(c.ppermute(x, "sp", stats, "ring"), x + 1)
    assert calls == [("isend", 6, "sp", "cpu"), ("irecv", 4, "sp", "cpu")]
    calls.clear()
    # the host transport: the call sees CPU copies, the caller its device
    monkeypatch.setattr(c, "host_staged", lambda kind, backend, dev: True)
    torch.testing.assert_close(c.ppermute(x, "sp", stats, "ring", shift=-1), x + 1)
    assert calls == [("isend", 4, "sp", "cpu"), ("irecv", 6, "sp", "cpu")]
    calls.clear()
    got = c.all_to_all(x, "sp", stats, "a2a", split_dim=1, concat_dim=0)
    assert calls == [("all_to_all_single", (4, 2, 1), "sp")]
    torch.testing.assert_close(got, x.reshape(2, 4, 1).movedim(1, 0).reshape(8, 1))
    assert stats.snapshot() == {
        "ring": {"calls": 2, "bytes": 64, "seconds": stats.by_stage["ring"]["seconds"],
                 "route": "host"},
        "a2a": {"calls": 1, "bytes": 32, "seconds": stats.by_stage["a2a"]["seconds"],
                "route": "host"}}


def test_sp_attention_refusals_match_the_jax_ones():
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.ops.ring_attention import ring_attention as j_ring
    from tf_operator_tpu.ops.ulysses_attention import ulysses_attention as j_ulysses
    from tf_operator_tpu.parallel import make_mesh as j_make_mesh

    from tf_operator_tpu_torch.ops.ulysses_attention import ulysses_attention
    from tf_operator_tpu_torch.parallel.mesh import make_mesh
    from tf_operator_tpu_torch.parallel.sharding import sequence_chunk

    jmesh = j_make_mesh({"sp": 4, "dp": -1}, devices=jax.devices()[:4])
    mesh = make_mesh({"sp": 4}, world=4)
    # a sequence that does not divide over sp 4
    x = np.zeros((1, 2, 30, 8), np.float32)
    with pytest.raises(ValueError, match="does not divide over 4 'sp' shards"):
        sequence_chunk(x, mesh, 0, dim=2)
    with pytest.raises(ValueError):
        j_ring(*(jnp.asarray(x),) * 3, jmesh, causal=True, use_flash=False)
    # 2 heads do not split over sp 4
    q = np.zeros((1, 2, 32, 8), np.float32)
    with pytest.raises(ValueError) as jerr:
        j_ulysses(*(jnp.asarray(q),) * 3, jmesh, causal=True, use_flash=False)
    with pytest.raises(ValueError) as perr:
        ulysses_attention(*(torch.tensor(q),) * 3, mesh, causal=True)
    assert str(perr.value) == str(jerr.value)


def test_sp_one_is_the_flash_dispatcher():
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.ops.ring_attention import ring_attention
    from tf_operator_tpu_torch.ops.ulysses_attention import ulysses_attention
    from tf_operator_tpu_torch.parallel.mesh import make_mesh

    q, k, v, _ = (torch.tensor(a) for a in _attn_inputs(2))
    want = fa.attention(q, k, v, causal=True)
    mesh = make_mesh({"dp": 1}, world=1)
    for fn in (ring_attention, ulysses_attention):
        torch.testing.assert_close(fn(q, k, v, mesh, causal=True), want, rtol=0, atol=0)


# -- training ------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("n", sorted(LLAMA_MESHES))
def test_llama_sp_matches_the_one_process_run_on_the_global_batch(runs, n, impl):
    ranks, one = runs["ranks"][n], runs["one"]
    for k in ("loss", "grad_norm", "token_accuracy"):
        for rec in ranks[1:]:
            assert rec[impl][k] == ranks[0][impl][k], k
        np.testing.assert_allclose(ranks[0][impl][k], one[k], rtol=1e-5, err_msg=k)
    got = np.load(runs["tmp"][n] / f"llama_{impl}.npz")
    assert set(got.files) == set(runs["one_params"])
    for name, want in runs["one_params"].items():
        err = np.linalg.norm(got[name] - want) / np.linalg.norm(want)
        assert err <= 1e-5, f"{name}: relative error {err:.3g}"
    stages = ranks[0][impl]["stages"]
    sp_stage = "ring_ppermute" if impl == "ring" else "ulysses_all_to_all"
    assert {sp_stage, "loss_halo", "metrics_all_reduce", "flat_all_reduce"} <= set(stages)
    if n == 4:
        # fsdp still reduce-scatters its sharded gradients over fsdp
        assert {"stage1_reduce_scatter", "gather_params"} <= set(stages)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("n", sorted(LLAMA_MESHES))
def test_llama_sp_matches_the_jax_trainer_on_the_same_mesh(runs, n, impl):
    for init in runs["inits"][1:]:
        for name, t in init.items():
            np.testing.assert_array_equal(t.numpy(), runs["initial"][name].numpy())
    got, jx = runs["ranks"][n][0][impl], runs["jax"][n, impl]
    np.testing.assert_allclose(got["loss"], jx["metrics"]["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], jx["metrics"]["grad_norm"], rtol=1e-4)
    np.testing.assert_allclose(got["token_accuracy"], jx["metrics"]["token_accuracy"])
    assert max(jx["metrics"]["grad_norm"]) > _llama_cfg().grad_clip, "the clip never triggered"
    # each tensor's update within 1e-3 of the JAX update's norm
    # (tests/test_torch_multiprocess.py's criterion).  Not element by
    # element at 2e-5: an embedding row that one token of the batch moves
    # takes Adam's normalised step, where float order moves it most, and
    # there the JAX trainer's own weights differ by 1.6e-5 between the
    # {"sp": 2} and the {"sp": 2, "fsdp": 2} mesh and the port's one
    # process is 3.1e-5 from the latter's (its update within 1.4e-4)
    params = np.load(runs["tmp"][n] / f"llama_{impl}.npz")
    for name, t in jx["params"].items():
        want, got = t.numpy(), params[name]
        init = runs["initial"][name].numpy()
        scale = np.linalg.norm(want - init)
        assert np.linalg.norm((got - init) - (want - init)) <= 1e-3 * scale, name


@pytest.mark.parametrize("n", sorted(LLAMA_MESHES))
def test_sp_loss_shares_sum_to_the_one_process_loss(runs, n):
    """The ranks' shares of ``llama_loss`` and ``llama_loss_chunked``
    (the last target of a chunk from the next one, the whole sequence's
    count), summed over sp and averaged over the batch shards, are the
    one process's loss and token accuracy on the global batch."""

    for rec in runs["ranks"][n]:
        for loss, acc in rec["loss_shares"]:
            np.testing.assert_allclose([loss, acc], runs["one_loss"], rtol=1e-5)


# -- the data and the entry point ---------------------------------------------

@pytest.mark.parametrize("n", sorted(LLAMA_MESHES))
def test_sp_ranks_train_on_the_one_process_global_batch(runs, n):
    from tf_operator_tpu_torch.data.text import TextBatches, as_lm_batches

    ranks = runs["ranks"][n]
    global_batch = ranks[0]["data"]["global_batch"]
    assert global_batch == 2 * n
    want = next(iter(as_lm_batches(TextBatches(str(runs["tmp"][n] / "text"), global_batch))))
    want = want["input_ids"]
    shards = max(r["data"]["batch_index"] for r in ranks) + 1
    sp = max(r["data"]["sp_index"] for r in ranks) + 1
    assert shards * sp == n
    got = np.zeros_like(want)
    rows, chunk = global_batch // shards, SEQ // sp
    for r in ranks:
        d = r["data"]
        assert d["rows"] == rows
        got[d["batch_index"] * rows:(d["batch_index"] + 1) * rows,
            d["sp_index"] * chunk:(d["sp_index"] + 1) * chunk] = np.array(d["chunk"])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("impl", IMPLS)
def test_llama_pretrain_sp_job_matches_one_process(runs, impl):
    ranks = runs["ranks"][2]
    assert ranks[0][f"pretrain_{impl}"] == ranks[1][f"pretrain_{impl}"]
    np.testing.assert_allclose(ranks[0][f"pretrain_{impl}"], runs["pretrain_one"],
                               rtol=PRETRAIN_RTOL)
    tag = f"llama-tiny bytes seq=32 batch=2 fsdp=1 sp=2({impl})"
    assert any(f"process 1/2 [{tag}]" in line for line in runs["outs"][2][1].splitlines())


if __name__ == "__main__":
    worker(sys.argv[1])
