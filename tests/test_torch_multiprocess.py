"""Real multi-process worlds of the port on the CPU (gloo), against
the port's one-process runs and the JAX package.

Each world is 2 or 4 processes of this file (``python -m
tests.test_torch_multiprocess WORKER DIR``) with the ``TPUJOB_*``
environment written by ``tests/torch_world.py``, each world on its own
port below the host's ephemeral range; a worker writes what it measured
under DIR and the test compares.  The JAX
side runs in the test process on its virtual CPU devices.

- ``psum_hierarchical`` (2 slices x 2 ranks, all three stages) equals
  the flat all-reduce and the numpy sum: bucketed leaves whole, an
  fsdp-sharded leaf as the rank's shard;
- ``llama_tiny`` (float32) trained 6 steps by 2 ranks over ``{"fsdp":
  2}`` with the logical shardings:
  - against the port's one-process run on the global batch: each loss,
    grad norm and token accuracy within 1e-5 relative, and each final
    weight tensor within 1e-5 relative in the L2 norm (the same float32
    arithmetic, its sums split between ranks);
  - against the JAX ``Trainer`` on a 2-device ``{"fsdp": 2}`` mesh from
    the same bridged weights and batches, at
    ``tests/test_torch_training.py``'s tolerances for one device: loss
    rtol 1e-5, grad norm rtol 1e-4 each step, weights atol 2e-5 and
    each tensor's update within 1e-3 of the JAX update's norm;
  - the export of the sharded trainer (process 0 writes the gathered
    weights) equals the gathered weights;
  - between steps a rank holds half of each sharded weight (its master
    shard) and half of its moments, and in a step at most two sharded
    weights full at once;
- ``dist_mnist``, 2 ranks against one process on the global batch
  (float32: each loss within 1e-5 relative), and its CLI's final line
  (bf16, the reference's);
- ResNet-18 (width 8, float32) with dp 2 against the JAX ``Trainer`` on
  a 2-device dp mesh, two sgd steps: loss rtol 1e-4, parameters and
  running statistics atol 1e-5 (``tests/test_torch_resnet.py``'s), which
  holds only with batch-global BatchNorm statistics; ``resnet_dp
  --fsdp 2`` as a 2-rank job; ``--norm fused`` refused in a world of 2;
- the reference's ``LocalProcessBackend`` and ``TPUJobController`` run
  the port's ``dist_psum`` as a 2-worker job and ``dist_multislice`` as
  a ``TPU_SLICE`` job of 2 slices x 2 hosts (v5e-8): both reach
  Succeeded with the reference's log lines, and the ``MULTISLICE_LEDGER``
  equals the JAX plan's ledger for the same model and mesh.
"""

import json
import os
import sys
import time

import numpy as np
import pytest
import torch
from torch_world import run_world

torch.set_num_threads(2)

VOCAB, SEQ, BATCH, LLAMA_STEPS = 256, 32, 4, 6
MNIST_STEPS, MNIST_BATCH = 6, 8
RESNET_STEPS, RESNET_BATCH = 2, 4


def _workers(n: int, worker: str, tmp, extra=None):
    return run_world(n, [sys.executable, "-m", "tests.test_torch_multiprocess", worker,
                         str(tmp)], extra)


# -- workers (run in the ranks) ----------------------------------------------

PSUM_SHAPES = [(6, 5), (7,), (4, 3), (8, 4)]
#: the last leaf is split over fsdp along dim 0
PSUM_SPECS = [None, None, None, ("fsdp", None)]


def _psum_inputs(rank):
    r = np.random.default_rng(rank)
    return [r.standard_normal(s).astype(np.float32) for s in PSUM_SHAPES]


def worker_psum(out_dir):
    from tf_operator_tpu_torch.parallel import collectives
    from tf_operator_tpu_torch.parallel.mesh import make_mesh
    from tf_operator_tpu_torch.runtime.bootstrap import initialize, world

    ctx = initialize("cpu")
    rank, n = world()
    mesh = make_mesh({"dp": 2, "fsdp": -1})
    xs = [torch.tensor(a) for a in _psum_inputs(rank)]
    hier = collectives.psum_hierarchical([x.clone() for x in xs], mesh, shardings=PSUM_SPECS,
                                         bucket_bytes=64)
    flat = [x.clone() for x in xs]
    for x in flat:
        torch.distributed.all_reduce(x)
    mesh.stats = collectives.CollectiveStats()  # the flat plan's stages alone
    plan = collectives.build_grad_sync_plan([(x.shape, x.dtype) for x in xs], PSUM_SPECS, mesh,
                                            mode="flat")
    flat_plan = plan.apply([x.clone() for x in xs])
    timing = collectives.measure_sync_seconds(mesh, "cpu", nbytes=4096, repeats=2)
    np.savez(os.path.join(out_dir, f"psum{rank}.npz"),
             **{f"hier{i}": t.numpy() for i, t in enumerate(hier)},
             **{f"flat{i}": t.numpy() for i, t in enumerate(flat)},
             **{f"plan{i}": t.contiguous().numpy() for i, t in enumerate(flat_plan)})
    with open(os.path.join(out_dir, f"psum{rank}.json"), "w") as f:
        json.dump({"backend": ctx.backend, "timing": timing,
                   "stages": plan.stats.snapshot()}, f)


def _llama_cfg():
    from tf_operator_tpu_torch.parallel.trainer import TrainerConfig

    return TrainerConfig(learning_rate=1e-3, weight_decay=0.1, warmup_steps=2, total_steps=6,
                         grad_clip=0.5, optimizer="adamw")


def _llama_model(state):
    from tf_operator_tpu_torch.models.llama import LlamaLM, llama_tiny

    cfg = llama_tiny(vocab_size=VOCAB, max_len=SEQ, dtype=torch.float32)
    return LlamaLM.from_state_dict(cfg, state, "cpu", trainable=True)


def worker_llama(out_dir):
    from tf_operator_tpu_torch.models.llama import llama_loss
    from tf_operator_tpu_torch.models.weights import load_npz
    from tf_operator_tpu_torch.parallel.checkpoint import export_params
    from tf_operator_tpu_torch.parallel.mesh import make_mesh
    from tf_operator_tpu_torch.parallel.trainer import Trainer
    from tf_operator_tpu_torch.runtime.bootstrap import initialize, world
    from tf_operator_tpu_torch.runtime.harness import gather_params

    initialize("cpu")
    rank, n = world()
    model = _llama_model(load_npz(os.path.join(out_dir, "init.npz")))
    trainer = Trainer(model, _llama_cfg(), llama_loss, mesh=make_mesh({"sp": 1, "fsdp": n}),
                      shardings="logical")
    batches = np.load(os.path.join(out_dir, "batches.npy"))
    local = BATCH // n
    rows = slice(trainer.batch_index * local, (trainer.batch_index + 1) * local)
    live, gather = [0], trainer._gather

    def counted(indices):
        gather(indices)
        live[0] = max(live[0], len(trainer._live))

    trainer._gather = counted
    metrics = [trainer.train_step(trainer.shard_batch({"input_ids": b[rows]}))
               for b in batches]
    trainer._gather = gather
    rec = {k: [float(m[k]) for m in metrics] for k in ("loss", "grad_norm", "token_accuracy")}
    rec["most_live"], rec["n_sharded"] = live[0], len(trainer._sharded)
    rec["stages"] = trainer.collective_stats.snapshot()
    rec["resident"] = trainer.resident_bytes()
    last = trainer.shard_batch({"input_ids": batches[-1][rows]})
    rec["eval_loss"] = float(trainer.eval_step(last)["loss"])
    rec["resident_after_eval"] = trainer.resident_bytes()
    params = gather_params(trainer)
    export_params(trainer, os.path.join(out_dir, "artifact"))
    if rank == 0:
        np.savez(os.path.join(out_dir, "llama_params.npz"),
                 **{k: v.numpy() for k, v in params.items()})
    with open(os.path.join(out_dir, f"llama{rank}.json"), "w") as f:
        json.dump(rec, f)


def worker_mnist(out_dir):
    from tf_operator_tpu_torch import dist_mnist
    from tf_operator_tpu_torch.runtime.bootstrap import world

    argv = ["--device", "cpu", "--steps", str(MNIST_STEPS), "--batch-size", str(MNIST_BATCH)]
    assert dist_mnist.main(argv) == 0
    losses = dist_mnist.run(dist_mnist.parse_args(argv), dtype=torch.float32)["losses"]
    with open(os.path.join(out_dir, f"mnist{world()[0]}.json"), "w") as f:
        json.dump(losses, f)


def worker_resnet(out_dir):
    from tf_operator_tpu_torch import resnet_dp
    from tf_operator_tpu_torch.models import resnet
    from tf_operator_tpu_torch.parallel.mesh import make_mesh
    from tf_operator_tpu_torch.parallel.trainer import (
        Trainer,
        TrainerConfig,
        batchnorm_cross_entropy_loss,
    )
    from tf_operator_tpu_torch.runtime.bootstrap import initialize, world

    initialize("cpu")
    rank, n = world()
    model = resnet.resnet18(10, width=8, dtype=torch.float32, device="cpu")
    with np.load(os.path.join(out_dir, "resnet_init.npz")) as f:
        model.load_state_dict({k: torch.from_numpy(f[k]) for k in f.files}, strict=True)
    trainer = Trainer(model, TrainerConfig(optimizer="sgd", learning_rate=0.1),
                      batchnorm_cross_entropy_loss, mesh=make_mesh({"dp": n}))
    with np.load(os.path.join(out_dir, "resnet_batch.npz")) as f:
        batch = {k: f[k] for k in f.files}
    metrics = [trainer.train_step(trainer.shard_global_batch(batch))
               for _ in range(RESNET_STEPS)]
    if rank == 0:
        np.savez(os.path.join(out_dir, "resnet_state.npz"),
                 **{k: v.numpy() for k, v in model.state_dict().items()})
        with open(os.path.join(out_dir, "resnet.json"), "w") as f:
            json.dump({k: [float(m[k]) for m in metrics] for k in ("loss", "grad_norm")}, f)
    assert resnet_dp.main(["--device", "cpu", "--model", "resnet18", "--image-size", "16",
                           "--num-classes", "10", "--batch-per-device", "2", "--steps", "2",
                           "--fsdp", "2"]) == 0


def worker_teardown(out_dir):
    import atexit

    import torch.distributed as dist

    from tf_operator_tpu_torch.runtime.bootstrap import initialize, world

    ctx = initialize("cpu")
    rank, _ = world()
    x = torch.ones(4)
    dist.all_reduce(x)
    joined = dist.is_initialized()
    atexit._run_exitfuncs()
    with open(os.path.join(out_dir, f"teardown{rank}.json"), "w") as f:
        json.dump({"backend": ctx.backend, "sum": x.tolist(), "joined": joined,
                   "after_exit_funcs": dist.is_initialized()}, f)


WORKERS = {"psum": worker_psum, "llama": worker_llama, "mnist": worker_mnist,
           "resnet": worker_resnet, "teardown": worker_teardown}


# -- tests -------------------------------------------------------------------

def test_psum_hierarchical_equals_the_flat_all_reduce_and_the_numpy_sum(tmp_path):
    n = 4
    outs = _workers(n, "psum", tmp_path,
                    {r: {"MEGASCALE_NUM_SLICES": "2", "MEGASCALE_SLICE_ID": str(r // 2)}
                     for r in range(n)})
    want = [sum(_psum_inputs(r)[i] for r in range(n)) for i in range(len(PSUM_SHAPES))]
    for r in range(n):
        got = np.load(tmp_path / f"psum{r}.npz")
        for i, w in enumerate(want):
            np.testing.assert_allclose(got[f"flat{i}"], w, rtol=1e-6, atol=1e-6)
            if PSUM_SPECS[i] is None:
                np.testing.assert_allclose(got[f"hier{i}"], got[f"flat{i}"], rtol=1e-6,
                                           atol=1e-6)
                np.testing.assert_allclose(got[f"plan{i}"], w, rtol=1e-6, atol=1e-6)
            else:
                # the fsdp coordinate of rank r is r % 2 (2 ranks a slice)
                shard = np.split(w, 2, axis=0)[r % 2]
                np.testing.assert_allclose(got[f"hier{i}"], shard, rtol=1e-6, atol=1e-6)
                np.testing.assert_allclose(got[f"plan{i}"], shard, rtol=1e-6, atol=1e-6)
        rec = json.loads((tmp_path / f"psum{r}.json").read_text())
        assert rec["backend"] == "gloo"
        assert set(rec["timing"]) == {"dcn_fragment_s", "ici_reshard_s", "flat_full_s",
                                      "probe_bytes", "intra_slice_size"}
        assert rec["timing"]["intra_slice_size"] == 2
        # the flat plan: one all-reduce a bucket, stages 1 and 2 for the sharded leaf
        assert set(rec["stages"]) == {"flat_all_reduce", "stage1_reduce_scatter",
                                      "stage2_all_reduce"}
    assert "process 3/4: joined a gloo world" in outs[3]


@pytest.fixture(scope="module")
def llama_runs(tmp_path_factory):
    """The 2-rank fsdp run, the port's one-process run on the global
    batch and the JAX trainer on a 2-device fsdp mesh, from one set of
    weights and batches."""

    import flax
    import jax

    from tf_operator_tpu.models import llama_loss as j_llama_loss
    from tf_operator_tpu.models import llama_tiny as j_llama_tiny
    from tf_operator_tpu.parallel import Trainer as JTrainer
    from tf_operator_tpu.parallel import TrainerConfig as JTrainerConfig
    from tf_operator_tpu.parallel import make_mesh as j_make_mesh

    from tf_operator_tpu_torch.models.llama import llama_loss
    from tf_operator_tpu_torch.models.weights import from_flax_params, save_npz
    from tf_operator_tpu_torch.parallel.trainer import Trainer

    tmp = tmp_path_factory.mktemp("llama")
    r = np.random.default_rng(11)
    batches = r.integers(0, VOCAB, (LLAMA_STEPS, BATCH, SEQ)).astype(np.int32)
    np.save(tmp / "batches.npy", batches)
    cfg = _llama_cfg()
    jmesh = j_make_mesh({"fsdp": 2}, devices=jax.devices()[:2])
    jcfg = JTrainerConfig(**{f: getattr(cfg, f) for f in (
        "learning_rate", "weight_decay", "warmup_steps", "total_steps", "grad_clip",
        "optimizer", "accum_steps")})
    first = {"input_ids": batches[0]}
    jt = JTrainer(j_llama_tiny(vocab_size=VOCAB, max_len=SEQ, mesh=jmesh,
                               dtype=jax.numpy.float32),
                  jcfg, jmesh, j_llama_loss, first, init_args=(first["input_ids"],),
                  shardings="logical")
    unbox = lambda t: jax.tree_util.tree_map(np.asarray, flax.core.meta.unbox(t))  # noqa: E731
    initial = from_flax_params(unbox(jt.state.params))
    save_npz(initial, str(tmp / "init.npz"))
    outs = _workers(2, "llama", tmp)
    ranks = [json.loads((tmp / f"llama{i}.json").read_text()) for i in range(2)]
    jm = [jt.train_step(jt.shard_batch({"input_ids": b})) for b in batches]
    one = Trainer(_llama_model(initial), cfg, llama_loss)
    om = [one.train_step({"input_ids": b}) for b in batches]
    return {"tmp": tmp, "outs": outs, "ranks": ranks, "initial": initial,
            "jax": {k: [float(m[k]) for m in jm] for k in ("loss", "grad_norm",
                                                            "token_accuracy")},
            "jax_params": from_flax_params(unbox(jt.state.params)),
            "one": {k: [float(m[k]) for m in om] for k in ("loss", "grad_norm",
                                                            "token_accuracy")},
            "one_params": {n: p.detach() for n, p in one.model.named_parameters()},
            "one_resident": one.resident_bytes(),
            "one_eval_loss": float(one.eval_step({"input_ids": batches[-1]})["loss"])}


def test_a_gloo_world_is_torn_down_when_the_interpreter_exits(tmp_path):
    """``initialize`` registers the world's teardown for the exit: left
    to the C++ static destructors, a finished rank of a 4-rank gloo
    world aborted 2 to 3 times in a hundred exits under load
    (``tests/torch_teardown_stress.py``)."""

    _workers(2, "teardown", tmp_path)
    for r in range(2):
        rec = json.loads((tmp_path / f"teardown{r}.json").read_text())
        assert rec == {"backend": "gloo", "sum": [2.0] * 4, "joined": True,
                       "after_exit_funcs": False}


def test_llama_fsdp_matches_the_one_process_run_on_the_global_batch(llama_runs):
    ranks, one = llama_runs["ranks"], llama_runs["one"]
    for k in ("loss", "grad_norm", "token_accuracy"):
        # every rank holds the global means
        assert ranks[0][k] == ranks[1][k], k
        np.testing.assert_allclose(ranks[0][k], one[k], rtol=1e-5, err_msg=k)
    got = np.load(llama_runs["tmp"] / "llama_params.npz")
    assert set(got.files) == set(llama_runs["one_params"])
    for name, want in llama_runs["one_params"].items():
        want = want.numpy()
        err = np.linalg.norm(got[name] - want) / np.linalg.norm(want)
        assert err <= 1e-5, f"{name}: relative error {err:.3g}"
        assert not np.array_equal(want, llama_runs["initial"][name].numpy()), name
    # between steps (and after an eval) a rank holds half of every
    # embed-sharded weight, as its master shard, and half of its moments;
    # the model's sharded parameters hold no storage, the norms stay whole
    one_res = llama_runs["one_resident"]
    for rec in ranks:
        res = rec["resident"]
        assert rec["resident_after_eval"] == res
        assert res["params"] < 0.01 * one_res["params"], res
        assert res["params"] + res["masters"] < 0.51 * one_res["params"], (res, one_res)
        assert res["optimizer"] < 0.51 * one_res["optimizer"], (res, one_res)
        np.testing.assert_allclose(rec["eval_loss"], llama_runs["one_eval_loss"], rtol=1e-5)
        # in a step a module's weights are gathered for its forward (and
        # again for the backward, which in float32 saves the weight) and
        # freed after: never the whole model at once
        assert rec["most_live"] <= 2 < rec["n_sharded"], rec["most_live"]
    assert {"gather_params", "stage1_reduce_scatter", "flat_all_reduce",
            "metrics_all_reduce", "norm_all_reduce"} <= set(ranks[0]["stages"])


def test_llama_fsdp_matches_the_jax_trainer_on_a_two_device_fsdp_mesh(llama_runs):
    ranks, jx = llama_runs["ranks"], llama_runs["jax"]
    np.testing.assert_allclose(ranks[0]["loss"], jx["loss"], rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["grad_norm"], jx["grad_norm"], rtol=1e-4)
    np.testing.assert_allclose(ranks[0]["token_accuracy"], jx["token_accuracy"])
    assert max(jx["grad_norm"]) > _llama_cfg().grad_clip, "the clip never triggered"
    got = np.load(llama_runs["tmp"] / "llama_params.npz")
    for name, t in llama_runs["jax_params"].items():
        want = t.numpy()
        np.testing.assert_allclose(got[name], want, atol=2e-5, err_msg=name)
        init = llama_runs["initial"][name].numpy()
        scale = np.linalg.norm(want - init)
        assert np.linalg.norm((got[name] - init) - (want - init)) <= 1e-3 * scale, name


def test_sharded_export_writes_the_gathered_weights(llama_runs):
    from tf_operator_tpu_torch.models.weights import load_npz

    art = llama_runs["tmp"] / "artifact"
    assert sorted(os.listdir(art)) == ["model.json", "params.npz"]
    got = np.load(llama_runs["tmp"] / "llama_params.npz")
    for name, t in load_npz(str(art / "params.npz")).items():
        np.testing.assert_array_equal(t.numpy(), got[name], err_msg=name)


def test_dist_mnist_two_ranks_match_one_process_on_the_global_batch(tmp_path):
    from tf_operator_tpu_torch import dist_mnist

    outs = _workers(2, "mnist", tmp_path)
    argv = ["--device", "cpu", "--steps", str(MNIST_STEPS), "--batch-size", str(MNIST_BATCH)]
    one = dist_mnist.run(dist_mnist.parse_args(argv), dtype=torch.float32)["losses"]
    for r in range(2):
        got = json.loads((tmp_path / f"mnist{r}.json").read_text())
        np.testing.assert_allclose(got, one, rtol=1e-5)
        line = [ln for ln in outs[r].splitlines() if ln.startswith(f"process {r}/2: steps")]
        assert line and line[0].startswith(f"process {r}/2: steps 0..{MNIST_STEPS} loss "), outs[r]
    for flag in ("--data-dir", "--checkpoint-dir", "--profile-dir"):
        with pytest.raises(SystemExit):
            dist_mnist.parse_args(argv + [flag, str(tmp_path)])


def test_resnet_dp_matches_the_jax_trainer_with_global_batch_statistics(tmp_path):
    import flax
    import jax

    from tf_operator_tpu.models import resnet as jresnet
    from tf_operator_tpu.parallel import Trainer as JTrainer
    from tf_operator_tpu.parallel import TrainerConfig as JTrainerConfig
    from tf_operator_tpu.parallel import make_mesh as j_make_mesh
    from tf_operator_tpu.parallel.trainer import (
        batchnorm_cross_entropy_loss as j_bn_loss,
    )

    from tf_operator_tpu_torch.models import resnet

    r = np.random.RandomState(3)
    batch = {"image": r.rand(RESNET_BATCH, 16, 16, 3).astype(np.float32),
             "label": r.randint(0, 10, size=(RESNET_BATCH,)).astype(np.int32)}
    np.savez(tmp_path / "resnet_batch.npz", **batch)
    jmesh = j_make_mesh({"dp": 2}, devices=jax.devices()[:2])
    jt = JTrainer(jresnet.resnet18(num_classes=10, width=8, dtype=jax.numpy.float32),
                  JTrainerConfig(optimizer="sgd", learning_rate=0.1), jmesh, j_bn_loss, batch)

    def state():
        return resnet.resnet_state_from_flax(jax.tree_util.tree_map(np.asarray, {
            "params": flax.core.unfreeze(jt.state.params),
            "batch_stats": flax.core.unfreeze(jt.state.model_state["batch_stats"])}))

    np.savez(tmp_path / "resnet_init.npz", **{k: v.numpy() for k, v in state().items()})
    outs = _workers(2, "resnet", tmp_path)
    jm = [jt.train_step(jt.shard_batch(batch)) for _ in range(RESNET_STEPS)]
    rec = json.loads((tmp_path / "resnet.json").read_text())
    np.testing.assert_allclose(rec["loss"], [float(m["loss"]) for m in jm], rtol=1e-4)
    np.testing.assert_allclose(rec["grad_norm"], [float(m["grad_norm"]) for m in jm], rtol=1e-3)
    got = np.load(tmp_path / "resnet_state.npz")
    for k, t in state().items():
        np.testing.assert_allclose(got[k], t.numpy(), atol=1e-5, err_msg=k)
    for out in outs:
        assert "resnet18 dp=1 fsdp=2 norm=batchnorm: " in out and "ex/s global" in out


def test_resnet_dp_refuses_the_fused_norm_in_a_world_of_two(monkeypatch):
    from tf_operator_tpu_torch import resnet_dp

    monkeypatch.setenv("TPUJOB_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("TPUJOB_NUM_PROCESSES", "2")
    monkeypatch.setenv("TPUJOB_PROCESS_ID", "0")
    with pytest.raises(SystemExit) as exc:
        resnet_dp.parse_args(["--device", "cpu", "--norm", "fused"])
    assert exc.value.code == 2
    for fsdp in ("1", "2"):
        assert resnet_dp.parse_args(["--device", "cpu", "--fsdp", fsdp]).fsdp == int(fsdp)
    with pytest.raises(SystemExit):
        resnet_dp.parse_args(["--device", "cpu", "--fsdp", "4"])


# -- the reference's orchestrator running port jobs ---------------------------

@pytest.fixture
def local_harness():
    from tf_operator_tpu.backend.jobstore import JobStore
    from tf_operator_tpu.backend.local import LocalProcessBackend
    from tf_operator_tpu.controller.controller import TPUJobController
    from tf_operator_tpu.controller.reconciler import ReconcilerConfig

    store = JobStore()
    backend = LocalProcessBackend()
    controller = TPUJobController(store, backend,
                                  config=ReconcilerConfig(resolver=backend.resolver))
    controller.run(threadiness=2)
    yield store, backend
    controller.stop()
    backend.close()


def _wait_succeeded(store, name, timeout=180.0):
    from tf_operator_tpu.api.types import JobConditionType

    deadline = time.time() + timeout
    while time.time() < deadline:
        job = store.get("default", name)
        if job is not None and job.status.has_condition(JobConditionType.SUCCEEDED):
            return job
        if job is not None and job.status.has_condition(JobConditionType.FAILED):
            break
        time.sleep(0.1)
    job = store.get("default", name)
    raise AssertionError(f"{name} did not succeed; status={job.status if job else None}")


PORT_ENV = {"OMP_NUM_THREADS": "1", "TPUJOB_NO_SUITE_RECORD": "1"}


def test_local_backend_runs_the_port_dist_psum_as_a_two_worker_job(local_harness):
    from tests.testutil import new_job
    from tf_operator_tpu.api.types import ReplicaType, SuccessPolicy

    store, backend = local_harness
    job = new_job(name="portpair", worker=2, command=[
        sys.executable, "-m", "tf_operator_tpu_torch.dist_psum", "--device", "cpu"])
    job.spec.replica_specs[ReplicaType.WORKER].template.containers[0].env = dict(PORT_ENV)
    job.spec.success_policy = SuccessPolicy.ALL_WORKERS
    store.create(job)
    done = _wait_succeeded(store, "portpair")
    assert done.status.replica_statuses[ReplicaType.WORKER].succeeded == 2
    assert "process 0/2: allgather ok -> [0.0, 1.0]" in backend.pod_log("default",
                                                                        "portpair-worker-0")
    assert "process 1/2: allgather ok -> [0.0, 1.0]" in backend.pod_log("default",
                                                                        "portpair-worker-1")


def test_local_backend_runs_the_port_dist_multislice_on_two_slices(local_harness):
    import jax
    import jax.numpy as jnp

    from tests.testutil import new_job
    from tf_operator_tpu.api.types import ReplicaType
    from tf_operator_tpu.models import MnistCNN as JMnist
    from tf_operator_tpu.parallel import collectives as jcoll
    from tf_operator_tpu.parallel import make_mesh as j_make_mesh
    from tf_operator_tpu.parallel.sharding import fsdp_shardings

    store, backend = local_harness
    job = new_job(name="porttwoslice", tpu_slice=2, tpu_topology="v5e-8", command=[
        sys.executable, "-m", "tf_operator_tpu_torch.dist_multislice", "--device", "cpu"])
    spec = job.spec.replica_specs[ReplicaType.TPU_SLICE]
    assert spec.slice_host_count() == 2
    spec.template.containers[0].env = dict(PORT_ENV)
    store.create(job)
    done = _wait_succeeded(store, "porttwoslice")
    assert done.status.replica_statuses[ReplicaType.TPU_SLICE].succeeded == 4
    for idx in range(4):
        log = backend.pod_log("default", f"porttwoslice-tpuslice-{idx}")
        s, h = idx // 2, idx % 2
        assert f"process {idx}/4: slice {s}/2 worker {h} megascale ok" in log, log
    log0 = backend.pod_log("default", "porttwoslice-tpuslice-0")
    lines = [ln for ln in log0.splitlines() if ln.startswith("MULTISLICE_LEDGER ")]
    assert lines, log0
    ledger = json.loads(lines[-1].split(" ", 1)[1])
    assert ledger["grad_sync"] == "hierarchical"
    assert ledger["axis_fabric"] == {"dp": "dcn", "fsdp": "ici"}
    assert ledger["mesh"] == {"dp": 2, "fsdp": 2}
    intra = ledger["intra_slice_size"]
    assert intra == 2
    assert ledger["dcn_bytes_ratio"] <= 1 / intra + 1e-3
    # the JAX plan for the same model on the same mesh: the same ledger
    jm = j_make_mesh({"dp": 2, "fsdp": -1}, devices=jax.devices()[:4], slices=2)
    abstract = jax.eval_shape(lambda: JMnist().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)), train=False))["params"]
    want = jcoll.build_grad_sync_plan(abstract, fsdp_shardings(abstract, jm), jm).ledger()
    assert {k: ledger[k] for k in want} == want


if __name__ == "__main__":
    WORKERS[sys.argv[1]](sys.argv[2])
