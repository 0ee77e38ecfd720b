"""The step series (``utils/summaries.py``), the ``Trainer``'s summaries,
``evaluate`` and ``train_steps`` (``parallel/trainer.py``) and
``mnist_with_summaries`` against the JAX package, on the CPU.

- A port writer's files are read by the port's ``read_series`` and by
  the JAX package's (``tf_operator_tpu/utils/summaries.py``, which the
  operator's job API, health rollup and autoscaler read with) to the
  same records, and the other way round; ``latest_checkpoint_time`` and
  the tail read (``limit``) agree, and a torn line is skipped;
- the ``MnistCNN`` (float32; on both sides a loss over its deterministic
  forward, without the training dropout) from one flax init, the same sgd steps at
  learning rate 0.01 on one batch: ``summary_every`` writes the same
  steps with the same keys (``steps_per_sec`` from the second record on)
  and each scalar within rtol 2e-4 of the JAX trainer's (the first
  step's grad norm reads 4.9e-5 apart from the same weights: the
  convolutions' float32 backward sums in another order; at the example's
  0.05 the two random-label trajectories part by 2.5e-3 within ten
  steps, so the rate is lower here, and at 0.01 the grad norms part by
  6.6e-4 at the eleventh step while the losses stay within 5e-6, so
  both runs take ten steps); ``train_steps`` in windows of 2 parks
  and writes the records of the JAX trainer's windows (steps 4 and 6 at
  every 3, each its window's last step), and its stacked metrics are
  within rtol 2e-4 of the JAX trainer's per-step program over the same
  steps (the JAX window is one compiled scan, whose float32 arithmetic
  its own docstring puts about 1e-3 from that program); ``evaluate``
  over two batches within rtol 1e-5;
- ``mnist_with_summaries`` as a 2-worker job under the reference's
  ``LocalProcessBackend`` and ``TPUJobController``: the job succeeds
  with the reference's final line on both workers, and the reference's
  ``read_series`` reads both processes' series (steps 5 and 10,
  ``steps_per_sec`` at step 10).
"""

import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from tf_operator_tpu_torch.utils import summaries

torch.set_num_threads(2)

LR, EVERY = 0.01, 3


def _series(rows):
    return [{k: v for k, v in r.items() if k != "time"} for r in rows]


def test_the_reference_reads_the_ports_series_and_back(tmp_path):
    from tf_operator_tpu.utils import summaries as jsummaries

    with summaries.SummaryWriter(str(tmp_path / "port"), process_id=0) as w:
        w.write(1, loss=2.5, accuracy=np.float32(0.25), note="skipped")
        w.write(2, loss=2.0, checkpoint_time_unix=1234.5)
    with summaries.SummaryWriter(str(tmp_path / "port"), process_id=1) as w:
        w.write(1, loss=2.25)
        w.write(3, loss=torch.tensor(1.5))
    with open(tmp_path / "port" / "metrics-1.jsonl", "a") as f:
        f.write('{"step": 4, "loss": 1.')  # a writer that died mid-line
    for directory, write in (("port", None), ("ref", jsummaries.SummaryWriter)):
        if write is not None:
            for pid, recs in ((0, [(1, {"loss": 2.5, "accuracy": 0.25}),
                                   (2, {"loss": 2.0, "checkpoint_time_unix": 1234.5})]),
                              (1, [(1, {"loss": 2.25}), (3, {"loss": 1.5})])):
                with write(str(tmp_path / directory), process_id=pid) as w:
                    for step, scalars in recs:
                        w.write(step, **scalars)
        path = str(tmp_path / directory)
        got, want = summaries.read_series(path), jsummaries.read_series(path)
        assert _series(got) == _series(want) == [
            {"step": 1, "loss": 2.5, "accuracy": 0.25}, {"step": 1, "loss": 2.25},
            {"step": 2, "loss": 2.0, "checkpoint_time_unix": 1234.5},
            {"step": 3, "loss": 1.5}]
        assert _series(summaries.read_series(path, limit=2)) == _series(
            jsummaries.read_series(path, limit=2))
        assert (summaries.latest_checkpoint_time(path)
                == jsummaries.latest_checkpoint_time(path) == 1234.5)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "ref")) == [
        "metrics-0.jsonl", "metrics-1.jsonl"]
    assert summaries.ANNOTATION_SUMMARY_DIR == jsummaries.ANNOTATION_SUMMARY_DIR
    assert summaries.latest_checkpoint_time(str(tmp_path / "none")) is None


def _batches(n=3, rows=16):
    r = np.random.RandomState(7)
    return [{"image": r.rand(rows, 28, 28, 1).astype(np.float32),
             "label": r.randint(0, 10, rows).astype(np.int32)} for _ in range(n)]


def _jax_loss(params, state, batch, rng, train=True):
    """The JAX trainer's ``cross_entropy_loss`` on the deterministic
    forward (no dropout), as the port's side runs (the port's
    ``cross_entropy_loss`` at its default ``train=False``)."""

    import jax.numpy as jnp
    import optax

    logits = state.apply_fn({"params": params}, batch["image"], train=False)
    loss = optax.softmax_cross_entropy_with_integer_labels(
        logits.astype(jnp.float32), batch["label"]).mean()
    return loss, {"metrics": {"accuracy": (logits.argmax(-1) == batch["label"]).mean()}}


def _pair(tmp_path, tag, every):
    """A JAX and a port ``Trainer`` over the same flax init, each writing
    its series under ``tmp_path``."""

    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.models import MnistCNN as JMnistCNN
    from tf_operator_tpu.parallel import Trainer as JTrainer
    from tf_operator_tpu.parallel import TrainerConfig as JTrainerConfig
    from tf_operator_tpu.parallel import make_mesh as j_make_mesh
    from tf_operator_tpu.utils.summaries import SummaryWriter as JSummaryWriter

    from tf_operator_tpu_torch.models.mnist import MnistCNN, cross_entropy_loss
    from tf_operator_tpu_torch.models.weights import mnist_state_from_flax
    from tf_operator_tpu_torch.parallel.trainer import Trainer, TrainerConfig

    batch = _batches(1)[0]
    jw = JSummaryWriter(str(tmp_path / f"{tag}_jax"))
    jt = JTrainer(JMnistCNN(dtype=jnp.float32),
                  JTrainerConfig(optimizer="sgd", learning_rate=LR, summary_every=every),
                  j_make_mesh({"dp": 1}, devices=jax.devices()[:1]), _jax_loss, batch,
                  summary_writer=jw)
    model = MnistCNN(dtype=torch.float32, device="cpu")
    model.load_state_dict(mnist_state_from_flax(
        jax.tree_util.tree_map(np.asarray, jt.state.params)))
    pw = summaries.SummaryWriter(str(tmp_path / f"{tag}_port"))
    pt = Trainer(model, TrainerConfig(optimizer="sgd", learning_rate=LR, summary_every=every),
                 cross_entropy_loss, summary_writer=pw)
    return jt, jw, pt, pw, batch


def _check_series(got, want, rtol):
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in set(w) - {"step", "time", "steps_per_sec"}:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, err_msg=k)
    assert "steps_per_sec" not in got[0] and all(r["steps_per_sec"] > 0 for r in got[1:])


def test_summary_every_writes_the_jax_trainers_records(tmp_path):
    jt, jw, pt, pw, batch = _pair(tmp_path, "step", EVERY)
    jbatch = jt.shard_batch(batch)
    for _ in range(10):
        jt.train_step(jbatch)
        pt.train_step(pt.shard_batch(batch))
    jw.close()
    pw.close()
    got = summaries.read_series(str(tmp_path / "step_port"))
    want = summaries.read_series(str(tmp_path / "step_jax"))
    assert [r["step"] for r in want] == [3, 6, 9]
    assert set(want[0]) == {"step", "time", "loss", "accuracy", "grad_norm"}
    _check_series(got, want, 2e-4)
    assert pt.sync_ledger.count("summary") == 3


def test_train_steps_parks_its_windows_summary_as_the_jax_trainer(tmp_path):
    jt, jw, pt, pw, batch = _pair(tmp_path, "window", EVERY)
    # the JAX trainer's per-step program over the same steps: the values
    js, jsw, _, _, _ = _pair(tmp_path, "stepwise", EVERY)
    jbatch = jt.shard_batch(batch)
    stacked = []
    for _ in range(5):
        window = jt.train_steps(jbatch, 2)
        want = [js.train_step(jbatch) for _ in range(2)]
        got = pt.train_steps(pt.shard_batch(batch), 2)
        assert set(got) == set(window) == set(want[0])
        for k in want[0]:
            assert tuple(got[k].shape) == (2,)
            np.testing.assert_allclose(got[k].numpy(), [float(m[k]) for m in want],
                                       rtol=2e-4, err_msg=k)
        stacked.append(got)
    for w in (jw, jsw, pw):
        w.close()
    got = summaries.read_series(str(tmp_path / "window_port"))
    want = summaries.read_series(str(tmp_path / "window_jax"))
    # parked at the boundary window's end, written when the next starts;
    # the last window's (step 10) is dropped, as no window follows it
    assert [r["step"] for r in want] == [r["step"] for r in got] == [4, 6]
    for rec, w in zip(got, want):
        assert set(rec) == set(w)
        window = stacked[rec["step"] // 2 - 1]
        for k in set(rec) - {"step", "time", "steps_per_sec"}:
            assert rec[k] == float(window[k][-1]), k
    assert "steps_per_sec" not in got[0] and got[1]["steps_per_sec"] > 0
    assert pt.host_step == 10
    with pytest.raises(ValueError):
        pt.train_steps(batch, 0)


def test_evaluate_is_the_jax_trainers(tmp_path):
    jt, jw, pt, pw, batch = _pair(tmp_path, "eval", EVERY)
    held = _batches(2, rows=8)
    want, got = jt.evaluate(held), pt.evaluate(held)
    assert set(got) == set(want) == {"loss", "accuracy"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert isinstance(got["loss"], float)
    with pytest.raises(ValueError, match="empty"):
        pt.evaluate([])
    jw.close()
    pw.close()


def test_the_mnist_loss_in_training_is_the_jax_trainers(tmp_path):
    """``models/mnist.cross_entropy_loss(train=True)``
    (``mnist_with_summaries``' loss): its evaluation (no dropout) is the
    JAX trainer's ``cross_entropy_loss``'s, and a training forward drops
    half of the 1024 features with masks from the trainer's generator."""

    import functools

    from tf_operator_tpu.parallel.trainer import cross_entropy_loss as j_loss

    from tf_operator_tpu_torch.models.mnist import MnistCNN
    from tf_operator_tpu_torch.models.mnist import cross_entropy_loss as p_loss

    cross_entropy_loss = functools.partial(p_loss, train=True)

    jt, jw, pt, pw, batch = _pair(tmp_path, "loss", EVERY)
    jt.loss_fn, pt.loss_fn = j_loss, cross_entropy_loss
    want = jt.eval_step(jt.shard_batch(batch))
    got = pt.eval_step(pt.shard_batch(batch))
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    pt.model.train()
    with torch.no_grad():
        drop = [float(cross_entropy_loss(pt.model, pt.shard_batch(batch))[0]) for _ in range(2)]
    assert drop[0] != drop[1] and float(got["loss"]) not in drop
    with pytest.raises(ValueError, match="dropout_rng"):
        cross_entropy_loss(MnistCNN(dtype=torch.float32).train(), pt.shard_batch(batch))
    jw.close()
    pw.close()


def test_mnist_with_summaries_writes_its_series_in_one_process(tmp_path, capsys):
    from tf_operator_tpu_torch import mnist_with_summaries

    d = str(tmp_path / "series")
    assert mnist_with_summaries.main(["--device", "cpu", "--summary-dir", d, "--steps", "10",
                                      "--batch-size", "16"]) == 0
    assert f"process 0/1: final loss " in capsys.readouterr().out
    rows = summaries.read_series(d)
    assert [r["step"] for r in rows] == [5, 10] and "steps_per_sec" in rows[1]
    with pytest.raises(SystemExit):
        mnist_with_summaries.parse_args(["--summary-dir", d, "--checkpoint-dir", d])


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


def test_local_backend_runs_mnist_with_summaries_as_a_two_worker_job(local_harness, tmp_path):
    from tests.testutil import new_job
    from tf_operator_tpu.api.types import JobConditionType, ReplicaType, SuccessPolicy
    from tf_operator_tpu.utils.summaries import read_series as j_read_series

    store, backend = local_harness
    d = str(tmp_path / "series")
    job = new_job(name="portsummaries", worker=2, command=[
        sys.executable, "-m", "tf_operator_tpu_torch.mnist_with_summaries", "--device", "cpu",
        "--summary-dir", d, "--steps", "10", "--batch-size", "16"])
    job.spec.replica_specs[ReplicaType.WORKER].template.containers[0].env = {
        "OMP_NUM_THREADS": "1", "TPUJOB_NO_SUITE_RECORD": "1"}
    job.spec.success_policy = SuccessPolicy.ALL_WORKERS
    store.create(job)
    deadline = time.time() + 240
    while time.time() < deadline:
        got = store.get("default", "portsummaries")
        if got is not None and (got.status.has_condition(JobConditionType.SUCCEEDED)
                                or got.status.has_condition(JobConditionType.FAILED)):
            break
        time.sleep(0.1)
    logs = [backend.pod_log("default", f"portsummaries-worker-{i}") for i in range(2)]
    assert got.status.has_condition(JobConditionType.SUCCEEDED), logs
    for i in range(2):
        assert f"process {i}/2: final loss " in logs[i] and f"series in {d}" in logs[i]
    rows = j_read_series(d)
    assert _series(rows) == _series(summaries.read_series(d))
    assert sorted(r["step"] for r in rows) == [5, 5, 10, 10]
    assert all("steps_per_sec" in r for r in rows if r["step"] == 10)
    assert sorted(os.listdir(d)) == ["metrics-0.jsonl", "metrics-1.jsonl"]
