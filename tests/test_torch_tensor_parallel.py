"""Tensor parallelism (``parallel/tensor_parallel.py``; the tp axis under
``Trainer(shardings="logical")``) against the JAX package, on the CPU.

Each family at test scale (``tests/torch_model_parallel.py``: llama_tiny,
gpt_tiny, moe_tiny, bert_tiny, t5_tiny, vit_tiny, float32) starts from
the JAX ``Trainer``'s own initial params on a mesh of host devices,
bridged into the port, and both sides train the same seeded global
batches (4 rows, 3 steps of sgd with momentum, dropout 0); the port as
the ranks of a gloo world (``tests/torch_world.py``).  Tolerances:

- each step's loss and grad norm against the JAX trainer's on the same
  mesh, rtol 2e-4 (the reference's own bound between meshes,
  ``tests/test_llama.py``); every rank of a tp line prints the same
  numbers, exactly;
- the params after the steps (``Trainer.full_params``, the shards
  gathered) against the JAX trainer's, each leaf within 2e-4 of its
  largest element;
- each rank's parameter shapes (its masters under fsdp) equal the
  shards the JAX layout gives a device, exactly;
- the parameters a rank keeps whole are bitwise equal across its tp
  line after the steps, at dropout 0.1 too (the line draws one set of
  masks);
- ``shard_batch`` refuses a batch on a mesh that replicates it across
  processes, naming ``shard_global_batch``, and the steps run after;
- under the default rule (fsdp) a tp mesh splits nothing: the ranks
  train whole replicas and match the JAX trainer as above.

A 2-rank world runs the six families over ``{"tp": 2}`` and a 4-rank
world llama over ``{"fsdp": 2, "tp": 2}``; ``t5_multihost`` and
``vit_classify`` run with ``--tp 2`` as 2-process jobs through the
reference's local harness (``LocalProcessBackend`` + ``TPUJobController``).
"""

import json
import re
import sys
import time

import numpy as np
import pytest
import torch
from torch_world import run_world

import torch_model_parallel as mp
from tf_operator_tpu_torch.models.transformer import Embed, TransformerConfig
from tf_operator_tpu_torch.parallel import tensor_parallel as tpar

torch.set_num_threads(2)

ROWS, SEED = 4, 5
#: the losses and grad norms, relative (module docstring)
RTOL = 2e-4
#: the params after the steps, against each leaf's largest element
PARAM_TOL = 2e-4


def _write(tmp, name, family, shape, state, data, **extra):
    mp.save_state(state, str(tmp / f"{name}_state.npz"))
    np.savez(tmp / f"{name}_batches.npz", **data)
    return {"name": name, "family": family, "mesh": shape,
            "state": str(tmp / f"{name}_state.npz"),
            "batches": str(tmp / f"{name}_batches.npz"), **extra}


def _ranks(tmp, name, n):
    return [json.loads((tmp / f"{name}_rank{r}.json").read_text()) for r in range(n)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX trainer of each family on {"tp": 2}, llama's on
    {"fsdp": 2, "tp": 2}, and the port's worlds from the same params."""

    tmp = tmp_path_factory.mktemp("tp")
    jax_runs, specs = {}, []
    for family in mp.FAMILIES:
        data = mp.batches(family, ROWS, SEED)
        jax_runs[family] = mp.jax_run(family, {"tp": 2}, data)
        specs.append(_write(tmp, family, family, {"tp": 2}, jax_runs[family]["initial"], data,
                            guard=family == "gpt", export=family == "llama"))
    for family in ("gpt", "t5"):
        data = mp.batches(family, ROWS, SEED)
        specs.append(_write(tmp, f"{family}_dropout", family, {"tp": 2},
                            jax_runs[family]["initial"], data, dropout=0.1))
    specs.append(_write(tmp, "gpt_fsdp_rule", "gpt", {"tp": 2}, jax_runs["gpt"]["initial"],
                        mp.batches("gpt", ROWS, SEED), shardings="fsdp"))
    (tmp / "spec2.json").write_text(json.dumps(specs))
    world2 = run_world(2, [sys.executable, "-m", "torch_model_parallel",
                           str(tmp / "spec2.json")], timeout=300)
    data = mp.batches("llama", ROWS, SEED)
    jax_runs["llama_fsdp_tp"] = mp.jax_run("llama", {"fsdp": 2, "tp": 2}, data)
    (tmp / "spec4.json").write_text(json.dumps([_write(
        tmp, "llama_fsdp_tp", "llama", {"fsdp": 2, "tp": 2},
        jax_runs["llama_fsdp_tp"]["initial"], data)]))
    world4 = run_world(4, [sys.executable, "-m", "torch_model_parallel",
                           str(tmp / "spec4.json")], timeout=300)
    return {"tmp": tmp, "jax": jax_runs, "outs": world2 + world4}


def _metrics_match(ranks, want):
    for rec in ranks:
        assert rec["metrics"] == ranks[0]["metrics"]  # one line, one number
    for got, ref in zip(ranks[0]["metrics"], want["metrics"]):
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=RTOL)
        np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"], rtol=RTOL)
    assert len(ranks[0]["metrics"]) == len(want["metrics"]) == mp.STEPS


def _params_match(tmp, name, want):
    with np.load(tmp / f"{name}_params.npz") as f:
        got = {k: f[k] for k in f.files}
    assert set(got) == set(want["final"])
    for k, w in want["final"].items():
        assert got[k].shape == w.shape, k
        assert np.abs(got[k] - w).max() <= PARAM_TOL * max(np.abs(w).max(), 1e-6), k


@pytest.mark.parametrize("family", mp.FAMILIES)
def test_losses_match_the_jax_trainer_on_a_tp_mesh(runs, family):
    ranks = _ranks(runs["tmp"], family, 2)
    assert [r["mesh"]["tp"] for r in ranks] == [2, 2]
    _metrics_match(ranks, runs["jax"][family])


@pytest.mark.parametrize("family", mp.FAMILIES)
def test_trained_params_match_the_jax_trainer(runs, family):
    _params_match(runs["tmp"], family, runs["jax"][family])


@pytest.mark.parametrize("family", mp.FAMILIES)
def test_each_rank_holds_the_jax_layout_shards(runs, family):
    want = runs["jax"][family]["shards"]
    for rec in _ranks(runs["tmp"], family, 2):
        assert {k: tuple(v) for k, v in rec["shapes"].items()} == want
        # no leaf is split over fsdp here: the masters are the shards
        assert rec["masters"] == rec["shapes"]
    # and the split is real: some leaf is half its whole
    whole = runs["jax"][family]["final"]
    assert any(np.prod(s) * 2 == whole[k].size for k, s in want.items())


@pytest.mark.parametrize("family", ["gpt", "t5"])
def test_replicated_params_stay_bitwise_equal_with_dropout(runs, family):
    ranks = _ranks(runs["tmp"], f"{family}_dropout", 2)
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    assert ranks[0]["whole"] == ranks[1]["whole"] and ranks[0]["whole"]
    # dropout acted: the losses leave the dropout-0 run's
    plain = _ranks(runs["tmp"], family, 2)[0]["metrics"]
    assert all(np.isfinite(m["loss"]) for m in ranks[0]["metrics"])
    assert [m["loss"] for m in ranks[0]["metrics"]] != [m["loss"] for m in plain]


@pytest.mark.parametrize("family", mp.FAMILIES)
def test_replicated_params_stay_bitwise_equal(runs, family):
    ranks = _ranks(runs["tmp"], family, 2)
    assert ranks[0]["whole"] == ranks[1]["whole"] and ranks[0]["whole"]


def test_the_fsdp_rule_on_a_tp_mesh_trains_whole_replicas(runs):
    """Under the ``Trainer``'s default rule (fsdp) no parameter is split
    over tp: each rank of the line trains the whole model on the same
    rows, with no tp collective, and computes what the JAX trainer
    computes on that mesh (the losses, grad norms and params of its
    logical run, the one-device math within the stated tolerances)."""

    want = runs["jax"]["gpt"]
    ranks = _ranks(runs["tmp"], "gpt_fsdp_rule", 2)
    _metrics_match(ranks, want)
    _params_match(runs["tmp"], "gpt_fsdp_rule", want)
    whole = {k: v.shape for k, v in want["final"].items()}
    for rec in ranks:
        assert {k: tuple(v) for k, v in rec["shapes"].items()} == whole
        assert not [s for s in rec["stages"] if s.startswith("tp_")], rec["stages"]
    assert ranks[0]["whole"] == ranks[1]["whole"] and len(ranks[0]["whole"]) == len(whole)


def test_shard_batch_guard_fires_on_a_replicating_mesh(runs):
    """The reference's guard test (gpt_tiny over {"tp": 2}): shard_batch
    raises and names shard_global_batch; the steps then run."""

    for rec in _ranks(runs["tmp"], "gpt", 2):
        assert "shard_global_batch" in rec["guard"]
        assert len(rec["metrics"]) == mp.STEPS
        assert all(np.isfinite(m["loss"]) for m in rec["metrics"])


def test_tp_collectives_count_in_the_mesh_stats(runs):
    for family in mp.FAMILIES:
        stages = set(_ranks(runs["tmp"], family, 2)[0]["stages"])
        assert {"tp_all_reduce", "tp_grad_all_reduce", "tp_loss_all_reduce"} <= stages, family
        # no gradient is summed over tp: the plan has no group to do it
        # (a one-rank batch line) and the params gather for the export
        assert not stages & {"flat_all_reduce", "stage1_reduce_scatter"}, family


def test_llama_over_fsdp_and_tp_matches_the_jax_trainer(runs):
    """``tests/test_llama.py``'s fsdp x tp layout at 4 ranks: the metrics,
    the params, each rank's masters the JAX shards (fsdp's chunk of the
    tp shard), and the replicas of a tp line bitwise equal."""

    want = runs["jax"]["llama_fsdp_tp"]
    ranks = _ranks(runs["tmp"], "llama_fsdp_tp", 4)
    _metrics_match(ranks, want)
    _params_match(runs["tmp"], "llama_fsdp_tp", want)
    for rec in ranks:
        assert {k: tuple(v) for k, v in rec["masters"].items()} == want["shards"]
    q = "layers.0.self_attn.query.kernel"
    assert ranks[0]["masters"][q] == [64, 2, 32] and ranks[0]["shapes"][q] == [128, 2, 32]
    # every leaf split over neither tp nor fsdp (the norms' scales) is one
    # tensor on all four ranks
    assert all(rec["whole"] == ranks[0]["whole"] for rec in ranks) and ranks[0]["whole"]
    assert {"stage1_reduce_scatter", "gather_params", "tp_all_reduce"} <= set(ranks[0]["stages"])


def test_export_writes_whole_tensors_the_jax_model_reads(runs):
    """``export_params`` after a tp run: model.json and params.npz of
    whole tensors under flat flax paths; unflattened, the JAX model
    applies them, and they equal the JAX trainer's params."""

    import flax
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.models import llama as jllama
    from tf_operator_tpu_torch.models.weights import from_flax_params

    art = runs["tmp"] / "llama_artifact"
    desc = json.loads((art / "model.json").read_text())
    assert desc["family"] == "llama" and desc["config"]["n_heads"] == 4
    with np.load(art / "params.npz") as f:
        tree = flax.traverse_util.unflatten_dict({tuple(k.split("/")): f[k] for k in f.files})
    got = {k: v.numpy() for k, v in from_flax_params(tree).items()}
    want = runs["jax"]["llama"]["final"]
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape
        assert np.abs(got[k] - w).max() <= PARAM_TOL * max(np.abs(w).max(), 1e-6), k
    model = jllama.llama_tiny(vocab_size=mp.VOCAB, max_len=mp.SEQ, dtype=jnp.float32)
    ids = jnp.asarray(mp.batches("llama", 2, 9, steps=1)["input_ids"][0])
    logits = model.apply({"params": tree}, ids)
    assert logits.shape == (2, mp.SEQ, mp.VOCAB) and bool(jnp.all(jnp.isfinite(logits)))
    ref = model.apply({"params": jax.tree_util.tree_map(
        jnp.asarray, flax.traverse_util.unflatten_dict(
            {tuple(k.split("/")): v for k, v in _flax_flat(want).items()}))}, ids)
    np.testing.assert_allclose(np.asarray(logits), np.asarray(ref), atol=1e-3)


def _flax_flat(state):
    from tf_operator_tpu_torch.models.weights import name_to_flax_path

    return {name_to_flax_path(k): v for k, v in state.items()}


# -- the pieces, one process ----------------------------------------------------


def test_collectives_without_a_line_are_the_plain_ops():
    r = np.random.default_rng(0)
    logits = torch.as_tensor(r.standard_normal((6, 11)), dtype=torch.float32)
    targets = torch.as_tensor(r.integers(0, 11, 6))
    for red in ("mean", "sum", "none"):
        torch.testing.assert_close(tpar.cross_entropy(logits, targets, None, red),
                                   torch.nn.functional.cross_entropy(logits, targets,
                                                                     reduction=red))
    assert torch.equal(tpar.argmax(logits, None), logits.argmax(-1))
    x = torch.ones(3, requires_grad=True)
    for fn in (tpar.copy_to, tpar.reduce_from, tpar.gather_last):
        assert fn(x, None) is x
    table = torch.as_tensor(r.standard_normal((11, 4)), dtype=torch.float32)
    assert torch.equal(tpar.vocab_embed(table, targets, None), table[targets])


def test_embed_without_a_line_looks_up_and_attends_as_before():
    cfg = TransformerConfig(vocab_size=10, hidden=4, n_heads=1, head_dim=4, dtype=torch.float32)
    emb = Embed(cfg, trainable=True)
    torch.nn.init.normal_(emb.embedding)
    ids = torch.tensor([[1, 9, 0]])
    assert torch.equal(emb(ids), emb.embedding[ids])
    x = torch.randn(1, 3, 4)
    torch.testing.assert_close(emb.attend(x), x @ emb.embedding.t())


# -- the entries as jobs of the reference's harness ---------------------------------


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


def _wait_succeeded(store, name, timeout=240.0):
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


ENTRIES = {
    "t5": ("tf_operator_tpu_torch.t5_multihost",
           ["--model", "t5_tiny", "--steps", "6", "--batch-per-device", "2", "--enc-len", "16",
            "--dec-len", "8"]),
    "vit": ("tf_operator_tpu_torch.vit_classify",
            ["--model", "vit_tiny", "--steps", "4", "--batch-per-device", "4"]),
}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_entry_tensor_parallel_across_two_processes(local_harness, entry):
    """The port's counterpart of the reference's
    ``test_t5_tensor_parallel_across_two_processes``: two workers, tp=2 in
    both logs, the same loss trajectory on both."""

    from tests.testutil import new_job
    from tf_operator_tpu.api.types import ReplicaType, SuccessPolicy

    store, backend = local_harness
    module, argv = ENTRIES[entry]
    name = f"port{entry}tp"
    job = new_job(name=name, worker=2, command=[
        sys.executable, "-m", module, "--device", "cpu", "--steps-per-sync", "1", "--tp", "2",
        *argv])
    job.spec.replica_specs[ReplicaType.WORKER].template.containers[0].env = {
        "OMP_NUM_THREADS": "1", "TPUJOB_NO_SUITE_RECORD": "1"}
    job.spec.success_policy = SuccessPolicy.ALL_WORKERS
    store.create(job)
    done = _wait_succeeded(store, name)
    assert done.status.replica_statuses[ReplicaType.WORKER].succeeded == 2
    logs = [backend.pod_log("default", f"{name}-worker-{i}") for i in (0, 1)]
    assert all("dp=1 tp=2" in log for log in logs), logs[0][-2000:]
    pairs = [re.search(r"loss ([\d.]+) -> ([\d.]+)", log).groups() for log in logs]
    assert pairs[0] == pairs[1]
    if entry == "vit":
        assert all("ex/s global" in log for log in logs)


@pytest.mark.parametrize("shape", [{"dp": 2, "tp": 2}, {"dp": 2, "fsdp": 2, "tp": 2}],
                         ids=["dp2-tp2", "dp2-fsdp2-tp2"])
def test_grad_sync_ledger_is_the_jax_ledger_on_a_tp_mesh(shape):
    """The plan sums over the batch axes only, but its byte ledger stays
    the JAX plan's on a mesh over two slices with tp in it: built from
    the whole shapes and the logical specs, leaves in flax order."""

    import flax
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.parallel import collectives as jcoll
    from tf_operator_tpu.parallel import make_mesh as j_make_mesh
    from tf_operator_tpu.parallel import sharding as jsharding
    from tf_operator_tpu_torch.models.llama import LlamaLM
    from tf_operator_tpu_torch.parallel import collectives, mesh, sharding

    n = int(np.prod(list(shape.values())))
    jm = j_make_mesh(shape, devices=jax.devices()[:n], slices=2)
    jmodel = mp._jax_model("llama", jm)
    abstract = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                  jnp.zeros((n, 8), jnp.int32)))["params"]
    with jm, fnn.logical_axis_rules(list(jsharding.LOGICAL_RULES)):
        shardings = jsharding.logical_shardings(abstract, jm)
    want = jcoll.build_grad_sync_plan(abstract, shardings, jm).ledger()

    model = LlamaLM(mp.PORT["llama"][1](torch.float32), device="meta", trainable=True)
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    pm = mesh.make_mesh(shape, world=n, slices=2)
    specs = sharding.logical_shardings(shapes, pm)
    order = sorted(shapes, key=lambda k: tuple(model.flax_path(k).split("/")))
    plan = collectives.build_grad_sync_plan([(shapes[k], torch.float32) for k in order],
                                            [specs[k] for k in order], pm)
    assert plan.ledger() == want
    # and the sum leaves tp out: its ranks hold shards or equal gradients
    assert "tp" in plan.ici and "tp" not in plan.summed
    assert len(flax.traverse_util.flatten_dict(abstract)) == len(order)
