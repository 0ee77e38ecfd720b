"""The port's mesh, shardings and grad-sync plan against the JAX
package's, on the CPU, with no processes: the JAX side runs on the 8
virtual CPU devices, the port's rank arrays are built for a world of 8.

- ``make_mesh``'s rank array equals the device ids of the JAX
  ``make_mesh(...).devices`` (and ``mesh_axis_links``, ``slice_count``,
  ``data_parallel_size`` agree) for a table of shapes, with and without
  ``slices``; the refusals are the same errors;
- ``fsdp_spec`` / ``fsdp_shardings`` give the JAX dimensions for every
  ``MnistCNN`` and ResNet-18 parameter, and ``logical_shardings`` the
  JAX ``Trainer(shardings="logical")`` layout for every ``llama_tiny``
  parameter, at fsdp 2 and 4;
- ``GradSyncPlan.ledger()`` equals the JAX ledger for the same tree and
  mesh, and the trainer's leaf order is the JAX flatten order;
- the stage collectives are fixed per backend, with no host copy.
"""

import copy
import dataclasses

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models import MnistCNN as JMnist
from tf_operator_tpu.models import llama_tiny as j_llama_tiny
from tf_operator_tpu.models import resnet as jresnet
from tf_operator_tpu.parallel import collectives as jcoll
from tf_operator_tpu.parallel import mesh as jmesh
from tf_operator_tpu.parallel import sharding as jsharding

from tf_operator_tpu_torch.models import resnet
from tf_operator_tpu_torch.models.llama import LlamaLM, llama_tiny
from tf_operator_tpu_torch.models.mnist import MnistCNN
from tf_operator_tpu_torch.models.weights import flax_path_to_name
from tf_operator_tpu_torch.parallel import collectives, mesh, sharding
from tf_operator_tpu_torch.parallel.trainer import _flax_key, _flax_orders

torch.set_num_threads(2)

MESH_CASES = [
    ({"dp": 8}, 1), ({"dp": 2, "fsdp": 4}, 1), ({"dp": 2, "fsdp": 4}, 2),
    ({"dp": 4, "fsdp": -1}, 2), ({"dp": -1}, 4), ({"sp": 1, "fsdp": 8}, 1),
    ({"fsdp": -1, "tp": 2}, 1), ({"dp": 2, "fsdp": 2, "tp": 2}, 2),
    ({"pp": 2, "dp": 2, "sp": 2}, 2), ({"dp": 2, "ep": 2, "tp": 2}, 1), (None, 1), (None, 2),
]


def _ids(m):
    return np.vectorize(lambda d: d.id)(m.devices)


@pytest.mark.parametrize("shape,slices", MESH_CASES, ids=lambda v: str(v))
def test_rank_array_matches_the_jax_mesh(shape, slices):
    j = jmesh.make_mesh(shape, slices=slices)
    t = mesh.make_mesh(shape, slices=slices, world=8)
    np.testing.assert_array_equal(t.ranks, _ids(j))
    assert t.axis_names == j.axis_names
    assert t.shape == dict(j.shape)
    assert mesh.mesh_axis_links(t) == jmesh.mesh_axis_links(j)
    assert mesh.slice_count(t) == jmesh.slice_count(j)
    assert mesh.data_parallel_size(t) == jmesh.data_parallel_size(j)
    assert collectives.ici_axes(t) == jcoll.ici_axes(j)
    for gb in (16, 24):
        ok = gb % mesh.data_parallel_size(t) == 0
        if ok:
            assert mesh.local_batch_size(t, gb) == jmesh.local_batch_size(j, gb)
        else:
            with pytest.raises(ValueError):
                mesh.local_batch_size(t, gb)


def test_lines_and_batch_index():
    t = mesh.make_mesh({"dp": 2, "fsdp": -1}, slices=2, world=8)
    assert t.line(("fsdp",), 5) == [4, 5, 6, 7]
    assert t.line(("dp",), 5) == [1, 5]
    assert t.line(mesh.BATCH_AXES, 5) == list(range(8))
    assert [t.index(mesh.BATCH_AXES, r) for r in range(8)] == list(range(8))
    assert t.group(("fsdp",)) is None  # no world joined


REFUSALS = [
    ({"dp": 3}, None), ({"dp": -1, "fsdp": -1}, None), ({"dp": 3, "fsdp": -1}, None),
    ({"bogus": 2}, None), ({"dp": 1, "fsdp": 8}, 2), ({"dp": 2, "fsdp": 4}, 3),
    ({"dp": 2, "tp": 4}, 4),
]


@pytest.mark.parametrize("shape,slices", REFUSALS, ids=lambda v: str(v))
def test_refusals_match(shape, slices):
    with pytest.raises(ValueError) as jerr:
        jmesh.make_mesh(shape, slices=slices)
    with pytest.raises(ValueError) as terr:
        mesh.make_mesh(shape, slices=slices, world=8)
    assert str(terr.value) == str(jerr.value)


def test_slice_count_from_the_environment(monkeypatch):
    monkeypatch.setenv("MEGASCALE_NUM_SLICES", "2")
    t = mesh.make_mesh({"dp": 2, "fsdp": -1}, world=4)
    assert mesh.slice_count(t) == 2
    assert mesh.mesh_axis_links(t) == {"pp": "ici", "dp": "dcn", "fsdp": "ici", "ep": "ici",
                                       "sp": "ici", "tp": "ici"}


def _jspec(sh, ndim):
    spec = tuple(sh.spec) + (None,) * (ndim - len(sh.spec))
    return tuple(tuple(e) if isinstance(e, list) else e for e in spec)


def _jax_fsdp(params, fsdp):
    jm = jmesh.make_mesh({"fsdp": fsdp}, devices=jax.devices()[:fsdp])
    sh = flax.traverse_util.flatten_dict(jsharding.fsdp_shardings(params, jm), sep="/")
    return {p: _jspec(sh[p], np.ndim(a))
            for p, a in flax.traverse_util.flatten_dict(params, sep="/").items()}


@pytest.mark.parametrize("fsdp", [2, 4])
def test_fsdp_auto_rule_matches_the_jax_dims_for_mnist(fsdp):
    params = jax.eval_shape(lambda: JMnist().init(jax.random.PRNGKey(0),
                                                  jnp.zeros((1, 28, 28, 1)), train=False))
    params = flax.core.unfreeze(params)["params"]
    want = {p.replace("/", "."): s for p, s in _jax_fsdp(params, fsdp).items()}
    model = MnistCNN(device="meta")
    shapes = {n: p.shape for n, p in model.named_parameters()}
    got = sharding.fsdp_shardings(shapes, mesh.make_mesh({"fsdp": fsdp}, world=fsdp))
    assert got == want
    assert any(s != (None,) * len(s) for s in got.values())
    for n, s in shapes.items():
        d = sharding.fsdp_spec(s, fsdp)
        assert (d is None) == (got[n] == (None,) * len(s))


@pytest.mark.parametrize("fsdp", [2, 4])
def test_fsdp_auto_rule_matches_the_jax_dims_for_resnet(fsdp):
    jmodel = jresnet.resnet18(num_classes=10, width=8)
    v = flax.core.unfreeze(jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False)))
    want = _jax_fsdp(v["params"], fsdp)
    model = resnet.resnet18(10, width=8, device="meta")
    shapes = {n: p.shape for n, p in model.named_parameters()}
    got = sharding.fsdp_shardings(shapes, mesh.make_mesh({"fsdp": fsdp}, world=fsdp),
                                  flax_orders=_flax_orders(model))
    for n, spec in got.items():
        jspec = want[n.replace(".", "/")]
        if n.endswith(".kernel") and len(spec) == 4:  # OIHW against HWIO
            jspec = tuple(jspec[f] for f in resnet.Conv.flax_order["kernel"])
        assert spec == jspec, n
    assert any("fsdp" in s for s in got.values())


def _jax_llama(fsdp):
    jm = jmesh.make_mesh({"fsdp": fsdp}, devices=jax.devices()[:fsdp])
    model = j_llama_tiny(vocab_size=256, max_len=32, mesh=jm)
    ids = jnp.zeros((fsdp, 32), jnp.int32)
    abstract = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), ids, train=False))
    return jm, abstract["params"]


@pytest.mark.parametrize("fsdp", [2, 4])
def test_logical_shardings_match_the_jax_trainer_layout(fsdp):
    jm, abstract = _jax_llama(fsdp)
    with jm, fnn.logical_axis_rules(list(jsharding.LOGICAL_RULES)):
        sh = jsharding.logical_shardings(abstract, jm)
    sh = flax.traverse_util.flatten_dict(sh, sep="/")
    want = {flax_path_to_name(p): _jspec(sh[p], len(a.value.shape))
            for p, a in flax.traverse_util.flatten_dict(abstract, sep="/").items()}
    model = LlamaLM(llama_tiny(vocab_size=256, max_len=32), device="meta", trainable=True)
    shapes = {n: p.shape for n, p in model.named_parameters()}
    got = sharding.logical_shardings(shapes, mesh.make_mesh({"fsdp": fsdp}, world=fsdp))
    assert got == want
    assert sharding.LOGICAL_RULES == jsharding.LOGICAL_RULES
    assert sharding.MIN_SHARD_SIZE == jsharding.MIN_SHARD_SIZE


def test_trainer_leaf_order_is_the_jax_flatten_order():
    model = LlamaLM(dataclasses.replace(llama_tiny(vocab_size=256, max_len=32), n_layers=11),
                    device="meta", trainable=True)
    jm = j_llama_tiny(vocab_size=256, max_len=32)
    jm = type(jm)(dataclasses.replace(jm.cfg, n_layers=11))
    abstract = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                                              train=False))["params"]
    paths = ["/".join(str(k.key) for k in path if hasattr(k, "key"))
             for path, _ in jax.tree_util.tree_flatten_with_path(abstract)[0]]
    names = sorted((n for n, _ in model.named_parameters()), key=lambda n: _flax_key(model, n))
    assert [flax_path_to_name(p) for p in paths] == names
    assert names.index("layers.10.ln_self.scale") < names.index("layers.2.ln_self.scale")


LEDGER_MESHES = [({"dp": 2, "fsdp": -1}, 2), ({"dp": 4, "fsdp": -1}, 2), ({"dp": -1}, 2),
                 ({"dp": 2, "fsdp": -1}, 1), ({"dp": 8}, 4),
                 # sequence parallelism: sp is an ici axis the weights replicate over
                 ({"dp": 2, "sp": 2, "fsdp": -1}, 2), ({"sp": 2, "fsdp": -1}, 1)]


@pytest.mark.parametrize("shape,slices", LEDGER_MESHES, ids=lambda v: str(v))
@pytest.mark.parametrize("model", ["llama_tiny", "mnist"])
def test_grad_sync_ledger_equals_the_jax_ledger(model, shape, slices):
    jm = jmesh.make_mesh(shape, slices=slices)
    tm = mesh.make_mesh(shape, slices=slices, world=8)
    if model == "mnist":
        abstract = jax.eval_shape(lambda: JMnist().init(
            jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)), train=False))["params"]
        jsh = jsharding.fsdp_shardings(abstract, jm)
        tmodel = MnistCNN(device="meta")
        shapes = {n: p.shape for n, p in tmodel.named_parameters()}
        specs = sharding.fsdp_shardings(shapes, tm)
        to_name = lambda p: p.replace("/", ".")  # noqa: E731
    else:
        jl = j_llama_tiny(vocab_size=256, max_len=32, mesh=jm)
        abstract = jax.eval_shape(lambda: jl.init(jax.random.PRNGKey(0),
                                                  jnp.zeros((8, 32), jnp.int32),
                                                  train=False))["params"]
        with jm, fnn.logical_axis_rules(list(jsharding.LOGICAL_RULES)):
            jsh = jsharding.logical_shardings(abstract, jm)
        tmodel = LlamaLM(llama_tiny(vocab_size=256, max_len=32), device="meta", trainable=True)
        shapes = {n: p.shape for n, p in tmodel.named_parameters()}
        specs = sharding.logical_shardings(shapes, tm)
        to_name = flax_path_to_name
    want = jcoll.build_grad_sync_plan(abstract, jsh, jm).ledger()
    order = sorted(shapes, key=lambda n: _flax_key(tmodel, n))
    paths = ["/".join(str(k.key) for k in path if hasattr(k, "key"))
             for path, _ in jax.tree_util.tree_flatten_with_path(abstract)[0]]
    assert [to_name(p) for p in paths] == order
    plan = collectives.build_grad_sync_plan([(shapes[n], torch.float32) for n in order],
                                            [specs[n] for n in order], tm)
    assert plan.ledger() == want
    for bb in (1 << 10, 1 << 16):
        assert (collectives.build_grad_sync_plan(
            [(shapes[n], torch.float32) for n in order], [specs[n] for n in order], tm,
            bucket_bytes=bb).ledger()
            == jcoll.build_grad_sync_plan(abstract, jsh, jm, bucket_bytes=bb).ledger())


def test_stage_collectives_are_fixed_per_backend(monkeypatch):
    """What ``GradSyncPlan.apply`` calls, recorded: stage 1 a
    reduce-scatter over the intra-slice group, stage 2 an all-reduce
    over dp, stage 3 an all-gather over the intra-slice group; the flat
    mode one all-reduce over the batch axes; the direct route stages 1
    and 2.  The plan consults no backend, so gloo and NCCL get the same
    calls and no host copy."""

    import torch.distributed as dist

    calls = []

    def reduce_scatter_tensor(out, inp, group=None):
        calls.append(("reduce_scatter_tensor", group))
        out.copy_(inp[:out.shape[0]])

    def all_reduce(t, group=None):
        calls.append(("all_reduce", group))

    def all_gather_into_tensor(out, inp, group=None):
        calls.append(("all_gather_into_tensor", group))
        out.copy_(inp.repeat((out.shape[0] // inp.shape[0],) + (1,) * (inp.ndim - 1)))

    for name, fn in (("reduce_scatter_tensor", reduce_scatter_tensor),
                     ("all_reduce", all_reduce),
                     ("all_gather_into_tensor", all_gather_into_tensor)):
        monkeypatch.setattr(dist, name, fn)
    tm = mesh.make_mesh({"dp": 2, "fsdp": -1}, slices=2, world=8)
    monkeypatch.setattr(tm, "group", lambda axes: tuple(axes))
    leaves = [((8, 8), torch.float32), ((16, 4), torch.float32)]
    specs = [None, ("fsdp", None)]
    for mode, bucket in (("hierarchical", [("reduce_scatter_tensor", ("fsdp",)),
                                           ("all_reduce", ("dp",)),
                                           ("all_gather_into_tensor", ("fsdp",))]),
                         ("flat", [("all_reduce", ("dp", "fsdp"))])):
        plan = collectives.build_grad_sync_plan(leaves, specs, tm, mode=mode)
        calls.clear()
        out = plan.apply([torch.ones(8, 8), torch.ones(16, 4)])
        assert calls == [("reduce_scatter_tensor", ("fsdp",)), ("all_reduce", ("dp",))] + bucket
        assert out[0].shape == (8, 8) and out[1].shape == (4, 4)
        assert set(plan.stats.by_stage) >= {"stage1_reduce_scatter", "stage2_all_reduce"}


def test_unported_axes_are_refused():
    for shape, word in (({"pp": 2, "dp": 2}, "pipeline"),):
        with pytest.raises(NotImplementedError, match=word):
            sharding.check_mesh(mesh.make_mesh(shape, world=4))
    # sequence parallelism beside tensor or expert parallelism is ported
    sharding.check_mesh(mesh.make_mesh({"sp": 2, "tp": 2}, world=4))
    sharding.check_mesh(mesh.make_mesh({"sp": 2, "ep": 2}, world=4))
    sharding.check_mesh(mesh.make_mesh({"dp": 2, "fsdp": 2}, world=4))
    # tensor and expert parallelism are ported
    sharding.check_mesh(mesh.make_mesh({"fsdp": 2, "tp": 2}, world=4))
    sharding.check_mesh(mesh.make_mesh({"ep": 4}, world=4))
    # sequence parallelism is ported
    sharding.check_mesh(mesh.make_mesh({"sp": 2, "dp": 2}, world=4))
    sharding.check_mesh(mesh.make_mesh({"sp": 2, "fsdp": 2}, world=4))


@pytest.mark.parametrize("grad_sync", ["auto", "flat", "hierarchical"])
def test_trainer_grad_sync_option_on_a_one_rank_mesh(grad_sync):
    """``Trainer(grad_sync=)`` on a one-rank mesh: the plan it keeps (None
    under flat sync, as in the JAX trainer; auto is flat on one slice),
    and a step equal to the trainer without a mesh."""

    from tf_operator_tpu_torch.models.mnist import init_mnist
    from tf_operator_tpu_torch.parallel.trainer import (
        Trainer,
        TrainerConfig,
        batchnorm_cross_entropy_loss,
    )

    base = init_mnist(MnistCNN(dtype=torch.float32), 0)
    r = np.random.default_rng(0)
    batch = {"image": torch.as_tensor(r.standard_normal((4, 28, 28, 1)), dtype=torch.float32),
             "label": torch.as_tensor(r.integers(0, 10, 4))}
    cfg = TrainerConfig(optimizer="sgd", learning_rate=0.1)
    got = Trainer(copy.deepcopy(base), cfg, batchnorm_cross_entropy_loss,
                  mesh=mesh.make_mesh({"fsdp": 1}), grad_sync=grad_sync)
    want = Trainer(copy.deepcopy(base), cfg, batchnorm_cross_entropy_loss)
    assert got.grad_sync == ("flat" if grad_sync == "auto" else grad_sync)
    assert (got.grad_sync_plan is None) == (got.grad_sync == "flat")
    for _ in range(2):
        g, w = got.train_step(batch), want.train_step(batch)
        np.testing.assert_allclose(float(g["loss"]), float(w["loss"]), rtol=1e-6)
    for a, b in zip(got.params, want.params):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="grad_sync"):
        Trainer(copy.deepcopy(base), cfg, batchnorm_cross_entropy_loss,
                mesh=mesh.make_mesh({"fsdp": 1}), grad_sync="ring")
