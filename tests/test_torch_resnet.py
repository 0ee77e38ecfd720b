"""The port's ResNet training path against the JAX package's, on the CPU.

The flax variables of the JAX model are carried across
(``resnet_state_from_flax``, loaded with ``strict=True``) and both sides
get the same numpy batch.  ``norm="fused"`` runs the JAX kernel through
``norm_impl="interpret"`` and the port's plain K5 / K6; ``"batchnorm"``
runs both stock graphs.  At width 8, float32:

- train-mode logits atol 1e-3, whole-model gradients of the
  cross-entropy relative l2 <= 1e-3 and the running statistics after the
  step atol 1e-5 (the tolerances of ``tests/test_fused_batchnorm.py``'s
  whole-model test: reduction-order noise compounds through the layers);
- eval-mode logits against ``train=False`` from the updated statistics,
  atol 1e-3;
- 36 px as well as 32 px, so that flax's ``"SAME"`` padding is pinned
  where it is (1, 1) as well as (0, 1);
- one and two trainer steps (clip -> sgd with momentum) against
  ``jax.value_and_grad`` and the JAX package's optax chain: loss rtol
  1e-4, parameters atol 1e-5;
- the entry point, the initialiser's laws and the padding rule.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tf_operator_tpu.models import resnet as jresnet
from tf_operator_tpu.parallel.trainer import TrainerConfig as JTrainerConfig
from tf_operator_tpu.parallel.trainer import make_optimizer as j_make_optimizer

from tf_operator_tpu_torch import resnet_dp
from tf_operator_tpu_torch.models import resnet
from tf_operator_tpu_torch.ops import fused_batchnorm as fb
from tf_operator_tpu_torch.parallel.trainer import (
    Trainer,
    TrainerConfig,
    batchnorm_cross_entropy_loss,
)

torch.set_num_threads(2)

MODELS = {"resnet18": (jresnet.resnet18, resnet.resnet18),
          "resnet50": (jresnet.resnet50, resnet.resnet50)}


def _pair(name, norm, image=32, classes=10):
    jfn, tfn = MODELS[name]
    jkw = dict(norm="fused", norm_impl="interpret") if norm == "fused" else {}
    jmodel = jfn(num_classes=classes, width=8, dtype=jnp.float32, **jkw)
    r = np.random.RandomState(0)
    batch = {"image": r.rand(4, image, image, 3).astype(np.float32),
             "label": r.randint(0, classes, size=(4,)).astype(np.int32)}
    variables = jmodel.init(jax.random.PRNGKey(0), batch["image"], train=False)
    variables = flax.core.unfreeze(variables)
    model = tfn(num_classes=classes, width=8, dtype=torch.float32, norm=norm, device="cpu")
    model.load_state_dict(resnet.resnet_state_from_flax(variables), strict=True)
    return jmodel, variables, model, batch


def _jloss(jmodel, batch):
    def loss(params, stats):
        logits, upd = jmodel.apply({"params": params, "batch_stats": stats}, batch["image"],
                                   train=True, mutable=["batch_stats"])
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, batch["label"]).mean()
        return ce, (logits, upd["batch_stats"])

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel_l2(got, want):
    keys = sorted(want)
    a = np.concatenate([got[k].ravel() for k in keys])
    b = np.concatenate([want[k].ravel() for k in keys])
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("norm", ["batchnorm", "fused"])
@pytest.mark.parametrize("name,image", [("resnet18", 32), ("resnet50", 32), ("resnet18", 36)])
def test_train_step_matches_jax(name, image, norm):
    jmodel, v, model, batch = _pair(name, norm, image)
    (jl, (jlogits, jstats)), jgrads = _jloss(jmodel, batch)(v["params"], v["batch_stats"])

    fb.plain_calls.clear()
    model.train()
    logits = model(_tbatch(batch)["image"])
    loss, _ = batchnorm_cross_entropy_loss(model, _tbatch(batch))
    n_norms = len(model.norms())
    if norm == "fused":
        assert fb.plain_calls[fb.KERNEL_FWD] == 2 * n_norms
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=1e-3)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-4)
    loss.backward()
    if norm == "fused":
        assert fb.plain_calls[fb.KERNEL_BWD] == n_norms
    want = {k: t.numpy() for k, t in
            resnet.resnet_state_from_flax({"params": jgrads}).items()}
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    assert _rel_l2(got, want) <= 1e-3

    # running statistics: the model ran two train-mode forwards, the JAX
    # step one; rerun one forward from the carried state to compare
    model.load_state_dict(resnet.resnet_state_from_flax(v), strict=True)
    with torch.no_grad():
        model(_tbatch(batch)["image"])
    stats = resnet.resnet_state_from_flax({"params": {}, "batch_stats": jstats})
    state = model.state_dict()
    for k, t in stats.items():
        np.testing.assert_allclose(state[k].numpy(), t.numpy(), atol=1e-5, err_msg=k)

    # eval mode reads the updated running statistics and updates nothing
    v_upd = {"params": v["params"], "batch_stats": jstats}
    before = {k: t.clone() for k, t in model.state_dict().items()}
    model.eval()
    with torch.no_grad():
        ev = model(_tbatch(batch)["image"])
    np.testing.assert_allclose(
        ev.numpy(), np.asarray(jmodel.apply(v_upd, batch["image"], train=False)), atol=1e-3)
    assert all(torch.equal(before[k], t) for k, t in model.state_dict().items())


def test_trainer_steps_match_jax_sgd():
    """Two trainer steps (clip 1.0 -> sgd lr 0.1, momentum 0.9) against
    jax.value_and_grad and the JAX package's optax chain, fused norms."""

    jmodel, v, model, batch = _pair("resnet18", "fused")
    opt = j_make_optimizer(JTrainerConfig(optimizer="sgd", learning_rate=0.1))
    params, stats = v["params"], v["batch_stats"]
    opt_state = opt.init(params)
    step = _jloss(jmodel, batch)
    trainer = Trainer(model, TrainerConfig(optimizer="sgd", learning_rate=0.1),
                      batchnorm_cross_entropy_loss)
    for _ in range(2):
        (jl, (_, stats)), grads = step(params, stats)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        m = trainer.train_step(batch)
        np.testing.assert_allclose(m["loss"].item(), float(jl), rtol=1e-4)
        np.testing.assert_allclose(m["grad_norm"].item(), float(optax.global_norm(grads)),
                                   rtol=1e-3)
    want = resnet.resnet_state_from_flax({"params": params, "batch_stats": stats})
    state = model.state_dict()
    for k, t in want.items():
        np.testing.assert_allclose(state[k].numpy(), t.numpy(), atol=1e-5, err_msg=k)
    ev = trainer.eval_step(batch)
    assert set(ev) == {"loss", "accuracy"} and np.isfinite(ev["loss"].item())
    assert all(torch.equal(state[k], t) for k, t in model.state_dict().items())


@pytest.mark.parametrize("name", sorted(MODELS))
def test_state_keys_and_initialiser(name):
    jmodel, v, model, _ = _pair(name, "batchnorm")
    state = resnet.resnet_state_from_flax(v)
    assert set(state) == set(model.state_dict())
    for k, t in state.items():
        assert tuple(t.shape) == tuple(model.state_dict()[k].shape), k
    resnet.init_resnet(model, 0)
    n_norms = 53 if name == "resnet50" else 20
    assert len(model.norms()) == n_norms
    zeros = [k for k, p in model.named_parameters()
             if k.endswith(".scale") and not torch.any(p != 0)]
    n_blocks = 16 if name == "resnet50" else 8
    assert len(zeros) == n_blocks  # each block's last norm starts at zero
    for k, p in model.named_parameters():
        if k.endswith(".kernel"):
            fan_in = p.shape[0] if p.ndim == 2 else int(np.prod(p.shape[1:]))
            std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
            assert float(p.detach().abs().max()) <= 2 * std * (1 + 1e-6)
            if p.numel() >= 2000:
                assert abs(float(p.detach().std()) / np.sqrt(1.0 / fan_in) - 1) < 0.1, k


def test_initialiser_is_seeded():
    a = resnet.init_resnet(resnet.resnet18(10, width=8, device="cpu"), 3).state_dict()
    b = resnet.init_resnet(resnet.resnet18(10, width=8, device="cpu"), 3).state_dict()
    c = resnet.init_resnet(resnet.resnet18(10, width=8, device="cpu"), 4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv_init.kernel"], c["conv_init.kernel"])


@pytest.mark.parametrize("size,k,s,want", [(112, 3, 2, (0, 1)), (9, 3, 2, (1, 1)),
                                            (56, 3, 1, (1, 1)), (56, 1, 2, (0, 0)),
                                            (9, 1, 2, (0, 0)), (7, 3, 2, (1, 1))])
def test_same_padding_is_flax_rule(size, k, s, want):
    assert resnet.same_padding(size, k, s) == want
    pads = jax.lax.padtype_to_pads((size,), (k,), (s,), "SAME")
    assert tuple(pads[0]) == want


def test_model_options_are_validated():
    with pytest.raises(ValueError, match="norm must be"):
        resnet.resnet18(10, width=8, norm="layernorm", device="cpu")
    with pytest.raises(ValueError, match="plain_kernels"):
        resnet.resnet18(10, width=8, plain_kernels=True, device="cpu")


def test_entry_point_trains_on_the_cpu(capsys):
    argv = ["--device", "cpu", "--model", "resnet18", "--image-size", "32", "--num-classes",
            "10", "--batch-per-device", "8", "--steps", "20", "--norm", "fused"]
    assert resnet_dp.main(argv) == 0
    out = capsys.readouterr().out
    assert "resnet18 dp=1 fsdp=1 norm=fused: " in out and "ex/s global" in out
    first, last = out.split("loss ")[1].split("\n")[0].split(" -> ")
    assert float(last) < float(first)


def test_entry_point_refuses_fsdp():
    with pytest.raises(SystemExit) as exc:
        resnet_dp.parse_args(["--device", "cpu", "--fsdp", "2"])
    assert exc.value.code == 2


def test_entry_point_defaults_to_cuda_and_the_reference_norm():
    args = resnet_dp.parse_args([])
    assert (args.device, args.norm, args.model, args.image_size, args.fsdp) == (
        "cuda", "batchnorm", "resnet50", 224, 1)
