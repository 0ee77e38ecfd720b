"""``serve_lm`` and the model descriptions over the decoder zoo (gpt,
llama, moe) against the JAX package, on the CPU.

- ``model.json`` both ways: the port's ``describe_model`` writes the JAX
  package's dict for each family, the port rebuilds the family and config
  from the JAX-written one, and the JAX ``model_from_description``
  rebuilds the port-written one; a ``max_len`` above a learned table's
  trained length is refused on both sides (rope extends).
- ``serve_lm --artifact`` of a JAX-written gpt and moe artifact (vocab
  256, float32): ``/generate``'s greedy sample equal to JAX ``generate``'s
  bytes, through the chunked decoder and, after the JAX server's
  fallback line, the contiguous slot pool (``--batching 2``); the
  records' ``model`` label is the family; ``--speculative`` and
  ``--roles`` with a prefill replica fail with the JAX server's errors.
- A port-trained artifact (``export_params``) read by the JAX package:
  JAX ``generate`` on it equal to the port's on the exported model.
- The artifact checks: ``serve_lm``'s main exits on a vocab other than
  256 before any weight is read, a ``--max-len`` above the trained
  length is capped with the JAX server's line, one below a learned
  table's trained length is refused on both sides; the seeded
  ``--model`` shapes of the zoo, and the int8 line of a moe model (the
  quantized bytes, the weights then held dequantized).
"""

import json
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.models import llama_tiny as j_llama_tiny
from tf_operator_tpu.models.decode import generate as j_generate
from tf_operator_tpu.models.registry import describe_model as j_describe_model
from tf_operator_tpu.models.registry import model_from_description as j_from_description

import torch_zoo as zoo
from tf_operator_tpu_torch import resolve_device, serve_lm
from tf_operator_tpu_torch.models.batching import ContinuousBatchingDecoder
from tf_operator_tpu_torch.models.decode import ChunkedServingDecoder, generate
from tf_operator_tpu_torch.models.gpt import CausalLM
from tf_operator_tpu_torch.models.llama import LlamaLM, llama_tiny
from tf_operator_tpu_torch.models.moe import MoeLM
from tf_operator_tpu_torch.models.registry import describe_model, model_from_description
from tf_operator_tpu_torch.models.weights import init_params
from tf_operator_tpu_torch.parallel.checkpoint import export_params
from tf_operator_tpu_torch.parallel.trainer import Trainer, TrainerConfig

torch.set_num_threads(2)

MAX_LEN = 64
CPU = resolve_device("cpu")


def _jax_and_port(family):
    """(JAX model, port model class, port config) at vocab 256."""

    if family == "llama":
        return (j_llama_tiny(vocab_size=256, max_len=MAX_LEN), LlamaLM,
                llama_tiny(vocab_size=256, max_len=MAX_LEN))
    return (zoo.jax_model(family, jnp.bfloat16, vocab=256), zoo.PORT_CLS[family],
            zoo.port_config(family, torch.bfloat16, vocab=256))


@pytest.mark.parametrize("family", ["gpt", "llama", "moe"])
def test_descriptions_round_trip_both_ways(family):
    jm, cls, cfg = _jax_and_port(family)
    d = describe_model(cls(cfg, device="meta"))
    assert json.loads(json.dumps(d)) == d
    assert d == j_describe_model(jm)
    assert model_from_description(json.loads(json.dumps(j_describe_model(jm)))) == (cls, cfg)
    rebuilt = j_from_description(d)
    assert type(rebuilt) is type(jm) and j_describe_model(rebuilt) == d


@pytest.mark.parametrize("family", ["gpt", "llama", "moe"])
def test_max_len_past_a_learned_table_is_refused_on_both_sides(family):
    jm, cls, cfg = _jax_and_port(family)
    d = j_describe_model(jm)
    if family == "llama":
        assert model_from_description(d, max_len=2 * MAX_LEN)[1].max_len == 2 * MAX_LEN
        return
    with pytest.raises(ValueError, match="learned position table") as got:
        model_from_description(d, max_len=MAX_LEN + 1)
    with pytest.raises(ValueError) as want:
        j_from_description(d, max_len=MAX_LEN + 1)
    assert str(got.value) == str(want.value)
    assert model_from_description(d, max_len=32)[1] is not None


@pytest.fixture(scope="module", params=["gpt", "moe"])
def artifact(request, tmp_path_factory):
    family = request.param
    params = zoo.jax_params(family, seed=3, vocab=256)
    jm = zoo.jax_model(family, vocab=256)
    path = zoo.save_jax_artifact(jm, params, tmp_path_factory.mktemp(family))
    return family, jm, params, path


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                 data=json.dumps(body).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def _jax_sample(jm, params, prompt, n):
    ids = np.frombuffer(prompt.encode(), np.uint8).astype(np.int32)[None]
    out = np.asarray(j_generate(jm, params, jnp.asarray(ids), max_new_tokens=n))
    return serve_lm.decode_bytes(out[0, ids.shape[1]:])


@pytest.mark.parametrize("batching", [0, 2], ids=["chunked", "contiguous"])
def test_serve_lm_serves_a_jax_artifact(artifact, batching, capsys):
    family, jm, params, path = artifact
    args = serve_lm.build_parser().parse_args([
        "--device", "cpu", "--artifact", path, "--batching", str(batching),
        "--max-len", str(MAX_LEN)])
    cls, cfg = serve_lm.artifact_model(path, MAX_LEN)
    assert cls is zoo.PORT_CLS[family]
    model = serve_lm.load_model(CPU, max_len=args.max_len, artifact=path)
    assert type(model) is cls and model.cfg.dtype == torch.float32  # the artifact's
    capsys.readouterr()
    decoder = serve_lm.build_decoder(model, args)
    line = capsys.readouterr().out
    if batching:
        assert type(decoder) is ContinuousBatchingDecoder and decoder.slots == 2
        assert line.startswith("paged pool unavailable (") and line.strip().endswith(
            "); serving the contiguous slot pool")
        assert decoder.model_label == family
    else:
        assert isinstance(decoder, ChunkedServingDecoder)
    server = serve_lm.Server(decoder, model_label=serve_lm.model_label_of(args)).start()
    try:
        for prompt in ("the sharded ", "a longer prompt of bytes: 0123456789"):
            got = _post(server.port, {"prompt": prompt, "max_new_tokens": 12})
            assert got["sample"] == _jax_sample(jm, params, prompt, 12), prompt
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/metrics") as resp:
            text = resp.read().decode()
        assert f'model="{family}"' in text
    finally:
        server.close()


def test_artifact_lines_and_checks(artifact, capsys, tmp_path):
    family, jm, params, path = artifact
    serve_lm.load_model(CPU, max_len=4 * MAX_LEN, artifact=path)
    out = capsys.readouterr().out
    assert out == f"capping --max-len to trained length {MAX_LEN}\n"
    # below the trained length the learned table no longer fits: the
    # JAX package refuses the same (flax's parameter shape check)
    with pytest.raises(ValueError, match="pos_embed: shape"):
        serve_lm.load_model(CPU, max_len=MAX_LEN // 2, artifact=path)
    small = j_from_description(j_describe_model(jm), max_len=MAX_LEN // 2)
    with pytest.raises(Exception, match="pos_embed"):
        small.apply({"params": params}, jnp.zeros((1, 4), jnp.int32))
    desc = json.loads(open(f"{path}/model.json").read())
    desc["config"]["vocab_size"] = 128
    (tmp_path / "model.json").write_text(json.dumps(desc))
    with pytest.raises(SystemExit, match="byte-level \\(vocab 256\\); the artifact was "
                                         "trained with vocab 128"):
        serve_lm.main(["--device", "cpu", "--artifact", str(tmp_path), "--port", "0"])


def test_speculative_and_roles_are_refused(artifact):
    from tests.testutil import load_serve_lm

    family, jm, params, path = artifact
    model = serve_lm.load_model(CPU, max_len=MAX_LEN, artifact=path)
    for flags, jkw, prefix in (
            (["--speculative"], {"speculative": True}, "--speculative requires the paged pool: "),
            (["--roles", "prefill=1,decode=1"], {"roles": ["prefill", "decode"], "replicas": 2},
             "--roles requires the paged pool: ")):
        with pytest.raises(ValueError) as want:
            load_serve_lm().build_handler(jm, params, MAX_LEN, batching_slots=2,
                                          paged_kernel="off", **jkw)
        args = serve_lm.build_parser().parse_args(
            ["--device", "cpu", "--artifact", path, "--batching", "2"] + flags)
        with pytest.raises(ValueError) as got:
            serve_lm.build_decoder(model, args, draft=model)
        assert str(got.value).startswith(prefix) and str(want.value).startswith(prefix)
        assert f"{type(model).__name__} is not pageable" in str(got.value)


@pytest.mark.parametrize("family", ["gpt", "moe"])
def test_a_port_artifact_serves_in_the_jax_package(family, tmp_path):
    cfg = zoo.port_config(family, vocab=256, dropout=0.0)
    cls = zoo.PORT_CLS[family]
    model = cls.from_state_dict(cfg, init_params(cfg, 2, "cpu", trainable=True, family=cls),
                                "cpu", trainable=True)
    trainer = Trainer(model, TrainerConfig(learning_rate=1e-2), zoo.PORT_LOSS[family])
    trainer.train_step({"input_ids": zoo.ids(4, (2, 16), vocab=256)})
    export_params(trainer, str(tmp_path))
    desc = json.loads((tmp_path / "model.json").read_text())
    jm = j_from_description(desc)
    flat = np.load(tmp_path / "params.npz")
    tree = {}
    for key in flat.files:
        node = tree
        *parts, leaf = key.split("/")
        for p in parts:
            node = node.setdefault(p, {})
        node[leaf] = flat[key]
    prompt = zoo.ids(5, (1, 6), vocab=256)
    want = np.asarray(j_generate(jm, tree, jnp.asarray(prompt), max_new_tokens=8))
    served = serve_lm.load_model(CPU, max_len=MAX_LEN, artifact=str(tmp_path))
    got = generate(served, torch.as_tensor(prompt), 8).numpy()
    # both serve the exported float32 weights: the same tokens
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,cls", [("gpt-tiny", CausalLM), ("moe-tiny", MoeLM),
                                      ("gpt-small", CausalLM), ("moe-gpt-small", MoeLM)])
def test_seeded_zoo_shapes(name, cls):
    build = serve_lm.SEEDED_MODELS[name]
    got_cls, cfg = build(128)
    assert got_cls is cls
    base = getattr(cfg, "base", cfg)
    assert base.vocab_size == 256 and base.max_len == 128
    if name.endswith("small"):
        assert (base.hidden, base.n_heads, base.head_dim, base.n_layers, base.mlp_dim) == (
            768, 12, 64, 12, 3072)
    if name == "moe-gpt-small":
        assert cfg.num_experts == 8
    choices = next(a.choices for a in serve_lm.build_parser()._actions
                   if a.option_strings == ["--model"])
    assert name in choices


def test_seeded_moe_int8_counts_the_quantized_bytes(capsys):
    model = serve_lm.load_model(CPU, max_len=64, model="moe-tiny", quantize="int8")
    line = capsys.readouterr().out.strip()
    before, after = (float(x.split(" MB")[0]) for x in line.split("params ")[1].split(" -> "))
    assert line.startswith("int8 weights-only quantization: params") and after < before / 1.5
    # held dequantized: no int8 kernel in the model
    assert not any(n.endswith("kernel_q") for n, _ in model.named_buffers())
    gpt = serve_lm.load_model(CPU, max_len=64, model="gpt-tiny", quantize="int8")
    assert sum(n.endswith("kernel_q") for n, _ in gpt.named_buffers()) == 2 * 6
