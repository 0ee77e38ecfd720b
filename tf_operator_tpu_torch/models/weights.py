"""The weight bridge between the flax param tree and the port's
``state_dict``, and seeded initialisation at the flax init scales.

Flax paths (as ``llama_tiny`` produces them) and port names:

    tok_embed/embedding                      tok_embed.embedding
    layer_i/ln_self/RMSNorm_0/scale          layers.i.ln_self.scale
    layer_i/self_attn/{query,key,value,out}/kernel
                                             layers.i.self_attn.{...}.kernel
    layer_i/ln_mlp/RMSNorm_0/scale           layers.i.ln_mlp.scale
    layer_i/mlp/{wi_gate,wi_up,wo}/kernel    layers.i.mlp.{...}.kernel
    ln_final/RMSNorm_0/scale                 ln_final.scale
    lm_head/kernel                           lm_head.kernel

and, for the gpt and moe families, which name their parameters the
same way (models/gpt.py, models/moe.py):

    pos_embed                                pos_embed
    layer_i/self_attn/{...}/bias             layers.i.self_attn.{...}.bias
    layer_i/mlp/{wi,wo}/{kernel,bias}        layers.i.mlp.{wi,wo}.{...}
    layer_i/moe/router/kernel                layers.i.moe.router.kernel
    layer_i/moe/{wi,wo}                      layers.i.moe.{wi,wo}

Shapes are unchanged (the port keeps the flax layout), so the bridge is
a renaming, both ways at float32 (and one way for a tree that
``quantize_tree`` made: its ``QTensor`` leaves become the port's): a
flax tree becomes a state_dict that
``LlamaLM.from_state_dict`` loads into a serving model (each entry cast
once to its storage dtype, which gives the numbers flax's cast at use
gives) or into a trainable one (float32 masters); a state_dict becomes
a flat flax-path npz (:func:`save_npz`), the ``params.npz`` of the
artifact ``serve_lm --artifact`` reads.

The encoder families (BERT, T5, ViT) name their parameters by the flax
path itself, joined by dots, less the norms' ``LayerNorm_0`` /
``RMSNorm_0`` scope (``bert.layer_0.ln_attn.scale``):
:func:`family_state_from_flax` bridges them (the model's ``flax_path``
is the inverse, putting the scope back), and :func:`init_params` draws
any family's state.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Mapping

import numpy as np
import torch

from tf_operator_tpu_torch.ops.quant import QTensor, eligible, quantize_param

_NORM = "RMSNorm_0"
#: the scopes flax's norm modules put under the reference's LayerNorm wrapper
_NORM_SCOPES = ("LayerNorm_0", "RMSNorm_0")


def _flatten(tree, prefix: str = "") -> Dict[str, object]:
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            # flax LogicallyPartitioned / Partitioned boxes carry .value
            if not isinstance(value, np.ndarray) and hasattr(value, "value"):
                value = value.value
            out[path] = value
    return out


def flax_path_to_name(path: str) -> str:
    parts = [p for p in path.split("/") if p != _NORM]
    if parts[0].startswith("layer_"):
        parts = ["layers", parts[0][len("layer_"):]] + parts[1:]
    return ".".join(parts)


def name_to_flax_path(name: str) -> str:
    parts = name.split(".")
    if parts[0] == "layers":
        parts = [f"layer_{parts[1]}"] + parts[2:]
    if parts[-1] == "scale":
        parts = parts[:-1] + [_NORM, "scale"]
    return "/".join(parts)


def _from_leaf(value):
    # a JAX QTensor (quantize_tree's leaf) is known by its fields, with no
    # import of the JAX package
    if hasattr(value, "q") and hasattr(value, "scale"):
        return QTensor(torch.tensor(np.asarray(value.q)), torch.tensor(np.asarray(value.scale)))
    return torch.tensor(np.asarray(value))


def from_flax_params(tree) -> Dict[str, object]:
    """Flax params (nested dicts of arrays, boxed or not, or one flat
    dict keyed by "/" paths, as an npz holds them; quantized leaves
    allowed) -> the port's state_dict of float tensors and QTensors on
    the CPU."""

    return {flax_path_to_name(path): _from_leaf(value)
            for path, value in _flatten(tree).items()}


def to_flax_params(state: Mapping[str, torch.Tensor]) -> Dict[str, object]:
    """The inverse of :func:`from_flax_params`: nested dicts of numpy
    float32 arrays."""

    tree: Dict[str, object] = {}
    for name, t in state.items():
        parts = name_to_flax_path(name).split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t.detach().to("cpu", torch.float32).numpy()
    return tree


def family_state_from_flax(tree) -> Dict[str, torch.Tensor]:
    """An encoder family's flax params (nested dicts of arrays, boxed or
    not) -> its state_dict of float tensors on the CPU: each path joined
    by dots, the norms' scope dropped."""

    return {".".join(p for p in path.split("/") if p not in _NORM_SCOPES):
            torch.tensor(np.asarray(value))
            for path, value in _flatten(tree).items()}


def mnist_state_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``MnistCNN``'s ``params`` as the port's ``MnistCNN``
    state_dict (models/mnist.py): the scope path joined by dots, each
    array as it is (the port keeps the flax layout)."""

    return {path.replace("/", "."): torch.from_numpy(np.array(a, dtype=np.float32))
            for path, a in _flatten(params).items()}


def save_npz(state: Mapping[str, torch.Tensor], path: str) -> None:
    """Write ``state`` as an npz of flat flax-path keys (float32),
    through a temporary file so a reader never sees half of it."""

    tmp = f"{path}.tmp.npz"
    np.savez(tmp, **{name_to_flax_path(name): t.detach().to("cpu", torch.float32).numpy()
                     for name, t in state.items()})
    os.replace(tmp, path)


def load_npz(path: str, *, quantize: bool = False) -> Dict[str, object]:
    """A state_dict from an npz of flat flax-path keys (numpy only).
    ``quantize``: each eligible kernel becomes a QTensor as it is read,
    from its float32 values (ops/quant.py), so the float32 tree is never
    held whole."""

    state = {}
    with np.load(path) as f:
        for key in f.files:
            name = flax_path_to_name(key)
            t = torch.from_numpy(f[key])
            state[name] = quantize_param(name, t) if quantize and eligible(name, t.shape) else t
    return state


def _lecun_fan_in(shape) -> int:
    """flax's variance_scaling fan-in (in_axis=-2, out_axis=-1): the
    in axis times every axis that is neither in nor out."""

    receptive = math.prod(shape) // (shape[-2] * shape[-1])
    return shape[-2] * receptive


#: the tables flax initialises at normal(0.02): the embeddings, learned
#: positions and segments, T5's relative-position table (and llama's
#: lm_head, named apart)
_NORMAL_INIT = ("embedding", "pos_embed", "seg_embed", "rel_embedding")


def init_params(cfg, seed: int, device, *, trainable: bool = False,
                quantize: bool = False, family=None) -> Dict[str, object]:
    """A seeded state_dict of ``family`` (default ``LlamaLM``; the gpt
    and moe families too, the latter on its ``MoeConfig``) built on
    ``cfg``, made directly on ``device`` at the flax init scales:
    normal(0.02) for the embeddings, position and segment tables, T5's
    relative-position table and llama's lm_head, lecun-normal (truncated
    at 2 sigma) for the projections and the moe router and expert
    stacks (an [E, in, out] stack's fan-in counts E, flax's law), ones
    for the norm scales, zeros for biases.  Draws in float32, stores in
    the parameter's dtype.  The numbers differ from flax's (another
    generator); the scales do not.  ``trainable``: float32 everywhere,
    for a trainable model.  ``quantize``: each eligible kernel becomes a
    QTensor quantized from its float32 draw, before any storage cast
    (the draws, and so the float weights, are those of the unquantized
    call); a trainable model is never quantized."""

    if family is None:
        from tf_operator_tpu_torch.models.llama import LlamaLM as family

    if trainable and quantize:
        raise ValueError("a trainable (float32 master) model is not quantized: the JAX "
                         "package quantizes a model for serving only")
    g = torch.Generator(device=device).manual_seed(int(seed))
    state = {}
    for name, p in family(cfg, device="meta", trainable=trainable).named_parameters():
        shape = tuple(p.shape)
        if name.endswith(".scale"):
            t = torch.ones(shape, dtype=torch.float32, device=device)
        elif name.endswith(".bias"):
            t = torch.zeros(shape, dtype=torch.float32, device=device)
        elif name.split(".")[-1] in _NORMAL_INIT or name == "lm_head.kernel":
            t = torch.empty(shape, dtype=torch.float32, device=device)
            t.normal_(0.0, 0.02, generator=g)
        else:
            # flax lecun_normal: truncated normal, stddev corrected for
            # the truncation at +-2
            std = math.sqrt(1.0 / _lecun_fan_in(shape)) / 0.87962566103423978
            t = torch.empty(shape, dtype=torch.float32, device=device)
            torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=g)
        state[name] = (quantize_param(name, t) if quantize and eligible(name, shape)
                       else t.to(p.dtype))
    return state
