"""Parameter sharding rules (the port of
``tf_operator_tpu/parallel/sharding.py``).

A sharding here is a spec per tensor: a tuple with one entry per
dimension, the mesh axis (or axes) that dimension is split over, or
None, in the port's own layout, as a ``PartitionSpec`` reads.  Two
mechanisms, as in the JAX package:

1. the FSDP auto-rule (:func:`fsdp_spec`, :func:`fsdp_shardings`) for
   models without logical axes (MnistCNN, ResNet): each parameter is
   split along its largest dimension that the fsdp size divides (ties to
   the last), in the flax layout; small parameters stay replicated;
2. logical rules (:func:`logical_shardings`) for the transformer
   families: each parameter's logical axes (:data:`LLAMA_PARAM_AXES`,
   which also names the gpt and moe families' layers, then
   :data:`ENCODER_PARAM_AXES` for the BERT, T5 and ViT names and the
   learned position table; the
   reference's ``param_with_axes`` sites) map through
   :data:`LOGICAL_RULES` to mesh axes, by flax's
   ``logical_to_mesh_axes`` algorithm.  This is the layout of the JAX
   ``Trainer(shardings="logical")``.

Where a port module keeps a tensor in another layout than flax's (the
ResNet convolution kernels, OIHW against flax's HWIO), the module names
the permutation in ``flax_order`` (``{leaf: order}``: the port's
dimension i is flax's ``order[i]``), so the auto-rule picks the flax
dimension it would pick in the reference.

The batch is laid out as the reference's logical rules lay it out:
rows over ("dp", "fsdp"), the sequence ("seq") over sp
(:func:`sequence_chunk`); the parameters are replicated over sp.

The model axes, tp ("heads", "mlp", "vocab") and ep ("expert"), split
a parameter into local shards (:func:`model_axis_dims`,
:func:`local_shard`): each rank of a tp or ep line holds its own shard
and the batch is replicated along the line (parallel/tensor_parallel.py
computes with them).  :func:`check_mesh` refuses pp, and sp together
with tp or ep.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

from tf_operator_tpu_torch.parallel.mesh import (
    AXIS_EP,
    AXIS_FSDP,
    AXIS_PP,
    AXIS_SP,
    AXIS_TP,
    MODEL_PARALLEL_AXES,
    Mesh,
)

#: Logical-axis -> mesh-axis rules for the transformer family: batch
#: rides dp + fsdp; embed shards over fsdp (ZeRO-3 style); heads / mlp
#: over tp; sequence over sp; experts over ep.
LOGICAL_RULES: Tuple[Tuple[str, Any], ...] = (
    # -- parameter axes
    ("batch", ("dp", "fsdp")),
    ("embed", AXIS_FSDP),
    ("embed2", None),  # second dim of square hidden-to-hidden kernels
    ("mlp", AXIS_TP),
    ("heads", AXIS_TP),
    ("kv", None),
    ("vocab", AXIS_TP),
    ("seq", AXIS_SP),
    ("expert", AXIS_EP),
    ("cap", None),  # MoE per-expert capacity buckets
    ("stack", None),
    ("norm", None),
    ("relpos_buckets", None),
    # -- activation axes (activations never shard their feature dim over
    # fsdp: that axis is for parameter sharding)
    ("act_embed", None),
    ("act_heads", AXIS_TP),
    ("act_kv", None),
    ("act_mlp", AXIS_TP),
)

#: Parameters smaller than this stay replicated under the FSDP
#: auto-rule.
MIN_SHARD_SIZE = 2**13

#: The logical axes of each llama parameter (port names), from the
#: reference's ``param_with_axes`` sites: the embedding, the dense
#: projections (``dense``: kernel axes, the bias the trailing feature
#: axes), the attention output, the norm scales and the untied head.
LLAMA_PARAM_AXES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    (r"tok_embed\.embedding", ("vocab", "embed")),
    (r".*\.scale", ("norm",)),
    (r".*\.self_attn\.(query|key|value)\.kernel", ("embed", "heads", "kv")),
    (r".*\.self_attn\.(query|key|value)\.bias", ("heads", "kv")),
    (r".*\.self_attn\.out\.kernel", ("heads", "kv", "embed")),
    (r".*\.self_attn\.out\.bias", ("embed",)),
    (r".*\.mlp\.(wi_gate|wi_up|wi)\.kernel", ("embed", "mlp")),
    (r".*\.mlp\.wi\.bias", ("mlp",)),
    (r".*\.mlp\.wo\.kernel", ("mlp", "embed")),
    (r".*\.mlp\.wo\.bias", ("embed",)),
    (r"lm_head\.kernel", ("embed", "vocab")),
    # the moe family's router and expert stacks (models/moe.py)
    (r".*\.moe\.router\.kernel", ("embed", "expert")),
    (r".*\.moe\.wi", ("expert", "embed", "mlp")),
    (r".*\.moe\.wo", ("expert", "mlp", "embed")),
)

#: The logical axes of the encoder families' parameters (BERT, T5, ViT;
#: port names, the flax paths joined by dots) that the llama table does
#: not name: the embeddings and tables, the norms' biases, the encoder's
#: and the cross-attention's projections, T5's relative-position table,
#: BERT's MLM head, ViT's patch projection and head.
ENCODER_PARAM_AXES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    (r"(.*\.)?(tok_embed|shared_embed)\.embedding", ("vocab", "embed")),
    (r"(.*\.)?pos_embed", ("seq", "embed")),
    (r"(.*\.)?seg_embed", ("stack", "embed")),
    (r"(.*\.)?(ln_\w+|mlm_ln)\.bias", ("norm",)),
    (r".*\.(attn|cross_attn)\.(query|key|value)\.kernel", ("embed", "heads", "kv")),
    (r".*\.(attn|cross_attn)\.(query|key|value)\.bias", ("heads", "kv")),
    (r".*\.(attn|cross_attn)\.out\.kernel", ("heads", "kv", "embed")),
    (r".*\.(attn|cross_attn)\.out\.bias", ("embed",)),
    (r".*\.rel_embedding", ("relpos_buckets", "heads")),
    (r".*\.mlm_transform\.kernel", ("embed", "embed2")),
    (r".*\.mlm_transform\.bias", ("embed2",)),
    (r".*\.mlm_decoder\.kernel", ("embed", "vocab")),
    (r".*\.mlm_decoder\.bias", ("vocab",)),
    (r"patch_embed\.proj\.kernel", ("stack", "embed")),
    (r"patch_embed\.proj\.bias", ("embed",)),
    (r"head\.kernel", ("embed", "vocab")),
    (r"head\.bias", ("vocab",)),
)

Spec = Tuple[Any, ...]

def check_mesh(mesh: Mesh) -> None:
    """Refuse the meshes the trainer does not shard over: a pp axis above
    1 (the JAX trainer has no pipeline either: pipeline parallelism runs
    through ``models/pipelined_lm.PipelinedLM``), and sp above 1 together
    with tp or ep (the reference's sequence-parallel attention over heads
    split on tp, ``heads_axis="tp"``)."""

    if mesh.shape[AXIS_PP] > 1:
        raise NotImplementedError(f"mesh axis pp={mesh.shape[AXIS_PP]}: the trainer runs no "
                                  "pipeline; pipeline parallelism runs through "
                                  "models/pipelined_lm.PipelinedLM")
    model = [ax for ax in MODEL_PARALLEL_AXES if mesh.shape[ax] > 1]
    if mesh.shape[AXIS_SP] > 1 and model:
        raise NotImplementedError(
            f"mesh axes sp={mesh.shape[AXIS_SP]} with "
            + ", ".join(f"{ax}={mesh.shape[ax]}" for ax in model)
            + ": sequence parallelism together with tensor or expert parallelism is not "
            "ported yet")


def model_axis_dims(spec: Spec, mesh: Mesh) -> Dict[str, int]:
    """``{axis: dimension}`` of the model axes (tp, ep) of size above 1
    that ``spec`` splits a parameter over."""

    out = {}
    for ax in MODEL_PARALLEL_AXES:
        dim = sharded_dim(spec, mesh, ax)
        if dim is not None:
            out[ax] = dim
    return out


def local_shard(x, spec: Spec, mesh: Mesh, rank: int):
    """``rank``'s shard of the whole parameter ``x`` over the model axes
    of ``spec`` (the chunk at its coordinate on each tp or ep line along
    that axis's dimension), a view; ``x`` itself where ``spec`` names
    none."""

    for ax, dim in model_axis_dims(spec, mesh).items():
        x = x.chunk(mesh.shape[ax], dim)[mesh.index((ax,), rank)]
    return x


def sequence_chunk(x, mesh: Mesh, rank: int, dim: int = 1):
    """``rank``'s chunk of ``x`` (a tensor or an array) along its
    sequence dimension ``dim`` ("seq" over sp: the chunk at the rank's
    coordinate on its sp line), a view; ``x`` itself at sp 1.  Refuses a
    length that does not divide."""

    n = mesh.shape[AXIS_SP]
    if n <= 1:
        return x
    s = x.shape[dim]
    if s % n:
        raise ValueError(f"seq {s} does not divide over {n} '{AXIS_SP}' shards")
    i, c = mesh.index((AXIS_SP,), rank), s // n
    return x[(slice(None),) * dim + (slice(i * c, (i + 1) * c),)]


def fsdp_spec(shape: Sequence[int], fsdp_size: int) -> Optional[int]:
    """The dimension to shard over fsdp (the largest that ``fsdp_size``
    divides, ties toward the last), or None to replicate: an fsdp size
    of 1, fewer than ``MIN_SHARD_SIZE`` elements, or no divisible
    dimension."""

    if fsdp_size <= 1:
        return None
    total = 1
    for d in shape:
        total *= int(d)
    if total < MIN_SHARD_SIZE:
        return None
    best, best_dim = -1, -1
    for i, d in enumerate(shape):
        if d % fsdp_size == 0 and d >= best:
            best, best_dim = d, i
    return best_dim if best_dim >= 0 else None


def _spec(ndim: int, dim: Optional[int]) -> Spec:
    parts: list = [None] * ndim
    if dim is not None:
        parts[dim] = AXIS_FSDP
    return tuple(parts)


def fsdp_shardings(shapes: Mapping[str, Sequence[int]], mesh: Mesh,
                   flax_orders: Optional[Mapping[str, Sequence[int]]] = None
                   ) -> Dict[str, Spec]:
    """The auto-rule's spec of every tensor of ``shapes`` (name -> shape
    in the port's layout); ``flax_orders`` names the tensors kept in
    another layout than flax's (module docstring)."""

    fsdp = mesh.shape[AXIS_FSDP]
    out = {}
    for name, shape in shapes.items():
        shape = tuple(int(d) for d in shape)
        order = (flax_orders or {}).get(name)
        if order is None:
            out[name] = _spec(len(shape), fsdp_spec(shape, fsdp))
            continue
        flax_shape = [0] * len(shape)
        for i, f in enumerate(order):
            flax_shape[f] = shape[i]
        f_dim = fsdp_spec(flax_shape, fsdp)
        out[name] = _spec(len(shape), None if f_dim is None else list(order).index(f_dim))
    return out


def logical_to_mesh_axes(names: Sequence[Optional[str]]) -> Spec:
    """flax's ``logical_to_mesh_axes``: walk the rules in order; a rule
    assigns its mesh axes to the dimension of its logical name when that
    dimension is still unassigned and none of the axes is used yet."""

    if len(set(n for n in names if n is not None)) != len([n for n in names if n is not None]):
        raise ValueError(f"duplicate logical axis names in {tuple(names)}")
    unassigned = object()
    result: list = [unassigned] * len(names)
    for logical, mesh_axes in LOGICAL_RULES:
        if logical not in names:
            continue
        pos = list(names).index(logical)
        used = set()
        for r in result:
            if r is unassigned or r is None:
                continue
            used.update(r if isinstance(r, tuple) else (r,))
        wanted = mesh_axes if isinstance(mesh_axes, tuple) else (mesh_axes,)
        if result[pos] is unassigned and not used.intersection(a for a in wanted if a):
            result[pos] = mesh_axes
    return tuple(None if r is unassigned else r for r in result)


def llama_param_axes(name: str) -> Tuple[str, ...]:
    """The logical axes of a transformer-family parameter
    (:data:`LLAMA_PARAM_AXES`, then :data:`ENCODER_PARAM_AXES`)."""

    for pattern, axes in LLAMA_PARAM_AXES + ENCODER_PARAM_AXES:
        if re.fullmatch(pattern, name):
            return axes
    raise KeyError(f"no logical axes for the parameter {name!r}")


def logical_shardings(shapes: Mapping[str, Sequence[int]], mesh: Mesh) -> Dict[str, Spec]:
    """The spec of every transformer-family tensor of ``shapes`` through
    its logical axes and :data:`LOGICAL_RULES`.  A dimension that its mesh axes do
    not divide is refused, as the JAX trainer fails loudly at jit
    time."""

    out = {}
    for name, shape in shapes.items():
        axes = llama_param_axes(name)
        if len(axes) != len(shape):
            raise ValueError(f"{name}: logical axes {axes} for shape {tuple(shape)}")
        spec = logical_to_mesh_axes(axes)
        for dim, entry in zip(shape, spec):
            n = 1
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                if ax is not None:
                    n *= mesh.shape[ax]
            if n > 1 and dim % n:
                raise ValueError(f"{name}: dimension {dim} is not divisible by {n} ({entry})")
        out[name] = spec
    return out


def sharded_dim(spec: Spec, mesh: Mesh, axis: str = AXIS_FSDP) -> Optional[int]:
    """The dimension ``spec`` splits over ``axis`` where that axis has
    size above 1, else None."""

    if mesh.shape[axis] <= 1:
        return None
    for i, entry in enumerate(spec):
        if axis in (entry if isinstance(entry, tuple) else (entry,)):
            return i
    return None
