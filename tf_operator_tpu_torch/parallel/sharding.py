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
2. logical rules (:func:`logical_shardings`) for the llama family: each
   parameter's logical axes (:data:`LLAMA_PARAM_AXES`, the reference's
   ``param_with_axes`` sites) map through :data:`LOGICAL_RULES` to mesh
   axes, by flax's ``logical_to_mesh_axes`` algorithm.  This is the
   layout of the JAX ``Trainer(shardings="logical")``.

Where a port module keeps a tensor in another layout than flax's (the
ResNet convolution kernels, OIHW against flax's HWIO), the module names
the permutation in ``flax_order`` (``{leaf: order}``: the port's
dimension i is flax's ``order[i]``), so the auto-rule picks the flax
dimension it would pick in the reference.

Only dp and fsdp are ported: :func:`check_mesh` refuses any other axis
of size above 1.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

from tf_operator_tpu_torch.parallel.mesh import AXIS_EP, AXIS_FSDP, AXIS_SP, AXIS_TP, Mesh

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
)

Spec = Tuple[Any, ...]

#: axes the port shards over; the others wait for the features named
_PORTED_AXES = ("dp", "fsdp")
_WAITING = {"sp": "sequence parallelism", "tp": "tensor parallelism",
            "ep": "expert parallelism (the moe family)",
            "pp": "pipeline parallelism (pipelined_lm)"}


def check_mesh(mesh: Mesh) -> None:
    """Refuse a mesh with an axis of size above 1 other than dp and
    fsdp."""

    bad = [ax for ax, n in mesh.shape.items() if n > 1 and ax not in _PORTED_AXES]
    if bad:
        raise NotImplementedError(
            "mesh axes " + ", ".join(f"{ax}={mesh.shape[ax]} ({_WAITING[ax]})" for ax in bad)
            + " are not ported yet: the port shards over dp and fsdp only")


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
    """The logical axes of a llama parameter (:data:`LLAMA_PARAM_AXES`)."""

    for pattern, axes in LLAMA_PARAM_AXES:
        if re.fullmatch(pattern, name):
            return axes
    raise KeyError(f"no logical axes for the llama parameter {name!r}")


def logical_shardings(shapes: Mapping[str, Sequence[int]], mesh: Mesh) -> Dict[str, Spec]:
    """The spec of every llama tensor of ``shapes`` through its logical
    axes and :data:`LOGICAL_RULES`.  A dimension that its mesh axes do
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
