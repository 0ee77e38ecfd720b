"""Hierarchical (slice-aware) gradient collectives on process groups
(the port of ``tf_operator_tpu/parallel/collectives.py``).

A job that spans slices reduces its gradients across the slice boundary
(dp, the one axis of a slice-aware mesh that crosses it), where links
are slow.  The hierarchical reduction sends only a fragment across:

1. reduce-scatter over the intra-slice group (the ici axes, fsdp): each
   rank holds the sum of 1/n_ici of the gradient over its slice;
2. all-reduce of that fragment over the dp group: 1/n_ici of the bytes
   a flat all-reduce would move across slices;
3. all-gather over the intra-slice group: the full sum again.

A leaf already sharded over the ici axes (an fsdp-sharded parameter)
takes the direct route: stage 1 along its sharded dimension, stage 2,
and no stage 3 (its optimizer shard needs only its fragment).
Replicated leaves are bucketed: flattened, concatenated per dtype up to
``bucket_bytes``, padded to a multiple of n_ici.  The JAX plan runs
inside a shard_map where XLA makes the intra-slice reduction; here the
plan runs all three stages itself, on the full local gradients.

The plan's ``mode`` is ``"hierarchical"`` or ``"flat"``: flat reduces a
bucket with one all-reduce over the batch axes (dp and the ici axes
together); the direct route is the same in both.

Each stage calls one collective, the same on every backend
(:func:`reduce_scatter`, :func:`all_reduce`, :func:`all_gather`): gloo
(PyTorch 2.13 on the CPU, 2.11 on CUDA tensors) and NCCL take all three
on the tensors' own device, so no stage makes a host copy.  Nothing is
tried and caught.

Sequence parallelism (ops/ring_attention.py, ops/ulysses_attention.py)
adds two collectives over a mesh line:

- :func:`ppermute`, the ring's ``lax.ppermute`` (a shift of one
  neighbour): ``torch.distributed.batch_isend_irecv`` of one send and
  one receive;
- :func:`all_to_all`, ``lax.all_to_all(tiled=True)``:
  ``torch.distributed.all_to_all_single`` on the parts stacked along a
  new leading dimension.

NCCL takes both on CUDA tensors, and gloo takes both on CPU tensors and
``all_to_all_single`` on CUDA tensors (PyTorch 2.11 on the H100
machine).  Gloo's send and receive on a CUDA tensor abort the process
there (``writev ... Bad address``: the device pointer read as host
memory), so the ring's ppermute on gloo copies a CUDA tensor to the CPU
for the call and back after it: the ``host`` transport, the one
exception (:func:`host_staged`).  The route is fixed by the collective,
the backend and the tensor's device before the call and recorded in the
stats beside the stage.

Byte accounting (``ledger()``): the JAX plan's, payload bytes per rank per step: a stage-2 all-reduce of an
F-byte fragment counts F toward dcn, a stage-3 gather counts (full -
fragment) toward ici; the intra-slice reduction is not counted.  Two
baselines: every gradient byte at full width (``flat_dcn_bytes``,
the topology-blind state), and the flat program on the same mesh, where
an ici-sharded gradient's dp all-reduce moves only its shard
(``flat_mesh_dcn_bytes``).

The mesh's ``stats`` counts what the collectives over its groups (a
plan's, the trainer's parameter gather, the sequence-parallel attention
and loss) actually did: calls, the bytes handed to each call
(the full-width buffer of a reduce-scatter or all-gather, the tensor of
an all-reduce) and the host wall of the calls.  On gloo a call returns
when its data is in place, so the wall is the collective's time; on
NCCL it is the enqueue.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from tf_operator_tpu_torch.parallel.mesh import (
    AXIS_DP,
    FABRIC_ICI,
    MODEL_PARALLEL_AXES,
    Mesh,
    mesh_axis_links,
)

#: bucket capacity for the fused cross-slice all-reduces
DEFAULT_BUCKET_BYTES = 4 << 20

class CollectiveStats:
    """Calls, bytes and host seconds of collectives, by stage name, and
    the route (``device`` or ``host``) of a ppermute or all-to-all
    stage."""

    def __init__(self):
        self.by_stage: Dict[str, Dict[str, float]] = {}

    def add(self, stage: str, nbytes: int, seconds: float, route: Optional[str] = None) -> None:
        s = self.by_stage.setdefault(stage, {"calls": 0, "bytes": 0, "seconds": 0.0})
        s["calls"] += 1
        s["bytes"] += int(nbytes)
        s["seconds"] += seconds
        if route is not None:
            s["route"] = route

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        return {k: dict(v) for k, v in self.by_stage.items()}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def reduce_scatter(out: torch.Tensor, inp: torch.Tensor, group, stats: CollectiveStats,
                   stage: str) -> torch.Tensor:
    """Sum ``inp`` (dim 0 split in the group's size) over ``group`` into
    this rank's part ``out``; a one-rank line (group None) copies."""

    import torch.distributed as dist

    if group is None:
        return out.copy_(inp)
    t0 = time.perf_counter()
    dist.reduce_scatter_tensor(out, inp, group=group)
    stats.add(stage, _nbytes(inp), time.perf_counter() - t0)
    return out


def all_reduce(t: torch.Tensor, group, stats: CollectiveStats, stage: str,
               op: str = "sum") -> torch.Tensor:
    """Reduce ``t`` over ``group`` in place (``op``: "sum", "max" or
    "min"); a no-op on a one-rank line."""

    import torch.distributed as dist

    if group is None:
        return t
    t0 = time.perf_counter()
    if op == "sum":
        dist.all_reduce(t, group=group)
    else:
        dist.all_reduce(t, op=getattr(dist.ReduceOp, op.upper()), group=group)
    stats.add(stage, _nbytes(t), time.perf_counter() - t0)
    return t


def all_gather(out: torch.Tensor, inp: torch.Tensor, group, stats: CollectiveStats,
               stage: str) -> torch.Tensor:
    """Concatenate every rank's ``inp`` along dim 0 into ``out``; a copy
    on a one-rank line."""

    import torch.distributed as dist

    if group is None:
        return out.copy_(inp)
    t0 = time.perf_counter()
    dist.all_gather_into_tensor(out, inp, group=group)
    stats.add(stage, _nbytes(out), time.perf_counter() - t0)
    return out


def host_staged(kind: str, backend: str, device_type: str) -> bool:
    """Whether a ``kind`` collective (``"ppermute"`` or ``"all_to_all"``)
    on ``backend`` copies tensors on ``device_type`` to the CPU for the
    call and back after it (the ``host`` transport): only gloo's
    ppermute of a CUDA tensor (module docstring).  Read before the call."""

    return kind == "ppermute" and backend == "gloo" and device_type == "cuda"


def _timed_call(call, t: torch.Tensor, group, kind: str, stats: CollectiveStats,
                stage: str) -> torch.Tensor:
    """Run ``call(send, recv)`` on the route :func:`host_staged` gives
    and return ``recv``: ``send`` is ``t`` and ``recv`` a new tensor of
    its shape, both on the CPU for the host route."""

    import torch.distributed as dist

    host = host_staged(kind, dist.get_backend(group), t.device.type)
    route = "host" if host else "device"
    t0 = time.perf_counter()
    if host:
        send = t.cpu()
        recv = torch.empty_like(send)
        call(send, recv)
        recv = recv.to(t.device)
    else:
        recv = torch.empty_like(t)
        call(t, recv)
    stats.add(stage, _nbytes(t), time.perf_counter() - t0, route=route)
    return recv


def ppermute(t: torch.Tensor, group, stats: CollectiveStats, stage: str,
             shift: int = 1) -> torch.Tensor:
    """``lax.ppermute`` over the ring of ``group`` (a mesh line, its
    ranks in coordinate order) with the permutation j -> (j + shift) % n:
    a new tensor holding the ``t`` of the rank ``shift`` places back.
    One ``batch_isend_irecv`` (a send and a receive, posted together);
    a one-rank line copies."""

    import torch.distributed as dist

    if group is None:
        return t.clone()
    ranks = dist.get_process_group_ranks(group)
    me = ranks.index(dist.get_rank())
    n = len(ranks)
    dst, src = ranks[(me + shift) % n], ranks[(me - shift) % n]
    t = t.contiguous()

    def call(send, recv):
        ops = [dist.P2POp(dist.isend, send, dst, group),
               dist.P2POp(dist.irecv, recv, src, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    return _timed_call(call, t, group, "ppermute", stats, stage)


def all_to_all(t: torch.Tensor, group, stats: CollectiveStats, stage: str, *,
               split_dim: int, concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(tiled=True)`` over ``group``: ``t`` cut into n
    equal parts along ``split_dim``, part j sent to the line's j-th rank,
    and the parts received concatenated along ``concat_dim`` in rank
    order.  One ``all_to_all_single``; a one-rank line copies."""

    import torch.distributed as dist

    if group is None:
        return t.clone()
    n = dist.get_world_size(group)
    if t.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dimension {split_dim} of {tuple(t.shape)} does not "
                         f"split {n} ways")
    inp = torch.stack(t.chunk(n, split_dim))

    def call(send, recv):
        dist.all_to_all_single(recv, send, group=group)

    out = _timed_call(call, inp, group, "all_to_all", stats, stage)
    return torch.cat(out.unbind(0), dim=concat_dim)


def scatter_dim(x: torch.Tensor, dim: int, group, n: int, stats: CollectiveStats,
                stage: str) -> torch.Tensor:
    """Stage 1 of the direct route: ``x`` summed over ``group``, this
    rank's 1/n of dimension ``dim``, contiguous with ``dim`` moved first
    (``movedim(0, dim)`` gives it in ``x``'s layout)."""

    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    return reduce_scatter(out, src, group, stats, stage)


def gather_dim(shard: torch.Tensor, dim: int, group, n: int, stats: CollectiveStats,
               stage: str) -> torch.Tensor:
    """Every rank's ``shard`` concatenated along ``dim``."""

    src = shard.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] * n,) + tuple(src.shape[1:]))
    return all_gather(out, src, group, stats, stage).movedim(0, dim)


def ici_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The mesh axes whose collectives stay intra-slice (size > 1 and not
    dp, the cross-slice axis): the fragment dimension of stages 1 and 3."""

    links = mesh_axis_links(mesh)
    return tuple(ax for ax in mesh.axis_names
                 if ax != AXIS_DP and mesh.shape[ax] > 1 and links[ax] == FABRIC_ICI)


def _spec_divisor(spec, mesh: Mesh, ici: Tuple[str, ...]) -> int:
    """How many ways a leaf's gradient is split across the ici axes (1:
    replicated, the bucket route)."""

    if spec is None:
        return 1
    div = 1
    for entry in spec:
        if entry is None:
            continue
        for ax in entry if isinstance(entry, tuple) else (entry,):
            if ax in ici:
                div *= mesh.shape[ax]
    return div


def _ici_split(spec, ici: Tuple[str, ...]) -> Tuple[str, ...]:
    """The ici axes ``spec`` splits a leaf over, in mesh order."""

    named = set()
    for entry in spec or ():
        if entry is not None:
            named.update(entry if isinstance(entry, tuple) else (entry,))
    return tuple(ax for ax in ici if ax in named)


def _ici_dim(spec, ici: Tuple[str, ...]) -> int:
    dims = [i for i, entry in enumerate(spec)
            if entry is not None
            and set(entry if isinstance(entry, tuple) else (entry,)) & set(ici)]
    if len(dims) != 1:
        raise NotImplementedError(f"a leaf split over the ici axes along {len(dims)} "
                                  f"dimensions ({spec}); one is ported")
    return dims[0]


@dataclasses.dataclass
class _Bucket:
    indices: List[int]
    sizes: List[int]
    shapes: List[Tuple[int, ...]]
    dtype: Any
    padded: int  # total flattened length, padded to a multiple of n_ici


@dataclasses.dataclass
class GradSyncPlan:
    """One gradient list's sync, built once per trainer: per-leaf
    routes, buckets, the byte ledger, and the stats of what ran."""

    mesh: Mesh
    dcn_axis: str
    ici: Tuple[str, ...]
    n_ici: int
    #: per leaf: ("direct", divisor, dim, the summed ici axes it is split
    #: over along dim) or ("bucket", bucket, slot)
    routes: List[Tuple]
    buckets: List[_Bucket]
    flat_blind_dcn_bytes: int
    flat_mesh_dcn_bytes: int
    dcn_bytes: int
    ici_bytes: int
    dcn_collectives: int
    ici_collectives: int
    mode: str = "hierarchical"

    @property
    def summed(self) -> Tuple[str, ...]:
        """The ici axes the gradients are summed over: all but the model
        axes (tp, ep), whose ranks hold shards or equal gradients."""

        return tuple(ax for ax in self.ici if ax not in MODEL_PARALLEL_AXES)

    @property
    def n_summed(self) -> int:
        n = 1
        for ax in self.summed:
            n *= self.mesh.shape[ax]
        return n

    @property
    def stats(self) -> CollectiveStats:
        """Where the plan's collectives count: its mesh's."""

        return self.mesh.stats

    @property
    def dcn_bytes_ratio(self) -> float:
        return self.dcn_bytes / self.flat_blind_dcn_bytes if self.flat_blind_dcn_bytes else 0.0

    @property
    def dcn_bytes_ratio_vs_flat_mesh(self) -> float:
        return self.dcn_bytes / self.flat_mesh_dcn_bytes if self.flat_mesh_dcn_bytes else 0.0

    def __post_init__(self):
        # a group's first use is collective (parallel/mesh.py): make
        # every group the plan uses now, at the same point on every rank
        self._groups()
        for route in self.routes:
            if route[0] == "direct":
                self.mesh.group(route[3])
                self.mesh.group((self.dcn_axis,) + tuple(ax for ax in self.summed
                                                         if ax not in route[3]))

    def _groups(self):
        return (self.mesh.group(self.summed), self.mesh.group((self.dcn_axis,)),
                self.mesh.group((self.dcn_axis,) + self.summed))

    def apply_leaf(self, i: int, grad: torch.Tensor) -> torch.Tensor:
        """Leaf ``i`` of the direct route summed over the batch axes:
        this rank's shard along its sharded dimension (an unsharded one
        whole, reduced over dp).  A leaf split over tp or ep comes as
        this rank's shard of it and is summed over the other axes."""

        _, _, dim, axes = self.routes[i]
        # stage 2 also sums over the ici axes the leaf is replicated over
        # (sp: every rank of a sequence-parallel line holds the weights)
        rest = tuple(ax for ax in self.summed if ax not in axes)
        dcn = self.mesh.group((self.dcn_axis,) + rest)
        if not axes:
            return all_reduce(grad.clone(), dcn, self.stats, "stage2_all_reduce")
        n = 1
        for ax in axes:
            n *= self.mesh.shape[ax]
        frag = scatter_dim(grad, dim, self.mesh.group(axes), n, self.stats,
                           "stage1_reduce_scatter")
        return all_reduce(frag, dcn, self.stats, "stage2_all_reduce").movedim(0, dim)

    def apply(self, grads: Sequence[Optional[torch.Tensor]],
              done: Optional[Dict[int, torch.Tensor]] = None) -> List[torch.Tensor]:
        """Sum ``grads`` (each rank's full local gradients) over the
        batch axes (dp and the ici axes).  A direct leaf comes back as
        this rank's shard along its sharded dimension, a bucketed one
        whole.  ``done``: direct leaves already summed by
        :meth:`apply_leaf` (their entries in ``grads`` are not read).
        The caller divides by the batch ranks for the mean."""

        if len(grads) != len(self.routes):
            raise ValueError(f"grad list has {len(grads)} leaves, plan was built for "
                             f"{len(self.routes)}")
        done = done or {}
        intra, dcn, batch = self._groups()
        st = self.stats
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        for i, route in enumerate(self.routes):
            if route[0] == "direct":
                out[i] = done[i] if i in done else self.apply_leaf(i, grads[i])
        for bucket in self.buckets:
            pieces = [grads[i].reshape(-1) for i in bucket.indices]
            total = sum(bucket.sizes)
            if bucket.padded > total:
                pieces.append(pieces[0].new_zeros(bucket.padded - total))
            flat = torch.cat(pieces) if len(pieces) > 1 else pieces[0].clone()
            if self.mode == "flat":
                all_reduce(flat, batch, st, "flat_all_reduce")
            else:
                frag = flat.new_empty(bucket.padded // self.n_summed)
                reduce_scatter(frag, flat, intra, st, "stage1_reduce_scatter")
                all_reduce(frag, dcn, st, "stage2_all_reduce")
                all_gather(flat, frag, intra, st, "stage3_all_gather")
            offset = 0
            for idx, size, shape in zip(bucket.indices, bucket.sizes, bucket.shapes):
                out[idx] = flat[offset:offset + size].view(shape)
                offset += size
        return out  # type: ignore[return-value]

    def ledger(self) -> Dict[str, Any]:
        """The JAX plan's accounting, key for key."""

        return {
            "dcn_axis": self.dcn_axis,
            "ici_axes": list(self.ici),
            "intra_slice_size": self.n_ici,
            "flat_dcn_bytes_per_step": self.flat_blind_dcn_bytes,
            "flat_mesh_dcn_bytes_per_step": self.flat_mesh_dcn_bytes,
            "hier_dcn_bytes_per_step": self.dcn_bytes,
            "hier_ici_bytes_per_step": self.ici_bytes,
            "dcn_bytes_ratio": round(self.dcn_bytes_ratio, 6),
            "dcn_bytes_ratio_vs_flat_mesh": round(self.dcn_bytes_ratio_vs_flat_mesh, 6),
            "dcn_collectives_per_step": self.dcn_collectives,
            "ici_collectives_per_step": self.ici_collectives,
            "buckets": len(self.buckets),
        }


def build_grad_sync_plan(leaves: Sequence[Tuple[Sequence[int], torch.dtype]],
                         specs: Optional[Sequence[Any]], mesh: Mesh, *,
                         bucket_bytes: int = DEFAULT_BUCKET_BYTES, mode: str = "hierarchical") -> GradSyncPlan:
    """Route every gradient leaf (``(shape, dtype)``, in the order the
    plan will be applied) and compute the byte ledger.  ``specs``: each
    leaf's spec (``parallel/sharding``), or None to treat every leaf as
    replicated.  The plan's collectives count in ``mesh.stats``.

    The sum runs over every ici axis but tp and ep, so over sp too: a
    sequence-parallel rank holds every weight, and its gradient is its
    chunk's share; a tensor- or expert-parallel rank holds its shard of
    a leaf split over its line (whose gradient is its own) or the whole
    of a replicated one (whose gradient is already the line's).  The
    ledger is the JAX plan's, over every ici axis."""

    if mode not in ("hierarchical", "flat"):
        raise ValueError(f"mode must be hierarchical|flat, got {mode!r}")
    ici = ici_axes(mesh)
    n_ici = 1
    for ax in ici:
        n_ici *= mesh.shape[ax]
    if specs is None:
        specs = [None] * len(leaves)
    if len(specs) != len(leaves):
        raise ValueError(f"params/shardings leaf mismatch: {len(leaves)} vs {len(specs)}")

    routes: List[Tuple] = [()] * len(leaves)
    flat_blind_bytes = flat_mesh_bytes = dcn_bytes = ici_bytes = direct = 0
    open_buckets: Dict[Any, _Bucket] = {}
    buckets: List[_Bucket] = []

    def close(dtype) -> None:
        b = open_buckets.pop(dtype, None)
        if b is not None:
            b.padded = -(-sum(b.sizes) // n_ici) * n_ici
            buckets.append(b)

    summed = tuple(ax for ax in ici if ax not in MODEL_PARALLEL_AXES)
    for i, (shape, dtype) in enumerate(leaves):
        shape = tuple(int(d) for d in shape)
        size = 1
        for d in shape:
            size *= d
        itemsize = torch.empty((), dtype=dtype).element_size()
        nbytes = size * itemsize
        flat_blind_bytes += nbytes
        div = _spec_divisor(specs[i], mesh, ici)
        flat_mesh_bytes += nbytes // div
        if div > 1 or not dtype.is_floating_point:
            split = _ici_split(specs[i], summed)
            routes[i] = ("direct", div, _ici_dim(specs[i], summed) if split else None, split)
            direct += 1
            dcn_bytes += nbytes // div
            continue
        b = open_buckets.get(dtype)
        if b is None:
            b = open_buckets[dtype] = _Bucket([], [], [], dtype, 0)
        b.indices.append(i)
        b.sizes.append(size)
        b.shapes.append(shape)
        routes[i] = ("bucket", None, None)
        if sum(b.sizes) * itemsize >= bucket_bytes:
            close(dtype)
    for dtype in list(open_buckets):
        close(dtype)
    for b_idx, b in enumerate(buckets):
        for slot, leaf_idx in enumerate(b.indices):
            routes[leaf_idx] = ("bucket", b_idx, slot)
        itemsize = torch.empty((), dtype=b.dtype).element_size()
        frag = (b.padded // n_ici) * itemsize
        dcn_bytes += frag
        ici_bytes += b.padded * itemsize - frag

    return GradSyncPlan(
        mesh=mesh, dcn_axis=AXIS_DP, ici=ici, n_ici=n_ici, routes=routes, buckets=buckets,
        flat_blind_dcn_bytes=flat_blind_bytes, flat_mesh_dcn_bytes=flat_mesh_bytes,
        dcn_bytes=dcn_bytes, ici_bytes=ici_bytes,
        dcn_collectives=len(buckets) + direct,
        ici_collectives=len(buckets) if n_ici > 1 else 0,
        mode=mode)


def psum_hierarchical(xs: Sequence[torch.Tensor], mesh: Mesh, *, shardings=None,
                      bucket_bytes: int = DEFAULT_BUCKET_BYTES) -> List[torch.Tensor]:
    """The two-stage sum of ``xs`` over the batch axes (sum semantics:
    the flat all-reduce's result), through a plan built for their
    shapes; a leaf sharded over the ici axes (``shardings``) comes back
    as this rank's shard of the sum."""

    plan = build_grad_sync_plan([(x.shape, x.dtype) for x in xs], shardings, mesh,
                                bucket_bytes=bucket_bytes)
    return plan.apply(xs)


def measure_sync_seconds(mesh: Mesh, device, nbytes: int = DEFAULT_BUCKET_BYTES, *,
                         repeats: int = 5) -> Dict[str, float]:
    """Time the hierarchical reduction's phases alone (collective: every
    rank calls it), best of ``repeats``, each ending in a device sync:
    ``dcn_fragment_s`` the all-reduce of one fragment over dp,
    ``ici_reshard_s`` the reduce-scatter + all-gather pair over the ici
    axes, ``flat_full_s`` the full-width all-reduce over the batch axes."""

    device = torch.device(device)
    ici = ici_axes(mesh)
    n_ici = 1
    for ax in ici:
        n_ici *= mesh.shape[ax]
    n = max(n_ici, (nbytes // 4 // n_ici) * n_ici)
    intra, dcn, batch = mesh.group(ici), mesh.group((AXIS_DP,)), mesh.group((AXIS_DP,) + ici)
    stats = CollectiveStats()
    full = torch.ones(n, dtype=torch.float32, device=device)
    frag = torch.ones(n // n_ici, dtype=torch.float32, device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def timed(fn) -> float:
        fn()
        sync()
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            sync()
            best = min(best, time.perf_counter() - t0)
        return best

    def ici_pair():
        reduce_scatter(frag, full, intra, stats, "stage1")
        all_gather(full, frag, intra, stats, "stage3")

    return {
        "dcn_fragment_s": timed(lambda: all_reduce(frag, dcn, stats, "stage2")),
        "ici_reshard_s": timed(ici_pair),
        "flat_full_s": timed(lambda: all_reduce(full, batch, stats, "flat")),
        "probe_bytes": n * 4,
        "intra_slice_size": n_ici,
    }
