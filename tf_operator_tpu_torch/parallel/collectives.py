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

Byte accounting (``ledger()``): the JAX plan's, payload bytes per rank per step: a stage-2 all-reduce of an
F-byte fragment counts F toward dcn, a stage-3 gather counts (full -
fragment) toward ici; the intra-slice reduction is not counted.  Two
baselines: every gradient byte at full width (``flat_dcn_bytes``,
the topology-blind state), and the flat program on the same mesh, where
an ici-sharded gradient's dp all-reduce moves only its shard
(``flat_mesh_dcn_bytes``).

``stats`` counts what the collectives of a plan (and of the trainer's
parameter gather) actually did: calls, the bytes handed to each call
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

from tf_operator_tpu_torch.parallel.mesh import AXIS_DP, FABRIC_ICI, Mesh, mesh_axis_links

#: bucket capacity for the fused cross-slice all-reduces
DEFAULT_BUCKET_BYTES = 4 << 20

class CollectiveStats:
    """Calls, bytes and host seconds of collectives, by stage name."""

    def __init__(self):
        self.by_stage: Dict[str, Dict[str, float]] = {}

    def add(self, stage: str, nbytes: int, seconds: float) -> None:
        s = self.by_stage.setdefault(stage, {"calls": 0, "bytes": 0, "seconds": 0.0})
        s["calls"] += 1
        s["bytes"] += int(nbytes)
        s["seconds"] += seconds

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


def all_reduce(t: torch.Tensor, group, stats: CollectiveStats, stage: str) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; a no-op on a one-rank line."""

    import torch.distributed as dist

    if group is None:
        return t
    t0 = time.perf_counter()
    dist.all_reduce(t, group=group)
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
    #: per leaf: ("direct", divisor, dim) or ("bucket", bucket, slot)
    routes: List[Tuple]
    buckets: List[_Bucket]
    flat_blind_dcn_bytes: int
    flat_mesh_dcn_bytes: int
    dcn_bytes: int
    ici_bytes: int
    dcn_collectives: int
    ici_collectives: int
    mode: str = "hierarchical"
    stats: CollectiveStats = dataclasses.field(default_factory=CollectiveStats)

    @property
    def dcn_bytes_ratio(self) -> float:
        return self.dcn_bytes / self.flat_blind_dcn_bytes if self.flat_blind_dcn_bytes else 0.0

    @property
    def dcn_bytes_ratio_vs_flat_mesh(self) -> float:
        return self.dcn_bytes / self.flat_mesh_dcn_bytes if self.flat_mesh_dcn_bytes else 0.0

    def _groups(self):
        return (self.mesh.group(self.ici), self.mesh.group((self.dcn_axis,)),
                self.mesh.group((self.dcn_axis,) + self.ici))

    def apply_leaf(self, i: int, grad: torch.Tensor) -> torch.Tensor:
        """Leaf ``i`` of the direct route summed over the batch axes:
        this rank's shard along its sharded dimension (an unsharded one
        whole, reduced over dp)."""

        _, div, dim = self.routes[i]
        intra, dcn, _ = self._groups()
        if div == 1:
            return all_reduce(grad.clone(), dcn, self.stats, "stage2_all_reduce")
        frag = scatter_dim(grad, dim, intra, div, self.stats, "stage1_reduce_scatter")
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
                frag = flat.new_empty(bucket.padded // self.n_ici)
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
                         bucket_bytes: int = DEFAULT_BUCKET_BYTES, mode: str = "hierarchical"
                         ) -> GradSyncPlan:
    """Route every gradient leaf (``(shape, dtype)``, in the order the
    plan will be applied) and compute the byte ledger.  ``specs``: each
    leaf's spec (``parallel/sharding``), or None to treat every leaf as
    replicated."""

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
            routes[i] = ("direct", div, _ici_dim(specs[i], ici) if div > 1 else None)
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
