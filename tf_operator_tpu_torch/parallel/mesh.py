"""Named meshes over the ranks of a job (the port of
``tf_operator_tpu/parallel/mesh.py``).

A JAX mesh is an array of devices with named axes; the port's is an
array of global ranks, one device a rank, laid out exactly as the JAX
``make_mesh`` lays out device ids (the same shapes, the same refusals,
the same slice-aware order), with one ``torch.distributed`` group per
line of each axis: the ranks that differ only in that axis's
coordinate.  A collective "over fsdp" is a collective on the calling
rank's fsdp group.

``new_group`` is collective, so every rank creates every group, in one
fixed order: at construction the lines of each axis of size > 1 (in
``AXIS_ORDER``) and of the batch axes together; any other combination
of axes on its first :meth:`Mesh.group` call, which every rank makes at
the same point of the same program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

AXIS_PP = "pp"
AXIS_DP = "dp"
AXIS_FSDP = "fsdp"
AXIS_TP = "tp"
AXIS_SP = "sp"
AXIS_EP = "ep"

#: Canonical axis order.  Data-parallel-ish axes go first so that
#: neighbouring devices end up on the model axes (tp/sp), where
#: collectives are in the critical path; pp is outermost.
AXIS_ORDER = (AXIS_PP, AXIS_DP, AXIS_FSDP, AXIS_EP, AXIS_SP, AXIS_TP)

#: The global batch is sharded over every data-ish axis.
BATCH_AXES = (AXIS_DP, AXIS_FSDP)

#: Axes whose collectives are bandwidth-bound on the critical path:
#: these never span a slice boundary (dp may: the hierarchical grad
#: sync of parallel/collectives.py).
MODEL_AXES = (AXIS_FSDP, AXIS_EP, AXIS_SP, AXIS_TP)

#: Fabric names mesh_axis_links reports: intra-slice links, and the
#: network between slices.
FABRIC_ICI = "ici"
FABRIC_DCN = "dcn"


class Mesh:
    """``ranks``: the global rank at each mesh position, shape = the
    axis sizes in ``AXIS_ORDER``; ``slice_ids``: the slice of each
    position.  ``groups`` only where a world of more than one process
    has been joined (``runtime/bootstrap.initialize``)."""

    axis_names = AXIS_ORDER

    def __init__(self, ranks: np.ndarray, slice_ids: np.ndarray, distributed: bool):
        self.ranks = ranks
        self.slice_ids = slice_ids
        self.shape: Dict[str, int] = dict(zip(AXIS_ORDER, ranks.shape))
        self.size = int(ranks.size)
        self._distributed = distributed
        self._groups: Dict[Tuple[str, ...], object] = {}
        if distributed:
            for ax in AXIS_ORDER:
                if self.shape[ax] > 1:
                    self._make_groups((ax,))
            if math.prod(self.shape[ax] for ax in BATCH_AXES) > 1:
                self._make_groups(BATCH_AXES)

    def _lines(self, axes: Tuple[str, ...]) -> np.ndarray:
        """[n_lines, line size]: each row the ranks of one line over
        ``axes``, ordered by their coordinates (row-major in ``axes``)."""

        idx = [AXIS_ORDER.index(ax) for ax in axes]
        rest = [i for i in range(len(AXIS_ORDER)) if i not in idx]
        moved = np.transpose(self.ranks, rest + idx)
        return moved.reshape(-1, math.prod(self.shape[ax] for ax in axes))

    def line(self, axes: Sequence[str], rank: int) -> List[int]:
        """The ranks of ``rank``'s line over ``axes``, in coordinate
        order (its own included)."""

        for row in self._lines(tuple(axes)):
            if rank in row:
                return [int(r) for r in row]
        raise ValueError(f"rank {rank} is not in the mesh")

    def index(self, axes: Sequence[str], rank: int) -> int:
        """``rank``'s position in its line over ``axes``: for the batch
        axes, the batch shard it holds."""

        return self.line(axes, rank).index(rank)

    def _make_groups(self, axes: Tuple[str, ...]) -> None:
        import torch.distributed as dist

        me = dist.get_rank()
        for row in self._lines(axes):
            ranks = [int(r) for r in row]
            if ranks != sorted(ranks):
                # a group's collectives order its members by rank
                raise NotImplementedError(f"the line {ranks} over {axes} is not in rank order")
            g = dist.new_group(ranks)
            if me in ranks:
                self._groups[axes] = g

    def group(self, axes: Sequence[str]):
        """This rank's process group over ``axes``; None where the line
        is one rank (no collective is needed) or no world was joined.
        The first call for a combination not made at construction is
        collective (module docstring)."""

        axes = tuple(ax for ax in AXIS_ORDER if ax in tuple(axes))
        if not self._distributed or math.prod(self.shape[ax] for ax in axes) <= 1:
            return None
        if axes not in self._groups:
            self._make_groups(axes)
        return self._groups[axes]


def make_mesh(shape: Optional[Mapping[str, int]] = None, *, slices: Optional[int] = None,
              world: Optional[int] = None) -> Mesh:
    """A mesh with the canonical named axes over the job's ranks (the JAX
    ``make_mesh``'s rules).

    ``shape`` maps axis name -> size; one size may be -1 (the ranks
    left); missing axes get size 1; default: every rank on dp.
    ``slices`` makes the mesh slice-aware: each slice's ranks (a
    contiguous block, the operator's pod numbering slice * H + host) form
    an intra-slice sub-mesh with dp / slices, and the sub-meshes are
    concatenated along dp, so dp is the only axis that crosses a slice.
    ``slices=None`` reads ``MEGASCALE_NUM_SLICES``
    (``bootstrap/tpu_env.detected_slice_topology``).  A dp extent that
    the slices do not divide is refused, as is any model axis that would
    cross a slice.

    ``world``: the rank count; default the joined world's (1 outside
    one).  Groups are made only in a joined world of more than one rank,
    whose size ``world`` must then be."""

    from tf_operator_tpu_torch.runtime.bootstrap import world as joined

    joined_world = joined()[1]
    ndev = joined_world if world is None else int(world)
    if joined_world > 1 and ndev != joined_world:
        raise ValueError(f"a mesh of {ndev} ranks in a world of {joined_world}")
    distributed = joined_world > 1
    shape = dict(shape or {AXIS_DP: ndev})
    unknown = set(shape) - set(AXIS_ORDER)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}; valid: {AXIS_ORDER}")

    if slices is None:
        from tf_operator_tpu_torch.bootstrap.tpu_env import detected_slice_topology

        slices, _ = detected_slice_topology()
    slices = max(1, int(slices))

    sizes: Dict[str, int] = {ax: int(shape.get(ax, 1)) for ax in AXIS_ORDER}
    wild = [ax for ax, s in sizes.items() if s == -1]
    if len(wild) > 1:
        raise ValueError("at most one axis may be -1")
    if wild:
        known = math.prod(s for s in sizes.values() if s != -1)
        if ndev % known:
            raise ValueError(f"{ndev} devices not divisible by {known}")
        sizes[wild[0]] = ndev // known
    if math.prod(sizes.values()) != ndev:
        raise ValueError(f"mesh shape {sizes} != {ndev} devices")

    dims = tuple(sizes[ax] for ax in AXIS_ORDER)
    dp_axis = AXIS_ORDER.index(AXIS_DP)
    if slices > 1:
        if ndev % slices:
            raise ValueError(f"{ndev} devices do not divide into {slices} slices")
        if sizes[AXIS_DP] % slices:
            would_cross = [ax for ax in (AXIS_PP, *MODEL_AXES) if sizes[ax] > 1]
            raise ValueError(
                f"slice-aware mesh: dp={sizes[AXIS_DP]} is not divisible by "
                f"slices={slices}, so the slice dimension would have to ride "
                f"a model axis ({', '.join(would_cross) or 'none available'}) "
                "across DCN — refused (bandwidth-bound collectives do not "
                "belong on the cross-slice fabric).  Give dp an extent "
                "divisible by the slice count (dp varies across slices; "
                "fsdp/tp/sp/ep stay within a slice), or pass slices=1 to "
                "explicitly opt into a topology-blind mesh."
            )
        per = ndev // slices
        intra = list(dims)
        intra[dp_axis] = sizes[AXIS_DP] // slices
        ranks = np.concatenate(
            [np.arange(s * per, (s + 1) * per).reshape(intra) for s in range(slices)],
            axis=dp_axis)
    else:
        ranks = np.arange(ndev).reshape(dims)
    slice_ids = np.zeros(dims, dtype=np.int64)
    if slices > 1:
        dp_size = dims[dp_axis]
        dp_index = np.arange(dp_size) // (dp_size // slices)
        slice_ids += dp_index.reshape([1] * dp_axis + [dp_size]
                                      + [1] * (len(dims) - dp_axis - 1))
    mesh = Mesh(ranks, slice_ids, distributed=False)
    links = mesh_axis_links(mesh)
    crossing = [ax for ax in MODEL_AXES if links[ax] == FABRIC_DCN]
    if crossing:
        raise ValueError(
            f"model axes {crossing} span a slice boundary (DCN) — their "
            "collectives are bandwidth-bound and must stay on ICI"
        )
    return Mesh(ranks, slice_ids, distributed=distributed) if distributed else mesh


def slice_count(mesh: Mesh) -> int:
    """Number of distinct slices the mesh spans (1: no cross-slice link
    anywhere, and the trainer's flat grad sync is the one to run)."""

    return int(len(np.unique(mesh.slice_ids)))


def mesh_axis_links(mesh: Mesh) -> Dict[str, str]:
    """Which fabric each axis's collectives ride: ``"dcn"`` where moving
    along the axis, every other coordinate fixed, can change the slice,
    else ``"ici"``."""

    ids = mesh.slice_ids
    out: Dict[str, str] = {}
    for i, ax in enumerate(mesh.axis_names):
        varies = bool(np.any(ids.max(axis=i) != ids.min(axis=i)))
        out[ax] = FABRIC_DCN if varies else FABRIC_ICI
    return out


def data_parallel_size(mesh: Mesh) -> int:
    return mesh.shape[AXIS_DP] * mesh.shape[AXIS_FSDP]


def local_batch_size(mesh: Mesh, global_batch: int) -> int:
    n = data_parallel_size(mesh)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by dp size {n}")
    return global_batch // n
