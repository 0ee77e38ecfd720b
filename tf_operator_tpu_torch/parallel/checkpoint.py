"""Params-only export for serving (the port of ``export_params`` in
``tf_operator_tpu/parallel/checkpoint.py``).

The artifact is a directory of two files: ``params.npz``, the float32
parameters under flat flax paths (the JAX package writes an orbax
checkpoint; the port has no orbax and writes npz), and ``model.json``,
the model's description (models/registry.describe_model), so that the
serving side rebuilds the exact architecture:

    python -m tf_operator_tpu_torch.serve_lm --artifact DIR

A trainer over a mesh holds each rank's shard of the masters: the export
gathers the full weights first (collective: every rank calls it), then
process 0 writes and the other ranks wait for it at a barrier.
"""

from __future__ import annotations

import json
import os

from tf_operator_tpu_torch.models.registry import describe_model
from tf_operator_tpu_torch.models.weights import save_npz

PARAMS_FILE = "params.npz"
MODEL_FILE = "model.json"


def export_params(trainer, directory: str) -> str:
    """Write the trained model of ``trainer`` as a serving artifact into
    ``directory`` (overwriting one there) and return the directory."""

    from tf_operator_tpu_torch.runtime.bootstrap import world

    model = trainer.model
    if getattr(trainer, "mesh", None) is not None:
        trainer.gather()
    rank, n = world()
    if rank != 0:
        _barrier()
        return directory
    os.makedirs(directory, exist_ok=True)
    save_npz(model.state_dict(), os.path.join(directory, PARAMS_FILE))
    tmp = os.path.join(directory, f".{MODEL_FILE}.{os.getpid()}.tmp")
    with open(tmp, "w") as f:
        json.dump(describe_model(model), f, indent=1)
    os.replace(tmp, os.path.join(directory, MODEL_FILE))
    if n > 1:
        _barrier()
    return directory


def _barrier() -> None:
    import torch.distributed as dist

    dist.barrier()
