"""Params-only export for serving, and its loaders (the port of
``export_params``, ``export_merged_params``, ``load_model_description``
and ``load_params`` in ``tf_operator_tpu/parallel/checkpoint.py``).

The artifact is a directory of two files: ``params.npz``, the float32
parameters under flat flax paths (the JAX package writes an orbax
checkpoint; the port has no orbax and writes npz), and ``model.json``,
the model's description (models/registry.describe_model), so that the
serving side rebuilds the exact architecture:

    python -m tf_operator_tpu_torch.serve_lm --artifact DIR

A trainer over a mesh holds each rank's shard of the masters: the export
gathers the whole weights first, over fsdp and across the tp and ep
lines (``Trainer.full_params``; collective: every rank calls it), then
process 0 writes and the other ranks wait for it at a barrier.

A LoRA trainer (``models/lora.LoraModel``) holds only adapters: its
export bakes them into the base (``LoraModel.merged_params``) and
describes the wrapped family, so an adapter tree is never written under
the base's ``model.json``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional

import torch

from tf_operator_tpu_torch.models.lora import LoraModel
from tf_operator_tpu_torch.models.registry import describe_model
from tf_operator_tpu_torch.models.weights import load_npz, save_npz

PARAMS_FILE = "params.npz"
MODEL_FILE = "model.json"


def export_params(trainer, directory: str) -> str:
    """Write the trained model of ``trainer`` as a serving artifact into
    ``directory`` (overwriting one there) and return the directory."""

    model = trainer.model
    if isinstance(model, LoraModel):
        return export_merged_params(model.model, model.merged_params(), directory)
    state = model.state_dict()
    if getattr(trainer, "mesh", None) is not None:
        state.update(trainer.full_params())
    return export_merged_params(model, state, directory)


def export_merged_params(model, state: Mapping[str, torch.Tensor], directory: str) -> str:
    """The artifact of an explicit (model, state) pair: the core
    ``export_params`` delegates to, for states that never lived in a
    trainer (a LoRA merge, edited weights); ``model`` is the family the
    state fits.  In a job of several processes every rank calls it;
    process 0 writes and the others wait at a barrier."""

    from tf_operator_tpu_torch.runtime.bootstrap import world

    desc = describe_model(model)
    rank, n = world()
    if rank != 0:
        _barrier()
        return directory
    os.makedirs(directory, exist_ok=True)
    save_npz(state, os.path.join(directory, PARAMS_FILE))
    tmp = os.path.join(directory, f".{MODEL_FILE}.{os.getpid()}.tmp")
    with open(tmp, "w") as f:
        json.dump(desc, f, indent=1)
    os.replace(tmp, os.path.join(directory, MODEL_FILE))
    if n > 1:
        _barrier()
    return directory


def load_model_description(directory: str) -> Optional[Dict]:
    """The ``model.json`` an export wrote, or None where there is none;
    pair with ``models/registry.model_from_description``."""

    path = os.path.join(directory, MODEL_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def load_params(directory: str) -> Dict[str, torch.Tensor]:
    """The flat state (name -> float32 tensor on the CPU) of an export's
    ``params.npz``."""

    return load_npz(os.path.join(directory, PARAMS_FILE))


def _barrier() -> None:
    import torch.distributed as dist

    dist.barrier()
