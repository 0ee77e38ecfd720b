"""Params-only export for serving (the port of ``export_params`` in
``tf_operator_tpu/parallel/checkpoint.py``).

The artifact is a directory of two files: ``params.npz``, the float32
parameters under flat flax paths (the JAX package writes an orbax
checkpoint; the port has no orbax and writes npz), and ``model.json``,
the model's description (models/registry.describe_model), so that the
serving side rebuilds the exact architecture:

    python -m tf_operator_tpu_torch.serve_lm --weights DIR/params.npz \\
        --model-json DIR/model.json
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

    model = trainer.model
    os.makedirs(directory, exist_ok=True)
    save_npz(model.state_dict(), os.path.join(directory, PARAMS_FILE))
    tmp = os.path.join(directory, f".{MODEL_FILE}.{os.getpid()}.tmp")
    with open(tmp, "w") as f:
        json.dump(describe_model(model), f, indent=1)
    os.replace(tmp, os.path.join(directory, MODEL_FILE))
    return directory
