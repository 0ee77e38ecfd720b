"""Data sources of the port (numpy only): on-disk datasets and their
per-process sharded loaders (the JAX package's ``data/`` exports, where
the port has them)."""

from tf_operator_tpu_torch.data.loader import NpySource, device_prefetch, make_loader
from tf_operator_tpu_torch.data.synthetic import (
    ensure_imagenet_like,
    ensure_mnist,
    wait_for_dataset,
)
from tf_operator_tpu_torch.data.text import as_lm_batches, decode_bytes, ensure_text

__all__ = [
    "NpySource",
    "as_lm_batches",
    "decode_bytes",
    "device_prefetch",
    "ensure_imagenet_like",
    "ensure_mnist",
    "ensure_text",
    "make_loader",
    "wait_for_dataset",
]
