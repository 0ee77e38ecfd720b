"""Deterministic on-disk datasets, generated once (the port of
``tf_operator_tpu/data/synthetic.py``).

The datasets are the JAX package's, byte for byte: a learnable
procedural MNIST (each class a fixed random template, every example its
template plus noise) and an ImageNet-shaped one, drawn with
``np.random.RandomState`` and written as uint8 ``images.npy`` and int32
``labels.npy`` beside a ``meta.json`` commit record holding the
parameters they were generated with.  No download: the coordinator of a
job writes the dataset (``ensure_mnist``) and the other processes wait
for its commit record (:func:`wait_for_dataset`); ``data/loader.py``
reads it.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np

_META = "meta.json"


def wait_for_dataset(directory: str, timeout: float = 120.0,
                     meta: Optional[dict] = None) -> str:
    """Block until another process finishes generating ``directory``.

    A job generates on the coordinator only; the others call this with
    the coordinator's ``meta`` (``mnist_meta()``, ``text_meta(...)``),
    so that a stale dataset of other parameters does not satisfy the
    wait while the coordinator rewrites it.  Without ``meta`` any commit
    record will do."""

    deadline = time.time() + timeout
    while time.time() < deadline:
        if meta is not None:
            if _exists(directory, meta):
                return directory
        elif os.path.exists(os.path.join(directory, _META)):
            return directory
        time.sleep(0.2)
    raise TimeoutError(f"dataset never appeared at {directory}")


def mnist_meta(n: int = 16384, seed: int = 0, classes: int = 10) -> dict:
    return {"kind": "mnist-like", "n": n, "seed": seed, "classes": classes}


def commit_arrays(directory: str, arrays: dict, meta: dict) -> None:
    """Write ``arrays`` (file name -> array) and their commit record in
    two phases: the meta record is retracted first (readers poll it),
    each array lands through tmp + rename (a reader never maps half an
    array), and the meta record lands last.  So a regeneration over a
    stale dataset of other parameters is safe too."""

    os.makedirs(directory, exist_ok=True)
    meta_path = os.path.join(directory, _META)
    try:
        os.remove(meta_path)
    except FileNotFoundError:
        pass
    pid = os.getpid()
    for name, arr in arrays.items():
        # the tmp name must end in .npy, or np.save appends it
        tmp = os.path.join(directory, f".{name[:-4]}.{pid}.tmp.npy")
        np.save(tmp, arr)
        os.replace(tmp, os.path.join(directory, name))
    tmp = os.path.join(directory, f".{_META}.{pid}.tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, meta_path)


def _write(directory: str, images: np.ndarray, labels: np.ndarray, meta: dict) -> None:
    commit_arrays(directory, {"images.npy": images, "labels.npy": labels}, meta)


def _exists(directory: str, meta: dict) -> bool:
    try:
        with open(os.path.join(directory, _META)) as f:
            return json.load(f) == meta
    except (OSError, ValueError):
        return False


def ensure_mnist(directory: str, n: int = 16384, seed: int = 0, classes: int = 10) -> str:
    """The 28 x 28 x 1 uint8 dataset in MNIST's shape; idempotent."""

    meta = mnist_meta(n, seed, classes)
    if _exists(directory, meta):
        return directory
    r = np.random.RandomState(seed)
    templates = r.rand(classes, 28, 28, 1).astype(np.float32)
    labels = r.randint(0, classes, size=(n,)).astype(np.int32)
    noise = r.rand(n, 28, 28, 1).astype(np.float32)
    images = 0.7 * templates[labels] + 0.3 * noise
    _write(directory, (images * 255).astype(np.uint8), labels, meta)
    return directory


def ensure_imagenet_like(directory: str, n: int = 512, size: int = 224,
                         classes: int = 1000, seed: int = 0) -> str:
    """The 224 x 224 x 3 uint8 dataset in ImageNet's shape; idempotent.
    The class templates are drawn at 1/8 resolution and repeated up, so
    generating stays fast."""

    meta = {"kind": "imagenet-like", "n": n, "size": size, "seed": seed, "classes": classes}
    if _exists(directory, meta):
        return directory
    r = np.random.RandomState(seed)
    labels = r.randint(0, classes, size=(n,)).astype(np.int32)
    small = size // 8
    images = np.empty((n, size, size, 3), dtype=np.uint8)
    templates = r.rand(min(classes, 64), small, small, 3).astype(np.float32)
    for i in range(n):
        t = templates[labels[i] % len(templates)]
        up = np.repeat(np.repeat(t, 8, axis=0), 8, axis=1)
        img = 0.7 * up + 0.3 * r.rand(size, size, 3).astype(np.float32)
        images[i] = (img * 255).astype(np.uint8)
    _write(directory, images, labels, meta)
    return directory
