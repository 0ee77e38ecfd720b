"""Deterministic on-disk text corpus for byte-level LM training (the
port of ``tf_operator_tpu/data/text.py``).

The corpus is the JAX package's: sentences from a small templated
grammar over a fixed word list, drawn with ``np.random.RandomState``,
so the same seed gives the same bytes on both sides.  It is written
once to disk as non-overlapping windows ``tokens.npy`` [n, seq_len]
uint8 beside a meta commit record.  Ids are the bytes (< 256), valid
at any vocab of 256 or more.

The JAX package reads it through a grain loader with per-process
shards; the port reads it through :class:`TextBatches`, a seeded numpy
iterator that shuffles the windows anew each epoch.  In a job of
several processes the coordinator writes the corpus and the others wait
for its commit record (``data/synthetic.wait_for_dataset``, which the
corpus is committed through too); every process draws
the same global batch and keeps its rows ``[i * local, (i + 1) * local)``
(``shard=(i, n)``), so a one-process run on the global batch sees
exactly the rows a job of n processes trains on together.  Under
sequence parallelism n is the batch shards (dp x fsdp), not the
processes: the ranks of one sp line take the same shard and the trainer
cuts each its chunk of the sequence.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from tf_operator_tpu_torch.data.synthetic import _exists, commit_arrays, wait_for_dataset

__all__ = ["TextBatches", "as_lm_batches", "decode_bytes", "ensure_text", "text_meta",
           "wait_for_dataset"]

_NOUNS = (
    "operator worker slice tensor kernel gradient token shard mesh ring "
    "queue batch buffer device compiler schedule"
).split()
_VERBS = (
    "schedules reduces shards rotates compiles streams permutes gathers "
    "fuses drains adopts restarts"
).split()
_ADJS = (
    "sharded fused causal atomic idle hot replicated factored lazy strict"
).split()


def text_meta(n_chars: int = 1 << 20, seq_len: int = 256, seed: int = 0) -> dict:
    return {
        "kind": "grammar_bytes",
        "n_chars": n_chars,
        "seq_len": seq_len,
        "seed": seed,
    }


def _generate_corpus(n_chars: int, seed: int) -> str:
    r = np.random.RandomState(seed)
    parts = []
    total = 0
    while total < n_chars:
        s = (
            f"the {r.choice(_ADJS)} {r.choice(_NOUNS)} "
            f"{r.choice(_VERBS)} the {r.choice(_NOUNS)}. "
        )
        parts.append(s)
        total += len(s)
    return "".join(parts)[:n_chars]


def ensure_text(directory: str, n_chars: int = 1 << 20, seq_len: int = 256,
                seed: int = 0) -> str:
    """Generate (idempotent) and return the corpus directory: windows
    ``tokens.npy`` [n_windows, seq_len] uint8 and the meta record."""

    meta = text_meta(n_chars, seq_len, seed)
    if _exists(directory, meta):
        return directory
    text = _generate_corpus(n_chars, seed)
    tokens = np.frombuffer(text.encode("ascii"), dtype=np.uint8)
    n_windows = len(tokens) // seq_len
    commit_arrays(directory,
                  {"tokens.npy": tokens[: n_windows * seq_len].reshape(n_windows, seq_len)},
                  meta)
    return directory


def decode_bytes(arr) -> str:
    """uint8/int token array -> printable string (the 'detokenizer')."""

    b = np.asarray(arr).reshape(-1).astype(np.uint8).tobytes()
    return b.decode("ascii", errors="replace")


class TextBatches:
    """Batches {"input_ids": [B, seq_len] uint8} of the corpus windows:
    each epoch visits every whole batch of a fresh permutation drawn
    from ``np.random.default_rng(seed + epoch)``; the remainder of an
    epoch is dropped.  ``num_epochs=None`` runs forever.  ``shard=(i,
    n)``: ``batch_size`` is the global batch, and each yield holds its
    i-th of n equal row blocks."""

    def __init__(self, directory: str, batch_size: int, *, seed: int = 0,
                 num_epochs: Optional[int] = None, shard: Tuple[int, int] = (0, 1)):
        self.tokens = np.load(os.path.join(directory, "tokens.npy"), mmap_mode="r")
        if batch_size < 1 or batch_size > len(self.tokens):
            raise ValueError(
                f"batch_size {batch_size} must be in 1..{len(self.tokens)} (the windows)"
            )
        index, count = shard
        if batch_size % count or not 0 <= index < count:
            raise ValueError(f"shard {shard} of a global batch of {batch_size}")
        self.batch_size, self.seed, self.num_epochs = batch_size, seed, num_epochs
        local = batch_size // count
        self.rows = slice(index * local, (index + 1) * local)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n, b = len(self.tokens), self.batch_size
        epoch = 0
        while self.num_epochs is None or epoch < self.num_epochs:
            order = np.random.default_rng(self.seed + epoch).permutation(n)
            for i in range(0, n - b + 1, b):
                yield {"input_ids": np.asarray(self.tokens[order[i:i + b][self.rows]])}
            epoch += 1


def as_lm_batches(loader):
    """Loader dicts -> int32 model batches (the byte 'tokenizer' is a
    cast)."""

    for batch in loader:
        yield {"input_ids": batch["input_ids"].astype(np.int32)}
