"""Byte-level llama pretraining, then a sample (the port of
``examples/llama_pretrain.py``), on one device or as one rank of a job.

    python -m tf_operator_tpu_torch.llama_pretrain --model llama-wide \\
        --seq-len 2048 --batch-per-device 4 --steps 30
    python -m tf_operator_tpu_torch.llama_pretrain --device cpu \\
        --model llama-tiny --seq-len 128 --batch-per-device 8 --steps 30

Under the operator (the ``TPUJOB_*`` environment) the process first
joins the job's world (``runtime/bootstrap.initialize``) and the N ranks
train one model over the mesh ``{"sp": 1, "fsdp": N}`` with the llama
family's logical shardings, as the JAX entry does: each rank keeps its
shard of the masters and trains on its rows of the global batch
(``--batch-per-device`` x N).  The coordinator generates the corpus
(data/text.py) under ``--data-dir``; the others wait for it.

The trainer (parallel/trainer.py) runs AdamW with a 10-update warmup on
float32 master weights, computing in bf16; attention runs the flash
kernels on the card, at each rank's local batch.  ``--export-dir``
writes a serving artifact (``params.npz`` + ``model.json``) that
``serve_lm --artifact`` serves; ``--generate N`` samples N greedy bytes
after training.  In a job both gather the weights first (every rank),
and process 0 writes and samples.

Weights are random from seed 0.  The moe family (``--family``) and
sequence parallelism (``--sp``) wait for later slices; the parser
refuses their flags.
"""

from __future__ import annotations

import argparse
import functools
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from tf_operator_tpu_torch.data.text import (
    TextBatches,
    as_lm_batches,
    decode_bytes,
    ensure_text,
    text_meta,
    wait_for_dataset,
)
from tf_operator_tpu_torch.models.decode import generate
from tf_operator_tpu_torch.models.llama import (
    LlamaLM,
    llama_loss,
    llama_loss_chunked,
    llama_tiny,
    llama_wide,
)
from tf_operator_tpu_torch.models.weights import init_params
from tf_operator_tpu_torch.parallel.checkpoint import export_params
from tf_operator_tpu_torch.parallel.mesh import make_mesh
from tf_operator_tpu_torch.parallel.trainer import Trainer, TrainerConfig
from tf_operator_tpu_torch.runtime.bootstrap import entry_device, initialize, world
from tf_operator_tpu_torch.runtime.harness import (
    batch_sizes,
    gather_params,
    standard_parser,
    train_loop,
)

MODELS = ("llama-tiny", "llama-wide")
INIT_SEED = 0
PROMPT = "the sharded "


def parser() -> argparse.ArgumentParser:
    p = standard_parser(__doc__.split("\n")[0], steps=60, batch_per_device=8,
                        learning_rate=3e-3)
    p.add_argument("--model", choices=MODELS, default="llama-tiny",
                   help="llama-tiny (vocab 256) or llama-wide (~700M, vocab 32000)")
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--data-dir", default="build/data/text")
    p.add_argument("--chunked-loss", type=int, default=0, metavar="N",
                   help="stream the head + cross-entropy over N sequence chunks "
                   "(llama_loss_chunked); 0 = full-logits loss")
    p.add_argument("--export-dir", default="",
                   help="write a serving artifact here after training")
    p.add_argument("--generate", type=int, default=48,
                   help="greedy bytes to sample after training (0 = none)")
    return p


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = parser()
    args = p.parse_args(argv)
    if args.steps < 1 or args.batch_per_device < 1 or args.seq_len < 2:
        p.error("--steps, --batch-per-device must be >= 1 and --seq-len >= 2")
    return args


def model_config(name: str, seq_len: int):
    if name == "llama-wide":
        return llama_wide(max_len=seq_len)
    # byte-level: the tiny model's vocab is the 256 bytes
    return llama_tiny(vocab_size=256, max_len=seq_len)


def run(args: argparse.Namespace) -> Dict:
    """Train as ``args`` say; returns the trainer, the losses, the
    timings, ``train_loop``'s ``stats`` (``loop``) and the sample."""

    ctx = initialize(args.device)
    rank, n = world()
    device = entry_device(args.device, ctx)
    cfg = model_config(args.model, args.seq_len)
    model = LlamaLM.from_state_dict(
        cfg, init_params(cfg, INIT_SEED, device, trainable=True), device, trainable=True)
    loss_fn = (functools.partial(llama_loss_chunked, n_chunks=args.chunked_loss)
               if args.chunked_loss else llama_loss)
    mesh = make_mesh({"sp": 1, "fsdp": n}) if n > 1 else None
    trainer = Trainer(model, TrainerConfig(learning_rate=args.learning_rate, warmup_steps=10),
                      loss_fn, mesh=mesh, shardings="logical")
    if rank == 0:
        ensure_text(args.data_dir, seq_len=args.seq_len)
    else:
        wait_for_dataset(args.data_dir, meta=text_meta(seq_len=args.seq_len))
    global_batch, _ = batch_sizes(args.batch_per_device)
    shard = (trainer.batch_index, n) if mesh is not None else (0, 1)
    batches = as_lm_batches(TextBatches(args.data_dir, global_batch, seed=INIT_SEED,
                                        shard=shard))
    tag = f"{args.model} bytes seq={args.seq_len} batch={args.batch_per_device}"
    if mesh is not None:
        tag += f" fsdp={n} sp=1"
    stats: Dict = {}
    t0 = time.perf_counter()
    losses = train_loop(trainer, batches, args.steps, steps_per_sync=args.steps_per_sync,
                        tag=tag, stats=stats)
    wall = time.perf_counter() - t0
    out = {"trainer": trainer, "losses": losses, "wall_s": wall,
           "resolved_at": stats["resolved_at"], "loop": stats, "sample": None}
    if args.export_dir:
        export_params(trainer, args.export_dir)
        if rank == 0:
            print(f"exported serving artifact to {args.export_dir}", flush=True)
    n_new = min(args.generate, args.seq_len - len(PROMPT))
    if args.generate:
        # the gather is collective: every rank takes part, process 0 samples
        gather_params(trainer)
    if args.generate and rank == 0 and n_new < 1:
        print(f"seq-len {args.seq_len} leaves no room after the {len(PROMPT)}-byte "
              "prompt; skipping generation", flush=True)
    elif args.generate and rank == 0:
        prompt = torch.as_tensor(np.frombuffer(PROMPT.encode(), np.uint8)[None].astype(np.int64))
        ids = generate(trainer.model, prompt.to(device), n_new)
        out["sample"] = decode_bytes(ids[0, len(PROMPT):].cpu().numpy())
        print(f"prompt: {PROMPT!r}")
        print(f"sample: {out['sample']!r}", flush=True)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
