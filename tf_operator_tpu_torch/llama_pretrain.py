"""Byte-level llama pretraining on one device, then a sample (the port
of ``examples/llama_pretrain.py``).

    python -m tf_operator_tpu_torch.llama_pretrain --model llama-wide \\
        --seq-len 2048 --batch 4 --steps 30
    python -m tf_operator_tpu_torch.llama_pretrain --device cpu \\
        --model llama-tiny --seq-len 128 --batch 8 --steps 30

The corpus (data/text.py) is generated once under ``--data-dir``; the
trainer (parallel/trainer.py) runs AdamW with a 10-update warmup on
float32 master weights, computing in bf16; attention runs the flash
kernels on the card.  ``--export-dir`` writes a serving artifact
(``params.npz`` + ``model.json``) that ``serve_lm --weights`` serves;
``--generate N`` samples N greedy bytes after training.

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

from tf_operator_tpu_torch.data.text import TextBatches, as_lm_batches, decode_bytes, ensure_text
from tf_operator_tpu_torch.device import resolve_device
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
from tf_operator_tpu_torch.parallel.trainer import Trainer, TrainerConfig
from tf_operator_tpu_torch.runtime.harness import standard_parser, train_loop

MODELS = ("llama-tiny", "llama-wide")
INIT_SEED = 0
PROMPT = "the sharded "


def parser() -> argparse.ArgumentParser:
    p = standard_parser(__doc__.split("\n")[0], steps=60, batch=8, learning_rate=3e-3)
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
    if args.steps < 1 or args.batch < 1 or args.seq_len < 2:
        p.error("--steps, --batch must be >= 1 and --seq-len >= 2")
    return args


def model_config(name: str, seq_len: int):
    if name == "llama-wide":
        return llama_wide(max_len=seq_len)
    # byte-level: the tiny model's vocab is the 256 bytes
    return llama_tiny(vocab_size=256, max_len=seq_len)


def run(args: argparse.Namespace) -> Dict:
    """Train as ``args`` say; returns the trainer, the losses, the
    timings and the sample."""

    device = resolve_device(args.device)
    cfg = model_config(args.model, args.seq_len)
    model = LlamaLM.from_state_dict(
        cfg, init_params(cfg, INIT_SEED, device, trainable=True), device, trainable=True)
    loss_fn = (functools.partial(llama_loss_chunked, n_chunks=args.chunked_loss)
               if args.chunked_loss else llama_loss)
    trainer = Trainer(model, TrainerConfig(learning_rate=args.learning_rate, warmup_steps=10),
                      loss_fn)
    ensure_text(args.data_dir, seq_len=args.seq_len)
    batches = as_lm_batches(TextBatches(args.data_dir, args.batch, seed=INIT_SEED))
    stats: Dict = {}
    t0 = time.perf_counter()
    losses = train_loop(trainer, batches, args.steps, steps_per_sync=args.steps_per_sync,
                        tag=f"{args.model} bytes seq={args.seq_len} batch={args.batch}",
                        stats=stats)
    wall = time.perf_counter() - t0
    out = {"trainer": trainer, "losses": losses, "wall_s": wall,
           "resolved_at": stats["resolved_at"], "sample": None}
    if args.export_dir:
        export_params(trainer, args.export_dir)
        print(f"exported serving artifact to {args.export_dir}", flush=True)
    n_new = min(args.generate, args.seq_len - len(PROMPT))
    if args.generate and n_new < 1:
        print(f"seq-len {args.seq_len} leaves no room after the {len(PROMPT)}-byte "
              "prompt; skipping generation", flush=True)
    elif args.generate:
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
