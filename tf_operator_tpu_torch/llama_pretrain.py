"""Byte-level llama pretraining, then a sample (the port of
``examples/llama_pretrain.py``), on one device or as one rank of a job.

    python -m tf_operator_tpu_torch.llama_pretrain --model llama-wide \\
        --seq-len 2048 --batch-per-device 4 --steps 30
    python -m tf_operator_tpu_torch.llama_pretrain --device cpu \\
        --model llama-tiny --seq-len 128 --batch-per-device 8 --steps 30
    python -m tf_operator_tpu_torch.llama_pretrain --family moe --steps 60

Under the operator (the ``TPUJOB_*`` environment) the process first
joins the job's world (``runtime/bootstrap.initialize``) and the N ranks
train one model over the mesh ``{"sp": SP, "fsdp": N // SP}`` with the
llama family's logical shardings, as the JAX entry does: each rank
keeps its shard of the masters and trains on its rows of the global
batch (``--batch-per-device`` x N rows).  With ``--sp SP`` above 1 the
SP ranks of an sp line read the same rows and each trains on its chunk
of the sequence, attention running the ``--sp-impl`` schedule (``ring``:
K/V hops, ``ulysses``: the heads <-> sequence all-to-all); SP must
divide N.  The coordinator generates the corpus (data/text.py) under
``--data-dir``; the others wait for it.

The trainer (parallel/trainer.py) runs AdamW with a 10-update warmup on
float32 master weights, computing in bf16; attention runs the flash
kernels on the card, at each rank's local batch.  ``--export-dir``
writes a serving artifact (``params.npz`` + ``model.json``) that
``serve_lm --artifact`` serves; ``--generate N`` samples N greedy bytes
after training.  In a job both gather the weights first (every rank),
and process 0 writes and samples (decoding ignores sp, as the
reference's does).

``--family moe`` trains the routed-expert LM instead (models/moe.py:
``moe_tiny`` at vocab 256 with ``--experts`` experts, 4 by default) on
``moe_lm_loss`` (the next-token loss plus the routers' auxiliary loss),
exports it as ``family: moe`` and samples through its dropless decoder.
In a job the mesh is the reference's ``{"ep": gcd(E, devices a process),
"dp": N // ep}``: with one device a process ep is 1, so the N ranks
train over dp with every expert on every rank, and the tag reads ``moe
bytes dp=N ep=1 E=...`` (the reference's two-worker job shows ep=2
because each of its workers holds two devices).  ``--family moe``
ignores ``--sp`` and ``--sp-impl``, as the reference does (its mesh is
the same whatever ``--sp`` says); beside ``--model llama-wide`` it is
refused at parse time.

Weights are random from seed 0.
"""

from __future__ import annotations

import argparse
import functools
import math
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
from tf_operator_tpu_torch.models.moe import MoeLM, moe_lm_loss, moe_tiny
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
    p.add_argument("--family", choices=["llama", "moe"], default="llama",
                   help="llama (RoPE+GQA+SwiGLU over fsdp[/sp]) or moe (top-2 routed "
                   "experts, moe_tiny at vocab 256, over dp x ep; ignores --sp)")
    p.add_argument("--experts", type=int, default=4, help="moe family: expert count")
    p.add_argument("--model", choices=MODELS, default="llama-tiny",
                   help="llama-tiny (vocab 256) or llama-wide (~700M, vocab 32000); "
                   "the llama family's shapes")
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--data-dir", default="build/data/text")
    p.add_argument("--chunked-loss", type=int, default=0, metavar="N",
                   help="stream the head + cross-entropy over N sequence chunks "
                   "(llama_loss_chunked); 0 = full-logits loss")
    p.add_argument("--export-dir", default="",
                   help="write a serving artifact here after training")
    p.add_argument("--generate", type=int, default=48,
                   help="greedy bytes to sample after training (0 = none)")
    p.add_argument("--sp", type=int, default=1, help="sequence-parallel axis size")
    p.add_argument("--sp-impl", choices=["ring", "ulysses"], default="ring")
    return p


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = parser()
    args = p.parse_args(argv)
    if args.steps < 1 or args.batch_per_device < 1 or args.seq_len < 2:
        p.error("--steps, --batch-per-device must be >= 1 and --seq-len >= 2")
    if args.family == "llama" and (args.sp < 1 or args.seq_len % args.sp):
        p.error(f"--sp must be >= 1 and divide --seq-len ({args.seq_len})")
    if args.family == "moe":
        if args.model != "llama-tiny":
            p.error(f"--family moe trains moe_tiny; --model {args.model} is a llama shape")
        if args.experts < 1:
            p.error("--experts must be >= 1")
    return args


def model_config(name: str, seq_len: int, **kw):
    """The model's config; ``kw``: the sequence-parallel mesh and
    sp_impl."""

    if name == "llama-wide":
        return llama_wide(max_len=seq_len, **kw)
    # byte-level: the tiny model's vocab is the 256 bytes
    return llama_tiny(vocab_size=256, max_len=seq_len, **kw)


def moe_mesh_shape(experts: int, n: int) -> Dict[str, int]:
    """The reference's moe mesh for ``n`` processes of one device each:
    ep = gcd(experts, devices a process) = 1, dp = n // ep."""

    ep = math.gcd(experts, 1)
    return {"ep": ep, "dp": n // ep}


def build(args: argparse.Namespace, device, n: int, dropout: Optional[float] = None):
    """(model, loss_fn, mesh, tag) of the family ``args`` names, for a
    world of ``n`` processes (a mesh only above one); ``dropout``
    overrides the moe configuration's (the reference's 0.1)."""

    if args.family == "moe":
        shape = moe_mesh_shape(args.experts, n)
        mesh = make_mesh(shape) if n > 1 else None
        cfg = moe_tiny(vocab_size=256, max_len=args.seq_len, num_experts=args.experts,
                       **({} if dropout is None else {"dropout": dropout}))
        model = MoeLM.from_state_dict(
            cfg, init_params(cfg, INIT_SEED, device, trainable=True, family=MoeLM), device,
            trainable=True)
        tag = f"moe bytes dp={shape['dp']} ep={shape['ep']} E={args.experts}"
        return model, moe_lm_loss, mesh, tag
    mesh = make_mesh({"sp": args.sp, "fsdp": n // args.sp}) if n > 1 else None
    cfg = model_config(args.model, args.seq_len, mesh=mesh, sp_impl=args.sp_impl)
    model = LlamaLM.from_state_dict(
        cfg, init_params(cfg, INIT_SEED, device, trainable=True), device, trainable=True)
    loss_fn = (functools.partial(llama_loss_chunked, n_chunks=args.chunked_loss)
               if args.chunked_loss else llama_loss)
    tag = f"{args.model} bytes seq={args.seq_len} batch={args.batch_per_device}"
    if mesh is not None:
        tag += f" fsdp={n // args.sp} sp={args.sp}({args.sp_impl})"
    return model, loss_fn, mesh, tag


def run(args: argparse.Namespace, dropout: Optional[float] = None) -> Dict:
    """Train as ``args`` say; returns the trainer, the losses, the
    timings, ``train_loop``'s ``stats`` (``loop``) and the sample.
    ``dropout`` overrides the moe configuration's."""

    ctx = initialize(args.device)
    rank, n = world()
    if args.family == "llama" and n % args.sp:
        raise ValueError(f"--sp {args.sp} does not divide the job's {n} processes")
    device = entry_device(args.device, ctx)
    model, loss_fn, mesh, tag = build(args, device, n, dropout)
    trainer = Trainer(model, TrainerConfig(learning_rate=args.learning_rate, warmup_steps=10),
                      loss_fn, mesh=mesh, shardings="logical")
    if rank == 0:
        ensure_text(args.data_dir, seq_len=args.seq_len)
    else:
        wait_for_dataset(args.data_dir, meta=text_meta(seq_len=args.seq_len))
    global_batch, _ = batch_sizes(args.batch_per_device, mesh)
    shard = (trainer.batch_index, trainer.batch_ranks) if mesh is not None else (0, 1)
    batches = (trainer.shard_batch(b) for b in as_lm_batches(
        TextBatches(args.data_dir, global_batch, seed=INIT_SEED, shard=shard)))
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
