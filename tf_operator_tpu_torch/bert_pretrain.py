"""BERT pretraining on synthetic MLM batches (the port of
``examples/bert_pretrain.py``; the reference's BASELINE config 3), on
one device or as one rank of a job.

    python -m tf_operator_tpu_torch.bert_pretrain --model bert_base \\
        --seq-len 128 --batch-per-device 32
    python -m tf_operator_tpu_torch.bert_pretrain --device cpu \\
        --model bert_tiny --seq-len 32 --batch-per-device 8 --steps 20

Each process's fixed batch is ``synthetic_mlm_batch(process index,
--batch-per-device, --seq-len, vocab)``: 15 % of the positions masked to
id 4 and labelled, the rest labelled -100.  The trainer
(parallel/trainer.py) runs AdamW at ``--learning-rate`` with a
10-update warmup on float32 masters, computing in bf16 with dropout 0.1
(the reference's default); attention runs the flash kernels on the
card.  ``train_loop`` prints the losses and exits 1 if the loss did not
fall over >= 20 steps.

Under the operator (the ``TPUJOB_*`` environment) the N ranks train one
model over the mesh ``{"fsdp": N}`` with the logical shardings: the
reference's translation of the parameter servers, every rank a shard of
the parameters and of their optimizer state.  Weights are random from
seed 0.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from tf_operator_tpu_torch.models.bert import BertForPretraining, bert_base, bert_tiny, mlm_loss
from tf_operator_tpu_torch.models.weights import init_params
from tf_operator_tpu_torch.parallel.mesh import make_mesh
from tf_operator_tpu_torch.parallel.trainer import Trainer, TrainerConfig
from tf_operator_tpu_torch.runtime.bootstrap import entry_device, initialize, world
from tf_operator_tpu_torch.runtime.harness import batch_sizes, standard_parser, train_loop

INIT_SEED = 0
#: model -> (config builder, vocab)
MODELS = {"bert_base": (bert_base, 30522), "bert_tiny": (bert_tiny, 1024)}


def synthetic_mlm_batch(rng: int, n: int, seq: int, vocab: int, mask_id: int = 4):
    """The reference's synthetic MLM batch: ids from [5, vocab), 15 % of
    the positions replaced by ``mask_id`` and labelled with the id they
    held, the rest labelled -100."""

    r = np.random.RandomState(rng)
    ids = r.randint(5, vocab, size=(n, seq)).astype(np.int32)
    labels = np.full((n, seq), -100, dtype=np.int32)
    mask = r.rand(n, seq) < 0.15
    labels[mask] = ids[mask]
    ids = np.where(mask, mask_id, ids)
    return {"input_ids": ids, "labels": labels}


def parser() -> argparse.ArgumentParser:
    p = standard_parser(__doc__.split("\n")[0], batch_per_device=8, learning_rate=1e-4)
    p.add_argument("--model", choices=sorted(MODELS), default="bert_base")
    p.add_argument("--seq-len", type=int, default=128)
    return p


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = parser()
    args = p.parse_args(argv)
    if args.steps < 1 or args.batch_per_device < 1 or args.seq_len < 1:
        p.error("--steps, --batch-per-device and --seq-len must be >= 1")
    return args


def run(args: argparse.Namespace, dropout: Optional[float] = None) -> Dict:
    """Train as ``args`` say; ``dropout`` overrides the configuration's
    rate (0.1: a job held against one process on the same global batch
    runs at 0, where no rank's masks differ from the process's).
    Returns the trainer, its batch, the losses, the wall, the resolve
    times and ``train_loop``'s ``stats`` (``loop``)."""

    ctx = initialize(args.device)
    rank, n = world()
    device = entry_device(args.device, ctx)
    mesh = make_mesh({"fsdp": n}) if n > 1 else None
    build, vocab = MODELS[args.model]
    cfg = build(max_len=args.seq_len, **({} if dropout is None else {"dropout": dropout}))
    state = init_params(cfg, INIT_SEED, device, trainable=True, family=BertForPretraining)
    model = BertForPretraining.from_state_dict(cfg, state, device, trainable=True)
    trainer = Trainer(model, TrainerConfig(learning_rate=args.learning_rate, warmup_steps=10),
                      mlm_loss, mesh=mesh, shardings="logical")
    _, local_batch = batch_sizes(args.batch_per_device, mesh)
    batch = trainer.shard_batch(synthetic_mlm_batch(rank, local_batch, args.seq_len, vocab))
    stats: Dict = {}
    t0 = time.perf_counter()
    losses = train_loop(trainer, batch, args.steps, tag=f"{args.model} fsdp={n}",
                        steps_per_sync=args.steps_per_sync, stats=stats)
    return {"trainer": trainer, "batch": batch, "losses": losses,
            "wall_s": time.perf_counter() - t0, "resolved_at": stats["resolved_at"],
            "loop": stats}


def main(argv: Optional[List[str]] = None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
