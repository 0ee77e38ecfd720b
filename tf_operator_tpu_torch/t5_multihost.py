"""T5 training on a synthetic seq2seq batch (the port of
``examples/t5_multihost.py``; the reference's BASELINE config 5), on one
device or as one rank of a job.

    python -m tf_operator_tpu_torch.t5_multihost --model t5_base
    python -m tf_operator_tpu_torch.t5_multihost --device cpu --model t5_tiny \\
        --steps 20

Every process builds the same global batch,
``synthetic_seq2seq_batch(0, --batch-per-device x dp, --enc-len,
--dec-len, vocab)``, and trains on its rows of it
(``Trainer.shard_global_batch``).  AdamW at ``--learning-rate`` with a
10-update warmup on float32 masters, bf16 compute, dropout 0.1 (the
reference's default).  The encoder's and the decoder's self-attentions
carry the relative-position bias and run the plain attention; the
cross-attentions run the flash kernels on the card.  ``train_loop``
prints the losses and exits 1 if the loss did not fall over >= 20
steps.

Under the operator (the ``TPUJOB_*`` environment) the N ranks train over
the mesh ``{"dp": N / tp, "tp": tp}`` with the logical shardings: under
``--tp`` above 1 the ranks of a tp line hold the same rows and each its
share of the heads, MLP columns and vocab (parallel/tensor_parallel.py),
and print the same losses.  A ``--tp`` that does not divide the world
is refused, as the reference's assert refuses it.  Weights are random
from seed 0.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from tf_operator_tpu_torch.models.t5 import T5, seq2seq_loss, t5_base, t5_tiny
from tf_operator_tpu_torch.models.weights import init_params
from tf_operator_tpu_torch.parallel.mesh import make_mesh
from tf_operator_tpu_torch.parallel.trainer import Trainer, TrainerConfig
from tf_operator_tpu_torch.runtime.bootstrap import entry_device, initialize, world
from tf_operator_tpu_torch.runtime.harness import standard_parser, train_loop

INIT_SEED = 0
#: model -> (config builder, vocab)
MODELS = {"t5_base": (t5_base, 32128), "t5_tiny": (t5_tiny, 1024)}


def synthetic_seq2seq_batch(rng: int, n: int, enc_len: int, dec_len: int, vocab: int):
    """The reference's synthetic batch: encoder ids, decoder ids and
    targets, each from [2, vocab)."""

    r = np.random.RandomState(rng)
    return {
        "encoder_ids": r.randint(2, vocab, size=(n, enc_len)).astype(np.int32),
        "decoder_ids": r.randint(2, vocab, size=(n, dec_len)).astype(np.int32),
        "targets": r.randint(2, vocab, size=(n, dec_len)).astype(np.int32),
    }


def parser() -> argparse.ArgumentParser:
    p = standard_parser(__doc__.split("\n")[0], batch_per_device=4, learning_rate=1e-4)
    p.add_argument("--model", choices=sorted(MODELS), default="t5_base")
    p.add_argument("--enc-len", type=int, default=64)
    p.add_argument("--dec-len", type=int, default=32)
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel axis size")
    return p


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = parser()
    args = p.parse_args(argv)
    if min(args.steps, args.batch_per_device, args.enc_len, args.dec_len, args.tp) < 1:
        p.error("--steps, --batch-per-device, --enc-len, --dec-len and --tp must be >= 1")
    return args


def run(args: argparse.Namespace) -> Dict:
    """Train as ``args`` say.  Returns the trainer, its batch, the
    losses, the wall, the resolve times and ``train_loop``'s ``stats``
    (``loop``)."""

    ctx = initialize(args.device)
    _, n = world()
    if n % args.tp:
        raise ValueError(f"--tp {args.tp} does not divide the job's {n} processes")
    device = entry_device(args.device, ctx)
    mesh = make_mesh({"dp": n // args.tp, "tp": args.tp}) if n > 1 else None
    build, vocab = MODELS[args.model]
    cfg = build()
    state = init_params(cfg, INIT_SEED, device, trainable=True, family=T5)
    model = T5.from_state_dict(cfg, state, device, trainable=True)
    trainer = Trainer(model, TrainerConfig(learning_rate=args.learning_rate, warmup_steps=10),
                      seq2seq_loss, mesh=mesh, shardings="logical")
    dp = n // args.tp
    batch = trainer.shard_global_batch(synthetic_seq2seq_batch(
        0, args.batch_per_device * dp, args.enc_len, args.dec_len, vocab))
    stats: Dict = {}
    t0 = time.perf_counter()
    losses = train_loop(trainer, batch, args.steps, tag=f"{args.model} dp={dp} tp={args.tp}",
                        steps_per_sync=args.steps_per_sync, stats=stats)
    return {"trainer": trainer, "batch": batch, "losses": losses,
            "wall_s": time.perf_counter() - t0, "resolved_at": stats["resolved_at"],
            "loop": stats}


def main(argv: Optional[List[str]] = None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
