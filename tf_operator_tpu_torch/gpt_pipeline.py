"""Pipeline-parallel GPT training: the pp axis end to end (the port of
``examples/gpt_pipeline.py``).

A causal LM whose decoder stack is split into ``--pp`` stages
(models/pipelined_lm.py), each rank holding its stage, activations
moving stage to stage by ppermute under the GPipe schedule
(parallel/pipeline.py), composed with data parallelism over the rest of
the ranks: the mesh is ``{"pp": pp, "dp": N // pp}`` over the job's N
processes, one device each; N must divide by pp (else exit 2).

    # two ranks (the TPUJOB_* environment of a job of 2 processes)
    python -m tf_operator_tpu_torch.gpt_pipeline --pp 2 --steps 10
    python -m tf_operator_tpu_torch.gpt_pipeline --device cpu --pp 1 --family llama

``--family gpt`` builds learned positions and relu MLPs with biases,
``--family llama`` RoPE, GQA (4 query heads over 2 KV heads) and
SwiGLU without biases; 4 heads of ``--hidden`` / 4, vocab 512.  Every
rank draws the same ids (``RandomState(0)``, the batch rounded up to a
multiple of ``--microbatches`` a dp shard) and trains them every step
with optax.adamw's own update (weight decay 1e-4 on every leaf, no mask,
no clip: not the Trainer's chain) through ``runtime/harness.train_loop``.

On the card K1–K3 take head dims of 32 to 128 (``ops/flash_attention``):
``--hidden`` must give hidden / 4 in that range (128 to 512).
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

import numpy as np
import torch

N_HEADS = 4
VOCAB = 512
INIT_SEED = 0


def parse_args(argv: Optional[List[str]] = None):
    from tf_operator_tpu_torch.runtime.harness import standard_parser

    parser = standard_parser(__doc__.split("\n")[0], learning_rate=1e-3)
    parser.add_argument("--pp", type=int, default=2, help="pipeline stages")
    parser.add_argument("--microbatches", type=int, default=4)
    parser.add_argument("--seq-len", type=int, default=64)
    parser.add_argument("--n-layers", type=int, default=4)
    parser.add_argument("--hidden", type=int, default=128)
    parser.add_argument(
        "--family", choices=["gpt", "llama"], default="gpt",
        help="block family for the stages: gpt (learned pos, relu) or "
             "llama (RoPE + GQA + SwiGLU, no biases)",
    )
    return parser.parse_args(argv)


def model_config(args):
    from tf_operator_tpu_torch.models.transformer import TransformerConfig

    llama = args.family == "llama"
    return TransformerConfig(
        vocab_size=VOCAB,
        hidden=args.hidden,
        n_heads=N_HEADS,
        head_dim=args.hidden // N_HEADS,
        n_layers=args.n_layers,
        mlp_dim=(11 * args.hidden // 4) if llama else 4 * args.hidden,
        max_len=args.seq_len,
        rope=llama,
        attn_bias=not llama,
        n_kv_heads=2 if llama else None,
    )


class _Loop:
    """The functional step of the reference (loss, grads, adamw) behind
    the harness's trainer protocol."""

    def __init__(self, model, optimizer):
        self.model, self.optimizer = model, optimizer

    def train_step(self, ids: torch.Tensor) -> Dict[str, torch.Tensor]:
        model = self.model
        for p in model.parameters():
            p.grad = None
        loss = model.loss(ids)
        loss.backward()
        model.sync_grads()
        self.optimizer.step([p.grad for p in model.parameters()])
        return {"loss": model.global_mean(loss)}


def run(args) -> Optional[Dict]:
    """Train as ``args`` say; None (after the reference's message) where
    the job's processes do not divide by pp."""

    from tf_operator_tpu_torch.models.pipelined_lm import PipelinedLM
    from tf_operator_tpu_torch.parallel.mesh import AXIS_DP, make_mesh
    from tf_operator_tpu_torch.parallel.trainer import Optimizer, TrainerConfig
    from tf_operator_tpu_torch.runtime.bootstrap import entry_device, initialize, world
    from tf_operator_tpu_torch.runtime.harness import train_loop

    ctx = initialize(args.device)
    rank, n_dev = world()
    device = entry_device(args.device, ctx)
    if n_dev % args.pp:
        print(f"{n_dev} devices not divisible by pp={args.pp}", file=sys.stderr)
        return None
    mesh = make_mesh({"pp": args.pp, "dp": n_dev // args.pp})
    family = args.family
    model = PipelinedLM(model_config(args), mesh, microbatches=args.microbatches,
                        activation="swiglu" if family == "llama" else "relu",
                        device=device).init_params(INIT_SEED)
    dp = mesh.shape[AXIS_DP]
    # batch-per-device keeps its meaning (rows per dp shard), rounded UP
    # to a multiple of microbatches so each microbatch's rows shard evenly
    m = args.microbatches
    bpd = -(-max(args.batch_per_device, 1) // m) * m
    ids = np.random.RandomState(0).randint(0, VOCAB, size=(bpd * dp, args.seq_len))
    shard = mesh.index((AXIS_DP,), rank) if dp > 1 else 0
    local = torch.as_tensor(ids[shard * bpd:(shard + 1) * bpd].astype(np.int64), device=device)
    params = list(model.parameters())
    optimizer = Optimizer(TrainerConfig(learning_rate=args.learning_rate, weight_decay=1e-4,
                                        grad_clip=0.0), params, decay=[True] * len(params))
    loop = _Loop(model, optimizer)
    stats: Dict = {}
    losses = train_loop(loop, local, args.steps,
                        tag=f"{family} pp={args.pp} dp={dp} mb={args.microbatches}",
                        steps_per_sync=args.steps_per_sync, stats=stats)
    return {"model": model, "losses": losses, "loop": stats, "mesh": mesh}


def main(argv: Optional[List[str]] = None) -> int:
    return 0 if run(parse_args(argv)) is not None else 2


if __name__ == "__main__":
    sys.exit(main())
