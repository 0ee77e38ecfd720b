"""ViT image classification on a synthetic batch (the port of
``examples/vit_classify.py``), on one device or as one rank of a job.

    python -m tf_operator_tpu_torch.vit_classify --model vit_b16 \\
        --image-size 224 --num-classes 1000
    python -m tf_operator_tpu_torch.vit_classify --device cpu --model vit_tiny \\
        --batch-per-device 8 --steps 20

Each process draws its batch shard from
``np.random.RandomState(Trainer.batch_index)``: ``--batch-per-device``
float32 images in [0, 1) of ``--image-size`` px and integer labels
below ``--num-classes``.  Without tp the index is the process's, as the
reference draws it; the ranks of a tp line draw the same shard, that of
their coordinate on dp (the reference's process holds its tp devices
itself).  AdamW at ``--learning-rate`` (no warmup, as the
reference's) on float32 masters, bf16 compute, dropout 0.1 (the
reference's default); attention runs the flash kernels on the card.
``train_loop`` (which exits 1 if the loss did not fall over >= 20
steps), then ``Trainer.benchmark`` over ``max(steps // 2, 5)`` more
steps, printed as ``{tag}: {x:.1f} ex/s global``.

Under the operator (the ``TPUJOB_*`` environment) the N ranks train over
the mesh ``{"dp": N / tp, "tp": tp}`` with the logical shardings: under
``--tp`` above 1 each rank of a tp line holds its share of the heads,
MLP columns and classes (parallel/tensor_parallel.py).  A ``--tp`` that
does not divide the world is refused, as the reference's assert refuses
it.  Weights are random from seed 0.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from tf_operator_tpu_torch.models.vit import ViT, vit_b16, vit_loss, vit_tiny
from tf_operator_tpu_torch.models.weights import init_params
from tf_operator_tpu_torch.parallel.mesh import make_mesh
from tf_operator_tpu_torch.parallel.trainer import Trainer, TrainerConfig
from tf_operator_tpu_torch.runtime.bootstrap import entry_device, initialize, world
from tf_operator_tpu_torch.runtime.harness import batch_sizes, standard_parser, train_loop

INIT_SEED = 0
MODELS = {"vit_b16": vit_b16, "vit_tiny": vit_tiny}


def parser() -> argparse.ArgumentParser:
    p = standard_parser(__doc__.split("\n")[0], learning_rate=3e-3)
    p.add_argument("--model", choices=sorted(MODELS), default="vit_tiny")
    p.add_argument("--image-size", type=int, default=32)
    p.add_argument("--num-classes", type=int, default=10)
    p.add_argument("--tp", type=int, default=1, help="tensor axis size")
    return p


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = parser()
    args = p.parse_args(argv)
    if min(args.steps, args.batch_per_device, args.image_size, args.num_classes,
           args.tp) < 1:
        p.error("--steps, --batch-per-device, --image-size, --num-classes and --tp "
                "must be >= 1")
    return args


def make_batch(args: argparse.Namespace, rows: int, shard: int = 0
               ) -> Dict[str, np.ndarray]:
    """The fixed rows of batch shard ``shard`` (the reference's batch of
    the process of that index: its ``RandomState``)."""

    rng = np.random.RandomState(shard)
    s = args.image_size
    return {"image": rng.rand(rows, s, s, 3).astype(np.float32),
            "label": rng.randint(0, args.num_classes, size=(rows,)).astype(np.int32)}


def run(args: argparse.Namespace) -> Dict:
    """Train as ``args`` say, then benchmark.  Returns the trainer, its
    batch, the losses, the wall, the resolve times, ``train_loop``'s
    ``stats`` (``loop``) and the benchmark's numbers."""

    ctx = initialize(args.device)
    _, n = world()
    if n % args.tp:
        raise ValueError(f"--tp {args.tp} does not divide the job's {n} processes")
    device = entry_device(args.device, ctx)
    mesh = make_mesh({"dp": n // args.tp, "tp": args.tp}) if n > 1 else None
    vcfg = MODELS[args.model](image_size=args.image_size, n_classes=args.num_classes)
    state = init_params(vcfg, INIT_SEED, device, trainable=True, family=ViT)
    model = ViT.from_state_dict(vcfg, state, device, trainable=True)
    trainer = Trainer(model, TrainerConfig(optimizer="adamw", learning_rate=args.learning_rate),
                      vit_loss, mesh=mesh, shardings="logical")
    _, local_batch = batch_sizes(args.batch_per_device, mesh)
    # this rank's shard alone, straight to the device: the ranks of a tp
    # line draw the same rows, which shard_batch's guard cannot know
    shard = trainer.batch_index if mesh is not None else 0
    batch = {k: torch.as_tensor(v).to(device)
             for k, v in make_batch(args, local_batch, shard).items()}
    tag = f"{args.model} dp={n // args.tp} tp={args.tp}"
    stats: Dict = {}
    t0 = time.perf_counter()
    losses = train_loop(trainer, batch, args.steps, tag=tag,
                        steps_per_sync=args.steps_per_sync, stats=stats)
    wall = time.perf_counter() - t0
    bench = trainer.benchmark(batch, steps=max(args.steps // 2, 5), warmup=0)
    print(f"{tag}: {bench['examples_per_sec']:.1f} ex/s global", flush=True)
    return {"trainer": trainer, "batch": batch, "losses": losses, "wall_s": wall,
            "resolved_at": stats["resolved_at"], "loop": stats, "benchmark": bench}


def main(argv: Optional[List[str]] = None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
