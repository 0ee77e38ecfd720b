"""ResNet data-parallel training (the port of ``examples/resnet_dp.py``),
on one device or as one rank of a job.

    python -m tf_operator_tpu_torch.resnet_dp --norm fused --model resnet50 \\
        --batch-per-device 64
    python -m tf_operator_tpu_torch.resnet_dp --device cpu --model resnet18 \\
        --image-size 32 --num-classes 10 --batch-per-device 8 --steps 20 --norm fused

Each process's fixed batch is drawn from
``np.random.RandomState(process_index)`` (float32 images in [0, 1),
integer labels, ``--batch-per-device`` rows); SGD with momentum 0.9
and clip 1.0 at ``--learning-rate``, ``train_loop`` (which exits 1 if
the loss did not fall over >= 20 steps), then ``Trainer.benchmark``
over ``max(steps // 2, 5)`` more steps, printed as ``{tag}: {x:.1f}
ex/s global``.  Weights are random from seed 0
(``models/resnet.init_resnet``).

Under the operator (the ``TPUJOB_*`` environment) the process joins the
job's world first, and the N ranks train over the mesh ``{"dp": N //
fsdp, "fsdp": fsdp}``: ``--fsdp`` must divide N; parameters take the
FSDP auto-rule, and the BatchNorm statistics are the global batch's
(``models/resnet.py``).

``--norm`` (not in the JAX entry) exposes the JAX package's own
``ResNet(norm=...)`` field: ``batchnorm`` (the default, the reference's)
or ``fused``, which runs every norm through the fused BatchNorm kernels
K5 and K6 on the card.  ``fused`` is refused in a world of more than one
process, as the JAX package refuses its Pallas norm on more than one
device: the kernels reduce one rank's rows.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from tf_operator_tpu_torch.models.resnet import NORMS, init_resnet, resnet18, resnet50
from tf_operator_tpu_torch.parallel.mesh import make_mesh
from tf_operator_tpu_torch.parallel.trainer import (
    Trainer,
    TrainerConfig,
    batchnorm_cross_entropy_loss,
)
from tf_operator_tpu_torch.runtime.bootstrap import entry_device, from_env, initialize, world
from tf_operator_tpu_torch.runtime.harness import batch_sizes, standard_parser, train_loop

INIT_SEED = 0
MODELS = {"resnet50": resnet50, "resnet18": resnet18}


def parser() -> argparse.ArgumentParser:
    p = standard_parser(__doc__.split("\n")[0])
    p.add_argument("--model", choices=sorted(MODELS), default="resnet50")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--fsdp", type=int, default=1,
                   help="fsdp axis size; it must divide the job's process count")
    p.add_argument("--norm", choices=NORMS, default="batchnorm",
                   help="batchnorm: the stock graph; fused: the fused BatchNorm kernels")
    return p


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = parser()
    args = p.parse_args(argv)
    ctx = from_env()
    n = ctx.num_processes if ctx is not None else 1
    if args.fsdp < 1 or n % args.fsdp:
        p.error(f"--fsdp {args.fsdp} must divide the job's {n} process(es)")
    if args.norm == "fused" and n > 1:
        p.error("--norm fused: the fused BatchNorm kernels reduce one rank's rows; a job of "
                f"{n} processes needs the batch-global statistics of --norm batchnorm")
    if args.steps < 1 or args.batch_per_device < 1 or args.image_size < 1:
        p.error("--steps, --batch-per-device and --image-size must be >= 1")
    return args


def make_batch(args: argparse.Namespace, process_index: int = 0) -> Dict[str, np.ndarray]:
    """The JAX entry's fixed batch of one process (its ``RandomState``)."""

    rng = np.random.RandomState(process_index)
    b, s = batch_sizes(args.batch_per_device)[1], args.image_size
    return {"image": rng.rand(b, s, s, 3).astype(np.float32),
            "label": rng.randint(0, args.num_classes, size=(b,)).astype(np.int32)}


def build_trainer(args: argparse.Namespace, device, plain_kernels: bool = False,
                  mesh=None) -> Trainer:
    model = MODELS[args.model](num_classes=args.num_classes, norm=args.norm,
                               plain_kernels=plain_kernels, device=device)
    init_resnet(model, INIT_SEED)
    return Trainer(model, TrainerConfig(optimizer="sgd", learning_rate=args.learning_rate),
                   batchnorm_cross_entropy_loss, mesh=mesh)


def run(args: argparse.Namespace) -> Dict:
    """Train as ``args`` say; returns the trainer, the losses, the
    resolve times, ``train_loop``'s ``stats`` (``loop``) and the
    benchmark's numbers."""

    ctx = initialize(args.device)
    rank, n = world()
    device = entry_device(args.device, ctx)
    mesh = make_mesh({"dp": n // args.fsdp, "fsdp": args.fsdp}) if n > 1 else None
    trainer = build_trainer(args, device, mesh=mesh)
    batch = trainer.shard_batch(make_batch(args, rank))
    tag = f"{args.model} dp={n // args.fsdp} fsdp={args.fsdp} norm={args.norm}"
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
