"""dist-mnist, the canonical training job of the operator (the port of
the synthetic path of ``examples/dist_mnist.py``).

    python -m tf_operator_tpu_torch.dist_mnist [--device cpu] [--steps 30]

Every process joins the job's world from the injected environment
(``runtime/bootstrap.initialize``); the ranks train one ``MnistCNN``
(models/mnist.py, random from seed 0) over the mesh ``{"dp": N}``,
parameters replicated, SGD with momentum 0.9 at ``--learning-rate`` (no
clip, as the reference's ``optax.sgd``).  Step s draws the global batch
``synthetic_mnist(s % 7, per_process * N)`` (the same on every process)
and each process trains on its rows ``[pid * per_process, (pid + 1) *
per_process)``, ``per_process = max(--batch-size // N, 1)``; the
gradients are averaged over the ranks.  The losses stay on the device
and are read once at the end, then the reference's line:
``process {pid}/{n}: steps 0..{steps} loss {first} -> {last}`` (last =
the mean of the last five), and exit 1 if the loss did not fall over 20
or more steps.

The reference's ``--data-dir`` (an on-disk dataset through the grain
loader), ``--checkpoint-dir`` (orbax) and ``--profile-dir`` (a JAX
profiler trace) are not ported yet: the parser refuses them.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from tf_operator_tpu_torch.models.mnist import MnistCNN, cross_entropy_loss, init_mnist
from tf_operator_tpu_torch.parallel.mesh import make_mesh
from tf_operator_tpu_torch.parallel.trainer import Trainer, TrainerConfig
from tf_operator_tpu_torch.runtime.bootstrap import entry_device, initialize, world

INIT_SEED = 0
_UNPORTED = {"data_dir": "--data-dir (the grain loader of an on-disk dataset)",
             "checkpoint_dir": "--checkpoint-dir (the orbax checkpoint manager)",
             "profile_dir": "--profile-dir (a profiler trace)"}


def synthetic_mnist(seed: int, n: int):
    """Deterministic fake MNIST, the same on every process (the
    reference's)."""

    r = np.random.RandomState(seed)
    images = r.rand(n, 28, 28, 1).astype("float32")
    labels = r.randint(0, 10, size=(n,)).astype("int32")
    return images, labels


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--batch-size", type=int, default=64, help="global")
    p.add_argument("--learning-rate", type=float, default=0.05)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--data-dir", default="", help="not ported yet")
    p.add_argument("--checkpoint-dir", default="", help="not ported yet")
    p.add_argument("--profile-dir", default="", help="not ported yet")
    return p


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = parser()
    args = p.parse_args(argv)
    for field, what in _UNPORTED.items():
        if getattr(args, field):
            p.error(f"{what} is not ported yet")
    return args


def run(args: argparse.Namespace, dtype: torch.dtype = torch.bfloat16) -> Dict:
    """Train as ``args`` say (``dtype``: the model's compute dtype, the
    reference's bf16 by default); returns the trainer and the losses."""

    ctx = initialize(args.device)
    pid, n = world()
    device = entry_device(args.device, ctx)
    mesh = make_mesh({"dp": n}) if n > 1 else None
    model = init_mnist(MnistCNN(dtype=dtype, device=device), INIT_SEED)
    cfg = TrainerConfig(optimizer="sgd", learning_rate=args.learning_rate, momentum=0.9,
                        grad_clip=0.0)
    trainer = Trainer(model, cfg, cross_entropy_loss, mesh=mesh)
    per_proc = max(args.batch_size // n, 1)
    lo = pid * per_proc
    pending = []
    for step in range(args.steps):
        images, labels = synthetic_mnist(step % 7, per_proc * n)
        batch = trainer.shard_batch({"image": images[lo:lo + per_proc],
                                     "label": labels[lo:lo + per_proc]})
        pending.append(trainer.train_step(batch)["loss"])
    losses = torch.stack(pending).tolist() if pending else []
    return {"trainer": trainer, "losses": losses}


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    losses = run(args)["losses"]
    pid, n = world()
    if losses:
        first, last = losses[0], float(np.mean(losses[-5:]))
        print(f"process {pid}/{n}: steps 0..{args.steps} loss {first:.4f} -> {last:.4f}",
              flush=True)
        if args.steps >= 20 and not last < first:
            print("loss did not decrease", file=sys.stderr, flush=True)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
