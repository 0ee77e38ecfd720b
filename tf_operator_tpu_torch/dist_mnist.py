"""dist-mnist, the canonical training job of the operator (the port of
``examples/dist_mnist.py``).

    python -m tf_operator_tpu_torch.dist_mnist [--device cpu] [--steps 30] [--data-dir D]

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

With ``--data-dir D`` the steps read an on-disk dataset instead, as the
reference's real data path does: process 0 writes the procedural MNIST
there (``data/synthetic.ensure_mnist``, idempotent; no download) while
the others wait for its commit record of the same parameters, and each
process trains on its disjoint shard of the records through
``data/loader.make_loader`` (``per_process`` rows a step, reshuffled
each epoch, forever) and ``device_prefetch`` (pinned host buffers
copied to the card on a side stream, two batches ahead).

The reference's ``--checkpoint-dir`` (orbax) and ``--profile-dir`` (a
JAX profiler trace) are not ported yet: the parser refuses them.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from tf_operator_tpu_torch.data.loader import device_prefetch, make_loader
from tf_operator_tpu_torch.data.synthetic import ensure_mnist, mnist_meta, wait_for_dataset
from tf_operator_tpu_torch.models.mnist import MnistCNN, cross_entropy_loss, init_mnist
from tf_operator_tpu_torch.parallel.mesh import make_mesh
from tf_operator_tpu_torch.parallel.trainer import Trainer, TrainerConfig
from tf_operator_tpu_torch.runtime.bootstrap import entry_device, initialize, world

INIT_SEED = 0
_UNPORTED = {"checkpoint_dir": "--checkpoint-dir (the orbax checkpoint manager)",
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
    p.add_argument("--data-dir", default="",
                   help="on-disk dataset read through the sharded loader (generated once "
                   "by the coordinator if missing); default: in-memory synthetic tensors")
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
    reference's bf16 by default); returns the trainer, the losses and,
    with ``--data-dir``, the record ids of the first batch the steps
    trained on (``first_ids``; else None)."""

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
    batches, first_ids = None, []
    if args.data_dir:
        if pid == 0:
            ensure_mnist(args.data_dir)
        else:
            # these parameters: a stale dataset the coordinator is
            # rewriting must not satisfy the wait
            wait_for_dataset(args.data_dir, meta=mnist_meta())
        loader = make_loader(args.data_dir, per_proc, process_id=pid, process_count=n,
                             num_epochs=None)

        def drawn():
            for ids, batch in loader.indexed():
                if not first_ids:
                    first_ids.append(ids.tolist())
                yield batch

        batches = device_prefetch(drawn(), device)
    pending = []
    for step in range(args.steps):
        if batches is not None:
            batch = trainer.shard_batch(next(batches))
        else:
            images, labels = synthetic_mnist(step % 7, per_proc * n)
            batch = trainer.shard_batch({"image": images[lo:lo + per_proc],
                                         "label": labels[lo:lo + per_proc]})
        pending.append(trainer.train_step(batch)["loss"])
    losses = torch.stack(pending).tolist() if pending else []
    return {"trainer": trainer, "losses": losses,
            "first_ids": first_ids[0] if first_ids else None}


def report(args: argparse.Namespace, losses: List[float]) -> int:
    """Print the reference's loss line; the exit code (1 if the loss did
    not fall over 20 or more steps)."""

    pid, n = world()
    if losses:
        first, last = losses[0], float(np.mean(losses[-5:]))
        print(f"process {pid}/{n}: steps 0..{args.steps} loss {first:.4f} -> {last:.4f}",
              flush=True)
        if args.steps >= 20 and not last < first:
            print("loss did not decrease", file=sys.stderr, flush=True)
            return 1
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    return report(args, run(args)["losses"])


if __name__ == "__main__":
    sys.exit(main())
