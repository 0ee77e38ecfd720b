"""mnist_with_summaries: a step series a user can plot (the port of
``examples/mnist_with_summaries.py``).

    python -m tf_operator_tpu_torch.mnist_with_summaries --summary-dir D \\
        [--device cpu] [--steps 40] [--summary-every 5]

The ``Trainer`` (parallel/trainer.py) writes a JSON-lines scalar series
through ``utils/summaries.SummaryWriter`` every ``--summary-every``
steps: loss, accuracy, grad_norm and, from the second record on,
steps_per_sec, one file a process (``metrics-<pid>.jsonl``), the JAX
package's format, so that a job annotated with
``tpujob.dist/summary-dir`` shows it in ``tpujob describe`` and the
dashboard.  One process, or every process of a job (joined from the
``TPUJOB_*`` environment, ``runtime/bootstrap.initialize``) over the
mesh ``{"dp": N}``: each trains the ``MnistCNN`` (random from seed 0,
dropout 0.5 in training) with SGD (momentum 0.9, the default clip) on a
fixed batch of ``max(--batch-size // N, 1)`` random images drawn from
seed 0, the same on every process, as the reference does.  Prints the
reference's line ``process {pid}/{n}: final loss {x}, series in {D}``.

``--checkpoint-dir`` (the reference's orbax checkpointer) is not ported
yet: the parser refuses it.
"""

from __future__ import annotations

import argparse
import functools
import sys
from typing import Dict, List, Optional

import numpy as np

from tf_operator_tpu_torch.models.mnist import MnistCNN, cross_entropy_loss, init_mnist
from tf_operator_tpu_torch.parallel.mesh import make_mesh
from tf_operator_tpu_torch.parallel.trainer import Trainer, TrainerConfig
from tf_operator_tpu_torch.runtime.bootstrap import entry_device, initialize, world
from tf_operator_tpu_torch.utils.summaries import SummaryWriter

INIT_SEED = 0


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--batch-size", type=int, default=64, help="global")
    p.add_argument("--learning-rate", type=float, default=0.05)
    p.add_argument("--summary-dir", required=True)
    p.add_argument("--summary-every", type=int, default=5)
    p.add_argument("--checkpoint-dir", default="", help="not ported yet")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = parser()
    args = p.parse_args(argv)
    if args.checkpoint_dir:
        p.error("--checkpoint-dir (the orbax checkpoint manager) is not ported yet")
    return args


def run(args: argparse.Namespace) -> Dict:
    """Train as ``args`` say, writing the series; returns the trainer
    and the last step's metrics (None without steps)."""

    ctx = initialize(args.device)
    pid, n = world()
    device = entry_device(args.device, ctx)
    mesh = make_mesh({"dp": n}) if n > 1 else None
    per_proc = max(args.batch_size // n, 1)
    r = np.random.RandomState(0)
    local = {"image": r.rand(per_proc, 28, 28, 1).astype(np.float32),
             "label": r.randint(0, 10, size=(per_proc,)).astype(np.int32)}
    writer = SummaryWriter(args.summary_dir, process_id=pid)
    trainer = Trainer(init_mnist(MnistCNN(device=device), INIT_SEED),
                      TrainerConfig(optimizer="sgd", learning_rate=args.learning_rate,
                                    summary_every=args.summary_every),
                      functools.partial(cross_entropy_loss, train=True), mesh=mesh,
                      summary_writer=writer)
    batch = trainer.shard_batch(local)
    last = None
    try:
        for _ in range(args.steps):
            last = trainer.train_step(batch)
    finally:
        writer.close()
    return {"trainer": trainer, "last": last}


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    last = run(args)["last"]
    pid, n = world()
    final = (f"final loss {float(last['loss']):.4f}" if last is not None
             else "already complete at step 0")
    print(f"process {pid}/{n}: {final}, series in {args.summary_dir}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
