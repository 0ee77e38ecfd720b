"""The multi-slice workload (the port of ``examples/dist_multislice.py``):
the slice topology the operator injects, and training on the slice-aware
mesh through the hierarchical gradient sync.

    python -m tf_operator_tpu_torch.dist_multislice [--device cpu]

Each process:

1. joins the job's world (``runtime/bootstrap.initialize``) and, in a job
   of more than one slice, asserts from inside the worker that the
   injected ``MEGASCALE_*`` / ``TPU_WORKER_*`` environment matches its
   place in the world (slice = pid // hosts, worker = pid % hosts), then
   gathers every rank's id across all slices and prints the reference's
   line ``process {pid}/{n}: slice {s}/{S} worker {w} megascale ok,
   allgather -> [...]``;
2. builds the mesh ``{"dp": S, "fsdp": -1}`` (the slice count read from
   the environment: dp across slices, fsdp within one) and trains an
   ``MnistCNN`` six steps through ``train_loop`` (SGD at 0.05, clip 1.0,
   its batch of 8 drawn from ``RandomState(pid)``); across slices the
   trainer's grad sync is the hierarchical plan
   (``parallel/collectives.py``);
3. process 0 prints ``MULTISLICE_LEDGER {...}``: the grad sync, the mesh,
   each batch axis's fabric, the steps, the final loss and the plan's
   byte ledger (the JAX ledger's keys).

One slice (no MEGASCALE variables) is the flat one-slice mesh.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

import numpy as np

from tf_operator_tpu_torch.bootstrap.tpu_env import (
    ENV_SLICE_ID,
    ENV_WORKER_HOSTNAMES,
    ENV_WORKER_ID,
    detected_slice_topology,
)
from tf_operator_tpu_torch.dist_psum import allgather_ids
from tf_operator_tpu_torch.models.mnist import MnistCNN, cross_entropy_loss, init_mnist
from tf_operator_tpu_torch.parallel.mesh import make_mesh, mesh_axis_links
from tf_operator_tpu_torch.parallel.trainer import Trainer, TrainerConfig
from tf_operator_tpu_torch.runtime.bootstrap import entry_device, initialize, world
from tf_operator_tpu_torch.runtime.harness import train_loop

STEPS = 6
PER_DEVICE = 8


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    ctx = initialize(args.device)
    pid, n = world()
    device = entry_device(args.device, ctx)

    num_slices, slice_id = detected_slice_topology()
    if num_slices > 1:
        worker_id = int(os.environ[ENV_WORKER_ID])
        hostnames = os.environ[ENV_WORKER_HOSTNAMES].split(",")
        hosts = len(hostnames)
        # (read, expected from this process's place in the world)
        facts = {"slice id": (slice_id, int(os.environ[ENV_SLICE_ID])),
                 "processes": (n, num_slices * hosts), "slice": (slice_id, pid // hosts),
                 "worker": (worker_id, pid % hosts)}
        wrong = {k: v for k, v in facts.items() if v[0] != v[1]}
        if wrong or not all(hostnames):
            raise RuntimeError(f"process {pid}/{n}: the injected slice topology does not "
                               f"match: {wrong}, hostnames {hostnames}")
    else:
        worker_id = pid

    gathered = allgather_ids(pid, n, device)
    if gathered.tolist() != [[float(i)] for i in range(n)]:
        raise RuntimeError(f"allgather returned {gathered.tolist()}")
    print(f"process {pid}/{n}: slice {slice_id if slice_id is not None else 0}"
          f"/{num_slices} worker {worker_id} "
          f"megascale ok, allgather -> {gathered.ravel().tolist()}", flush=True)

    mesh = make_mesh({"dp": num_slices, "fsdp": -1})
    links = mesh_axis_links(mesh)
    r = np.random.RandomState(pid)
    local = {"image": r.rand(PER_DEVICE, 28, 28, 1).astype(np.float32),
             "label": r.randint(0, 10, size=(PER_DEVICE,))}
    model = init_mnist(MnistCNN(device=device), 0)
    trainer = Trainer(model, TrainerConfig(optimizer="sgd", learning_rate=0.05),
                      cross_entropy_loss, mesh=mesh if n > 1 else None)
    sharded = trainer.shard_batch(local)
    losses = train_loop(trainer, sharded, STEPS, steps_per_sync=3, assert_decreasing=False,
                        tag="multislice")
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite losses {losses}")

    if pid == 0:
        ledger = {
            "grad_sync": trainer.grad_sync,
            "mesh": {ax: int(s) for ax, s in mesh.shape.items() if s > 1},
            "axis_fabric": {ax: links[ax] for ax in ("dp", "fsdp")},
            "steps": STEPS,
            "final_loss": round(float(losses[-1]), 4),
        }
        if trainer.grad_sync_plan is not None:
            ledger.update(trainer.grad_sync_plan.ledger())
        print("MULTISLICE_LEDGER " + json.dumps(ledger), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
