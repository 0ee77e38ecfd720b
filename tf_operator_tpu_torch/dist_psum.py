"""The smallest distributed workload (the port of ``examples/dist_psum.py``):
each process joins the job's world from the injected environment,
gathers every rank's id across the world, checks it and exits 0.

    python -m tf_operator_tpu_torch.dist_psum [--device cpu]

It prints the reference's line: ``process {pid}/{n}: allgather ok ->
[0.0, 1.0, ...]``.  Outside a job it is a world of one.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import torch

from tf_operator_tpu_torch.runtime.bootstrap import entry_device, initialize, world


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    ctx = initialize(args.device)
    pid, n = world()
    if ctx is not None and (pid, n) != (ctx.process_id, ctx.num_processes):
        raise RuntimeError(f"joined as {pid}/{n}, injected {ctx.process_id}/{ctx.num_processes}")
    gathered = allgather_ids(pid, n, entry_device(args.device, ctx))
    if gathered.tolist() != [[float(i)] for i in range(n)]:
        raise RuntimeError(f"allgather returned {gathered.tolist()}")
    print(f"process {pid}/{n}: allgather ok -> {gathered.ravel().tolist()}", flush=True)
    return 0


def allgather_ids(pid: int, n: int, device) -> torch.Tensor:
    """[n, 1]: every rank's id, gathered on ``device`` (the reference's
    ``process_allgather(jnp.array([float(pid)]))``)."""

    mine = torch.tensor([float(pid)], device=device)
    if n == 1:
        return mine.reshape(1, 1).cpu()
    import torch.distributed as dist

    out = torch.empty(n, device=device)
    dist.all_gather_into_tensor(out, mine)
    return out.reshape(n, 1).cpu()


if __name__ == "__main__":
    sys.exit(main())
