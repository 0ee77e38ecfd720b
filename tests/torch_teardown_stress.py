"""How often a rank of a gloo world aborts at exit, with and without the
teardown that ``runtime/bootstrap.initialize`` registers.

Starts ``--worlds`` 4-rank worlds at once, ``--rounds`` times; each
rank joins through ``initialize("cpu")``, runs a few all-gathers and
all-reduces (over the world and over two 2-rank subgroups, as the
model-parallel workers do) and exits.  ``--no-teardown`` unregisters
the teardown first, as the port was before it had one.  Prints one JSON
line: the ranks started, those that exited non-zero, and those whose
output holds ``terminate called``.  Needs no card::

    python tests/torch_teardown_stress.py [--no-teardown] [--rounds 10] [--worlds 6]
"""

import argparse
import json
import os
import subprocess
import sys

from torch_world import ROOT, free_port, rank_env

RANK = """
import atexit, sys
import torch
import torch.distributed as dist
from tf_operator_tpu_torch.runtime import bootstrap

torch.set_num_threads(1)
bootstrap.initialize("cpu")
if sys.argv[1] == "off":
    atexit.unregister(bootstrap._leave_world)
rank, n = bootstrap.world()
pair = [dist.new_group([0, 1]), dist.new_group([2, 3])][rank // 2]
x = torch.randn(64, 64)
for _ in range(30):
    out = torch.empty(n * 64, 64)
    dist.all_gather_into_tensor(out, x)
    dist.all_reduce(x)
    x = x / n
    dist.all_reduce(x, group=pair)
print("done", rank, flush=True)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--no-teardown", action="store_true")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--worlds", type=int, default=6)
    args = ap.parse_args(argv)
    mode = "off" if args.no_teardown else "on"
    started = failed = aborted = 0
    for _ in range(args.rounds):
        procs = []
        for _ in range(args.worlds):
            port = free_port()
            procs += [subprocess.Popen([sys.executable, "-c", RANK, mode], cwd=ROOT,
                                       env=rank_env(r, 4, port), stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
                      for r in range(4)]
        for p in procs:
            out = p.communicate(timeout=300)[0]
            started += 1
            failed += p.returncode != 0
            aborted += "terminate called" in out
    print(json.dumps({"teardown": mode, "rounds": args.rounds, "worlds": args.worlds,
                      "ranks": started, "failed": failed, "aborted": aborted,
                      "cpus": os.cpu_count()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
