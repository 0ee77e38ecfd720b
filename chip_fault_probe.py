"""A planted fault for ``chip_smoke.py`` phase 5b's llama-wide fsdp check.

Copies this checkout into a temporary directory, breaks the gradient
sync there (each rank's reduce-scatter keeps its own part of its own
gradient in place of the sum over the ranks), builds the flash-attention
kernels in the copy, and runs ``chip_smoke.phase_llama_fsdp`` from it:
one process on the global batch, one on 4 rows, and 2 fsdp ranks, on
the one card.  The check must refuse the broken sync.  Prints the
check's readings, then ``FAULT_PROBE {...}``; exits 0 when the check
failed as it should, 1 when the broken sync passed it.  Needs a CUDA
card (about three minutes on an H100)::

    python3 chip_fault_probe.py
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
TARGET = os.path.join("tf_operator_tpu_torch", "parallel", "collectives.py")
SUM = "    dist.reduce_scatter_tensor(out, inp, group=group)\n"
OWN = "    out.copy_(inp.chunk(dist.get_world_size(group))[dist.get_rank(group)])\n"
RUN = """
import tempfile
import chip_smoke as c
from tf_operator_tpu_torch.ops import _build
_build.load("flash_attention")
tmp = tempfile.mkdtemp(prefix="fault_probe_")
try:
    c.phase_llama_fsdp(tmp, c.card_line())
finally:
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_fault_probe.py runs on a GPU", file=sys.stderr)
        return 2
    root = tempfile.mkdtemp(prefix="chip_fault_probe_")
    try:
        copy = os.path.join(root, "repo")
        shutil.copytree(HERE, copy, ignore=shutil.ignore_patterns(
            ".git", "build", "__pycache__"))
        path = os.path.join(copy, TARGET)
        with open(path) as f:
            src = f.read()
        if src.count(SUM) != 1:
            raise SystemExit(f"{TARGET}: the reduce-scatter call to break is not there once")
        with open(path, "w") as f:
            f.write(src.replace(SUM, OWN))
        proc = subprocess.run([sys.executable, "-c", RUN], cwd=copy, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=1500)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    lines = proc.stdout.splitlines()
    for ln in lines:
        if "llama-wide fsdp 2" in ln or "off the yardstick" in ln:
            print(ln, flush=True)
    refused = proc.returncode != 0 and any("off the yardstick" in ln for ln in lines)
    if proc.returncode != 0 and not refused:
        print("\n".join(lines[-40:]), flush=True)
    print("FAULT_PROBE " + json.dumps({"fault": "reduce-scatter keeps the rank's own part",
                                       "check_rc": proc.returncode, "refused": refused}),
          flush=True)
    return 0 if refused else 1


if __name__ == "__main__":
    sys.exit(main())
