"""Planted faults for ``chip_smoke.py``'s llama-wide checks (phases 5b
and 5c(b)).

For each fault: copies this checkout into a temporary directory, breaks
the gradient sync there, builds the flash-attention kernels in the copy,
and runs the phase's check from it on the one card.  The check must
refuse the broken sync.

- ``fsdp``: each rank's reduce-scatter keeps its own part of its own
  gradient in place of the sum over the ranks; runs
  ``chip_smoke.phase_llama_fsdp`` (one process on the global batch, one
  on 4 rows, 2 fsdp ranks).
- ``sp``: the grad-sync plan leaves the sp axis out of its axes, so a
  sequence-parallel rank keeps its chunk's share of each gradient; runs
  the yardstick and ``chip_smoke.phase_sp_llama`` on the ring (2 ranks
  of ``llama_pretrain --sp 2``).

Prints each check's readings, then ``FAULT_PROBE {...}`` a fault; exits
0 when every check failed as it should, 1 when a broken sync passed its
check.  Needs a CUDA card (about three minutes a fault on an H100)::

    python3 chip_fault_probe.py [fsdp] [sp]
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
TARGET = os.path.join("tf_operator_tpu_torch", "parallel", "collectives.py")
RUN = """
import tempfile
import chip_smoke as c
from tf_operator_tpu_torch.ops import _build
_build.load("flash_attention")
tmp = tempfile.mkdtemp(prefix="fault_probe_")
try:
{}
finally:
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
"""
#: name: (what is broken, the line(s) to break, what replaces them, the
#: check to run, the tags of its readings)
FAULTS = {
    "fsdp": ("reduce-scatter keeps the rank's own part",
             "    dist.reduce_scatter_tensor(out, inp, group=group)\n",
             "    out.copy_(inp.chunk(dist.get_world_size(group))[dist.get_rank(group)])\n",
             "    c.phase_llama_fsdp(tmp, c.card_line())",
             ("llama-wide fsdp 2",)),
    "sp": ("the grad-sync plan leaves sp out",
           'got {mode!r}")\n    ici = ici_axes(mesh)\n',
           'got {mode!r}")\n    ici = tuple(ax for ax in ici_axes(mesh) if ax != "sp")\n',
           "    one = c.llama_yardstick(tmp)\n"
           "    c.phase_sp_llama(tmp, c.card_line(), one['losses'], impls=('ring',))",
           ("llama-wide sp 2",)),
}


def probe(name: str) -> bool:
    """Run fault ``name`` against its check; True if the check refused it."""

    fault, good, broken, check, tags = FAULTS[name]
    root = tempfile.mkdtemp(prefix="chip_fault_probe_")
    try:
        copy = os.path.join(root, "repo")
        shutil.copytree(HERE, copy, ignore=shutil.ignore_patterns(
            ".git", "build", "__pycache__"))
        path = os.path.join(copy, TARGET)
        with open(path) as f:
            src = f.read()
        if src.count(good) != 1:
            raise SystemExit(f"{TARGET}: the code to break for {name} is not there once")
        with open(path, "w") as f:
            f.write(src.replace(good, broken))
        proc = subprocess.run([sys.executable, "-c", RUN.format(check)], cwd=copy, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=1500)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    lines = proc.stdout.splitlines()
    for ln in lines:
        if any(tag in ln for tag in tags) or "off the yardstick" in ln:
            print(ln, flush=True)
    refused = proc.returncode != 0 and any("off the yardstick" in ln for ln in lines)
    if proc.returncode != 0 and not refused:
        print("\n".join(lines[-40:]), flush=True)
    print("FAULT_PROBE " + json.dumps({"name": name, "fault": fault,
                                       "check_rc": proc.returncode, "refused": refused}),
          flush=True)
    return refused


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_fault_probe.py runs on a GPU", file=sys.stderr)
        return 2
    names = argv or list(FAULTS)
    unknown = [n for n in names if n not in FAULTS]
    if unknown:
        print(f"unknown fault(s) {unknown}; choose from {sorted(FAULTS)}", file=sys.stderr)
        return 2
    results = [probe(n) for n in names]
    return 0 if all(results) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
