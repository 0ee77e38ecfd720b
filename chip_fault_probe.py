"""Planted faults for ``chip_smoke.py``'s multi-rank training checks
(phases 5b and 5c(b), llama-wide; phase 16(b), the pipeline; phase
5e, moe over sp).

For each fault: copies this checkout into a temporary directory, breaks
the gradient sync there, builds the flash-attention kernels in the copy,
and runs the phase's check from it on the one card.  The check must
refuse the broken sync.

- ``fsdp``: each rank's reduce-scatter keeps its own part of its own
  gradient in place of the sum over the ranks; runs
  ``chip_smoke.phase_multiprocess``'s ``fsdp`` job (one process on the
  global batch, one on 4 rows, 2 fsdp ranks) and its check.
- ``sp``: the grad-sync plan leaves the sp axis out of its axes, so a
  sequence-parallel rank keeps its chunk's share of each gradient; runs
  the yardstick and ``chip_smoke.phase_multiprocess``'s ``sp_ring`` job
  (2 ranks of ``llama_pretrain --sp 2`` on the ring) and its check.
- ``pp_input``: the pipeline's input cotangent stays on stage 0 (not
  shared over pp), so the other stage's embedding gets the head's
  gradient only; runs ``chip_smoke.phase_pipeline`` (one process's
  sequential yardstick, then 2 ranks over ``{"pp": 2}``).
- ``pp_output``: the shared output's backward sums over pp in place of
  the identity, so every stage's gradient, and the input's, counts pp
  times; runs ``chip_smoke.phase_pipeline``.
- ``moe_sp_prefix``: moe's capacity scan leaves out the routes the
  earlier ranks of the sp line queued (``models/moe.route_offsets``), so
  each chunk's slots start at 0 and rank 1 keeps routes the whole row's
  queue drops; runs ``chip_smoke.phase_multiprocess``'s
  ``moe_gpt_small_ring_sp2`` job, the 8-expert moe's ring over
  ``{"sp": 2}`` (phase 5e: the yardstick in one process, then 2 ranks),
  and its check.

The multi-rank faults run through the same runner, worlds and checks
as ``chip_smoke.py`` itself, with only the job of the fault.

Prints each check's readings, then ``FAULT_PROBE {...}`` a fault; exits
0 when every check failed as it should, 1 when a broken sync passed its
check.  Needs a CUDA card (about three minutes a fault on an H100)::

    python3 chip_fault_probe.py [fsdp] [sp] [pp_input] [pp_output] [moe_sp_prefix]
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
COLLECTIVES = os.path.join("tf_operator_tpu_torch", "parallel", "collectives.py")
PIPELINE = os.path.join("tf_operator_tpu_torch", "parallel", "pipeline.py")
MOE = os.path.join("tf_operator_tpu_torch", "models", "moe.py")
RUN = """
import chip_smoke as c
from tf_operator_tpu_torch.ops import _build
_build.load("flash_attention")
{}
"""
#: name: (what is broken, the file, the line(s) to break, what replaces
#: them, the check to run, the tags of its readings)
FAULTS = {
    "fsdp": ("reduce-scatter keeps the rank's own part", COLLECTIVES,
             "    dist.reduce_scatter_tensor(out, inp, group=group)\n",
             "    out.copy_(inp.chunk(dist.get_world_size(group))[dist.get_rank(group)])\n",
             "c.phase_multiprocess(c.card_line(), jobs=('fsdp',))",
             ("llama-wide fsdp 2",)),
    "sp": ("the grad-sync plan leaves sp out", COLLECTIVES,
           'got {mode!r}")\n    ici = ici_axes(mesh)\n',
           'got {mode!r}")\n    ici = tuple(ax for ax in ici_axes(mesh) if ax != "sp")\n',
           "c.phase_multiprocess(c.card_line(), jobs=('sp_ring',))",
           ("llama-wide sp 2",)),
    "pp_input": ("the input's cotangent stays on stage 0", PIPELINE,
                 "        broadcast(g_xs, 0, line.group, line.stats, STAGE_INPUT_GRAD)\n",
                 "        pass\n",
                 "c.phase_pipeline(c.card_line())",
                 ("pipeline gpt_small pp 2",)),
    "pp_output": ("the shared output's backward sums over pp", PIPELINE,
                  "                g_out = g_ys[j] if s == n - 1 else recv\n",
                  "                g_out = g_ys[j] * n if s == n - 1 else recv\n",
                  "c.phase_pipeline(c.card_line())",
                  ("pipeline gpt_small pp 2",)),
    "moe_sp_prefix": ("the capacity scan without the earlier sp ranks' counts", MOE,
                      "    return every[:line.index].sum(0), every.sum(0)\n",
                      "    return torch.zeros_like(counts), every.sum(0)\n",
                      "c.phase_multiprocess(c.card_line(), jobs=('moe_gpt_small_ring_sp2',))",
                      ("sp zoo",)),
}


def probe(name: str) -> bool:
    """Run fault ``name`` against its check; True if the check refused it."""

    fault, target, good, broken, check, tags = FAULTS[name]
    root = tempfile.mkdtemp(prefix="chip_fault_probe_")
    try:
        copy = os.path.join(root, "repo")
        shutil.copytree(HERE, copy, ignore=shutil.ignore_patterns(
            ".git", "build", "__pycache__"))
        path = os.path.join(copy, target)
        with open(path) as f:
            src = f.read()
        if src.count(good) != 1:
            raise SystemExit(f"{target}: the code to break for {name} is not there once")
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
