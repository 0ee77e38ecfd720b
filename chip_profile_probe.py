"""The crash witness for ``serve_lm``'s ``/debug/profile`` on a card.

Started while the pool's driver thread launched a llama-7B-width decode
window, a capture (Kineto / CUPTI, on the request's thread) crashed the
process now and then: SIGSEGV in a thread with no Python frame, during
the recording.  ``ProfileCapture`` therefore starts and stops the
profiler inside ``DEVICE_GATE.quiet()`` with the device synchronized.
This script runs many captures beside a live decode loop, each child
process a server at ``chip_smoke.py`` phase 7's shape (llama_7b_shape
bf16 seeded weights, the paged pool at 8 slots, phase 7's nine
requests, ``/debug/profile?seconds=2`` while they decode), so that a
crash ends only its child.  Each child first profiles a few matmuls on
its main thread, as the script's earlier phases do.  Modes, cycled over
the children:

- ``gated``: the server as it is;
- ``ungated``: the capture with the gate taken out (``_quiet`` a no-op),
  the server as it was before the gate.

Prints a line a child (its mode, exit code, captures) and then
``PROBE_SUMMARY {mode: {children, captures, crashes, other_fail}}``;
each child's output and, on a crash, faulthandler's stacks of every
thread land in ``chiprun_out/probe/``.  Needs a CUDA card::

    python3 chip_profile_probe.py [SECONDS [MODES [CAPTURES [PARALLEL]]]]

(defaults: 420 s of starting children, ``gated,ungated``, 4 captures a
child, 3 children at once on the one card).  Exits 1 when a gated child
crashed or failed, else 0.
"""

import faulthandler
import json
import os
import shutil
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out", "probe")
MODES = ("gated", "ungated")


def child(mode: str, n: int) -> int:
    """One server process: ``n`` captures beside phase 7's traffic."""

    faulthandler.enable(all_threads=True)
    sys.path.insert(0, ROOT)
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as c
    from tf_operator_tpu_torch import resolve_device, serve_lm
    from tf_operator_tpu_torch.models.llama import LlamaLM, llama_7b_shape
    from tf_operator_tpu_torch.models.weights import init_params

    dev = resolve_device()
    cfg = llama_7b_shape(max_len=2048)
    model = LlamaLM.from_state_dict(cfg, init_params(cfg, 0, dev), dev)
    x = torch.randn(1024, 1024, device=dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True):
        for _ in range(10):
            x = (x @ x) / 1024
        torch.cuda.synchronize()
    if mode == "ungated":
        serve_lm.ProfileCapture._quiet = lambda self: contextlib.nullcontext()
    pool = serve_lm.make_pool(model, model_label="llama-7b", slots=8, steps_per_sync=8,
                              kv_block_size=16)
    server = serve_lm.Server(pool).start()
    bodies = c._main_bodies()
    try:
        for i in range(n):
            threads = [threading.Thread(target=c._post, args=(server.port, b)) for b in bodies]
            for t in threads:
                t.start()
            t_end = time.perf_counter() + 60
            while pool.in_flight() == 0 and time.perf_counter() < t_end:
                time.sleep(0.001)
            t0 = time.perf_counter()
            code, body = c._get_status(server.port, "/debug/profile?seconds=2")
            wall = time.perf_counter() - t0
            for t in threads:
                t.join(timeout=600)
            last = server.profiler.last if code == 200 else {}
            print(json.dumps({"i": i, "code": code, "wall": round(wall, 3),
                              **{k: round(v, 3) for k, v in last.items()
                                 if k.endswith("_s")}}), flush=True)
            if code == 200:
                shutil.rmtree(body["artifact"], ignore_errors=True)
            if server.fatal:
                print("FATAL", server.fatal, flush=True)
                return 1
    finally:
        server.close()
    return 0


def main(seconds: float, modes: list, n: int, parallel: int) -> int:
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_profile_probe.py runs on a GPU", file=sys.stderr)
        return 2
    import chip_smoke as c

    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    c.phase_build()
    print(c.card_line(), flush=True)
    t_end = time.time() + seconds
    running, k, results = [], 0, []
    while True:
        while len(running) < parallel and time.time() < t_end:
            mode = modes[k % len(modes)]
            base = os.path.join(OUT, f"{k:02d}-{mode}")
            with open(base + ".out", "w") as out, open(base + ".err", "w") as err:
                p = subprocess.Popen([sys.executable, os.path.abspath(__file__), "child",
                                      mode, str(n)], stdout=out, stderr=err, cwd=ROOT)
            running.append((k, mode, base, p, time.time()))
            k += 1
        if not running:
            break
        time.sleep(1)
        for item in list(running):
            kk, mode, base, p, t0 = item
            if p.poll() is None:
                continue
            running.remove(item)
            with open(base + ".out") as f:
                codes = [json.loads(line)["code"] for line in f if line.startswith('{"i"')]
            rec = {"k": kk, "mode": mode, "rc": p.returncode,
                   "captures": codes.count(200), "idle_503": codes.count(503),
                   "wall_s": round(time.time() - t0, 1)}
            results.append(rec)
            print(json.dumps(rec), flush=True)
    summary = {}
    for r in results:
        s = summary.setdefault(r["mode"], {"children": 0, "captures": 0, "crashes": 0,
                                           "other_fail": 0})
        s["children"] += 1
        # a crashed child's capture in flight counts as one
        s["captures"] += r["captures"] + (r["rc"] == -11)
        s["crashes"] += r["rc"] == -11
        s["other_fail"] += r["rc"] not in (0, -11)
    print("PROBE_SUMMARY " + json.dumps(summary), flush=True)
    gated = summary.get("gated", {})
    return 1 if gated.get("crashes") or gated.get("other_fail") else 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "child":
        sys.exit(child(sys.argv[2], int(sys.argv[3])))
    argv = sys.argv[1:]
    sys.exit(main(float(argv[0]) if argv else 420.0,
                  argv[1].split(",") if len(argv) > 1 else list(MODES),
                  int(argv[2]) if len(argv) > 2 else 4,
                  int(argv[3]) if len(argv) > 3 else 3))
