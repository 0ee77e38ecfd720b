"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. identity: the card's name and power limit (nvidia-smi), torch, CUDA
   and nvcc versions.  Without a CUDA device the script exits 2.
2. build: every CUDA source of the port under
   ``tf_operator_tpu_torch/csrc``, one nvcc process each, all started
   together, with ptxas's register report per source; for the flash
   source each kernel's registers, shared memory (static, and the
   dynamic bytes K1's, K2's and K3's launchers ask for) and spills, and
   the HGMMA count of K1's, K2's and K3's Hopper kernels in the SASS
   (cuobjdump); for the int8 matmul source each K7 kernel's registers,
   shared memory and spills; for K4, K5 and K6 each kernel's
   registers, spills, static and dynamic shared memory (K5's and K6's
   from their occupancy queries, with their grids); ptxas's warnings.
   The Hopper kernels must not spill and must issue HGMMA; no K7, K4,
   K5 or K6 kernel may spill.
3. the paged-attention kernel (K4) against its plain PyTorch version on
   the card: 7B decode shapes (S=8, H=Hkv=32, D=128, bs=16, MB=128,
   lengths 1..2048), the same with seats at the table's end beside
   short ones (one under a split, one on a split boundary, one just
   past it), GQA (Hkv=8), K=1 and K=4, bf16 and float32, plus small
   shapes covering the other block sizes and head dims; each case
   prints its split count and positions a split.  Each case
   holds the kernel to an absolute tolerance and, per output row (one
   seat, query row and head), to a tolerance relative to that row's
   largest value; it prints both errors and the
   kernel's, the plain version's and scaled_dot_product_attention's
   device times (the last on the gathered view, a yardstick the port
   never calls; CUDA events, queued behind a device sleep so that the
   wrapper's host time is not what is timed) beside the bound: live K/V
   bytes over 3.35 TB/s; and the wrapper's host microseconds a call.
4. the flash-attention kernels K1 (forward), K2 (dq) and K3 (dk, dv),
   all three wgmma fed by TMA, against their plain versions: the wide
   training shape (B 4, H 16, Hkv 8, S 2048, D 128, bf16, causal), the
   same at GQA group 4 (H 32, Hkv 8: K3 folds four query heads into a
   kv tile's walk), non-causal, a window of 256 at S 1024, Sq != Sk
   (causal and not; 192 x 320 causal puts a kv tile across the diagonal
   at a non-square offset), S = 1000, D 64, D 96 and D 32 (the 64-byte
   swizzle route of K1 and K3), MHA and float32.  Kernel by kernel on
   the same inputs, per row; and the gradients through
   ``FlashAttention`` against autograd through the plain versions.  At
   both wide shapes: each kernel's time (CUDA events, 20 launches after
   3 warm-ups), its bound (the causal products at the dense bf16 peak,
   or its bytes at 3.35 TB/s, whichever is larger), the plain version's
   time and SDPA's forward and backward times.
4b. the int8 matmul kernel (K7) against its plain version: M = 1, 8 and
   64 rows at each 7B projection shape (4096 x 4096, 4096 x 11008,
   11008 x 4096, 4096 x 32000) in bf16, small shapes at each JAX block
   width (N = 384, 640, 768, 1024, K = 96) and float32 x, per output row
   (max |kernel - plain| over the row's largest |plain|: bf16 8e-3,
   float32 1e-5).  At the 7B shapes: the kernel's device time (CUDA
   events over 20 launches after 3 warm-ups, queued behind a device
   sleep so that the host's cost per call is not what is timed, cycling
   through copies of the weight that together exceed the 50 MB L2, as a
   decode step finds them cold), the plain version's, the bound (the
   bytes at 3.35 TB/s, or the products at the dense peak, whichever is
   larger) and, as the library yardstick, ``torch.matmul`` on a bf16
   weight of the same shape: the product the int8 path replaces; at
   M = 8 also the host microseconds per call of the wrapper and of
   ``torch.matmul``.  The kernels line gives K7's numbers per launch
   over one 7B decode step's mix of shapes (225 launches at M = 8).
   Then the routes: M > 64, K % 32 != 0 and N not a multiple of 128
   take the GEMM route (within one bf16 ulp of each row's largest
   plain value: its sums stay in float32 until after the scale), a
   strided weight and a weight off 16 bytes raise.
4c. the fused BatchNorm kernels K5 (forward) and K6 (backward) against
   their plain versions: each of the 16 (R, C, relu, residual) classes of
   ResNet-50's 53 norms at batch 64 and 224 px (from the stem's [802816,
   64] to [3136, 2048]), bf16 and float32, and the JAX test's ragged
   shapes (2,3,3,5), (34,1,1,7), (1,9,5,130) with every epilogue: y,
   mean, var, dx, dgamma, dbeta and dres on the same inputs, and the
   gradients through the autograd Function (tolerances at ``BN_RTOL``).
   In bf16 at every ResNet class: each kernel's device time (CUDA
   events, queued behind a device sleep, 3 times), its bound (bytes at
   3.35 TB/s), the plain version's time, ``F.batch_norm(training=True)``'s
   forward and autograd backward, the wrapper's host microseconds, and
   the bytes K5 (x) and K6 (g and x) held on chip; then K5 and K6 by
   class (median ms, share of the bound, bytes held) and the totals
   over one step's 53 layers (the median of the 3 repeats and their
   spread).
4d. ResNet-50 training, the main path of K5 and K6: ``resnet_dp --norm
   fused --model resnet50 --image-size 224 --batch-per-device 64 --steps
   30`` in process.  Counts zeroed just before and read just after: K5
   and K6 must each launch 53 x (30 + 15) times (train_loop's steps and
   the benchmark's) and no plain version may run; the loss must fall.
   Prints step ms, examples/s, model TFLOP/s (8.18 GFLOP an image
   forward, x3 for a step) and their share of the 989 TFLOPS peak, and
   peak memory.  Then one step under torch.profiler (busy share, K5's
   and K6's shares, the largest kernel families); the one-step parity
   of K5 / K6 against their plain versions (loss, grad norm, running
   statistics); and the reference's A/B, ``--norm batchnorm`` against
   ``--norm fused``, 3 steps each (step ms, the largest relative loss
   difference).
5. the training main path: ``llama_pretrain`` at llama-wide (full
   depth, 12 layers), seq 2048 x batch 4, 30 steps on the byte corpus
   generated in a temporary directory.  The counts are zeroed just
   before and read just after: K1, K2 and K3 must each have launched
   12 x 30 times, no plain attention may have run, and the loss must
   fall.  Prints step ms, tokens/s, model TFLOP/s and their share of
   the 989 TFLOPS peak, and peak memory.
6. train -> export -> serve: the exported artifact behind the port's
   ``serve_lm`` (K4 at Hkv 8) answers one greedy request with the
   bytes ``generate`` gives on the trained parameters in the process;
   then one training step under torch.profiler (busy share, top
   kernels, and K1's, K2's and K3's shares of device time, each and
   together), and the one-step parity: the first step's loss and grad
   norm through the kernels against the same step with the plain
   attention, same weights and batch.
7. serving at full width: ``llama_7b_shape`` with seeded bf16
   weights, the paged pool (8 slots, max_len 2048, bs 16, 8 steps per
   sync) behind ``serve_lm``'s HTTP server on 127.0.0.1:0; 8 concurrent
   greedy requests (prompts of 64..1500 bytes, two sharing a 512-byte
   prefix) and one seeded temperature request, 32 new tokens each.  The
   kernel counts are zeroed just before and read just after: K4 must
   have launched 32 layers x the decode steps run.
   Then one decode window of the same pool runs under torch.profiler:
   the device's busy share of the window and each kernel's share.
8. end to end: on ``llama_tiny`` (float32) the pool's greedy tokens
   through the kernel equal the plain contiguous ``generate`` on the
   card; at 7B width the first decode step's logits through the kernel
   are within a bf16 tolerance, and share their argmax, with the same
   paged step under the plain attention on the same arena (only the
   attention differs) and with the contiguous (plain) path.
9. int8 serving at full width: ``serve_lm.load_model(..., quantize=
   "int8")`` (what ``--quantize int8`` runs) quantizes the same seeded
   float32 weights as they are made, and the same pool and requests as
   phase 7 run behind the HTTP server.  Counts zeroed just before and
   read just after: K7 must have launched 225 (7 projections x 32
   layers + the head) x (decode steps + prefills of <= 64 rows), the
   GEMM route 225 x the longer prefills, K4 32 x the decode steps, and
   no plain version may have run.  Prints the weight bytes bf16 ->
   int8, decode tokens/s and TTFT beside phase 7's, peak memory and one
   profiled decode window (busy share, K7's share of device time).
10. int8 end to end: ``llama_tiny`` (float32, int8 kernels) pool tokens
   through K7 equal the contiguous ``generate`` with the plain int8
   matmul; at 7B width the first paged decode step through K7 is within
   a stated bound of the same step with the plain int8 matmul (K4 in
   both), with the same argmax.
11. the kernels line (K1, K2, K3 from the training path, K4 from the
   serving path, K7 from the int8 serving path, K5 and K6 from the
   ResNet path, at the [200704, 256] no-ReLU, no-residual class, where
   F.batch_norm computes the same function), the card line, and last
   ``{"ok": true, "device": {...}}``.
"""

import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import torch

#: published H100 SXM peaks (NVIDIA data sheet): HBM3 rate and dense
#: rates by input type (the kernel computes in float32 on CUDA cores
#: for float32 inputs)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float32: 5e-5}
#: per output row [D]: max |kernel - plain| over the row's max |plain|.
#: bf16: the kernel keeps probabilities in float32 where the plain
#: version rounds them to bf16, and both round the output, so a row may
#: differ by an ulp of its largest value (2^-7 relative); 2e-2 is 2.5 of
#: those, and a block left out of a long row shifts it by more
ROW_RTOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
#: stated bounds for the 7B first-step logits, as max |diff| over max
#: |logit|: the kernel path against the paged path with the plain
#: attention on the same arena, and against the contiguous path.  Both
#: bf16; one rounding step apart per layer, amplified through 32 layers
#: of random weights.  Both read about 0.045 on an H100 at seed 0; the
#: bounds are twice that
LOGITS_REL_TOL = {"paged_plain": 0.09, "contiguous": 0.09}
#: K7 per output row: max |kernel - plain| over the row's largest
#: |plain|.  bf16: both round one float32 sum per element once and the
#: sums run in another order, so an element may land one bf16 ulp
#: (2^-8 to 2^-7 of the row's largest) away; 8e-3 is about two of them.
#: float32: FMA sums in another order
QM_RTOL = {torch.bfloat16: 8e-3, torch.float32: 1e-5}
#: the 7B int8 first paged decode step through K7 against the same step
#: with the plain int8 matmul (K4 in both), as max |diff| over max
#: |logit|: one bf16 rounding apart per projection, amplified through 32
#: layers of random weights (the bound of the attention check above)
INT8_LOGITS_REL_TOL = 0.09
#: the 7B projections of one decode step: (K, N) -> launches per step
#: (query, key, value, out; gate, up; down; the head)
PROJ_7B = {(4096, 4096): 4 * 32, (4096, 11008): 2 * 32, (11008, 4096): 32,
           (4096, 32000): 1}


def log(msg):
    print(msg, flush=True)


def free_device_memory():
    """Collect what ``del`` left in reference cycles, then hand the
    cached blocks back, so the next phase's peak is its own."""

    gc.collect()
    torch.cuda.empty_cache()


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


#: the Hopper kernels of K1, K2 and K3 (wgmma, TMA), each with its
#: index for flash_hopper_smem_bytes: built without spills and issuing
#: HGMMA, which phase 2 checks in ptxas's report and the SASS
HOPPER_KERNELS = {"flash_fwd_hopper_kernel": 0, "flash_bwd_dq_hopper_kernel": 1,
                  "flash_bwd_dkv_hopper_kernel": 2}


def _ptxas_entries(report):
    """ptxas's per-kernel lines: {mangled name: {"registers", "smem",
    "spill_stores", "spill_loads", "stack"}} (static shared memory; the
    kernels' dynamic shared memory is what their launchers ask for)."""

    entries, cur = {}, None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = entries.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            cur["smem"] = int(sm.group(1)) if sm else 0
    return entries


def _hgmma_counts(library):
    """HGMMA instructions by kernel in the SASS of a built library
    (cuobjdump), for the kernels whose name holds a HOPPER_KERNELS entry."""

    from tf_operator_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", library], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, cur = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = m.group(1) if any(k in m.group(1) for k in HOPPER_KERNELS) else None
            if cur:
                counts[cur] = 0
        elif cur and "HGMMA" in ln:
            counts[cur] += 1
    return counts


def _short(mangled):
    """a kernel's name and template arguments (head dim; row tiles and
    load width) from its mangled name"""

    m = re.search(r"\d+((?:flash|quant_matmul|paged_attention|bn_fwd|bn_bwd)_\w+?_kernel)"
                  r"(I(?:\w+?)E)?(?:v|$)", mangled)
    if not m:
        return mangled[:60]
    # template arguments: integers, bools, and float / bf16
    args = re.findall(r"L[ib](\d+)E|(13__nv_bfloat16)|(?<=I)(f)|(?<=E)(f)", m.group(2) or "")
    names = [a or ("bf16" if b else "f32") for a, b, c, d in args]
    return m.group(1) + (f"<{','.join(names)}>" if names else "")


def _ptxas_rows(log_text):
    """{short name: ptxas's entry} of one source's report"""

    return {_short(mangled): dict(e) for mangled, e in _ptxas_entries(log_text).items()}


def _spills(row):
    return row.get("spill_stores", 1) or row.get("spill_loads", 1)


def _check_k4_k5_k6_build(logs):
    """K4's, K5's and K6's kernels: registers, spills and shared memory
    (static from ptxas; dynamic: K4's ring and partials, K5's and K6's
    on-chip rows from their occupancy queries, with their grids).  None
    may spill."""

    from tf_operator_tpu_torch.ops import fused_batchnorm as fb
    from tf_operator_tpu_torch.ops import paged_attention as pa

    for src, tag, prefix in (("paged_attention", "K4", "paged_attention_split_kernel"),
                             ("fused_batchnorm", "K5", "bn_fwd_fused_kernel"),
                             ("fused_batchnorm", "K6", "bn_bwd_fused_kernel")):
        if src not in logs:
            log(f"{src}.cu was built before this run: no ptxas report to check")
            continue
        rows = {n: r for n, r in _ptxas_rows(logs[src]).items() if n.startswith(prefix)}
        for name, row in rows.items():
            args = name.split("<")[1][:-1].split(",")
            if tag == "K4":  # <dtype, D, rows>
                row["dynamic_smem"] = pa.kernel_smem_bytes(int(args[1]), int(args[2]))
            else:  # <dtype, vec, relu, residual>
                code = 1 if args[0] == "bf16" else 0
                find = fb.fwd_resources if tag == "K5" else fb.bwd_resources
                row["grid_ctas"], row["dynamic_smem"] = find(
                    code, int(args[1]), int(args[2]), int(args[3]))
        log(f"{tag} kernels (ptxas) " + json.dumps(rows))
        bad = {n: r for n, r in rows.items() if _spills(r)}
        if bad or not rows:
            raise AssertionError(f"{tag} kernels spill or are missing: {bad or rows}")


def phase_build():
    """Every source at once (one nvcc each, started together), then
    each library loaded; prints ptxas's report per source and, for the
    flash source, every kernel's registers, shared memory and spills,
    the dynamic shared memory K1's, K2's and K3's launchers ask for, and
    their HGMMA count in the SASS; for the int8 matmul source, each K7
    kernel's registers, shared memory and spills; for K4, K5 and K6 the
    same with their dynamic shared memory and grids.  K1's, K2's and
    K3's Hopper kernels must not spill and must issue HGMMA; no K7, K4,
    K5 or K6 kernel may spill."""

    from tf_operator_tpu_torch.ops import _build
    from tf_operator_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"built {sorted(logs)} together in {time.perf_counter() - t0:.1f} s")
    for name in _build.sources():
        _build.load(name)
        report = [ln.strip() for ln in logs.get(name, "").splitlines()
                  if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        log(f"ptxas {name}.cu: " + " | ".join(report))
        # ptxas's warnings (a wgmma it serialised names the reason)
        for ln in logs.get(name, "").splitlines():
            if "warning" in ln.lower():
                log(f"ptxas {name}.cu warning: {ln.strip()[:300]}")
    if "quant_matmul" in logs:
        k7 = _ptxas_rows(logs["quant_matmul"])
        log("K7 kernels (ptxas) " + json.dumps(k7))
        bad = {n: r for n, r in k7.items() if _spills(r)}
        if bad or not k7:
            raise AssertionError(f"K7 kernels spill: {bad or k7}")
    else:
        log("quant_matmul.cu was built before this run: no ptxas report to check")
    _check_k4_k5_k6_build(logs)
    if "flash_attention" not in logs:
        log("flash_attention.cu was built before this run: no ptxas report to check")
        return
    entries = _ptxas_entries(logs["flash_attention"])
    hgmma = _hgmma_counts(_build._library_path("flash_attention"))
    rows = {}
    for mangled, e in entries.items():
        name = _short(mangled)
        rows[name] = dict(e)
        kernel = next((k for k in HOPPER_KERNELS if k in mangled), None)
        if kernel:
            d = int(name.split("<")[1][:-1])
            rows[name]["dynamic_smem"] = fa.hopper_smem_bytes(HOPPER_KERNELS[kernel], d)
            rows[name]["hgmma"] = hgmma.get(mangled, 0)
    log("flash kernels (ptxas, SASS) " + json.dumps(rows))
    bad = {n: r for n, r in rows.items() if any(k in n for k in HOPPER_KERNELS)
           and (_spills(r) or not r.get("hgmma"))}
    missing = [k for k in HOPPER_KERNELS if not any(k in n for n in rows)]
    if bad or missing:
        raise AssertionError(f"K1-K3 Hopper kernels spill, issue no HGMMA or are missing: "
                             f"{bad or missing}")


def k4_case(name, *, s, h, hkv, d, bs, mb, k_new, dtype, max_len, seed, lengths=None):
    from tf_operator_tpu_torch.ops.paged_attention import (
        _gathered_view,
        launch_plan,
        paged_attention_multi,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    nb = s * mb + 1
    q = torch.randn((s, k_new, h, d), generator=g, device=dev).to(dtype)
    ka = torch.randn((nb, hkv, bs, d), generator=g, device=dev).to(dtype)
    va = torch.randn((nb, hkv, bs, d), generator=g, device=dev).to(dtype)
    ka[0] = 1e4  # poisoned scratch: unused table entries point here
    va[0] = 1e4
    perm = torch.randperm(nb - 1, generator=g, device=dev)[: s * mb] + 1
    tables = perm.reshape(s, mb).to(torch.int32)
    if lengths is None:
        lengths = torch.randint(k_new, max_len + 1, (s,), generator=g, device=dev)
    lengths = torch.as_tensor(lengths, device=dev).to(torch.int32)
    for i in range(s):
        used = -(-int(lengths[i]) // bs)
        tables[i, used:] = 0
    args = (q, ka, va, tables, lengths)
    got = paged_attention_multi(*args)
    torch.cuda.synchronize()
    want = paged_attention_multi(*args, impl="plain")
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    row_rel = (diff.amax(-1) / want.float().abs().amax(-1).clamp_min(1e-30)).max().item()
    if not math.isfinite(err) or err > TOL[dtype] or row_rel > ROW_RTOL[dtype]:
        raise AssertionError(
            f"K4 {name}: max abs err {err} (tol {TOL[dtype]}), max row-relative "
            f"err {row_rel} (tol {ROW_RTOL[dtype]})")
    ms = time_ms_queued(lambda: paged_attention_multi(*args))
    plain_ms = time_ms_queued(lambda: paged_attention_multi(*args, impl="plain"), iters=5)
    # the library yardstick: SDPA on the gathered contiguous view
    kv_k, kv_v = _gathered_view(ka, tables), _gathered_view(va, tables)
    qend = lengths[:, None].long() - (k_new - 1 - torch.arange(k_new, device=dev))[None]
    mask = (torch.arange(mb * bs, device=dev)[None, None] < qend[:, :, None])[:, None]
    qt = q.transpose(1, 2)
    if hkv != h:
        kv_k = kv_k.repeat_interleave(h // hkv, dim=1)
        kv_v = kv_v.repeat_interleave(h // hkv, dim=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms_queued(lambda: sdpa(qt, kv_k, kv_v, attn_mask=mask))
    elem = torch.finfo(dtype).bits // 8
    live = int(lengths.clamp(max=mb * bs).sum())
    n_bytes = (2 * live * hkv * d * elem + 2 * q.numel() * elem
               + tables.numel() * 4 + lengths.numel() * 4)
    visible = sum(max(0, int(lengths[i]) - (k_new - 1 - t))
                  for i in range(s) for t in range(k_new))
    ops = 4 * d * h * visible
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    splits, chunk = launch_plan(q, ka, tables)
    rec = {
        "case": name, "splits": splits, "split_positions": chunk,
        "max_abs_err": err, "tol": TOL[dtype],
        "max_row_rel_err": row_rel, "row_rtol": ROW_RTOL[dtype], "kernel_ms": ms,
        "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "live_kv_bytes": 2 * live * hkv * d * elem,
        "host_us": host_us(lambda: paged_attention_multi(*args), calls=50),
    }
    rec["share_of_bound"] = rec["bound_ms"] / ms
    log("K4 " + json.dumps(rec))
    return rec


def phase_k4():
    mha = dict(s=8, h=32, hkv=32, d=128, bs=16, mb=128, max_len=2048)
    gqa = dict(mha, hkv=8)
    cases = [
        ("7b_mha_k1_bf16", dict(mha, k_new=1, dtype=torch.bfloat16)),
        ("7b_mha_k4_bf16", dict(mha, k_new=4, dtype=torch.bfloat16)),
        ("7b_mha_k1_f32", dict(mha, k_new=1, dtype=torch.float32)),
        # seats at the table's end beside short ones (one under a split,
        # one on the split boundary of the 2 x 1024 plan, one a position
        # past it)
        ("7b_mha_k1_bf16_long_short", dict(mha, k_new=1, dtype=torch.bfloat16, lengths=[
            2048, 37, 2048, 1024, 2048, 1025, 2048, 1])),
        ("gqa8_k1_bf16", dict(gqa, k_new=1, dtype=torch.bfloat16)),
        ("gqa8_k4_f32", dict(gqa, k_new=4, dtype=torch.float32)),
        ("bs8_d32_k3_f32", dict(s=5, h=4, hkv=2, d=32, bs=8, mb=9, max_len=70,
                                k_new=3, dtype=torch.float32)),
        ("bs12_d64_k1_bf16", dict(s=5, h=8, hkv=2, d=64, bs=12, mb=7, max_len=84,
                                  k_new=1, dtype=torch.bfloat16)),
        ("bs32_d64_k2_bf16", dict(s=3, h=4, hkv=4, d=64, bs=32, mb=5, max_len=160,
                                  k_new=2, dtype=torch.bfloat16)),
    ]
    return [k4_case(n, seed=i, **kw) for i, (n, kw) in enumerate(cases)]


def _prompts(seed):
    import random

    rng = random.Random(seed)

    def text(n):
        return "".join(chr(rng.randrange(32, 127)) for _ in range(n))

    shared = text(512)
    lengths = [64, 200, 380, 700, 900, 1200, 1500]
    prompts = [text(n) for n in lengths]
    prompts.insert(3, shared + text(150))   # the shared-prefix pair
    prompts[6] = shared + text(400)
    return prompts


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        method="POST",
    )
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as resp:
        out = json.loads(resp.read())
        return resp.status, out, time.perf_counter() - t0


def phase_main_path(model, tag="main path"):
    from tf_operator_tpu_torch.models.batching import PagedContinuousBatchingDecoder
    from tf_operator_tpu_torch.ops import _build
    from tf_operator_tpu_torch.serve_lm import Server

    n_layers = model.cfg.n_layers
    pool = PagedContinuousBatchingDecoder(model, slots=8, steps_per_sync=8,
                                          kv_block_size=16)
    server = Server(pool).start()
    try:
        bodies = [{"prompt": p, "max_new_tokens": 32} for p in _prompts(0)]
        bodies.append({"prompt": "seeded temperature request: ", "max_new_tokens": 32,
                       "temperature": 0.8, "top_k": 40, "seed": 1234})
        results = [None] * len(bodies)

        def send(i):
            results[i] = _post(server.port, bodies[i])

        torch.cuda.reset_peak_memory_stats()
        _build.launches.clear()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=send, args=(i,)) for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        launches = dict(_build.launches)
        if server.fatal:
            raise AssertionError(f"decode loop died: {server.fatal[0]}")
        for i, r in enumerate(results):
            if r is None or r[0] != 200 or len(r[1]["sample"]) != 32:
                raise AssertionError(f"request {i} failed: {r}")
        steps = pool.decode_steps
        k4 = launches.get("paged_attention", 0)
        if k4 != n_layers * steps or steps == 0:
            raise AssertionError(
                f"K4 launched {k4} times; {n_layers} layers x {steps} decode steps "
                f"= {n_layers * steps}")
        recent = list(pool.recent)
        hits = [r for r in recent if r["prefix_tokens"] >= 512]
        if len(hits) != 1:
            raise AssertionError(f"expected one 512-token prefix hit, got {recent}")
        decode_tokens = sum(r["tokens"] - 1 for r in recent)
        stats = {
            "requests": len(results), "wall_s": wall, "decode_steps": steps,
            "k4_launches": k4, "launches": launches,
            "dispatches": dict(pool.dispatches),
            "decode_tokens": decode_tokens,
            "decode_tokens_per_s": decode_tokens / pool.decode_seconds,
            "decode_window_s": pool.decode_seconds,
            "ttft_s": {r["rid"]: round(r["ttft_s"], 4) for r in recent},
            "prompt_tokens": {r["rid"]: r["prompt_tokens"] for r in recent},
            "http_latency_s": [round(r[2], 3) for r in results],
            "prefix_hit_rid": hits[0]["rid"],
            "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
        }
        log(f"{tag} " + json.dumps(stats))
        log(f"seeded sample: {results[-1][1]['sample']!r}")
        return stats, pool
    finally:
        server.close()


def phase_decode_profile(pool):
    """Where one decode window's time goes: the pool (its server
    stopped) admits 8 greedy requests, runs one window unprofiled, then
    one under torch.profiler.  Prints the window's wall, the device's
    busy share of it and the kernels' shares of device time.  The
    profiler slows the host, so the busy share is a lower bound."""

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prompts = [(torch.arange(n) * 7 + 3) % 256 for n in (512, 700, 900, 1100, 300, 1500, 64, 200)]
    rids = [pool.submit(p.numpy(), 2 * pool.steps_per_sync + 1) for p in prompts]
    pool.step()  # admissions and a warm window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        pool.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    pool.run()
    for rid in rids:
        pool.result(rid)

    def dev_us(e):
        return e.self_device_time_total

    # kernels only: a CPU op's own device time repeats its kernels', and
    # some runs list ops such as aten::mm among the CUDA events
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0
              and not e.key.startswith("aten::")]
    busy = sum(dev_us(e) for e in events)
    if busy == 0:
        log("decode window profile: the profiler recorded no device time")
        return None
    top = sorted(events, key=dev_us, reverse=True)[:6]
    rec = {
        "window_steps": pool.steps_per_sync, "profiled_window_ms": wall_us / 1e3,
        "device_busy_ms": busy / 1e3, "device_busy_share": busy / wall_us,
        "k4_share_of_device": sum(dev_us(e) for e in events if "paged_attention" in e.key) / busy,
        "k7_share_of_device": sum(dev_us(e) for e in events if "quant_matmul" in e.key) / busy,
        "top_kernels": [[e.key[:60], round(dev_us(e) / busy, 4), e.count] for e in top],
    }
    log("decode window profile " + json.dumps(rec))
    return rec


def phase_end_to_end(model7b):
    from tf_operator_tpu_torch.models.batching import PagedContinuousBatchingDecoder
    from tf_operator_tpu_torch.models.decode import (
        decode_variant,
        gather_block_view,
        generate,
        init_cache,
        paged_arena,
        paged_decode_variant,
        scatter_block_view,
    )
    from tf_operator_tpu_torch.models.llama import LlamaLM, llama_tiny
    from tf_operator_tpu_torch.models.transformer import PagedCache
    from tf_operator_tpu_torch.models.weights import init_params

    dev = model7b.device
    cfg = llama_tiny(vocab_size=256, max_len=128, dtype=torch.float32)
    tiny = LlamaLM.from_state_dict(cfg, init_params(cfg, 7, dev), dev)
    pool = PagedContinuousBatchingDecoder(tiny, slots=3, steps_per_sync=4, kv_block_size=16)
    g = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, 256, (n,), generator=g) for n in (5, 16, 17, 40, 33)]
    rids = [pool.submit(p.numpy(), 20) for p in prompts]
    pool.run()
    for p, rid in zip(prompts, rids):
        got = pool.result(rid)
        want = generate(tiny, p[None].to(dev), 20)[0].cpu().numpy()
        if not (got == want).all():
            raise AssertionError(f"tiny pool != generate: {got} vs {want}")
    log(f"e2e tiny f32: pool tokens == contiguous generate for {len(prompts)} requests")

    # 7B width: the first decode step through the kernel against the
    # same paged step with the plain attention, and against the
    # contiguous (plain attention) path, from one prompt
    dmodel, pmodel = decode_variant(model7b), paged_decode_variant(model7b)
    ids = torch.randint(0, model7b.cfg.vocab_size, (1, 300), generator=g).to(dev)
    with torch.inference_mode():
        cache = init_cache(dmodel, 1, length=320)
        tok = dmodel(ids, cache=cache)[:, -1].argmax(-1)
        plain = dmodel(tok[:, None], cache=cache)[0, 0]
        bs, mb = 16, 128
        arena = paged_arena(model7b, 21, bs)
        row = torch.zeros(mb, dtype=torch.int32, device=dev)
        row[:20] = torch.arange(1, 21, dtype=torch.int32)
        view = gather_block_view(arena, row[:19], 0)
        tok2 = dmodel(ids, cache=view)[:, -1].argmax(-1)
        scatter_block_view(arena, view, row, 0, 19)
        tables = row[None].contiguous()
        lengths = torch.tensor([300], dtype=torch.int32, device=dev)
        # each layer appends position 300 before it attends, so the two
        # paged steps read the same 300 cached positions and their own
        kernel = pmodel(tok2[:, None], cache=PagedCache(arena, tables, lengths))[0, 0]
        paged_plain = pmodel(tok2[:, None],
                             cache=PagedCache(arena, tables, lengths, impl="plain"))[0, 0]
    rec = {"first_token_equal": bool(tok.item() == tok2.item())}
    for ref_name, ref in (("paged_plain", paged_plain), ("contiguous", plain)):
        err = (kernel - ref).abs().max().item()
        scale = ref.abs().max().item()
        rec[ref_name] = {
            "max_abs_err": err, "max_abs_logit": scale, "rel": err / scale,
            "tol_rel": LOGITS_REL_TOL[ref_name],
            "same_argmax": bool(kernel.argmax() == ref.argmax()),
        }
    log("e2e 7b first-step logits " + json.dumps(rec))
    for ref_name in LOGITS_REL_TOL:
        r = rec[ref_name]
        if not (math.isfinite(r["rel"]) and r["rel"] <= r["tol_rel"] and r["same_argmax"]):
            raise AssertionError(f"7B kernel-path logits off the {ref_name} path: {rec}")
    if not rec["first_token_equal"]:
        raise AssertionError(f"7B paged prefill's token off the contiguous one: {rec}")


#: flash kernels (K1-K3) against their plain versions: kernel by kernel
#: on the same inputs (K2, K3 get the plain forward's lse and delta),
#: per row of D values over the row's largest |plain| (floored at 1e-3
#: of the tensor's largest); through autograd (FlashAttention against
#: autograd through the plain versions) over the tensor's largest
#: |plain|, because the kernel's out, a bf16 ulp off the plain out in
#: places, reaches every gradient through delta = rowsum(dO * O), and a
#: dq row that cancels to near zero then differs by more than its own
#: size.  bf16: the kernels round p and ds to bf16 as tensor-core
#: operands where the plain versions keep float32; readings on the card
#: were under 1e-2.  float32: another summation order
FLASH_RTOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
FLASH_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
#: causal work in units of one product over the visible pairs
#: (2 * D flops per pair): K1 QK^T and PV; K2 QK^T, dO V^T and dS K;
#: K3 QK^T, dO V^T, P^T dO and dS^T Q
FLASH_UNITS = {"flash_attention_fwd": 2, "flash_attention_bwd_dq": 3,
               "flash_attention_bwd_dkv": 4}


def _visible_pairs(sq, sk, causal, window):
    qpos = torch.arange(sq)[:, None]
    kpos = torch.arange(sk)[None, :]
    vis = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        vis = qpos >= kpos
        if window is not None:
            vis &= qpos - kpos < window
    return int(vis.sum())


def _row_rel(got, want):
    got, want = got.float(), want.float()
    floor = 1e-3 * want.abs().max().clamp_min(1e-30)
    return ((got - want).abs().amax(-1) / want.abs().amax(-1).maximum(floor)).max().item()


def _row_ulps(got, want):
    """max over rows of max |got - want| in bf16 ulps of the row's
    largest |want|"""
    got, want = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().amax(-1).clamp_min(1e-30))) - 7)
    return ((got - want).abs().amax(-1) / ulp).max().item()


def _tensor_rel(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def flash_case(name, *, b, h, hkv, sq, sk, d, dtype, causal, window=None, seed=0,
               timed=False):
    from tf_operator_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, h, sq, d), generator=g, device=dev).to(dtype)
    k = torch.randn((b, hkv, sk, d), generator=g, device=dev).to(dtype)
    v = torch.randn((b, hkv, sk, d), generator=g, device=dev).to(dtype)
    do = torch.randn((b, h, sq, d), generator=g, device=dev).to(dtype)
    out, lse = fa.flash_forward_cuda(q, k, v, causal, window)
    p_out, p_lse = fa.flash_forward_plain(q, k, v, causal, window)
    delta = (do.float() * p_out.float()).sum(-1)
    args = (q, k, v, do, p_lse, delta, causal, window)
    dq = fa.flash_backward_dq_cuda(*args)
    dk, dv = fa.flash_backward_dkv_cuda(*args)
    p_dq = fa.flash_backward_dq_plain(*args)
    p_dk, p_dv = fa.flash_backward_dkv_plain(*args)
    torch.cuda.synchronize()
    rec = {"case": name, "shape": [b, h, hkv, sq, sk, d], "dtype": str(dtype),
           "causal": causal, "window": window, "tol": FLASH_RTOL[dtype], "row_rel": {}}
    for n, a, ref in (("out", out, p_out), ("lse", lse[..., None], p_lse[..., None]),
                      ("dq", dq, p_dq), ("dk", dk, p_dk), ("dv", dv, p_dv)):
        rec["row_rel"][n] = _row_rel(a, ref)
    rec["max_abs_err"] = {"fwd": (out.float() - p_out.float()).abs().max().item(),
                          "dq": (dq.float() - p_dq.float()).abs().max().item(),
                          "dkv": max((dk.float() - p_dk.float()).abs().max().item(),
                                     (dv.float() - p_dv.float()).abs().max().item())}
    # gradients through autograd: FlashAttention (kernels) against the
    # plain versions
    grads = {}
    for impl in ("cuda", "plain"):
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        o = fa.flash_attention(qq, kk, vv, causal, window, impl=impl)
        grads[impl] = (o, *torch.autograd.grad(o, (qq, kk, vv), do))
    rec["autograd_rel"] = {n: _tensor_rel(a, ref) for n, a, ref in
                           zip(("out", "dq", "dk", "dv"), grads["cuda"], grads["plain"])}
    del grads
    bad = {n: e for n, e in {**rec["row_rel"], **{f"autograd_{k2}": e2 for k2, e2 in
                                                 rec["autograd_rel"].items()}}.items()
           if not (math.isfinite(e) and e <= FLASH_RTOL[dtype])}
    if timed:
        elem = torch.finfo(dtype).bits // 8
        pairs = b * h * _visible_pairs(sq, sk, causal, window)
        unit = 2 * d * pairs
        qb, kb = q.numel() * elem, k.numel() * elem
        rows = b * h * sq * 4
        n_bytes = {"flash_attention_fwd": qb + 2 * kb + qb + rows,
                   "flash_attention_bwd_dq": 2 * qb + 2 * kb + 2 * rows + qb,
                   "flash_attention_bwd_dkv": 2 * qb + 2 * kb + 2 * rows + 2 * kb}
        kernel_fn = {"flash_attention_fwd": lambda: fa.flash_forward_cuda(q, k, v, causal, window),
                     "flash_attention_bwd_dq": lambda: fa.flash_backward_dq_cuda(*args),
                     "flash_attention_bwd_dkv": lambda: fa.flash_backward_dkv_cuda(*args)}
        plain_fn = {"flash_attention_fwd": lambda: fa.flash_forward_plain(q, k, v, causal, window),
                    "flash_attention_bwd_dq": lambda: fa.flash_backward_dq_plain(*args),
                    "flash_attention_bwd_dkv": lambda: fa.flash_backward_dkv_plain(*args)}
        sdpa = torch.nn.functional.scaled_dot_product_attention
        sq_, sk_, sv_ = (t.clone().requires_grad_() for t in (q, k, v))
        so = sdpa(sq_, sk_, sv_, is_causal=causal, enable_gqa=hkv != h)
        library = {"fwd": time_ms(lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=hkv != h)),
                   "bwd": time_ms(lambda: torch.autograd.grad(so, (sq_, sk_, sv_), do,
                                                              retain_graph=True))}
        rec["timing"] = {}
        for kname in FLASH_KERNELS:
            t_ops = FLASH_UNITS[kname] * unit / PEAK_OPS[dtype] * 1e3
            t_bytes = n_bytes[kname] / HBM_BYTES_PER_S * 1e3
            ms = time_ms(kernel_fn[kname])
            rec["timing"][kname] = {
                "ms": ms, "plain_ms": time_ms(plain_fn[kname], iters=5),
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": library["fwd" if kname == "flash_attention_fwd" else "bwd"],
                "flops": FLASH_UNITS[kname] * unit,
            }
            rec["timing"][kname]["share_of_bound"] = rec["timing"][kname]["bound_ms"] / ms
        rec["sdpa_ms"] = library
    log("flash " + json.dumps(rec))
    if bad:
        raise AssertionError(f"flash {name}: errors over the tolerance {FLASH_RTOL[dtype]}: {bad}")
    return rec


def phase_flash():
    wide = dict(b=4, h=16, hkv=8, sq=2048, sk=2048, d=128, dtype=torch.bfloat16, causal=True)
    small = dict(b=1, h=8, hkv=4, sq=1024, sk=1024, d=128, dtype=torch.bfloat16, causal=True)
    cases = [
        ("wide_causal_bf16", dict(wide, timed=True)),
        # GQA group 4: K3 folds four query heads into each kv tile's walk
        ("wide_gqa4_causal_bf16", dict(wide, h=32, timed=True)),
        ("noncausal_bf16", dict(small, causal=False)),
        ("window256_s1024_bf16", dict(small, window=256)),
        ("cross_sq512_sk1024_bf16", dict(small, sq=512)),
        ("cross_noncausal_sq1024_sk700_bf16", dict(small, sk=700, causal=False)),
        ("s1000_bf16", dict(small, sq=1000, sk=1000)),
        ("d64_bf16", dict(small, d=64)),
        # the 64-byte swizzle route (32-column panels)
        ("d96_bf16", dict(small, d=96)),
        ("d32_bf16", dict(small, d=32)),
        # a kv tile straddling the diagonal at a non-square offset
        ("cross_sq192_sk320_bf16", dict(small, sq=192, sk=320)),
        ("mha_bf16", dict(small, hkv=8)),
        ("f32_causal_gqa", dict(small, sq=512, sk=512, dtype=torch.float32)),
    ]
    return [flash_case(n, seed=i, **kw) for i, (n, kw) in enumerate(cases)]


def time_ms_cold(fn, copies, iters=20, warmup=3):
    """Device ms per call of ``fn(c)``, over the copies ``c`` of its
    weight in turn, so no launch finds its weight in L2 from the launch
    before.  The timed launches are queued behind a device sleep, so
    that a call whose host side takes longer than its kernel (K7 at the
    decode shapes) is timed on the device, not on the host."""

    for i in range(warmup):
        fn(copies[i % len(copies)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~30 ms: the host queues every launch meanwhile
    start.record()
    for i in range(iters):
        fn(copies[i % len(copies)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_ms_queued(fn, iters=20, warmup=3):
    """Device ms per call of ``fn``, its launches queued behind a device
    sleep so that a call whose host side takes longer than its kernels
    is timed on the device (CUDA events, as ``time_ms``)."""

    return time_ms_cold(lambda _: fn(), [None], iters=iters, warmup=warmup)


def host_us(fn, calls=200):
    """Host microseconds per call of ``fn``, its launches left to run."""

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def k7_case(name, *, m, k, n, dtype, seed, timed=False):
    from tf_operator_tpu_torch.ops import quant_matmul as qm
    from tf_operator_tpu_torch.ops.quant import QTensor, quantize_array

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, k), generator=g, device=dev).to(dtype)
    qt = quantize_array(torch.randn((k, n), generator=g, device=dev) * 0.02)
    got = qm.quant_matmul(x, qt, dtype)
    torch.cuda.synchronize()
    want = qm.quant_matmul(x, qt, dtype, impl="plain")
    err = (got.float() - want.float()).abs().max().item()
    row_rel = _row_rel(got, want)
    rec = {"case": name, "m": m, "k": k, "n": n, "dtype": str(dtype), "max_abs_err": err,
           "max_row_rel_err": row_rel, "row_rtol": QM_RTOL[dtype]}
    if timed:
        # enough copies of the weight to exceed the 50 MB L2 twice over
        n_copies = max(2, min(16, -(-100_000_000 // (k * n))))
        qs = [qt] + [QTensor(qt.q.clone(), qt.scale.clone()) for _ in range(n_copies - 1)]
        ws = [q.q.to(torch.bfloat16) for q in qs]
        elem = torch.finfo(dtype).bits // 8
        n_bytes = k * n + 4 * n + (m * k + m * n) * elem
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * m * k * n / PEAK_OPS[dtype] * 1e3
        rec.update({
            "ms": time_ms_cold(lambda q: qm.quant_matmul(x, q, dtype), qs),
            "plain_ms": time_ms_cold(lambda q: qm.quant_matmul(x, q, dtype, impl="plain"), qs,
                                     iters=5),
            "library_ms": time_ms_cold(lambda w: torch.matmul(x, w), ws),
            "library": "torch.matmul(x, bf16 weight of the same shape)",
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops
            else "operations", "weight_copies": n_copies,
        })
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        if m == 8:
            # the host side of one call as a decode step makes it
            # (DenseGeneral's quant_matmul_2d on its flat operands),
            # against torch.matmul
            s_flat = qt.scale.reshape(n)
            rec["host_us"] = {
                "quant_matmul_2d": host_us(lambda: qm.quant_matmul_2d(x, qt.q, s_flat, dtype)),
                "torch.matmul": host_us(lambda: torch.matmul(x, ws[0]))}
        del qs, ws
    log("K7 " + json.dumps(rec))
    if not (math.isfinite(row_rel) and row_rel <= QM_RTOL[dtype]):
        raise AssertionError(f"K7 {name}: row-relative error {row_rel} over {QM_RTOL[dtype]}")
    return rec


def phase_k7():
    """K7 against its plain version; the routes of the wrapper."""

    from tf_operator_tpu_torch.ops import _build
    from tf_operator_tpu_torch.ops import quant_matmul as qm
    from tf_operator_tpu_torch.ops.quant import QTensor, quantize_array

    recs = []
    for (k, n) in PROJ_7B:
        for m in (1, 8, 64):
            recs.append(k7_case(f"7b_m{m}_k{k}_n{n}_bf16", m=m, k=k, n=n,
                                dtype=torch.bfloat16, seed=len(recs), timed=True))
    for m, n in ((8, 384), (33, 640), (8, 768), (64, 1024)):
        recs.append(k7_case(f"m{m}_k96_n{n}_bf16", m=m, k=96, n=n, dtype=torch.bfloat16,
                            seed=len(recs)))
    for m, k, n in ((8, 96, 384), (64, 4096, 4096)):
        recs.append(k7_case(f"m{m}_k{k}_n{n}_f32", m=m, k=k, n=n, dtype=torch.float32,
                            seed=len(recs)))
    # the routes: out of range takes the GEMM route; a weight the kernel
    # cannot take raises; neither runs the plain version
    dev = torch.device("cuda")
    routes = {}
    for m, k, n in ((65, 4096, 4096), (8, 100, 384), (8, 96, 320)):
        x = torch.randn((m, k), device=dev).to(torch.bfloat16)
        qt = quantize_array(torch.randn((k, n), device=dev))
        qm.plain_calls.clear()
        _build.launches.clear()
        got = qm.quant_matmul(x, qt)
        launched = dict(_build.launches)
        if launched != {qm.GEMM: 1} or qm.plain_calls:
            raise AssertionError(f"K7 route for M={m} K={k} N={n}: {launched}, plain "
                                 f"{dict(qm.plain_calls)}")
        ulps = _row_ulps(got, qm.quant_matmul(x, qt, impl="plain"))
        routes[f"m{m}_k{k}_n{n}"] = {"launches": launched, "max_row_ulps": ulps}
        if ulps > 1.0:
            raise AssertionError(f"GEMM route for M={m} K={k} N={n}: {ulps} bf16 ulps "
                                 "of the row's largest off the plain version")
    qm.plain_calls.clear()
    x = torch.randn((8, 96), device=dev).to(torch.bfloat16)
    qt = quantize_array(torch.randn((96, 512), device=dev))
    try:
        qm.quant_matmul(x, QTensor(qt.q[:, ::2], qt.scale[..., ::2]))
        raise AssertionError("K7 took a strided weight")
    except ValueError as exc:
        routes["strided_q"] = str(exc)
    # a contiguous weight view 4 bytes into its storage: the 16-byte
    # copies cannot read it
    store = torch.empty(qt.q.numel() + 16, dtype=torch.int8, device=dev)
    shifted = store[4:4 + qt.q.numel()].view(qt.q.shape)
    shifted.copy_(qt.q)
    try:
        qm.quant_matmul(x, QTensor(shifted, qt.scale))
        raise AssertionError("K7 took a weight off 16 bytes")
    except ValueError as exc:
        routes["q_off_16_bytes"] = str(exc)
    if qm.plain_calls:
        raise AssertionError(f"a K7 route ran the plain version: {dict(qm.plain_calls)}")
    log("K7 routes " + json.dumps(routes))
    return recs


def k7_decode_step(recs):
    """K7's per-launch numbers over one 7B decode step's mix of shapes at
    M = 8 (225 launches), and the step's totals."""

    by_shape = {(r["k"], r["n"]): r for r in recs if r["m"] == 8 and "ms" in r}
    launches = sum(PROJ_7B.values())
    step = {key: sum(PROJ_7B[s] * by_shape[s][key] for s in PROJ_7B)
            for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
    rec = {key: v / launches for key, v in step.items()}
    rec.update({"bound_by": "bytes", "launches_per_step": launches,
                "step_totals_ms": step,
                "max_abs_err": max(r["max_abs_err"] for r in recs
                                   if r["case"].startswith("7b_"))})
    log("K7 decode step (M = 8) " + json.dumps(rec))
    return rec


def training_flops_per_token(cfg, seq_len):
    """Model flops of one trained token (forward + backward = 3x the
    forward): 6 x the matmul parameters (every kernel but the embedding
    gather) plus the causal attention products, 6 * L * H * D * S (two
    products of 2 * D flops over S/2 positions on average, x3)."""

    e, h, hkv, d, m = cfg.hidden, cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.mlp_dim
    per_layer = e * h * d + 2 * e * hkv * d + h * d * e + 3 * e * m
    matmul = cfg.n_layers * per_layer + e * cfg.vocab_size
    return 6.0 * matmul + 6 * cfg.n_layers * h * d * seq_len


def _steady_step_s(resolved_at):
    """Seconds per step between the first and the last loss resolve
    (the first window, which holds the warm-up, is left out)."""

    (n0, t0), (n1, t1) = resolved_at[0], resolved_at[-1]
    return (t1 - t0) / (n1 - n0)


def phase_train(data_dir, export_dir, steps):
    """The training main path: ``llama_pretrain`` at llama-wide, full
    depth, seq 2048 x batch 4, through its own entry point.  Counts are
    zeroed just before and read just after: K1, K2 and K3 must each
    launch 12 layers x steps times, and no plain attention may run."""

    from tf_operator_tpu_torch import llama_pretrain
    from tf_operator_tpu_torch.ops import _build
    from tf_operator_tpu_torch.ops import flash_attention as fa

    args = llama_pretrain.parse_args([
        "--model", "llama-wide", "--seq-len", "2048", "--batch-per-device", "4",
        "--steps", str(steps), "--steps-per-sync", "5", "--data-dir", data_dir,
        "--export-dir", export_dir, "--generate", "0"])
    torch.cuda.reset_peak_memory_stats()
    _build.launches.clear()
    fa.plain_calls.clear()
    out = llama_pretrain.run(args)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    plain = dict(fa.plain_calls)
    trainer, losses = out["trainer"], out["losses"]
    cfg = trainer.model.cfg
    step_s = _steady_step_s(out["resolved_at"])
    tokens = args.batch_per_device * args.seq_len
    flops_tok = training_flops_per_token(cfg, args.seq_len)
    stats = {
        "model": "llama-wide", "layers": cfg.n_layers, "steps": steps,
        "params": sum(p.numel() for p in trainer.params),
        "loss_first": losses[0], "loss_last5": sum(losses[-5:]) / 5,
        "losses": [round(x, 4) for x in losses],
        "launches": launches, "plain_calls": plain,
        "wall_s": out["wall_s"], "step_ms": step_s * 1e3,
        "tokens_per_s": tokens / step_s,
        "model_tflops": flops_tok * tokens / step_s / 1e12,
        "flops_per_token": flops_tok,
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    stats["peak_share"] = stats["model_tflops"] * 1e12 / PEAK_OPS[torch.bfloat16]
    log("train " + json.dumps(stats))
    want = cfg.n_layers * steps
    for kname in FLASH_KERNELS:
        if launches.get(kname, 0) != want:
            raise AssertionError(f"{kname} launched {launches.get(kname, 0)} times; "
                                 f"{cfg.n_layers} layers x {steps} steps = {want}")
    if sum(plain.values()):
        raise AssertionError(f"plain attention ran on the card during training: {plain}")
    if not stats["loss_last5"] < stats["loss_first"]:
        raise AssertionError(f"the loss did not fall: {losses}")
    return stats, trainer, args


def phase_train_profile(trainer, batch, tag="train step", shares=(("flash", "flash_"),)):
    """One training step under torch.profiler: the device's busy share
    of the step's wall, the device-time share of each kernel whose name
    holds one of ``shares``' patterns, the top kernels and the largest
    kernel families (a kernel's name up to its template arguments)."""

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    trainer.train_step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
              and not e.key.startswith("aten::")]
    busy = sum(e.self_device_time_total for e in events)
    if busy == 0:
        log(f"{tag} profile: the profiler recorded no device time")
        return None
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    families = {}
    for e in events:
        fam = e.key.split("<")[0].split("(")[0].strip()[:60]
        families[fam] = families.get(fam, 0) + e.self_device_time_total
    rec = {"profiled_step_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
           "device_busy_share": busy / wall_us,
           "top_kernels": [[e.key[:60], round(e.self_device_time_total / busy, 4), e.count]
                           for e in top],
           "top_families": [[f, round(t / busy, 4)] for f, t in
                            sorted(families.items(), key=lambda kv: -kv[1])[:8]]}
    for name, pattern in shares:
        rec[f"{name}_share_of_device"] = sum(
            e.self_device_time_total for e in events if pattern in e.key) / busy
    log(f"{tag} profile " + json.dumps(rec))
    return rec


#: one-step parity at the wide config: the first step's loss and grad
#: norm through the kernels against the same step with the plain
#: attention (same weights, same batch; only the attention differs).
#: Relative bounds from the readings on an H100 at seed 0 (loss
#: 4.2e-6 to 1.7e-5, grad norm 9.5e-7 to 6.0e-5 across the kernel
#: versions measured), which leave room for another rounding of p and
#: for cuBLAS's choice of algorithms, and no room for a wrong gradient
PARITY_RTOL = {"loss": 5e-5, "grad_norm": 5e-4}


def phase_parity(args, batch):
    from tf_operator_tpu_torch.llama_pretrain import INIT_SEED, model_config
    from tf_operator_tpu_torch.models.llama import LlamaLM, llama_loss
    from tf_operator_tpu_torch.models.weights import init_params
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.parallel.trainer import Trainer, TrainerConfig

    dev = torch.device("cuda")
    cfg = model_config(args.model, args.seq_len)
    model = LlamaLM.from_state_dict(cfg, init_params(cfg, INIT_SEED, dev, trainable=True),
                                    dev, trainable=True)
    tcfg = TrainerConfig(learning_rate=args.learning_rate, warmup_steps=10)
    fa.plain_calls.clear()
    got = Trainer(model, tcfg, llama_loss).compute_grads(batch)
    want = Trainer(model.variant(plain_kernels=True), tcfg, llama_loss).compute_grads(batch)
    if fa.plain_calls[fa.KERNEL_FWD] != cfg.n_layers:
        raise AssertionError(f"the plain step did not run the plain attention: {fa.plain_calls}")
    rec = {}
    for key in PARITY_RTOL:
        a, b = float(got[key]), float(want[key])
        rec[key] = {"kernels": a, "plain": b, "rel": abs(a - b) / abs(b), "tol": PARITY_RTOL[key]}
    log("one-step parity " + json.dumps(rec))
    for key, r in rec.items():
        if not (math.isfinite(r["rel"]) and r["rel"] <= r["tol"]):
            raise AssertionError(f"one-step parity: {key} off the plain step: {rec}")
    return rec


def phase_serve_artifact(trainer, export_dir):
    """Train -> export -> serve: the port's serve_lm on the exported
    artifact (K4 at Hkv 8) answers one greedy request with the tokens
    ``generate`` gives on the trained parameters in this process."""

    from tf_operator_tpu_torch.data.text import decode_bytes
    from tf_operator_tpu_torch.models.batching import PagedContinuousBatchingDecoder
    from tf_operator_tpu_torch.models.decode import generate
    from tf_operator_tpu_torch.ops import _build
    from tf_operator_tpu_torch.serve_lm import Server, load_model

    prompt, n_new = "the sharded ", 32
    model = load_model(torch.device("cuda"), max_len=2048, artifact=export_dir)
    pool = PagedContinuousBatchingDecoder(model, slots=2, steps_per_sync=8, kv_block_size=16)
    server = Server(pool).start()
    try:
        _build.launches.clear()
        status, body, _ = _post(server.port, {"prompt": prompt, "max_new_tokens": n_new})
        k4 = _build.launches.get("paged_attention", 0)
    finally:
        server.close()
    ids = torch.tensor([list(prompt.encode())], device="cuda")
    want = generate(trainer.model, ids, n_new)[0, len(prompt):].tolist()
    # the server answers bytes: the in-process tokens, decoded the same
    # way, must give the same text, and are all bytes (< 256), so that
    # equal text is equal tokens
    got = body.get("sample") if status == 200 else None
    rec = {"status": status, "served_sample": got, "generate_sample": decode_bytes(want),
           "generate_tokens": want, "k4_launches": k4}
    log("train->export->serve " + json.dumps(rec))
    if (status != 200 or got != rec["generate_sample"] or max(want) >= 256
            or k4 == 0):
        raise AssertionError(f"served artifact off in-process generate: {rec}")
    del pool, model
    return rec


def phase_int8_serving(bf16_stats):
    """Phase 9: the 7B int8 model through ``load_model(quantize="int8")``
    behind the server; K7, GEMM-route and K4 counts; no plain calls."""

    from tf_operator_tpu_torch.models.llama import LlamaLM, llama_7b_shape
    from tf_operator_tpu_torch.ops import quant_matmul as qm
    from tf_operator_tpu_torch.ops.quant import state_bytes
    from tf_operator_tpu_torch.serve_lm import load_model

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = load_model(dev, max_len=2048, model="llama-7b", init_seed=0, quantize="int8")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    weights = {"bf16_bytes": state_bytes(LlamaLM(llama_7b_shape(max_len=2048),
                                                 device="meta").state_dict()),
               "int8_bytes": state_bytes(model.state_dict()),
               "load_and_quantize_s": load_s,
               "peak_during_load_gib": torch.cuda.max_memory_allocated() / 2**30}
    log("int8 weights " + json.dumps(weights))
    qm.plain_calls.clear()
    stats, pool = phase_main_path(model, tag="int8 main path")
    plain = dict(qm.plain_calls)
    n_proj = 7 * model.cfg.n_layers + 1
    rows = [r["prompt_tokens"] - r["prefix_tokens"] for r in pool.recent]
    short = sum(1 for r in rows if r <= qm.MAX_GEMV_ROWS)
    k7, gemm = stats["launches"].get(qm.KERNEL, 0), stats["launches"].get(qm.GEMM, 0)
    want = {"k7": n_proj * (stats["decode_steps"] + short),
            "gemm": n_proj * (len(rows) - short)}
    compare = {
        "k7_launches": k7, "gemm_launches": gemm, "expected": want,
        "prefill_rows": rows, "plain_calls": plain,
        "decode_tokens_per_s": {"int8": stats["decode_tokens_per_s"],
                                "bf16": bf16_stats["decode_tokens_per_s"]},
        "mean_ttft_s": {"int8": sum(stats["ttft_s"].values()) / len(stats["ttft_s"]),
                        "bf16": sum(bf16_stats["ttft_s"].values()) / len(bf16_stats["ttft_s"])},
        "max_memory_allocated_gib": {"int8": stats["max_memory_allocated_gib"],
                                     "bf16": bf16_stats["max_memory_allocated_gib"]},
    }
    log("int8 vs bf16 serving " + json.dumps(compare))
    if k7 != want["k7"] or gemm != want["gemm"]:
        raise AssertionError(f"int8 serving launches off: {compare}")
    if sum(plain.values()):
        raise AssertionError(f"the plain int8 matmul ran on the card: {plain}")
    phase_decode_profile(pool)
    del pool
    return stats, model


def phase_int8_end_to_end(model7b):
    """Phase 10: int8 token identity on llama_tiny, and the 7B first
    paged decode step through K7 against the plain int8 matmul."""

    from tf_operator_tpu_torch.models.batching import PagedContinuousBatchingDecoder
    from tf_operator_tpu_torch.models.decode import (
        decode_variant,
        gather_block_view,
        generate,
        paged_arena,
        paged_decode_variant,
        scatter_block_view,
    )
    from tf_operator_tpu_torch.models.llama import LlamaLM, llama_tiny
    from tf_operator_tpu_torch.models.transformer import PagedCache
    from tf_operator_tpu_torch.models.weights import init_params
    from tf_operator_tpu_torch.ops import _build
    from tf_operator_tpu_torch.ops import quant_matmul as qm

    dev = model7b.device
    cfg = llama_tiny(vocab_size=256, max_len=128, dtype=torch.float32)
    tiny = LlamaLM.from_state_dict(cfg, init_params(cfg, 7, dev, quantize=True), dev)
    pool = PagedContinuousBatchingDecoder(tiny, slots=3, steps_per_sync=4, kv_block_size=16)
    g = torch.Generator().manual_seed(4)
    prompts = [torch.randint(0, 256, (n,), generator=g) for n in (5, 16, 17, 40, 33)]
    _build.launches.clear()
    rids = [pool.submit(p.numpy(), 20) for p in prompts]
    pool.run()
    k7 = _build.launches.get(qm.KERNEL, 0)
    plain = tiny.variant(plain_kernels=True)
    for p, rid in zip(prompts, rids):
        got = pool.result(rid)
        want = generate(plain, p[None].to(dev), 20)[0].cpu().numpy()
        if not (got == want).all():
            raise AssertionError(f"tiny int8 pool through K7 != plain generate: {got} vs {want}")
    if k7 == 0:
        raise AssertionError("the tiny int8 pool launched no K7")
    log(f"e2e tiny f32 int8: pool tokens through K7 ({k7} launches) == generate with the "
        f"plain int8 matmul for {len(prompts)} requests")

    dmodel, pmodel = decode_variant(model7b), paged_decode_variant(model7b)
    ids = torch.randint(0, model7b.cfg.vocab_size, (1, 300), generator=g).to(dev)
    with torch.inference_mode():
        bs, mb = 16, 128
        arena = paged_arena(model7b, 21, bs)
        row = torch.zeros(mb, dtype=torch.int32, device=dev)
        row[:20] = torch.arange(1, 21, dtype=torch.int32)
        view = gather_block_view(arena, row[:19], 0)
        tok = dmodel(ids, cache=view)[:, -1].argmax(-1)
        scatter_block_view(arena, view, row, 0, 19)
        tables = row[None].contiguous()
        lengths = torch.tensor([300], dtype=torch.int32, device=dev)
        _build.launches.clear()
        kernel = pmodel(tok[:, None], cache=PagedCache(arena, tables, lengths))[0, 0]
        launches = dict(_build.launches)
        ref = pmodel.variant(plain_kernels=True)(
            tok[:, None], cache=PagedCache(arena, tables, lengths))[0, 0]
    err = (kernel - ref).abs().max().item()
    rec = {"max_abs_err": err, "max_abs_logit": ref.abs().max().item(),
           "rel": err / ref.abs().max().item(), "tol_rel": INT8_LOGITS_REL_TOL,
           "same_argmax": bool(kernel.argmax() == ref.argmax()), "kernel_step_launches": launches}
    log("e2e 7b int8 first-step logits, K7 vs plain int8 matmul " + json.dumps(rec))
    if launches.get(qm.KERNEL, 0) != 7 * model7b.cfg.n_layers + 1:
        raise AssertionError(f"the 7B int8 step did not run K7 on every projection: {rec}")
    if not (math.isfinite(rec["rel"]) and rec["rel"] <= INT8_LOGITS_REL_TOL
            and rec["same_argmax"]):
        raise AssertionError(f"7B int8 logits through K7 off the plain int8 matmul: {rec}")


#: K5 / K6 against their plain versions on the same inputs (K6 is fed the
#: kernel's own y, mean and var).  float32: y and dx within 1e-4 of the
#: tensor's largest value, mean and var 1e-5 relative (sums in another
#: order).  bf16: y within one bf16 ulp of each element, the ulp taken
#: at no less than |y| = 1/16 (both round one float32 value once, but
#: the kernel's fused multiply-add and the plain version's multiply,
#: then add, differ by a float32 rounding of the O(1) terms, which is
#: several bf16 ulps of a y that cancels to near zero: 2 to 6 read on
#: the card before the floor); dx within
#: 1e-2 of the tensor's largest |dx| (an element that cancels near zero
#: may round an ulp of the tensor's scale away); dres bit for bit (the same
#: masked dy).  dgamma and dbeta 1e-4 of their largest (float32 sums in
#: another order).  Through autograd (K5 + K6 against the plain Function):
#: every gradient within 1e-4 (float32) or 2e-2 (bf16) of its largest,
#: apart from the elements where the two forwards' ReLU masks differ
#: (bn_case).
BN_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
BN_AUTOGRAD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
#: the JAX test's ragged shapes (tests/test_fused_batchnorm.py:30)
BN_RAGGED = [(2, 3, 3, 5), (34, 1, 1, 7), (1, 9, 5, 130)]
#: the class the kernels line reports: the largest norm with neither
#: ReLU nor residual, where F.batch_norm computes the same function
BN_LINE_CLASS = (200704, 256, False, False)
#: K5 and K6 are timed this many times at every class; the step totals
#: are reported as the median of the repeats and their spread
BN_REPEATS = 3
#: ResNet training of the main path: resnet_dp's own 30 steps, then its
#: benchmark's max(30 // 2, 5)
RESNET_STEPS = 30
#: one-step parity at ResNet-50, batch 64, 224 px: the first step through
#: K5 / K6 against the same step through their plain versions (same init,
#: same batch; only the norms' arithmetic differs).  bf16 activations
#: round an ulp apart in places at every norm and the difference crosses
#: 53 norms and their convolutions.  The H100 read 5.8e-6 (loss), 7.1e-6
#: (gradient norm) and 1.3e-4 (each norm's updated running mean and var,
#: relative to that tensor's largest value); the limits stand about ten
#: times above those readings
RESNET_PARITY_RTOL = {"loss": 1e-4, "grad_norm": 1e-4, "running_stats": 1e-3}
#: the reference's A/B (benchmarks/measure.py:334-400): stock norms
#: against fused on the same init and batch, 3 sgd steps each.  The two
#: graphs round the residual add at another place (the stock graph casts
#: to bf16, then adds; the fused one adds in float32, then casts), so the
#: losses drift apart step by step; the H100 read 2.2e-5 by the third
#: step, and the limit stands about 45 times above it (the reference
#: records the difference without a bound)
RESNET_AB_RTOL = 1e-3


def resnet50_layout(batch, image):
    """ResNet-50's norms at ``batch`` x ``image`` px, in forward order, as
    (R, C, relu, residual), and the model flops of one image's forward
    (2 x multiply-adds of every convolution and the head), read from a
    forward on the meta device."""

    from tf_operator_tpu_torch.models import resnet

    model = resnet.resnet50(device="meta").eval()
    layers, flops = [], [2 * model.head.kernel.numel()]

    def norm_hook(mod, args, kwargs, out):
        x = args[0]
        layers.append((batch * (x.numel() // x.shape[-1]), x.shape[-1],
                       bool(kwargs.get("relu", False)), kwargs.get("residual") is not None))

    def conv_hook(mod, args, out):
        flops[0] += 2 * mod.kernel.numel() * out.shape[1] * out.shape[2]

    for m in model.modules():
        if isinstance(m, resnet.BatchNorm):
            m.register_forward_hook(norm_hook, with_kwargs=True)
        elif isinstance(m, resnet.Conv):
            m.register_forward_hook(conv_hook)
    model(torch.empty(1, image, image, 3, device="meta"))
    return layers, flops[0]


def _bf16_ulps(got, want):
    got, want = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -4))) - 7)
    return ((got - want).abs() / ulp).max().item()


def bn_case(name, shape, relu, use_res, dtype, seed, timed=False):
    """K5 and K6 against their plain versions at one NHWC shape; with
    ``timed``, their times beside the bound, the plain versions' and
    F.batch_norm's (training=True, forward and its autograd backward)."""

    import torch.nn.functional as F
    from tf_operator_tpu_torch.ops import fused_batchnorm as fb

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    c = shape[-1]
    x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.3).to(dtype)
    gamma = torch.randn(c, generator=g, device=dev)
    beta = torch.randn(c, generator=g, device=dev)
    res = torch.randn(shape, generator=g, device=dev).to(dtype) if use_res else None
    dy = torch.randn(shape, generator=g, device=dev).to(dtype)
    x2, dy2 = x.view(-1, c), dy.view(-1, c)
    r2 = res.view(-1, c) if use_res else None
    eps = 1e-5
    fwd = lambda: fb.fused_batchnorm_fwd_cuda(x2, gamma, beta, eps, relu, r2)
    y, m, v = fwd()
    bwd = lambda: fb.fused_batchnorm_bwd_cuda(dy2, x2, gamma, y, m, v, eps, relu, use_res)
    dx, dg, db, dr = bwd()
    torch.cuda.synchronize()
    py, pm, pv = fb.fused_batchnorm_fwd_plain(x2, gamma, beta, eps, relu, r2)
    pdx, pdg, pdb, pdr = fb.fused_batchnorm_bwd_plain(dy2, x2, gamma, y, m, v, eps, relu,
                                                      use_res)
    rec = {"case": name, "shape": list(shape), "relu": relu, "residual": use_res,
           "dtype": str(dtype),
           "max_abs_err": {"y": (y.float() - py.float()).abs().max().item(),
                           "dx": (dx.float() - pdx.float()).abs().max().item()},
           "rel": {"mean": _tensor_rel(m, pm), "var": _tensor_rel(v, pv),
                   "dgamma": _tensor_rel(dg, pdg), "dbeta": _tensor_rel(db, pdb),
                   "dx": _tensor_rel(dx, pdx)}}
    bad = {k: e for k, e in rec["rel"].items()
           if not (math.isfinite(e) and e <= (BN_RTOL[dtype] if k == "dx" else 1e-4))}
    if dtype == torch.bfloat16:
        rec["y_bf16_ulps"] = _bf16_ulps(y, py)
        if not rec["y_bf16_ulps"] <= 1.0:
            bad["y_ulps"] = rec["y_bf16_ulps"]
    else:
        rec["rel"]["y"] = _tensor_rel(y, py)
        if not rec["rel"]["y"] <= BN_RTOL[dtype]:
            bad["y"] = rec["rel"]["y"]
    if use_res and not torch.equal(dr, pdr):
        bad["dres"] = "not bit for bit"
    # through autograd: the Function with the kernels against the plain one
    grads = {}
    for impl in (None, "plain"):
        ts = [t.clone().requires_grad_() for t in (x, gamma, beta) + ((res,) if use_res else ())]
        out, _, _ = fb.fused_batchnorm(ts[0], ts[1], ts[2], eps=eps, relu=relu,
                                       residual=ts[3] if use_res else None, impl=impl)
        out.backward(dy)
        grads[impl] = [out] + [t.grad for t in ts]
    # where one forward rounds y to 0 and the other to a tiny positive
    # value, the ReLU masks differ and that element's g differs by a
    # whole dy.  Such elements must lie within the floored bf16 ulp of 0
    # and are counted; dx and dres are compared where the masks agree,
    # dgamma and dbeta with the flipped elements' own terms taken out
    agree = torch.ones_like(x, dtype=torch.bool)
    corr = {}
    if relu:
        yk, yp = grads[None][0].float(), grads["plain"][0].float()
        agree = (yk > 0) == (yp > 0)
        near0 = torch.maximum(yk.abs(), yp.abs()) <= 2.0 ** -11
        rec["relu_mask_flips"] = int((~agree).sum())
        if not bool(near0[~agree].all()):
            bad["relu_mask_flip_away_from_0"] = rec["relu_mask_flips"]
        flip = ((yk > 0).float() - (yp > 0).float()) * dy.float()
        red = tuple(range(x.ndim - 1))
        corr = {"dbeta": flip.sum(red),
                "dgamma": (flip * (x.float() - pm) * torch.rsqrt(pv + eps)).sum(red)}
    names = ("y", "dx", "dgamma", "dbeta", "dres")
    rec["autograd_rel"] = {}
    for n, a, b in zip(names, grads[None], grads["plain"]):
        if n in ("dx", "dres"):
            a, b = a * agree, b * agree
        rec["autograd_rel"][n] = _tensor_rel(a.float() - corr.get(n, 0.0), b)
    del grads
    bad.update({f"autograd_{k}": e for k, e in rec["autograd_rel"].items()
                if not (math.isfinite(e) and e <= BN_AUTOGRAD_RTOL[dtype])})
    if timed:
        elem = torch.finfo(dtype).bits // 8
        f_bytes, b_bytes = fb.bytes_moved(x2.shape[0], c, elem, relu, use_res)
        xv = x.permute(0, 3, 1, 2)
        lx = xv.detach().requires_grad_()
        lg, lb = gamma.clone().requires_grad_(), beta.clone().requires_grad_()
        lo = F.batch_norm(lx, None, None, lg, lb, training=True, eps=eps)
        dyv = dy.permute(0, 3, 1, 2)
        runs = {fb.KERNEL_FWD: [], fb.KERNEL_BWD: []}
        for _ in range(BN_REPEATS):
            runs[fb.KERNEL_FWD].append(time_ms_queued(fwd))
            runs[fb.KERNEL_BWD].append(time_ms_queued(bwd))
        rec["timing"] = {
            "fused_batchnorm_fwd": {
                "bound_ms": f_bytes / HBM_BYTES_PER_S * 1e3,
                "plain_ms": time_ms_queued(lambda: fb.fused_batchnorm_fwd_plain(
                    x2, gamma, beta, eps, relu, r2), iters=5),
                "library_ms": time_ms_queued(lambda: F.batch_norm(
                    xv, None, None, gamma, beta, training=True, eps=eps)),
                "host_us": host_us(fwd, calls=50)},
            "fused_batchnorm_bwd": {
                "bound_ms": b_bytes / HBM_BYTES_PER_S * 1e3,
                "plain_ms": time_ms_queued(lambda: fb.fused_batchnorm_bwd_plain(
                    dy2, x2, gamma, y, m, v, eps, relu, use_res), iters=5),
                "library_ms": time_ms_queued(lambda: torch.autograd.grad(
                    lo, (lx, lg, lb), dyv, retain_graph=True)),
                "host_us": host_us(bwd, calls=50)},
        }
        for kname, t in rec["timing"].items():
            t.update(ms=statistics.median(runs[kname]), ms_runs=runs[kname], bound_by="bytes")
            t["share_of_bound"] = t["bound_ms"] / t["ms"]
        code = fb._DTYPE_CODES[dtype]
        ctas, hold = fb.fwd_resources(code, fb._vector_io(c, x2, y, *((r2,) if use_res else ())),
                                      int(relu), int(use_res))
        held = fb.fwd_held_bytes(x2.shape[0], c, ctas, hold, elem)
        rec["timing"]["fused_batchnorm_fwd"].update(
            held_on_chip_bytes=held, held_share_of_rows=held / (elem * x2.numel()))
        ctas, hold = fb.bwd_resources(code, fb._vector_io(c, x2, dy2), int(relu), int(use_res))
        held = fb.bwd_held_bytes(x2.shape[0], c, ctas, hold, elem)
        rec["timing"]["fused_batchnorm_bwd"].update(
            held_on_chip_bytes=held, held_share_of_rows=held / (2 * elem * x2.numel()))
        del lo
    fb.plain_calls.clear()
    log("K5/K6 " + json.dumps(rec))
    if bad:
        raise AssertionError(f"K5/K6 {name}: errors over the tolerance: {bad}")
    return rec


def phase_bn(batch=64, image=224):
    """K5 and K6 against their plain versions: every (R, C, relu,
    residual) class of ResNet-50 at ``batch`` and ``image`` px in bf16 and
    float32 (timed in bf16), and the JAX test's ragged shapes with every
    epilogue.  Returns the records and one step's totals over the 53
    layers."""

    layers, _ = resnet50_layout(batch, image)
    counts = {}
    for cls in layers:
        counts[cls] = counts.get(cls, 0) + 1
    recs, timed = [], {}
    for i, (r, c, relu, use_res) in enumerate(counts):
        hw = int(round(math.sqrt(r // batch)))
        for dtype in (torch.bfloat16, torch.float32):
            rec = bn_case(f"resnet50_r{r}_c{c}{'_relu' if relu else ''}{'_res' if use_res else ''}",
                          (batch, hw, hw, c), relu, use_res, dtype, seed=i,
                          timed=dtype == torch.bfloat16)
            recs.append(rec)
            if "timing" in rec:
                timed[(r, c, relu, use_res)] = rec
        free_device_memory()
    for j, shape in enumerate(BN_RAGGED):
        for relu in (False, True):
            for use_res in (False, True):
                for dtype in (torch.bfloat16, torch.float32):
                    recs.append(bn_case(f"ragged_{'x'.join(map(str, shape))}", shape, relu,
                                        use_res, dtype, seed=100 + j))
    step = {}
    for kname in ("fused_batchnorm_fwd", "fused_batchnorm_bwd"):
        step[kname] = {key: sum(n * timed[cls]["timing"][kname][key]
                                for cls, n in counts.items())
                       for key in ("ms", "bound_ms", "plain_ms", "library_ms")}
        runs = [sum(n * timed[cls]["timing"][kname]["ms_runs"][i] for cls, n in counts.items())
                for i in range(BN_REPEATS)]
        step[kname].update(ms=statistics.median(runs), ms_runs=runs,
                           ms_spread=max(runs) - min(runs))
        step[kname]["share_of_bound"] = step[kname]["bound_ms"] / step[kname]["ms"]
        step[kname]["max_abs_err_bf16"] = max(
            rec["max_abs_err"]["y" if kname.endswith("fwd") else "dx"]
            for rec in timed.values())
    for tag, kname, held in (("K5", "fused_batchnorm_fwd", "x"),
                             ("K6", "fused_batchnorm_bwd", "g and x")):
        log(f"{tag} by class (bf16): [R, C, relu, residual, layers, ms (median of "
            f"{BN_REPEATS}), bound_ms, share of bound, bytes of {held} held on chip] "
            + json.dumps([
                [*cls, n, t["ms"], t["bound_ms"], t["share_of_bound"], t["held_on_chip_bytes"]]
                for cls, n in counts.items() for t in (timed[cls]["timing"][kname],)]))
    log(f"K5/K6 one ResNet-50 step (53 layers, batch 64, 224 px, bf16; ms: the median of "
        f"{BN_REPEATS} repeats, ms_runs each repeat's total, ms_spread their range; "
        "library_ms: F.batch_norm, which has no epilogue on 49 of them) " + json.dumps(step))
    return recs, timed, step


def phase_resnet_train():
    """The ResNet main path: ``resnet_dp --norm fused --model resnet50
    --image-size 224 --batch-per-device 64 --steps 30`` in process.  The
    counts are zeroed just before and read just after: K5 and K6 must
    each launch 53 x (30 + 15) times and no plain version may run."""

    from tf_operator_tpu_torch import resnet_dp
    from tf_operator_tpu_torch.ops import _build
    from tf_operator_tpu_torch.ops import fused_batchnorm as fb

    args = resnet_dp.parse_args([
        "--norm", "fused", "--model", "resnet50", "--image-size", "224",
        "--batch-per-device", "64", "--steps", str(RESNET_STEPS)])
    layers, fwd_flops = resnet50_layout(args.batch_per_device, args.image_size)
    torch.cuda.reset_peak_memory_stats()
    _build.launches.clear()
    fb.plain_calls.clear()
    out = resnet_dp.run(args)
    torch.cuda.synchronize()
    launches, plain = dict(_build.launches), dict(fb.plain_calls)
    losses, bench = out["losses"], out["benchmark"]
    n_norms = len(out["trainer"].model.norms())
    steps = RESNET_STEPS + max(RESNET_STEPS // 2, 5)
    step_s = _steady_step_s(out["resolved_at"])
    flops_step = 3 * fwd_flops * args.batch_per_device
    stats = {
        "model": "resnet50", "norm": "fused", "batch": args.batch_per_device,
        "image": args.image_size, "steps": steps, "norm_layers": n_norms,
        "launches": launches, "plain_calls": plain,
        "loss_first": losses[0], "loss_last5": sum(losses[-5:]) / 5,
        "losses": [round(x, 4) for x in losses],
        "step_ms_train_loop": step_s * 1e3, "step_ms_benchmark": bench["step_ms"],
        "examples_per_s": bench["examples_per_sec"],
        "examples_per_s_train_loop": args.batch_per_device / step_s,
        "fwd_gflop_per_image": fwd_flops / 1e9, "tflop_per_step": flops_step / 1e12,
        "model_tflops": flops_step / (bench["step_ms"] / 1e3) / 1e12,
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    stats["peak_share"] = stats["model_tflops"] * 1e12 / PEAK_OPS[torch.bfloat16]
    log("resnet train " + json.dumps(stats))
    want = len(layers) * steps
    for kname in (fb.KERNEL_FWD, fb.KERNEL_BWD):
        if n_norms != len(layers) or launches.get(kname, 0) != want:
            raise AssertionError(f"{kname} launched {launches.get(kname, 0)} times; "
                                 f"{len(layers)} norms x {steps} steps = {want}")
    if sum(plain.values()):
        raise AssertionError(f"a plain BatchNorm ran on the card during training: {plain}")
    if not stats["loss_last5"] < stats["loss_first"]:
        raise AssertionError(f"the ResNet loss did not fall: {losses}")
    return stats, out["trainer"], out["batch"], args


def phase_resnet_parity(args, batch):
    """One step through K5 / K6 against the same step through their plain
    versions (``plain_kernels=True``): loss, grad norm, running stats."""

    from tf_operator_tpu_torch import resnet_dp
    from tf_operator_tpu_torch.ops import _build
    from tf_operator_tpu_torch.ops import fused_batchnorm as fb

    dev = torch.device("cuda")
    out = {}
    for plain in (False, True):
        trainer = resnet_dp.build_trainer(args, dev, plain_kernels=plain)
        _build.launches.clear()
        fb.plain_calls.clear()
        m = trainer.compute_grads(batch)
        counted = dict(fb.plain_calls) if plain else dict(_build.launches)
        out[plain] = ({k: float(m[k]) for k in ("loss", "grad_norm")},
                      [(bn.mean.clone(), bn.var.clone()) for bn in trainer.model.norms()],
                      counted)
        del trainer, m
        free_device_memory()
    n = len(out[False][1])
    if out[False][2] != {fb.KERNEL_FWD: n, fb.KERNEL_BWD: n} or \
            out[True][2] != {fb.KERNEL_FWD: n, fb.KERNEL_BWD: n}:
        raise AssertionError(f"parity steps did not run what they should: kernels "
                             f"{out[False][2]}, plain {out[True][2]}")
    rec = {}
    for key in ("loss", "grad_norm"):
        a, b = out[False][0][key], out[True][0][key]
        rec[key] = {"kernels": a, "plain": b, "rel": abs(a - b) / abs(b),
                    "tol": RESNET_PARITY_RTOL[key]}
    stats_rel = max(max(_tensor_rel(ka, pa), _tensor_rel(kv, pv))
                    for (ka, kv), (pa, pv) in zip(out[False][1], out[True][1]))
    rec["running_stats"] = {"rel": stats_rel, "tol": RESNET_PARITY_RTOL["running_stats"]}
    log("resnet one-step parity " + json.dumps(rec))
    for key, r in rec.items():
        if not (math.isfinite(r["rel"]) and r["rel"] <= r["tol"]):
            raise AssertionError(f"ResNet one-step parity: {key} off the plain step: {rec}")
    return rec


def phase_resnet_ab(args, batch):
    """The reference's A/B: ``--norm batchnorm`` against ``--norm fused``,
    same init and batch, 3 steps each; step ms (steps 2 and 3, host clock
    around synchronised steps) and the largest relative loss difference."""

    import argparse

    from tf_operator_tpu_torch import resnet_dp

    dev = torch.device("cuda")
    rec = {}
    for norm in ("batchnorm", "fused"):
        trainer = resnet_dp.build_trainer(argparse.Namespace(**dict(vars(args), norm=norm)), dev)
        losses, times = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(trainer.train_step(batch)["loss"]))
            times.append(time.perf_counter() - t0)
        rec[norm] = {"losses": losses, "step_ms": 1e3 * sum(times[1:]) / 2,
                     "first_step_ms": 1e3 * times[0]}
        del trainer
        free_device_memory()
    rec["resnet_fusedbn_loss_max_rel_err"] = max(
        abs(a - b) / max(abs(a), 1e-12)
        for a, b in zip(rec["batchnorm"]["losses"], rec["fused"]["losses"]))
    rec["tol"] = RESNET_AB_RTOL
    log("resnet norm A/B " + json.dumps(rec))
    if not rec["resnet_fusedbn_loss_max_rel_err"] <= RESNET_AB_RTOL:
        raise AssertionError(f"stock and fused ResNet steps disagree: {rec}")
    return rec


#: training steps of the main path (the loss-decrease guard of
#: train_loop needs 20 or more)
TRAIN_STEPS = 30


def _kernel_entry(name, source, replaces, launches, err, timing):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": timing["ms"],
            "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"], "library_ms": timing["library_ms"]}


def main():
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs the port on a GPU", file=sys.stderr)
        return 2
    import shutil
    import tempfile

    from tf_operator_tpu_torch import resolve_device
    from tf_operator_tpu_torch.data.text import TextBatches, as_lm_batches
    from tf_operator_tpu_torch.models.llama import LlamaLM, llama_7b_shape
    from tf_operator_tpu_torch.models.weights import init_params
    from tf_operator_tpu_torch.ops.paged_attention import KERNEL
    from tf_operator_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc: {nvcc}, "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    phase_build()
    k4 = phase_k4()
    flash = phase_flash()
    k7 = phase_k7()
    _, bn_timed, bn_step = phase_bn()
    log(f"kernel phases done at {time.perf_counter() - t0:.1f} s")

    resnet_stats, trainer, batch, resnet_args = phase_resnet_train()
    phase_train_profile(trainer, batch, tag="resnet train step",
                        shares=(("k5", "bn_fwd_"), ("k6", "bn_bwd_")))
    del trainer
    free_device_memory()
    phase_resnet_parity(resnet_args, batch)
    phase_resnet_ab(resnet_args, batch)
    del batch
    free_device_memory()
    log(f"resnet phases done at {time.perf_counter() - t0:.1f} s")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        data_dir, export_dir = os.path.join(tmp, "text"), os.path.join(tmp, "artifact")
        train_stats, trainer, args = phase_train(data_dir, export_dir, TRAIN_STEPS)
        batch = next(iter(as_lm_batches(TextBatches(data_dir, args.batch_per_device, seed=1))))
        phase_serve_artifact(trainer, export_dir)
        phase_train_profile(trainer, batch, shares=(
            ("flash", "flash_"), ("k1", "flash_fwd_"), ("k2", "flash_bwd_dq_"),
            ("k3", "flash_bwd_dkv_")))
        del trainer
        free_device_memory()
        phase_parity(args, batch)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    free_device_memory()
    log(f"training phases done at {time.perf_counter() - t0:.1f} s")

    dev = resolve_device()
    cfg = llama_7b_shape(max_len=2048)
    t_init = time.perf_counter()
    model = LlamaLM.from_state_dict(cfg, init_params(cfg, 0, dev), dev)
    torch.cuda.synchronize()
    log(f"llama_7b_shape bf16 seeded weights on the card in "
        f"{time.perf_counter() - t_init:.1f} s")
    main_stats, pool = phase_main_path(model)
    phase_decode_profile(pool)
    del pool
    phase_end_to_end(model)
    # the pool holds reference cycles (the prefix cache's callbacks), so
    # the bf16 weights and arena go only with a collection
    del model
    free_device_memory()
    log(f"bf16 serving phases done at {time.perf_counter() - t0:.1f} s")

    int8_stats, model = phase_int8_serving(main_stats)
    phase_int8_end_to_end(model)
    del model
    free_device_memory()
    head = k4[0]
    kernels = [_kernel_entry(
        "paged_attention", "tf_operator_tpu_torch/csrc/paged_attention.cu",
        "tf_operator_tpu/ops/paged_attention.py:195", main_stats["launches"].get(KERNEL, 0),
        head["max_abs_err"], dict(head, ms=head["kernel_ms"]))]
    wide = flash[0]
    replaces = {"flash_attention_fwd": "tf_operator_tpu/ops/flash_attention.py:165",
                "flash_attention_bwd_dq": "tf_operator_tpu/ops/flash_attention.py:297",
                "flash_attention_bwd_dkv": "tf_operator_tpu/ops/flash_attention.py:343"}
    errs = {"flash_attention_fwd": "fwd", "flash_attention_bwd_dq": "dq",
            "flash_attention_bwd_dkv": "dkv"}
    for kname in FLASH_KERNELS:
        kernels.insert(-1, _kernel_entry(
            kname, "tf_operator_tpu_torch/csrc/flash_attention.cu", replaces[kname],
            train_stats["launches"].get(kname, 0), wide["max_abs_err"][errs[kname]],
            wide["timing"][kname]))
    step = k7_decode_step(k7)
    kernels.append(_kernel_entry(
        "quant_matmul", "tf_operator_tpu_torch/csrc/quant_matmul.cu",
        "tf_operator_tpu/ops/quant_matmul.py:60", int8_stats["launches"].get("quant_matmul", 0),
        step["max_abs_err"], step))
    line = bn_timed[BN_LINE_CLASS]
    for kname, line_no, err in (("fused_batchnorm_fwd", 166, "y"),
                                ("fused_batchnorm_bwd", 250, "dx")):
        kernels.append(_kernel_entry(
            kname, "tf_operator_tpu_torch/csrc/fused_batchnorm.cu",
            f"tf_operator_tpu/ops/fused_batchnorm.py:{line_no}",
            resnet_stats["launches"].get(kname, 0), line["max_abs_err"][err],
            line["timing"][kname]))
    log("K5/K6 kernels-line class: " + json.dumps(list(BN_LINE_CLASS)) + "; per step "
        + json.dumps(bn_step))
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
