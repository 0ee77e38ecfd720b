"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. identity: the card's name and power limit (nvidia-smi), torch, CUDA
   and nvcc versions.  Without a CUDA device the script exits 2.
2. build: every CUDA source of the port under
   ``tf_operator_tpu_torch/csrc``, one nvcc process each, all started
   together, with ptxas's register report per source.
3. the paged-attention kernel (K4) against its plain PyTorch version on
   the card: 7B decode shapes (S=8, H=Hkv=32, D=128, bs=16, MB=128,
   lengths 1..2048), GQA (Hkv=8), K=1 and K=4, bf16 and float32, plus
   small shapes covering the other block sizes and head dims.  Each case
   holds the kernel to an absolute tolerance and, per output row (one
   seat, query row and head), to a tolerance relative to that row's
   largest value; it prints both errors and the
   kernel's, the plain version's and scaled_dot_product_attention's
   times (the last on the gathered view, a yardstick the port never
   calls) beside the bound: live K/V bytes over 3.35 TB/s.
4. the flash-attention kernels K1 (forward), K2 (dq) and K3 (dk, dv)
   against their plain versions: the wide training shape (B 4, H 16,
   Hkv 8, S 2048, D 128, bf16, causal), non-causal, a window of 256 at
   S 1024, Sq != Sk (causal and not), S = 1000, D 64, MHA and float32.
   Kernel by kernel on the same inputs, per row; and the gradients
   through ``FlashAttention`` against autograd through the plain
   versions.  At the wide shape: each kernel's time (CUDA events, 20
   launches after 3 warm-ups), its bound (the causal products at the
   dense bf16 peak, or its bytes at 3.35 TB/s, whichever is larger),
   the plain version's time and SDPA's forward and backward times.
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
   kernels), and the one-step parity: the first step's loss and grad
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
9. the kernels line (K1, K2, K3 from the training path, K4 from the
   serving path), the card line, and last
   ``{"ok": true, "device": {...}}``.
"""

import json
import math
import os
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


def log(msg):
    print(msg, flush=True)


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


def phase_build():
    """Every source at once (one nvcc each, started together), then
    each library loaded; prints ptxas's report per source."""

    from tf_operator_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"built {sorted(logs)} together in {time.perf_counter() - t0:.1f} s")
    for name in _build.sources():
        _build.load(name)
        report = [ln.strip() for ln in logs.get(name, "").splitlines()
                  if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        log(f"ptxas {name}.cu: " + " | ".join(report))


def k4_case(name, *, s, h, hkv, d, bs, mb, k_new, dtype, max_len, seed):
    from tf_operator_tpu_torch.ops.paged_attention import (
        _gathered_view,
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
    lengths = torch.randint(k_new, max_len + 1, (s,), generator=g, device=dev).to(torch.int32)
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
    ms = time_ms(lambda: paged_attention_multi(*args))
    plain_ms = time_ms(lambda: paged_attention_multi(*args, impl="plain"), iters=5)
    # the library yardstick: SDPA on the gathered contiguous view
    kv_k, kv_v = _gathered_view(ka, tables), _gathered_view(va, tables)
    qend = lengths[:, None].long() - (k_new - 1 - torch.arange(k_new, device=dev))[None]
    mask = (torch.arange(mb * bs, device=dev)[None, None] < qend[:, :, None])[:, None]
    qt = q.transpose(1, 2)
    if hkv != h:
        kv_k = kv_k.repeat_interleave(h // hkv, dim=1)
        kv_v = kv_v.repeat_interleave(h // hkv, dim=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(qt, kv_k, kv_v, attn_mask=mask))
    elem = torch.finfo(dtype).bits // 8
    live = int(lengths.clamp(max=mb * bs).sum())
    n_bytes = (2 * live * hkv * d * elem + 2 * q.numel() * elem
               + tables.numel() * 4 + lengths.numel() * 4)
    visible = sum(max(0, int(lengths[i]) - (k_new - 1 - t))
                  for i in range(s) for t in range(k_new))
    ops = 4 * d * h * visible
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    rec = {
        "case": name, "max_abs_err": err, "tol": TOL[dtype],
        "max_row_rel_err": row_rel, "row_rtol": ROW_RTOL[dtype], "kernel_ms": ms,
        "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "live_kv_bytes": 2 * live * hkv * d * elem,
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


def phase_main_path(model):
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
        log("main path " + json.dumps(stats))
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
        ("noncausal_bf16", dict(small, causal=False)),
        ("window256_s1024_bf16", dict(small, window=256)),
        ("cross_sq512_sk1024_bf16", dict(small, sq=512)),
        ("cross_noncausal_sq1024_sk700_bf16", dict(small, sk=700, causal=False)),
        ("s1000_bf16", dict(small, sq=1000, sk=1000)),
        ("d64_bf16", dict(small, d=64)),
        ("mha_bf16", dict(small, hkv=8)),
        ("f32_causal_gqa", dict(small, sq=512, sk=512, dtype=torch.float32)),
    ]
    return [flash_case(n, seed=i, **kw) for i, (n, kw) in enumerate(cases)]


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
        "--model", "llama-wide", "--seq-len", "2048", "--batch", "4",
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
    tokens = args.batch * args.seq_len
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


def phase_train_profile(trainer, batch):
    """One training step under torch.profiler: the device's busy share
    of the step's wall and the top kernels by device time."""

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
        log("train step profile: the profiler recorded no device time")
        return None
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    flash = sum(e.self_device_time_total for e in events if "flash_" in e.key)
    rec = {"profiled_step_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
           "device_busy_share": busy / wall_us, "flash_share_of_device": flash / busy,
           "top_kernels": [[e.key[:60], round(e.self_device_time_total / busy, 4), e.count]
                           for e in top]}
    log("train step profile " + json.dumps(rec))
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
    want = Trainer(model.variant(plain_attention=True), tcfg, llama_loss).compute_grads(batch)
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
    model = load_model(torch.device("cuda"), max_len=2048,
                       weights=os.path.join(export_dir, "params.npz"),
                       model_json=os.path.join(export_dir, "model.json"))
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
    log(f"kernel phases done at {time.perf_counter() - t0:.1f} s")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        data_dir, export_dir = os.path.join(tmp, "text"), os.path.join(tmp, "artifact")
        train_stats, trainer, args = phase_train(data_dir, export_dir, TRAIN_STEPS)
        batch = next(iter(as_lm_batches(TextBatches(data_dir, args.batch, seed=1))))
        phase_serve_artifact(trainer, export_dir)
        phase_train_profile(trainer, batch)
        del trainer
        torch.cuda.empty_cache()
        phase_parity(args, batch)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
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
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
