"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py
    python3 chip_smoke.py --ab DIR    # phases 4d, 5 and 7: DIR's tree against this one

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
   past it), GQA (Hkv=8), K=1 and K=4, bf16 and float32, the
   speculative verify pass (K=5, MHA, bf16), plus small
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
   192`` in process.  Counts zeroed just before and read just after: K5
   and K6 must each launch 53 x (192 + 96) times (train_loop's steps and
   the benchmark's) and no plain version may run; the loss must fall.
   ``train_loop``'s records (``check_loop_records``): the step-time
   sentinel observed ``train_sync`` once a window (24 windows of 8) and
   froze its drift reference at the 16th, the sync ledger and
   ``train_sync_total{phase}`` counted a ``window`` resolve a window but
   the last and one ``final``, the ``train.<tag>`` heartbeat beat once a
   window; the drift ratio (the p50 of all 24 windows over the first
   16's) is printed.
   Prints step ms, examples/s, model TFLOP/s (8.18 GFLOP an image
   forward, x3 for a step) and their share of the 989 TFLOPS peak, and
   peak memory.  Then one step under torch.profiler (busy share, K5's
   and K6's shares, the largest kernel families); the one-step parity
   of K5 / K6 against their plain versions (loss, grad norm, running
   statistics); and the reference's A/B, ``--norm batchnorm`` against
   ``--norm fused``, 3 steps each (step ms, the largest relative loss
   difference).
5. the training main path: ``llama_pretrain`` at llama-wide (full
   depth, 12 layers), seq 2048 x batch 4, 120 steps on the byte corpus
   generated in a temporary directory.  The counts are zeroed just
   before and read just after: K1, K2 and K3 must each have launched
   12 x 120 times, no plain attention may have run, and the loss must
   fall.  Prints step ms, tokens/s, model TFLOP/s and their share of
   the 989 TFLOPS peak, and peak memory.  ``train_loop``'s records as
   in phase 4d (120 steps, 24 windows of 5).
6. train -> export -> serve: the exported artifact behind the port's
   ``serve_lm`` (K4 at Hkv 8) answers one greedy request with the
   bytes ``generate`` gives on the trained parameters in the process;
   then one training step under torch.profiler (busy share, top
   kernels, and K1's, K2's and K3's shares of device time, each and
   together), and the one-step parity: the first step's loss and grad
   norm through the kernels against the same step with the plain
   attention, same weights and batch.
5b. the operator's multi-process jobs (``phase_multiprocess``, which
   also runs 5c and 5e), each
   rank a process spawned here with the ``TPUJOB_*`` environment written
   here, all on the one card (so gloo: NCCL refuses two ranks on one
   GPU); the kernels are phase 2's builds.  One 2-rank world runs 5b's
   2-rank jobs, 5c's and 5e's 2-rank jobs and 5d's in turn
   (``rank_jobs``: the processes start once), one 4-rank world 5b's
   multislice job and 5e's 4-rank jobs, this process every yardstick;
   then each job's check.  The phase prints the walls of 5b + 5c and of
   5e.  ``phase_multiprocess(card, jobs=...)`` runs some of the jobs
   (``multiprocess_jobs`` names them) through the same worlds and
   checks, as ``chip_fault_probe.py`` does.  (1) 2 ranks:
   ``dist_psum`` on CUDA tensors (the reference's line), then
   ``psum_hierarchical`` over fsdp against the flat all-reduce on card
   tensors (``PSUM_ATOL``) and a 64 MiB sync probe.  (2) llama-wide at
   full width (seq 2048; its depth cut to ``DIST_LAYERS`` of its 12
   layers) through ``llama_pretrain``: one
   process on 8 rows (the yardstick), one process on 4 rows (memory
   only), then 2 ranks over ``{"sp": 1, "fsdp": 2}`` at 4 rows each,
   ``DIST_STEPS`` steps (``phase_llama_fsdp``); each rank's losses against the
   yardstick's (``DIST_LOSS_RTOL``) and its gathered weights against
   the yardstick's leaf by leaf (``DIST_WEIGHT_RTOL``), K1, K2 and K3 =
   layers x steps launches a rank and no plain attention; prints per rank the
   step wall, the collectives' calls, bytes and host seconds by stage,
   the training state it holds between steps (``resident_bytes``) and
   ``max_memory_allocated`` beside the 4-row process's.  (3) ``dist_multislice`` as 2 slices x 2
   hosts (``MEGASCALE_*`` / ``TPU_WORKER_*`` written here), after
   ``psum_hierarchical`` through all three stages on card tensors: the
   reference's line on every rank, and the ``MULTISLICE_LEDGER`` with
   ``dcn_bytes_ratio`` <= 1 / intra + 1e-3.
5c. sequence parallelism (inside phase 5b's jobs): (a)
   (``phase_sp_attention``) 2 ranks of ``ring_attention`` and
   ``ulysses_attention`` at llama-wide's attention shape (global B 4,
   H 16, Hkv 8, S 2048, D 128, bf16, causal), forward and backward,
   against one process's K1 forward and K2 / K3 backward on the whole
   sequence (each rank's chunk, ``FLASH_RTOL`` of the largest value),
   and a windowed ring (``SP_WINDOW``, a boundary hop on rank 1): K1-K3
   launches a rank as the schedule reckons them, the boundary blocks
   counted apart, no plain attention, the bytes each collective moved;
   (b) (``phase_sp_llama``) ``llama_pretrain --sp 2 --sp-impl
   ring|ulysses`` as 2-rank jobs
   at llama-wide width, seq 2048, the global batch of phase 5b's
   yardstick (4 rows a rank of 2 = 8 rows, each rank its half of the
   sequence), ``DIST_STEPS`` steps: each rank's losses against the
   yardstick's (``DIST_LOSS_RTOL``), rank 0's weights against the
   yardstick's leaf by leaf (``DIST_WEIGHT_RTOL``: the gradients' sum
   over sp), K1-K3 launches = layers x steps x (r
   + 1) on rank r of the causal ring and layers x steps under Ulysses, no
   plain attention, no boundary block; prints per rank the step ms,
   the collectives' share of the wall and bytes by stage, and
   ``max_memory_allocated``.
5e. sequence parallelism over the decoder zoo and beside tp / ep
   (``phase_sp_zoo``, inside phase 5b): K1, K2 and K3 at the shapes a
   rank runs (``SP_ZOO_FLASH``: Ulysses' whole sequence at a tp 2 rank's
   3 heads over sp 2, the ring's non-causal hop at 512 of 1,024)
   against their plain versions, timed;
   then gpt_small's widths (``CausalLM``, vocab 256, all 12 layers,
   learned positions for 1,024) and the 8-expert moe at those widths
   (0.48 B, capacity factor ``SP_ZOO_CAPACITY`` 0.5, so routes drop and
   the slots' scan across the sp line decides which), dropout 0,
   ``DIST_STEPS`` ``Trainer`` steps at seq 1024 x 8 of the byte corpus
   (AdamW, the zoo's rate for gpt, ``MP_LR`` for the moe): one process
   each (the yardsticks, here), then in 5b's 2-rank world gpt on the
   ring and on Ulysses and the moe on the ring over ``{"sp": 2}``, and
   in a 4-rank world gpt on Ulysses over ``{"sp": 2, "tp": 2}`` (12
   heads, 6 a tp rank, 3 an sp shard) and the moe on the ring over
   ``{"sp": 2, "ep": 2}`` (4 experts a rank), all at full width and
   depth.  Each rank's losses within ``DIST_LOSS_RTOL`` of its family's
   yardstick and equal on every rank, rank 0's gathered weights within
   ``DIST_WEIGHT_RTOL`` leaf by leaf (the biases skipped:
   ``SP_ZOO_SKIP``), each leaf's step-0 gradient norm within
   ``SP_ZOO_GRAD_RTOL`` of one process's, K1-K3 = 12 x steps x (r + 1)
   on sp rank r of the causal ring and 12 x steps under Ulysses, no
   plain attention; prints per rank the step ms, the collectives by
   stage, the bytes it holds and peak memory.  ``chip_fault_probe.py
   moe_sp_prefix`` must see the moe check refuse the scan without the
   earlier rank's counts.
5d. the model-parallel jobs (``phase_model_parallel``): K1, K2 and K3
   at the shapes a rank runs (``MP_FLASH``: T5-base's and ViT-B/16's
   6 heads of 12 under tp 2, the 8-expert moe's 12 heads under ep 2)
   against their plain versions, timed; then 2 ranks, each running in
   turn (``rank_model_parallel``) ``t5_multihost --model t5_base --tp
   2`` (batch 4, 64 / 32, dropout 0.1, ``MP_T5_STEPS`` steps),
   ``vit_classify --model vit_b16 --tp 2`` (224 px x 32, 1000 classes,
   ``MP_VIT_STEPS`` steps and its benchmark) and the 8-expert moe at
   gpt_small's widths over ``{"ep": 2}`` through the ``Trainer`` (seq
   1024 x 8, ``MP_MOE_STEPS`` steps, dropout 0.1; these two at learning
   rate ``MP_LR``), against the same
   three in this process on the same global batches (``--tp 1``, no
   mesh): each rank's losses within ``DIST_LOSS_RTOL`` of one
   process's, the ranks' ``loss a -> b`` lines and losses identical,
   the parameters each keeps whole bitwise equal across the ranks,
   K1-K3 = layers x the steps run a rank (T5: its cross-attentions,
   and 24 plain biased self-attentions a step), no other plain
   attention; prints per rank the step ms, the parameter bytes it holds
   beside the whole model's, and the collectives' calls, bytes and host
   seconds by stage.
5f. decoding over tp / ep shards and the MNIST jobs (``phase_sharded_decode``
   and ``phase_mnist_jobs`` inside phase 5b's 2-rank world; the moe's
   decode inside 5d's job): (1) llama-wide (``llama_wide``: all 12
   layers, GQA 16 : 8 of 128, vocab 32000, seeded weights) over
   ``{"tp": 2}`` through the ``Trainer``, ``DECODE_STEPS`` AdamW steps
   on 2 x 1024 bytes (K1-K3 = 12 x steps a rank at 8 : 4 heads, no
   plain attention), then ``Trainer.generate`` on the live shards:
   ``DECODE_PROMPTS`` corpus prompts of ``DECODE_PROMPT`` bytes,
   ``DECODE_NEW`` greedy tokens (timed: tokens/s on gloo), held against
   ``models/decode.generate`` from the gathered copy on rank 0: both fed
   the gathered run's tokens step by step, the logits within
   ``DECODE_LOGIT_RTOL`` of each step's largest; the free-running ids
   equal to the gathered run's up to the first position whose gathered
   top-2 margin is below twice that (printed, with where they part);
   both ranks' ids identical; no K1-K3 launch in the decode (it stays on
   the plain attention, as the reference's stays on XLA).  5d's moe at
   ep 2 decodes the same prompt shape after its steps under the same
   checks, but its weights stay near random (5d trains at ``MP_LR``), so
   its gathered top-2 margin is close from the first token on and the
   free-running ids check cannot fail there: the moe's decode is held by
   its forced logits, the ranks' ids and the launches alone.  (2) ``dist_mnist --data-dir`` as 2 ranks on the card:
   process 0 writes the procedural MNIST, process 1 waits for its
   commit record, each trains ``MNIST_DATA_STEPS`` steps on its shard
   through the sharded loader and ``device_prefetch``: exit 0 with the
   loss falling, the two first batches' record ids disjoint.  (3)
   ``mnist_with_summaries`` at its defaults as 2 ranks: exit 0 with the
   reference's line, and ``read_series`` gives each process's records
   at steps 5..40 with ``steps_per_sec`` from the second on.
7. serving at full width: ``llama_7b_shape`` with seeded bf16
   weights, the paged pool (8 slots, max_len 2048, bs 16, 8 steps per
   sync) behind ``serve_lm``'s HTTP server on 127.0.0.1:0; 8 concurrent
   greedy requests (prompts of 64..1500 bytes, two sharing a 512-byte
   prefix) and one seeded temperature request, 32 new tokens each.  The
   kernel counts are zeroed just before and read just after: K4 must
   have launched 32 layers x the decode steps run.  The records, read
   over HTTP while the server runs (``check_records``): every reply's
   ``request_id`` echoed in ``x-trace-id``; each ``/requests/<id>``
   done with 32 tokens and step dispatches = windows, exactly one with a
   prefix hit of >= 512 tokens; each ``/traces/<id>`` holding the six
   lifecycle spans, ``dispatch.admission`` under ``admission``;
   ``/metrics`` with 9 requests ok, 9 TTFT observations over the tiers
   and the step dispatches of the pool's ledger; ``/slo``,
   ``/debug/arena``, ``/alerts`` parse, and ``/debug/flightrecorder``'s
   ndjson names every request.
   The cost plane (``check_costplane``), once the traffic has finished:
   ``/debug/memory``'s ``weights`` = ``state_bytes`` of the model and
   ``kv_arena`` = the arena's bytes, to the byte, the limit =
   ``mem_get_info``'s total, coverage (the resident components over the
   allocator's live bytes) >= 0.95, and the bytes left unaccounted;
   ``/debug/compiles`` holds K4's library load and its variant classes,
   each with its first-launch wall; ``/metrics`` carries every JAX
   cost-plane family but ``serve_pool_compiles``, and
   ``step_time_p50_seconds{signal="decode.window"}`` is within 10 % of
   the median window wall of the pool's ``decode.window`` spans.  Then
   the nine requests again (``phase_debug_pass``): no new compile event;
   ``/debug/profile?seconds=2`` during the traffic, started, stopped and
   exported on its request's thread, writes a trace of the CUDA activity
   naming K4's kernel (and K7's for the int8 model); the windows it
   covered against the pass's others, and the capture's start,
   recording, stop and export walls, are printed; the profiler's stop
   and the export hold the interpreter lock, so the window they overlap
   stalls, and it must stay within twice the longest window outside
   the capture plus the stop and export walls (``_profile_windows``);
   a second request meanwhile gets 409 and one once the pool is
   idle 503; a watchdog heartbeat with a 0.5 s deadline that never beats
   counts one ``watchdog_stall_total`` and dumps one postmortem whose
   stacks name the driver thread.
   Then one decode window of the same pool runs under torch.profiler:
   the device's busy share of the window and each kernel's share.
7c. what the records cost on the host: phase 7's nine requests, in this
   process, through a bare pool (no ledger, no metrics) and through the
   pool ``serve_lm.make_pool`` builds, in the order bare, plane, plane,
   bare (two runs a side).  Each run: decode tokens/s, the median window ms
   (the ledger's step seconds: up to the window's fetch) and the median
   bookkeeping µs a window (``step()``'s wall less that, over windows
   that admitted nothing); K4 = 32 x the decode steps.  Then each
   side's median and spread (max - min), and whether the sides differ
   by more than the spread, beside the card line.  The records (the cost
   plane included) must add under 1 ms of bookkeeping a window (the
   plane side's median less the bare side's).
7b. serving under arena pressure at full width: the same model behind
   ``serve_lm``'s server, the pool at 8 slots, max_len 2048, bs 16, 8
   steps per sync, in its default ``reserve="lazy"``.  Eight batch
   requests (prompts of 390..410 bytes, none a multiple of 16, so each
   straddle block is private; 80 new tokens; one seeded temperature
   request with top_k 40) at once, and after two windows one
   interactive request (700 bytes, 32 new tokens).  The arena is the
   eight batch commits (``_commit_blocks``) plus 24 blocks, below the
   sum of their worst cases.  Three runs, counts zeroed just before
   and read just after each: K4 must have launched 32 layers x the
   decode steps, every request must answer, the allocator must conserve
   and the swap arena end empty.  (1) an unpressured pool at the
   default arena: the reference tokens; (2) the pressured lazy pool:
   at least one preemption, every victim batch, swap bytes out = in >
   0, every request's token row identical to (1)'s, greedy and seeded;
   (3) ``reserve="worst-case"`` at the same arena: identical tokens,
   and fewer seats at once than lazy's eight.  Prints each run's peak
   seats, preemptions (each victim's tier, blocks swapped to the host
   and left live), demotions, decode tokens/s, TTFT by tier and peak
   memory; each swap copy's device ms (CUDA events), blocks, bytes and
   GB/s, beside a plain pinned-host copy of the largest swap's bytes
   each way as the link's yardstick; all beside the card line.  Each
   run's records as in phase 7, and (``check_pressure_records``)
   ``serve_preemptions_total{tier="batch"}`` = the preemptions with no
   interactive series, ``kv_swap_bytes_total`` out = in = the swap
   log's bytes, the autopsies' preemptions and swapped blocks = the
   run's own preempt and demotion logs, the timeline's ``swapped``
   series back to 0 (above 0 when a seat was preempted), both tiers on
   ``/slo``.
7d. speculative serving at full width (run after phase 8): the same bf16 model as the
   target and phase 9's int8 model (loaded here, while the bf16 one is
   resident) as its self-draft, behind ``serve_lm``'s server built from
   its flags (``--batching 8 --speculative --speculative-force --spec-k
   4``, phase 7's arena), against the same server without
   ``--speculative``, in the order plain, spec, spec (two speculative
   runs, whose seeded rows must agree, and one plain).  Phase 7's nine requests, six ``tier: interactive`` (the 64-,
   200- and 1500-byte prompts, both of the shared-prefix pair and the
   seeded request), three batch, which decode plainly in the same
   windows.  Counts zeroed just before and read just after each run.  On
   every speculative run: ``serving_dispatch_total{phase="draft"}`` =
   verify windows + the six interactive admissions,
   ``{phase="verify"}`` = ``spec_windows``; each interactive autopsy
   counts one ``draft`` and each batch one none; K4 launches = 32 x ((4
   + 1) x draft windows + verify windows + plain steps); K7 launches =
   225 x (4 + 1) x draft windows + 225 x the draft prefills of <= 64
   rows, the GEMM route 225 x the longer ones; no plain int8 matmul;
   the pool's K4 + K7 launches of draft and verify = their count; the
   cost plane as in phase 7 with the draft's weights and arena twin in
   ``weights`` and ``kv_arena``, and K7's routes on ``/debug/compiles``;
   ``/metrics`` shows both spec gauges and the three
   ``serve_spec_*_total`` families at the pool's counts, and records as
   in phase 7.  Across runs: every greedy token row equals the plain
   run's, or at its first divergent position the two tokens are the
   target's top two and their logit gap is within the difference
   between a replay of the step pass (k_new 1) and of the verify pass
   (k_new 5) at that position (both replays on the plain contiguous
   path; printed); the seeded request gives the same tokens in each
   speculative run, each within its top_k support of the replayed
   logits up to ``SPEC_SUPPORT_TOL``.  Then one speculative window of
   eight interactive seats under torch.profiler (busy share, K4 and K7
   shares of device time).  Prints, each side's median and
   spread of its runs beside the card line: the interactive requests'
   decode tokens/s (median of tokens after the first over the time
   after the first) and TTFT, all requests' decode tokens/s over the
   decode dispatches' wall, the window's host wall; the speculative
   side's acceptance rate, dispatches a token and launches a token; the
   speedup (interactive decode tokens/s, speculative over plain), and
   the ``spec record`` line that ``tf_operator_tpu_torch/
   spec_measured.json`` (``serve_lm``'s guard) is written from.
8. end to end: on ``llama_tiny`` (float32) the pool's greedy tokens
   through the kernel equal the plain contiguous ``generate`` on the
   card; at 7B width the first decode step's logits through the kernel
   are within a bf16 tolerance, and share their argmax, with the same
   paged step under the plain attention on the same arena (only the
   attention differs) and with the contiguous (plain) path.
9. int8 serving at full width: ``serve_lm.load_model(..., quantize=
   "int8")`` (what ``--quantize int8`` runs) quantizes the same seeded
   float32 weights as they are made (before phase 7d, which drafts with
   it), and the same pool and requests as
   phase 7 run behind the HTTP server.  Counts zeroed just before and
   read just after: K7 must have launched 225 (7 projections x 32
   layers + the head) x (decode steps + prefills of <= 64 rows), the
   GEMM route 225 x the longer prefills, K4 32 x the decode steps, and
   no plain version may have run.  The records and the cost plane as in
   phase 7 (K7's routes on ``/debug/compiles``), with its second pass.  Prints
   the weight bytes bf16 -> int8, decode tokens/s and TTFT beside phase
   7's, peak memory and one profiled decode window (busy share, K7's
   share of device time).
10. int8 end to end: ``llama_tiny`` (float32, int8 kernels) pool tokens
   through K7 equal the contiguous ``generate`` with the plain int8
   matmul; at 7B width the first paged decode step through K7 is within
   a stated bound of the same step with the plain int8 matmul (K4 in
   both), with the same argmax.
11. the JAX server's default mode (run after phase 7d, bf16): the same
   7B model behind ``serve_lm`` built from its flags with no
   ``--batching`` and ``--prompt-cache 4`` (the chunked decoder, max_len
   2048), over HTTP: phase 7's nine bodies one at a time, then three new
   ones (100, 300 and 600 bytes, the last seeded) at once on their own
   threads, then those three again one at a time, each of
   ``SHORT_NEW_TOKENS`` (12) new tokens.  Counts zeroed just
   before and read just after.  Checks: every answer 200 with the JAX
   server's keys; the repeats' rows equal their first rows exactly;
   ``serve_prompt_cache_hits`` = 3 =
   ``serve_prefix_cache_hits_total{mode="chunked"}``;
   ``serving_dispatch_total{phase="prefill"}`` = the binary chunks of
   the 12 prompts that missed, ``{phase="decode"}`` = the 15 requests;
   15 TTFT observations under ``mode="chunked"``; no kernel launched
   (the contiguous decode branch reaches none in bf16); each greedy row
   equals the first 12 tokens of phase 7's paged row for the same body,
   or its first
   divergence is a tie of the two paths (``_path_divergence``: the
   logits that chose that token computed again on each path as it ran,
   the chunked decoder's binary-chunk prefill and decode steps, and the
   paged admission's one-shot prefill past its prefix hit and K4 steps
   at 8 seats; each replay must choose its path's served token, the
   margin between the two tokens on each replay must be within what the
   two paths move those two logits, and the replays' difference within
   phase 8's bound).  Prints each
   request's HTTP latency (the JAX definition of its TTFT), the
   sequential prefill and decode seconds, decode tokens/s (11 tokens a
   request over the decode dispatches' wall) and peak memory.
9b. (run after phase 9) phase 11 on the int8 model: K7 = 225 x (11
   steps a request + the prefill chunks of <= 64 rows), the GEMM route
   225 x the wider chunks, no K4 and no plain int8 matmul; greedy rows
   against phase 9's paged rows; decode tokens/s beside phase 11's.
12. the contiguous slot pool (after phase 11): the same seeded bf16
   weights under ``llama_7b_shape(max_len=2048, window=1024)``, built
   with ``LlamaLM.from_state_dict`` over the same storage (a
   ``variant(window=...)`` is a shallow copy whose attention layers
   keep their own config; both are checked), behind ``serve_lm`` built
   from ``--batching 8``, which must print the JAX server's ``paged pool
   unavailable (...); serving the contiguous slot pool`` line.  Phase
   7's nine bodies at once, ``SHORT_NEW_TOKENS`` (12) new tokens each;
   the 1,500-byte prompt prefills in chunks
   capped at 1,024 and its cache wraps.  Checks: the records
   (``check_records`` with the staged path's spans); dispatches
   ``prefill`` = the capped chunks, ``sample`` = ``scatter`` = 9,
   ``admission`` = 0; no kernel launched; peak seats = the 8 slots
   (the nine bodies are sent at once; polled every 2 ms); ``/debug/memory``'s ``kv_arena`` = the slot stack, 8 x 32
   layers x 2 x 32 heads x 1,024 x 128 x 2 B = 4 GiB, and ``weights`` =
   ``state_bytes``; each greedy row equals the chunked decoder's row on
   the same windowed model, or its first divergence is a bf16 tie.
   Prints decode tokens/s, window ms, TTFT and peak memory, then one
   steady window of eight seats under torch.profiler (as phase 7's).
13. multi-replica and disaggregated serving (after phase 12), the bf16
   7B model, 8 slots, block 16, phase 7's nine bodies at once, each part
   collected after its run:
   13a (``phase_fleet``): ``serve_lm --batching 8 --replicas 2`` in
   process.  Checks: every request ok, its trace one ``route`` span
   naming replica 0 or 1; ``kv_blocks_free`` for both replicas on
   ``/metrics``; ``/slo`` one merged TTFT row of 9; ``/debug/memory``'s
   weights = ``state_bytes`` (once) and ``kv_arena`` = 2 x the arena, to
   the byte; K4 = 32 x the decode steps (the shared ledger's, = both
   replicas' windows x 8); both arena timelines, ``/debug/fabric`` 404;
   the records as phase 7's; each greedy row equal to phase 7's or its
   first divergence a tie (``_pair_divergence`` on the two paths' paged
   replays with each body's prefix hit); the seeded body's row equals
   phase 7's (the same path: no prefix hit, M = 8 steps).
   13b (``phase_disaggregated``): ``--roles prefill=1,decode=2``.
   Checks: the prefill replica ran no window (so no K4 launch: K4 = 32 x
   the decode replicas' steps); each body's autopsy names replica 0 for
   the prefill and its decode replica, holds one ``migrate_in`` with
   ``migrated_blocks`` = its ``migrate`` span's blocks, and a prefix hit
   of every full block before its last token; its trace has both route
   spans; ``kv_migrate_bytes_total{direction="out"}`` = the fabric's
   publishes x 8,388,608 and ``{direction="in"}`` = the migrated blocks x
   8,388,608; 9 TTFT observations, none under ``role="prefill"``; no
   publish failure; the greedy rows equal 13a's or tie (the disaggregated
   replay takes its prefix from a one-shot prefill of the whole prompt,
   as the prefill replica published it); the seeded body repeats.
   Prints each replica's windows and decode tokens/s, each request's
   publish wall and TTFT, each ``migrate_out`` / ``migrate_in`` copy's ms
   and GB/s, and the fabric's host bytes.
   13c (``phase_fleet_http``): two ``python -m
   tf_operator_tpu_torch.serve_lm --model llama-7b --batching 8
   --kv-blocks 256`` processes on the card: A with ``--fabric-port P
   --fabric-peers ''``, B with ``--fabric-peers 127.0.0.1:P``.  Phase 7's
   first three bodies (and the fifth) go to A, then the three to B.
   Checks: B's samples equal A's; each of B's autopsies holds one
   ``migrate_in`` and no ``prefill``; B's pulled blocks = its
   ``/debug/fabric`` hits, and ``kv_migrate_bytes_total{transport="http"}``
   and the bytes pulled = them x 8,388,608; then A stops and B gets the
   fifth body: answered (by recompute) with
   ``kv_fabric_pull_failures_total{reason="peer_dead"}`` >= 1.  Prints the
   pods' boot wall, latencies, A's fabric host bytes and a port client's
   HTTP pull ms a block from A.
14. the encoder workloads (``phase_encoders``, run after phase 6's
   parity and before phase 5b): (a) K1, K2 and K3 at the three
   encoders' attention shapes, bf16, D 64, non-causal (``ENCODER_FLASH``:
   BERT-base [32, 12, 128, 64], ViT-B/16 [32, 12, 196, 64], T5-base's
   cross-attention q [4, 12, 32, 64] against k, v [4, 12, 64, 64]) against
   their plain versions at ``FLASH_RTOL``, each kernel's time (CUDA
   events, 20 launches after 3 warm-ups), its bound (bytes or products,
   whichever is larger), the plain version's and SDPA's forward and
   backward times; (b) ``bert_pretrain`` at bert_base, seq 128 x batch
   32, (c) ``t5_multihost`` at t5_base (the entry's defaults: batch 4,
   encoder 64, decoder 32), (d) ``vit_classify`` at vit_b16, 224 px x
   batch 32, 1000 classes, each through its entry's ``run`` for
   ``ENCODER_STEPS`` steps at dropout 0.1 and its entry's optimizer.
   Counts zeroed just before and read just after each: K1, K2 and K3
   must each launch 12 x the steps run (ViT's benchmark steps included),
   the plain attention must not run, except T5's 24 biased
   self-attentions a forward, and the loss must fall.  Prints step ms,
   examples/s, model TFLOP/s (``encoder_flops_per_example``) and their
   share of the 989 TFLOPS peak, and peak memory; then each family's
   one-step parity at dropout 0, kernels against the plain attention on
   the same weights and batch: loss and grad norm at ``PARITY_RTOL`` x
   sqrt(8,188 / the targets its loss averages), phase 6's tolerances
   scaled from llama's 8,188 targets to BERT's labelled positions, T5's
   128 targets and ViT's 32 images; beside them the same step in float32
   (what bf16 itself moves) and the plain forward with P rounded to bf16
   as K1 rounds it.
15. the decoder zoo (``phase_zoo``, after phase 14): (a) K1, K2 and K3
   causal at gpt_small's training shape [8, 12, 1024, 64] and at
   moe_tiny's [8, 4, 128, 32] (``ZOO_FLASH``), and K7 at M 8 on gpt's
   int8 projections (768 x 768, 768 x 3072, 3072 x 768), each against
   its plain version at its phase 4 / 4b tolerance, timed beside its
   bound and SDPA or the bf16 ``torch.matmul``; (b) gpt_small's widths
   at vocab 256 (``CausalLM``, 12 layers, learned positions for 1,024),
   ``ZOO_GPT_STEPS`` ``Trainer`` steps at seq 1024 x batch 8 on the byte
   corpus (dropout 0.1), ``export_params``, then the artifact behind
   ``serve_lm`` (phase 7's bodies that fit 1,024 positions): chunked
   bf16 (no kernel launched, its first row equal to ``generate`` on the
   trained weights), ``--batching 8`` (the fallback line naming
   ``CausalLM``, the contiguous pool, one admission a request, rows
   against the chunked rows, equal or a bf16 tie) and ``--quantize
   int8`` chunked (K7 = 72 x (31 decode steps a request + prefill chunks
   of <= 64 rows), the GEMM route 72 x the wider chunks, rows against
   the same decoder with K7's plain version); (c) ``llama_pretrain
   --family moe`` at the reference entry's defaults (moe_tiny, 4
   experts, seq 128 x batch 8, 60 steps, export ``family: moe``, a
   sample), then as a 2-rank job (``rank_moe``: dp 2, ep 1, gloo on the
   card, dropout 0) whose losses must equal one process's on both
   ranks' rows within ``DIST_LOSS_RTOL``; (d) ``MoeLM`` with 8 experts
   at gpt_small's widths (~0.48 B parameters) for ``ZOO_MOE_STEPS``
   steps at seq 1024 x batch 8, exported (``{"family": "moe", "moe":
   ...}``) and served by ``serve_lm --batching 8`` (the contiguous pool)
   against the chunked decoder's rows.  K1-K3 must launch layers x
   steps in each training run and never in serving; no plain attention
   and no plain int8 product runs; every loss must fall.  Prints each
   family's step ms, tokens/s and peak memory.
16. LoRA fine-tuning and pipeline parallelism (``phase_lora_pipeline``,
   after phase 6, on phase 5's export): K1, K2 and K3 causal at the LoRA
   step's shape [8, 16 (Hkv 8), 128, 128] and a pipeline microbatch's at
   gpt_small's widths [2, 12, 1024, 64] (``PHASE16_FLASH``), against
   their plain versions, timed beside their bounds and SDPA; (a)
   ``lora_finetune`` over the llama-wide export (``LORA_STEPS`` steps,
   rank 8, batch 8 x seq 128): 9,205,760 adapter parameters over a
   frozen 697,354,240, step 0's logits bit for bit the base's, the loss
   falling, a digest of every base tensor unchanged, K1-K3 = 12 x steps
   each (``generate`` launches none: the contiguous cache's plain
   product), then the merged export behind ``serve_lm --batching 8``
   (three greedy requests of 16 tokens, the paged pool, K4 = 12 x decode
   steps), each row equal to ``generate`` on the merged model or first
   off it at a bf16 tie; (b) ``PipelinedLM`` at gpt_small's widths
   (vocab 256, 12 layers, relu) as 2 ranks over ``{"pp": 2}`` (gloo on
   the card; 6 layers a stage), seq 1024 x 8 in 4 microbatches,
   ``PP_STEPS`` steps of optax.adamw's form, against one process
   training the same weights through the sequential
   ``lm_reference_apply``: every loss within ``DIST_LOSS_RTOL``, both
   ranks' equal, each leaf a rank holds (the replicated embedding, norm
   and positions, and its stage's layers as that slice of the one
   process's stack) against the one process's, its step-0 gradient
   within ``PP_GRAD_RTOL`` and its weight after the steps within
   ``PP_WEIGHT_RTOL`` (the gradients, because AdamW's update hides a
   gradient's scale: ``chip_fault_probe.py pp_input pp_output``; the
   leaves ``PP_ZERO_GRAD`` says are skipped), a
   rank's stage bytes half the stack's, K1-K3 = 6 layers
   x 4 microbatches a step on each rank (bubble ticks run nothing) and
   12 a step in the one process; (c) ``gpt_pipeline --pp 2`` at its
   defaults for ``--family gpt``, then ``--family llama``, run by (b)'s
   two ranks after it (one world, so the processes start once),
   ``PIPE_JOB_STEPS`` steps: the reference's tag line equal on both
   ranks, the loss falling, K1-K3 = 2 x 4 a step.
17. the kernels line (K1, K2, K3 from the training paths: llama's, the
   three encoders', the zoo's, phase 5d's 2-rank jobs, phase 16's
   (both ranks'), phase 5e's (every rank's) and phase 5f's tp 2 steps
   (both ranks'), each counted around its
   own run, with the counts by path, and phase 16's and 5e's shapes; K4 from the serving path, K7 from the int8
   serving paths, 7B's pool and gpt_small's chunked decoder, by path;
   K5 and K6 from the ResNet path, at the [200704, 256] no-ReLU,
   no-residual class, where F.batch_norm computes the same function),
   the card line, and last ``{"ok": true, "device": {...}}``.

``--ab DIR`` (``ab_main``): phases 4d, 5 and 7 of the tree unpacked at
DIR (an earlier commit's ``git archive``, under the gitignored
``build/``) and of this tree, each by its own ``chip_smoke.py`` in a
process of its own, in the order parent, change, change, parent; each
side's median and spread of the ResNet and llama step ms and phase 7's
decode tokens/s, beside the card line.  The run logs go to
``build/ab/``.
"""

import collections
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
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

    from tf_operator_tpu_torch.utils.costplane import default_costplane

    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"built {sorted(logs)} together in {time.perf_counter() - t0:.1f} s; nvcc walls "
        + json.dumps({e["program"]: e["first_call_seconds"]
                      for e in default_costplane.compiles.snapshot()["events"]
                      if e["trigger"] == "nvcc"}))
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
        # the speculative verify pass: spec_k + 1 = 5 query rows a head
        ("7b_mha_k5_bf16", dict(mha, k_new=5, dtype=torch.bfloat16)),
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
    """(status, answer, seconds, x-trace-id header) of one /generate."""

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        method="POST",
    )
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as resp:
        out = json.loads(resp.read())
        return (resp.status, out, time.perf_counter() - t0,
                resp.headers.get("x-trace-id"))


def _get(port, path):
    """(status, body bytes) of one GET."""

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=120) as resp:
        return resp.status, resp.read()


def _get_json(port, path):
    status, body = _get(port, path)
    if status != 200:
        raise AssertionError(f"GET {path}: {status}")
    return json.loads(body)


def _get_status(port, path, timeout=300):
    """(status, parsed JSON body) of one GET, error statuses included."""

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def _metric(text, name, **labels):
    """The value of one series of a Prometheus exposition (0 if absent)."""

    want = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    head = f"{name}{{{want}}} " if want else f"{name} "
    for line in text.splitlines():
        if line.startswith(head):
            return float(line[len(head):])
    return 0.0


def _metric_sum(text, name):
    """The sum of every series of one family in an exposition."""

    return sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
               if line.startswith(name + "{") or line.startswith(name + " "))


def record_rows(pool):
    """The token rows a pool hands out, by its request id (the HTTP
    sample is bytes decoded as ASCII, which folds every byte >= 128 into
    one character): a dict filled as ``result_wait`` returns rows."""

    rows, result_wait = {}, pool.result_wait

    def recording_wait(rid, timeout=None):
        row = result_wait(rid, timeout)
        if row is not None:
            rows[rid] = row
        return row

    pool.result_wait = recording_wait
    return rows


def decode_steps(pool):
    """Decode steps a pool ran: its ledger's windows x steps a window."""

    return pool.ledger.count("step") * pool.steps_per_sync


#: the lifecycle spans every served request's trace holds
REQUEST_SPANS = ("serve.generate", "queue.wait", "admission", "dispatch.admission",
                 "decode.window", "retire")


#: the lifecycle spans of a request that the contiguous pool seats on
#: its staged path (prefilled on the submitter's thread, then scattered)
STAGED_SPANS = ("serve.generate", "queue.wait", "admission", "dispatch.prefill",
                "dispatch.sample", "dispatch.scatter", "decode.window", "retire")


def check_records(port, pool, results, tag, spans=REQUEST_SPANS):
    """The serving plane's records of one phase, read over HTTP while
    the server runs: each reply's ``request_id`` (echoed in x-trace-id),
    its autopsy and its trace (holding ``spans``, the seating dispatch
    under ``admission``); /metrics against the pool's own counts; /slo,
    /debug/arena, /alerts and /debug/flightrecorder parse.  Returns the
    autopsies in request order and the exposition."""

    autopsies = []
    for i, r in enumerate(results):
        rid = r[1].get("request_id")
        if not rid or r[3] != rid:
            raise AssertionError(f"{tag}: request {i} id {rid!r}, x-trace-id {r[3]!r}")
        a = _get_json(port, f"/requests/{rid}")
        if a["state"] != "done" or a["dispatches"].get("step") != a["windows"]:
            raise AssertionError(f"{tag}: autopsy of request {i}: {a}")
        trace = _get_json(port, f"/traces/{rid}")
        by_id = {s["spanId"]: s for s in trace["spans"]}
        names = {s["name"] for s in by_id.values()}
        if not set(spans) <= names:
            raise AssertionError(f"{tag}: trace of request {i} lacks "
                                 f"{set(spans) - names}")
        for s in by_id.values():
            if s["name"] in ("dispatch.admission", "dispatch.scatter") and \
                    by_id.get(s["parentId"], {}).get("name") != "admission":
                raise AssertionError(f"{tag}: {s['name']} outside admission: {s}")
        autopsies.append(a)
    status, raw = _get(port, "/metrics")
    text = raw.decode()
    n = len(results)
    ok = _metric(text, "serve_requests_total", status="200")
    ttft = _metric_sum(text, "serve_ttft_seconds_count")
    steps = _metric(text, "serving_dispatch_total", phase="step")
    if not (status == 200 and ok == n and ttft == n and steps == pool.ledger.count("step")):
        raise AssertionError(f"{tag}: /metrics requests_ok {ok}, ttft counts {ttft} of {n}, "
                             f"step dispatches {steps} vs {pool.ledger.count('step')}")
    slo = _get_json(port, "/slo")
    arena = _get_json(port, "/debug/arena")
    alerts = _get_json(port, "/alerts")
    status, raw = _get(port, "/debug/flightrecorder")
    dump = [json.loads(line) for line in raw.decode().splitlines()]
    named = {r["id"] for r in dump if r["type"] == "request"}
    if status != 200 or dump[0]["type"] != "meta" or \
            not {a["id"] for a in autopsies} <= named:
        raise AssertionError(f"{tag}: the flight recorder's dump names {sorted(named)}")
    log(f"{tag} records: " + json.dumps({
        "requests_ok": ok, "ttft_count": ttft, "step_dispatches": steps,
        "slo_ttft": slo["histograms"]["serve_ttft_seconds"],
        "arena_samples": [len(r["samples"]) for r in arena["replicas"]],
        "alerts_firing": alerts["firing"], "flight_records": len(dump)}))
    return autopsies, text, slo


#: the JAX cost plane's families on /metrics (all but the JAX server's
#: serve_pool_compiles line); the drift ratio appears once the sentinel
#: has frozen its reference (16 windows)
COSTPLANE_FAMILIES = ("compile_total", "compile_seconds", "hbm_component_bytes",
                      "hbm_device_limit_bytes", "hbm_headroom_bytes",
                      "step_time_p50_seconds", "step_time_p99_seconds")
#: the sentinel's p50 against the median of the pool's window walls
SENTINEL_RTOL = 0.10
#: the windows after which the step-time sentinel freezes its drift
#: reference (``StepTimeSentinel``'s warmup); a drift ratio read at
#: exactly this many windows is 1 by construction
SENTINEL_WARMUP = 16
#: the resident components' share of the allocator's live bytes
MIN_COVERAGE = 0.95


def _arena_bytes(arena):
    return sum(k.nbytes + v.nbytes for k, v in arena)


def _window_walls(pool):
    """The pool's decode-window walls from its ``decode.window`` spans
    (one span a seat, one wall a window), by the window's start."""

    walls = {}
    for summary in pool.tracer.store.summaries(1000):
        for span in pool.tracer.store.trace(summary["traceId"])["spans"]:
            if span["name"] == "decode.window":
                walls[span["startMono"]] = span["duration"]
    return walls


def _strays(pool, models):
    """What holds device memory that no component accounts: the other
    pools alive before a collection and after it, and the largest device
    tensors outside the models and the pool's arenas."""

    import warnings

    from tf_operator_tpu_torch.models.batching import PagedContinuousBatchingDecoder
    from tf_operator_tpu_torch.utils.costplane import _leaves

    def live(kind):
        with warnings.catch_warnings():  # isinstance on deprecated module attributes
            warnings.simplefilter("ignore")
            return [o for o in gc.get_objects() if isinstance(o, kind)]

    before = sum(1 for p in live(PagedContinuousBatchingDecoder) if p is not pool)
    gc.collect()
    after = sum(1 for p in live(PagedContinuousBatchingDecoder) if p is not pool)
    known = {t.untyped_storage().data_ptr() for t in _leaves(
        [models, pool._arena, pool._draft_arena]) if isinstance(t, torch.Tensor)}
    strays = {t.untyped_storage().data_ptr(): t for t in live(torch.Tensor)
              if t.is_cuda and t.untyped_storage().data_ptr() not in known}
    big = sorted(strays.values(), key=lambda t: -t.untyped_storage().nbytes())[:6]
    return {"other_pools_before_a_collection": before, "other_pools_after": after,
            "largest_stray_tensors": [[list(t.shape), str(t.dtype),
                                       t.untyped_storage().nbytes()] for t in big]}


def check_costplane(port, pool, models, text, tag):
    """The cost plane over HTTP once the phase's traffic has finished (a
    window has ended): ``/debug/memory``'s weights = ``state_bytes`` of
    ``models`` and kv_arena = the pool's arena (and its draft twin's) to
    the byte, the limit = ``mem_get_info``'s total, coverage >=
    ``MIN_COVERAGE``; ``/debug/compiles`` holds K4's library load and its
    variant classes (K7's routes for an int8 model), each with its first
    wall; ``/metrics`` (``text``) carries every cost-plane family, and the
    sentinel's decode.window p50 agrees with the median window wall."""

    from tf_operator_tpu_torch.ops.quant import state_bytes

    mem = _get_json(port, "/debug/memory")
    rows = [d for d in mem["devices"] if d["device"].startswith("cuda")]
    if len(rows) != 1:
        raise AssertionError(f"{tag}: /debug/memory devices {mem['devices']}")
    row = rows[0]
    comps = row["components"]
    want = {"weights": sum(state_bytes(m.state_dict()) for m in models),
            "kv_arena": _arena_bytes(pool._arena) + (
                _arena_bytes(pool._draft_arena) if pool._draft_arena is not None else 0),
            "limit": torch.cuda.mem_get_info()[1]}
    resident = row["accounted_bytes"] - comps["program_tmp"]
    rec = {"components": comps, "accounted_bytes": row["accounted_bytes"],
           "backend_bytes": row["backend_bytes"], "coverage": row["coverage"],
           "unaccounted_bytes": row["backend_bytes"] - resident,
           "limit_bytes": row["limit_bytes"], "headroom_bytes": row["headroom_bytes"],
           "expected": want}
    if row["coverage"] < MIN_COVERAGE:
        rec["strays"] = _strays(pool, models)
    if (comps["weights"] != want["weights"] or comps["kv_arena"] != want["kv_arena"]
            or row["limit_bytes"] != want["limit"] or row["coverage"] < MIN_COVERAGE):
        raise AssertionError(f"{tag}: /debug/memory {json.dumps(rec, default=str)}")
    compiles = _get_json(port, "/debug/compiles")
    by = compiles["byProgram"]
    k4 = by.get("ops.paged_attention", {}).get("byTrigger", {})
    ring = {(e["program"], e["trigger"]): e["first_call_seconds"] for e in compiles["events"]}
    need = [("csrc/paged_attention.cu", "load")] + [("ops.paged_attention", t) for t in k4]
    if any(k.endswith("kernel_q") for m in models for k in m.state_dict()):
        k7 = by.get("ops.quant_matmul", {}).get("byTrigger", {})
        if not k7:
            raise AssertionError(f"{tag}: no K7 class on /debug/compiles: {by}")
        need += [("csrc/quant_matmul.cu", "load")] + [("ops.quant_matmul", t) for t in k7]
    if not any(t.startswith("k_new=1,") for t in k4) or any(
            ring.get(k, 0.0) <= 0.0 for k in need):
        raise AssertionError(f"{tag}: /debug/compiles lacks {need} with a wall: "
                             f"{json.dumps(compiles['events'])}")
    rec["compiles"] = {"total": compiles["total"],
                       "first_call_seconds": {f"{p} {t}": ring[(p, t)] for p, t in need}}
    names = {line.split("{")[0].split(" ")[0] for line in text.splitlines()
             if not line.startswith("#")}
    missing = [f for f in COSTPLANE_FAMILIES
               if f not in names and f + "_count" not in names]
    walls = list(_window_walls(pool).values())
    p50 = _metric(text, "step_time_p50_seconds", signal="decode.window")
    median = statistics.median_low(walls)
    rec.update(windows=len(walls), sentinel_p50_s=p50, median_window_s=median)
    if missing or abs(p50 - median) > SENTINEL_RTOL * median:
        raise AssertionError(f"{tag}: /metrics lacks {missing}, or the sentinel's p50 "
                             f"{p50} is off the median window {median}")
    log(f"{tag} cost plane ({card_line()}) " + json.dumps(rec))
    return rec


#: the kernel names a /debug/profile trace of a decode window must hold
#: (the capture records the CUDA activity alone): K4's, and K7's for an
#: int8 model
PROFILE_KERNELS = {"k4": "paged_attention_split_kernel", "k7": "quant_matmul_bf16_kernel"}


#: the slack, as a share of the longest window outside a capture, of the
#: stall bound below: one more window, for what else holds the
#: interpreter lock in the pass (the watchdog's postmortem, admissions,
#: the switch interval); a loop held for the recording too (2 s) still
#: breaks it
PROFILE_STALL_SLACK = 1.0


def _profile_windows(windows, capture):
    """Decode windows ({start: wall}) of a pass against a capture's
    stages (``ProfileCapture.last``: starting, recording, stopping,
    exporting): the walls, in ms, of the windows that overlap each stage
    and of those outside the capture, each stage's wall, and whether the
    windows the recording covers stay inside the spread of those
    outside.  On a card the profiler's stop and the trace's export hold
    the interpreter lock, so the window they overlap stalls; its bound:
    no longer than the longest window outside the capture, plus the stop
    and the export, plus ``PROFILE_STALL_SLACK`` of that window.  A loop
    held for the recording too, or longer than the lock is held, breaks
    it (``stall_within_bound``)."""

    def overlapping(lo, hi):
        return [w for t, w in windows.items() if t < hi and t + w > lo]

    stages = ("starting", "recording", "stopping", "exporting")
    rec = {stage: [round(w * 1e3, 1) for w in overlapping(*capture[stage])]
           for stage in stages}
    lo, hi = capture["starting"][0], capture["exporting"][1]
    rec["outside"] = sorted(round(w * 1e3, 1) for t, w in windows.items()
                            if not (t < hi and t + w > lo))
    rec.update({k: capture[k] for k in ("start_s", "record_s", "stop_s", "export_s")})
    if rec["recording"] and rec["outside"]:
        rec["recording_inside_spread"] = max(rec["recording"]) <= max(rec["outside"])
    held = rec["stopping"] + rec["exporting"]
    if held and rec["outside"]:
        longest = max(rec["outside"])
        rec["stall_ms"] = max(held) - statistics.median(rec["outside"])
        rec["stall_bound_ms"] = round(longest * (1 + PROFILE_STALL_SLACK)
                                      + (capture["stop_s"] + capture["export_s"]) * 1e3, 1)
        rec["stall_within_bound"] = max(held) <= rec["stall_bound_ms"]
        rec["under_twice_longest_outside"] = max(held) < 2 * longest
    return rec


def phase_debug_pass(server, bodies, tag):
    """The same requests again through the warm server, with the
    operator's tools on it: the compile ledger gains no event; a
    ``/debug/profile?seconds=2`` taken during the traffic, started,
    stopped and exported on its request's thread, writes a trace that
    names K4's kernel (and K7's for an int8 model), while a second
    request meanwhile gets 409 and one once the pool is idle 503; the
    windows the capture covered against the pass's others, and the
    capture's start, recording, stop and export walls, with the stalled
    window held to its bound (``_profile_windows``); a watchdog with a
    0.5 s heartbeat that never beats counts one ``watchdog_stall_total``
    and dumps one postmortem whose stacks name the driver thread
    (``serve.pool``)."""

    from tf_operator_tpu_torch.utils import flight
    from tf_operator_tpu_torch.utils.costplane import default_costplane
    from tf_operator_tpu_torch.utils.watchdog import Watchdog

    pool, port = server.pool, server.port
    compiles0 = default_costplane.compiles.total()
    starts0 = set(_window_walls(pool))
    dog = Watchdog(metrics=pool.metrics, recorder=flight.default_recorder,
                   check_interval=0.1)
    dog.register("chip_smoke.stopped", deadline=0.5)
    dog.start()
    results = [None] * len(bodies)
    answers = {}

    def send(i):
        results[i] = _post(port, bodies[i])

    def profile():
        answers["first"] = _get_status(port, "/debug/profile?seconds=2")

    try:
        threads = [threading.Thread(target=send, args=(i,)) for i in range(len(bodies))]
        for t in threads:
            t.start()
        t_end = time.perf_counter() + 60
        while pool.in_flight() == 0 and time.perf_counter() < t_end:
            time.sleep(0.001)
        prof = threading.Thread(target=profile)
        prof.start()
        t_end = time.perf_counter() + 60
        while not server.profiler.busy.locked() and time.perf_counter() < t_end:
            time.sleep(0.001)
        answers["concurrent"] = _get_status(port, "/debug/profile?seconds=2")
        for t in threads + [prof]:
            t.join(timeout=900)
        answers["idle"] = _get_status(port, "/debug/profile?seconds=2")
    finally:
        dog.stop()
    if any(r is None or r[0] != 200 for r in results) or server.fatal:
        raise AssertionError(f"{tag} second pass: {results} {server.fatal}")
    code, body = answers["first"]
    if code != 200 or answers["concurrent"][0] != 409 or answers["idle"][0] != 503:
        raise AssertionError(f"{tag}: /debug/profile answered {answers}")
    art = body["artifact"]
    with open(os.path.join(art, "trace.json")) as f:
        trace = f.read()
    files = sorted(os.listdir(art))
    int8 = any(k.endswith("kernel_q") for k in pool.dmodel.state_dict())
    named = {k: v in trace for k, v in PROFILE_KERNELS.items() if k == "k4" or int8}
    shutil.rmtree(art, ignore_errors=True)
    stalls = pool.metrics.counter("watchdog_stall_total", heartbeat="chip_smoke.stopped")
    stacks = ""
    if len(dog.dumps) == 1:
        with open(dog.dumps[0]) as f:
            for line in f:
                r = json.loads(line)
                if r["type"] == "log" and "thread stacks" in r["message"]:
                    stacks = r["fields"]["stacks"]
        os.remove(dog.dumps[0])
    second = {t: w for t, w in sorted(_window_walls(pool).items()) if t not in starts0}
    rec = {"new_compile_events": default_costplane.compiles.total() - compiles0,
           "windows_ms": [round(w * 1e3, 1) for w in second.values()],
           "profile": {"files": files, "trace_bytes": len(trace), "names": named,
                       "aten_ops_in_trace": '"aten::' in trace,
                       "events": trace.count('"ph"'), "mb": len(trace) / 1e6,
                       "trace_only": "trace_only" in (
                           torch._C._profiler._ExperimentalConfig.__init__.__doc__ or ""),
                       "artifact_prefix_ok": os.path.basename(art).startswith(
                           f"serve-profile-c{body['costplane']['compiles_at_start']}-"),
                       "wall_seconds": body["wall_seconds"],
                       "windows": _profile_windows(second, server.profiler.last)},
           "stalls": stalls, "dumps": len(dog.dumps),
           "postmortem_names_driver": "--- thread serve.pool " in stacks}
    log(f"{tag} debug pass ({card_line()}) " + json.dumps(rec))
    if rec["new_compile_events"] or files != ["COSTPLANE.json", "trace.json"] or \
            not all(named.values()) or not rec["profile"]["artifact_prefix_ok"] or \
            rec["profile"]["windows"].get("stall_within_bound") is False or \
            stalls != 1 or rec["dumps"] != 1 or not rec["postmortem_names_driver"]:
        raise AssertionError(f"{tag}: debug pass {json.dumps(rec)}")
    return rec


def _main_bodies():
    """Phase 7's nine requests."""

    bodies = [{"prompt": p, "max_new_tokens": 32} for p in _prompts(0)]
    bodies.append({"prompt": "seeded temperature request: ", "max_new_tokens": 32,
                   "temperature": 0.8, "top_k": 40, "seed": 1234})
    return bodies


def phase_main_path(model, tag="main path"):
    from tf_operator_tpu_torch.ops import _build
    from tf_operator_tpu_torch.serve_lm import Server, make_pool

    n_layers = model.cfg.n_layers
    pool = make_pool(model, model_label="llama-7b", slots=8, steps_per_sync=8,
                     kv_block_size=16)
    rows = record_rows(pool)
    server = Server(pool).start()
    try:
        bodies = _main_bodies()
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
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        if server.fatal:
            raise AssertionError(f"decode loop died: {server.fatal[0]}")
        for i, r in enumerate(results):
            if r is None or r[0] != 200 or len(r[1]["sample"]) != 32:
                raise AssertionError(f"request {i} failed: {r}")
        steps = decode_steps(pool)
        k4 = launches.get("paged_attention", 0)
        if k4 != n_layers * steps or steps == 0:
            raise AssertionError(
                f"K4 launched {k4} times; {n_layers} layers x {steps} decode steps "
                f"= {n_layers * steps}")
        autopsies, text, _ = check_records(server.port, pool, results, tag)
        if any(a["tokens"] != 32 for a in autopsies):
            raise AssertionError(f"{tag}: autopsy tokens {[a['tokens'] for a in autopsies]}")
        hits = [a for a in autopsies if a["admission"]["prefix_hit_tokens"] >= 512]
        if len(hits) != 1:
            raise AssertionError(f"expected one 512-token prefix hit, got {autopsies}")
        decode_tokens = sum(a["tokens"] - 1 for a in autopsies)
        stats = {
            "requests": len(results), "wall_s": wall, "decode_steps": steps,
            "k4_launches": k4, "launches": launches,
            "dispatches": {p: r["count"] for p, r in pool.ledger.snapshot().items()},
            "decode_tokens": decode_tokens,
            "decode_tokens_per_s": decode_tokens / pool.ledger.seconds("step"),
            "decode_window_s": pool.ledger.seconds("step"),
            "ttft_s": {a["rid"]: a["ttft_seconds"] for a in autopsies},
            "prompt_tokens": {a["rid"]: a["prompt_tokens"] for a in autopsies},
            "prefill_rows": [a["prompt_tokens"] - a["admission"]["prefix_hit_tokens"]
                             for a in autopsies],
            "http_latency_s": [round(r[2], 3) for r in results],
            "prefix_hit_rid": hits[0]["rid"],
            "max_memory_allocated_gib": peak_gib,
        }
        log(f"{tag} " + json.dumps(stats))
        # the token rows in body order (phase 11 holds the chunked
        # decoder's to them)
        stats["rows"] = [rows[a["rid"]][a["prompt_tokens"]:].tolist() for a in autopsies]
        stats["prefix_hits"] = [a["admission"]["prefix_hit_tokens"] for a in autopsies]
        # the cost plane, then the same requests again: read after the
        # first pass's numbers, which the second pass would change
        stats["costplane"] = check_costplane(server.port, pool, [model], text, tag)
        stats["costplane"].update(phase_debug_pass(server, bodies, tag))
        log(f"seeded sample: {results[-1][1]['sample']!r}")
        return stats, pool
    finally:
        server.close()


# -- phases 11 and 12: the chunked decoder and the contiguous slot pool -------

#: the chunked server's prompt cache (``--prompt-cache``)
CHUNKED_PROMPT_CACHE = 4
#: new tokens a request in phases 11, 9b and 12 (phase 7's bodies and
#: phase 11's new ones, cut from 32 to keep the script inside its time;
#: their greedy rows are held against the first as many of the paged
#: pool's)
SHORT_NEW_TOKENS = 12
#: phase 11's three new bodies, sent at once and then repeated: greedy,
#: greedy and seeded (their prompts are not among phase 7's)
CHUNKED_NEW_LENGTHS = (100, 300, 600)


def _short_bodies():
    """Phase 7's nine bodies at ``SHORT_NEW_TOKENS`` new tokens each."""

    return [dict(b, max_new_tokens=SHORT_NEW_TOKENS) for b in _main_bodies()]


def _chunked_new_bodies():
    import random

    rng = random.Random(11)
    bodies = [{"prompt": "".join(chr(rng.randrange(32, 127)) for _ in range(n)),
               "max_new_tokens": SHORT_NEW_TOKENS} for n in CHUNKED_NEW_LENGTHS]
    bodies[-1].update(temperature=0.8, top_k=40, seed=99)
    return bodies


def _chunked_server(model):
    """``serve_lm`` built from its flags with no ``--batching`` (the
    chunked decoder) and ``--prompt-cache 4`` at max_len 2048, and the
    token rows it hands out by prompt bytes, in order."""

    from tf_operator_tpu_torch.models.decode import ChunkedServingDecoder
    from tf_operator_tpu_torch.serve_lm import Server, build_decoder, build_parser

    args = build_parser().parse_args(["--model", "llama-7b", "--max-len", "2048",
                                      "--prompt-cache", str(CHUNKED_PROMPT_CACHE)])
    decoder = build_decoder(model, args)
    if not isinstance(decoder, ChunkedServingDecoder):
        raise AssertionError(f"serve_lm's default mode built {type(decoder).__name__}")
    rows = collections.defaultdict(list)
    generate = decoder.generate

    def recording(prompt_ids, n, **kw):
        out = generate(prompt_ids, n, **kw)
        p = prompt_ids.shape[1]
        rows[bytes(prompt_ids[0].tolist())].append(out[0, p:].tolist())
        return out

    decoder.generate = recording
    return Server(decoder, model_label="llama-7b").start(), rows


def _send_each(port, bodies):
    """The answers to the bodies sent one at a time."""

    results = []
    for b in bodies:
        results.append(_post(port, b))
    return results


def _send_at_once(port, bodies):
    """The answers to the bodies sent at once, each on its own thread."""

    results = [None] * len(bodies)

    def send(i):
        results[i] = _post(port, bodies[i])

    threads = [threading.Thread(target=send, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    return results


def _chunk_counts(bodies, max_chunk=None):
    """The chunked prefill's dispatches of each body's prompt (its binary
    chunks, capped at ``max_chunk``) and how many chunks are <= 64 rows
    (K7's) or wider (the GEMM route's)."""

    from tf_operator_tpu_torch.models.decode import window_chunks
    from tf_operator_tpu_torch.ops.quant_matmul import MAX_GEMV_ROWS

    widths = [w for b in bodies for w in window_chunks(len(b["prompt"].encode()), max_chunk)]
    return {"chunks": len(widths), "short": sum(1 for w in widths if w <= MAX_GEMV_ROWS),
            "long": sum(1 for w in widths if w > MAX_GEMV_ROWS)}


def _check_ok(results, tag, n_new=32):
    for i, r in enumerate(results):
        if r is None or r[0] != 200 or len(r[1]["sample"]) != n_new \
                or set(r[1]) != {"prompt", "sample", "seed"}:
            raise AssertionError(f"{tag}: request {i} failed: {r}")


def _greedy_against(model, bodies, got_rows, want_rows, tag, prefix_hits=None):
    """Each greedy body's row against another path's: equal, or its first
    divergence a bf16 tie: as ``_spec_divergence`` rules for two rows of
    one attention path, or, given the paged rows' ``prefix_hits``, as
    ``_path_divergence`` rules for a chunked decoder's row against a
    paged pool's.  Returns the records of the divergent rows."""

    divergent = []
    for i, b in enumerate(bodies):
        if b.get("temperature"):
            continue
        got, want = got_rows[i], want_rows[i]
        if got == want:
            continue
        prompt = np.frombuffer(b["prompt"].encode(), np.uint8).astype(np.int64)
        if prefix_hits is None:
            d = _spec_divergence(model, prompt, got, want)
        else:
            d = _path_divergence(model, prompt, got, want, prefix_hits[i])
        d["body"] = i
        divergent.append(d)
        if not d["tie"]:
            raise AssertionError(f"{tag}: body {i} left the other path's row at a non-tie: {d}")
    return divergent


def phase_chunked(model, card, paged, tag="chunked"):
    """Phase 11 (and, on the int8 model, phase 9b): ``serve_lm``'s default
    mode at 7B width over HTTP.  Phase 7's nine bodies one at a time, then
    three new ones at once, then those three again, ``SHORT_NEW_TOKENS``
    each.  Counts zeroed just before and read just after.  Checks (module
    docstring), the greedy rows against the first as many of ``paged``'s,
    phase 7's (or 9's) stats: its rows and prefix hits; returns the run's
    numbers."""

    from tf_operator_tpu_torch.ops import _build
    from tf_operator_tpu_torch.ops import quant_matmul as qm

    int8 = any(k.endswith("kernel_q") for k in model.state_dict())
    server, rows = _chunked_server(model)
    decoder = server.decoder
    try:
        bodies, new = _short_bodies(), _chunked_new_bodies()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.launches.clear()
        qm.plain_calls.clear()
        t0 = time.perf_counter()
        seq = _send_each(server.port, bodies)
        seq_decode_s = decoder.ledger.seconds("decode")
        seq_prefill_s = decoder.ledger.seconds("prefill")
        at_once = _send_at_once(server.port, new)
        repeats = _send_each(server.port, new)
        wall = time.perf_counter() - t0
        launches, plain = dict(_build.launches), dict(qm.plain_calls)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        for part, results in (("sequential", seq), ("at once", at_once),
                              ("repeats", repeats)):
            _check_ok(results, f"{tag} {part}", SHORT_NEW_TOKENS)
        _, raw = _get(server.port, "/metrics")
        text = raw.decode()
    finally:
        server.close()
    n_req = len(bodies) + 2 * len(new)
    counts = _chunk_counts(bodies + new)
    # a request's first token comes from its prefill's logits
    steps = n_req * (SHORT_NEW_TOKENS - 1)
    n_proj = 7 * model.cfg.n_layers + 1
    want = {"prompt_cache_hits": 3.0, "prefix_cache_hits_chunked": 3.0,
            "prefill_dispatches": float(counts["chunks"]), "decode_dispatches": float(n_req),
            "ttft_observations": float(n_req),
            "k7": n_proj * (steps + counts["short"]) if int8 else 0,
            "gemm": n_proj * counts["long"] if int8 else 0, "k4": 0, "plain_int8": 0,
            "other_launches": 0}
    got = {"prompt_cache_hits": _metric(text, "serve_prompt_cache_hits"),
           "prefix_cache_hits_chunked": _metric(text, "serve_prefix_cache_hits_total",
                                                mode="chunked"),
           "prefill_dispatches": _metric(text, "serving_dispatch_total", phase="prefill"),
           "decode_dispatches": _metric(text, "serving_dispatch_total", phase="decode"),
           "ttft_observations": _metric(text, "serve_ttft_seconds_count", mode="chunked",
                                        model="llama-7b"),
           "k7": launches.get(qm.KERNEL, 0), "gemm": launches.get(qm.GEMM, 0),
           "k4": launches.get("paged_attention", 0), "plain_int8": sum(plain.values()),
           "other_launches": sum(n for k, n in launches.items()
                                 if k not in (qm.KERNEL, qm.GEMM, "paged_attention"))}
    order = [rows[b["prompt"].encode()] for b in new]
    repeat_equal = all(len(r) == 2 and r[0] == r[1] for r in order)
    seq_rows = [rows[b["prompt"].encode()][0] for b in bodies]
    decode_tokens = (SHORT_NEW_TOKENS - 1) * len(bodies)
    stats = {
        "tag": tag, "int8": int8, "requests": n_req, "wall_s": wall,
        "expected": want, "counted": got, "launches": launches,
        "repeats_equal_first_rows": repeat_equal,
        "ttft_s": [round(r[2], 4) for r in seq],
        "sequential_prefill_s": seq_prefill_s, "sequential_decode_s": seq_decode_s,
        "decode_tokens_per_s": decode_tokens / seq_decode_s,
        "max_memory_allocated_gib": peak_gib,
    }
    stats["against_paged_pool"] = _greedy_against(
        model, bodies, seq_rows, [r[:SHORT_NEW_TOKENS] for r in paged["rows"]], tag,
        prefix_hits=paged["prefix_hits"])
    log(f"{tag} ({card}) " + json.dumps(stats))
    if got != want or not repeat_equal:
        raise AssertionError(f"{tag}: counts or repeats off: {json.dumps(stats)}")
    stats["rows"] = seq_rows
    return stats


#: phase 12's rolling window (the contiguous pool serves it at 8 slots)
WINDOW_7B = 1024


def phase_contiguous(model, card):
    """Phase 12: the contiguous slot pool at 7B width with a rolling
    window of 1024, the bf16 weights shared with ``model``, behind
    ``serve_lm`` built from ``--batching 8`` (module docstring)."""

    import contextlib
    import io

    from tf_operator_tpu_torch.models.batching import ContinuousBatchingDecoder
    from tf_operator_tpu_torch.models.decode import ChunkedServingDecoder
    from tf_operator_tpu_torch.models.llama import LlamaLM, llama_7b_shape
    from tf_operator_tpu_torch.ops import _build
    from tf_operator_tpu_torch.ops.quant import state_bytes
    from tf_operator_tpu_torch.serve_lm import Server, build_decoder, build_parser

    dev = model.device
    cfg = llama_7b_shape(max_len=2048, window=WINDOW_7B)
    # a variant() is a shallow copy whose attention layers keep their own
    # config, so it would not take the window: the model is rebuilt
    # around the same storage instead
    shallow = model.variant(window=WINDOW_7B)
    wmodel = LlamaLM.from_state_dict(cfg, model.state_dict(), dev)
    shared = all(a.data_ptr() == b.data_ptr() for a, b in zip(
        model.state_dict().values(), wmodel.state_dict().values()))
    layer_window = {"variant": shallow.layers[0].self_attn.cfg.window,
                    "rebuilt": wmodel.layers[0].self_attn.cfg.window}
    if layer_window != {"variant": None, "rebuilt": WINDOW_7B} or not shared:
        raise AssertionError(f"contiguous: the windowed model {layer_window}, shared {shared}")
    bodies = _short_bodies()
    # the reference rows: the chunked decoder on the same windowed model
    ref = ChunkedServingDecoder(wmodel)
    t_ref = time.perf_counter()
    ref_rows = []
    for b in bodies:
        ids = torch.as_tensor(np.frombuffer(b["prompt"].encode(), np.uint8).astype(np.int64))
        gen = None
        if b.get("temperature"):
            gen = torch.Generator(device=dev).manual_seed(b["seed"])
        out = ref.generate(ids[None], SHORT_NEW_TOKENS, temperature=b.get("temperature", 0.0),
                           top_k=b.get("top_k"), generator=gen)
        ref_rows.append(out[0, ids.numel():].tolist())
    ref_s = time.perf_counter() - t_ref
    del ref
    args = build_parser().parse_args(["--model", "llama-7b", "--max-len", "2048",
                                      "--batching", "8"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        pool = build_decoder(wmodel, args)
    line = out.getvalue().strip()
    if type(pool) is not ContinuousBatchingDecoder or not line.startswith(
            "paged pool unavailable (") or "serving the contiguous slot pool" not in line:
        raise AssertionError(f"contiguous: serve_lm built {type(pool).__name__}: {line!r}")
    rows = record_rows(pool)
    server = Server(pool).start()
    peak = [0]
    polling = threading.Event()

    def poll():
        while not polling.is_set():
            peak[0] = max(peak[0], len(pool._active))
            time.sleep(0.002)

    poller = threading.Thread(target=poll, daemon=True)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.launches.clear()
        poller.start()
        t0 = time.perf_counter()
        results = _send_at_once(server.port, bodies)
        wall = time.perf_counter() - t0
        polling.set()
        launches = dict(_build.launches)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        if server.fatal:
            raise AssertionError(f"contiguous: decode loop died: {server.fatal[0]}")
        for i, r in enumerate(results):
            if r is None or r[0] != 200 or len(r[1]["sample"]) != SHORT_NEW_TOKENS:
                raise AssertionError(f"contiguous: request {i} failed: {r}")
        autopsies, text, _ = check_records(server.port, pool, results, "contiguous",
                                           spans=STAGED_SPANS)
        mem = _get_json(server.port, "/debug/memory")
    finally:
        polling.set()
        server.close()
    pool_rows = [rows[a["rid"]][a["prompt_tokens"]:].tolist() for a in autopsies]
    counts = _chunk_counts(bodies, WINDOW_7B)
    want = {"prefill": counts["chunks"], "sample": len(bodies), "scatter": len(bodies),
            "admission": 0}
    dispatches = {p: pool.ledger.count(p) for p in want}
    (row,) = [d for d in mem["devices"] if d["device"].startswith("cuda")]
    slot_bytes = 8 * cfg.n_layers * 2 * cfg.kv_heads * WINDOW_7B * cfg.head_dim * 2
    memory = {"kv_arena": row["components"]["kv_arena"], "expected_kv_arena": slot_bytes,
              "weights": row["components"]["weights"],
              "expected_weights": state_bytes(wmodel.state_dict()),
              "coverage": row["coverage"]}
    decode_tokens = sum(a["tokens"] - 1 for a in autopsies)
    stats = {
        "window": WINDOW_7B, "slots": pool.slots, "fallback_line": line, "wall_s": wall,
        "dispatches": dispatches, "expected_dispatches": want, "launches": launches,
        "peak_seats": peak[0], "memory": memory, "reference_rows_s": ref_s,
        "decode_tokens_per_s": decode_tokens / pool.ledger.seconds("step"),
        "window_ms": pool.ledger.seconds("step") / pool.ledger.count("step") * 1e3,
        "ttft_s": {a["rid"]: a["ttft_seconds"] for a in autopsies},
        "max_memory_allocated_gib": peak_gib,
        "against_chunked": _greedy_against(wmodel, bodies, pool_rows, ref_rows, "contiguous"),
        "seeded_equal": pool_rows[-1] == ref_rows[-1],
    }
    log(f"contiguous pool ({card}) " + json.dumps(stats))
    # where a steady window goes, its prefills done
    stats["profile"] = phase_decode_profile(pool)
    if (dispatches != want or launches or peak[0] != pool.slots
            or memory["kv_arena"] != slot_bytes
            or memory["weights"] != memory["expected_weights"]
            or any(a["tokens"] != SHORT_NEW_TOKENS for a in autopsies)):
        raise AssertionError(f"contiguous: {json.dumps(stats)}")
    del pool, wmodel
    return stats


# -- phase 13: multi-replica and disaggregated serving -----------------------

#: phase 13c's pods: each ``serve_lm`` process's model flags, and the
#: model's KV geometry (layers, KV heads, head dim; block 16, bf16)
POD_MODEL_FLAGS = ["--model", "llama-7b", "--init-seed", "0", "--max-len", "2048"]
POD_KV = (32, 32, 128)
#: a 7B bf16 KV block: 32 layers x (K, V) x 16 tokens x 32 heads x 128 x 2 B
BLOCK_BYTES_7B = POD_KV[0] * 2 * 16 * POD_KV[1] * POD_KV[2] * 2


def _fleet_server(model, flags):
    """``serve_lm`` built from its flags at 7B width (max_len 2048, 8
    slots, block 16) plus ``flags``, in this process, and each replica's
    token rows by its pool-local request id."""

    from tf_operator_tpu_torch.models.pool_router import PoolRouter
    from tf_operator_tpu_torch.serve_lm import Server, build_decoder, build_parser

    args = build_parser().parse_args(["--model", "llama-7b", "--max-len", "2048",
                                      "--batching", "8"] + flags)
    router = build_decoder(model, args)
    if not isinstance(router, PoolRouter):
        raise AssertionError(f"serve_lm {flags} built {type(router).__name__}")
    rows = {p.replica_label: record_rows(p) for p in router.pools}
    return Server(router).start(), router, rows


def _replica_windows(traces):
    """Each replica's decode-window walls ({replica: {start: wall}}) from
    the ``decode.window`` spans of ``traces`` (one span a seat, one wall
    a window)."""

    out = collections.defaultdict(dict)
    for trace in traces:
        for span in trace["spans"]:
            if span["name"] == "decode.window":
                out[span["attributes"]["replica"]][span["startMono"]] = span["duration"]
    return out


def _fleet_run(model, flags, tag):
    """Phase 7's nine bodies at once through ``_fleet_server``, counts
    zeroed just before and read just after: (results, autopsies in body
    order, each body's token row, /metrics text, /slo, the records'
    traces, the router, the counts, the wall, the other reads).  The
    counts: the launches, the decode steps (the shared ledger's) and each
    replica's windows.  Then the seeded body once more."""

    from tf_operator_tpu_torch.ops import _build

    server, router, rows = _fleet_server(model, flags)
    try:
        bodies = _main_bodies()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.launches.clear()
        t0 = time.perf_counter()
        results = _send_at_once(server.port, bodies)
        wall = time.perf_counter() - t0
        counts = {"launches": dict(_build.launches),
                  "decode_steps": decode_steps(router.pools[0]),
                  "windows": {p.replica_label: p.windows for p in router.pools}}
        if server.fatal:
            raise AssertionError(f"{tag}: a decode loop died: {server.fatal[0]}")
        for i, r in enumerate(results):
            if r is None or r[0] != 200 or len(r[1]["sample"]) != 32:
                raise AssertionError(f"{tag}: request {i} failed: {r}")
        autopsies, text, slo = check_records(server.port, router.pools[0], results, tag)
        traces = [_get_json(server.port, f"/traces/{r[1]['request_id']}") for r in results]
        memory = _get_json(server.port, "/debug/memory")
        arena = _get_json(server.port, "/debug/arena")
        fabric = _get_status(server.port, "/debug/fabric")
        extra = {"memory": memory, "arena": arena, "fabric": fabric,
                 "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        if any(b.get("temperature") for b in bodies):
            # the seeded body again: the same tokens through the same path
            extra["seeded_repeat"] = _post(server.port, bodies[-1])
    finally:
        server.close()
    body_rows = [rows[a["replica"]][a["rid"]][a["prompt_tokens"]:].tolist() for a in autopsies]
    return (results, autopsies, body_rows, text, slo, traces, router, counts, wall, extra)


def _window_stats(router, autopsies, traces, counts):
    """Each replica's decode windows, their median wall and its decode
    tokens/s (tokens after the first of the requests it decoded over its
    windows' wall)."""

    walls = _replica_windows(traces)
    out = {}
    for p in router.pools:
        w = list(walls.get(p.replica_label, {}).values())
        tokens = sum(a["tokens"] - 1 for a in autopsies if a["replica"] == p.replica_label)
        out[p.replica_label] = {
            "role": p.role, "windows": counts["windows"][p.replica_label],
            "median_window_ms": statistics.median(w) * 1e3 if w else None,
            "decode_tokens": tokens, "decode_tokens_per_s": tokens / sum(w) if w else None}
    return out


def _judge_rows(model, bodies, got_rows, want_rows, replays, names, tag):
    """Each greedy body's row against another path's: equal, or its first
    divergence a tie of the two paths (``_pair_divergence``, with the
    body's replays ``replays(i)``).  Returns the divergent rows' records."""

    divergent = []
    for i, b in enumerate(bodies):
        if b.get("temperature") or got_rows[i] == want_rows[i]:
            continue
        prompt = np.frombuffer(b["prompt"].encode(), np.uint8).astype(np.int64)
        d = _pair_divergence(model, prompt, got_rows[i], want_rows[i], replays(i), names)
        d["body"] = i
        divergent.append(d)
        if not d["tie"]:
            raise AssertionError(f"{tag}: body {i} left the other path's row at a non-tie: {d}")
    return divergent


def phase_fleet(model, card, paged):
    """Phase 13a: ``serve_lm --batching 8 --replicas 2`` at 7B width
    (module docstring); ``paged`` is phase 7's stats (rows, prefix
    hits)."""

    from tf_operator_tpu_torch.ops.quant import state_bytes

    tag = "fleet"
    bodies = _main_bodies()
    (results, autopsies, rows, text, slo, traces, router, counts, wall,
     extra) = _fleet_run(model, ["--replicas", "2"], tag)
    launches, steps = counts["launches"], counts["decode_steps"]
    replica_steps = sum(counts["windows"].values()) * router.pools[0].steps_per_sync
    routed = [[s["attributes"] for s in t["spans"] if s["name"] == "route"] for t in traces]
    labels = [f'kv_blocks_free{{model="llama-7b",replica="{r}",role="unified"}}'
              for r in ("0", "1")]
    ttft_rows = slo["histograms"]["serve_ttft_seconds"]
    (row,) = [d for d in extra["memory"]["devices"]
              if d["device"].startswith(model.device.type)]
    memory = {"weights": row["components"]["weights"],
              "expected_weights": state_bytes(model.state_dict()),
              "kv_arena": row["components"]["kv_arena"],
              "expected_kv_arena": 2 * _arena_bytes(router.pools[0]._arena),
              "coverage": row["coverage"]}
    hits = [a["admission"]["prefix_hit_tokens"] for a in autopsies]
    stats = {
        "wall_s": wall, "launches": launches, "decode_steps": steps,
        "replica_steps": replica_steps,
        "replicas": _window_stats(router, autopsies, traces, counts),
        "routes": [[r["replica"] for r in rs] for rs in routed], "prefix_hits": hits,
        "ttft_s": [a["ttft_seconds"] for a in autopsies], "memory": memory,
        "slo_ttft_rows": ttft_rows, "peak_gib": extra["peak_gib"],
        "seeded_equal_phase_7": rows[-1] == paged["rows"][-1],
        # a repeat may map the first one's prompt block (a prefix hit the
        # first had not), so only 13b, where both take the same path,
        # holds it
        "seeded_repeat_equal": extra["seeded_repeat"][1]["sample"] == results[-1][1]["sample"],
    }
    stats["against_phase_7"] = _judge_rows(
        model, bodies, rows, paged["rows"],
        lambda i: (lambda m, p, r, j: _paged_replay_logits(m, p, r, j, hits[i]),
                   lambda m, p, r, j: _paged_replay_logits(m, p, r, j, paged["prefix_hits"][i])),
        ("fleet", "paged"), tag)
    log(f"fleet ({card}) " + json.dumps(stats))
    k4 = launches.get("paged_attention", 0)
    bad = []
    if k4 != model.cfg.n_layers * steps or steps != replica_steps or steps == 0:
        bad.append(f"K4 {k4} against 32 x {steps} decode steps ({replica_steps} by replica)")
    if any(len(rs) != 1 or rs[0]["replica"] not in ("0", "1") or rs[0]["phase"] != "unified"
           for rs in routed):
        bad.append(f"route spans {routed}")
    if any(label not in text for label in labels):
        bad.append("kv_blocks_free lacks a replica")
    if len(ttft_rows) != 1 or ttft_rows[0]["count"] != len(bodies) or "replica" in ttft_rows[0]:
        bad.append(f"/slo TTFT rows {ttft_rows}")
    if memory["weights"] != memory["expected_weights"] or \
            memory["kv_arena"] != memory["expected_kv_arena"]:
        bad.append(f"/debug/memory {memory}")
    if {r["replica"] for r in extra["arena"]["replicas"]} != {"0", "1"} or \
            extra["fabric"][0] != 404 or not all(counts["windows"].values()):
        bad.append("the arena timelines, /debug/fabric's 404 or a replica's windows")
    if not stats["seeded_equal_phase_7"]:
        bad.append("the seeded body left phase 7's row")
    if bad:
        raise AssertionError(f"{tag}: {bad}")
    stats["rows"] = rows
    del router
    free_device_memory()
    return stats


def phase_disaggregated(model, card, fleet):
    """Phase 13b: ``serve_lm --batching 8 --roles prefill=1,decode=2`` at
    7B width (module docstring); ``fleet`` is 13a's stats (rows, prefix
    hits)."""

    tag = "disaggregated"
    bodies = _main_bodies()
    (results, autopsies, rows, text, slo, traces, router, counts, wall,
     extra) = _fleet_run(model, ["--roles", "prefill=1,decode=2"], tag)
    pre, decs = router.pools[0], router.pools[1:]
    fabric = pre.fabric.snapshot()
    block = pre._block_host_bytes
    launches, steps, windows = counts["launches"], counts["decode_steps"], counts["windows"]
    routes = [{s["attributes"]["phase"]: s for s in t["spans"] if s["name"] == "route"}
              for t in traces]
    migrate_spans = [[s["attributes"]["blocks"] for s in t["spans"] if s["name"] == "migrate"]
                     for t in traces]
    usable = [(len(b["prompt"].encode()) - 1) // 16 for b in bodies]
    pulled = sum(a["migrated_blocks"] for a in autopsies)
    handshake = [{"publish_ms": routes[i]["prefill"]["duration"] * 1e3
                  if "prefill" in routes[i] else None,
                  "ttft_s": a["ttft_seconds"],
                  "after_publish_s": a["ttft_seconds"] - routes[i]["prefill"]["duration"]
                  if "prefill" in routes[i] else None,
                  "decode_queue_wait_s": a["queue_wait_seconds"]}
                 for i, a in enumerate(autopsies)]

    def copies(pool):
        out = []
        for e in pool.migrate_log:
            ms = e["events"][0].elapsed_time(e["events"][1]) if e["events"] else None
            out.append({"direction": e["direction"], "blocks": e["blocks"], "bytes": e["bytes"],
                        "host_ms": e["host_s"] * 1e3, "device_ms": ms,
                        "gb_per_s": e["bytes"] / ms / 1e6 if ms else None})
        return out

    counted = {
        "migrate_out_bytes": _metric(text, "kv_migrate_bytes_total", direction="out",
                                     transport="local"),
        "migrate_in_bytes": _metric(text, "kv_migrate_bytes_total", direction="in",
                                    transport="local"),
        "ttft_observations": _metric_sum(text, "serve_ttft_seconds_count"),
        "ttft_prefill_role": sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                                 if line.startswith("serve_ttft_seconds_count{")
                                 and 'role="prefill"' in line),
        "publish_failures": _metric(text, "serve_fabric_publish_failures_total",
                                    model="llama-7b"),
        "k4": launches.get("paged_attention", 0),
    }
    want = {"migrate_out_bytes": float(fabric["publishes"] * BLOCK_BYTES_7B),
            "migrate_in_bytes": float(pulled * BLOCK_BYTES_7B),
            "ttft_observations": float(len(bodies)), "ttft_prefill_role": 0.0,
            "publish_failures": 0.0, "k4": model.cfg.n_layers * steps}
    hits = [a["admission"]["prefix_hit_tokens"] for a in autopsies]
    stats = {
        "wall_s": wall, "launches": launches, "decode_steps": steps,
        "replicas": _window_stats(router, autopsies, traces, counts), "counted": counted,
        "expected": want,
        "fabric": fabric, "fabric_host_bytes": fabric["bytes_published"],
        "handshake": handshake, "prefix_hits": hits,
        "migrated_blocks": [a["migrated_blocks"] for a in autopsies],
        "migrate_copies": {"out": copies(pre), "in": [c for d in decs for c in copies(d)]},
        "peak_gib": extra["peak_gib"],
        "seeded_repeat_equal": extra["seeded_repeat"][1]["sample"] == results[-1][1]["sample"],
    }
    stats["against_fleet"] = _judge_rows(
        model, bodies, rows, fleet["rows"],
        lambda i: (lambda m, p, r, j: _paged_replay_logits(m, p, r, j, hits[i], migrated=True),
                   lambda m, p, r, j: _paged_replay_logits(m, p, r, j,
                                                           fleet["prefix_hits"][i])),
        ("disaggregated", "fleet"), tag)
    log(f"disaggregated ({card}) " + json.dumps(stats))
    bad = []
    if block != BLOCK_BYTES_7B or counted != want:
        bad.append(f"block bytes {block}, counts {counted} against {want}")
    if windows["0"] or pre.ledger is not decs[0].ledger or \
            steps != sum(windows.values()) * pre.steps_per_sync:
        bad.append(f"the prefill replica stepped ({windows} windows)")
    for i, a in enumerate(autopsies):
        spans = migrate_spans[i]
        ok = (a["prefill_replica"] == "0" and a["decode_replica"] in ("1", "2")
              and a["replica"] == a["decode_replica"]
              and set(routes[i]) == {"prefill", "decode"}
              and routes[i]["decode"]["attributes"]["role"] == "decode"
              and a["admission"]["prefix_hit_tokens"] == usable[i] * 16)
        if usable[i] > 0:
            ok = ok and a["dispatches"].get("migrate_in") == len(spans) == 1 \
                and a["migrated_blocks"] == spans[0] > 0
        if not ok:
            bad.append(f"body {i}: autopsy {a}, migrate spans {spans}")
    if not stats["seeded_repeat_equal"]:
        bad.append("the seeded body did not repeat")
    if bad:
        raise AssertionError(f"{tag}: {bad}")
    del router, pre, decs
    free_device_memory()
    return stats


#: phase 13c: the first three of phase 7's bodies go to pod A and then
#: to pod B; A also serves the fourth body that B gets only once A has
#: stopped (its 700 bytes: phase 7's fifth)
HTTP_FLEET_BODIES = 3
HTTP_FLEET_FOURTH = 4
#: each pod's arena (``--kv-blocks``): two 7B pods on one card
HTTP_FLEET_KV_BLOCKS = 256
#: blocks the HTTP pull timing reads from pod A
HTTP_PULL_TIMED = 16


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _spawn_pod(flags, tag):
    """One ``python -m tf_operator_tpu_torch.serve_lm`` at 7B width with
    ``flags``; returns (process, its lines, the serving port, the fabric
    server's address) once it serves.  A reader thread keeps its output
    (stdout and stderr together) in the lines."""

    import queue

    cmd = [sys.executable, "-m", "tf_operator_tpu_torch.serve_lm"] + POD_MODEL_FLAGS + [
        "--batching", "8", "--kv-blocks", str(HTTP_FLEET_KV_BLOCKS), "--port", "0"] + flags
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    lines, q = [], queue.Queue()

    def read():
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            q.put(line)
        q.put(None)

    threading.Thread(target=read, daemon=True).start()
    return proc, lines, q


def _await_pod(proc, lines, q, tag, timeout=300):
    """(serving port, fabric address) of a spawned pod once it prints
    them."""

    import queue

    port = addr = None
    t_end = time.monotonic() + timeout
    while port is None and time.monotonic() < t_end:
        try:
            line = q.get(timeout=max(0.1, t_end - time.monotonic()))
        except queue.Empty:
            break
        if line is None:
            break
        m = re.match(r"fabric server on (\S+) ", line)
        if m:
            addr = m.group(1)
        m = re.match(r"serving on 127\.0\.0\.1:(\d+) ", line)
        if m:
            port = int(m.group(1))
    if port is None or addr is None:
        proc.kill()
        raise AssertionError(f"{tag}: the pod did not serve: {lines[-40:]}")
    return port, addr


def _stop_pod(proc):
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=60)


def _time_http_pulls(addr, arena_like, n):
    """A port client's pulls of ``n`` of the blocks pod ``addr`` lists,
    each timed: (ms a block, MB/s)."""

    from tf_operator_tpu_torch.models.fabric_service import FleetFabric
    from tf_operator_tpu_torch.models.prefix_cache import PrefixFabric

    client = FleetFabric(PrefixFabric(model_label="llama-7b"), peers=[addr],
                         request_timeout=30.0)
    client.register_template(arena_like)
    with urllib.request.urlopen(f"http://{addr}/fabric/index", timeout=60) as resp:
        keys = [bytes.fromhex(k) for k in json.loads(resp.read())["keys"]][:n]
    walls = []
    for key in keys:
        t0 = time.perf_counter()
        rec = client.get(key)
        walls.append(time.perf_counter() - t0)
        if rec is None or rec.get("transport") != "http" or rec["nbytes"] != BLOCK_BYTES_7B:
            raise AssertionError(f"fleet over HTTP: timed pull of {key.hex()} gave {rec}")
    ms = statistics.median(walls) * 1e3
    return {"blocks": len(keys), "median_ms_a_block": ms,
            "mb_per_s": BLOCK_BYTES_7B / (ms / 1e3) / 1e6, "walls_ms": [w * 1e3 for w in walls]}


def phase_fleet_http(card):
    """Phase 13c: two ``serve_lm`` processes on the card sharing blocks
    over HTTP (module docstring)."""

    tag = "fleet over HTTP"
    fabric_port = _free_port()
    a_proc, a_lines, a_q = _spawn_pod(["--fabric-port", str(fabric_port), "--fabric-peers",
                                       ""], "pod A")
    b_proc, b_lines, b_q = _spawn_pod(["--fabric-peers", f"127.0.0.1:{fabric_port}"], "pod B")
    bodies = _main_bodies()[:HTTP_FLEET_BODIES]
    fourth = _main_bodies()[HTTP_FLEET_FOURTH]
    try:
        t0 = time.perf_counter()
        a_port, a_addr = _await_pod(a_proc, a_lines, a_q, "pod A")
        b_port, b_addr = _await_pod(b_proc, b_lines, b_q, "pod B")
        boot_s = time.perf_counter() - t0
        got_a = _send_at_once(a_port, bodies + [fourth])
        got_b = _send_at_once(b_port, bodies)
        for part, results in (("A", got_a), ("B", got_b)):
            for i, r in enumerate(results):
                if r is None or r[0] != 200 or len(r[1]["sample"]) != 32:
                    raise AssertionError(f"{tag}: pod {part} request {i}: {r}")
        autopsies = [_get_json(b_port, f"/requests/{r[1]['request_id']}") for r in got_b]
        fab_b = _get_json(b_port, "/debug/fabric")["fabric"]
        fab_a = _get_json(a_port, "/debug/fabric")["fabric"]
        text_b = _get(b_port, "/metrics")[1].decode()
        layers, heads, head_dim = POD_KV
        arena_like = [(torch.empty((2, heads, 16, head_dim), dtype=torch.bfloat16,
                                   device="meta"),) * 2 for _ in range(layers)]
        pulls = _time_http_pulls(a_addr, arena_like, HTTP_PULL_TIMED)
        # A stops; B gets the body only A served: the index B read from A
        # names its blocks, the pulls find A dead, and B recomputes
        _stop_pod(a_proc)
        got_4 = _post(b_port, fourth)
        text_b4 = _get(b_port, "/metrics")[1].decode()
        fab_b4 = _get_json(b_port, "/debug/fabric")["fabric"]
    finally:
        _stop_pod(a_proc)
        _stop_pod(b_proc)
    pulled = sum(a.get("pulled_blocks", 0) for a in autopsies)
    stats = {
        "boot_s": boot_s, "fabric_port": fabric_port, "b_fabric": b_addr,
        "samples_equal": [ra[1]["sample"] == rb[1]["sample"] for ra, rb in zip(got_a, got_b)],
        "a_exit": a_proc.returncode,
        "pulled_blocks": [a.get("pulled_blocks", 0) for a in autopsies],
        "b_dispatches": [a["dispatches"] for a in autopsies],
        "b_pulls": fab_b["pulls"], "b_bytes_pulled": fab_b["bytes_pulled"],
        "a_fabric_host_bytes": fab_a["bytes_published"], "a_blocks": fab_a["blocks"],
        "http_migrate_in_bytes": _metric(text_b, "kv_migrate_bytes_total", direction="in",
                                         transport="http"),
        "http_pulls": pulls,
        "b_latency_s": [round(r[2], 3) for r in got_b], "a_latency_s": [round(r[2], 3)
                                                                        for r in got_a],
        "fourth": {"status": got_4[0], "latency_s": got_4[2],
                   "peer_dead": sum(float(line.rsplit(" ", 1)[1])
                                    for line in text_b4.splitlines()
                                    if line.startswith("kv_fabric_pull_failures_total{")
                                    and 'reason="peer_dead"' in line),
                   "sample_equals_a": got_4[1]["sample"] == got_a[-1][1]["sample"],
                   "pull_failures": fab_b4["pull_failures"], "peers": fab_b4["peers"]},
    }
    log(f"fleet over HTTP ({card}) " + json.dumps(stats))
    bad = []
    if not all(stats["samples_equal"]):
        bad.append("B's samples left A's")
    if pulled != fab_b["pulls"].get("hit") or pulled == 0 or \
            stats["http_migrate_in_bytes"] != pulled * BLOCK_BYTES_7B or \
            fab_b["bytes_pulled"] != pulled * BLOCK_BYTES_7B:
        bad.append(f"pulled {pulled} blocks, {stats['http_migrate_in_bytes']} bytes")
    if any("prefill" in d for d in stats["b_dispatches"]) or \
            any(d.get("migrate_in") != 1 for d in stats["b_dispatches"]):
        bad.append("B's dispatches")
    if got_4[0] != 200 or len(got_4[1]["sample"]) != 32 or stats["fourth"]["peer_dead"] < 1:
        bad.append("the fourth body after A stopped")
    if bad:
        raise AssertionError(f"{tag}: {bad}; A: {a_lines[-20:]}; B: {b_lines[-20:]}")
    return stats


#: phase 7c's runs, interleaved so that drift between them cancels
PLANE_ORDER = ("bare", "plane", "plane", "bare")
#: what the records (the cost plane included) may add to a decode
#: window's host work: the median bookkeeping, plane less bare
PLANE_BOOKKEEPING_US = 1000.0


def _plane_run(model, side):
    """Phase 7's nine requests through one pool, driven in this process
    (the HTTP layer's per-request work is outside the decode window):
    ``bare`` is the pool built with no ledger and no metrics, ``plane``
    the pool as ``serve_lm`` builds it (``make_pool``).  Each ``step()``
    is timed; a step that ran a window and admitted or resumed nothing
    gives one bookkeeping sample: its wall less the window's wall up to
    its fetch (the ledger's ``step`` seconds)."""

    from tf_operator_tpu_torch.models.batching import PagedContinuousBatchingDecoder
    from tf_operator_tpu_torch.ops import _build
    from tf_operator_tpu_torch.serve_lm import make_pool

    kw = dict(slots=8, steps_per_sync=8, kv_block_size=16)
    if side == "bare":
        pool = PagedContinuousBatchingDecoder(model, **kw)
    else:
        pool = make_pool(model, model_label="llama-7b", **kw)
    rids = []
    for i, b in enumerate(_main_bodies()):
        ids = np.frombuffer(b["prompt"].encode("ascii", "replace"), np.uint8).astype(np.int32)
        gen = None
        if b.get("temperature"):
            gen = torch.Generator(device="cuda").manual_seed(b["seed"])
        rids.append(pool.submit(ids, b["max_new_tokens"], temperature=b.get("temperature", 0.0),
                                top_k=b.get("top_k"), generator=gen, trace_id=f"{side}-{i}"))
    torch.cuda.synchronize()
    _build.launches.clear()
    windows, book = [], []
    t0 = time.perf_counter()
    while pool._queue or pool._active:
        seated = pool.ledger.count("admission") + pool.ledger.count("swap_in")
        w0, n0 = pool.ledger.seconds("step"), pool.ledger.count("step")
        t_step = time.perf_counter()
        pool.step()
        dt = time.perf_counter() - t_step
        if pool.ledger.count("step") > n0:
            windows.append(pool.ledger.seconds("step") - w0)
            if pool.ledger.count("admission") + pool.ledger.count("swap_in") == seated:
                book.append(dt - windows[-1])
    wall = time.perf_counter() - t0
    if any(pool.result(r) is None for r in rids):
        raise AssertionError(f"plane cost, {side}: a request did not finish")
    k4 = _build.launches.get("paged_attention", 0)
    steps = decode_steps(pool)
    if k4 != model.cfg.n_layers * steps or steps == 0:
        raise AssertionError(f"plane cost, {side}: K4 launched {k4} times for "
                             f"{steps} decode steps")
    tokens = sum(e["tokens"] - 1 for e in pool.request_log.recent(len(rids)))
    if tokens != len(rids) * 31:
        raise AssertionError(f"plane cost, {side}: {tokens} decode tokens")
    rec = {"side": side, "wall_s": wall, "decode_steps": steps,
           "k4_launches": k4, "windows": len(windows),
           "decode_tokens_per_s": tokens / pool.ledger.seconds("step"),
           "window_ms": statistics.median(windows) * 1e3,
           "bookkeeping_us": statistics.median(book) * 1e6 if book else None,
           "bookkeeping_samples_us": [round(b * 1e6, 1) for b in book]}
    del pool
    free_device_memory()
    return rec


def phase_plane_cost(model, card):
    """Phase 7c: what the serving plane's records cost on the host.  The
    same nine requests through a bare pool and a ``serve_lm`` pool, in
    ``PLANE_ORDER``; for each side the median and spread (max - min)
    over its runs of decode tokens/s, window ms and bookkeeping µs a
    window."""

    runs = [_plane_run(model, side) for side in PLANE_ORDER]
    for r in runs:
        log(f"plane cost run ({card}) " + json.dumps(r))
    summary = {}
    for side in ("bare", "plane"):
        mine = [r for r in runs if r["side"] == side]
        summary[side] = {}
        for key in ("decode_tokens_per_s", "window_ms", "bookkeeping_us"):
            xs = [r[key] for r in mine if r[key] is not None]
            summary[side][key] = {"median": statistics.median(xs), "spread": max(xs) - min(xs),
                                  "runs": xs}
    diff = {key: summary["plane"][key]["median"] - summary["bare"][key]["median"]
            for key in ("decode_tokens_per_s", "window_ms", "bookkeeping_us")}
    beyond = {key: abs(diff[key]) > max(summary["bare"][key]["spread"],
                                        summary["plane"][key]["spread"]) for key in diff}
    log(f"plane cost ({card}) " + json.dumps({"summary": summary, "plane_minus_bare": diff,
                                              "beyond_spread": beyond}))
    if not diff["bookkeeping_us"] < PLANE_BOOKKEEPING_US:
        raise AssertionError(f"the records cost {diff['bookkeeping_us']:.1f} us a decode "
                             f"window, over {PLANE_BOOKKEEPING_US}")
    return summary


def phase_decode_profile(pool, tier="batch"):
    """Where one decode window's time goes: the pool (its server
    stopped) admits 8 greedy requests of ``tier``, runs one window
    unprofiled, then one under torch.profiler.  Prints the window's
    wall, the device's busy share of it and the kernels' shares of
    device time.  The profiler slows the host, so the busy share is a
    lower bound."""

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prompts = [(torch.arange(n) * 7 + 3) % 256 for n in (512, 700, 900, 1100, 300, 1500, 64, 200)]
    rids = [pool.submit(p.numpy(), 2 * pool.steps_per_sync + 1, tier=tier) for p in prompts]
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
        "tier": tier, "speculative": pool._spec_tier(tier),
        "window_steps": pool.steps_per_sync, "profiled_window_ms": wall_us / 1e3,
        "device_busy_ms": busy / 1e3, "device_busy_share": busy / wall_us,
        "k4_share_of_device": sum(dev_us(e) for e in events if "paged_attention" in e.key) / busy,
        "k7_share_of_device": sum(dev_us(e) for e in events if "quant_matmul" in e.key) / busy,
        "top_kernels": [[e.key[:60], round(dev_us(e) / busy, 4), e.count] for e in top],
    }
    log("decode window profile " + json.dumps(rec))
    return rec


#: phase 7b: eight batch prompts in 390..410 bytes (none a multiple of
#: 16, so each seat's straddle block is private), 80 new tokens each
#: (cut from 128 to keep the script inside its time: the seats still
#: outgrow the 24 spare blocks by 8, and the worst cases, 244 blocks,
#: stay above the arena's 236); the fourth is seeded temperature.  After
#: two windows one interactive request of 700 bytes and 32 new tokens
#: arrives
PRESSURE_LENGTHS = (390, 393, 397, 399, 403, 405, 407, 410)
PRESSURE_BUDGET = 80
PRESSURE_INTERACTIVE = (700, 32)


def _pressure_bodies(seed=5):
    import random

    rng = random.Random(seed)

    def text(n):
        return "".join(chr(rng.randrange(32, 127)) for _ in range(n))

    bodies = [{"prompt": text(n), "max_new_tokens": PRESSURE_BUDGET, "tier": "batch"}
              for n in PRESSURE_LENGTHS]
    bodies[3].update(temperature=0.8, top_k=40, seed=4321)
    n, budget = PRESSURE_INTERACTIVE
    bodies.append({"prompt": text(n), "max_new_tokens": budget, "tier": "interactive"})
    return bodies


def pressure_kv_blocks(pool_cls, model, bodies):
    """The arena of phase 7b from the pool's own commit formula: the
    eight batch commits plus 24 blocks (three rounds of one block a
    seat), which must lie below the sum of their worst cases."""

    from tf_operator_tpu_torch.models.kv_blocks import blocks_for

    probe = pool_cls(model, slots=1, kv_block_size=16, kv_blocks=1 + model.cfg.max_len // 16)
    batch = [(len(b["prompt"]), b["max_new_tokens"]) for b in bodies if b["tier"] == "batch"]
    lazy = sum(probe._commit_blocks(p, n) for p, n in batch)
    worst = sum(blocks_for(p + n, 16) for p, n in batch)
    del probe
    kv_blocks = lazy + 24
    if not lazy <= kv_blocks < worst:
        raise AssertionError(f"phase 7b arena {kv_blocks}: lazy {lazy}, worst {worst}")
    return kv_blocks, lazy, worst


def _serve_pressure(model, bodies, *, kv_blocks, reserve, tag):
    """The bodies through ``serve_lm``'s server over one pool: the batch
    requests at once, the interactive one after two windows.  Counts
    zeroed just before and read just after.  Returns (stats, rows by
    prompt, pool)."""

    from tf_operator_tpu_torch.ops import _build
    from tf_operator_tpu_torch.serve_lm import Server, make_pool

    pool = make_pool(model, model_label="llama-7b", slots=8, steps_per_sync=8,
                     kv_block_size=16, kv_blocks=kv_blocks, reserve=reserve)
    # the token rows (the HTTP sample is bytes), each preemption's tier
    # and blocks: swapped to the host and left live on the device, and
    # each demotion's request and blocks
    rows, preempts, demotions = {}, [], []
    result_wait, preempt = pool.result_wait, pool._preempt_seat_locked
    demote = pool._demote_queued_locked

    def recording_wait(rid, timeout=None):
        row = result_wait(rid, timeout)
        if row is not None:
            rows[rid] = row
        return row

    def logged_preempt(slot, reason):
        req = pool._active[slot]
        freed = preempt(slot, reason)
        rec = pool.swap.peek(req.rid)
        preempts.append({"rid": req.rid, "tier": req.tier, "tokens": len(req.tokens),
                         "swapped": rec["n_blocks"], "live": len(rec["live"]),
                         "freed": freed, "reason": reason})
        return freed

    def logged_demote(max_rank, exclude_rid):
        held = {q.rid: pool.swap.peek(q.rid)["n_blocks"] for q in pool._queue
                if q.swapped and pool.swap.peek(q.rid) is not None}
        done = demote(max_rank, exclude_rid)
        for rid, n in held.items():
            rec = pool.swap.peek(rid)
            if rec is not None and rec["n_blocks"] != n:
                demotions.append({"rid": rid, "blocks": rec["n_blocks"] - n})
        return done

    pool.result_wait = recording_wait
    pool._preempt_seat_locked = logged_preempt
    pool._demote_queued_locked = logged_demote
    server = Server(pool).start()
    results = [None] * len(bodies)

    def send(i):
        results[i] = _post(server.port, bodies[i])

    try:
        torch.cuda.reset_peak_memory_stats()
        _build.launches.clear()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=send, args=(i,)) for i in range(len(bodies))]
        for t in threads[:-1]:
            t.start()
        peak = 0
        while pool.ledger.count("step") < 2 and not server.fatal:
            peak = max(peak, len(pool._active))
            time.sleep(0.002)
        threads[-1].start()
        while any(t.is_alive() for t in threads) and time.perf_counter() - t0 < 900:
            peak = max(peak, len(pool._active))
            time.sleep(0.002)
        wall = time.perf_counter() - t0
        launches = dict(_build.launches)
        for i, r in enumerate(results):
            if r is None or r[0] != 200 or \
                    len(r[1]["sample"]) != bodies[i]["max_new_tokens"]:
                raise AssertionError(f"{tag}: request {i} failed: {r}")
        autopsies, metrics_text, slo = check_records(server.port, pool, results, tag)
    finally:
        server.close()
    if server.fatal:
        raise AssertionError(f"{tag}: decode loop died: {server.fatal[0]}")
    steps = decode_steps(pool)
    k4 = launches.get("paged_attention", 0)
    if k4 != model.cfg.n_layers * steps or steps == 0:
        raise AssertionError(f"{tag}: K4 launched {k4} times; {model.cfg.n_layers} layers x "
                             f"{steps} decode steps")
    pool.alloc.check()
    if len(pool.swap) or pool.swap.swapped_blocks:
        raise AssertionError(f"{tag}: the swap arena is not empty: {pool.swap.snapshot()}")
    by_prompt = {}
    for row in rows.values():
        for b in bodies:
            p = b["prompt"].encode()
            if bytes(row[: len(p)].astype("uint8")) == p and len(row) == len(p) + b["max_new_tokens"]:
                by_prompt[b["prompt"]] = row
    ttft = {}
    for a in autopsies:
        ttft.setdefault(a["tier"], []).append(a["ttft_seconds"])
    stats = {
        "kv_blocks": kv_blocks, "reserve": reserve, "wall_s": wall, "decode_steps": steps,
        "k4_launches": k4, "peak_seats": peak,
        "dispatches": {p: r["count"] for p, r in pool.ledger.snapshot().items()},
        "preemptions": pool.preemptions, "preempted": preempts,
        "demotions": demotions,
        "swap": pool.swap.snapshot(),
        "decode_tokens_per_s": sum(a["tokens"] - 1 for a in autopsies)
        / pool.ledger.seconds("step"),
        "ttft_s_by_tier": {t: {"mean": sum(v) / len(v), "max": max(v)} for t, v in ttft.items()},
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    check_pressure_records(pool, autopsies, metrics_text, slo, preempts, demotions, tag)
    return stats, by_prompt, pool


def check_pressure_records(pool, autopsies, text, slo, preempts, demotions, tag):
    """Phase 7b's records against the pool's own counts: the preemption
    counter by tier, the swap bytes counters against the swap log, the
    autopsies' preemptions and swapped blocks against the phase's own
    preempt and demotion logs, the timeline's swapped series, and both
    tiers on /slo."""

    n = pool.preemptions
    batch = _metric(text, "serve_preemptions_total", model="llama-7b", replica="0",
                    tier="batch")
    interactive = "serve_preemptions_total{model=\"llama-7b\",replica=\"0\"," \
        "tier=\"interactive\"}" in text
    out = sum(e["bytes"] for e in pool.swap_log if e["direction"] == "out")
    back = sum(e["bytes"] for e in pool.swap_log if e["direction"] == "in")
    swap_out = _metric(text, "kv_swap_bytes_total", direction="out")
    swap_in = _metric(text, "kv_swap_bytes_total", direction="in")
    want_swapped = collections.Counter()
    for p in preempts:
        want_swapped[p["rid"]] += p["swapped"]
    for d in demotions:
        want_swapped[d["rid"]] += d["blocks"]
    got_swapped = {a["rid"]: a["swapped_blocks"] for a in autopsies}
    samples = pool.timeline.snapshot()["samples"]
    tiers = {row["tier"] for row in slo["histograms"]["serve_ttft_seconds"]}
    rec = {"preemptions": n, "counter_batch": batch, "interactive_series": interactive,
           "swap_bytes": {"out": swap_out, "in": swap_in, "log_out": out, "log_in": back},
           "autopsy_preempted": sum(a["preempted"] for a in autopsies),
           "autopsy_swapped_blocks": got_swapped,
           "timeline_max_swapped": max(s["swapped"] for s in samples),
           "timeline_last_swapped": samples[-1]["swapped"], "slo_tiers": sorted(tiers)}
    log(f"{tag} pressure records: " + json.dumps(rec))
    if batch != n or interactive:
        raise AssertionError(f"{tag}: serve_preemptions_total off: {rec}")
    if not swap_out == swap_in == out == back:
        raise AssertionError(f"{tag}: kv_swap_bytes_total off the swap log: {rec}")
    if rec["autopsy_preempted"] != n or any(
            got_swapped[rid] != want_swapped.get(rid, 0) for rid in got_swapped):
        raise AssertionError(f"{tag}: autopsies off the preempt log: {rec}, "
                             f"want {dict(want_swapped)}")
    if n and rec["timeline_max_swapped"] <= 0 or rec["timeline_last_swapped"] != 0:
        raise AssertionError(f"{tag}: the timeline's swapped series: {rec}")
    if tiers != {"batch", "interactive"}:
        raise AssertionError(f"{tag}: /slo tiers {tiers}")


def _swap_timings(pool):
    """Each swap copy's device ms (CUDA events around it: the gathers or
    scatters, the copy, and a fresh pinned buffer's allocation where the
    allocator has none cached), blocks, bytes and GB/s; and by direction
    the median and the largest."""

    out = []
    torch.cuda.synchronize()
    for e in pool.swap_log:
        ms = e["events"][0].elapsed_time(e["events"][1])
        out.append({"direction": e["direction"], "blocks": e["blocks"], "bytes": e["bytes"],
                    "ms": ms, "gb_per_s": e["bytes"] / ms / 1e6})
    summary = {}
    for d in ("out", "in"):
        xs = [s for s in out if s["direction"] == d]
        if xs:
            summary[d] = {"copies": len(xs),
                          "median_ms": statistics.median(s["ms"] for s in xs),
                          "max_ms": max(s["ms"] for s in xs),
                          "median_gb_per_s": statistics.median(s["gb_per_s"] for s in xs),
                          "blocks": sum(s["blocks"] for s in xs),
                          "bytes": sum(s["bytes"] for s in xs)}
    return out, summary


def _link_yardstick(nbytes):
    """A plain pinned-host copy of ``nbytes`` each way (CUDA events over
    20 copies after 3 warm-ups): the host link's yardstick for the swaps.
    Also the host ms of pinning a fresh buffer of twice those bytes (a
    size the caching host allocator has not seen in this run)."""

    t0 = time.perf_counter()
    fresh = torch.empty(2 * nbytes, dtype=torch.uint8, pin_memory=True)
    pin_ms = (time.perf_counter() - t0) * 1e3
    del fresh
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    d2h = time_ms(lambda: host.copy_(dev, non_blocking=True))
    h2d = time_ms(lambda: dev.copy_(host, non_blocking=True))
    return {"bytes": nbytes, "d2h_ms": d2h, "d2h_gb_per_s": nbytes / d2h / 1e6,
            "h2d_ms": h2d, "h2d_gb_per_s": nbytes / h2d / 1e6,
            "pin_fresh_bytes": 2 * nbytes, "pin_fresh_ms": pin_ms}


def phase_pressure(model, card):
    """Phase 7b: the pool under arena pressure at 7B width (module
    docstring)."""

    from tf_operator_tpu_torch.models.batching import PagedContinuousBatchingDecoder

    bodies = _pressure_bodies()
    kv_blocks, lazy, worst = pressure_kv_blocks(PagedContinuousBatchingDecoder, model, bodies)
    log(f"pressure arena: {kv_blocks} blocks; the batch commits {lazy}, their worst cases "
        f"{worst}")
    ref, want, pool = _serve_pressure(model, bodies, kv_blocks=None, reserve="lazy",
                                      tag="unpressured")
    del pool
    free_device_memory()
    lazy_stats, got, pool = _serve_pressure(model, bodies, kv_blocks=kv_blocks,
                                            reserve="lazy", tag="pressured lazy")
    swaps, swap_summary = _swap_timings(pool)
    del pool
    free_device_memory()
    wc_stats, wc_rows, pool = _serve_pressure(model, bodies, kv_blocks=kv_blocks,
                                              reserve="worst-case", tag="worst-case")
    del pool
    free_device_memory()
    same = {b["prompt"][:12]: bool(np.array_equal(got.get(b["prompt"]), want.get(b["prompt"])))
            for b in bodies}
    same_wc = all(np.array_equal(wc_rows.get(b["prompt"]), want.get(b["prompt"]))
                  for b in bodies)
    if not len(want) == len(got) == len(wc_rows) == len(bodies):
        raise AssertionError(f"phase 7b rows: {len(want)}, {len(got)}, {len(wc_rows)} of "
                             f"{len(bodies)}")
    outs = [s for s in swaps if s["direction"] == "out"]
    yard = _link_yardstick(max(s["bytes"] for s in outs)) if outs else None
    for tag, stats in (("unpressured", ref), ("pressured lazy", lazy_stats),
                       ("worst-case", wc_stats)):
        log(f"pressure {tag} ({card}) " + json.dumps(stats))
    log(f"pressure swaps ({card}) " + json.dumps(swaps))
    log(f"pressure swaps by direction ({card}) " + json.dumps(swap_summary))
    log(f"pressure link yardstick ({card}) " + json.dumps(yard))
    log("pressure token identity against the unpressured pool: " + json.dumps(same)
        + f"; worst-case identical: {same_wc}")
    victims = lazy_stats["preempted"]
    if lazy_stats["preemptions"] < 1 or not outs:
        raise AssertionError(f"phase 7b preempted nothing: {lazy_stats}")
    if any(v["tier"] != "batch" for v in victims):
        raise AssertionError(f"an interactive seat was preempted: {victims}")
    swap = lazy_stats["swap"]
    if not swap["bytes_out_total"] == swap["bytes_in_total"] > 0:
        raise AssertionError(f"swap bytes out != in: {swap}")
    if not all(same.values()) or not same_wc:
        raise AssertionError("a pressured request's tokens differ from the unpressured pool's")
    if not lazy_stats["peak_seats"] == 8 > wc_stats["peak_seats"]:
        raise AssertionError(f"peak seats: lazy {lazy_stats['peak_seats']}, worst-case "
                             f"{wc_stats['peak_seats']}")
    return lazy_stats


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


#: phase 7d: draft tokens a speculative window, and which of phase 7's
#: nine requests speculate (tier interactive): the 64-byte prompt, the
#: 200-byte one, both of the shared-prefix pair (the second admitted
#: through a prefix hit), the 1500-byte one and the seeded request; the
#: 380-, 700- and 900-byte ones are batch and decode plainly in the same
#: windows
SPEC_K = 4
SPEC_INTERACTIVE = (0, 1, 3, 6, 7, 8)
#: the runs: one plain (the rows the speculative runs are held to, and
#: the speedup's baseline) and two speculative (their seeded rows must
#: agree)
SPEC_ORDER = ("plain", "spec", "spec")
#: a seeded token must lie within its top_k support of the replayed
#: logits, up to this share of their largest magnitude (the replay runs
#: the plain contiguous path, the served run K4 and other GEMM shapes)
SPEC_SUPPORT_TOL = 1e-2


def _spec_bodies():
    bodies = _main_bodies()
    for i, b in enumerate(bodies):
        b["tier"] = "interactive" if i in SPEC_INTERACTIVE else "batch"
    return bodies


def _bf16_ulp(x):
    return 2.0 ** (math.floor(math.log2(max(abs(x), 1e-30))) - 7)


def _replay_logits(model, row, pos, k_new):
    """Target logits at position ``pos`` of token row ``row`` on the plain
    contiguous path, fed as the served pass fed it: ``k_new`` = 1 as a
    decode step, 5 as the verify pass (the window ending at ``pos`` or
    later, causal, so the rows after ``pos`` do not matter)."""

    from tf_operator_tpu_torch.models.decode import decode_variant, init_cache

    dmodel = decode_variant(model)
    dev = model.device
    start = max(1, pos - (k_new - 1))
    ids = torch.as_tensor(row[: start + k_new], device=dev).long()[None]
    with torch.inference_mode():
        cache = init_cache(dmodel, 1, length=start + k_new)
        dmodel(ids[:, :start], cache=cache)
        return dmodel(ids[:, start:], cache=cache)[0, pos - start].float()


def _spec_divergence(model, prompt, got, want):
    """Where a speculative greedy row left the plain pool's: the first
    divergent position, both tokens, and the target's top-2 logit gap
    there from a replay of the step pass and of the verify pass, beside
    the two replays' largest logit difference."""

    p_len = len(prompt)
    j = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    pos = p_len + j - 1  # the input position whose logits chose token j
    row = np.concatenate([prompt, np.asarray(got, np.int64)])
    step = _replay_logits(model, row, pos, 1)
    verify = _replay_logits(model, row, pos, SPEC_K + 1)
    diff = (step - verify).abs().max().item()

    def gap(lg):
        top = torch.topk(lg, 2)
        return (top.values[0] - top.values[1]).item(), top.indices.tolist()

    gaps = {"step": gap(step), "verify": gap(verify)}
    floor = max(diff, _bf16_ulp(step.abs().max().item()))
    tie = (min(g for g, _ in gaps.values()) <= floor
           and {int(got[j]), int(want[j])} <= set(gaps["step"][1] + gaps["verify"][1]))
    return {"position": j, "spec_token": int(got[j]), "plain_token": int(want[j]),
            "top2_gap": {k: v[0] for k, v in gaps.items()},
            "top2": {k: v[1] for k, v in gaps.items()},
            "replay_max_abs_diff": diff, "tie_floor": floor, "tie": bool(tie)}


def _chunked_replay_logits(model, prompt, row, j):
    """The logits that chose token ``j`` of a chunked decoder's row
    ``row``, computed again as the decoder computed them: the prompt
    prefilled in its binary chunks (the first token from the last
    chunk's last row), then the row's tokens before ``j`` fed one decode
    step each."""

    from tf_operator_tpu_torch.models.decode import ChunkedServingDecoder, init_cache

    dec = ChunkedServingDecoder(model)
    p = len(prompt)
    ids = torch.as_tensor(np.concatenate([prompt, np.asarray(row[:j], np.int64)]),
                          device=model.device).long()[None]
    with torch.inference_mode():
        cache, offset = init_cache(dec.dmodel, 1), 0
        for width in dec._chunks(p):
            last = dec.dmodel(ids[:, offset : offset + width], cache=cache)[:, -1]
            offset += width
        for i in range(j):
            last = dec.dmodel(ids[:, p + i : p + i + 1], cache=cache)[:, 0]
    return last[0].float()


def _paged_replay_logits(model, prompt, row, j, hit, slots=8, migrated=False):
    """The logits that chose token ``j`` of a paged pool's row ``row``,
    computed again as the pool computed them: the admission's one-shot
    prefill of the prompt past its ``hit`` prefix-cache tokens over a
    view of the seat's blocks (the first token from its last row), then
    the row's tokens before ``j`` one decode step each through K4 at the
    pool's ``slots`` seats, the others on the scratch block as the pool
    runs them, so that every projection has the served row count.  The
    hit's blocks are prefilled here one-shot; the pool read them from
    the request that published them.  ``migrated``: they come from a
    one-shot prefill of the whole prompt, as a prefill replica's
    publish computes them before a decode replica pulls them."""

    from tf_operator_tpu_torch.models.decode import (
        decode_variant,
        gather_block_view,
        paged_arena,
        paged_decode_variant,
        scatter_block_view,
    )
    from tf_operator_tpu_torch.models.transformer import PagedCache

    dev, bs, p = model.device, 16, len(prompt)
    n = -(-(p + j) // bs)
    arena = paged_arena(model, n + 1, bs)
    tables = torch.zeros((slots, model.cfg.max_len // bs), dtype=torch.int32, device=dev)
    tables[0, :n] = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
    ids = torch.as_tensor(np.concatenate([prompt, np.asarray(row[:j], np.int64)]),
                          device=dev).long()[None]
    dmodel = decode_variant(model)
    shared, seat = hit // bs, -(-p // bs)
    with torch.inference_mode():
        if shared:
            width, nb = (p, seat) if migrated else (hit, shared)
            view = gather_block_view(arena, tables[0, :nb], 0)
            dmodel(ids[:, :width], cache=view)
            scatter_block_view(arena, view, tables[0], 0, nb)
        view = gather_block_view(arena, tables[0, :seat], hit)
        last = dmodel(ids[:, hit:p], cache=view)[0, -1]
        scatter_block_view(arena, view, tables[0], shared, seat - shared)
        pmodel = paged_decode_variant(model)
        toks = torch.zeros((slots, 1), dtype=torch.long, device=dev)
        lengths = torch.zeros(slots, dtype=torch.int32, device=dev)
        for i in range(j):
            toks[0, 0], lengths[0] = ids[0, p + i], p + i
            last = pmodel(toks, cache=PagedCache(arena, tables, lengths.clone()))[0, 0]
    return last.float()


def _pair_divergence(model, prompt, got, want, replays, names):
    """Where greedy row ``got`` left row ``want``, two paths' rows of the
    same prompt: the first divergent position j and both tokens a and b,
    with the logits that chose token j computed again on each path as it
    ran (``replays``: one ``fn(model, prompt, row, j)`` a path, both fed
    ``got``'s tokens before j, which are ``want``'s).  A tie: each replay
    chooses its path's served token (a on the first, b on the second),
    so the divergence is the two paths' arithmetic and no other input; on
    each replay the margin between a and b is within the floor, the
    amount by which the two paths move those two logits (|x[a] - y[a]| +
    |x[b] - y[b]|, at least a bf16 ulp of the largest logit: with both
    replays faithful the two margins add up to at most it); and the
    replays' largest difference over the vocabulary stays within phase
    8's bound on two paths (``LOGITS_REL_TOL``).  ``names`` label the two
    paths in the record."""

    j = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    x, y = (fn(model, prompt, got, j) for fn in replays)
    first, second = names
    a, b = int(got[j]), int(want[j])
    diff = (x - y).abs().max().item()
    scale = x.abs().max().item()
    moved = {t: abs((x[t] - y[t]).item()) for t in (a, b)}
    floor = max(moved[a] + moved[b], _bf16_ulp(scale))
    margins = {first: (x[a] - x[b]).item(), second: (y[b] - y[a]).item()}
    replayed = {first: int(x.argmax()), second: int(y.argmax())}
    tie = (replayed == {first: a, second: b} and max(margins.values()) <= floor
           and diff <= LOGITS_REL_TOL["contiguous"] * scale)
    return {"position": j, f"{first}_token": a, f"{second}_token": b,
            "margins": margins, "moved": {"a": moved[a], "b": moved[b]},
            "replayed_argmax": replayed, "tie_floor": floor,
            "replay_max_abs_diff": diff, "max_abs_logit": scale, "tie": bool(tie)}


def _path_divergence(model, prompt, got, want, hit):
    """Where a chunked decoder's greedy row (``got``) left the paged
    pool's (``want``), judged by ``_pair_divergence`` on the chunked
    decoder's replay (``_chunked_replay_logits``) and the paged pool's
    with the body's prefix ``hit`` (``_paged_replay_logits``)."""

    d = _pair_divergence(
        model, prompt, got, want,
        (_chunked_replay_logits, lambda m, p, r, j: _paged_replay_logits(m, p, r, j, hit)),
        ("chunked", "paged"))
    d["prefix_hit"] = hit
    return d


def _spec_support(model, prompt, sample, top_k):
    """The worst margin of a seeded row's tokens against their top_k
    support on replayed logits: min over tokens of (logit(tok) - k-th
    logit) / max |logit| (>= -SPEC_SUPPORT_TOL to pass)."""

    from tf_operator_tpu_torch.models.decode import decode_variant, init_cache

    dmodel = decode_variant(model)
    row = np.concatenate([prompt, np.asarray(sample, np.int64)])
    ids = torch.as_tensor(row, device=model.device).long()[None]
    with torch.inference_mode():
        logits = dmodel(ids, cache=init_cache(dmodel, 1, length=len(row)))[0].float()
    worst = math.inf
    for j, tok in enumerate(sample):
        lg = logits[len(prompt) + j - 1]
        kth = torch.topk(lg, top_k).values[-1]
        worst = min(worst, ((lg[int(tok)] - kth) / lg.abs().max()).item())
    return worst


def _spec_run(model, draft, side):
    """Phase 7d's nine requests through ``serve_lm`` over HTTP, the pool
    built from ``serve_lm``'s flags: ``--batching 8`` (phase 7's arena),
    and on the ``spec`` side ``--speculative --speculative-force --spec-k
    4`` with ``draft``.  Counts zeroed just before the requests and read
    just after."""

    from tf_operator_tpu_torch.ops import _build
    from tf_operator_tpu_torch.ops import quant_matmul as qm
    from tf_operator_tpu_torch.serve_lm import (
        Server,
        build_parser,
        build_pool,
        refuse_speculative,
    )

    argv = ["--model", "llama-7b", "--max-len", "2048", "--batching", "8",
            "--steps-per-sync", "8", "--kv-block-size", "16"]
    if side == "spec":
        argv += ["--speculative", "--speculative-force", "--spec-k", str(SPEC_K)]
    args = build_parser().parse_args(argv)
    refuse_speculative(args)
    pool = build_pool(model, args, draft=draft if side == "spec" else None)
    rows = record_rows(pool)
    server = Server(pool).start()
    try:
        bodies = _spec_bodies()
        results = [None] * len(bodies)

        def send(i):
            results[i] = _post(server.port, bodies[i])

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.launches.clear()
        qm.plain_calls.clear()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=send, args=(i,)) for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        launches, plain = dict(_build.launches), dict(qm.plain_calls)
        if server.fatal:
            raise AssertionError(f"speculative {side}: decode loop died: {server.fatal[0]}")
        for i, r in enumerate(results):
            if r is None or r[0] != 200 or len(r[1]["sample"]) != 32:
                raise AssertionError(f"speculative {side}: request {i} failed: {r}")
        autopsies, text, _ = check_records(server.port, pool, results, f"speculative {side}")
        if side == "spec":
            # the draft's weights and arena twin are the server's too
            check_costplane(server.port, pool, [model, draft], text, "speculative spec")
        inter = [a for i, a in enumerate(autopsies) if i in SPEC_INTERACTIVE]
        rates = [(a["tokens"] - 1) / (a["total_seconds"] - a["ttft_seconds"]) for a in inter]
        decode_s = sum(pool.ledger.seconds(p) for p in ("step", "draft", "verify"))
        rec = {
            "side": side, "wall_s": wall, "windows": pool.windows,
            "dispatches": {p: r["count"] for p, r in pool.ledger.snapshot().items()},
            "launches": launches, "plain_int8_calls": plain,
            "interactive_decode_tokens_per_s": statistics.median(rates),
            "interactive_ttft_s": statistics.median(a["ttft_seconds"] for a in inter),
            "decode_tokens_per_s": sum(a["tokens"] - 1 for a in autopsies) / decode_s,
            "window_ms": decode_s / pool.windows * 1e3,
            "dispatch_s": {p: pool.ledger.seconds(p) for p in ("step", "draft", "verify")},
            "samples": [rows[a["rid"]][a["prompt_tokens"]:].tolist() for a in autopsies],
        }
        if side == "spec":
            rec.update(_check_spec_run(pool, autopsies, text, launches, plain, bodies))
        return rec
    finally:
        server.close()


def _check_spec_run(pool, autopsies, text, launches, plain, bodies):
    """Phase 7d's counts on one speculative run (module docstring)."""

    from tf_operator_tpu_torch.ops import quant_matmul as qm

    n_layers = pool.pmodel.cfg.n_layers
    n_proj = 7 * n_layers + 1
    w = pool.spec_windows
    steps = pool.ledger.count("step") * pool.steps_per_sync
    inter = [i for i in range(len(bodies)) if i in SPEC_INTERACTIVE]
    rows = [len(bodies[i]["prompt"].encode()) for i in inter]
    short = sum(1 for r in rows if r <= qm.MAX_GEMV_ROWS)
    snap = pool.spec_snapshot()
    want = {
        "draft_dispatches": w + len(inter), "verify_dispatches": w,
        "k4": n_layers * ((SPEC_K + 1) * w + w + steps),
        "k7": n_proj * (SPEC_K + 1) * w + n_proj * short,
        "gemm": n_proj * (len(inter) - short),
        "spec_launches": n_layers * (SPEC_K + 2) * w + n_proj * (SPEC_K + 1) * w,
    }
    got = {
        "draft_dispatches": _metric(text, "serving_dispatch_total", phase="draft"),
        "verify_dispatches": _metric(text, "serving_dispatch_total", phase="verify"),
        "k4": launches.get("paged_attention", 0), "k7": launches.get(qm.KERNEL, 0),
        "gemm": launches.get(qm.GEMM, 0), "spec_launches": pool.spec_launches,
    }
    drafts = [a["dispatches"].get("draft", 0) for a in autopsies]
    families = {name: _metric_sum(text, name) for name in (
        "serve_spec_proposed_total", "serve_spec_accepted_total", "serve_spec_rollbacks_total",
        "serve_spec_acceptance_rate", "serve_spec_dispatches_per_token")}
    rec = {"spec_windows": w, "plain_steps": steps, "expected": want, "counted": got,
           "autopsy_drafts": drafts, "spec_snapshot": snap, "spec_families": families}
    gauges = [line.split(" ")[0] for line in text.splitlines()
              if line.startswith("serve_spec_acceptance_rate ")
              or line.startswith("serve_spec_dispatches_per_token ")]
    if (got != want or sum(plain.values()) or w == 0
            or drafts != [1 if i in SPEC_INTERACTIVE else 0 for i in range(len(bodies))]
            or len(gauges) != 2 or families["serve_spec_proposed_total"] != snap["spec_proposed"]
            or families["serve_spec_accepted_total"] != snap["spec_accepted"]
            or families["serve_spec_rollbacks_total"] != snap["spec_rollbacks"]
            or snap["spec_rollbacks"] == 0):
        raise AssertionError(f"speculative run's counts off: {rec}, plain calls {plain}, "
                             f"gauges {gauges}")
    return rec


def phase_speculative(model, draft, card):
    """Phase 7d: speculative serving at 7B width (module docstring)."""

    from tf_operator_tpu_torch.serve_lm import build_parser, build_pool

    runs = []
    for side in SPEC_ORDER:
        runs.append(_spec_run(model, draft, side))
        # the run's pool lives in cycles (its server's threads, the
        # recording wait): collected here, once the run's frame is gone,
        # so that its arenas are free before the next run's
        free_device_memory()
    # one speculative window of 8 interactive seats under the profiler
    pool = build_pool(model, build_parser().parse_args(
        ["--batching", "8", "--speculative", "--spec-k", str(SPEC_K)]), draft=draft)
    phase_decode_profile(pool, tier="interactive")
    del pool
    free_device_memory()
    for r in runs:
        log(f"speculative run ({card}) " + json.dumps({k: v for k, v in r.items()
                                                       if k != "samples"}))
    plain = next(r for r in runs if r["side"] == "plain")["samples"]
    bodies = _spec_bodies()
    divergences = []
    seeded = [i for i, b in enumerate(bodies) if b.get("temperature")]
    for r in runs:
        if r["side"] != "spec":
            continue
        for i, (got, want) in enumerate(zip(r["samples"], plain)):
            if i in seeded or got == want:
                continue
            prompt = np.frombuffer(bodies[i]["prompt"].encode(), np.uint8).astype(np.int64)
            d = _spec_divergence(model, prompt, got, want)
            d["request"] = i
            divergences.append(d)
    spec_runs = [r for r in runs if r["side"] == "spec"]
    seeded_samples = {tuple(r["samples"][i]) for r in spec_runs for i in seeded}
    support = {}
    for i in seeded:
        prompt = np.frombuffer(bodies[i]["prompt"].encode(), np.uint8).astype(np.int64)
        support[i] = _spec_support(model, prompt, spec_runs[0]["samples"][i],
                                   bodies[i]["top_k"])
    summary = {}
    for side in ("plain", "spec"):
        mine = [r for r in runs if r["side"] == side]
        summary[side] = {}
        for key in ("interactive_decode_tokens_per_s", "interactive_ttft_s",
                    "decode_tokens_per_s", "window_ms"):
            xs = [r[key] for r in mine]
            summary[side][key] = {"median": statistics.median(xs),
                                  "spread": max(xs) - min(xs), "runs": xs}
    snaps = [r["spec_snapshot"] for r in spec_runs]
    for key in ("acceptance_rate", "dispatches_per_token", "launches_per_token"):
        xs = [s[key] for s in snaps]
        summary["spec"][key] = {"median": statistics.median(xs),
                                "spread": max(xs) - min(xs), "runs": xs}
    speedup = (summary["spec"]["interactive_decode_tokens_per_s"]["median"]
               / summary["plain"]["interactive_decode_tokens_per_s"]["median"])
    rec = {"summary": summary, "spec_paged_speedup": speedup,
           "greedy_divergences": divergences, "seeded_repeats": len(seeded_samples) == 1,
           "seeded_support_margin": support}
    log(f"speculative vs plain ({card}) " + json.dumps(rec))
    name, limit = [x.strip() for x in card.split(",")]
    log("spec record " + json.dumps({"spec_paged_speedup": {
        "value": speedup, "card": name, "power_limit": limit,
        "date": time.strftime("%Y-%m-%d"), "artifact": "chip_smoke.py phase 7d",
        "config": f"llama_7b_shape bf16 target, int8 self-draft, spec_k {SPEC_K}, 8 slots, "
                  "6 interactive speculating + 3 batch plain, interactive decode tokens/s "
                  f"(medians of {SPEC_ORDER.count('spec')} speculative runs and "
                  f"{SPEC_ORDER.count('plain')} plain)"}}))
    if any(not d["tie"] for d in divergences):
        raise AssertionError(f"speculative greedy rows off the plain pool's: {divergences}")
    if len(seeded_samples) != 1 or any(m < -SPEC_SUPPORT_TOL for m in support.values()):
        raise AssertionError(f"the seeded speculative request: samples {seeded_samples}, "
                             f"support margins {support}")
    return rec


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
               timed=False, queued=False):
    """K1-K3 at one shape against their plain versions; ``timed``: each
    kernel's, its plain version's and SDPA's times beside the bound;
    ``queued``: also each kernel's and SDPA's device time with their
    launches queued behind a device sleep (``device_ms``), for shapes
    whose kernels take less than their wrappers' host time."""

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
            if queued:
                dev_ms = time_ms_queued(kernel_fn[kname])
                rec["timing"][kname]["device_ms"] = dev_ms
                rec["timing"][kname]["device_share_of_bound"] = max(t_ops, t_bytes) / dev_ms
        rec["sdpa_ms"] = library
        if queued:
            rec["sdpa_device_ms"] = {
                "fwd": time_ms_queued(lambda: sdpa(q, k, v, is_causal=causal,
                                                   enable_gqa=hkv != h)),
                "bwd": time_ms_queued(lambda: torch.autograd.grad(so, (sq_, sk_, sv_), do,
                                                                  retain_graph=True))}
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


def check_loop_records(loop, steps, k, tag):
    """``train_loop``'s records of one run (its ``stats``): every step's
    loss resolved, the sentinel observed ``train_sync`` once a window
    and froze its drift reference (``SENTINEL_WARMUP`` windows) with
    windows after it, the sync ledger counted one ``window`` resolve a
    window but the last and one ``final``, the exported
    ``train_sync_total{phase}`` moved by as much, and the heartbeat beat
    once a window.  Returns them with the drift ratio."""

    from tf_operator_tpu_torch.utils.metrics import default_metrics

    windows = -(-steps // k)
    ledger, snap = loop["sync_ledger"], loop["sentinel"].snapshot().get("train_sync", {})
    rec = {"windows": windows, "observations": snap.get("observations"),
           "sync": {p: ledger.count(p) for p in ("step", "window", "final")},
           "train_sync_total": {p: default_metrics.counter("train_sync_total", phase=p)
                                - loop["train_sync_total_before"].get(p, 0.0)
                                for p in ("window", "final")},
           "heartbeat_beats": loop["heartbeat_beats"],
           "drift_ratio": snap.get("drift_ratio"), "p50_s": snap.get("p50_seconds"),
           "reference_p50_s": snap.get("reference_p50_seconds")}
    log(f"{tag} loop records ({card_line()}) " + json.dumps(rec))
    if (loop["resolved_at"][-1][0] != steps or rec["observations"] != windows
            or rec["drift_ratio"] is None or windows <= SENTINEL_WARMUP
            or rec["sync"] != {"step": 0, "window": windows - 1, "final": 1}
            or rec["train_sync_total"] != {"window": windows - 1, "final": 1}
            or rec["heartbeat_beats"] != windows):
        raise AssertionError(f"{tag}: train_loop's records {json.dumps(rec)}")
    return rec


def _sync_totals():
    from tf_operator_tpu_torch.utils.metrics import default_metrics

    return {p: default_metrics.counter("train_sync_total", phase=p) for p in ("window", "final")}


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
    before = _sync_totals()
    out = llama_pretrain.run(args)
    torch.cuda.synchronize()
    out["loop"]["train_sync_total_before"] = before
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
    stats["loop_records"] = check_loop_records(out["loop"], steps, args.steps_per_sync,
                                               "llama train")
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


#: phase 14: K1-K3 at the encoder workloads' attention shapes (bf16, D
#: 64, non-causal): BERT-base at seq 128 x batch 32, ViT-B/16 at 224 px
#: (196 patches: the second 128-row tile holds 68 rows) x batch 32, and
#: T5-base's cross-attention (decoder 32 against encoder 64, batch 4)
ENCODER_FLASH = (
    ("bert_base_s128_b32", dict(b=32, h=12, hkv=12, sq=128, sk=128, d=64)),
    ("vit_b16_s196_b32", dict(b=32, h=12, hkv=12, sq=196, sk=196, d=64)),
    ("t5_base_cross_sq32_sk64_b4", dict(b=4, h=12, hkv=12, sq=32, sk=64, d=64)),
)
#: phase 14's training runs: steps of train_loop (the loss guard needs 20
#: or more), resolved in windows of 5
ENCODER_STEPS = 40
#: T5's self-attentions carry the relative-position bias and run the
#: plain attention: one call a layer of each stack a forward
T5_PLAIN_PER_FORWARD = 24


def encoder_flops_per_example(family, cfg, **shape):
    """Model flops of one trained example (forward + backward = 3x the
    forward), phase 5's definition: 6 x the matmul parameters each token
    passes through (no embedding gather), plus the attention products,
    2 x 2 * H * D flops a (query, key) pair x 3, non-causal (a causal
    pair counted half, as phase 5 counts it)."""

    e, h, d, m, n = cfg.hidden, cfg.n_heads, cfg.head_dim, cfg.mlp_dim, cfg.n_layers
    hd = h * d
    layer = 4 * e * hd + 2 * e * m
    pair = 12 * hd
    if family == "bert":
        s = shape["seq"]
        return s * (6.0 * (n * layer + e * e + e * cfg.vocab_size) + n * pair * s)
    if family == "vit":
        s, p = shape["patches"], shape["patch"]
        return 6.0 * (s * (p * p * 3 * e + n * layer) + e * shape["classes"]) + n * pair * s * s
    se, sd = shape["enc"], shape["dec"]
    matmul = (se * n * layer + sd * n * (layer + 2 * e * hd) + se * n * 2 * e * hd
              + sd * e * cfg.vocab_size)
    return 6.0 * matmul + n * pair * (se * se + sd * sd / 2 + sd * se)


def _encoder_run(name, entry, argv, family, shape, per_example):
    """One encoder entry through its own ``run`` at full width: counts
    zeroed just before and read just after; K1-K3 must each launch 12 x
    the train steps run (the loop's and, for ViT, the benchmark's), the
    plain attention only where the family's biased self-attentions send
    it (T5: ``T5_PLAIN_PER_FORWARD`` calls a step), and the loss must
    fall."""

    from tf_operator_tpu_torch.ops import _build
    from tf_operator_tpu_torch.ops import flash_attention as fa

    args = entry.parse_args(argv)
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    _build.launches.clear()
    fa.plain_calls.clear()
    out = entry.run(args)
    torch.cuda.synchronize()
    launches = {k: _build.launches.get(k, 0) for k in FLASH_KERNELS}
    plain = dict(fa.plain_calls)
    trainer, losses = out["trainer"], out["losses"]
    cfg = trainer.model.cfg
    steps = trainer.host_step
    step_s = _steady_step_s(out["resolved_at"])
    rows = next(iter(out["batch"].values())).shape[0]
    flops = per_example * rows / step_s
    rec = {"model": name, "layers": cfg.n_layers, "dropout": cfg.dropout, "shape": shape,
           "rows": rows, "steps": steps, "params": sum(p.numel() for p in trainer.params),
           "loss_first": losses[0], "loss_last5": sum(losses[-5:]) / 5,
           "losses": [round(x, 4) for x in losses], "launches": launches,
           "plain_calls": plain, "wall_s": out["wall_s"], "step_ms": step_s * 1e3,
           "examples_per_s": rows / step_s, "flops_per_example": per_example,
           "model_tflops": flops / 1e12, "peak_share": flops / PEAK_OPS[torch.bfloat16],
           "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30}
    if "benchmark" in out:
        rec["benchmark"] = out["benchmark"]
    log(f"encoder train ({card_line()}) " + json.dumps(rec))
    want = cfg.n_layers * steps
    for kname in FLASH_KERNELS:
        if launches[kname] != want:
            raise AssertionError(f"{name}: {kname} launched {launches[kname]} times; "
                                 f"{cfg.n_layers} layers x {steps} steps = {want}")
    want_plain = {"dot_product_attention": T5_PLAIN_PER_FORWARD * steps} if family == "t5" else {}
    if {k: v for k, v in plain.items() if v} != want_plain:
        raise AssertionError(f"{name}: plain attention calls {plain}, want {want_plain}")
    if not rec["loss_last5"] < rec["loss_first"]:
        raise AssertionError(f"{name}: the loss did not fall: {losses}")
    return rec, trainer, out["batch"]


#: the targets phase 6's llama parity averages its loss over (4 rows x
#: 2047 next tokens), on which ``PARITY_RTOL`` was read
LLAMA_PARITY_TARGETS = 4 * 2047


def _plain_forward_bf16_p(q, k, v, causal=False, window=None):
    """K1's plain version with the probabilities rounded to q's dtype
    before the PV product (its row sums float32), the rounding K1's
    tensor cores take: the plain step under it shows how far one such
    rounding choice moves a loss."""

    from tf_operator_tpu_torch.ops import flash_attention as fa

    fa.plain_calls[fa.KERNEL_FWD] += 1
    b, h, sq, d = q.shape
    logits = fa._logits(q, k, causal, window)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-37)
    out = torch.matmul(p.to(q.dtype).float(), v.float()[:, :, None]) / l
    return out.reshape(b, h, sq, d).to(q.dtype), (m + torch.log(l))[..., 0].reshape(b, h, sq)


def _float32_plain(cfg):
    """``cfg`` computing in float32 with the plain attention."""

    import dataclasses

    if hasattr(cfg, "base"):
        return dataclasses.replace(cfg, base=_float32_plain(cfg.base))
    return dataclasses.replace(cfg, dtype=torch.float32, plain_kernels=True)


def _encoder_parity(name, family_cls, cfg, loss_fn, batch, targets, lr):
    """The first step through the kernels against the same step with the
    plain attention (same weights at dropout 0, same batch; only the
    attention differs): the loss and the grad norm each at its
    ``PARITY_RTOL`` x sqrt(``LLAMA_PARITY_TARGETS`` / ``targets``).  Both
    are means over ``targets`` of what the attention's roundings move, so
    their differences shrink as the square root of that count, and
    llama's tolerances were read over 8,188 targets.  Printed beside:
    ``p_rounding``, how far rounding P to bf16 in the plain forward
    (``_plain_forward_bf16_p``) moves the same loss, one rounding choice
    at this count; and the same step in float32 with the plain
    attention, against which each bf16 step's loss and grad norm show
    what computing in bf16 moves at all."""

    from tf_operator_tpu_torch.models.weights import init_params
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.parallel.trainer import Trainer, TrainerConfig

    dev = torch.device("cuda")
    state = init_params(cfg, 0, dev, trainable=True, family=family_cls)
    model = family_cls.from_state_dict(cfg, state, dev, trainable=True)
    tcfg = TrainerConfig(learning_rate=lr)
    got = Trainer(model, tcfg, loss_fn).compute_grads(batch)
    plain_model = model.variant(plain_kernels=True)
    fa.plain_calls.clear()
    want = Trainer(plain_model, tcfg, loss_fn).compute_grads(batch)
    layers = (cfg.base if hasattr(cfg, "base") else cfg).n_layers
    if fa.plain_calls[fa.KERNEL_FWD] != layers:
        raise AssertionError(f"{name}: the plain step did not run the plain attention: "
                             f"{dict(fa.plain_calls)}")
    exact, fa.flash_forward_plain = fa.flash_forward_plain, _plain_forward_bf16_p
    try:
        with torch.no_grad():
            rounded = float(loss_fn(plain_model, batch)[0])
    finally:
        fa.flash_forward_plain = exact
    f32 = family_cls.from_state_dict(_float32_plain(cfg), state, dev, trainable=True)
    del state
    truth = Trainer(f32, tcfg, loss_fn).compute_grads(batch)
    del f32
    free_device_memory()
    rec = {"targets": targets,
           "p_rounding": {"plain_bf16_p": rounded,
                          "rel": abs(rounded - float(want["loss"])) / abs(float(want["loss"])),
                          "kernels_rel": abs(float(got["loss"]) - rounded) / abs(rounded)},
           "float32": {key: {"value": float(truth[key]),
                             "kernels_rel": abs(float(got[key]) / float(truth[key]) - 1),
                             "plain_rel": abs(float(want[key]) / float(truth[key]) - 1)}
                       for key in PARITY_RTOL}}
    scale = math.sqrt(LLAMA_PARITY_TARGETS / targets)
    tols = {key: tol * scale for key, tol in PARITY_RTOL.items()}
    for key, tol in tols.items():
        a, b = float(got[key]), float(want[key])
        rec[key] = {"kernels": a, "plain": b, "rel": abs(a - b) / abs(b), "tol": tol}
    log(f"{name} one-step parity (dropout 0) " + json.dumps(rec))
    for key in tols:
        r = rec[key]
        if not (math.isfinite(r["rel"]) and r["rel"] <= r["tol"]):
            raise AssertionError(f"{name} one-step parity: {key} off the plain step: {rec}")
    return rec


def phase_encoders(card):
    """Phase 14: the reference's encoder workloads at full width.  (a) K1-K3
    at the three attention shapes against their plain versions, timed
    beside their bounds and SDPA; (b) ``bert_pretrain`` at bert_base,
    seq 128 x batch 32; (c) ``t5_multihost`` at t5_base (the entry's
    defaults: batch 4, encoder 64, decoder 32); (d) ``vit_classify`` at
    vit_b16, 224 px x batch 32, 1000 classes (then its benchmark line):
    each through its entry point at dropout 0.1 and its entry's optimizer
    (``_encoder_run``), then its one-step parity at dropout 0
    (``_encoder_parity``).  Returns the flash records and the runs."""

    from tf_operator_tpu_torch import bert_pretrain, t5_multihost, vit_classify
    from tf_operator_tpu_torch.models import bert, t5, vit

    flash = [flash_case(n, seed=100 + i, dtype=torch.bfloat16, causal=False, timed=True,
                        queued=True, **kw)
             for i, (n, kw) in enumerate(ENCODER_FLASH)]
    log(f"encoder flash shapes ({card}) " + json.dumps(
        {r["case"]: {**{k: {f: round(t[f], 5) for f in ("ms", "device_ms", "bound_ms",
                                                         "plain_ms", "library_ms")}
                        | {"bound_by": t["bound_by"]} for k, t in r["timing"].items()},
                     "sdpa_device_ms": r["sdpa_device_ms"]} for r in flash}))
    steps = ["--steps", str(ENCODER_STEPS), "--steps-per-sync", "5"]
    runs = {}
    bcfg = bert.bert_base(max_len=128)
    runs["bert_pretrain"], trainer, batch = _encoder_run(
        "bert_base", bert_pretrain,
        ["--model", "bert_base", "--seq-len", "128", "--batch-per-device", "32"] + steps,
        "bert", {"seq": 128}, encoder_flops_per_example("bert", bcfg, seq=128))
    del trainer
    free_device_memory()
    runs["bert_pretrain"]["parity"] = _encoder_parity(
        "bert_base", bert.BertForPretraining, bert.bert_base(max_len=128, dropout=0.0),
        bert.mlm_loss, batch, int((batch["labels"] >= 0).sum()), 1e-4)
    del batch
    tcfg = t5.t5_base()
    runs["t5_multihost"], trainer, batch = _encoder_run(
        "t5_base", t5_multihost, ["--model", "t5_base"] + steps, "t5",
        {"enc": 64, "dec": 32}, encoder_flops_per_example("t5", tcfg, enc=64, dec=32))
    del trainer
    free_device_memory()
    runs["t5_multihost"]["parity"] = _encoder_parity(
        "t5_base", t5.T5, t5.t5_base(dropout=0.0), t5.seq2seq_loss, batch,
        batch["targets"].numel(), 1e-4)
    del batch
    vcfg = vit.vit_b16()
    runs["vit_classify"], trainer, batch = _encoder_run(
        "vit_b16", vit_classify,
        ["--model", "vit_b16", "--image-size", "224", "--num-classes", "1000",
         "--batch-per-device", "32"] + steps, "vit",
        {"patches": 196, "patch": 16, "classes": 1000},
        encoder_flops_per_example("vit", vcfg.base, patches=196, patch=16, classes=1000))
    del trainer
    free_device_memory()
    runs["vit_classify"]["parity"] = _encoder_parity(
        "vit_b16", vit.ViT, vit.vit_b16(dropout=0.0), vit.vit_loss, batch,
        batch["label"].numel(), 3e-3)
    del batch
    free_device_memory()
    return flash, runs


# -- phase 15: the decoder zoo ------------------------------------------------

#: phase 15's attention shapes: gpt_small's training step (and the
#: 8-expert moe's at its widths), and moe_tiny's as llama_pretrain
#: --family moe trains it (batch 8 x seq 128)
ZOO_FLASH = (
    ("gpt_small_causal_b8_s1024_d64", dict(b=8, h=12, hkv=12, sq=1024, sk=1024, d=64)),
    ("moe_tiny_causal_b8_s128_d32", dict(b=8, h=4, hkv=4, sq=128, sk=128, d=32)),
)
#: K7 at gpt_small's int8 projections, decode rows (M 8): q/k/v/out
#: 768 x 768, wi 768 x 3072, wo 3072 x 768 (K x N)
ZOO_K7 = ((768, 768), (768, 3072), (3072, 768))
#: gpt's int8 projections a layer (q, k, v, out, wi, wo; the tied head
#: stays bf16): K7 launches a forward = 6 x 12 at gpt_small
GPT_INT8_PROJ = 6
#: phase 15's training runs: rows x seq of a step, steps, and the
#: optimizer (a short warmup, so that a few steps move the loss)
ZOO_ROWS, ZOO_SEQ = 8, 1024
ZOO_GPT_STEPS, ZOO_MOE_STEPS = 30, 12
ZOO_TRAIN_CFG = dict(learning_rate=1e-3, warmup_steps=2)
#: the 2-rank llama_pretrain --family moe job's steps (dropout 0, the
#: one-process yardstick on both ranks' rows at once)
ZOO_JOB_STEPS = 6
#: the kernels line's K1-K3 paths of phase 15: (path, its run's key)
ZOO_TRAIN_PATHS = (("gpt_small_train", "gpt_small_train"),
                   ("llama_pretrain_moe", "moe_tiny"),
                   ("moe_gpt_small_train", "moe_gpt_small_train"))


def _zoo_bodies():
    """Phase 7's requests whose prompt and 32 new bytes fit the learned
    table's 1,024 positions."""

    return [b for b in _main_bodies() if len(b["prompt"].encode()) + 32 <= ZOO_SEQ]


def _zoo_train(name, family_cls, cfg, loss_fn, data_dir, steps):
    """``steps`` Trainer steps of ``family_cls`` on ``cfg`` (seeded,
    float32 masters, bf16 compute, dropout 0.1) at ``ZOO_ROWS`` x
    ``ZOO_SEQ`` rows of the byte corpus.  Counts zeroed just before and
    read just after: K1-K3 must each launch layers x steps times and the
    plain attention never; the loss must fall.  Returns the record and
    the trainer."""

    from tf_operator_tpu_torch.data.text import TextBatches, as_lm_batches
    from tf_operator_tpu_torch.models.weights import init_params
    from tf_operator_tpu_torch.ops import _build
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.parallel.trainer import Trainer, TrainerConfig

    dev = torch.device("cuda")
    model = family_cls.from_state_dict(
        cfg, init_params(cfg, 0, dev, trainable=True, family=family_cls), dev, trainable=True)
    trainer = Trainer(model, TrainerConfig(**ZOO_TRAIN_CFG), loss_fn)
    batches = iter(as_lm_batches(TextBatches(data_dir, ZOO_ROWS, seed=0)))
    base = model.cfg
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    _build.launches.clear()
    fa.plain_calls.clear()
    losses, stamps = [], []
    for _ in range(steps):
        out = trainer.train_step(next(batches))
        losses.append(float(out["loss"]))  # resolves the step
        stamps.append(time.perf_counter())
    torch.cuda.synchronize()
    launches = {k: _build.launches.get(k, 0) for k in FLASH_KERNELS}
    plain = {k: v for k, v in fa.plain_calls.items() if v}
    step_s = (stamps[-1] - stamps[0]) / (steps - 1)
    tokens = ZOO_ROWS * ZOO_SEQ
    rec = {"model": name, "layers": base.n_layers, "rows": ZOO_ROWS, "seq": ZOO_SEQ,
           "steps": steps, "params": sum(p.numel() for p in trainer.params),
           "dropout": base.dropout, "loss_first": losses[0],
           "loss_last3": sum(losses[-3:]) / 3, "losses": [round(x, 4) for x in losses],
           "launches": launches, "plain_calls": plain, "step_ms": step_s * 1e3,
           "tokens_per_s": tokens / step_s,
           "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30}
    if "moe_aux_loss" in out:
        rec["moe_aux_loss_last"] = float(out["moe_aux_loss"])
    log(f"zoo train ({card_line()}) " + json.dumps(rec))
    want = base.n_layers * steps
    if any(n != want for n in launches.values()) or plain:
        raise AssertionError(f"{name}: K1-K3 launched {launches} (want {want} each), "
                             f"plain attention {plain}")
    if not (all(math.isfinite(x) for x in losses) and rec["loss_last3"] < losses[0]):
        raise AssertionError(f"{name}: the loss did not fall: {losses}")
    return rec, trainer


def _zoo_serve(model, flags, bodies, tag, at_once=False, new_tokens=32):
    """``serve_lm`` built from ``flags`` around ``model`` answers
    ``bodies`` (``new_tokens`` each) over HTTP (one at a time, or all at
    once); counts zeroed just before and read just after.  Returns (the
    decoder, the token rows by body, the run's record)."""

    import contextlib
    import io

    from tf_operator_tpu_torch.ops import _build
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.ops import quant_matmul as qm
    from tf_operator_tpu_torch.serve_lm import (
        Server,
        build_decoder,
        build_parser,
        model_label_of,
    )

    args = build_parser().parse_args(flags)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        decoder = build_decoder(model, args)
    pool = getattr(decoder, "slots", None) is not None
    rows = record_rows(decoder) if pool else collections.defaultdict(list)
    if not pool:
        generate = decoder.generate

        def recording(prompt_ids, n, **kw):
            got = generate(prompt_ids, n, **kw)
            rows[bytes(prompt_ids[0].tolist())].append(got[0, prompt_ids.shape[1]:].tolist())
            return got

        decoder.generate = recording
    server = Server(decoder, model_label=model_label_of(args)).start()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.launches.clear()
        fa.plain_calls.clear()
        qm.plain_calls.clear()
        t0 = time.perf_counter()
        results = (_send_at_once if at_once else _send_each)(server.port, bodies)
        wall = time.perf_counter() - t0
        launches = dict(_build.launches)
        plain = {k: v for k, v in list(fa.plain_calls.items()) + list(qm.plain_calls.items())
                 if v}
        if server.fatal:
            raise AssertionError(f"{tag}: decode loop died: {server.fatal[0]}")
        for i, r in enumerate(results):
            if r is None or r[0] != 200 or len(r[1]["sample"]) != new_tokens:
                raise AssertionError(f"{tag}: request {i} failed: {r}")
    finally:
        server.close()
    if pool:
        autopsies = [decoder.request_log.get(r[1]["request_id"]) for r in results]
        got_rows = [rows[a["rid"]][a["prompt_tokens"]:].tolist() for a in autopsies]
        seconds = decoder.ledger.seconds("step")
        decode_tokens = sum(a["tokens"] - 1 for a in autopsies)
    else:
        got_rows = [rows[b["prompt"].encode()][0] for b in bodies]
        seconds = decoder.ledger.seconds("decode")
        decode_tokens = (new_tokens - 1) * len(bodies)
    rec = {"tag": tag, "flags": flags, "decoder": type(decoder).__name__,
           "line": out.getvalue().strip(), "requests": len(bodies), "wall_s": wall,
           "launches": launches, "plain_calls": plain,
           "decode_tokens_per_s": decode_tokens / seconds,
           "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30}
    return decoder, got_rows, rec


def _gpt_serving(export_dir, trainer, card):
    """(b) the exported gpt_small artifact behind ``serve_lm``: bf16
    chunked (``--batching 0``), ``--batching 8`` (the contiguous pool
    after the fallback line) and ``--quantize int8`` (chunked; K7 =
    ``GPT_INT8_PROJ`` x (decode steps + prefill chunks of <= 64 rows),
    the GEMM route x the wider chunks), each request's greedy row against
    the chunked bf16 rows (equal, or a bf16 tie), the int8 rows against
    the same decoder with K7's plain version."""

    from tf_operator_tpu_torch.models.decode import ChunkedServingDecoder, generate
    from tf_operator_tpu_torch.ops import quant_matmul as qm
    from tf_operator_tpu_torch.serve_lm import load_model

    dev = torch.device("cuda")
    bodies = _zoo_bodies()
    flags = ["--artifact", export_dir, "--max-len", str(ZOO_SEQ)]
    model = load_model(dev, max_len=ZOO_SEQ, artifact=export_dir)
    _, chunked_rows, chunked = _zoo_serve(model, flags, bodies, "gpt_small chunked bf16")
    # the served rows against in-process generate on the trained weights
    first = np.frombuffer(bodies[0]["prompt"].encode(), np.uint8).astype(np.int64)
    in_process = generate(trainer.model, torch.as_tensor(first, device=dev)[None], 32)
    chunked["first_row_equals_generate"] = in_process[0, first.size:].tolist() == chunked_rows[0]
    pool, pool_rows, contiguous = _zoo_serve(model, flags + ["--batching", "8"], bodies,
                                             "gpt_small contiguous bf16", at_once=True)
    contiguous["against_chunked"] = _greedy_against(model, bodies, pool_rows, chunked_rows,
                                                    "gpt_small contiguous")
    contiguous["dispatches"] = {p: pool.ledger.count(p) for p in ("admission", "step")}
    del pool
    int8_model = load_model(dev, max_len=ZOO_SEQ, artifact=export_dir, quantize="int8")
    _, int8_rows, int8 = _zoo_serve(int8_model, flags + ["--quantize", "int8"], bodies,
                                    "gpt_small chunked int8")
    plain = ChunkedServingDecoder(int8_model.variant(plain_kernels=True))
    plain_rows = []
    for b in bodies:
        ids = torch.as_tensor(np.frombuffer(b["prompt"].encode(), np.uint8).astype(np.int64))
        gen = None
        if b.get("temperature"):
            gen = torch.Generator(device=dev).manual_seed(b["seed"])
        got = plain.generate(ids[None], 32, temperature=b.get("temperature", 0.0),
                             top_k=b.get("top_k"), generator=gen)
        plain_rows.append(got[0, ids.numel():].tolist())
    int8["against_plain_k7"] = _greedy_against(int8_model, bodies, int8_rows, plain_rows,
                                               "gpt_small int8")
    counts = _chunk_counts(bodies)
    steps = 31 * len(bodies)
    n_proj = GPT_INT8_PROJ * int8_model.cfg.n_layers
    int8["expected"] = {qm.KERNEL: n_proj * (steps + counts["short"]),
                        qm.GEMM: n_proj * counts["long"]}
    runs = {"chunked_bf16": chunked, "contiguous_bf16": contiguous, "chunked_int8": int8}
    log(f"zoo gpt_small serving ({card}) " + json.dumps(runs))
    line = contiguous["line"]
    if (chunked["decoder"] != "ChunkedServingDecoder" or chunked["launches"]
            or chunked["plain_calls"] or not chunked["first_row_equals_generate"]):
        raise AssertionError(f"gpt_small chunked: {json.dumps(chunked)}")
    if (contiguous["decoder"] != "ContinuousBatchingDecoder"
            or not line.startswith("paged pool unavailable (CausalLM is not pageable")
            or not line.endswith("; serving the contiguous slot pool")
            or contiguous["launches"] or contiguous["plain_calls"]
            or contiguous["dispatches"]["admission"] != len(bodies)):
        raise AssertionError(f"gpt_small contiguous: {json.dumps(contiguous)}")
    if int8["launches"] != {k: v for k, v in int8["expected"].items() if v} \
            or int8["plain_calls"]:
        raise AssertionError(f"gpt_small int8: K7 launches {int8['launches']}, want "
                             f"{int8['expected']}, plain {int8['plain_calls']}")
    del int8_model, plain, model
    free_device_memory()
    return runs


def rank_moe(data_dir, rows):
    """One rank of phase 15's ``llama_pretrain --family moe`` job (or the
    one-process yardstick outside a job): dropout 0, ``ZOO_JOB_STEPS``
    steps, K1-K3 launches and the tag line."""

    from tf_operator_tpu_torch import llama_pretrain
    from tf_operator_tpu_torch.ops import _build
    from tf_operator_tpu_torch.runtime.bootstrap import world

    args = llama_pretrain.parse_args([
        "--family", "moe", "--batch-per-device", str(rows), "--steps", str(ZOO_JOB_STEPS),
        "--steps-per-sync", "1", "--data-dir", data_dir, "--generate", "0"])
    _build.launches.clear()
    out = llama_pretrain.run(args, dropout=0.0)
    torch.cuda.synchronize()
    rank, n = world()
    trainer = out["trainer"]
    rec = {"rank": rank, "world": n, "losses": out["losses"],
           "mesh": trainer.mesh.shape if trainer.mesh is not None else None,
           "launches": {k: _build.launches.get(k, 0) for k in FLASH_KERNELS},
           "step_ms": _steady_step_s(out["resolved_at"]) * 1e3}
    print("RANK " + json.dumps(rec), flush=True)
    return rec


def _moe_runs(tmp, card):
    """(c) ``llama_pretrain --family moe`` at the reference entry's
    defaults (moe_tiny, vocab 256, 4 experts, seq 128 x batch 8, 60
    steps, dropout 0.1) through its ``run``, then sampling; then as a
    2-rank job (dp 2, ep 1, gloo on the one card) at dropout 0 against
    the same run in one process on both ranks' rows (each loss within
    ``DIST_LOSS_RTOL``)."""

    from tf_operator_tpu_torch import llama_pretrain
    from tf_operator_tpu_torch.ops import _build
    from tf_operator_tpu_torch.ops import flash_attention as fa

    data_dir = os.path.join(tmp, "moe_text")
    args = llama_pretrain.parse_args(["--family", "moe", "--data-dir", data_dir,
                                      "--export-dir", os.path.join(tmp, "moe_tiny")])
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    _build.launches.clear()
    fa.plain_calls.clear()
    out = llama_pretrain.run(args)
    torch.cuda.synchronize()
    launches = {k: _build.launches.get(k, 0) for k in FLASH_KERNELS}
    losses = out["losses"]
    cfg = out["trainer"].model.cfg
    step_s = _steady_step_s(out["resolved_at"])
    with open(os.path.join(tmp, "moe_tiny", "model.json")) as f:
        family = json.load(f)["family"]
    alone = {"model": "moe_tiny", "experts": args.experts, "rows": args.batch_per_device,
             "seq": args.seq_len, "steps": args.steps, "dropout": cfg.dropout,
             "loss_first": losses[0], "loss_last5": sum(losses[-5:]) / 5,
             "launches": launches, "plain_calls": {k: v for k, v in fa.plain_calls.items()
                                                   if v},
             "exported_family": family, "sample": out["sample"], "step_ms": step_s * 1e3,
             "tokens_per_s": args.batch_per_device * args.seq_len / step_s,
             "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"zoo llama_pretrain --family moe ({card}) " + json.dumps(alone))
    want = cfg.n_layers * args.steps
    if (any(n != want for n in launches.values()) or alone["plain_calls"]
            or family != "moe" or not out["sample"]
            or not alone["loss_last5"] < losses[0]):
        raise AssertionError(f"llama_pretrain --family moe: {json.dumps(alone)}")
    code = f"import chip_smoke as c; c.rank_moe({data_dir!r}, {args.batch_per_device})"
    ranks = _run_ranks(2, code, "zoo moe job")
    yardstick = rank_moe(data_dir, 2 * args.batch_per_device)
    job = {"ranks": [{k: r[k] for k in ("rank", "world", "mesh", "losses", "launches",
                                        "step_ms")} for r in ranks],
           "tags": [any("[moe bytes dp=2 ep=1 E=4]" in ln for ln in r["lines"])
                    for r in ranks],
           "one_process_losses": yardstick["losses"],
           "max_loss_rel": max(abs(a - b) / abs(b) for r in ranks
                               for a, b in zip(r["losses"], yardstick["losses"])),
           "tol": DIST_LOSS_RTOL}
    log(f"zoo moe job ({card}) " + json.dumps(job))
    if (not all(job["tags"]) or not job["max_loss_rel"] <= DIST_LOSS_RTOL
            or any(r["mesh"] != {"pp": 1, "dp": 2, "fsdp": 1, "ep": 1, "sp": 1, "tp": 1}
                   or r["launches"] != {k: cfg.n_layers * ZOO_JOB_STEPS
                                        for k in FLASH_KERNELS} for r in ranks)):
        raise AssertionError(f"zoo moe job: {json.dumps(job)}")
    return alone, job


def _moe_gpt_small_serving(moe_dir, card):
    """(d)'s serving: the exported 8-expert artifact behind ``serve_lm
    --batching 8`` (the contiguous pool after the fallback line naming
    ``MoeLM``), each greedy row against the chunked decoder's on the same
    model (equal, or a bf16 tie); no kernel launches in decode."""

    from tf_operator_tpu_torch.models.decode import ChunkedServingDecoder
    from tf_operator_tpu_torch.serve_lm import load_model

    with open(os.path.join(moe_dir, "model.json")) as f:
        desc = json.load(f)
    model = load_model(torch.device("cuda"), max_len=ZOO_SEQ, artifact=moe_dir)
    bodies = _zoo_bodies()
    ref = ChunkedServingDecoder(model)
    ref_rows = []
    for b in bodies:
        ids = torch.as_tensor(np.frombuffer(b["prompt"].encode(), np.uint8).astype(np.int64))
        gen = None
        if b.get("temperature"):
            gen = torch.Generator(device=model.device).manual_seed(b["seed"])
        got = ref.generate(ids[None], 32, temperature=b.get("temperature", 0.0),
                           top_k=b.get("top_k"), generator=gen)
        ref_rows.append(got[0, ids.numel():].tolist())
    del ref
    pool, rows, served = _zoo_serve(
        model, ["--artifact", moe_dir, "--max-len", str(ZOO_SEQ), "--batching", "8"],
        bodies, "moe_gpt_small contiguous bf16", at_once=True)
    served["against_chunked"] = _greedy_against(model, bodies, rows, ref_rows,
                                                "moe_gpt_small contiguous")
    served["description"] = {k: desc[k] for k in ("family", "moe")}
    log(f"zoo moe_gpt_small serving ({card}) " + json.dumps(served))
    if (served["decoder"] != "ContinuousBatchingDecoder"
            or not served["line"].startswith("paged pool unavailable (MoeLM is not")
            or served["launches"] or served["plain_calls"]
            or desc["family"] != "moe" or desc["moe"]["num_experts"] != 8):
        raise AssertionError(f"moe_gpt_small serving: {json.dumps(served)}")
    del pool, model
    return served


def phase_zoo(card):
    """Phase 15: the decoder zoo at full width (module docstring).
    Returns the flash and K7 records and the runs, with the phase's
    walls by part."""

    import tempfile

    from tf_operator_tpu_torch.data.text import ensure_text
    from tf_operator_tpu_torch.models.gpt import CausalLM, gpt_small, lm_loss
    from tf_operator_tpu_torch.models.moe import MoeConfig, MoeLM, moe_lm_loss
    from tf_operator_tpu_torch.parallel.checkpoint import export_params

    t0 = time.perf_counter()
    walls = {}

    def mark(part):
        walls[part] = round(time.perf_counter() - t0 - sum(walls.values()), 3)

    flash = [flash_case(n, seed=150 + i, dtype=torch.bfloat16, causal=True, timed=True,
                        queued=True, **kw) for i, (n, kw) in enumerate(ZOO_FLASH)]
    log(f"zoo flash shapes ({card}) " + json.dumps(
        {r["case"]: {**{k: {f: round(t[f], 5) for f in ("ms", "device_ms", "bound_ms",
                                                         "plain_ms", "library_ms")}
                        | {"bound_by": t["bound_by"]} for k, t in r["timing"].items()},
                     "sdpa_device_ms": r["sdpa_device_ms"]} for r in flash}))
    k7 = [k7_case(f"gpt_small_m8_k{k}_n{n}_bf16", m=8, k=k, n=n, dtype=torch.bfloat16,
                  seed=150 + i, timed=True) for i, (k, n) in enumerate(ZOO_K7)]
    free_device_memory()
    mark("kernels")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_zoo_")
    runs = {}
    try:
        data_dir = os.path.join(tmp, "text")
        ensure_text(data_dir, seq_len=ZOO_SEQ)
        gcfg = gpt_small(vocab_size=256, max_len=ZOO_SEQ)
        runs["gpt_small_train"], trainer = _zoo_train("gpt_small", CausalLM, gcfg, lm_loss,
                                                      data_dir, ZOO_GPT_STEPS)
        export_dir = os.path.join(tmp, "gpt_small")
        export_params(trainer, export_dir)
        mark("gpt_small_train_export")
        runs["gpt_small_serving"] = _gpt_serving(export_dir, trainer, card)
        del trainer
        free_device_memory()
        mark("gpt_small_serving")
        runs["moe_tiny"], runs["moe_tiny_job"] = _moe_runs(tmp, card)
        free_device_memory()
        mark("llama_pretrain_moe_and_job")
        mcfg = MoeConfig(base=gpt_small(vocab_size=256, max_len=ZOO_SEQ), num_experts=8)
        runs["moe_gpt_small_train"], trainer = _zoo_train(
            "moe_gpt_small_e8", MoeLM, mcfg, moe_lm_loss, data_dir, ZOO_MOE_STEPS)
        moe_dir = os.path.join(tmp, "moe_gpt_small")
        export_params(trainer, moe_dir)
        del trainer
        free_device_memory()
        mark("moe_gpt_small_train_export")
        runs["moe_gpt_small_serving"] = _moe_gpt_small_serving(moe_dir, card)
        mark("moe_gpt_small_serving")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    free_device_memory()
    summary = {name: {k: r[k] for k in ("step_ms", "tokens_per_s", "max_memory_allocated_gib")}
               for name, r in (("gpt_small", runs["gpt_small_train"]),
                               ("moe_tiny", runs["moe_tiny"]),
                               ("moe_gpt_small_e8", runs["moe_gpt_small_train"]))}
    summary["wall_s"] = time.perf_counter() - t0
    summary["walls_s"] = walls
    log(f"zoo families ({card}) " + json.dumps(summary))
    return flash, k7, runs


# -- phase 16: LoRA fine-tuning and pipeline parallelism ----------------------

#: (a) lora_finetune over phase 5's llama-wide export at the entry's
#: defaults (batch 8, seq 128, rank 8, alpha 16, learning rate 1e-3)
LORA_STEPS, LORA_RANK = 40, 8
#: rank 8 over llama-wide: 7 kernels a layer x 12 and the lm_head (the
#: query [2048, 16, 128] gets a [32768, 8], b [8, 128]), and the base
LORA_ADAPTER_PARAMS, LORA_BASE_PARAMS = 9_205_760, 697_354_240
#: the merged artifact behind serve_lm --batching 8: three greedy
#: requests of LORA_NEW tokens each
LORA_BODIES = ({"prompt": "the operator ", "max_new_tokens": 16},
               {"prompt": "the sharded kernel gathers the ", "max_new_tokens": 16},
               {"prompt": "the fused gradient reduces ", "max_new_tokens": 16})
LORA_NEW = 16
#: (b) PipelinedLM at gpt_small's widths (vocab 256), 2 stages of 6
#: layers, relu, seq 1024 x 8 rows in 4 microbatches, PP_STEPS steps of
#: optax.adamw's form at PP_LR, on one fixed batch of the byte corpus
PP_ROWS, PP_SEQ, PP_MICROBATCHES, PP_STEPS, PP_LR = 8, 1024, 4, 6, 1e-3
#: (b) each step-0 gradient leaf a rank holds against the one process's,
#: |g - g_one| / |g_one| (L2 norms): the same bf16 arithmetic on 2-row
#: microbatches where the one process runs 8 rows, so products tiled
#: otherwise round otherwise.  Read 2.0e-3 on an H100 (a query bias);
#: chip_fault_probe.py's pp_input read 1.0 (the other stage's
#: positions), pp_output 1.0 (every stage's leaves)
PP_GRAD_RTOL = 2e-2
#: (b) each weight leaf after PP_STEPS steps, the same measure: in bf16
#: Adam carries the step-0 differences on and amplifies them where a
#: gradient is small.  Read 1.6e-2 / 2.0e-2 (key kernels); pp_input
#: 0.16, pp_output 3.1e-2 / 4.1e-2, under the limit: AdamW's update
#: hides a gradient's scale, so the gradients are held too
PP_WEIGHT_RTOL = 5e-2
#: (b) the leaves whose gradient is zero in exact arithmetic (a softmax
#: does not see a bias shared by every key), so that both runs' values
#: are rounding noise, far apart even in float32: both checks skip them.
#: The weight check also skips every leaf that starts at zero (the
#: biases): after PP_STEPS Adam steps such a leaf is all update, and in
#: bf16 Adam's normalisation turns small differences of small gradients
#: into whole steps of the learning rate; their gradients hold them
PP_ZERO_GRAD = ".self_attn.key.bias"
#: (c) gpt_pipeline --pp 2 at its defaults, each family as a 2-process job
PIPE_JOB_STEPS = 10
#: K1-K3 at phase 16's shapes: the LoRA step's attention (llama-wide,
#: batch 8 x seq 128) and a pipeline microbatch at gpt_small's widths
PHASE16_FLASH = (
    ("lora_llama_wide_causal_b8_s128_d128", dict(b=8, h=16, hkv=8, sq=128, sk=128, d=128)),
    ("pp_gpt_small_microbatch_causal_b2_s1024_d64",
     dict(b=2, h=12, hkv=12, sq=1024, sk=1024, d=64)),
)


def _param_digest(model):
    """{name: (sum of the int32 view, float64 sum of |x|)} of every
    parameter, on the device: any write to a float32 tensor moves it."""

    return {n: (int(p.detach().view(torch.int32).to(torch.int64).sum()),
                float(p.detach().double().abs().sum())) for n, p in model.named_parameters()}


def phase_lora(base_dir, card):
    """(a) ``lora_finetune`` over phase 5's llama-wide export (module
    docstring): the adapter count, step 0's logits bit for bit the
    base's, the loss falling, every base tensor unchanged, K1-K3 = 12
    layers x steps each (``generate`` decodes through the contiguous
    cache's plain product: no launch); then the merged artifact behind
    ``serve_lm --batching 8`` (the paged pool, K4 = 12 x decode steps),
    its greedy rows against ``generate`` on the merged model (equal, or
    a bf16 tie)."""

    import contextlib
    import io
    import tempfile

    from tf_operator_tpu_torch import lora_finetune
    from tf_operator_tpu_torch.data.text import TextBatches, as_lm_batches
    from tf_operator_tpu_torch.models.decode import generate
    from tf_operator_tpu_torch.ops import _build
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.ops.paged_attention import KERNEL
    from tf_operator_tpu_torch.serve_lm import load_model

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lora_")
    try:
        tuned = os.path.join(tmp, "tuned")
        args = lora_finetune.parse_args([
            "--base", base_dir, "--steps", str(LORA_STEPS), "--rank", str(LORA_RANK),
            "--data-dir", os.path.join(tmp, "text"), "--export-dir", tuned])
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            run = lora_finetune.setup(args)
        lora, base = run["lora"], run["base"]
        setup_s = time.perf_counter() - t0
        before = _param_digest(base)
        probe = next(iter(as_lm_batches(TextBatches(args.data_dir, args.batch, seed=99))))
        ids = torch.as_tensor(probe["input_ids"], device="cuda").long()
        with torch.no_grad():
            step0_equal = bool(torch.equal(lora(ids), base(ids)))
        del ids
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.launches.clear()
        fa.plain_calls.clear()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            lora_finetune.finish(args, run)
        torch.cuda.synchronize()
        finish_s = time.perf_counter() - t1
        launches = {k: _build.launches.get(k, 0) for k in FLASH_KERNELS}
        plain = {k: v for k, v in fa.plain_calls.items() if v}
        unchanged = _param_digest(base) == before
        lines = out.getvalue().splitlines()
        losses = run["losses"]
        steps_lines = [ln for ln in lines if ln.startswith("step ")]
        rec = {"base": base_dir, "lines": lines[:2] + steps_lines[-1:] + lines[-2:],
               "n_adapter": run["n_adapter"], "n_base": run["n_base"],
               "step0_logits_equal_base": step0_equal, "base_unchanged": unchanged,
               "loss_first": losses[0], "loss_last5": sum(losses[-5:]) / 5,
               "losses": [round(x, 4) for x in losses], "launches": launches,
               "plain_calls": plain, "sample": run["sample"],
               "step_ms": _steady_step_s(run["resolved_at"]) * 1e3,
               "setup_s": setup_s, "finish_s": finish_s,
               "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30}
        want_line = (f"training {LORA_ADAPTER_PARAMS:,} adapter params over a frozen "
                     f"{LORA_BASE_PARAMS:,}-param base "
                     f"({LORA_ADAPTER_PARAMS / LORA_BASE_PARAMS:.2%})")
        want = base.cfg.n_layers * LORA_STEPS
        serving = run["serving"]
        del run, lora, base
        free_device_memory()
        # the merged artifact behind serve_lm, against generate on the
        # merged weights
        bodies = list(LORA_BODIES)
        want_rows = []
        for b in bodies:
            p = torch.as_tensor(np.frombuffer(b["prompt"].encode(), np.uint8).astype(np.int64))
            want_rows.append(generate(serving, p[None].cuda(), LORA_NEW)[0, p.numel():]
                             .tolist())
        del serving
        model = load_model(torch.device("cuda"), max_len=256, artifact=tuned)
        pool, rows, served = _zoo_serve(
            model, ["--artifact", tuned, "--max-len", "256", "--batching", "8"], bodies,
            "lora merged paged bf16", at_once=True, new_tokens=LORA_NEW)
        served["decode_steps"] = decode_steps(pool)
        served["against_generate"] = _greedy_against(model, bodies, rows, want_rows,
                                                     "lora merged")
        served["k4_want"] = model.cfg.n_layers * served["decode_steps"]
        rec["serving"] = served
        rec["wall_s"] = time.perf_counter() - t0
        log(f"lora ({card}) " + json.dumps(rec))
        if (rec["n_adapter"], rec["n_base"]) != (LORA_ADAPTER_PARAMS, LORA_BASE_PARAMS) \
                or want_line not in lines:
            raise AssertionError(f"lora: adapter count: {json.dumps(rec)}")
        if not (step0_equal and unchanged):
            raise AssertionError(f"lora: step 0 off the base, or the base moved: "
                                 f"{json.dumps(rec)}")
        if (any(n != want for n in launches.values()) or plain
                or not all(math.isfinite(x) for x in losses)
                or not rec["loss_last5"] < losses[0]):
            raise AssertionError(f"lora: K1-K3 {launches} (want {want} each), plain {plain}, "
                                 f"losses {losses}")
        k4 = served["launches"].get(KERNEL, 0)
        if (served["decoder"] != "PagedContinuousBatchingDecoder" or k4 == 0
                or k4 != served["k4_want"] or served["plain_calls"]
                or any(k != KERNEL for k in served["launches"])):
            raise AssertionError(f"lora merged serving: {json.dumps(served)}")
        del pool, model
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    free_device_memory()
    return rec


def _pp_batch(data_dir):
    from tf_operator_tpu_torch.data.text import TextBatches, as_lm_batches

    batch = next(iter(as_lm_batches(TextBatches(data_dir, PP_ROWS, seed=0))))
    return torch.as_tensor(batch["input_ids"], device="cuda").long()


def _pp_leaves(model, grads=False):
    """{name in the one-process stack: float32 CPU copy} of the weights
    (or their gradients) that ``model``'s rank holds: stage layer j of
    rank s is layer s x layers-a-stage + j of the stack."""

    per = len(model.stages)
    out = {}
    for name, p in model.named_parameters():
        if name.startswith("stages."):
            _, j, rest = name.split(".", 2)
            name = f"stages.{model.stage_index * per + int(j)}.{rest}"
        out[name] = (p.grad if grads else p).detach().float().cpu().clone()
    return out


def _leaves_off(mine, theirs, skip):
    """The largest relative L2 difference of ``mine``'s leaves from
    ``theirs``' (the one process's), with its leaf, over the leaves not
    in ``skip``; ``same_names`` when every leaf is there at its shape."""

    same = all(k in theirs and theirs[k].shape == v.shape for k, v in mine.items())
    rel = {k: float((v - theirs[k]).norm() / theirs[k].norm().clamp_min(1e-30))
           for k, v in mine.items() if k not in skip and k in theirs
           and theirs[k].shape == v.shape}
    leaf = max(rel, key=rel.get)
    return {"max_rel": rel[leaf], "leaf": leaf, "compared": len(rel),
            "skipped": len(mine) - len(rel), "same_names": same}


def rank_pipeline(data_dir, yardstick):
    """One rank of (b)'s 2-rank job over ``{"pp": 2}`` (gloo, the ranks on
    the one card), or outside a job the one-process yardstick: every
    layer in one stage, trained through the sequential
    ``lm_reference_apply``.  PP_STEPS steps of optax.adamw's form on one
    fixed batch.  The yardstick writes its step-0 gradients and final
    weights to ``yardstick``; a rank reads them and holds its own leaf
    by leaf.  Returns losses, K1-K3 launches, the stage's bytes, step
    ms, the collectives and (a rank) the leaves' readings."""

    from tf_operator_tpu_torch.gpt_pipeline import _Loop
    from tf_operator_tpu_torch.models.gpt import gpt_small
    from tf_operator_tpu_torch.models.pipelined_lm import PipelinedLM, reference_loss
    from tf_operator_tpu_torch.ops import _build
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.parallel.mesh import make_mesh
    from tf_operator_tpu_torch.parallel.trainer import Optimizer, TrainerConfig
    from tf_operator_tpu_torch.runtime.bootstrap import entry_device, initialize, world

    ctx = initialize("cuda")
    rank, n = world()
    dev = entry_device("cuda", ctx)
    mesh = make_mesh({"pp": n}) if n > 1 else None
    model = PipelinedLM(gpt_small(vocab_size=256, max_len=PP_SEQ), mesh,
                        microbatches=PP_MICROBATCHES, activation="relu",
                        device=dev).init_params(0)
    params = list(model.parameters())
    loop = _Loop(model, Optimizer(TrainerConfig(learning_rate=PP_LR, weight_decay=1e-4,
                                                grad_clip=0.0), params,
                                  decay=[True] * len(params)))
    if mesh is None:
        model.loss = lambda ids: reference_loss(model, ids)
    ids = _pp_batch(data_dir)
    zero = {k for k, v in _pp_leaves(model).items() if not v.any()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.launches.clear()
    fa.plain_calls.clear()
    losses, stamps = [], []
    for step in range(PP_STEPS):
        losses.append(float(loop.train_step(ids)["loss"]))  # resolves the step
        if step == 0:
            grads = _pp_leaves(model, grads=True)
        stamps.append(time.perf_counter())
    torch.cuda.synchronize()
    weights = _pp_leaves(model)
    if mesh is None:
        torch.save({"grads": grads, "weights": weights}, yardstick)
        leaves = {"names": sorted(weights)}
    else:
        one = torch.load(yardstick, mmap=True)
        noise = {k for k in grads if k.endswith(PP_ZERO_GRAD)}
        leaves = {"grads": _leaves_off(grads, one["grads"], noise),
                  "weights": _leaves_off(weights, one["weights"], zero | noise),
                  "names": sorted(weights)}
    del grads, weights
    return {"rank": rank, "world": n, "stage": model.stage_index, "leaves": leaves,
            "layers": len(model.stages), "losses": losses,
            "launches": {k: _build.launches.get(k, 0) for k in FLASH_KERNELS},
            "plain_calls": {k: v for k, v in fa.plain_calls.items() if v},
            "stage_bytes": model.stage_bytes(),
            "step_ms": (stamps[-1] - stamps[0]) / (PP_STEPS - 1) * 1e3,
            "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
            "collectives": mesh.stats.snapshot() if mesh is not None else {}}


def rank_gpt_pipeline(family):
    """(c) on this rank: ``gpt_pipeline --pp 2`` at its defaults through
    its ``run``; returns the losses, K1-K3 and the step ms."""

    from tf_operator_tpu_torch import gpt_pipeline
    from tf_operator_tpu_torch.ops import _build

    _build.launches.clear()
    out = gpt_pipeline.run(gpt_pipeline.parse_args([
        "--pp", "2", "--family", family, "--steps", str(PIPE_JOB_STEPS),
        "--steps-per-sync", "1"]))
    torch.cuda.synchronize()
    model = out["model"]
    return {"family": family, "stage": model.stage_index, "layers": len(model.stages),
            "microbatches": model.microbatches, "losses": out["losses"],
            "launches": {k: _build.launches.get(k, 0) for k in FLASH_KERNELS},
            "step_ms": _steady_step_s(out["loop"]["resolved_at"]) * 1e3}


def rank_pipeline_jobs(data_dir, yardstick):
    """One rank of phase 16's 2-process world: (b), then (c)'s two jobs,
    one family after the other in the same world; prints ``RANK
    {...}``."""

    rec = {"pp": rank_pipeline(data_dir, yardstick),
           **{family: rank_gpt_pipeline(family) for family in ("gpt", "llama")}}
    print("RANK " + json.dumps(rec), flush=True)
    return rec


def phase_pipeline(card):
    """(b) and (c) (module docstring): one process's sequential oracle,
    then one 2-process world: the 2-rank PipelinedLM, then
    gpt_pipeline's two families.  Returns the records."""

    import tempfile

    from tf_operator_tpu_torch.data.text import ensure_text

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pp_")
    try:
        data_dir = os.path.join(tmp, "text")
        ensure_text(data_dir, seq_len=PP_SEQ)
        yardstick = os.path.join(tmp, "yardstick.pt")
        one = rank_pipeline(data_dir, yardstick)
        free_device_memory()
        world = _run_ranks(2, "import chip_smoke as c; "
                              f"c.rank_pipeline_jobs({data_dir!r}, {yardstick!r})",
                           "pp 2: PipelinedLM, then gpt_pipeline gpt and llama")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ranks = [r["pp"] for r in world]
    rec = {"ranks": [{k: r[k] for k in ("rank", "stage", "layers", "losses", "launches",
                                        "plain_calls", "stage_bytes", "step_ms",
                                        "max_memory_allocated_gib", "collectives")}
                     | {k: r["leaves"][k] for k in ("grads", "weights")}
                     for r in ranks],
           "one_process": {k: one[k] for k in ("layers", "losses", "launches", "stage_bytes",
                                               "step_ms", "max_memory_allocated_gib")},
           "max_loss_rel": max(abs(a - b) / abs(b) for r in ranks
                               for a, b in zip(r["losses"], one["losses"])),
           "tol": DIST_LOSS_RTOL, "grad_rtol": PP_GRAD_RTOL, "weight_rtol": PP_WEIGHT_RTOL,
           "wall_s": time.perf_counter() - t0}
    log(f"pipeline gpt_small pp 2 ({card}) " + json.dumps(rec))
    bad = []
    if not rec["max_loss_rel"] <= DIST_LOSS_RTOL:
        bad.append(f"losses {rec['max_loss_rel']:.3g} relative")
    for r in ranks:
        for kind, tol in (("grads", PP_GRAD_RTOL), ("weights", PP_WEIGHT_RTOL)):
            off = r["leaves"][kind]
            if not (off["same_names"] and off["max_rel"] <= tol):
                bad.append(f"rank {r['rank']} {kind} {off}")
    if set(ranks[0]["leaves"]["names"]) | set(ranks[1]["leaves"]["names"]) != set(
            one["leaves"]["names"]):
        bad.append("the ranks' leaves are not the one process's")
    if ranks[0]["losses"] != ranks[1]["losses"]:
        bad.append("the ranks' losses differ")
    if bad:
        raise AssertionError("pipeline pp 2 off the yardstick: " + "; ".join(bad))
    want = PP_MICROBATCHES * 6 * PP_STEPS
    if ([r["stage"] for r in ranks] != [0, 1]
            or one["launches"] != {k: 12 * PP_STEPS for k in FLASH_KERNELS}
            or any(2 * r["stage_bytes"] != one["stage_bytes"] or r["layers"] != 6
                   or r["launches"] != {k: want for k in FLASH_KERNELS} or r["plain_calls"]
                   for r in ranks)):
        raise AssertionError(f"pipeline pp 2: {json.dumps(rec)}")
    # (c): both families' jobs, run by the same ranks after (b)
    entry = {}
    for family in ("gpt", "llama"):
        rs = [dict(r[family], lines=r["lines"]) for r in world]
        tag = f"[{family} pp=2 dp=1 mb=4]: steps 0..{PIPE_JOB_STEPS} loss "
        lines = [[ln for ln in r["lines"] if tag in ln] for r in rs]
        entry[family] = {"lines": [ls[-1] if ls else None for ls in lines],
                         **{k: [r.get(k) for r in rs] for k in ("losses", "launches",
                                                                "step_ms", "layers")}}
        # 2 layers a stage x 4 microbatches a step
        want = {k: 2 * 4 * PIPE_JOB_STEPS for k in FLASH_KERNELS}
        ok = (all(len(ls) == 1 for ls in lines)
              and lines[0][0].split("]:")[1] == lines[1][0].split("]:")[1]
              and rs[0]["losses"] == rs[1]["losses"]
              and sum(rs[0]["losses"][-3:]) / 3 < rs[0]["losses"][0]
              and all(r["launches"] == want for r in rs))
        if not ok:
            raise AssertionError(f"gpt_pipeline --family {family}: {json.dumps(entry[family])}")
    log(f"gpt_pipeline --pp 2 jobs ({card}) " + json.dumps(entry))
    rec["gpt_pipeline"] = entry
    return rec


def phase_lora_pipeline(base_dir, card):
    """Phase 16: K1-K3 at its shapes, then (a) LoRA, (b) and (c) the
    pipeline.  Returns the flash records and the runs, with the walls."""

    t0 = time.perf_counter()
    flash = [flash_case(n, seed=160 + i, dtype=torch.bfloat16, causal=True, timed=True,
                        queued=True, **kw) for i, (n, kw) in enumerate(PHASE16_FLASH)]
    log(f"phase 16 flash shapes ({card}) " + json.dumps(
        {r["case"]: {**{k: {f: round(t[f], 5) for f in ("ms", "device_ms", "bound_ms",
                                                         "plain_ms", "library_ms")}
                        | {"bound_by": t["bound_by"]} for k, t in r["timing"].items()},
                     "sdpa_device_ms": r["sdpa_device_ms"],
                     "max_abs_err": r["max_abs_err"], "row_rel": r["row_rel"]}
         for r in flash}))
    free_device_memory()
    walls = {"kernels": time.perf_counter() - t0}
    runs = {"lora": phase_lora(base_dir, card)}
    walls["lora"] = runs["lora"]["wall_s"]
    runs["pipeline"] = phase_pipeline(card)
    walls["pipeline"] = runs["pipeline"]["wall_s"]
    walls["total"] = time.perf_counter() - t0
    log(f"phase 16 walls ({card}) " + json.dumps(walls))
    return flash, runs


#: phase 5b's llama-wide job: steps and rows a rank (the one-process
#: yardstick trains on both ranks' rows at once); every step is resolved
#: (K = 1), so the steady step wall is the resolves' slope after the
#: first step
DIST_STEPS = 3
DIST_BATCH = 4
#: their llama-wide's depth (of its 12 layers; width, sequence and rows
#: as phase 5's): cut from 12, and the steps from 4, to give phase 5d
#: the script's time
DIST_LAYERS = 4
#: phase 5b: each loss of the 2-rank fsdp run against the one-process
#: run on the same global batch, relative.  bf16 compute: each rank's
#: weight gradients are rounded to bf16 over its 4 rows where the one
#: process rounds them over all 8, and Adam carries that into the
#: weights; read 1.0e-5 over 4 steps and 1.3e-4 over 6
DIST_LOSS_RTOL = 1e-3
#: the gathered weights after the run against the yardstick's, leaf by
#: leaf: the largest over the leaves of |w - w_one| / |w_one| (L2 norms);
#: read 1.3e-3 (a query kernel).  A sync that drops the other rank's
#: gradients (chip_fault_probe.py) read 9.0e-2 here and 8.7e-3 on the
#: losses
DIST_WEIGHT_RTOL = 1e-2
#: the psum checks' bound, float32 sums of 2 or 4 terms in another order
PSUM_ATOL = 1e-5
PSUM_SHAPES = [(1024, 33), (4097,), (16, 8, 4), (2048, 64)]


def _rank_env(rank, n, port, extra=None):
    """The ``TPUJOB_*`` environment of rank ``rank`` in a job of ``n``
    processes on this host, its coordinator at 127.0.0.1:``port``."""

    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPUJOB_", "MEGASCALE_", "TPU_WORKER"))}
    env.update({"TPUJOB_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                "TPUJOB_NUM_PROCESSES": str(n), "TPUJOB_PROCESS_ID": str(rank),
                "TPUJOB_REPLICA_TYPE": "worker", "TPUJOB_REPLICA_INDEX": str(rank),
                "TPUJOB_NAME": "chip-smoke"})
    env.update(extra(rank) if extra else {})
    return env


def _run_ranks(n, code, tag, extra=None, timeout=900):
    """``python -c code`` as ranks 0..n-1 of one job (``n`` = 0: one
    process outside any job), all started together from the repo root;
    returns each rank's ``RANK {...}`` record and its output lines.  Each
    rank writes to a file of its own, so that no rank waits on a full
    pipe while another waits on it in a collective; ``timeout``: the
    seconds the job may take."""

    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    port = _free_port()
    envs = ([_rank_env(r, n, port, extra) for r in range(n)] if n else
            [{k: v for k, v in os.environ.items() if not k.startswith("TPUJOB_")}])
    t0 = time.perf_counter()
    files = [tempfile.TemporaryFile(mode="w+") for _ in envs]
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=here, env=env, text=True,
                              stdout=f, stderr=subprocess.STDOUT)
             for env, f in zip(envs, files)]
    try:
        for p in procs:
            p.wait(timeout=max(1.0, t0 + timeout - time.perf_counter()))
        outs = []
        for f in files:
            f.seek(0)
            outs.append(f.read())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
        for f in files:
            f.close()
    wall = time.perf_counter() - t0
    recs = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        lines = out.splitlines()
        if p.returncode != 0:
            raise AssertionError(f"{tag}: rank {r} exited {p.returncode}: {lines[-40:]}")
        got = [ln for ln in lines if ln.startswith("RANK ")]
        recs.append(dict(json.loads(got[-1][5:]), lines=lines) if got else {"lines": lines})
    log(f"{tag}: {max(1, n)} process(es) in {wall:.1f} s")
    return recs


def _check_psum(mesh, device, tag):
    """``psum_hierarchical`` on card tensors against the flat all-reduce
    (bucketed leaves whole, the last leaf fsdp-sharded along dim 0),
    and the sync probe's walls."""

    import torch.distributed as dist

    from tf_operator_tpu_torch.parallel import collectives

    rank = dist.get_rank()
    g = torch.Generator(device=device).manual_seed(rank)
    xs = [torch.randn(s, generator=g, device=device) for s in PSUM_SHAPES]
    specs = [None] * (len(xs) - 1) + [("fsdp", None)]
    hier = collectives.psum_hierarchical([x.clone() for x in xs], mesh, shardings=specs,
                                         bucket_bytes=64 << 10)
    flat = [x.clone() for x in xs]
    for x in flat:
        dist.all_reduce(x)
    fsdp = mesh.shape["fsdp"]
    shard = flat[-1].chunk(fsdp, 0)[mesh.index(("fsdp",), rank)]
    err = max([(h - f).abs().max().item() for h, f in zip(hier[:-1], flat[:-1])]
              + [(hier[-1] - shard).abs().max().item()])
    if not err <= PSUM_ATOL or any(h.device != torch.device(device) for h in hier):
        raise AssertionError(f"{tag}: psum_hierarchical off the flat all-reduce by {err}")
    probe = collectives.measure_sync_seconds(mesh, device, nbytes=64 << 20, repeats=3)
    return {"psum_max_abs_err": err, "sync_probe": probe}


def rank_jobs(jobs):
    """One process of a world (or one process outside any) that runs
    ``jobs`` in turn, so that the processes start once: each ``(name,
    function, kwargs)``, the function one of this module's ``rank_*``,
    which returns its record; prints ``RANK {name: record}``, each with
    the job's wall."""

    recs = {}
    for name, fn, kw in jobs:
        t0 = time.perf_counter()
        rec = globals()[fn](**kw)
        torch.cuda.synchronize()
        recs[name] = dict(rec, job_wall_s=time.perf_counter() - t0)
        free_device_memory()
    print("RANK " + json.dumps(recs), flush=True)
    return recs


def _jobs_code(jobs):
    return f"import chip_smoke as c; c.rank_jobs({list(jobs)!r})"


def _job(ranks, name):
    """Each rank's record of the job ``name`` (``rank_jobs``), with the
    rank's output lines."""

    return [dict(r[name], lines=r["lines"]) for r in ranks]


def rank_psum():
    """Phase 5b's 2-rank job: ``dist_psum`` on CUDA tensors, then
    ``psum_hierarchical`` over fsdp on card tensors."""

    from tf_operator_tpu_torch import dist_psum
    from tf_operator_tpu_torch.parallel.mesh import make_mesh
    from tf_operator_tpu_torch.runtime.bootstrap import from_env, initialize

    assert dist_psum.main([]) == 0
    ctx = initialize("cuda")
    rec = _check_psum(make_mesh({"fsdp": -1}), ctx.device, "2-rank psum")
    return dict(rec, rank=ctx.process_id, backend=ctx.backend, device=str(ctx.device),
                job=from_env().job_name)


def rank_multislice():
    """Phase 5b's 4-rank job (2 slices x 2 hosts): ``psum_hierarchical``
    through all three stages on card tensors, then ``dist_multislice``."""

    from tf_operator_tpu_torch import dist_multislice
    from tf_operator_tpu_torch.parallel.mesh import make_mesh
    from tf_operator_tpu_torch.runtime.bootstrap import initialize

    ctx = initialize("cuda")
    rec = _check_psum(make_mesh({"dp": 2, "fsdp": -1}), ctx.device, "4-rank psum")
    assert dist_multislice.main([]) == 0
    return dict(rec, rank=ctx.process_id, backend=ctx.backend)


def rank_llama(data_dir, batch_per_device, save=None, compare=None, extra=()):
    """One process of phase 5b's (or 5c's) llama-wide run through
    ``llama_pretrain`` (a rank of the job, or a one-process run): its
    losses, K1-K3 launches, step wall, collectives by stage, the
    training state it holds between steps, peak memory.  ``save``:
    write the weights after the run there; ``compare``: (rank 0) hold
    the gathered weights against the ones written there, leaf by leaf;
    ``extra``: more flags (``--sp``, ``--sp-impl``).  Returns the
    record."""

    import dataclasses

    from tf_operator_tpu_torch import llama_pretrain
    from tf_operator_tpu_torch.ops import _build
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.ops import ring_attention as ra
    from tf_operator_tpu_torch.runtime.bootstrap import world
    from tf_operator_tpu_torch.runtime.harness import gather_params

    full_depth = llama_pretrain.model_config
    args = llama_pretrain.parse_args([
        "--model", "llama-wide", "--seq-len", "2048", "--batch-per-device",
        str(batch_per_device), "--steps", str(DIST_STEPS), "--steps-per-sync", "1",
        "--data-dir", data_dir, "--generate", "0", *extra])
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    _build.launches.clear()
    fa.plain_calls.clear()
    ra.boundary_blocks.clear()
    # the depth cut, for this run only
    llama_pretrain.model_config = lambda name, seq_len, **kw: dataclasses.replace(
        full_depth(name, seq_len, **kw), n_layers=DIST_LAYERS)
    try:
        out = llama_pretrain.run(args)
    finally:
        llama_pretrain.model_config = full_depth
    torch.cuda.synchronize()
    launches, plain = dict(_build.launches), dict(fa.plain_calls)
    boundary = dict(ra.boundary_blocks)
    trainer = out["trainer"]
    resident = trainer.resident_bytes()
    peak = torch.cuda.max_memory_allocated()
    params = gather_params(trainer)
    rank, n = world()
    collectives = trainer.collective_stats.snapshot() if n > 1 else {}
    rec = {"rank": rank, "world": n, "losses": out["losses"],
           "launches": {k: launches.get(k, 0) for k in FLASH_KERNELS}, "plain_calls": plain,
           "boundary_blocks": boundary,
           "step_ms": _steady_step_s(out["resolved_at"]) * 1e3, "wall_s": out["wall_s"],
           "collectives": collectives,
           "collective_share": sum(v["seconds"] for v in collectives.values()) / out["wall_s"],
           "resident_bytes": resident, "max_memory_allocated_gib": peak / 2**30}
    if save:
        torch.save({k: v.cpu() for k, v in params.items()}, save)
    if compare and rank == 0:
        rec["weights"] = _leaves_against(params, torch.load(compare))
    return rec


def _leaves_against(params, want, skip=None):
    """``params`` against the weights ``want`` leaf by leaf: the largest
    relative L2 difference and its leaf, the leaf count, whether the
    names are the same.  ``skip``: a suffix of leaves left out (and
    counted)."""

    rel = {k: float((params[k].float() - w.to(params[k].device)).norm()
                    / w.to(params[k].device).norm()) for k, w in want.items()
           if k in params and not (skip and k.endswith(skip))}
    leaf = max(rel, key=rel.get)
    return {"leaves": len(rel), "skipped": len(want) - len(rel),
            "same_names": sorted(want) == sorted(params), "max_rel": rel[leaf],
            "max_leaf": leaf}


def _llama_paths(tmp):
    """The text data and the yardstick's weights of phases 5b and 5c."""

    return os.path.join(tmp, "text"), os.path.join(tmp, "yardstick.pt")


def _llama_job(tmp, rows, save=False, compare=False, extra=()):
    data_dir, yard = _llama_paths(tmp)
    return ("rank_llama", {"data_dir": data_dir, "batch_per_device": rows,
                           "save": yard if save else None, "compare": yard if compare else None,
                           "extra": tuple(extra)})


def llama_yardsticks(tmp):
    """Phases 5b and 5c's yardstick, llama-wide in this process on the
    global batch (2 x ``DIST_BATCH`` rows, its weights written under
    ``tmp``), and then on 4 rows (memory only): their records."""

    t0 = time.perf_counter()
    recs = [rank_llama(**_llama_job(tmp, rows, save=rows > DIST_BATCH)[1])
            for rows in (2 * DIST_BATCH, DIST_BATCH)]
    free_device_memory()
    log(f"llama-wide yardstick, then 4 rows: this process in {time.perf_counter() - t0:.1f} s")
    return recs


def _weights_off(rec, bad):
    """Rank 0's gathered weights against the yardstick's (``rec`` from
    ``rank_llama(compare=)``): appends to ``bad`` if a leaf is missing or
    the largest relative difference is over ``DIST_WEIGHT_RTOL``."""

    weights = rec["weights"]
    if not (weights["same_names"] and weights["max_rel"] <= DIST_WEIGHT_RTOL):
        bad.append(f"weights against the yardstick's {weights}")
    return weights


def phase_llama_fsdp(card, one, one4, ranks):
    """Phase 5b (2): the 2 ranks of llama-wide over fsdp 2 (their records
    ``ranks``, from ``phase_multiprocess``'s world) against one process
    on the global batch (``one``, the yardstick) and on 4 rows (``one4``,
    memory only: ``llama_yardsticks``); raises with the readings if a
    rank is off the yardstick."""

    want = DIST_STEPS * DIST_LAYERS
    rows, bad = [], []
    for rec in ranks:
        rel = [abs(a - b) / abs(b) for a, b in zip(rec["losses"], one["losses"])]
        rows.append({k: rec[k] for k in ("rank", "world", "launches", "step_ms", "wall_s",
                                        "collectives", "resident_bytes",
                                        "max_memory_allocated_gib")}
                    | {"loss_rel_max": max(rel), "losses": rec["losses"]})
        if rec["world"] != 2 or len(rec["losses"]) != DIST_STEPS:
            raise AssertionError(f"llama-wide fsdp 2: rank {rec['rank']}: {rec}")
        if any(rec["launches"][k] != want for k in FLASH_KERNELS) or sum(
                rec["plain_calls"].values()):
            raise AssertionError(f"llama-wide fsdp 2: rank {rec['rank']} launched "
                                 f"{rec['launches']} (want {want} each), plain "
                                 f"{rec['plain_calls']}")
        if not max(rel) <= DIST_LOSS_RTOL:
            bad.append(f"rank {rec['rank']} losses {rec['losses']} against {one['losses']}: "
                       f"{max(rel):.3g} relative")
    rows[0]["weights"] = _weights_off(ranks[0], bad)
    if ranks[0]["losses"] != ranks[1]["losses"]:
        bad.append("the ranks' global losses differ")
    summary = {
        "yardstick": {k: one[k] for k in ("losses", "step_ms", "wall_s", "resident_bytes",
                                          "max_memory_allocated_gib")},
        "one_process_4_rows": {k: one4[k] for k in ("resident_bytes",
                                                    "max_memory_allocated_gib")},
        "ranks": rows, "loss_rtol": DIST_LOSS_RTOL, "weight_rtol": DIST_WEIGHT_RTOL}
    log(f"llama-wide fsdp 2 ({card}) " + json.dumps(summary))
    if bad:
        raise AssertionError("llama-wide fsdp 2 off the yardstick: " + "; ".join(bad))
    return summary


#: phase 5c(a): the sp attention at llama-wide's attention shape, and
#: the windowed ring's window (a boundary hop on rank 1 of 2)
SP_ATTN = dict(b=4, h=16, hkv=8, s=2048, d=128)
SP_WINDOW = 1536
SP_CASES = (("ring", None), ("ulysses", None), ("ring", SP_WINDOW))
#: phase 5c(b): the schedules ``llama_pretrain --sp 2`` runs
SP_IMPLS = ("ring", "ulysses")


def _sp_reckon(impl, window, r):
    """(K1-K3 launches each, boundary blocks each way) of rank ``r`` of 2
    in one causal forward and backward of 5c(a)."""

    if impl == "ulysses":
        return 1, 0
    if window is None:
        return r + 1, 0  # the diagonal, and rank 0's hop from rank 1 masked
    # the hop from rank 0 to rank 1 is crossed by the band's edge
    return 1, r


def rank_sp_attention():
    """Phase 5c(a), one rank of 2: each schedule on this rank's chunk of
    one seeded global input, forward and backward, against one
    process's K1 forward and K2 / K3 backward on the whole sequence;
    returns the record."""

    from tf_operator_tpu_torch.ops import _build
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.ops import ring_attention as ra
    from tf_operator_tpu_torch.ops.ulysses_attention import ulysses_attention
    from tf_operator_tpu_torch.parallel.collectives import CollectiveStats
    from tf_operator_tpu_torch.parallel.mesh import make_mesh
    from tf_operator_tpu_torch.parallel.sharding import sequence_chunk
    from tf_operator_tpu_torch.runtime.bootstrap import initialize

    ctx = initialize("cuda")
    rank, dev = ctx.process_id, ctx.device
    mesh = make_mesh({"sp": ctx.num_processes})
    c = SP_ATTN
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((c["b"], c["h"], c["s"], c["d"]), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((c["b"], c["hkv"], c["s"], c["d"]), generator=g, device=dev).bfloat16()
            for _ in range(2))
    do = torch.randn(q.shape, generator=g, device=dev).bfloat16()
    chunk = lambda t: sequence_chunk(t, mesh, rank, dim=2).contiguous()  # noqa: E731
    rows = []
    for impl, window in SP_CASES:
        out, lse = fa.flash_forward_cuda(q, k, v, True, window)
        delta = (do.float() * out.float()).sum(-1)
        want = (out, fa.flash_backward_dq_cuda(q, k, v, do, lse, delta, True, window),
                *fa.flash_backward_dkv_cuda(q, k, v, do, lse, delta, True, window))
        qq, kk, vv = (chunk(t).requires_grad_() for t in (q, k, v))
        torch.cuda.synchronize()
        _build.launches.clear()
        fa.plain_calls.clear()
        ra.boundary_blocks.clear()
        mesh.stats = CollectiveStats()
        t0 = time.perf_counter()
        fn = ra.ring_attention if impl == "ring" else ulysses_attention
        o = fn(qq, kk, vv, mesh, causal=True, window=window)
        got = (o, *torch.autograd.grad(o, (qq, kk, vv), chunk(do)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {kname: _build.launches.get(kname, 0) for kname in FLASH_KERNELS}
        rel = {name: _tensor_rel(a, chunk(b)) for name, a, b in
               zip(("out", "dq", "dk", "dv"), got, want)}
        rows.append({"impl": impl, "window": window, "rel": rel, "tol": FLASH_RTOL[torch.bfloat16],
                     "launches": launches, "plain_calls": dict(fa.plain_calls),
                     "boundary_blocks": dict(ra.boundary_blocks), "ms": wall * 1e3,
                     "collectives": mesh.stats.snapshot(), "want": _sp_reckon(impl, window, rank)})
        del got, want, o
    return {"rank": rank, "cases": rows}


def phase_sp_attention(card, ranks):
    """Phase 5c(a) (module docstring): the sp attention at llama-wide's
    attention shape against one process, the 2 ranks' records
    ``ranks``; raises with the readings if a rank is off."""

    bad = []
    for rec in ranks:
        for row in rec["cases"]:
            want_k, want_b = row["want"]
            tag = f"rank {rec['rank']} {row['impl']} window={row['window']}"
            if any(not (math.isfinite(e) and e <= row["tol"]) for e in row["rel"].values()):
                bad.append(f"{tag}: {row['rel']} over {row['tol']}")
            if any(row["launches"][k] != want_k for k in FLASH_KERNELS) or row["plain_calls"]:
                bad.append(f"{tag}: launched {row['launches']} (want {want_k} each), plain "
                           f"{row['plain_calls']}")
            if row["boundary_blocks"] != ({"window_block_fwd": want_b,
                                           "window_block_bwd": want_b} if want_b else {}):
                bad.append(f"{tag}: boundary blocks {row['boundary_blocks']} (want {want_b})")
    attention = [{"rank": rec["rank"], "cases": rec["cases"]} for rec in ranks]
    log(f"sp attention ({card}) " + json.dumps(attention))
    if bad:
        raise AssertionError("sp attention: " + "; ".join(bad))
    return attention


def _sp_llama_job(tmp, impl):
    return (f"sp_{impl}", *_llama_job(tmp, DIST_BATCH, compare=True,
                                      extra=("--sp", "2", "--sp-impl", impl)))


def phase_sp_llama(card, yardstick, runs):
    """Phase 5c(b) (module docstring): ``llama_pretrain --sp 2``, the
    ranks' records ``runs`` by schedule, against the yardstick
    (``llama_yardsticks``: its losses ``yardstick``; rank 0 held its
    weights against the yardstick's) on the same global batch, loss by
    loss and rank 0's weights leaf by leaf; raises with the readings if
    a rank is off."""

    jobs, bad = {}, []
    for impl, ranks in runs.items():
        rows = []
        for rec in ranks:
            want = DIST_STEPS * DIST_LAYERS * (rec["rank"] + 1 if impl == "ring" else 1)
            rel = [abs(a - b) / abs(b) for a, b in zip(rec["losses"], yardstick)]
            rows.append({k: rec[k] for k in ("rank", "launches", "step_ms", "wall_s",
                                            "collective_share", "collectives",
                                            "max_memory_allocated_gib")}
                        | {"loss_rel_max": max(rel), "losses": rec["losses"],
                           "launches_reckoned": want})
            if rec["world"] != 2 or len(rec["losses"]) != DIST_STEPS:
                raise AssertionError(f"llama-wide sp 2 {impl}: rank {rec['rank']}: {rec}")
            if any(rec["launches"][k] != want for k in FLASH_KERNELS) or sum(
                    rec["plain_calls"].values()) or rec["boundary_blocks"]:
                bad.append(f"{impl} rank {rec['rank']} launched {rec['launches']} (want "
                           f"{want} each), plain {rec['plain_calls']}, boundary "
                           f"{rec['boundary_blocks']}")
            if not max(rel) <= DIST_LOSS_RTOL:
                bad.append(f"{impl} rank {rec['rank']} losses {rec['losses']} against "
                           f"{yardstick}: {max(rel):.3g} relative")
        off = []
        rows[0]["weights"] = _weights_off(ranks[0], off)
        bad += [f"{impl}: {msg}" for msg in off]
        jobs[impl] = rows
    log(f"llama-wide sp 2 ({card}) " + json.dumps({"yardstick": yardstick, "jobs": jobs,
                                                   "loss_rtol": DIST_LOSS_RTOL,
                                                   "weight_rtol": DIST_WEIGHT_RTOL}))
    if bad:
        raise AssertionError("llama-wide sp 2 off the yardstick: " + "; ".join(bad))
    return jobs


# -- phase 5e: sequence parallelism over the decoder zoo -------------------------

#: phase 5e's jobs: name -> (family, mesh, sp schedule); the 2-rank ones
#: run in phase 5b's world, the 4-rank ones in a world of their own
SP_ZOO_JOBS = {
    "gpt_small_ring_sp2": ("gpt", {"sp": 2}, "ring"),
    "gpt_small_ulysses_sp2": ("gpt", {"sp": 2}, "ulysses"),
    "moe_gpt_small_ring_sp2": ("moe", {"sp": 2}, "ring"),
    "gpt_small_ulysses_sp2_tp2": ("gpt", {"sp": 2, "tp": 2}, "ulysses"),
    "moe_gpt_small_ring_sp2_ep2": ("moe", {"sp": 2, "ep": 2}, "ring"),
}
#: the 8-expert moe's capacity factor in phase 5e: 0.5, where a row's
#: expert keeps 256 of its 2,048 routes, so routes drop and the slots'
#: scan across the sp line decides which (at the default 2.0 nothing
#: drops and the slots would not matter)
SP_ZOO_CAPACITY = 0.5
#: the leaves phase 5e's weight check skips: the biases, which start at
#: zero, so that after two AdamW updates each is all update, and Adam's
#: normalisation turns the bf16 rounding of a small gradient into a
#: whole step of the learning rate (and the key biases' gradient is zero
#: in exact arithmetic: PP_ZERO_GRAD).  Phase 16(b) skips them for the
#: same reason
SP_ZOO_SKIP = ".bias"
#: phase 5e: each leaf's step-0 gradient norm (the gradients summed over
#: sp and the batch axes, a split leaf's over its line) against one
#: process's, relative.  AdamW's update hides a gradient's scale, and
#: the moe's weights move at MP_LR, so the gradients are held too.  Read
#: on an H100: gpt <= 1.9e-3, the moe <= 8.6e-3 (router kernels); moe's
#: capacity scan without the earlier rank's counts (chip_fault_probe.py
#: moe_sp_prefix) 0.96 on an expert stack, where its weights moved 6.2e-4
#: (the key biases, zero in exact arithmetic, are skipped: PP_ZERO_GRAD)
SP_ZOO_GRAD_RTOL = 0.1
#: K1-K3 at the shapes a rank of phase 5e runs (bf16, D 64, gpt_small's
#: 12 heads of 8 x 1024): Ulysses' whole sequence at a tp 2 rank's
#: heads over sp 2 (3 heads), and the ring's visible hop at sp 2 (512
#: of 1,024, non-causal)
SP_ZOO_FLASH = (
    ("gpt_small_ulysses_sp2_tp2_causal_b8_h3_s1024",
     dict(b=8, h=3, hkv=3, sq=1024, sk=1024, d=64, causal=True)),
    ("gpt_small_ring_sp2_hop_b8_h12_s512",
     dict(b=8, h=12, hkv=12, sq=512, sk=512, d=64, causal=False)),
)


def _sp_zoo_model(family, mesh, sp_impl, dev):
    """(model, loss) of phase 5e's ``family`` at gpt_small's widths
    (vocab 256, 12 layers, 1,024 positions, dropout 0: an sp rank's
    masks cannot be one process's), built on ``mesh`` where it has sp,
    seeded weights (the same on every rank and in one process)."""

    from tf_operator_tpu_torch.models.gpt import CausalLM, gpt_small, lm_loss
    from tf_operator_tpu_torch.models.moe import MoeConfig, MoeLM, moe_lm_loss
    from tf_operator_tpu_torch.models.weights import init_params

    sp = mesh is not None and mesh.shape["sp"] > 1
    base = gpt_small(vocab_size=256, max_len=ZOO_SEQ, dropout=0.0,
                     **({"mesh": mesh, "sp_impl": sp_impl} if sp else {}))
    if family == "gpt":
        cls, cfg, loss = CausalLM, base, lm_loss
    else:
        cls, loss = MoeLM, moe_lm_loss
        cfg = MoeConfig(base=base, num_experts=8, capacity_factor=SP_ZOO_CAPACITY)
    model = cls.from_state_dict(cfg, init_params(cfg, 0, dev, trainable=True, family=cls), dev,
                                trainable=True)
    return model, loss


def rank_sp_zoo(family, shape, sp_impl, data_dir, yard):
    """One process of phase 5e: ``family`` (``_sp_zoo_model``) trained
    ``DIST_STEPS`` ``Trainer`` steps on ``ZOO_ROWS`` x ``ZOO_SEQ`` rows of
    the byte corpus, over a mesh of ``shape`` (a rank of its job), or
    alone (``shape`` None: the yardstick, whose weights are written to
    ``yard``; a rank 0 holds its gathered weights against them leaf by
    leaf).  Counts zeroed just before the steps and read just after;
    returns the record."""

    from tf_operator_tpu_torch.data.text import TextBatches, as_lm_batches
    from tf_operator_tpu_torch.ops import ring_attention as ra
    from tf_operator_tpu_torch.parallel.mesh import make_mesh
    from tf_operator_tpu_torch.parallel.trainer import Trainer, TrainerConfig
    from tf_operator_tpu_torch.runtime.bootstrap import entry_device, initialize, world

    dev = entry_device("cuda", initialize("cuda"))
    rank, n = world()
    # one slice, also in the multislice job's world, which it shares
    mesh = make_mesh(shape, slices=1) if shape else None
    model, loss = _sp_zoo_model(family, mesh, sp_impl, dev)
    # AdamW with ZOO_TRAIN_CFG's 2-update warmup, at the zoo's rate for
    # gpt and at phase 5d's MP_LR for the moe, as there: an expert's
    # stacks start at 0.0064 of scale (lecun over 3,072 x 8), and two
    # updates at 1e-3 move them by a quarter of that, so Adam's whole
    # steps on the bf16 rounding of small gradients (and on the routes a
    # rounding moves past the capacity) reach the weight check
    lr = MP_LR if family == "moe" else ZOO_TRAIN_CFG["learning_rate"]
    trainer = Trainer(model, TrainerConfig(**dict(ZOO_TRAIN_CFG, learning_rate=lr)), loss,
                      mesh=mesh, shardings="logical")
    batches = iter(as_lm_batches(TextBatches(data_dir, ZOO_ROWS, seed=0)))
    first_grads = {}
    update = trainer.optimizer.step

    def step(grads, norm=None):
        if not first_grads:
            first_grads.update(_leaf_grad_norms(trainer, grads))
        return update(grads, norm=norm)

    trainer.optimizer.step = step
    _mp_zero()
    ra.boundary_blocks.clear()
    losses, stamps, grad_norms = [], [], []
    t0 = time.perf_counter()
    for _ in range(DIST_STEPS):
        batch = next(batches)
        out = trainer.train_step(trainer.shard_global_batch(batch) if mesh else batch)
        losses.append(float(out["loss"]))  # resolves the step
        stamps.append(time.perf_counter())
        grad_norms.append(float(out["grad_norm"]))
    launches, plain = _mp_counts()
    wall = time.perf_counter() - t0
    rec = {"rank": rank, "world": n, "mesh": dict(mesh.shape) if mesh else None,
           "sp_index": mesh.index(("sp",), rank) if mesh else 0,
           "layers": model.cfg.n_layers, "losses": losses, "grad_norms": grad_norms,
           "step0_leaf_grad_norms": first_grads,
           "launches": launches, "plain_calls": plain,
           "boundary_blocks": dict(ra.boundary_blocks),
           "step_ms": (stamps[-1] - stamps[0]) / (DIST_STEPS - 1) * 1e3, "wall_s": wall,
           "collectives": trainer.collective_stats.snapshot() if mesh else {},
           "held_bytes": sum(m.numel() * m.element_size() for m in trainer.optimizer.params),
           "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30}
    if family == "moe":
        rec["moe_aux_loss_last"] = float(out["moe_aux_loss"])
    rec["collective_s"] = sum(v["seconds"] for v in rec["collectives"].values())
    params = trainer.full_params()
    if mesh is None:
        torch.save({k: v.cpu() for k, v in params.items()}, yard)
    elif rank == 0:
        rec["weights"] = _leaves_against(params, torch.load(yard), skip=SP_ZOO_SKIP)
    del trainer, model, params
    return rec


def _leaf_grad_norms(trainer, grads):
    """{name: the L2 norm of its gradient} of ``grads`` (the summed
    gradients the optimizer takes, aligned with the trainer's masters):
    a leaf split over tp or ep has its squares summed over its line
    (collective under a mesh), so every rank reads the whole leaf's."""

    from tf_operator_tpu_torch.parallel.collectives import all_reduce

    sq = torch.stack([g.detach().float().square().sum() for g in grads])
    if trainer.mesh is not None:
        for axes in trainer._norm_sets:
            pick = torch.tensor([a == axes for a in trainer._norm_axes], device=sq.device)
            part = torch.where(pick, sq, torch.zeros_like(sq))
            all_reduce(part, trainer.mesh.group(axes), trainer.collective_stats, "leaf_norms")
            sq = torch.where(pick, part, sq)
    return dict(zip(trainer.names, sq.sqrt().tolist()))


def _sp_zoo_paths(tmp):
    """Phase 5e's byte corpus and each family's yardstick weights."""

    return (os.path.join(tmp, "zoo_text"),
            {f: os.path.join(tmp, f"sp_zoo_{f}_yardstick.pt") for f in ("gpt", "moe")})


def _sp_zoo_job(tmp, name):
    family, shape, impl = SP_ZOO_JOBS[name]
    data_dir, yards = _sp_zoo_paths(tmp)
    return (name, "rank_sp_zoo", {"family": family, "shape": shape, "sp_impl": impl,
                                  "data_dir": data_dir, "yard": yards[family]})


def sp_zoo_yardsticks(tmp, names):
    """Phase 5e's yardsticks, in this process: each family that a job of
    ``names`` trains, alone on the global batch of the corpus under
    ``tmp`` (its weights written there).  {family: record}."""

    data_dir, yards = _sp_zoo_paths(tmp)
    out = {}
    for family in sorted({SP_ZOO_JOBS[n][0] for n in names}):
        out[family] = rank_sp_zoo(family, None, "ring", data_dir, yards[family])
        free_device_memory()
    return out


def phase_sp_zoo(card, yardsticks, runs):
    """Phase 5e (module docstring) for the jobs of ``runs`` ({name: the
    ranks' records}, from ``phase_multiprocess``'s worlds), against
    ``yardsticks`` ({family: one process's record}, ``sp_zoo_yardsticks``):
    each rank's losses against its family's yardstick
    (``DIST_LOSS_RTOL``), the ranks' global losses equal, rank 0's
    gathered weights against the yardstick's leaf by leaf
    (``DIST_WEIGHT_RTOL``), K1-K3 launches = layers x steps x (r + 1) on
    sp rank r of the causal ring and layers x steps under Ulysses, no
    plain attention, no boundary block; raises with the readings if a
    rank is off."""

    bad, summary = [], {}
    for name in runs:
        family, shape, impl = SP_ZOO_JOBS[name]
        one, ranks = yardsticks[family], runs[name]
        rows = []
        for rec in ranks:
            want = rec["layers"] * DIST_STEPS * (rec["sp_index"] + 1 if impl == "ring" else 1)
            rel = [abs(a - b) / abs(b) for a, b in zip(rec["losses"], one["losses"])]
            rows.append({k: rec[k] for k in ("rank", "sp_index", "launches", "step_ms",
                                            "wall_s", "job_wall_s", "collective_s",
                                            "collectives", "held_bytes",
                                            "max_memory_allocated_gib")}
                        | {"loss_rel_max": max(rel), "losses": rec["losses"],
                           "launches_reckoned": want})
            mesh = {k: v for k, v in rec["mesh"].items() if v > 1}
            if rec["world"] != math.prod(shape.values()) or mesh != shape:
                bad.append(f"{name} rank {rec['rank']}: world {rec['world']}, mesh {mesh}")
            if (any(rec["launches"][k] != want for k in FLASH_KERNELS) or rec["plain_calls"]
                    or rec["boundary_blocks"]):
                bad.append(f"{name} rank {rec['rank']} launched {rec['launches']} (want "
                           f"{want} each), plain {rec['plain_calls']}, boundary "
                           f"{rec['boundary_blocks']}")
            if not (len(rec["losses"]) == DIST_STEPS and all(map(math.isfinite, rec["losses"]))
                    and max(rel) <= DIST_LOSS_RTOL):
                bad.append(f"{name} rank {rec['rank']} losses {rec['losses']} against "
                           f"{one['losses']}: {max(rel):.3g} relative")
            if rec["losses"] != ranks[0]["losses"]:
                bad.append(f"{name}: the ranks' global losses differ")
            grads = {k: abs(g - one["step0_leaf_grad_norms"][k]) / one["step0_leaf_grad_norms"][k]
                     for k, g in rec["step0_leaf_grad_norms"].items()
                     if not k.endswith(PP_ZERO_GRAD)}
            leaf = max(grads, key=grads.get)
            rows[-1]["step0_grad"] = {"max_rel": grads[leaf], "leaf": leaf,
                                      "leaves": len(grads)}
            if not (set(rec["step0_leaf_grad_norms"]) == set(one["step0_leaf_grad_norms"])
                    and grads[leaf] <= SP_ZOO_GRAD_RTOL):
                bad.append(f"{name} rank {rec['rank']}: step-0 gradient of {leaf} "
                           f"{grads[leaf]:.3g} relative to one process's")
        off = []
        rows[0]["weights"] = _weights_off(ranks[0], off)
        bad += [f"{name}: {msg}" for msg in off]
        summary[name] = {"ranks": rows, "one_process": {
            k: one[k] for k in ("losses", "step_ms", "wall_s", "held_bytes",
                                "max_memory_allocated_gib")}}
    summary.update(loss_rtol=DIST_LOSS_RTOL, weight_rtol=DIST_WEIGHT_RTOL,
                   grad_rtol=SP_ZOO_GRAD_RTOL, capacity_factor=SP_ZOO_CAPACITY)
    log(f"sp zoo ({card}) " + json.dumps(summary))
    if bad:
        raise AssertionError("sp zoo off the yardstick: " + "; ".join(bad))
    return {"summary": summary, "runs": runs}


def multiprocess_jobs(tmp):
    """Every job of ``phase_multiprocess``, in the order its world runs
    them: name -> (the ranks of its world, its ``rank_jobs`` entry), the
    data and yardstick weights under ``tmp``."""

    jobs = {"psum": (2, ("psum", "rank_psum", {})),
            "fsdp": (2, ("fsdp", *_llama_job(tmp, DIST_BATCH, compare=True))),
            "sp_attention": (2, ("sp_attention", "rank_sp_attention", {}))}
    jobs.update({f"sp_{impl}": (2, _sp_llama_job(tmp, impl)) for impl in SP_IMPLS})
    jobs["multislice"] = (4, ("multislice", "rank_multislice", {}))
    jobs.update({n: (math.prod(shape.values()), _sp_zoo_job(tmp, n))
                 for n, (_, shape, _) in SP_ZOO_JOBS.items()})
    jobs["model_parallel"] = (2, _model_parallel_job(_sp_zoo_paths(tmp)[0]))
    jobs.update({name: (2, (name, fn, kw)) for name, fn, kw in _mnist_and_decode_jobs(tmp)})
    return jobs


def _mnist_and_decode_jobs(tmp):
    """Phase 5f's 2-rank jobs (``rank_jobs`` entries), their data under
    ``tmp``."""

    return (("sharded_decode", "rank_sharded_decode", {"data_dir": _sp_zoo_paths(tmp)[0]}),
            ("dist_mnist_data", "rank_dist_mnist_data", {"data_dir": os.path.join(tmp, "mnist")}),
            ("mnist_summaries", "rank_mnist_summaries",
             {"summary_dir": os.path.join(tmp, "mnist_series")}))


def _slice_env(r):
    """Rank ``r`` of the 4-rank world as host r % 2 of slice r // 2."""

    s, h = r // 2, r % 2
    return {"MEGASCALE_NUM_SLICES": "2", "MEGASCALE_SLICE_ID": str(s), "TPU_WORKER_ID": str(h),
            "TPU_WORKER_HOSTNAMES": f"slice{s}-host0,slice{s}-host1"}


def _check_multislice(recs, card):
    for r, rec in enumerate(recs):
        want_line = f"process {r}/4: slice {r // 2}/2 worker {r % 2} megascale ok"
        if not any(ln.startswith(want_line) for ln in rec["lines"]):
            raise AssertionError(f"multislice: rank {r}: {rec['lines'][-20:]}")
    ledger = json.loads([ln for ln in recs[0]["lines"]
                         if ln.startswith("MULTISLICE_LEDGER ")][-1].split(" ", 1)[1])
    intra = ledger["intra_slice_size"]
    if not (ledger["grad_sync"] == "hierarchical" and intra == 2
            and ledger["axis_fabric"] == {"dp": "dcn", "fsdp": "ici"}
            and ledger["dcn_bytes_ratio"] <= 1 / intra + 1e-3):
        raise AssertionError(f"multislice ledger {ledger}")
    out = {"ledger": ledger, "ranks": [
        {k: rec[k] for k in ("rank", "backend", "psum_max_abs_err", "sync_probe")}
        for rec in recs]}
    log(f"multislice 2x2 ({card}) " + json.dumps(out))
    return out


def phase_multiprocess(card, jobs=None):
    """Phases 5b, 5c, 5e and 5f, and 5d's 2-rank job: the operator's
    multi-process jobs on the one card, each rank a process spawned here
    with the ``TPUJOB_*`` environment written here (the kernels were
    built by phase 2; a rank loads them).  This process runs every
    yardstick the jobs are held to; one 2-rank world runs, in turn, the
    2-rank jobs (5b's psum and fsdp, 5c's, 5e's 2-rank ones, 5d's, 5f's), and
    one 4-rank world the multislice job (2 slices x 2 hosts) and 5e's
    4-rank jobs (``multiprocess_jobs``); then each job's check.
    ``jobs``: the names of the jobs to run (``chip_fault_probe.py`` runs
    one); None: every job, and 5e's K1-K3 shapes first.  Returns the
    summary, with 5e's records (``sp_zoo``) and 5d's job
    (``model_parallel_ranks``, for ``phase_model_parallel``)."""

    import tempfile

    from tf_operator_tpu_torch.data.text import ensure_text

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    table = multiprocess_jobs(tmp)
    names = list(table) if jobs is None else [n for n in table if n in jobs]
    if jobs is not None and len(names) != len(set(jobs)):
        raise ValueError(f"unknown job(s) {sorted(set(jobs) - set(table))}")
    zoo = [n for n in names if n in SP_ZOO_JOBS]
    summary, walls, worlds = {}, {}, {}
    t0 = time.perf_counter()
    try:
        ensure_text(_sp_zoo_paths(tmp)[0], seq_len=ZOO_SEQ)
        t5e = time.perf_counter()
        if jobs is None:
            sp_zoo_flash = [flash_case(name, seed=190 + i, dtype=torch.bfloat16, timed=True,
                                       queued=True, **kw)
                            for i, (name, kw) in enumerate(SP_ZOO_FLASH)]
            log(f"sp zoo flash shapes ({card}) " + json.dumps(
                {r["case"]: {**{k: {f: round(t[f], 5) for f in ("ms", "device_ms", "bound_ms",
                                                                 "plain_ms", "library_ms")}
                                | {"bound_by": t["bound_by"]} for k, t in r["timing"].items()},
                             "sdpa_device_ms": r["sdpa_device_ms"],
                             "row_rel_max": max(r["row_rel"].values())} for r in sp_zoo_flash}))
            free_device_memory()
        zoo_yards = sp_zoo_yardsticks(tmp, zoo)
        walls["5e_flash_and_yardsticks_s"] = time.perf_counter() - t5e
        if {"fsdp", "sp_ring", "sp_ulysses"} & set(names):
            one, one4 = llama_yardsticks(tmp)

        for n_ranks, extra in ((2, None), (4, _slice_env)):
            mine = [table[n][1] for n in names if table[n][0] == n_ranks]
            if mine:
                t_world = time.perf_counter()
                worlds[n_ranks] = _run_ranks(n_ranks, _jobs_code(mine),
                                             f"{n_ranks}-rank jobs", extra=extra)
                walls[f"{n_ranks}_rank_world_s"] = time.perf_counter() - t_world
        recs = {n: _job(worlds[table[n][0]], n) for n in names}

        if "psum" in recs:
            for r, rec in enumerate(recs["psum"]):
                line = f"process {r}/2: allgather ok -> [0.0, 1.0]"
                if line not in rec["lines"] or rec["backend"] != "gloo":
                    raise AssertionError(f"2-rank psum: rank {r}: {rec['lines'][-20:]}")
            summary["psum_2"] = [{k: rec[k] for k in ("backend", "device", "psum_max_abs_err",
                                                      "sync_probe")} for rec in recs["psum"]]
            log(f"2-rank psum ({card}) " + json.dumps(summary["psum_2"]))
        if "fsdp" in recs:
            summary["llama_fsdp"] = phase_llama_fsdp(card, one, one4, recs["fsdp"])
        if "sp_attention" in recs:
            summary["sp_attention"] = phase_sp_attention(card, recs["sp_attention"])
        sp_runs = {impl: recs[f"sp_{impl}"] for impl in SP_IMPLS if f"sp_{impl}" in recs}
        if sp_runs:
            summary["sp_llama"] = phase_sp_llama(card, one["losses"], sp_runs)
        if "multislice" in recs:
            summary["multislice"] = _check_multislice(recs["multislice"], card)
        if zoo:
            summary["sp_zoo"] = phase_sp_zoo(card, zoo_yards, {n: recs[n] for n in zoo})
            if jobs is None:
                summary["sp_zoo"]["flash"] = sp_zoo_flash
        summary["model_parallel_ranks"] = recs.get("model_parallel")
        if "sharded_decode" in recs:
            summary["sharded_decode"] = phase_sharded_decode(card, recs["sharded_decode"])
        if {"dist_mnist_data", "mnist_summaries"} & set(recs):
            summary["mnist"] = phase_mnist_jobs(
                card, recs.get("dist_mnist_data"), os.path.join(tmp, "mnist"),
                recs.get("mnist_summaries"), os.path.join(tmp, "mnist_series"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # each job's wall: the slowest rank's
    job_s = {n: max(r[n]["job_wall_s"] for r in w)
             for w in worlds.values() for n in w[0] if n != "lines"}
    walls["5e_s"] = walls["5e_flash_and_yardsticks_s"] + sum(job_s[n] for n in zoo)
    walls["5d_job_s"] = job_s.get("model_parallel", 0.0)
    walls["5f_s"] = sum(job_s.get(name, 0.0) for name, _, _ in _mnist_and_decode_jobs(tmp))
    walls["total_s"] = time.perf_counter() - t0
    walls["5b_5c_s"] = walls["total_s"] - walls["5e_s"] - walls["5d_job_s"] - walls["5f_s"]
    walls["jobs_s"] = job_s
    summary["walls"] = walls
    log(f"multi-process walls ({card}) " + json.dumps(walls))
    return summary


# -- phase 5d: the model-parallel jobs -----------------------------------------

#: phase 5d's steps: t5_multihost (the loss guard needs 20 or more and is
#: not asked for), vit_classify (then its benchmark's max(steps // 2, 5))
#: and the 8-expert moe through the Trainer
MP_T5_STEPS, MP_VIT_STEPS, MP_MOE_STEPS = 10, 6, 6
#: vit_classify's benchmark steps after MP_VIT_STEPS
MP_VIT_BENCH = max(MP_VIT_STEPS // 2, 5)
#: the learning rate of phase 5d's ViT and moe runs (T5 keeps its
#: entry's 1e-4 with a 10-update warmup).  The ranks' first losses read
#: 1.5e-5 (ViT) and 3.1e-5 (moe) of one process's; at vit_classify's
#: 3e-3 and the zoo's 1e-3 AdamW carries the bf16 rounding of the split
#: products' partial sums to 2.4e-3 and 2.1e-3 within six steps, while
#: in float32 at those rates the gaps are 3.2e-7 and 0
#: (``chip_mp_witness.py``, which holds the entries' rates).  At 1e-5
#: the bf16 gaps stay within ``DIST_LOSS_RTOL`` (3.0e-4 and 1.6e-4)
MP_LR = 1e-5
#: K1-K3 at the shapes one rank runs on phase 5d's paths (bf16, D 64):
#: T5-base's cross-attention under tp 2 (its self-attentions carry the
#: relative-position bias and run the plain attention; their shapes are
#: held too), ViT-B/16's under tp 2, and the 8-expert moe's under ep 2
#: (every head, the batch replicated)
MP_FLASH = (
    ("t5_base_tp2_cross_sq32_sk64_b4", dict(b=4, h=6, hkv=6, sq=32, sk=64, d=64, causal=False)),
    ("t5_base_tp2_enc_s64_b4", dict(b=4, h=6, hkv=6, sq=64, sk=64, d=64, causal=False)),
    ("t5_base_tp2_dec_s32_b4", dict(b=4, h=6, hkv=6, sq=32, sk=32, d=64, causal=True)),
    ("vit_b16_tp2_s196_b32", dict(b=32, h=6, hkv=6, sq=196, sk=196, d=64, causal=False)),
    ("moe_e8_ep2_causal_s1024_b8", dict(b=8, h=12, hkv=12, sq=1024, sk=1024, d=64,
                                        causal=True)),
)
#: the kernels line's K1-K3 paths of phase 5d: (path, its run's key)
MP_PATHS = (("t5_multihost_tp2", "t5"), ("vit_classify_tp2", "vit"), ("moe_ep2", "moe"))


def _mp_record(kind, trainer, losses, step_s, wall_s, launches, plain, loss_line=None):
    """One phase 5d run's record in this process: its losses, K1-K3
    launches, plain attention calls, step ms, the parameter bytes it
    holds (the masters) beside the whole model's and, of the leaves
    split over a model axis, its shards' beside their whole; the
    collectives by stage; a digest of each parameter it keeps whole."""

    import hashlib

    from tf_operator_tpu_torch.runtime.bootstrap import world

    rank, n = world()
    whole = {name: math.prod(shape) * 4 for name, shape in trainer.full_shapes.items()}
    held = {name: m.numel() * m.element_size() for name, m in
            zip(trainer.names, trainer.optimizer.params)}
    split = [name for name, dims in zip(trainer.names, trainer._model_dims) if dims]
    digest = hashlib.sha1()
    for name, m, dims in zip(trainer.names, trainer.optimizer.params, trainer._model_dims):
        if not dims:
            digest.update(m.detach().cpu().numpy().tobytes())
    rec = {"kind": kind, "rank": rank, "world": n, "losses": losses,
           "mesh": dict(trainer.mesh.shape) if trainer.mesh is not None else None,
           "launches": launches, "plain_calls": plain, "steps": trainer.host_step,
           "step_ms": step_s * 1e3, "wall_s": wall_s, "layers": trainer.model.cfg.n_layers,
           "param_bytes": {"held": sum(held.values()), "whole": sum(whole.values()),
                           "split_held": sum(held[k] for k in split),
                           "split_whole": sum(whole[k] for k in split), "split_leaves": len(split)},
           "collectives": trainer.collective_stats.snapshot() if trainer.mesh is not None else {},
           "whole_digest": digest.hexdigest(), "loss_line": loss_line,
           "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30}
    rec["collective_s"] = sum(v["seconds"] for v in rec["collectives"].values())
    return rec


def _mp_counts():
    from tf_operator_tpu_torch.ops import _build
    from tf_operator_tpu_torch.ops import flash_attention as fa

    torch.cuda.synchronize()
    return ({k: _build.launches.get(k, 0) for k in FLASH_KERNELS},
            {k: v for k, v in fa.plain_calls.items() if v})


def _mp_zero():
    from tf_operator_tpu_torch.ops import _build
    from tf_operator_tpu_torch.ops import flash_attention as fa

    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    _build.launches.clear()
    fa.plain_calls.clear()


def _loss_line(lines, tag):
    """The ``loss a -> b`` of train_loop's summary line of the run ``tag``."""

    import re

    for ln in reversed(lines):
        if f"[{tag}]" in ln:
            m = re.search(r"loss ([\d.]+) -> ([\d.]+)", ln)
            if m:
                return list(m.groups())
    return None


def rank_model_parallel(data_dir, model_axis):
    """One process of phase 5d (a rank of its 2-rank job, or the
    one-process runs at ``model_axis`` 1): t5_multihost, vit_classify and
    the 8-expert moe in turn (the ViT and the moe at ``MP_LR``), counts
    zeroed just before each and read just after; returns the three
    records."""

    import contextlib
    import io

    from tf_operator_tpu_torch import t5_multihost, vit_classify
    from tf_operator_tpu_torch.data.text import TextBatches, as_lm_batches
    from tf_operator_tpu_torch.models.gpt import gpt_small
    from tf_operator_tpu_torch.models.moe import MoeConfig, MoeLM, moe_lm_loss
    from tf_operator_tpu_torch.models.weights import init_params
    from tf_operator_tpu_torch.parallel.mesh import make_mesh
    from tf_operator_tpu_torch.parallel.trainer import Trainer, TrainerConfig
    from tf_operator_tpu_torch.runtime.bootstrap import initialize, world

    initialize("cuda")
    _, n = world()
    recs = {}
    for kind, entry, argv, tag in (
            ("t5", t5_multihost, ["--model", "t5_base", "--steps", str(MP_T5_STEPS)],
             f"t5_base dp=1 tp={model_axis}"),
            ("vit", vit_classify, ["--model", "vit_b16", "--image-size", "224", "--num-classes",
                                   "1000", "--batch-per-device", "32", "--steps",
                                   str(MP_VIT_STEPS), "--learning-rate", str(MP_LR)],
             f"vit_b16 dp=1 tp={model_axis}")):
        _mp_zero()
        out_buf = io.StringIO()
        with contextlib.redirect_stdout(out_buf):
            out = entry.run(entry.parse_args(argv + ["--steps-per-sync", "1", "--tp",
                                                     str(model_axis)]))
        text = out_buf.getvalue()
        print(text, end="", flush=True)
        launches, plain = _mp_counts()
        recs[kind] = _mp_record(kind, out["trainer"], out["losses"],
                                _steady_step_s(out["resolved_at"]), out["wall_s"], launches,
                                plain, _loss_line(text.splitlines(), tag))
        if "benchmark" in out:
            recs[kind]["benchmark"] = out["benchmark"]
        del out
    _mp_zero()
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = MoeConfig(base=gpt_small(vocab_size=256, max_len=ZOO_SEQ), num_experts=8)
    model = MoeLM.from_state_dict(cfg, init_params(cfg, 0, dev, trainable=True, family=MoeLM),
                                  dev, trainable=True)
    mesh = make_mesh({"ep": model_axis}) if n > 1 else None
    trainer = Trainer(model, TrainerConfig(**dict(ZOO_TRAIN_CFG, learning_rate=MP_LR)),
                      moe_lm_loss, mesh=mesh, shardings="logical")
    batches = iter(as_lm_batches(TextBatches(data_dir, ZOO_ROWS, seed=0)))
    losses, stamps = [], []
    t0 = time.perf_counter()
    for _ in range(MP_MOE_STEPS):
        losses.append(float(trainer.train_step(trainer.shard_global_batch(next(batches)))["loss"]))
        stamps.append(time.perf_counter())
    launches, plain = _mp_counts()
    recs["moe"] = _mp_record("moe", trainer, losses,
                             (stamps[-1] - stamps[0]) / (MP_MOE_STEPS - 1),
                             time.perf_counter() - t0, launches, plain)
    if n > 1:
        # phase 5f: the ep-split moe decodes on its live shards
        prompt = torch.as_tensor(next(batches)["input_ids"][:DECODE_PROMPTS, :DECODE_PROMPT])
        recs["moe"]["decode"] = _held_decode(
            trainer, lambda full: MoeLM.from_state_dict(cfg, full, dev), prompt.long(),
            DECODE_NEW)
    del trainer, model
    free_device_memory()
    return recs


def _model_parallel_job(data_dir):
    return ("model_parallel", "rank_model_parallel", {"data_dir": data_dir, "model_axis": 2})


def phase_model_parallel(card, ranks):
    """Phase 5d (module docstring): K1-K3 at the ranks' shapes, then the
    2-rank job's records ``ranks`` (run in ``phase_multiprocess``'s
    2-rank world on the same corpus: ``ensure_text`` is seeded) against
    the one-process runs; raises with the readings if a rank is off.
    Returns the flash records and the job's records."""

    import tempfile

    from tf_operator_tpu_torch.data.text import ensure_text

    t0 = time.perf_counter()
    flash = [flash_case(name, seed=170 + i, dtype=torch.bfloat16, timed=True, queued=True,
                        **kw) for i, (name, kw) in enumerate(MP_FLASH)]
    log(f"model-parallel flash shapes ({card}) " + json.dumps(
        {r["case"]: {**{k: {f: round(t[f], 5) for f in ("ms", "device_ms", "bound_ms",
                                                         "plain_ms", "library_ms")}
                        | {"bound_by": t["bound_by"]} for k, t in r["timing"].items()},
                     "sdpa_device_ms": r["sdpa_device_ms"],
                     "row_rel_max": max(r["row_rel"].values())} for r in flash}))
    free_device_memory()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mp_")
    try:
        data_dir = os.path.join(tmp, "text")
        ensure_text(data_dir, seq_len=ZOO_SEQ)
        t_one = time.perf_counter()
        one = rank_model_parallel(data_dir, 1)
        one_wall = time.perf_counter() - t_one
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    free_device_memory()
    want_launches = {"t5": 12 * MP_T5_STEPS, "vit": 12 * (MP_VIT_STEPS + MP_VIT_BENCH),
                     "moe": 12 * MP_MOE_STEPS}
    want_plain = {"t5": {"dot_product_attention": T5_PLAIN_PER_FORWARD * MP_T5_STEPS},
                  "vit": {}, "moe": {}}
    want_mesh = {"t5": {"dp": 1, "tp": 2}, "vit": {"dp": 1, "tp": 2}, "moe": {"ep": 2}}
    bad, summary = [], {}
    for kind in ("t5", "vit", "moe"):
        rows = []
        for r, rec in enumerate(ranks):
            run = rec[kind]
            rel = [abs(a - b) / abs(b) for a, b in zip(run["losses"], one[kind]["losses"])]
            rows.append({k: run[k] for k in ("rank", "world", "mesh", "launches", "plain_calls",
                                            "step_ms", "wall_s", "param_bytes", "collectives",
                                            "collective_s", "loss_line",
                                            "max_memory_allocated_gib")}
                        | {"loss_rel_max": max(rel), "losses": run["losses"]}
                        | ({"benchmark": run["benchmark"]} if "benchmark" in run else {}))
            mesh = {k: v for k, v in (run["mesh"] or {}).items() if v > 1}
            if run["world"] != 2 or mesh != {k: v for k, v in want_mesh[kind].items() if v > 1}:
                bad.append(f"{kind} rank {r}: world {run['world']}, mesh {run['mesh']}")
            if run["launches"] != {k: want_launches[kind] for k in FLASH_KERNELS}:
                bad.append(f"{kind} rank {r}: K1-K3 launched {run['launches']}, want "
                           f"{want_launches[kind]} each")
            if run["plain_calls"] != want_plain[kind]:
                bad.append(f"{kind} rank {r}: plain attention {run['plain_calls']}, want "
                           f"{want_plain[kind]}")
            if not (len(run["losses"]) == len(one[kind]["losses"])
                    and all(math.isfinite(x) for x in run["losses"])
                    and max(rel) <= DIST_LOSS_RTOL):
                bad.append(f"{kind} rank {r}: losses {run['losses']} against one process's "
                           f"{one[kind]['losses']} ({max(rel):.3g} relative)")
            pb = run["param_bytes"]
            if not (pb["split_leaves"] and pb["split_held"] * 2 == pb["split_whole"]):
                bad.append(f"{kind} rank {r}: holds {pb} (the split leaves' half)")
        a, b = ranks[0][kind], ranks[1][kind]
        if a["losses"] != b["losses"] or a["loss_line"] != b["loss_line"]:
            bad.append(f"{kind}: the ranks' losses differ: {a['losses']} / {b['losses']}, "
                       f"lines {a['loss_line']} / {b['loss_line']}")
        if a["whole_digest"] != b["whole_digest"]:
            bad.append(f"{kind}: the parameters the ranks keep whole differ")
        one_row = {k: one[kind][k] for k in ("losses", "launches", "plain_calls", "step_ms",
                                              "wall_s", "param_bytes", "loss_line",
                                              "max_memory_allocated_gib")}
        if one[kind]["launches"] != {k: want_launches[kind] for k in FLASH_KERNELS}:
            bad.append(f"{kind} one process: K1-K3 launched {one[kind]['launches']}")
        summary[kind] = {"one_process": one_row, "ranks": rows}
    summary["moe"]["decode"] = _check_decode("moe ep 2 decode",
                                             [r["moe"]["decode"] for r in ranks], bad)
    log(f"moe ep 2 decode: {summary['moe']['decode']['tokens_per_s'][0]:.1f} tokens/s "
        f"({DECODE_PROMPTS} prompts of {DECODE_PROMPT}, {DECODE_NEW} new, gloo) on {card}")
    summary["loss_rtol"] = DIST_LOSS_RTOL
    summary["one_process_wall_s"] = one_wall
    summary["wall_s"] = time.perf_counter() - t0
    log(f"model-parallel jobs ({card}) " + json.dumps(summary))
    if bad:
        raise AssertionError("model-parallel jobs: " + "; ".join(bad))
    return flash, {"ranks": ranks, "one": one}


# -- phase 5f: decoding over tp / ep shards, and the MNIST jobs ----------------

#: phase 5f's llama-wide over {"tp": 2} (all 12 layers): DECODE_STEPS
#: AdamW steps on DECODE_ROWS x DECODE_SEQ bytes (max_len DECODE_SEQ),
#: then DECODE_PROMPTS prompts of DECODE_PROMPT bytes and DECODE_NEW
#: greedy tokens; phase 5d's moe decodes the same prompt shape
DECODE_STEPS, DECODE_ROWS, DECODE_SEQ = 2, 2, 1024
DECODE_PROMPTS, DECODE_PROMPT, DECODE_NEW = 2, 64, 32
#: the sharded decode's logits against the gathered copy's, step by step,
#: both fed the gathered run's tokens: max |difference| over the step's
#: largest |logit|.  bf16: a rank rounds its partial product of a
#: row-parallel projection (attention out, MLP down; the experts'
#: combine) to bf16 before the float32 sum over the line, where one
#: process rounds the whole product once: one rounding apart per
#: projection, amplified through 12 layers of near-random weights (the
#: 7B paths one rounding apart a layer read 0.045 over 32 layers,
#: ``LOGITS_REL_TOL``).  Two logits that each move by at most this can
#: swap only where their margin is below twice it: the free-running ids
#: must be equal up to the first position whose gathered top-2 margin is
#: below twice this
DECODE_LOGIT_RTOL = 5e-2
#: phase 5f's 2-rank dist_mnist --data-dir steps (the reference's guard
#: needs 20 or more) and mnist_with_summaries' defaults (40 steps, a
#: record every 5)
MNIST_DATA_STEPS = 30
MNIST_SUMMARY_STEPS, MNIST_SUMMARY_EVERY = 40, 5


def _forced_logits(dmodel, ids, prompt_len):
    """float32 logits [B, N, V] of the decode model ``dmodel`` fed ``ids``
    [B, P + N]: the prompt, then each later token but the last, a step at
    a time; row j is what token P + j is chosen from.  A model whose vocab
    is split over tp gives its rows gathered over the line."""

    from tf_operator_tpu_torch.models.decode import init_cache
    from tf_operator_tpu_torch.parallel.tensor_parallel import gather_last

    cache = init_cache(dmodel, ids.shape[0])
    rows = [dmodel(ids[:, :prompt_len], cache=cache)[:, -1]]
    for t in range(prompt_len, ids.shape[1] - 1):
        rows.append(dmodel(ids[:, t:t + 1], cache=cache)[:, 0])
    return gather_last(torch.stack(rows, 1), dmodel.tp)


def _held_decode(trainer, gathered_model, prompt, new):
    """On every rank of a job: ``Trainer.generate`` (greedy) on the live
    shards, timed; then rank 0 builds ``gathered_model(state)`` on the
    gathered weights (``Trainer.full_params``) and runs
    ``models/decode.generate`` on it in this one process, and both the
    sharded model (every rank) and the gathered one (rank 0) are fed the
    gathered run's tokens step by step (``_forced_logits``).  Returns the
    rank's ids, tokens/s and K1-K3 launches during the decode; rank 0's
    record adds the logits' error a step, the first position whose
    gathered top-2 margin is below 2 x ``DECODE_LOGIT_RTOL`` of the
    step's largest logit, and the first position the free-running ids
    part."""

    import torch.distributed as dist

    from tf_operator_tpu_torch.models.decode import decode_variant, generate

    rank = dist.get_rank()
    prompt = prompt.to(trainer.device)
    _mp_zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = trainer.generate(prompt, new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = _mp_counts()
    rec = {"rank": rank, "ids": ids.tolist(), "decode_s": wall,
           "tokens_per_s": ids.shape[0] * new / wall, "launches": launches,
           "plain_calls": plain, "max_memory_allocated_gib":
           torch.cuda.max_memory_allocated() / 2**30}
    full = trainer.full_params()
    want = torch.empty_like(ids)
    if rank == 0:
        gmodel = gathered_model({k: v.detach().clone() for k, v in full.items()})
        del full
        trainer.release()
        want.copy_(generate(gmodel, prompt, new))
        with torch.inference_mode():
            glog = _forced_logits(decode_variant(gmodel), want, prompt.shape[1])
        del gmodel
    else:
        del full
        trainer.release()
    dist.broadcast(want, src=0)
    with trainer.inference():
        slog = _forced_logits(decode_variant(trainer.model), want, prompt.shape[1])
    if rank == 0:
        scale = glog.abs().amax(dim=(0, 2))  # [N]
        err = ((slog - glog).abs().amax(dim=(0, 2)) / scale).tolist()
        top2 = glog.topk(2, dim=-1).values
        margin = (top2[..., 0] - top2[..., 1]).amin(dim=0) / scale  # [N]
        close = (margin < 2 * DECODE_LOGIT_RTOL).nonzero()
        parted = (ids[:, prompt.shape[1]:] != want[:, prompt.shape[1]:]).any(0).nonzero()
        rec.update(logit_rel_err=err, logit_rel_max=max(err),
                   first_close_margin=int(close[0]) if len(close) else new,
                   first_parted=int(parted[0]) if len(parted) else new,
                   min_margin_rel=float(margin.min()), gathered_ids=want.tolist())
    free_device_memory()
    return rec


def _check_decode(tag, recs, bad):
    """Phase 5f's checks of one sharded decode's records (``_held_decode``
    on every rank), appending to ``bad``: every rank's ids the same, [B,
    P + N] with the prompt's bytes first; rank 0's logits within
    ``DECODE_LOGIT_RTOL`` and its free-running ids equal to the gathered
    run's up to the first close margin; no K1-K3 launch in the decode.
    Returns the summary row."""

    head = recs[0]
    if any(r["ids"] != head["ids"] for r in recs):
        bad.append(f"{tag}: the ranks' ids differ")
    if head["gathered_ids"] != head["ids"] and head["first_parted"] < head["first_close_margin"]:
        bad.append(f"{tag}: the ids part from the gathered run's at {head['first_parted']}, "
                   f"before the first close margin at {head['first_close_margin']}")
    if not head["logit_rel_max"] <= DECODE_LOGIT_RTOL:
        bad.append(f"{tag}: logits {head['logit_rel_max']:.3g} off the gathered copy's")
    if any(sum(r["launches"].values()) for r in recs):
        bad.append(f"{tag}: the decode launched K1-K3 {[r['launches'] for r in recs]}")
    return {"logit_rel_max": head["logit_rel_max"], "logit_rtol": DECODE_LOGIT_RTOL,
            "first_close_margin": head["first_close_margin"],
            "first_parted": head["first_parted"], "min_margin_rel": head["min_margin_rel"],
            "same_as_gathered": head["ids"] == head["gathered_ids"],
            "tokens_per_s": [r["tokens_per_s"] for r in recs],
            "decode_s": [r["decode_s"] for r in recs],
            "max_memory_allocated_gib": [r["max_memory_allocated_gib"] for r in recs]}


def rank_sharded_decode(data_dir):
    """Phase 5f (1): one rank of llama-wide (all 12 layers, seeded
    weights) over ``{"tp": 2}``: ``DECODE_STEPS`` AdamW steps through the
    ``Trainer`` (K1-K3 at the rank's 8 : 4 heads, counts zeroed just
    before and read just after), then ``_held_decode`` of
    ``DECODE_PROMPTS`` corpus prompts.  Returns the record."""

    from tf_operator_tpu_torch.data.text import TextBatches, as_lm_batches
    from tf_operator_tpu_torch.models.llama import LlamaLM, llama_loss, llama_wide
    from tf_operator_tpu_torch.models.weights import init_params
    from tf_operator_tpu_torch.parallel.mesh import make_mesh
    from tf_operator_tpu_torch.parallel.trainer import Trainer, TrainerConfig
    from tf_operator_tpu_torch.runtime.bootstrap import initialize, world

    dev = initialize("cuda").device
    _, n = world()
    cfg = llama_wide(max_len=DECODE_SEQ)
    _mp_zero()
    model = LlamaLM.from_state_dict(cfg, init_params(cfg, 0, dev, trainable=True), dev,
                                    trainable=True)
    trainer = Trainer(model, TrainerConfig(learning_rate=1e-3), llama_loss,
                      mesh=make_mesh({"tp": n}), shardings="logical")
    batches = iter(as_lm_batches(TextBatches(data_dir, DECODE_ROWS, seed=0)))
    losses, stamps = [], []
    t0 = time.perf_counter()
    for _ in range(DECODE_STEPS):
        losses.append(float(trainer.train_step(trainer.shard_global_batch(next(batches)))
                            ["loss"]))
        stamps.append(time.perf_counter())
    launches, plain = _mp_counts()
    heads = [tuple(trainer.model.layers[0].self_attn.query.kernel.shape),
             tuple(trainer.model.layers[0].self_attn.key.kernel.shape)]
    prompt = torch.as_tensor(next(batches)["input_ids"][:DECODE_PROMPTS, :DECODE_PROMPT])
    decode = _held_decode(trainer, lambda full: LlamaLM.from_state_dict(cfg, full, dev),
                          prompt.long(), DECODE_NEW)
    rec = {"rank": decode["rank"], "world": n, "losses": losses, "launches": launches,
           "plain_calls": plain, "train_s": stamps[-1] - t0, "query_key_shapes": heads,
           "mesh": dict(trainer.mesh.shape), "decode": decode,
           "collectives": trainer.collective_stats.snapshot()}
    del trainer, model
    free_device_memory()
    return rec


def phase_sharded_decode(card, ranks):
    """Phase 5f (1)'s check (the 2-rank job's records ``ranks``): the
    training steps' K1-K3 = 12 x ``DECODE_STEPS`` a rank and no plain
    attention, the ranks' losses equal, each rank holding 8 query and 4
    KV heads of 16 : 8, and the decode (``_check_decode``); prints the
    readings with the decode's tokens/s; raises if a rank is off."""

    bad = []
    want = 12 * DECODE_STEPS
    for rec in ranks:
        if rec["launches"] != {k: want for k in FLASH_KERNELS} or rec["plain_calls"]:
            bad.append(f"rank {rec['rank']}: K1-K3 {rec['launches']} (want {want} each), "
                       f"plain {rec['plain_calls']}")
        if [list(s) for s in rec["query_key_shapes"]] != [[2048, 8, 128], [2048, 4, 128]]:
            bad.append(f"rank {rec['rank']}: q / k kernels {rec['query_key_shapes']}")
        if not all(math.isfinite(x) for x in rec["losses"]):
            bad.append(f"rank {rec['rank']}: losses {rec['losses']}")
    if ranks[0]["losses"] != ranks[1]["losses"]:
        bad.append(f"the ranks' losses differ: {[r['losses'] for r in ranks]}")
    decode = _check_decode("llama-wide tp 2 decode", [r["decode"] for r in ranks], bad)
    summary = {"decode": decode, "ranks": [
        {k: r[k] for k in ("rank", "world", "mesh", "losses", "launches", "train_s")}
        | {"tp_stages": {k: v for k, v in r["collectives"].items() if k.startswith("tp")}}
        for r in ranks]}
    log(f"llama-wide tp 2 sharded decode ({card}) " + json.dumps(summary))
    log(f"llama-wide tp 2 decode: {decode['tokens_per_s'][0]:.1f} tokens/s ({DECODE_PROMPTS} "
        f"prompts of {DECODE_PROMPT}, {DECODE_NEW} new, gloo) on {card}")
    if bad:
        raise AssertionError("llama-wide tp 2 sharded decode: " + "; ".join(bad))
    return summary


def rank_dist_mnist_data(data_dir):
    """Phase 5f (2): one rank of ``dist_mnist --data-dir`` (process 0
    writes the dataset, the other waits for it), ``MNIST_DATA_STEPS``
    steps on the card; returns its exit code, its loss line and the
    record ids of the first batch it trained on (``dist_mnist.run``'s)."""

    import contextlib
    import io

    from tf_operator_tpu_torch import dist_mnist
    from tf_operator_tpu_torch.runtime.bootstrap import world

    args = dist_mnist.parse_args(["--data-dir", data_dir, "--steps", str(MNIST_DATA_STEPS)])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = dist_mnist.run(args)
        rc = dist_mnist.report(args, out["losses"])
    print(buf.getvalue(), end="", flush=True)
    pid, n = world()
    line = [ln for ln in buf.getvalue().splitlines() if ln.startswith(f"process {pid}/{n}:")]
    return {"rank": pid, "world": n, "rc": rc, "line": line[-1] if line else None,
            "first": out["first_ids"] or []}


def rank_mnist_summaries(summary_dir):
    """Phase 5f (3): one rank of ``mnist_with_summaries`` at its defaults
    on the card, writing its series under ``summary_dir``."""

    import contextlib
    import io

    from tf_operator_tpu_torch import mnist_with_summaries
    from tf_operator_tpu_torch.runtime.bootstrap import world

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mnist_with_summaries.main(["--summary-dir", summary_dir])
    print(buf.getvalue(), end="", flush=True)
    pid, n = world()
    return {"rank": pid, "world": n, "rc": rc, "line": buf.getvalue().strip().splitlines()[-1]}


def phase_mnist_jobs(card, data_recs, data_dir, summary_recs, summary_dir):
    """Phase 5f (2) and (3)'s checks: ``dist_mnist --data-dir`` exited 0
    on both ranks with the loss falling and the dataset's commit record
    of the reference's parameters, the record ids of the first batch
    each rank trained on disjoint and of its share of the global batch;
    ``mnist_with_summaries`` exited 0 with the reference's line
    on both ranks, and ``read_series`` gives each process's records at
    steps 5, 10, ..., 40 with ``steps_per_sec`` from the second on and
    finite losses.  Raises if one is off."""

    from tf_operator_tpu_torch.data.synthetic import mnist_meta
    from tf_operator_tpu_torch.utils.summaries import read_series

    bad, out = [], {}
    if data_recs is not None:
        rows = []
        for r, rec in enumerate(data_recs):
            m = re.search(r"loss ([\d.]+) -> ([\d.]+)", rec["line"] or "")
            if rec["rc"] != 0 or not m or not float(m.group(2)) < float(m.group(1)):
                bad.append(f"dist_mnist --data-dir rank {r}: rc {rec['rc']}, {rec['line']!r}")
            rows.append({k: rec[k] for k in ("rank", "rc", "line", "first")})
        with open(os.path.join(data_dir, "meta.json")) as f:
            if json.load(f) != mnist_meta():
                bad.append("dist_mnist --data-dir: the dataset's meta is not mnist_meta()")
        overlap = set(data_recs[0]["first"]) & set(data_recs[1]["first"])
        per = 64 // len(data_recs)  # dist_mnist's default global batch over the ranks
        if overlap or any(len(rec["first"]) != per for rec in data_recs):
            sizes = [len(rec["first"]) for rec in data_recs]
            bad.append(f"dist_mnist --data-dir: first batches of {sizes} ids (want {per}), "
                       f"shared {sorted(overlap)}")
        out["dist_mnist_data"] = {"ranks": rows, "first_batch_overlap": sorted(overlap)}
    if summary_recs is not None:
        series = read_series(summary_dir)
        steps = list(range(MNIST_SUMMARY_EVERY, MNIST_SUMMARY_STEPS + 1, MNIST_SUMMARY_EVERY))
        for r, rec in enumerate(summary_recs):
            if rec["rc"] != 0 or not rec["line"].startswith(f"process {r}/2: final loss "):
                bad.append(f"mnist_with_summaries rank {r}: rc {rec['rc']}, {rec['line']!r}")
        got = sorted(rec["step"] for rec in series)
        if got != sorted(steps * 2):
            bad.append(f"mnist_with_summaries: series steps {got}")
        rates = [rec.get("steps_per_sec") for rec in series if rec["step"] > steps[0]]
        if not rates or not all(x and x > 0 for x in rates) or any(
                rec["step"] == steps[0] and "steps_per_sec" in rec for rec in series):
            bad.append(f"mnist_with_summaries: steps_per_sec {rates}")
        if not all(math.isfinite(rec["loss"]) for rec in series):
            bad.append("mnist_with_summaries: a loss is not finite")
        out["mnist_summaries"] = {"lines": [rec["line"] for rec in summary_recs],
                                  "records": len(series), "steps_per_sec": rates,
                                  "losses": [rec["loss"] for rec in series]}
    log(f"mnist jobs ({card}) " + json.dumps(out))
    if bad:
        raise AssertionError("mnist jobs: " + "; ".join(bad))
    return out


def phase_serve_artifact(trainer, export_dir):
    """Train -> export -> serve: the port's serve_lm on the exported
    artifact (K4 at Hkv 8) answers one greedy request with the tokens
    ``generate`` gives on the trained parameters in this process."""

    from tf_operator_tpu_torch.data.text import decode_bytes
    from tf_operator_tpu_torch.models.decode import generate
    from tf_operator_tpu_torch.ops import _build
    from tf_operator_tpu_torch.serve_lm import Server, load_model, make_pool

    prompt, n_new = "the sharded ", 32
    model = load_model(torch.device("cuda"), max_len=2048, artifact=export_dir)
    pool = make_pool(model, model_label="llama", slots=2, steps_per_sync=8, kv_block_size=16)
    server = Server(pool).start()
    try:
        _build.launches.clear()
        status, body, *_ = _post(server.port, {"prompt": prompt, "max_new_tokens": n_new})
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


def load_int8_7b():
    """The 7B int8 model as ``--quantize int8`` loads it
    (``load_model(quantize="int8")``: the seeded float32 draws quantized
    as they are made), and its weight bytes against bf16's."""

    from tf_operator_tpu_torch.models.llama import LlamaLM, llama_7b_shape
    from tf_operator_tpu_torch.ops.quant import state_bytes
    from tf_operator_tpu_torch.serve_lm import load_model

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = load_model(dev, max_len=2048, model="llama-7b", init_seed=0, quantize="int8")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    weights = {"bf16_bytes": state_bytes(LlamaLM(llama_7b_shape(max_len=2048),
                                                 device="meta").state_dict()),
               "int8_bytes": state_bytes(model.state_dict()),
               "load_and_quantize_s": load_s,
               "peak_during_load_gib": (torch.cuda.max_memory_allocated() - base) / 2**30}
    log("int8 weights " + json.dumps(weights))
    return model


def phase_int8_serving(bf16_stats, model):
    """Phase 9: the 7B int8 model (``load_int8_7b``) behind the server;
    K7, GEMM-route and K4 counts; no plain calls."""

    from tf_operator_tpu_torch.ops import quant_matmul as qm

    qm.plain_calls.clear()
    stats, pool = phase_main_path(model, tag="int8 main path")
    plain = dict(qm.plain_calls)
    n_proj = 7 * model.cfg.n_layers + 1
    rows = stats["prefill_rows"]
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
#: ResNet training of the main path: resnet_dp's own 192 steps (24
#: windows of 8: the step-time sentinel, fed once a window, freezes its
#: drift reference at the 16th, and the 8 after it are what the drift
#: ratio compares), then its benchmark's 192 // 2
RESNET_STEPS = 192
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
    --image-size 224 --batch-per-device 64 --steps 192`` in process.  The
    counts are zeroed just before and read just after: K5 and K6 must
    each launch 53 x (192 + 96) times and no plain version may run."""

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
    before = _sync_totals()
    out = resnet_dp.run(args)
    torch.cuda.synchronize()
    out["loop"]["train_sync_total_before"] = before
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
    stats["loop_records"] = check_loop_records(out["loop"], RESNET_STEPS,
                                               args.steps_per_sync, "resnet train")
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


#: training steps of the main path: 24 windows of 5 (the step-time
#: sentinel, fed once a window, freezes its drift reference at the 16th,
#: and the 8 after it are what the drift ratio compares; the
#: loss-decrease guard of train_loop needs 20 or more)
TRAIN_STEPS = 120


def _kernel_entry(name, source, replaces, launches, err, timing):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": timing["ms"],
            "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"], "library_ms": timing["library_ms"]}


#: ``--ab``'s runs: an earlier commit's tree and this one in turns
AB_ORDER = ("parent", "change", "change", "parent")

#: one ``--ab`` run, in a tree's root: that tree's own phases 4d, 5 and 7
AB_RUN = """
import json, os, sys, tempfile, torch
import chip_smoke as c
from tf_operator_tpu_torch.models.llama import LlamaLM, llama_7b_shape
from tf_operator_tpu_torch.models.weights import init_params
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
c.phase_build()
resnet = c.phase_resnet_train()[0]
c.free_device_memory()
tmp = tempfile.mkdtemp(prefix="chip_smoke_ab_")
train = c.phase_train(os.path.join(tmp, "text"), os.path.join(tmp, "artifact"), c.TRAIN_STEPS)[0]
c.free_device_memory()
dev = torch.device("cuda")
cfg = llama_7b_shape(max_len=2048)
serve, pool = c.phase_main_path(LlamaLM.from_state_dict(cfg, init_params(cfg, 0, dev), dev))
print("AB " + json.dumps({
    "resnet_step_ms": resnet["step_ms_train_loop"], "llama_step_ms": train["step_ms"],
    "decode_tokens_per_s": serve["decode_tokens_per_s"]}), flush=True)
"""


def ab_main(parent):
    """``python3 chip_smoke.py --ab DIR``: phases 4d, 5 and 7 of the tree
    unpacked at ``DIR`` (an earlier commit's ``git archive``) and of this
    tree, each run by its own ``chip_smoke.py`` in a process of its own,
    in ``AB_ORDER``; prints each run's ResNet and llama step ms and
    decode tokens/s, then each side's median and spread (max - min)
    beside the card line.  The libraries are built once here and shared:
    a library's name hashes its source, so a tree whose sources are the
    same finds them built."""

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs the port on a GPU", file=sys.stderr)
        return 2
    from tf_operator_tpu_torch.ops import _build

    card = card_line()
    here = os.path.dirname(os.path.abspath(__file__))
    trees = {"parent": os.path.abspath(parent), "change": here}
    subprocess.run([sys.executable, "-c", "import chip_smoke as c; c.phase_build()"],
                   cwd=here, check=True, timeout=900)
    parent_build = os.path.join(trees["parent"], os.path.relpath(_build.BUILD_DIR, here))
    os.makedirs(parent_build, exist_ok=True)
    for f in os.listdir(_build.BUILD_DIR):
        if f.endswith(".so"):
            shutil.copy2(os.path.join(_build.BUILD_DIR, f), parent_build)
    out_dir = os.path.join(here, "build", "ab")
    os.makedirs(out_dir, exist_ok=True)
    runs = []
    for i, side in enumerate(AB_ORDER):
        proc = subprocess.run([sys.executable, "-c", AB_RUN], cwd=trees[side],
                              capture_output=True, text=True, timeout=1500)
        with open(os.path.join(out_dir, f"ab-{i}-{side}.log"), "w") as f:
            f.write(proc.stdout + proc.stderr)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
        if proc.returncode != 0 or not lines:
            raise AssertionError(f"ab run {i} ({side}) exited {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        runs.append(dict(json.loads(lines[-1][3:]), side=side))
        log(f"ab run ({card}) " + json.dumps(runs[-1]))
    summary = {}
    for side in ("parent", "change"):
        mine = [r for r in runs if r["side"] == side]
        summary[side] = {key: {"median": statistics.median(r[key] for r in mine),
                               "spread": max(r[key] for r in mine) - min(r[key] for r in mine),
                               "runs": [r[key] for r in mine]}
                         for key in ("resnet_step_ms", "llama_step_ms", "decode_tokens_per_s")}
    log(f"ab ({card}) " + json.dumps(summary))
    print(card)
    return 0


def main():
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs the port on a GPU", file=sys.stderr)
        return 2
    import faulthandler
    import tempfile

    # a fatal signal prints every thread's Python stack to stderr
    faulthandler.enable(all_threads=True)

    from tf_operator_tpu_torch import resolve_device
    from tf_operator_tpu_torch.data.text import TextBatches, as_lm_batches
    from tf_operator_tpu_torch.models.llama import LlamaLM, llama_7b_shape
    from tf_operator_tpu_torch.models.weights import init_params
    from tf_operator_tpu_torch.ops.paged_attention import KERNEL
    from tf_operator_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()

    def done(what):
        log(f"{what} done at {time.perf_counter() - t0:.1f} s")

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
        log(f"training phases done at {time.perf_counter() - t0:.1f} s")
        # phase 16 fine-tunes phase 5's export
        pp_flash, pp_runs = phase_lora_pipeline(export_dir, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    free_device_memory()
    log(f"phase 16 done at {time.perf_counter() - t0:.1f} s")
    _, encoder_runs = phase_encoders(card)
    log(f"encoder phase done at {time.perf_counter() - t0:.1f} s")
    _, zoo_k7, zoo_runs = phase_zoo(card)
    log(f"decoder zoo phase done at {time.perf_counter() - t0:.1f} s")
    multi = phase_multiprocess(card)
    log(f"multi-process phases done at {time.perf_counter() - t0:.1f} s")
    _, mp_runs = phase_model_parallel(card, ranks=multi["model_parallel_ranks"])
    log(f"model-parallel phase done at {time.perf_counter() - t0:.1f} s")

    dev = resolve_device()
    cfg = llama_7b_shape(max_len=2048)
    t_init = time.perf_counter()
    model = LlamaLM.from_state_dict(cfg, init_params(cfg, 0, dev), dev)
    torch.cuda.synchronize()
    log(f"llama_7b_shape bf16 seeded weights on the card in "
        f"{time.perf_counter() - t_init:.1f} s")
    main_stats, pool = phase_main_path(model)
    phase_decode_profile(pool)
    done("phase 7")
    del pool
    free_device_memory()
    phase_plane_cost(model, card)
    done("phase 7c")
    phase_pressure(model, card)
    done("phase 7b")
    phase_end_to_end(model)
    # the int8 model serves as phase 7d's self-draft and then as phase
    # 9's model, so the weights are made and quantized once
    int8_model = load_int8_7b()
    phase_speculative(model, int8_model, card)
    done("phases 8 and 7d")
    chunked = phase_chunked(model, card, main_stats, tag="chunked bf16")
    done("phase 11")
    free_device_memory()
    phase_contiguous(model, card)
    done("phase 12")
    free_device_memory()
    fleet = phase_fleet(model, card, main_stats)
    phase_disaggregated(model, card, fleet)
    done("phases 13a and 13b")
    phase_fleet_http(card)
    free_device_memory()
    # the pool holds reference cycles (the prefix cache's callbacks), so
    # the bf16 weights and arena go only with a collection
    del model
    free_device_memory()
    log(f"bf16 serving phases done at {time.perf_counter() - t0:.1f} s")

    int8_stats, model = phase_int8_serving(main_stats, int8_model)
    del int8_model
    int8_chunked = phase_chunked(model, card, int8_stats, tag="chunked int8")
    log(f"chunked decode ({card}) " + json.dumps({
        side: {k: r[k] for k in ("decode_tokens_per_s", "max_memory_allocated_gib")}
        for side, r in (("bf16", chunked), ("int8", int8_chunked))}))
    free_device_memory()
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
        # each path's launches, counted from zero around its own run
        by_path = {"llama_pretrain": train_stats["launches"].get(kname, 0),
                   **{path: r["launches"][kname] for path, r in encoder_runs.items()},
                   **{path: zoo_runs[key]["launches"][kname] for path, key in ZOO_TRAIN_PATHS},
                   "llama_pretrain_moe_job": sum(r["launches"][kname]
                                                 for r in zoo_runs["moe_tiny_job"]["ranks"]),
                   # phase 5d's 2-rank jobs: both ranks' launches
                   **{path: sum(r[key]["launches"][kname] for r in mp_runs["ranks"])
                      for path, key in MP_PATHS},
                   # phase 16: lora_finetune, and both ranks of each pp job
                   "lora_finetune": pp_runs["lora"]["launches"][kname],
                   "pipelined_lm_pp2": sum(r["launches"][kname]
                                           for r in pp_runs["pipeline"]["ranks"]),
                   **{f"gpt_pipeline_pp2_{family}": sum(
                       pp_runs["pipeline"]["gpt_pipeline"][family]["launches"][i][kname]
                       for i in range(2)) for family in ("gpt", "llama")},
                   # phase 5e: every rank of each job
                   **{path: sum(r["launches"][kname] for r in ranks)
                      for path, ranks in multi["sp_zoo"]["runs"].items()},
                   # phase 5f: both ranks of the llama-wide tp 2 job's steps
                   "llama_wide_tp2_decode_job": sum(
                       r["launches"][kname] for r in multi["sharded_decode"]["ranks"])}
        entry = _kernel_entry(
            kname, "tf_operator_tpu_torch/csrc/flash_attention.cu", replaces[kname],
            sum(by_path.values()), wide["max_abs_err"][errs[kname]], wide["timing"][kname])
        entry["launches_by_path"] = by_path
        # phase 16's and phase 5e's shapes: device (queued) and
        # host-included ms, the bound, SDPA's device forward / backward
        for key, cases in (("phase16_shapes", pp_flash),
                           ("phase5e_shapes", multi["sp_zoo"]["flash"])):
            entry[key] = {
                r["case"]: {"device_ms": r["timing"][kname]["device_ms"],
                            "ms": r["timing"][kname]["ms"],
                            "bound_ms": r["timing"][kname]["bound_ms"],
                            "bound_by": r["timing"][kname]["bound_by"],
                            "plain_ms": r["timing"][kname]["plain_ms"],
                            "max_abs_err": r["max_abs_err"][errs[kname]],
                            "sdpa_device_ms": r["sdpa_device_ms"]} for r in cases}
        kernels.insert(-1, entry)
    step = k7_decode_step(k7)
    k7_by_path = {"serve_lm_llama_7b_int8_pool": int8_stats["launches"].get("quant_matmul", 0),
                  "serve_lm_gpt_small_int8_chunked":
                  zoo_runs["gpt_small_serving"]["chunked_int8"]["launches"].get("quant_matmul",
                                                                                0)}
    entry = _kernel_entry(
        "quant_matmul", "tf_operator_tpu_torch/csrc/quant_matmul.cu",
        "tf_operator_tpu/ops/quant_matmul.py:60", sum(k7_by_path.values()),
        max(step["max_abs_err"], *(r["max_abs_err"] for r in zoo_k7)), step)
    entry["launches_by_path"] = k7_by_path
    kernels.append(entry)
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
    from tf_operator_tpu_torch.utils.costplane import default_costplane

    ledger = default_costplane.compiles.snapshot(limit=0)
    log(f"compile ledger ({card}) " + json.dumps({"total": ledger["total"],
                                                  "byProgram": ledger["byProgram"]}))
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--ab":
        sys.exit(ab_main(sys.argv[2]))
    sys.exit(main())
