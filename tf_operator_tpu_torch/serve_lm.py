"""LM serving over HTTP (the port of ``examples/serve_lm.py``).

    python -m tf_operator_tpu_torch.serve_lm --model llama-7b --init-seed 0 --max-len 2048
    python -m tf_operator_tpu_torch.serve_lm --artifact DIR --prompt-cache 4
    python -m tf_operator_tpu_torch.serve_lm --artifact DIR --batching 8 --quantize int8
    python -m tf_operator_tpu_torch.serve_lm --model llama-7b --batching 8 --speculative --speculative-force
    curl -s localhost:8600/generate -d '{"prompt": "the sharded ", "max_new_tokens": 32}'

The serving mode follows the JAX server's flags (``build_decoder``):

- ``--batching 0`` (the default): one request at a time through
  ``ChunkedServingDecoder`` (models/decode.py), on the request's own
  thread; ``--prompt-cache N`` keeps an LRU of N exact-prompt snapshots
  (refused beside ``--batching``, with the JAX server's message);
- ``--batching SLOTS``: the paged pool (models/batching.py), driven by
  one decode loop thread;
- ``--batching SLOTS`` on a model the paged pool refuses (a rolling
  window shorter than max_len, or the gpt and moe families): it prints
  ``paged pool unavailable (...); serving the contiguous slot pool`` and
  serves ``ContinuousBatchingDecoder``; ``--speculative`` is refused
  there.

``POST /generate`` takes ``prompt``, ``max_new_tokens`` (default 32),
``temperature`` (quantised to a 0.05 grid), ``top_k``, ``seed``,
``stop`` and ``tier`` and answers ``{"prompt", "sample", "seed",
"request_id"}``; prompts are byte-level ids.  Client errors are 400s
with the JAX server's messages.  Every request runs under a
``serve.generate`` span: an incoming ``x-trace-id`` (and
``x-parent-span-id``) is adopted, else a trace is rooted; its id is the
``request_id`` and is echoed in ``x-trace-id`` on every reply.

The serving plane's records (the JAX server's endpoints):

- ``GET /healthz``: ``{"ok": true}``;
- ``GET /metrics``: the Prometheus text exposition (request, SLO,
  dispatch, queue, ``kv_blocks_*``, preemption and swap families);
- ``GET /traces`` and ``/traces/<id>``: the trace store;
- ``GET /requests`` and ``/requests/<id>``: request autopsies;
- ``GET /debug/arena``: the arena's occupancy timeline;
- ``GET /slo``: per-tier quantiles of the SLO families and the load
  gauges;
- ``GET /alerts``: the alert engine's state over the default rules;
- ``GET /debug/flightrecorder``: the flight recorder's ndjson dump;
- ``GET /debug/compiles``: the compile ledger (``utils/costplane.py``):
  the process ledger, where the kernels record each nvcc build, each
  library load and the first launch of each kernel variant class,
  mirrored into the server's registry (``compile_total``,
  ``compile_seconds`` on ``/metrics``);
- ``GET /debug/memory``: the device-memory accountant: the weights, the
  KV arena (and the draft twin's), the seats' device state, swap
  staging on the host and the window's peak transient by device, with
  the limit, the headroom and the coverage of what the caching
  allocator says is live;
- ``GET /debug/profile?seconds=N`` (0 < N <= 30, default 1):
  ``torch.profiler`` over the live decode loop, started, stopped and
  exported on the request's thread (``ProfileCapture``).  The loop keeps
  stepping while it records; on a card the trace holds the CUDA
  activity alone (no host ops), the profiler starts and stops only
  while no server thread is inside device work (``DEVICE_GATE``), and
  its stop and the trace's export hold the interpreter lock, so the
  loop pauses for about as long as they take (seconds on a busy card).
  The answer names the artifact directory
  (``serve-profile-c<compiles>-...``, under ``$TPUJOB_PROFILE_DIR`` or
  the temporary directory) that holds ``trace.json``, a Chrome trace,
  and ``COSTPLANE.json``.  400 for a bad ``seconds``, 503 when a pool
  has no request seated or queued, 409 while another profile runs;
  only ``/debug/profile`` itself or with a query matches.

In the chunked mode the records are the JAX server's without a pool:
``/generate`` answers ``{"prompt", "sample", "seed"}``, its span and SLO
observations carry ``mode="chunked"`` (queue wait 0, TTFT and time per
output token from the generate's wall), ``top_k`` has no upper bound,
``/metrics`` adds ``serve_prompt_cache_hits``, ``/requests`` is empty
and ``/debug/arena`` lists no replica.

A pool's driver thread beats a ``serving.pool`` heartbeat on the
process watchdog (``utils/watchdog.py``); ``main`` starts the watchdog
when ``TPUJOB_WATCHDOG=1`` (deadline ``TPUJOB_WATCHDOG_DEADLINE``).

Speculative decoding (``--speculative``, ``--spec-k K``, ``--spec-tiers
T1[,T2]``): the pool's speculative mode (models/batching.py), gated per
SLO tier (interactive by default), with an int8 self-draft: the served
model itself under ``--quantize int8``, else its int8 twin quantized
from the same float32 weights (the artifact's npz or the seed's draws).
``--speculative`` alone serves 4 slots, as the JAX server does.  A tier
that is not an SLO tier, or a model the paged pool refuses, fails
startup.  ``/metrics`` then adds ``serve_spec_acceptance_rate`` and
``serve_spec_dispatches_per_token`` (left out while no token has been
emitted) to the ``serve_spec_*_total`` counters.  ``--speculative``
refuses to start when the port's own record
(``tf_operator_tpu_torch/spec_measured.json``, written from a card run of
``chip_smoke.py``'s speculative phase) says speculation is slower than
the plain pool; ``--speculative-force`` serves it anyway.

Multi-replica and disaggregated serving (the JAX server's flags, which
need ``--batching``): ``--replicas N`` runs N pool replicas over the one
model (its weights held and registered once), each with its own arena
and driver thread (heartbeat ``serving.pool<i>``), behind one admission
queue (models/pool_router.py: least blocks in use).  ``/metrics`` labels
each replica's series ``{replica}``, ``/slo`` merges them,
``/requests`` and ``/debug/arena`` merge the replicas' logs and
timelines.  ``--roles prefill=1,decode=2`` phase-splits the fleet: a
prompt with a full block before its last token prefills on a prefill
replica, which publishes its blocks into a shared host-side
``PrefixFabric``; a decode replica maps the chain and pulls only its
missing tail (one ``migrate_in`` dispatch), and TTFT spans the whole
handshake.  ``--fabric-peers HOST:PORT,...`` (may be empty) and
``--fabric-port P`` (or ``$TPUJOB_FABRIC_PORT``) make the fabric a
fleet's: local misses pull published blocks from peers over HTTP
(models/fabric_service.py, the JAX wire), each request's prompt is
published before its admission, and a ``FabricServer`` exports this
process's blocks on ``P`` (any free port when only peers are given).
``GET /debug/fabric`` reads the fabric (404 without one);
``/debug/arena`` carries its snapshot.

SLO tiers: the body's ``tier``, else the ``x-slo-tier`` header, else
``batch``; anything but ``interactive`` or ``batch`` is a 400.  The
pool reserves lazily (the prompt's blocks plus one, then growth at
block boundaries), admits by priority (interactive first, batch
boosted after 30 s in the queue), and under arena pressure preempts
batch seats mid-decode, swapping their KV blocks to host memory and
resuming them later with the same tokens (models/batching.py).
``--kv-swap-blocks N`` caps the host swap arena at N blocks (default:
unbounded); with both arenas full, requests wait in the queue or are
parked without a copy rather than fail mid-decode (a cap that no
victim fits can leave two parked requests waiting on each other).

The weights come from a seed (``--model NAME --init-seed N``, made on
the device: ``llama-7b``, ``llama-tiny``, ``gpt-small``, ``gpt-tiny``,
``moe-tiny`` or ``moe-gpt-small``) or from an ``export_params``
directory (``--artifact DIR``: ``params.npz`` of flat flax-path keys,
read with numpy, and ``model.json`` of any family, gpt, llama or moe,
checked as the JAX server checks it: ``main`` exits on a vocab other
than 256, a ``--max-len`` above the trained length is capped with its
line, and the records' ``model`` label is the family).  A gpt or moe model is not
pageable, so ``--batching SLOTS`` serves it through the contiguous slot
pool after the fallback line, and ``--speculative`` and ``--roles``
with a prefill replica fail with the JAX server's errors.
``--quantize int8`` holds the projection kernels (every ``kernel`` of
>= 4096 elements; the embedding stays bf16) as int8 with
per-output-channel scales, quantized from the float32 weights as they
are made or read (ops/quant.py); their products then run the int8
matmul (the CUDA kernel K7 on the card).  The moe family's int8 weights
(per-expert scales for the expert stacks) are dequantized to bf16 when
the model is built, as the JAX package materializes them before each
apply, so K7 is not on its path.

The flags are the JAX server's but for these differences:
``--artifact`` is optional, ``--model``, ``--init-seed``,
``--steps-per-sync`` and ``--device cuda|cpu`` (for ``--platform``) are
the port's own, and ``--paged-kernel`` takes ``auto`` and ``on`` (the
kernel on the card, its plain version for CPU tensors) and refuses
``off`` and ``interpret``, because the port never falls back from its
kernel on the card.  The server runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from tf_operator_tpu_torch.bootstrap.tpu_env import ENV_FABRIC_PORT
from tf_operator_tpu_torch.device import resolve_device
from tf_operator_tpu_torch.models.batching import (
    TOP_K_MAX,
    ContinuousBatchingDecoder,
    PagedContinuousBatchingDecoder,
)
from tf_operator_tpu_torch.models.decode import ChunkedServingDecoder
from tf_operator_tpu_torch.models.fabric_service import FabricServer, FleetFabric
from tf_operator_tpu_torch.models.gpt import CausalLM, gpt_small, gpt_tiny
from tf_operator_tpu_torch.models.kv_blocks import NotPageableError
from tf_operator_tpu_torch.models.llama import LlamaLM, llama_7b_shape, llama_tiny
from tf_operator_tpu_torch.models.moe import MoeConfig, MoeLM, moe_tiny
from tf_operator_tpu_torch.models.pool_router import PoolRouter
from tf_operator_tpu_torch.models.prefix_cache import PrefixFabric
from tf_operator_tpu_torch.models.registry import model_from_description
from tf_operator_tpu_torch.models.transformer import Family
from tf_operator_tpu_torch.models.weights import init_params, load_npz
from tf_operator_tpu_torch.ops.quant import QTensor, state_bytes
from tf_operator_tpu_torch.parallel.checkpoint import MODEL_FILE, PARAMS_FILE
from tf_operator_tpu_torch.utils import flight
from tf_operator_tpu_torch.utils.alerts import AlertEngine, default_rules
from tf_operator_tpu_torch.utils.costplane import CostPlane, default_costplane
from tf_operator_tpu_torch.utils.metrics import (
    SLO_BUCKETS,
    DispatchLedger,
    Metrics,
    finite_summary,
)
from tf_operator_tpu_torch.utils.trace import TRACE_HEADER, Tracer, extract_headers
from tf_operator_tpu_torch.utils.watchdog import default_watchdog, maybe_start_from_env


def decode_bytes(arr) -> str:
    """uint8/int token array -> printable string (the detokenizer)."""

    b = np.asarray(arr).reshape(-1).astype(np.uint8).tobytes()
    return b.decode("ascii", errors="replace")


#: the serving SLO families: long-tail buckets, and /slo's summaries
SLO_FAMILIES = (
    "serve_ttft_seconds",
    "serve_time_per_output_token_seconds",
    "serve_queue_wait_seconds",
    "serve_request_seconds",
)

#: /debug/arena returns at most this many samples of the timeline
ARENA_SAMPLE_LIMIT = 160

#: /debug/profile's longest capture (seconds), the JAX server's
PROFILE_MAX_SECONDS = 30.0

#: the driver thread's heartbeat on the process watchdog (a fleet's
#: replica i beats ``serving.pool<i>``)
POOL_HEARTBEAT = "serving.pool"


#: a fleet-mode publish waits this long for its prefill
PUBLISH_TIMEOUT_S = 120.0

#: the port's measured verdict on speculation: the ``spec_paged_speedup``
#: row (the speculative pool's interactive decode tokens/s over the plain
#: pool's at the same arena) from a card run of chip_smoke.py's
#: speculative phase, with the card, its power limit, the date and the
#: phase.  The JAX server's benchmarks/LAST_MEASURED.json row is the JAX
#: pool's on another machine, so the port does not read it
SPEC_RECORD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "spec_measured.json")


def speculative_slowdown(ledger_path: Optional[str] = None):
    """The measured speculative verdict: ``(speedup, row)`` from the
    ``spec_paged_speedup`` row of the record (``SPEC_RECORD`` unless
    ``ledger_path``), or ``(None, None)`` when nothing was measured."""

    path = SPEC_RECORD if ledger_path is None else ledger_path
    try:
        with open(path) as f:
            ledger = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None, None
    row = ledger.get("spec_paged_speedup") if isinstance(ledger, dict) else None
    if not isinstance(row, dict) or "value" not in row:
        return None, None
    return row["value"], dict(row, metric="spec_paged_speedup")


def refuse_speculative(args: argparse.Namespace, ledger_path: Optional[str] = None) -> None:
    """The JAX server's guard: ``--speculative`` without
    ``--speculative-force`` exits when the best measured speedup is
    below 1 (a measured slowdown is not a feature); with no record it
    serves."""

    if not args.speculative or args.speculative_force:
        return
    best, row = speculative_slowdown(ledger_path)
    if best is not None and best < 1.0:
        raise SystemExit(
            f"--speculative refused: the MEASURED speculative config is {best}x of "
            f"the non-speculative paged pool at the same arena "
            f"({row.get('config', 'int8 self-draft on the paged pool')}; {row['metric']}, "
            f"{row.get('card', 'card not recorded')} at {row.get('power_limit')}, "
            f"{row.get('artifact')}, "
            f"{row.get('date')}) — serving it would be a measured slowdown, not a "
            "feature.  Re-measure with `python3 chip_smoke.py` on the card, or pass "
            "--speculative-force on a deployment whose dispatch economics differ."
        )


def _records(metrics: Optional[Metrics], tracer: Optional[Tracer]) -> DispatchLedger:
    """The server's records: one ``Metrics`` registry (the SLO families
    on the long-tail buckets) and one ``Tracer``, under a
    ``DispatchLedger``."""

    metrics = metrics if metrics is not None else Metrics()
    tracer = tracer if tracer is not None else Tracer()
    for fam in SLO_FAMILIES:
        metrics.set_buckets(fam, SLO_BUCKETS)
    return DispatchLedger(metrics=metrics, tracer=tracer)


def parse_roles(spec: str) -> "list[str]":
    """``--roles prefill=1,decode=2`` -> ["prefill", "decode", "decode"]
    (the JAX server's rules and messages): roles from
    ``REPLICA_ROLES``; a spec with a prefill replica needs a decode or
    unified one, and one with a decode replica needs a prefill one."""

    roles: "list[str]" = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"--roles entries are role=count, got {part!r}")
        role, _, count = part.partition("=")
        role = role.strip()
        if role not in ("prefill", "decode", "unified"):
            raise ValueError(f"unknown role {role!r} (prefill|decode|unified)")
        try:
            n = int(count)
        except ValueError:
            raise ValueError(f"--roles count must be an int, got {count!r}")
        if n < 0:
            raise ValueError(f"--roles count must be >= 0, got {n}")
        roles.extend([role] * n)
    if not roles:
        raise ValueError("--roles declared no replicas")
    if "prefill" in roles and not any(r in ("decode", "unified") for r in roles):
        raise ValueError(
            "--roles with prefill replicas needs at least one decode/unified replica "
            "(prefill replicas never decode)"
        )
    if "decode" in roles and "prefill" not in roles:
        raise ValueError(
            "--roles with decode replicas needs at least one prefill replica (use "
            "unified=N for a non-split fleet)"
        )
    return roles


def make_pool(model: Family, *, model_label: str = "unknown",
              metrics: Optional[Metrics] = None, tracer: Optional[Tracer] = None,
              pool_class=PagedContinuousBatchingDecoder, replicas: int = 1,
              roles: Optional[list] = None, fabric_peers: Optional[list] = None,
              **pool_kw):
    """A pool (``pool_class``: the paged pool, or the contiguous one) with
    its records, as the server serves it: the server's records
    (``_records``) and one ``CostPlane`` over the registry whose compile
    ledger is the process ledger (where the kernels record), with the
    weights registered (the model's, and a draft model's that holds
    other storage).  ``pool_kw`` are the pool's own arguments.

    With ``replicas`` > 1 (or ``roles``, one a replica) it is a
    ``PoolRouter`` over that many pools of the one model, which share the
    records and the cost plane (the weights registered once, each arena
    added), labelled ``"0"``, ``"1"``, ...  A prefill role, or
    ``fabric_peers`` (a list, empty for discovery by announcement), gives
    the paged replicas one ``PrefixFabric``, made a ``FleetFabric`` over
    those peers by the second; the contiguous pool takes a label only."""

    n = max(1, int(replicas))
    role_list = list(roles) if roles else ["unified"] * n
    if len(role_list) != n:
        raise ValueError(f"--roles declares {len(role_list)} replicas but --replicas says {n}")
    ledger = _records(metrics, tracer)
    costplane = CostPlane(metrics=ledger.metrics, compiles=default_costplane.compiles)
    draft = pool_kw.get("draft_model")
    costplane.hbm.register_tree("weights", [model] if draft is None else [model, draft])
    fabric = None
    if "prefill" in role_list or fabric_peers is not None:
        fabric = PrefixFabric(metrics=ledger.metrics, model_label=model_label)
        if fabric_peers is not None:
            fabric = FleetFabric(fabric, peers=fabric_peers, metrics=ledger.metrics,
                                 model_label=model_label)
    pools = []
    for i, role in enumerate(role_list):
        kw = dict(pool_kw, replica_label=str(i) if n > 1 else "")
        if pool_class is not ContinuousBatchingDecoder:
            kw.update(role=role, fabric=fabric)
        pools.append(pool_class(model, ledger=ledger, metrics=ledger.metrics,
                                model_label=model_label, costplane=costplane, **kw))
    return pools[0] if n == 1 else PoolRouter(pools, tracer=ledger.tracer)


def make_chunked(model: Family, *, prompt_cache: int = 0,
                 metrics: Optional[Metrics] = None,
                 tracer: Optional[Tracer] = None) -> ChunkedServingDecoder:
    """The chunked decoder with the server's records (``_records``): its
    ``prefill`` and ``decode`` dispatches and its prompt cache's counters
    land in the server's registry."""

    return ChunkedServingDecoder(model, prompt_cache=prompt_cache,
                                 ledger=_records(metrics, tracer))


class DeviceGate:
    """Many workers, one quieter.  The server's threads that launch
    device work (a pool's window, a request's staged prefill or fabric
    publish, a chunked request) each hold ``work()`` around it, and may
    run together; ``quiet()`` waits until none is inside, holds new ones
    out (they wait, so a quieter is never starved) and runs alone.  A
    worker must not enter ``work()`` again inside its own."""

    def __init__(self):
        self._cond = threading.Condition()
        self._workers = 0
        self._quiet = False
        self._waiting = 0

    @contextlib.contextmanager
    def work(self):
        with self._cond:
            while self._quiet or self._waiting:
                self._cond.wait()
            self._workers += 1
        try:
            yield
        finally:
            with self._cond:
                self._workers -= 1
                if self._workers == 0:
                    self._cond.notify_all()

    @contextlib.contextmanager
    def quiet(self):
        with self._cond:
            self._waiting += 1
            try:
                while self._quiet or self._workers:
                    self._cond.wait()
            finally:
                self._waiting -= 1
            self._quiet = True
        try:
            yield
        finally:
            with self._cond:
                self._quiet = False
                self._cond.notify_all()


#: the process's gate (the profiler is process-wide state, and so are the
#: threads it records)
DEVICE_GATE = DeviceGate()


class ProfileCapture:
    """``GET /debug/profile``'s capture, run on the request's thread, off
    the decode loop (a pool's driver thread, or the chunked mode's
    request threads), which keeps stepping while it records.  On a card
    it records the CUDA activity alone, so the trace names kernels and no
    host ops: CUPTI records every kernel of the process, whichever thread
    launched it, where recording a host-bound loop's CPU ops slowed the
    windows it covered.  There the profiler starts and stops inside
    ``DEVICE_GATE.quiet()`` with the device synchronized: started while
    the driver thread launched a 7B decode window, the capture crashed
    the process (SIGSEGV in a thread with no Python frame) in about one
    of sixteen captures, and never with the gate.  So the start waits
    for the window in flight (a chunked mode's start and stop for its
    requests in flight), and the loop pauses for the stop, which holds
    the interpreter lock for its whole wall (seconds for a trace of a
    busy 7B decode loop); the export holds it too, so the window it
    overlaps stalls that long.  On the CPU it records the ops of every thread
    (``profile_all_threads``, where this PyTorch has it).  ``busy`` admits
    one capture at a time (the profiler is process-wide state); ``last``
    holds the last capture's walls (start, recording, stop, export) and
    the monotonic span of each stage."""

    def __init__(self, device: torch.device):
        self.device = device
        self.busy = threading.Lock()
        self.last: Optional[dict] = None

    @contextlib.contextmanager
    def _quiet(self):
        """On a card: the gate held and the device idle; elsewhere
        nothing (the CPU's profiler has no CUPTI, and the loop keeps
        stepping through the stop there)."""

        if self.device.type != "cuda":
            yield
            return
        with DEVICE_GATE.quiet():
            torch.cuda.synchronize(self.device)
            yield

    def capture(self, seconds: float, path: str) -> None:
        """Record ``seconds`` and write the Chrome trace to ``path`` (the
        caller holds ``busy``)."""

        prof = _profiler(self.device)
        marks = [time.monotonic()]
        with self._quiet():
            prof.__enter__()
        marks.append(time.monotonic())
        try:
            time.sleep(seconds)
        finally:
            marks.append(time.monotonic())
            with self._quiet():
                prof.__exit__(None, None, None)
            marks.append(time.monotonic())
        prof.export_chrome_trace(path)
        marks.append(time.monotonic())
        stages = ("starting", "recording", "stopping", "exporting")
        self.last = {**{stage: (a, b) for stage, a, b in zip(stages, marks, marks[1:])},
                     **{wall: b - a for wall, a, b in zip(
                         ("start_s", "record_s", "stop_s", "export_s"), marks, marks[1:])}}


def _profiler(device: torch.device):
    """A ``torch.profiler.profile`` of the CUDA activity on a card, of
    every thread's CPU ops on the CPU; ``trace_only`` where this PyTorch
    has it (the trace is all a capture keeps)."""

    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
    for options in ({"trace_only": True, "profile_all_threads": not cuda},
                    {"profile_all_threads": not cuda}):
        try:
            config = torch._C._profiler._ExperimentalConfig(**options)
        except TypeError:  # a PyTorch without the option
            continue
        return profile(activities=activities, experimental_config=config)
    return profile(activities=activities)


def replicas_of(decoder) -> list:
    """The pools behind ``decoder``: a router's replicas, a pool alone,
    or none (the chunked decoder)."""

    if isinstance(decoder, PoolRouter):
        return decoder.pools
    return [decoder] if isinstance(decoder, ContinuousBatchingDecoder) else []


def build_handler(decoder, fatal: list, model_label: Optional[str] = None):
    """The request handler class over ``decoder``: a pool or a fleet's
    ``PoolRouter`` built by ``make_pool``, or a chunked decoder built by
    ``make_chunked`` (whose records carry ``model_label``).  ``fatal`` is
    the decode loops' error list: once it holds an entry, waiting
    requests answer 500 instead of hanging.  The process flight recorder
    attaches the tracer and metrics, and each replica's request log and
    timeline; the handler's ``alert_engine`` evaluates the default rules
    over the registry (started by ``main``, not here).  In the chunked
    mode the handler's cost plane is its own, over the registry and the
    process compile ledger, with the weights registered, as the JAX
    server's.  ``Handler.pool_fabric`` is the replicas' fabric (None
    without one), which ``main`` exports."""

    replicas = replicas_of(decoder)
    router = decoder if isinstance(decoder, PoolRouter) else None
    pool = decoder if replicas else None
    head = replicas[0] if replicas else decoder
    metrics, tracer = head.ledger.metrics, head.ledger.tracer
    if metrics is None or tracer is None:
        raise ValueError("serve_lm serves a decoder built with its records "
                         "(make_pool, make_chunked)")
    max_len = head.max_len
    if pool is not None:
        model_label, costplane = head.model_label, head.costplane
    else:
        model_label = model_label or "unknown"
        costplane = CostPlane(metrics=metrics, compiles=default_costplane.compiles)
        costplane.hbm.register_tree("weights", [decoder.dmodel])
    fabric = head.fabric if pool is not None else None
    profiler = ProfileCapture(head.device)
    recorder = flight.default_recorder
    recorder.attach_tracer(tracer)
    recorder.attach_metrics(metrics)
    for p in replicas:
        recorder.attach_request_log(p.request_log)
        if p.timeline is not None:
            recorder.attach_arena_timeline(p.timeline)
    alert_engine = AlertEngine(default_rules(), metrics=metrics, recorder=recorder)

    def recent_requests(limit: int = 50) -> list:
        if router is not None:
            return router.recent_requests(limit)
        return pool.request_log.recent(limit) if pool is not None else []

    def request_autopsy(req_id: str):
        if router is not None:
            return router.request_autopsy(req_id)
        return pool.request_log.get(req_id) if pool is not None else None

    def arena_snapshots() -> list:
        return [p.timeline.snapshot(ARENA_SAMPLE_LIMIT) for p in replicas
                if p.timeline is not None]

    def in_flight() -> int:
        return sum(p.in_flight() for p in replicas)

    def slo() -> dict:
        def gauge_sum(name: str) -> float:
            return sum(v for labels, v in metrics.gauge_series(name).items()
                       if dict(labels).get("model", model_label) == model_label)

        return {
            "model": model_label,
            "replicas": max(1, len(replicas)),
            "histograms": {
                fam: [{**dict(labels), **finite_summary(summary)}
                      for labels, summary in sorted(
                          metrics.histogram_family_merged(fam).items())]
                for fam in SLO_FAMILIES
            },
            "gauges": {name: gauge_sum(name) for name in (
                "serve_admission_queue_depth", "serve_tokens_in_flight",
                "kv_blocks_free", "kv_blocks_in_use")},
            "requests_ok": metrics.counter("serve_requests_total", status="200"),
        }

    def observe_slo(queue_wait: float, ttft: float, tpot: float, exemplar: str) -> None:
        # the chunked mode's first token reaches the host with the
        # others, so TTFT is the generate's wall (the JAX server's)
        for fam, value in (("serve_queue_wait_seconds", queue_wait),
                           ("serve_ttft_seconds", ttft),
                           ("serve_time_per_output_token_seconds", tpot)):
            metrics.observe_histogram(fam, value, exemplar=exemplar, model=model_label,
                                      mode="chunked")

    def extra_gauges() -> str:
        # the JAX server's lines after the registry's families: a
        # speculating pool's derived gauges (the serve_spec_*_total
        # counters ride the registry; a fleet's router has none), the
        # chunked decoder's hits
        if pool is None:
            return f"serve_prompt_cache_hits {decoder.prompt_cache_hits}\n"
        if router is not None or not pool.spec_enabled:
            return ""
        snap = pool.spec_snapshot()
        lines = [f"serve_spec_acceptance_rate {snap['acceptance_rate']:.4f}"]
        if snap["dispatches_per_token"] != float("inf"):
            lines.append(f"serve_spec_dispatches_per_token {snap['dispatches_per_token']:.4f}")
        return "\n".join(lines) + "\n"

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            tid = getattr(self, "_trace_id", None)
            if tid:  # echoed on every reply of a traced request
                self.send_header(TRACE_HEADER, tid)
            self.end_headers()
            self.wfile.write(body)

        def _reply(self, code: int, payload: dict) -> None:
            t0 = getattr(self, "_t0", None)
            if t0 is not None:  # a /generate request being answered
                self._t0 = None
                metrics.observe_histogram(
                    "serve_request_seconds", time.perf_counter() - t0,
                    exemplar=getattr(self, "_trace_id", None),
                    route="/generate", model=model_label,
                )
                metrics.inc("serve_requests_total", status=str(code))
                if code == 200 and isinstance(payload.get("sample"), str):
                    metrics.inc("serve_tokens_generated_total",
                                float(len(payload["sample"])))
            self._send(code, json.dumps(payload).encode(), "application/json")

        def do_GET(self):
            # a keep-alive connection reuses the handler: no stale id
            self._trace_id = None
            path = self.path
            if path == "/healthz":
                return self._reply(200, {"ok": True})
            if path == "/metrics":
                return self._send(200, (metrics.exposition() + extra_gauges()).encode(),
                                  "text/plain; version=0.0.4")
            if path == "/traces":
                return self._reply(200, {"traces": tracer.store.summaries(50)})
            if path.startswith("/traces/"):
                t = tracer.store.trace(path[len("/traces/"):])
                if t is None:
                    return self._reply(404, {"error": "unknown trace id"})
                return self._reply(200, t)
            if path == "/requests":
                return self._reply(200, {"requests": recent_requests(50)})
            if path.startswith("/requests/"):
                entry = request_autopsy(path[len("/requests/"):])
                if entry is not None:
                    return self._reply(200, entry)
                return self._reply(404, {
                    "error": "unknown request id (pool modes only; ids "
                             "are trace ids — the /generate response's "
                             "request_id / x-trace-id header)"})
            if path == "/debug/arena":
                return self._reply(200, {
                    "replicas": arena_snapshots(),
                    "fabric": fabric.snapshot() if fabric is not None else None,
                })
            if path == "/debug/fabric":
                if fabric is None:
                    return self._reply(404, {
                        "error": "no prefix fabric (start with --roles prefill=... or "
                                 "--fabric-peers)"})
                return self._reply(200, {"model": model_label, "fabric": fabric.snapshot()})
            if path == "/slo":
                return self._reply(200, slo())
            if path == "/alerts":
                return self._reply(200, alert_engine.snapshot())
            if path == "/debug/flightrecorder":
                return self._send(200, recorder.dump_text().encode(),
                                  "application/x-ndjson")
            if path == "/debug/compiles":
                return self._reply(200, {"model": model_label,
                                         **costplane.compiles.snapshot()})
            if path == "/debug/memory":
                return self._reply(200, {"model": model_label, **costplane.hbm.snapshot()})
            if path == "/debug/profile" or path.startswith("/debug/profile?"):
                # exact or with a query: /debug/profileX is a 404
                return self._profile()
            return self._reply(404, {"error": "try POST /generate"})

        def _profile(self):
            """The JAX server's /debug/profile over ``ProfileCapture``:
            the checks in its order (400, 503 for an idle pool, 409),
            then the capture, its artifact directory and the cost
            plane's context."""

            seconds = 1.0
            query = self.path.split("?", 1)[1] if "?" in self.path else ""
            for part in query.split("&"):
                if part.startswith("seconds="):
                    try:
                        seconds = float(part.split("=", 1)[1])
                    except ValueError:
                        return self._reply(400, {"error": "seconds must be a number"})
            if not 0.0 < seconds <= PROFILE_MAX_SECONDS:
                return self._reply(400, {"error": "seconds must be in (0, 30]"})
            if pool is not None and in_flight() == 0:
                return self._reply(503, {
                    "error": "decode loop idle: no active seats or queued requests to "
                             "profile — send traffic first, then re-request"})
            if not profiler.busy.acquire(blocking=False):
                return self._reply(409, {"error": "a profile is already running "
                                                  "(torch.profiler is process-global)"})
            try:
                base = os.environ.get("TPUJOB_PROFILE_DIR")
                if base:
                    os.makedirs(base, exist_ok=True)
                # the compile count at capture names the artifact
                compiles0 = costplane.compiles.total()
                out_dir = tempfile.mkdtemp(prefix=f"serve-profile-c{compiles0}-",
                                           dir=base or None)
                t0 = time.perf_counter()
                profiler.capture(seconds, os.path.join(out_dir, "trace.json"))
                context = {
                    "compiles_at_start": compiles0,
                    "compiles_during_window": costplane.compiles.total() - compiles0,
                    "compile_programs": costplane.compiles.snapshot(limit=8)["byProgram"],
                    "step_time": costplane.sentinel.snapshot(),
                }
                with open(os.path.join(out_dir, "COSTPLANE.json"), "w") as f:
                    json.dump(context, f, indent=2, sort_keys=True)
                return self._reply(200, {
                    "artifact": out_dir, "seconds": seconds,
                    "wall_seconds": round(time.perf_counter() - t0, 3),
                    "costplane": context,
                })
            except Exception as exc:  # a profiler fault must not end the server
                return self._reply(500, {"error": repr(exc)})
            finally:
                profiler.busy.release()

        def do_POST(self):
            self._trace_id = None
            if self.path != "/generate":
                return self._reply(404, {"error": "unknown path"})
            # every request is a server span: an incoming x-trace-id /
            # x-parent-span-id is adopted, else a trace is rooted; its
            # id is the request's id in the pool
            tid, parent = extract_headers(self.headers)
            with tracer.start_span("serve.generate", kind="server", trace_id=tid,
                                   parent_id=parent) as span:
                self._trace_id = span.trace_id
                self._generate(span)

        def _generate(self, span):
            self._t0 = time.perf_counter()
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                text = req.get("prompt", "")
                n_new = int(req.get("max_new_tokens", 32))
                # a 0.05 grid, as the JAX server quantises it
                temperature = round(float(req.get("temperature", 0.0)) * 20) / 20
                if temperature < 0.0:
                    return self._reply(400, {"error": "temperature must be >= 0"})
                top_k = req.get("top_k")
                if top_k is not None:
                    top_k = int(top_k)
                    if top_k < 1:
                        return self._reply(400, {"error": "top_k must be >= 1"})
                seed = req.get("seed")
                if seed is None:
                    seed = int.from_bytes(os.urandom(4), "little")
                seed = int(seed)
                stop = req.get("stop")
                if stop is not None and not isinstance(stop, str):
                    return self._reply(400, {"error": "stop must be a string"})
                # the body's tier wins over the header; an explicit
                # `is None`, so a falsy body value is validated too
                tier = req.get("tier")
                if tier is None:
                    tier = self.headers.get("x-slo-tier") or "batch"
                if tier not in ("interactive", "batch"):
                    return self._reply(400, {
                        "error": "tier must be 'interactive' or 'batch'"})
                if not text:
                    return self._reply(400, {"error": "empty prompt"})
                if n_new < 1:
                    return self._reply(400, {"error": "max_new_tokens must be >= 1"})
                ids = np.frombuffer(text.encode("ascii", "replace"), np.uint8)
                if len(ids) + n_new > max_len:
                    return self._reply(400, {
                        "error": f"prompt({len(ids)}) + max_new_tokens({n_new}) "
                                 f"> max_len({max_len})"})
                span.set_attribute("prompt_tokens", int(len(ids)))
                span.set_attribute("max_new_tokens", n_new)
                generator = None
                if temperature > 0.0:
                    generator = torch.Generator(device=head.device).manual_seed(seed)
                if pool is None:
                    return self._chunked(span, text, ids, n_new, temperature, top_k,
                                         generator, seed, stop)
                span.set_attribute("mode", "pool")
                if top_k is not None and not 1 <= top_k <= TOP_K_MAX:
                    return self._reply(400, {
                        "error": f"top_k must be in [1, {TOP_K_MAX}] in "
                                 "--batching mode (static top-k width)"})
                span.set_attribute("tier", tier)
                if fabric is not None and router is None:
                    # fleet mode, one replica: this prompt's full blocks
                    # become fleet-visible before its admission (the first
                    # pod to see a prefix prefills and publishes it; the
                    # others find it and pull it).  A failed publish never
                    # fails the request: the admission recomputes
                    try:
                        with DEVICE_GATE.work():
                            pub = pool.publish_to_fabric(
                                ids.astype(np.int32), tier=tier, trace_id=span.trace_id,
                                timeout=PUBLISH_TIMEOUT_S)
                        span.set_attribute("fabric_published", pub["published"])
                    except Exception as exc:
                        metrics.inc("serve_fabric_publish_failures_total",
                                    model=model_label)
                        span.set_attribute("fabric_publish_error", repr(exc))
                with DEVICE_GATE.work():  # a rolling cache prefills at submit
                    rid = pool.submit(
                        ids.astype(np.int32), n_new, temperature=temperature,
                        top_k=top_k, generator=generator, tier=tier,
                        trace_id=span.trace_id,
                    )
                span.set_attribute("rid", rid)
                while True:
                    row = pool.result_wait(rid, timeout=0.5)
                    if row is not None:
                        break
                    if fatal:
                        return self._reply(500, {
                            "error": f"decode loop died: {fatal[0]}"})
                sample = _cut(decode_bytes(row[len(ids):]), stop)
                return self._reply(200, {"prompt": text, "sample": sample, "seed": seed,
                                         "request_id": span.trace_id})
            except (ValueError, TypeError, KeyError, json.JSONDecodeError) as exc:
                return self._reply(400, {"error": repr(exc)})
            except Exception as exc:  # serving must not die on one request
                traceback.print_exc()
                return self._reply(500, {"error": repr(exc)})

        def _chunked(self, span, text, ids, n_new, temperature, top_k, generator, seed,
                     stop):
            """One request through the chunked decoder, on this thread."""

            span.set_attribute("mode", "chunked")
            t_gen = time.perf_counter()
            with DEVICE_GATE.work():
                out = decoder.generate(torch.as_tensor(ids.astype(np.int64))[None], n_new,
                                       temperature=temperature, top_k=top_k,
                                       generator=generator)
            wall = time.perf_counter() - t_gen
            observe_slo(0.0, wall, wall / n_new, span.trace_id)
            sample = _cut(decode_bytes(out[0, len(ids):].numpy()), stop)
            return self._reply(200, {"prompt": text, "sample": sample, "seed": seed})

    Handler.alert_engine = alert_engine
    Handler.costplane = costplane
    Handler.profiler = profiler
    Handler.pool_fabric = fabric
    return Handler


def _cut(sample: str, stop: Optional[str]) -> str:
    """The sample up to the first ``stop``, the JAX server's contract."""

    if stop:
        cut = sample.find(stop)
        if cut >= 0:
            return sample[:cut]
    return sample


class _BurstHTTPServer(ThreadingHTTPServer):
    """The server's listener.  socketserver's listen backlog of 5 drops
    the connections of a burst of clients beyond it while the accept
    thread waits for the interpreter lock, and each dropped client
    retries a second or more later: a request sent during a burst could
    then reach a pool that had gone idle."""

    request_queue_size = 128


class Server:
    """The HTTP server and, for a pool, one decode loop thread a replica,
    started together and stopped together.  ``alert_engine`` is the
    handler's, not started: ``main`` starts it.  A pool's driver thread
    (``serve.pool``) beats the ``serving.pool`` heartbeat on the process
    watchdog; a fleet's replica i runs ``serve.pool<i>`` beating
    ``serving.pool<i>``.  The chunked mode has no driver thread (each
    request decodes on its own thread) and so no heartbeat.
    ``model_label`` labels a chunked decoder's records (a pool carries
    its own).  ``pool`` is the pool or the fleet's router, ``replicas``
    its pools and ``fabric`` their fabric."""

    def __init__(self, decoder, host: str = "127.0.0.1", port: int = 0,
                 model_label: Optional[str] = None):
        self.decoder = decoder
        self.replicas = replicas_of(decoder)
        self.pool = decoder if self.replicas else None
        self.fatal: list = []
        handler = build_handler(decoder, self.fatal, model_label)
        self.alert_engine = handler.alert_engine
        self.profiler = handler.profiler
        self.fabric = handler.pool_fabric
        self.httpd = _BurstHTTPServer((host, port), handler)
        self.port = self.httpd.server_address[1]
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self.httpd.serve_forever,
                                          name="serve.http", daemon=True)]
        one = len(self.replicas) == 1
        for i, p in enumerate(self.replicas):
            suffix = "" if one else str(i)
            self._threads.insert(i, threading.Thread(
                target=self._drive, args=(p, POOL_HEARTBEAT + suffix),
                name="serve.pool" + suffix, daemon=True))

    def _drive(self, pool, heartbeat: str) -> None:
        # the liveness-critical thread: a wedge here hangs every queued
        # client, so it beats the process watchdog's heartbeat
        hb = default_watchdog.register(heartbeat)
        try:
            while not self._stop.is_set():
                try:
                    hb.beat()
                    with DEVICE_GATE.work():
                        active = pool.step()
                    if active == 0:
                        time.sleep(0.005)
                except Exception as exc:  # a dead decode loop must surface as 500s
                    traceback.print_exc()
                    self.fatal.append(repr(exc))
                    return
        finally:
            # another server's driver may have registered the name since
            if default_watchdog.heartbeats().get(heartbeat) is hb:
                default_watchdog.unregister(heartbeat)

    def start(self) -> "Server":
        for t in self._threads:
            t.start()
        return self

    def close(self) -> None:
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        for t in self._threads:
            t.join(timeout=30)


def load_model(device: torch.device, *, max_len: int, model: str = "llama-tiny",
               init_seed: int = 0, artifact: Optional[str] = None,
               quantize: Optional[str] = None, what: str = "params") -> Family:
    """The model the flags name: the ``export_params`` directory
    ``artifact`` (``params.npz`` + ``model.json``) when given, else
    ``model``'s shape with weights made from ``init_seed`` on
    ``device``.  ``quantize="int8"`` holds the eligible kernels as int8,
    quantized from float32, and prints the weight bytes before and after
    under ``what`` (before: the bf16 storage of the unquantized model;
    the JAX server counts its float32 tree)."""

    if quantize not in (None, "int8"):
        raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
    int8 = quantize == "int8"
    if artifact:
        cls, cfg = artifact_model(artifact, max_len)
        state = load_npz(os.path.join(artifact, PARAMS_FILE), quantize=int8)
    else:
        if model not in SEEDED_MODELS:
            raise ValueError(f"model must be one of {sorted(SEEDED_MODELS)}, got {model!r}")
        cls, cfg = SEEDED_MODELS[model](max_len)
        state = init_params(cfg, init_seed, device, quantize=int8, family=cls)
    meta = cls(cfg, device="meta").state_dict() if int8 else None
    if int8 and not cls.SUPPORTS_QTENSOR:
        # the reference counts the quantized tree it then materializes
        # at each apply; this family holds the materialized bf16 weights
        after = state_bytes({n: state[n] if isinstance(state[n], QTensor) else t
                             for n, t in meta.items()})
    lm = cls.from_state_dict(cfg, state, device)
    if int8:
        if cls.SUPPORTS_QTENSOR:
            after = state_bytes(lm.state_dict())
        print(f"int8 weights-only quantization: {what} {state_bytes(meta) / 1e6:.1f} MB -> "
              f"{after / 1e6:.1f} MB", flush=True)
    return lm


def _description(artifact: str) -> dict:
    with open(os.path.join(artifact, MODEL_FILE)) as f:
        return json.load(f)


def check_byte_level(artifact: str) -> None:
    """The JAX server's first check of an artifact, before any weight is
    read: this server is byte-level, so a vocab other than the 256 bytes
    exits."""

    vocab = _description(artifact)["config"]["vocab_size"]
    if vocab != 256:
        raise SystemExit(f"this server is byte-level (vocab 256); the artifact was "
                         f"trained with vocab {vocab}")


def artifact_model(artifact: str, max_len: int):
    """(family class, config) of an ``export_params`` directory's
    ``model.json``, a ``max_len`` above the trained length capped at it
    with the JAX server's line."""

    desc = _description(artifact)
    trained = desc["config"]["max_len"]
    if max_len > trained:
        max_len = trained
        print(f"capping --max-len to trained length {max_len}", flush=True)
    return model_from_description(desc, max_len=max_len)


def _moe_gpt_small(max_len: int) -> MoeConfig:
    """Eight routed experts in every layer at gpt_small's widths."""

    return MoeConfig(base=gpt_small(vocab_size=256, max_len=max_len), num_experts=8)


#: ``--model``: (family class, config at a max_len) of each seeded shape;
#: byte-level prompts, so every shape but llama-7b has the 256 bytes as
#: its vocab
SEEDED_MODELS = {
    "llama-7b": lambda n: (LlamaLM, llama_7b_shape(max_len=n)),
    "llama-tiny": lambda n: (LlamaLM, llama_tiny(vocab_size=256, max_len=n)),
    "gpt-small": lambda n: (CausalLM, gpt_small(vocab_size=256, max_len=n)),
    "gpt-tiny": lambda n: (CausalLM, gpt_tiny(vocab_size=256, max_len=n)),
    "moe-tiny": lambda n: (MoeLM, moe_tiny(vocab_size=256, max_len=n)),
    "moe-gpt-small": lambda n: (MoeLM, _moe_gpt_small(n)),
}


def _paged_kernel_mode(value: str) -> str:
    """``--paged-kernel``'s value: ``auto`` or ``on``; any other, ``off``
    and ``interpret`` included, is refused at parse time."""

    if value not in ("auto", "on"):
        raise argparse.ArgumentTypeError(
            f"{value!r} refused: the port has no fallback from its kernels on the card "
            "(a CUDA tensor reaches the kernel or the call raises); use auto or on")
    return value


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=list(SEEDED_MODELS), default="llama-tiny",
                    help="a seeded shape: llama-7b, llama-tiny, gpt-small (GPT-2 small "
                    "widths), gpt-tiny, moe-tiny (4 experts) or moe-gpt-small (8 experts "
                    "at gpt-small widths); every one but llama-7b at vocab 256")
    ap.add_argument("--init-seed", type=int, default=0)
    ap.add_argument("--artifact", default=None,
                    help="export_params directory (params.npz + model.json); "
                    "overrides --model")
    ap.add_argument("--quantize", choices=["int8"], default=None,
                    help="weights-only int8 for the projection kernels (ops/quant.py); "
                    "the embedding stays bf16")
    ap.add_argument("--port", type=int, default=8600)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--prompt-cache", type=int, default=0, metavar="N",
                    help="LRU of N prompt-KV snapshots in the chunked decoder: an exact "
                    "repeat prompt skips prefill; each entry holds the prompt's K/V")
    ap.add_argument("--batching", type=int, default=0, metavar="SLOTS",
                    help="serve through a continuous-batching pool of this many slots "
                    "(the paged pool; the contiguous slot pool for a rolling-window, gpt "
                    "or moe model); 0 = one request at a time through the chunked decoder")
    ap.add_argument("--replicas", type=int, default=1, metavar="N",
                    help="run N pool replicas behind one admission queue "
                    "(models/pool_router.py: least blocks in use; per-replica gauges on "
                    "/metrics, merged quantiles on /slo).  Requires --batching")
    ap.add_argument("--roles", default=None, metavar="ROLE=N,...",
                    help="phase-split the replica fleet, e.g. 'prefill=1,decode=2': prefill "
                    "replicas prefill prompts and publish their blocks into the prefix-cache "
                    "fabric, decode replicas map the published chain (pulling the missing "
                    "tail: migrate_in) and decode.  Implies --replicas = the total; requires "
                    "--batching and a pageable model.  Default: every replica 'unified'")
    ap.add_argument("--fabric-port", type=int, default=None, metavar="PORT",
                    help="export this process's prefix-fabric store on 127.0.0.1:PORT "
                    "(GET /fabric/index, /fabric/blocks/<key>, POST /fabric/publish; "
                    "models/fabric_service.py).  Default: $TPUJOB_FABRIC_PORT when set, "
                    "else no fabric server.  Requires --batching")
    ap.add_argument("--fabric-peers", default=None, metavar="HOST:PORT,...",
                    help="static peers of the cross-pod KV fabric: local prefix-cache misses "
                    "pull published blocks from them over HTTP (one migrate_in dispatch, "
                    "hash-checked, recompute on any failure), and local publishes announce "
                    "to them.  May be empty ('') for discovery by announcement.  Requires "
                    "--batching")
    ap.add_argument("--kv-blocks", type=int, default=None)
    ap.add_argument("--kv-block-size", type=int, default=16)
    ap.add_argument("--kv-swap-blocks", type=int, default=None, metavar="N",
                    help="cap the host swap arena of preempted seats at N blocks "
                    "(default: unbounded); with both arenas full, requests wait "
                    "or park without a copy")
    ap.add_argument("--paged-kernel", type=_paged_kernel_mode, default="auto",
                    metavar="{auto,on}",
                    help="accepted for the reference's command lines: the paged decode "
                    "step always runs the kernel on the card (its plain version for CPU "
                    "tensors); 'off' and 'interpret' are refused, because the port never "
                    "falls back from its kernel")
    ap.add_argument("--steps-per-sync", type=int, default=8)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--speculative", action="store_true",
                    help="speculate in the pool with an int8 self-draft, gated per SLO tier "
                    "(--spec-tiers); refuses to start when the port's measured record "
                    "(spec_measured.json) says it is slower than the plain pool")
    ap.add_argument("--speculative-force", action="store_true",
                    help="serve --speculative even though the measured record says it is "
                    "a slowdown")
    ap.add_argument("--spec-k", type=int, default=4, metavar="K",
                    help="draft tokens proposed a window (the pool refuses K < 1)")
    ap.add_argument("--spec-tiers", default=None, metavar="T1[,T2]",
                    help="comma-separated SLO tiers that speculate (default: interactive); "
                    "a tier that is not an SLO tier fails startup")
    return ap


def model_label_of(args: argparse.Namespace) -> str:
    """The ``model`` label of the records: the artifact's ``model.json``
    family, else the ``--model`` name."""

    if args.artifact:
        return _description(args.artifact)["family"]
    return args.model


def slots_of(args: argparse.Namespace) -> int:
    """``--batching``, or 4 under ``--speculative`` alone (the JAX
    server's default for speculation); 0 = the chunked decoder."""

    if args.speculative and args.batching <= 0:
        return 4
    return args.batching


def fleet_of(args: argparse.Namespace) -> dict:
    """The fleet the flags describe, checked as the JAX server checks
    them (its exits and messages): ``replicas``, ``roles`` (None or one a
    replica), ``fabric_port`` (``--fabric-port``, else a positive
    ``$TPUJOB_FABRIC_PORT`` under ``--batching``, else None) and
    ``fabric_peers`` (None, or a list: empty when only a fabric port was
    given, for discovery by announcement)."""

    replicas = args.replicas
    if replicas > 1 and not args.batching:
        raise SystemExit("--replicas requires --batching SLOTS")
    roles = None
    if args.roles:
        if not args.batching:
            raise SystemExit("--roles requires --batching SLOTS")
        try:
            roles = parse_roles(args.roles)
        except ValueError as exc:
            raise SystemExit(f"bad --roles: {exc}")
        if replicas > 1 and replicas != len(roles):
            raise SystemExit(f"--roles declares {len(roles)} replicas but --replicas says "
                             f"{replicas} — drop one of the flags")
        replicas = len(roles)
    fabric_port = args.fabric_port
    if fabric_port is None:
        try:
            env_port = int(os.environ.get(ENV_FABRIC_PORT, "0") or "0")
        except ValueError:
            env_port = 0
        if env_port > 0 and args.batching:
            fabric_port = env_port
    peers = None
    if args.fabric_peers is not None:
        if not args.batching:
            raise SystemExit("--fabric-peers requires --batching SLOTS")
        peers = [p.strip() for p in args.fabric_peers.split(",") if p.strip()]
    if args.fabric_port is not None and not args.batching:
        raise SystemExit("--fabric-port requires --batching SLOTS")
    if fabric_port is not None and peers is None:
        peers = []  # fleet mode: discovery by announcement
    return {"replicas": max(1, replicas), "roles": roles, "fabric_port": fabric_port,
            "fabric_peers": peers}


def load_draft(model: Family, args: argparse.Namespace) -> Family:
    """The int8 self-draft of ``--speculative``: the served model when it
    already holds int8 kernels, else the same weights quantized from
    their float32 source (the artifact's npz, or the seed's draws), never
    from the bf16 storage, so that it is the JAX server's
    ``quantize_tree(params)`` draft."""

    if args.quantize == "int8":
        return model
    return load_model(model.device, max_len=args.max_len, model=args.model,
                      init_seed=args.init_seed, artifact=args.artifact, quantize="int8",
                      what="speculative draft")


def build_pool(model: Family, args: argparse.Namespace,
               metrics: Optional[Metrics] = None,
               draft: Optional[Family] = None, fleet: Optional[dict] = None):
    """The paged pool the flags describe (the JAX server's: lazy
    reservation), with its records (``make_pool``) on ``metrics``; a
    ``PoolRouter`` over the fleet of ``--replicas`` / ``--roles``, with
    the fabric of ``--roles`` / ``--fabric-peers`` (``fleet``, or
    ``fleet_of(args)`` when None).  Under
    ``--speculative`` ``draft`` is the draft model (``load_draft``), each
    replica with its own draft arena; the tiers of ``--spec-tiers`` reach
    the pool unvalidated, so that its constructor fails startup on a typo
    rather than serve non-speculatively.  A model the paged pool refuses
    raises ``NotPageableError``."""

    spec_kw = {}
    if args.speculative:
        if draft is None:
            raise ValueError("--speculative needs its draft model (load_draft)")
        spec_kw = dict(draft_model=draft, spec_k=args.spec_k)
        if args.spec_tiers is not None:
            spec_kw["spec_tiers"] = tuple(args.spec_tiers.split(","))
    fleet = fleet or fleet_of(args)
    return make_pool(
        model, model_label=model_label_of(args), metrics=metrics,
        replicas=fleet["replicas"], roles=fleet["roles"], fabric_peers=fleet["fabric_peers"],
        slots=slots_of(args), steps_per_sync=args.steps_per_sync,
        kv_blocks=args.kv_blocks, kv_block_size=args.kv_block_size,
        swap_blocks=args.kv_swap_blocks, **spec_kw,
    )


def build_decoder(model: Family, args: argparse.Namespace,
                  metrics: Optional[Metrics] = None, draft: Optional[Family] = None,
                  fleet: Optional[dict] = None):
    """The decoder the flags describe, as the JAX server places them:
    the chunked decoder for ``--batching 0``; the paged pool or fleet
    (``build_pool``) for more slots; and, where the paged pool refuses
    the model (a rolling-window cache, a gpt or moe model), the
    contiguous slot pool (as many
    replicas, a label each) after the JAX server's line.
    ``--prompt-cache`` beside a pool, and ``--speculative``, a fabric or
    ``--roles`` on a model the paged pool refuses raise the JAX server's
    errors."""

    slots = slots_of(args)
    fleet = fleet or fleet_of(args)
    if slots <= 0:
        return make_chunked(model, prompt_cache=args.prompt_cache, metrics=metrics)
    if args.prompt_cache:
        raise ValueError(
            "--prompt-cache applies to the chunked decoder; the batching pool consumes "
            "the shared PREFIX cache (models/prefix_cache.py) instead — drop one of the "
            "flags"
        )
    if fleet["roles"]:
        print(f"disaggregated roles: {','.join(fleet['roles'])}", flush=True)
    try:
        return build_pool(model, args, metrics, draft, fleet)
    except NotPageableError as exc:
        if args.speculative:
            raise ValueError(f"--speculative requires the paged pool: {exc}") from exc
        if (fleet["roles"] and "prefill" in fleet["roles"]) or \
                fleet["fabric_peers"] is not None:
            # the fabric is block-granular: no contiguous fleet under it
            raise ValueError(f"--roles requires the paged pool: {exc}") from exc
        print(f"paged pool unavailable ({exc}); serving the contiguous slot pool",
              flush=True)
        return make_pool(model, model_label=model_label_of(args), metrics=metrics,
                         pool_class=ContinuousBatchingDecoder, replicas=fleet["replicas"],
                         slots=slots, steps_per_sync=args.steps_per_sync)


def start_fabric_server(server: Server, fleet: dict) -> Optional[FabricServer]:
    """In fleet mode (``fleet_of``'s ``fabric_peers`` not None), a
    ``FabricServer`` over ``server``'s fabric on the fleet's fabric port
    (any free one when None), its address stamped as the fabric's
    advertise; else None."""

    if server.fabric is None or fleet["fabric_peers"] is None:
        return None
    fabric_server = FabricServer(server.fabric, port=fleet["fabric_port"] or 0).start()
    server.fabric.set_advertise(fabric_server.addr)
    print(f"fabric server on {fabric_server.addr} "
          f"(peers: {','.join(fleet['fabric_peers']) or 'announce-only'})", flush=True)
    return fabric_server


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    refuse_speculative(args)
    fleet = fleet_of(args)  # the flag errors exit before the weights load
    if args.artifact:
        check_byte_level(args.artifact)
    device = resolve_device(args.device)
    model = load_model(
        device, max_len=args.max_len, model=args.model, init_seed=args.init_seed,
        artifact=args.artifact, quantize=args.quantize,
    )
    draft = load_draft(model, args) if args.speculative else None
    # one registry for the process: the handler's /metrics and /slo,
    # the alert engine and the flight recorder's metric deltas.  The
    # recorder dumps on SIGTERM and on a fatal exception
    metrics = Metrics()
    flight.install(metrics=metrics)
    # TPUJOB_WATCHDOG=1 adds the stall monitor over the same registry
    maybe_start_from_env(metrics=metrics)
    server = Server(build_decoder(model, args, metrics, draft, fleet), port=args.port,
                    model_label=model_label_of(args)).start()
    fabric_server = start_fabric_server(server, fleet)
    server.alert_engine.start()
    print(f"serving on 127.0.0.1:{server.port} ({device})", flush=True)
    try:
        while not server.fatal:
            time.sleep(1.0)
        print(f"decode loop died: {server.fatal[0]}", flush=True)
        return 1
    except KeyboardInterrupt:
        return 0
    finally:
        server.alert_engine.stop()
        if fabric_server is not None:
            fabric_server.stop()
            server.fabric.stop()
        server.close()


if __name__ == "__main__":
    raise SystemExit(main())
