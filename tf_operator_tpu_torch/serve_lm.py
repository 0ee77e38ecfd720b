"""LM serving over HTTP through the paged pool (the port of the pool
mode of ``examples/serve_lm.py``).

    python -m tf_operator_tpu_torch.serve_lm --model llama-7b --init-seed 0 --batching 8
    python -m tf_operator_tpu_torch.serve_lm --artifact DIR
    python -m tf_operator_tpu_torch.serve_lm --artifact DIR --quantize int8
    python -m tf_operator_tpu_torch.serve_lm --model llama-7b --speculative --speculative-force
    curl -s localhost:8600/generate -d '{"prompt": "the sharded ", "max_new_tokens": 32}'

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
- ``GET /debug/flightrecorder``: the flight recorder's ndjson dump.

Speculative decoding (``--speculative``, ``--spec-k K``, ``--spec-tiers
T1[,T2]``): the pool's speculative mode (models/batching.py), gated per
SLO tier (interactive by default), with an int8 self-draft: the served
model itself under ``--quantize int8``, else its int8 twin quantized
from the same float32 weights (the artifact's npz or the seed's draws).
``--speculative`` alone serves 4 slots, as the JAX server does.  A tier
that is not an SLO tier, or a model the pool cannot page, fails
startup.  ``/metrics`` then adds ``serve_spec_acceptance_rate`` and
``serve_spec_dispatches_per_token`` (left out while no token has been
emitted) to the ``serve_spec_*_total`` counters.  ``--speculative``
refuses to start when the port's own record
(``tf_operator_tpu_torch/spec_measured.json``, written from a card run of
``chip_smoke.py``'s speculative phase) says speculation is slower than
the plain pool; ``--speculative-force`` serves it anyway.

The JAX server's ``/debug/compiles``, ``/debug/memory``,
``/debug/profile`` and ``/debug/fabric`` are not ported.

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

The weights come from a seed (``--model llama-7b|llama-tiny
--init-seed N``, made on the device) or from an ``export_params``
directory (``--artifact DIR``: ``params.npz`` of flat flax-path keys,
read with numpy, and ``model.json``).  ``--quantize int8`` holds the
projection kernels (every ``kernel`` of >= 4096 elements; the embedding
stays bf16) as int8 with per-output-channel scales, quantized from the
float32 weights as they are made or read (ops/quant.py); their products
then run the int8 matmul (the CUDA kernel K7 on the card).  The server
runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from tf_operator_tpu_torch.device import resolve_device
from tf_operator_tpu_torch.models.batching import (
    TOP_K_MAX,
    PagedContinuousBatchingDecoder,
)
from tf_operator_tpu_torch.models.llama import LlamaLM, llama_7b_shape, llama_tiny
from tf_operator_tpu_torch.models.registry import model_from_description
from tf_operator_tpu_torch.models.weights import init_params, load_npz
from tf_operator_tpu_torch.ops.quant import state_bytes
from tf_operator_tpu_torch.parallel.checkpoint import MODEL_FILE, PARAMS_FILE
from tf_operator_tpu_torch.utils import flight
from tf_operator_tpu_torch.utils.alerts import AlertEngine, default_rules
from tf_operator_tpu_torch.utils.metrics import (
    SLO_BUCKETS,
    DispatchLedger,
    Metrics,
    finite_summary,
)
from tf_operator_tpu_torch.utils.trace import TRACE_HEADER, Tracer, extract_headers


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


def make_pool(model: LlamaLM, *, model_label: str = "unknown",
              metrics: Optional[Metrics] = None, tracer: Optional[Tracer] = None,
              **pool_kw) -> PagedContinuousBatchingDecoder:
    """The paged pool with its records, as the server serves it: one
    ``Metrics`` registry (the SLO families on the long-tail buckets), one
    ``Tracer`` and a ``DispatchLedger`` over both.  ``pool_kw`` are the
    pool's own arguments."""

    metrics = metrics if metrics is not None else Metrics()
    tracer = tracer if tracer is not None else Tracer()
    for fam in SLO_FAMILIES:
        metrics.set_buckets(fam, SLO_BUCKETS)
    return PagedContinuousBatchingDecoder(
        model, ledger=DispatchLedger(metrics=metrics, tracer=tracer), metrics=metrics,
        model_label=model_label, **pool_kw,
    )


def build_handler(pool: PagedContinuousBatchingDecoder, fatal: list):
    """The request handler class over ``pool`` (built by ``make_pool``).
    ``fatal`` is the decode loop's error list: once it holds an entry,
    waiting requests answer 500 instead of hanging.  The process flight
    recorder attaches the pool's tracer, metrics, request log and
    timeline; the handler's ``alert_engine`` evaluates the default
    rules over the pool's registry (started by ``main``, not here)."""

    if pool.metrics is None or pool.tracer is None:
        raise ValueError("serve_lm serves a pool built with its records (make_pool)")
    max_len = pool.max_len
    metrics, tracer, model_label = pool.metrics, pool.tracer, pool.model_label
    recorder = flight.default_recorder
    recorder.attach_tracer(tracer)
    recorder.attach_metrics(metrics)
    recorder.attach_request_log(pool.request_log)
    recorder.attach_arena_timeline(pool.timeline)
    alert_engine = AlertEngine(default_rules(), metrics=metrics, recorder=recorder)

    def slo() -> dict:
        def gauge_sum(name: str) -> float:
            return sum(v for labels, v in metrics.gauge_series(name).items()
                       if dict(labels).get("model", model_label) == model_label)

        return {
            "model": model_label,
            "replicas": 1,
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

    def spec_gauges() -> str:
        # the JAX server's derived speculation gauges, after the
        # registry's families (the serve_spec_*_total counters)
        if not pool.spec_enabled:
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
                return self._send(200, (metrics.exposition() + spec_gauges()).encode(),
                                  "text/plain; version=0.0.4")
            if path == "/traces":
                return self._reply(200, {"traces": tracer.store.summaries(50)})
            if path.startswith("/traces/"):
                t = tracer.store.trace(path[len("/traces/"):])
                if t is None:
                    return self._reply(404, {"error": "unknown trace id"})
                return self._reply(200, t)
            if path == "/requests":
                return self._reply(200, {"requests": pool.request_log.recent(50)})
            if path.startswith("/requests/"):
                entry = pool.request_log.get(path[len("/requests/"):])
                if entry is not None:
                    return self._reply(200, entry)
                return self._reply(404, {
                    "error": "unknown request id (pool modes only; ids "
                             "are trace ids — the /generate response's "
                             "request_id / x-trace-id header)"})
            if path == "/debug/arena":
                return self._reply(200, {
                    "replicas": [pool.timeline.snapshot(ARENA_SAMPLE_LIMIT)],
                    "fabric": None,
                })
            if path == "/slo":
                return self._reply(200, slo())
            if path == "/alerts":
                return self._reply(200, alert_engine.snapshot())
            if path == "/debug/flightrecorder":
                return self._send(200, recorder.dump_text().encode(),
                                  "application/x-ndjson")
            return self._reply(404, {"error": "try POST /generate"})

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
                span.set_attribute("mode", "pool")
                if top_k is not None and not 1 <= top_k <= TOP_K_MAX:
                    return self._reply(400, {
                        "error": f"top_k must be in [1, {TOP_K_MAX}] in "
                                 "--batching mode (static top-k width)"})
                span.set_attribute("tier", tier)
                generator = None
                if temperature > 0.0:
                    generator = torch.Generator(device=pool.device).manual_seed(seed)
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
                sample = decode_bytes(row[len(ids):])
                if stop:
                    cut = sample.find(stop)
                    if cut >= 0:
                        sample = sample[:cut]
                return self._reply(200, {"prompt": text, "sample": sample, "seed": seed,
                                         "request_id": span.trace_id})
            except (ValueError, TypeError, KeyError, json.JSONDecodeError) as exc:
                return self._reply(400, {"error": repr(exc)})
            except Exception as exc:  # serving must not die on one request
                traceback.print_exc()
                return self._reply(500, {"error": repr(exc)})

    Handler.alert_engine = alert_engine
    return Handler


class Server:
    """The HTTP server and the pool's decode loop thread, started together
    and stopped together.  ``alert_engine`` is the handler's, not
    started: ``main`` starts it."""

    def __init__(self, pool: PagedContinuousBatchingDecoder,
                 host: str = "127.0.0.1", port: int = 0):
        self.pool = pool
        self.fatal: list = []
        handler = build_handler(pool, self.fatal)
        self.alert_engine = handler.alert_engine
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.port = self.httpd.server_address[1]
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._drive, name="serve.pool", daemon=True),
            threading.Thread(target=self.httpd.serve_forever, name="serve.http",
                             daemon=True),
        ]

    def _drive(self) -> None:
        while not self._stop.is_set():
            try:
                if self.pool.step() == 0:
                    time.sleep(0.005)
            except Exception as exc:  # a dead decode loop must surface as 500s
                traceback.print_exc()
                self.fatal.append(repr(exc))
                return

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
               quantize: Optional[str] = None, what: str = "params") -> LlamaLM:
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
        with open(os.path.join(artifact, MODEL_FILE)) as f:
            cfg = model_from_description(json.load(f), max_len=max_len)
        state = load_npz(os.path.join(artifact, PARAMS_FILE), quantize=int8)
    else:
        if model == "llama-7b":
            cfg = llama_7b_shape(max_len=max_len)
        elif model == "llama-tiny":
            # byte-level prompts: the tiny model's vocab is the 256 bytes
            cfg = llama_tiny(vocab_size=256, max_len=max_len)
        else:
            raise ValueError(f"model must be llama-7b or llama-tiny, got {model!r}")
        state = init_params(cfg, init_seed, device, quantize=int8)
    lm = LlamaLM.from_state_dict(cfg, state, device)
    if int8:
        before = state_bytes(LlamaLM(cfg, device="meta").state_dict())
        print(f"int8 weights-only quantization: {what} {before / 1e6:.1f} MB -> "
              f"{state_bytes(lm.state_dict()) / 1e6:.1f} MB", flush=True)
    return lm


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=["llama-7b", "llama-tiny"], default="llama-tiny")
    ap.add_argument("--init-seed", type=int, default=0)
    ap.add_argument("--artifact", default=None,
                    help="export_params directory (params.npz + model.json); "
                    "overrides --model")
    ap.add_argument("--quantize", choices=["int8"], default=None,
                    help="weights-only int8 for the projection kernels (ops/quant.py); "
                    "the embedding stays bf16")
    ap.add_argument("--port", type=int, default=8600)
    ap.add_argument("--max-len", type=int, default=2048)
    ap.add_argument("--batching", type=int, default=None, metavar="SLOTS",
                    help="the pool's seats (default 8; 4 with --speculative alone)")
    ap.add_argument("--kv-blocks", type=int, default=None)
    ap.add_argument("--kv-block-size", type=int, default=16)
    ap.add_argument("--kv-swap-blocks", type=int, default=None, metavar="N",
                    help="cap the host swap arena of preempted seats at N blocks "
                    "(default: unbounded); with both arenas full, requests wait "
                    "or park without a copy")
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
        with open(os.path.join(args.artifact, MODEL_FILE)) as f:
            return json.load(f)["family"]
    return args.model


def slots_of(args: argparse.Namespace) -> int:
    """``--batching``, else 8, or 4 under ``--speculative`` (the JAX
    server's default for speculation alone)."""

    if args.batching is not None:
        return args.batching
    return 4 if args.speculative else 8


def load_draft(model: LlamaLM, args: argparse.Namespace) -> LlamaLM:
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


def build_pool(model: LlamaLM, args: argparse.Namespace,
               metrics: Optional[Metrics] = None,
               draft: Optional[LlamaLM] = None) -> PagedContinuousBatchingDecoder:
    """The pool the flags describe (the JAX server's: lazy reservation),
    with its records (``make_pool``) on ``metrics``.  Under
    ``--speculative`` ``draft`` is the draft model (``load_draft``); the
    tiers of ``--spec-tiers`` reach the pool unvalidated, so that its
    constructor fails startup on a typo rather than serve
    non-speculatively."""

    spec_kw = {}
    if args.speculative:
        if draft is None:
            raise ValueError("--speculative needs its draft model (load_draft)")
        spec_kw = dict(draft_model=draft, spec_k=args.spec_k)
        if args.spec_tiers is not None:
            spec_kw["spec_tiers"] = tuple(args.spec_tiers.split(","))
    return make_pool(
        model, model_label=model_label_of(args), metrics=metrics,
        slots=slots_of(args), steps_per_sync=args.steps_per_sync,
        kv_blocks=args.kv_blocks, kv_block_size=args.kv_block_size,
        swap_blocks=args.kv_swap_blocks, **spec_kw,
    )


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    if slots_of(args) < 1:
        raise SystemExit("--batching must be >= 1 (the pool is the only serving mode)")
    refuse_speculative(args)
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
    server = Server(build_pool(model, args, metrics, draft), port=args.port).start()
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
        server.close()


if __name__ == "__main__":
    raise SystemExit(main())
