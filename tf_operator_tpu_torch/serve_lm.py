"""LM serving over HTTP through the paged pool (the port of the pool
mode of ``examples/serve_lm.py``).

    python -m tf_operator_tpu_torch.serve_lm --model llama-7b --init-seed 0 --batching 8
    python -m tf_operator_tpu_torch.serve_lm --artifact DIR
    python -m tf_operator_tpu_torch.serve_lm --artifact DIR --quantize int8
    curl -s localhost:8600/generate -d '{"prompt": "the sharded ", "max_new_tokens": 32}'

``POST /generate`` takes ``prompt``, ``max_new_tokens`` (default 32),
``temperature`` (quantised to a 0.05 grid), ``top_k``, ``seed``,
``stop`` and ``tier`` and answers ``{"prompt", "sample", "seed"}``;
prompts are byte-level ids.  ``GET /healthz`` answers ``{"ok": true}``.
Client errors are 400s with the JAX server's messages.

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


def decode_bytes(arr) -> str:
    """uint8/int token array -> printable string (the detokenizer)."""

    b = np.asarray(arr).reshape(-1).astype(np.uint8).tobytes()
    return b.decode("ascii", errors="replace")


def build_handler(pool: PagedContinuousBatchingDecoder, fatal: list):
    """The request handler class over ``pool``.  ``fatal`` is the
    decode loop's error list: once it holds an entry, waiting requests
    answer 500 instead of hanging."""

    max_len = pool.max_len

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                return self._reply(200, {"ok": True})
            return self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/generate":
                return self._reply(404, {"error": "unknown path"})
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
                if top_k is not None and not 1 <= top_k <= TOP_K_MAX:
                    return self._reply(400, {
                        "error": f"top_k must be in [1, {TOP_K_MAX}] in "
                                 "--batching mode (static top-k width)"})
                generator = None
                if temperature > 0.0:
                    generator = torch.Generator(device=pool.device).manual_seed(seed)
                rid = pool.submit(
                    ids.astype(np.int32), n_new, temperature=temperature,
                    top_k=top_k, generator=generator, tier=tier,
                )
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
                return self._reply(200, {"prompt": text, "sample": sample, "seed": seed})
            except (ValueError, TypeError, KeyError, json.JSONDecodeError) as exc:
                return self._reply(400, {"error": repr(exc)})
            except Exception as exc:  # serving must not die on one request
                traceback.print_exc()
                return self._reply(500, {"error": repr(exc)})

    return Handler


class Server:
    """The HTTP server and the pool's decode loop thread, started together
    and stopped together."""

    def __init__(self, pool: PagedContinuousBatchingDecoder,
                 host: str = "127.0.0.1", port: int = 0):
        self.pool = pool
        self.fatal: list = []
        self.httpd = ThreadingHTTPServer((host, port), build_handler(pool, self.fatal))
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
               quantize: Optional[str] = None) -> LlamaLM:
    """The model the flags name: the ``export_params`` directory
    ``artifact`` (``params.npz`` + ``model.json``) when given, else
    ``model``'s shape with weights made from ``init_seed`` on
    ``device``.  ``quantize="int8"`` holds the eligible kernels as int8,
    quantized from float32, and prints the weight bytes before and after
    (before: the bf16 storage of the unquantized model; the JAX server
    counts its float32 tree)."""

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
        print(f"int8 weights-only quantization: params {before / 1e6:.1f} MB -> "
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
    ap.add_argument("--batching", type=int, default=8, metavar="SLOTS")
    ap.add_argument("--kv-blocks", type=int, default=None)
    ap.add_argument("--kv-block-size", type=int, default=16)
    ap.add_argument("--kv-swap-blocks", type=int, default=None, metavar="N",
                    help="cap the host swap arena of preempted seats at N blocks "
                    "(default: unbounded); with both arenas full, requests wait "
                    "or park without a copy")
    ap.add_argument("--steps-per-sync", type=int, default=8)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap


def build_pool(model: LlamaLM, args: argparse.Namespace) -> PagedContinuousBatchingDecoder:
    """The pool the flags describe (the JAX server's: lazy reservation)."""

    return PagedContinuousBatchingDecoder(
        model, slots=args.batching, steps_per_sync=args.steps_per_sync,
        kv_blocks=args.kv_blocks, kv_block_size=args.kv_block_size,
        swap_blocks=args.kv_swap_blocks,
    )


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.batching < 1:
        raise SystemExit("--batching must be >= 1 (the pool is the only serving mode)")
    device = resolve_device(args.device)
    model = load_model(
        device, max_len=args.max_len, model=args.model, init_seed=args.init_seed,
        artifact=args.artifact, quantize=args.quantize,
    )
    server = Server(build_pool(model, args), port=args.port).start()
    print(f"serving on 127.0.0.1:{server.port} ({device})", flush=True)
    try:
        while not server.fatal:
            time.sleep(1.0)
        print(f"decode loop died: {server.fatal[0]}", flush=True)
        return 1
    except KeyboardInterrupt:
        return 0
    finally:
        server.close()


if __name__ == "__main__":
    raise SystemExit(main())
