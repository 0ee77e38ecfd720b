"""Cross-pod KV fabric service (the port of
``tf_operator_tpu/models/fabric_service.py``): the networked half of the
prefix-cache fabric.

- :class:`FabricServer` exports a pod's local fabric over HTTP:

      GET  /fabric/index            chain-key catalog + generation stamp
      GET  /fabric/blocks/<hexkey>  one block record on the wire
      POST /fabric/publish          push-style key announcements
      GET  /healthz                 liveness

- :class:`FleetFabric` is the client tier, duck-type compatible with
  ``PrefixFabric`` (models/prefix_cache.py), so the paged pool, the pool
  router and serve_lm use it unchanged: ``get`` resolves local-first,
  then pulls the block from a peer that advertises its chain key;
  ``__contains__`` answers fleet-wide; ``put`` publishes locally and
  announces the key to the peers.

The wire format is the JAX fabric's, byte for byte, so a port pod and a
JAX pod pull from each other: one JSON header line, ``{"v", "key",
"nbytes", "leaves": [{"shape", "dtype"}...], "sha256"}`` with sorted
keys, then each K/V leaf as an 8-byte big-endian length prefix and its
raw bytes.  The leaves go in the JAX arena's flatten order, which sorts
the flax layer names as strings (``layer_0, layer_1, layer_10, ...,
layer_2``), each layer's ``cached_key`` before its ``cached_value``
(``wire_order``); the port's record holds them in numeric layer order.
A bf16 leaf travels as its 2-byte words under the dtype name
``"bfloat16"`` (the JAX header's, through ``ml_dtypes``), without numpy
knowing the type: the port's host form of a bf16 block is its uint16
words.  The header's sha256 covers the whole payload and is checked
before anything is rebuilt; any fault is a :class:`PullError` whose
``reason`` (``PULL_FAILURE_REASONS``) counts in
``kv_fabric_pull_failures_total{reason}`` and degrades to a miss: the
admission recomputes, never a 500, never a poisoned block.

Pulls ride ``backend/retry.fabric_pull_policy``.  Sockets and numpy
only: no torch tensor crosses the wire.
"""

from __future__ import annotations

import hashlib
import json
import socket
import struct
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

#: bump when the /fabric/blocks header or payload layout changes: a
#: version-mismatched peer reads as corrupt and degrades to recompute
WIRE_VERSION = 1

#: the pull-failure taxonomy (the {reason} label); every one of them
#: means "recompute the tail", never an error surfaced to the request
PULL_FAILURE_REASONS = (
    "peer_dead",    # connection refused/reset, retry budget exhausted
    "not_found",    # stale index: peer evicted between index and pull
    "http_error",   # non-404 HTTP failure the retry policy gave up on
    "corrupt",      # content hash / header / template mismatch
    "short_read",   # payload shorter than its header claims
    "no_template",  # no arena template registered yet (pool still booting)
)

#: the wire's name of a bf16 leaf; its host form is the uint16 words
BF16 = "bfloat16"


class PullError(Exception):
    """A classified remote-pull failure (``reason`` in
    :data:`PULL_FAILURE_REASONS`)."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"{reason}: {detail}" if detail else reason)
        self.reason = reason


# ---------------------------------------------------------------------------
# wire codec
# ---------------------------------------------------------------------------


def wire_order(n_layers: int) -> List[Tuple[int, int]]:
    """(layer, 0 = K | 1 = V) in the JAX arena's flatten order: the
    layer names sorted as strings, K before V in each."""

    layers = sorted(range(n_layers), key=lambda i: f"layer_{i}")
    return [(i, j) for i in layers for j in (0, 1)]


def wire_dtype(name) -> Tuple[str, np.dtype]:
    """(the wire's dtype name, the host dtype) for a dtype name, a numpy
    dtype or a torch dtype: ``bfloat16`` is held as uint16 words."""

    name = str(name).replace("torch.", "")
    if name == BF16:
        return BF16, np.dtype(np.uint16)
    dt = np.dtype(name)
    return dt.name, dt


def host_block(kv) -> List[Tuple[np.ndarray, np.ndarray]]:
    """One block's host form from per-layer (K, V) torch tensors [1, Hkv,
    bs, D] (on the host already): numpy arrays, bf16 as its uint16
    words."""

    def one(t):
        if str(t.dtype) == "torch.bfloat16":
            import torch

            return t.contiguous().view(torch.int16).numpy().view(np.uint16)
        return t.contiguous().numpy()

    return [(one(k), one(v)) for k, v in kv]


def block_nbytes(kv) -> int:
    """The bytes of a block's K/V leaves (a record's ``nbytes``)."""

    return sum(int(a.nbytes) for pair in kv for a in pair)


def encode_block(key: bytes, rec: Dict[str, Any]) -> bytes:
    """Serialise one fabric record for the wire: the JSON header line,
    then every K/V leaf (``wire_order``) length-prefixed.  ``rec["kv"]``
    is the port's host form, where a uint16 leaf is a bf16 block's
    words."""

    kv = rec["kv"]
    parts: List[bytes] = []
    metas: List[Dict[str, Any]] = []
    for i, j in wire_order(len(kv)):
        arr = np.ascontiguousarray(kv[i][j])
        raw = arr.tobytes()
        parts.append(struct.pack(">Q", len(raw)))
        parts.append(raw)
        name = BF16 if arr.dtype == np.uint16 else str(arr.dtype)
        metas.append({"shape": list(arr.shape), "dtype": name})
    payload = b"".join(parts)
    header = {
        "v": WIRE_VERSION,
        "key": key.hex(),
        "nbytes": int(rec["nbytes"]),
        "leaves": metas,
        "sha256": hashlib.sha256(payload).hexdigest(),
    }
    return json.dumps(header, sort_keys=True).encode() + b"\n" + payload


def arena_template(arena) -> List[Tuple[int, int, tuple, str]]:
    """The template a pulled block is checked and rebuilt against: per
    wire leaf (``wire_order``), its layer, K or V, the arena leaf's shape
    [num_blocks, Hkv, bs, D] and its wire dtype name.  ``arena`` is the
    port's: per layer (K, V) tensors."""

    return [(i, j, tuple(arena[i][j].shape), wire_dtype(arena[i][j].dtype)[0])
            for i, j in wire_order(len(arena))]


def decode_block(body: bytes, template) -> Tuple[List[Tuple[np.ndarray, np.ndarray]], int]:
    """Parse a ``/fabric/blocks`` response against the registered arena
    ``template`` (``arena_template``); returns ``(kv, nbytes)`` in the
    port's host form.  Raises :class:`PullError` with its reason on any
    mismatch; the hash is checked before anything is rebuilt."""

    if template is None:
        raise PullError("no_template")
    try:
        nl = body.index(b"\n")
        header = json.loads(body[:nl])
    except (ValueError, UnicodeDecodeError) as exc:
        raise PullError("corrupt", f"unparseable header: {exc}")
    payload = body[nl + 1:]
    if int(header.get("v", 0)) != WIRE_VERSION:
        raise PullError("corrupt", f"wire version {header.get('v')!r}")
    if hashlib.sha256(payload).hexdigest() != header.get("sha256"):
        raise PullError("corrupt", "content hash mismatch")
    raws: List[Tuple[Dict[str, Any], bytes]] = []
    off = 0
    for meta in header.get("leaves", []):
        if off + 8 > len(payload):
            raise PullError("short_read", "truncated length prefix")
        (n,) = struct.unpack(">Q", payload[off: off + 8])
        off += 8
        if off + n > len(payload):
            raise PullError("short_read", f"leaf needs {n} bytes")
        raws.append((meta, payload[off: off + n]))
        off += n
    if len(raws) != len(template):
        raise PullError("corrupt", f"{len(raws)} wire leaves, template has {len(template)}")
    n_layers = len(template) // 2
    kv: List[List[Optional[np.ndarray]]] = [[None, None] for _ in range(n_layers)]
    for (meta, raw), (i, j, shape, name) in zip(raws, template):
        want_shape = (1,) + tuple(shape[1:])
        want_name, host = wire_dtype(name)
        try:
            got_name = wire_dtype(meta.get("dtype", "V"))[0]
        except TypeError:
            raise PullError("corrupt", f"bad dtype {meta.get('dtype')!r}")
        if tuple(meta.get("shape", ())) != want_shape or got_name != want_name:
            raise PullError("corrupt",
                            f"leaf {meta} does not match template {(want_shape, want_name)}")
        if len(raw) != host.itemsize * int(np.prod(want_shape)):
            raise PullError("short_read", "leaf byte count mismatch")
        kv[i][j] = np.frombuffer(raw, host).reshape(want_shape)
    return [(k, v) for k, v in kv], int(header.get("nbytes", 0))


# ---------------------------------------------------------------------------
# the client tier
# ---------------------------------------------------------------------------


class _Peer:
    """One peer's announced state (mutated under the fabric lock)."""

    def __init__(self, addr: str):
        self.addr = addr
        self.keys: set = set()
        self.generation = 0
        self.up: Optional[bool] = None  # None = never contacted
        self.last_index = 0.0  # monotonic stamp of the last index read


class FleetFabric:
    """Fleet-wide prefix fabric: a local ``PrefixFabric`` plus the HTTP
    client half of the cross-pod tier, duck-type compatible with
    ``PrefixFabric`` (``get``, ``unpin``, ``record``, ``put``,
    ``__contains__``, ``snapshot``).  A block pulled from a peer lands in
    the local fabric, and the record ``get`` returns carries
    ``transport="http"`` and ``peer``, so the pool meters its bytes by
    transport.  Remote pulls need the arena's template
    (``register_template``, which the paged pool calls once its arena
    exists); until then they count ``reason=no_template``.  With a
    ``metrics`` registry (default: the local fabric's) pulls count in
    ``kv_fabric_pulls_total{model, outcome}``, failures in
    ``kv_fabric_pull_failures_total{model, reason}``, and each peer's
    liveness sets ``kv_fabric_peer_up{peer}``."""

    def __init__(self, local, peers=(), metrics=None, model_label: str = "", policy=None,
                 request_timeout: float = 1.0, index_ttl_seconds: float = 2.0,
                 announce_timeout: float = 1.0):
        from tf_operator_tpu_torch.backend.retry import fabric_pull_policy

        self.local = local
        self.metrics = metrics if metrics is not None else local.metrics
        self.model_label = model_label or local.model_label
        self.policy = policy if policy is not None else fabric_pull_policy()
        self.request_timeout = float(request_timeout)
        self.index_ttl_seconds = float(index_ttl_seconds)
        self.announce_timeout = float(announce_timeout)
        self.advertise = ""  # host:port peers pull from (set after bind)
        self._lock = threading.Lock()
        self._peers: Dict[str, _Peer] = {str(a): _Peer(str(a)) for a in peers if str(a)}
        self._template = None
        self.pulls = {"hit": 0, "miss": 0, "failed": 0}
        self.pull_failures: Dict[str, int] = {}
        self.bytes_pulled = 0
        # push announcements: a daemon thread drains the queue, so put()
        # (called under the pool lock) never blocks on a socket
        self._ann_cv = threading.Condition()
        self._ann_pending: List[bytes] = []
        self._ann_thread: Optional[threading.Thread] = None
        self._ann_stop = False

    # -- PrefixFabric surface ----------------------------------------------

    def __len__(self) -> int:
        return len(self.local)

    def __contains__(self, key: bytes) -> bool:
        """Fleet-wide membership: local, or advertised by a peer
        (refreshing stale peer indexes on a miss), so a prefill pass
        skips a prompt another pod already published."""

        if key in self.local:
            return True
        return bool(self._peers_with(key))

    def unpin(self, key: bytes) -> None:
        self.local.unpin(key)

    def record(self, hit: bool) -> None:
        self.local.record(hit)

    def put(self, key: bytes, kv_tree: Any, nbytes: int) -> None:
        self.local.put(key, kv_tree, nbytes)
        self._announce([key])

    def get(self, key: bytes, pin: bool = False):
        """Local first; on a miss, pull from a peer whose index advertises
        the key.  A pulled block lands in the local fabric (later gets are
        local hits) and the returned record, a shallow copy, carries
        ``transport="http"`` and ``peer``.  Any failure returns None."""

        rec = self.local.get(key, pin=pin)
        if rec is not None:
            return rec
        with self._lock:
            have_peers = bool(self._peers)
        if not have_peers:
            return None
        candidates = self._peers_with(key)
        if not candidates:
            self._count_pull("miss")
            return None
        for peer in candidates:
            try:
                kv, nbytes = self._pull_block(peer, key)
            except PullError as exc:
                self._count_failure(exc.reason, peer)
                if exc.reason == "not_found":
                    with self._lock:
                        peer.keys.discard(key)
                continue
            self._mark_up(peer)
            self.local.put(key, kv, nbytes)
            stored = self.local.get(key, pin=pin)
            if stored is None:  # pathological capacity: serve it transient
                stored = {"kv": kv, "nbytes": int(nbytes)}
            self._count_pull("hit")
            with self._lock:
                self.bytes_pulled += int(nbytes)
            return dict(stored, transport="http", peer=peer.addr)
        self._count_pull("failed")
        return None

    def snapshot(self) -> dict:
        snap = self.local.snapshot()
        with self._lock:
            snap["advertise"] = self.advertise
            snap["peers"] = [
                {"peer": p.addr, "up": p.up, "keys": len(p.keys), "generation": p.generation}
                for p in self._peers.values()
            ]
            snap["pulls"] = dict(self.pulls)
            snap["pull_failures"] = dict(self.pull_failures)
            snap["bytes_pulled"] = self.bytes_pulled
        return snap

    # -- fleet plumbing ------------------------------------------------------

    def register_template(self, arena) -> None:
        """Record the template that pulled blocks decode against
        (``arena_template`` of the pool's arena)."""

        template = arena_template(arena)
        with self._lock:
            self._template = template

    def set_advertise(self, addr: str) -> None:
        """The ``host:port`` this pod's :class:`FabricServer` serves on,
        stamped into announcements so that peers learn where to pull."""

        self.advertise = str(addr)

    def handle_publish(self, payload: dict) -> None:
        """Merge a peer's ``POST /fabric/publish`` announcement: an
        unknown sender is added (discovery), a known one's key set grows;
        malformed keys are dropped."""

        addr = str(payload.get("advertise") or "")
        if not addr or addr == self.advertise:
            return
        keys = []
        for k in payload.get("keys", []) or []:
            try:
                keys.append(bytes.fromhex(str(k)))
            except ValueError:
                continue
        with self._lock:
            peer = self._peers.get(addr)
            if peer is None:
                peer = self._peers[addr] = _Peer(addr)
            peer.keys.update(keys)
            try:
                peer.generation = int(payload.get("generation") or 0)
            except (TypeError, ValueError):
                pass
        self._mark_up(peer)

    def refresh_peers(self) -> None:
        """Read every peer's index now."""

        with self._lock:
            peers = list(self._peers.values())
        for p in peers:
            self._refresh_index(p)

    def stop(self) -> None:
        """Join the announcer thread."""

        with self._ann_cv:
            self._ann_stop = True
            self._ann_cv.notify()
        t = self._ann_thread
        if t is not None:
            t.join(timeout=2.0)

    # -- internals -----------------------------------------------------------

    def _peers_with(self, key: bytes) -> List[_Peer]:
        """Peers whose index holds ``key``: the cached indexes first, then
        a re-read of any index older than ``index_ttl_seconds`` (one HTTP
        round a peer a TTL window at most)."""

        with self._lock:
            peers = list(self._peers.values())
        found = [p for p in peers if key in p.keys]
        if found:
            return found
        now = time.monotonic()
        for p in peers:
            if now - p.last_index > self.index_ttl_seconds:
                self._refresh_index(p)
        return [p for p in peers if key in p.keys]

    def _refresh_index(self, peer: _Peer) -> None:
        url = f"http://{peer.addr}/fabric/index"
        try:
            with urllib.request.urlopen(url, timeout=self.request_timeout) as resp:
                idx = json.loads(resp.read())
        except (OSError, ValueError):
            peer.up = False
            peer.last_index = time.monotonic()
            if self.metrics is not None:
                self.metrics.set("kv_fabric_peer_up", 0.0, peer=peer.addr)
            return
        keys = set()
        for k in idx.get("keys", []) or []:
            try:
                keys.add(bytes.fromhex(str(k)))
            except ValueError:
                continue
        with self._lock:
            peer.keys = keys
            try:
                peer.generation = int(idx.get("generation") or 0)
            except (TypeError, ValueError):
                pass
            peer.last_index = time.monotonic()
        self._mark_up(peer)

    def _pull_block(self, peer: _Peer, key: bytes):
        with self._lock:
            template = self._template
        if template is None:
            raise PullError("no_template")
        url = f"http://{peer.addr}/fabric/blocks/{key.hex()}"

        def attempt():
            with urllib.request.urlopen(url, timeout=self.request_timeout) as resp:
                return resp.read()

        try:
            body = self.policy.call(attempt, client="fabric", metrics=self.metrics)
        except urllib.error.HTTPError as exc:
            raise PullError("not_found" if exc.code == 404 else "http_error",
                            f"HTTP {exc.code}")
        except OSError as exc:
            raise PullError("peer_dead", str(exc))
        return decode_block(body, template)

    def _count_pull(self, outcome: str) -> None:
        with self._lock:
            self.pulls[outcome] = self.pulls.get(outcome, 0) + 1
        if self.metrics is not None:
            self.metrics.inc("kv_fabric_pulls_total", model=self.model_label, outcome=outcome)

    def _count_failure(self, reason: str, peer: _Peer) -> None:
        with self._lock:
            self.pull_failures[reason] = self.pull_failures.get(reason, 0) + 1
        if self.metrics is not None:
            self.metrics.inc("kv_fabric_pull_failures_total", model=self.model_label,
                             reason=reason)
        if reason == "peer_dead":
            peer.up = False
            if self.metrics is not None:
                self.metrics.set("kv_fabric_peer_up", 0.0, peer=peer.addr)

    def _mark_up(self, peer: _Peer) -> None:
        peer.up = True
        if self.metrics is not None:
            self.metrics.set("kv_fabric_peer_up", 1.0, peer=peer.addr)

    def _announce(self, keys: List[bytes]) -> None:
        with self._lock:
            have_peers = bool(self._peers)
        if not have_peers or not self.advertise:
            return
        with self._ann_cv:
            self._ann_pending.extend(keys)
            if self._ann_thread is None or not self._ann_thread.is_alive():
                self._ann_thread = threading.Thread(target=self._announce_loop, daemon=True,
                                                    name="fabric-announce")
                self._ann_thread.start()
            self._ann_cv.notify()

    def _announce_loop(self) -> None:
        while True:
            with self._ann_cv:
                while not self._ann_pending and not self._ann_stop:
                    self._ann_cv.wait(timeout=1.0)
                if self._ann_stop and not self._ann_pending:
                    return
                batch, self._ann_pending = self._ann_pending, []
            body = json.dumps({
                "advertise": self.advertise,
                "keys": [k.hex() for k in batch],
                "generation": getattr(self.local, "generation", 0),
            }).encode()
            with self._lock:
                addrs = list(self._peers)
            for addr in addrs:
                req = urllib.request.Request(
                    f"http://{addr}/fabric/publish", data=body,
                    headers={"Content-Type": "application/json"}, method="POST",
                )
                try:
                    with urllib.request.urlopen(req, timeout=self.announce_timeout):
                        pass
                except OSError:
                    pass  # best effort: the pull side's index reads recover


# ---------------------------------------------------------------------------
# the server tier
# ---------------------------------------------------------------------------


class FabricServer:
    """A pod's HTTP exporter of its local prefix fabric (threaded stdlib
    server, silenced logs, ``port`` / ``url`` / ``addr``, ``start`` /
    ``stop``).  ``fabric`` is a bare ``PrefixFabric`` or a
    :class:`FleetFabric` (whose ``local`` store is served and whose
    ``handle_publish`` takes announcements).  ``faults`` is an optional
    chaos hook duck-typed on ``decide(method, raw_path)`` (the JAX
    package's ``backend/kubesim.FaultInjector`` plugs in): ``("latency",
    s)`` sleeps, ``("error", status, retry_after)`` answers that status,
    anything else resets the connection mid-request."""

    def __init__(self, fabric, host: str = "127.0.0.1", port: int = 0, faults=None):
        self.fabric = fabric
        self.local = getattr(fabric, "local", fabric)
        self.faults = faults
        outer = self

        class Handler(BaseHTTPRequestHandler):
            server_version = "tpu-kv-fabric/1"

            def log_message(self, fmt, *args):  # quiet
                pass

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                try:
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def _send_json(self, code: int, obj) -> None:
                self._send(code, json.dumps(obj).encode(), "application/json")

            def _inject(self) -> bool:
                """True when a fault consumed the request."""

                if outer.faults is None:
                    return False
                decision = outer.faults.decide(self.command, self.path)
                if decision is None:
                    return False
                if decision[0] == "latency":
                    time.sleep(decision[1])
                    return False
                if decision[0] == "error":
                    _, status, retry_after = decision
                    self.send_response(int(status))
                    if retry_after is not None:
                        self.send_header("Retry-After", str(retry_after))
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return True
                # a reset: SO_LINGER(1, 0) and a hard shutdown, so the
                # client sees ECONNRESET mid-read (a peer dying mid-pull)
                try:
                    self.connection.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                               struct.pack("ii", 1, 0))
                except OSError:
                    pass
                self.close_connection = True
                try:
                    self.connection.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                return True

            def do_GET(self):
                if self._inject():
                    return
                route = self.path.split("?")[0]
                try:
                    if route == "/healthz":
                        return self._send(200, b"ok\n", "text/plain")
                    if route == "/fabric/index":
                        return self._send_json(200, outer.index())
                    if route.startswith("/fabric/blocks/"):
                        try:
                            key = bytes.fromhex(route[len("/fabric/blocks/"):])
                        except ValueError:
                            return self._send_json(400, {"error": "bad chain key"})
                        # pinned across the encode: no eviction races it
                        rec = outer.local.get(key, pin=True)
                        if rec is None:
                            return self._send_json(404, {"error": "unknown chain key"})
                        try:
                            body = encode_block(key, rec)
                        finally:
                            outer.local.unpin(key)
                        return self._send(200, body, "application/octet-stream")
                    return self._send_json(404, {"error": "not found"})
                except Exception as exc:  # noqa: BLE001 - the HTTP boundary
                    return self._send_json(500, {"error": f"{type(exc).__name__}: {exc}"})

            def do_POST(self):
                if self._inject():
                    return
                route = self.path.split("?")[0]
                try:
                    if route == "/fabric/publish":
                        n = int(self.headers.get("Content-Length") or 0)
                        raw = self.rfile.read(n) if n else b"{}"
                        try:
                            payload = json.loads(raw or b"{}")
                        except ValueError:
                            return self._send_json(400, {"error": "bad announcement"})
                        handle = getattr(outer.fabric, "handle_publish", None)
                        if handle is not None:
                            handle(payload)
                        return self._send_json(200, {"ok": True})
                    return self._send_json(404, {"error": "not found"})
                except Exception as exc:  # noqa: BLE001 - the HTTP boundary
                    return self._send_json(500, {"error": f"{type(exc).__name__}: {exc}"})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    def index(self) -> dict:
        """The /fabric/index document: every local chain key (hex) and the
        store's generation stamp."""

        keys, generation = self.local.index_keys()
        return {
            "v": WIRE_VERSION,
            "model": getattr(self.local, "model_label", ""),
            "advertise": getattr(self.fabric, "advertise", ""),
            "generation": int(generation),
            "keys": [k.hex() for k in keys],
        }

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    @property
    def addr(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"{host}:{port}"

    def start(self) -> "FabricServer":
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True,
                                            name="kv-fabric")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
