"""The device cost plane (the port of ``tf_operator_tpu/utils/costplane.py``):
compile ledger, device-memory accountant, step-time sentinel.

``CompileLedger``
  The stalls a process pays before its kernels run, each registered
  with the TRIGGER that caused it, the abstract input shapes, the
  observed host wall and the owning trace id.  Eager PyTorch compiles
  nothing per shape, so on the card the port's "compiles" are:

  - each ``nvcc`` build of a ``csrc/<name>.cu`` (program
    ``csrc/<name>.cu``, trigger ``nvcc``; the wall is that nvcc
    process's own, from its start to its exit);
  - each ``ctypes`` load of a built library (trigger ``load``);
  - the first launch of each kernel variant class a wrapper chooses
    (program ``ops.<module>``, the class as trigger: K4's ``k_new``,
    split count and dtype, K7's route, K1-K3's causal / window and
    dtype, K5's epilogue).

  Exported as ``compile_total{program,trigger}`` /
  ``compile_seconds{program}`` plus a bounded event ring
  (``GET /debug/compiles``).

  Honesty note on the wall: a variant class's wall is the host wall of
  its FIRST launch without a synchronize, the enqueue plus whatever the
  driver does on a kernel's first launch (the lazy load of its module);
  it never includes the kernel's device time.  It is labeled
  ``first_call_seconds`` in the ring to keep the claim exact.
  ``note()`` registers a class with no wall at all (0.0).

  The kernels record into the process ledger (``default_costplane``):
  a kernel is built, loaded and first launched once per process, not
  once per pool.  ``mirror(metrics)`` copies the ledger's families into
  another registry (a server's) and keeps them in step, so that the
  server's ``/metrics`` and its alert engine see every record.

``HBMAccountant``
  A per-device ledger of the big allocations: weights, optimizer state,
  KV arena, swap staging (host memory, under ``host:<replica>``), the
  peak transient (``program_tmp``) and ``other``, exported as
  ``hbm_component_bytes{device,component}`` with
  ``hbm_device_limit_bytes{device}`` / ``hbm_headroom_bytes{device}``
  and a ``GET /debug/memory`` snapshot that also reports COVERAGE: the
  resident components' bytes over what the caching allocator says is
  live (``allocated_bytes.all.current``: live tensors, not the
  allocator's reserve).  The device label is ``str(tensor.device)``
  (``cuda:0``, ``cpu``); a CPU device's live bytes are unknown (None),
  so its coverage is None.  The device limit (``mem_get_info``'s total)
  is read once per device and cached, because components are set on
  the decode loop's gauge refresh and a driver call there would sit on
  the window's path.  ``program_tmp`` is read only in ``snapshot()``:
  the device's ``max_memory_allocated`` less the resident components,
  the peak a window's transients reached on top of them; being a peak,
  it counts toward headroom and is left out of coverage.

``StepTimeSentinel``
  Rolling p50/p99 over the last ``window`` observations of each
  wall-clock signal (``decode.window``, ``train_sync``), with the
  reference quantiles FROZEN from the first ``warmup`` observations.
  The drift gauge is ``rolling_p50 / reference_p50`` — the median, not
  the tail, so jitter in the p99 cannot false-positive the
  ``step-time-regression`` stock rule.  Pure host arithmetic: it runs
  inside the decode window and the train loop.

``CostPlane`` bundles the three over ONE metrics registry; the process
global ``default_costplane`` rides ``utils.metrics.default_metrics``.
A module-level process counter sums every recorded compile
(``process_compile_count``).
"""

from __future__ import annotations

import collections
import os
import threading
import time
import weakref
from typing import Any, Dict, List, Optional

__all__ = [
    "CompileLedger",
    "HBMAccountant",
    "StepTimeSentinel",
    "CostPlane",
    "default_costplane",
    "process_compile_count",
    "abstract_shapes",
    "tree_device_bytes",
]

# -- process-wide compile counter -----------------------------------------

_process_lock = threading.Lock()
_process_compiles = 0


def _count_process_compile() -> None:
    global _process_compiles
    with _process_lock:
        _process_compiles += 1


def process_compile_count() -> int:
    """Total compiles recorded by EVERY CompileLedger instance in this
    process since import."""

    with _process_lock:
        return _process_compiles


# -- shape / byte helpers -------------------------------------------------

_SHORT_DTYPE = {
    "float32": "f32", "float16": "f16", "bfloat16": "bf16",
    "float64": "f64", "int32": "i32", "int64": "i64", "int8": "i8",
    "uint32": "u32", "uint8": "u8", "bool": "pred",
}


def _leaves(tree) -> List[Any]:
    """The leaves of a nest of dicts, lists and tuples, in order; a
    module's are its parameters then its buffers; ``None`` is dropped."""

    import torch

    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in _leaves(x)]
    return [] if tree is None else [tree]


def _describe_leaf(leaf) -> Optional[str]:
    """'f32[4,128]' for a tensor or array, None for anything else."""

    shape = getattr(leaf, "shape", None)
    dtype = getattr(leaf, "dtype", None)
    if shape is None or dtype is None:
        return None
    name = str(dtype).replace("torch.", "")
    name = _SHORT_DTYPE.get(name, name)
    return f"{name}[{','.join(str(int(s)) for s in shape)}]"


def abstract_shapes(args, kwargs=None, limit: int = 12) -> List[str]:
    """The abstract input signature of a call: the first ``limit``
    tensor or array leaves as dtype[shape] strings (+ an elision
    marker).  Metadata only — never touches device values."""

    leaves = _leaves((args, kwargs or {}))
    out: List[str] = []
    for leaf in leaves:
        desc = _describe_leaf(leaf)
        if desc is not None:
            out.append(desc)
        if len(out) >= limit:
            out.append(f"...+{max(0, len(leaves) - limit)} leaves")
            break
    return out


def tree_device_bytes(tree) -> Dict[str, int]:
    """Per-device bytes of a module, a state dict or a nest of tensors
    (numpy arrays count under ``host``).  Each storage counts once, by
    ``untyped_storage().data_ptr()``, so tied or viewed tensors are not
    counted twice; a storage counts whole.  Metadata only."""

    import torch

    out: Dict[str, int] = {}
    seen: set = set()
    for leaf in _leaves(tree):
        if hasattr(leaf, "q") and hasattr(leaf, "scale"):  # a QTensor
            parts = [leaf.q, leaf.scale]
        else:
            parts = [leaf]
        for t in parts:
            if isinstance(t, torch.Tensor):
                if t.device.type == "meta":
                    continue
                storage = t.untyped_storage()
                dev = str(t.device)
                key = (dev, storage.data_ptr())
                nbytes = storage.nbytes()
            else:
                nbytes = getattr(t, "nbytes", None)
                if nbytes is None:
                    continue
                dev, key = "host", ("host", id(t))
            if key in seen:
                continue
            seen.add(key)
            out[dev] = out.get(dev, 0) + int(nbytes)
    return out


def _cuda_index(device: str) -> Optional[int]:
    """The ordinal of a ``cuda:N`` label, None for any other device."""

    if not device.startswith("cuda:"):
        return None
    try:
        return int(device[len("cuda:"):])
    except ValueError:
        return None


# -- (a) the compile ledger -----------------------------------------------


class CompileLedger:
    """Attributed compile registry + ``compile_total{program,trigger}``
    / ``compile_seconds{program}`` emission + the bounded event ring
    behind ``GET /debug/compiles``."""

    def __init__(self, metrics=None, ring: int = 256):
        self._lock = threading.Lock()
        self._metrics = metrics
        self._ring: collections.deque = collections.deque(maxlen=int(ring))
        self._total = 0
        self._seq = 0
        #: registries kept in step with this ledger's (``mirror``); weak,
        #: so a server that goes takes its registry with it
        self._mirrors: "weakref.WeakSet" = weakref.WeakSet()

    @property
    def metrics(self):
        if self._metrics is None:
            from tf_operator_tpu_torch.utils.metrics import default_metrics

            self._metrics = default_metrics
        return self._metrics

    def mirror(self, metrics) -> None:
        """Keep ``metrics`` in step with this ledger: the compile
        families recorded so far are copied into it now, and every
        later record lands in it too."""

        own = self.metrics
        if metrics is None or metrics is own:
            return
        with self._lock:
            if metrics in self._mirrors:
                return
            for labels, v in own.counter_series("compile_total").items():
                metrics.inc("compile_total", v, **dict(labels))
            for labels, (bks, counts, total, n) in own.histogram_raw(
                    "compile_seconds").items():
                metrics.merge_histogram("compile_seconds", bks, counts, total, n,
                                        **dict(labels))
            self._mirrors.add(metrics)

    def record(self, program: str, trigger: str = "",
               seconds: float = 0.0, shapes: Optional[List[str]] = None,
               trace_id: Optional[str] = None) -> Dict[str, Any]:
        """Register ONE compile.  ``seconds`` is the first-call wall
        (0.0 for ``note()``-style registrations where no honest wall
        exists)."""

        if trace_id is None:
            from tf_operator_tpu_torch.utils.trace import current_trace_id

            trace_id = current_trace_id() or ""
        own = self.metrics
        with self._lock:
            self._seq += 1
            event = {
                "seq": self._seq,
                "program": program,
                "trigger": trigger,
                "shapes": list(shapes or []),
                "first_call_seconds": round(float(seconds), 6),
                "trace_id": trace_id,
                "when": time.time(),
            }
            self._ring.append(event)
            self._total += 1
            # emitted under the lock, so that a mirror attached
            # concurrently neither misses this record nor counts it twice
            for m in [own, *self._mirrors]:
                if m is not None:
                    m.inc("compile_total", program=program, trigger=trigger)
                    m.observe_histogram("compile_seconds", seconds, program=program)
        _count_process_compile()
        return event

    def note(self, program: str, trigger: str = "", **kw) -> Dict[str, Any]:
        """Register a compile class whose wall is not measured: counted
        and attributed, wall honestly absent (0.0)."""

        return self.record(program, trigger, seconds=0.0, **kw)

    def wrap(self, fn, program: str, trigger: str = ""):
        """Return ``fn`` instrumented so its FIRST call registers one
        compile (wall = the first call's host wall; see module
        docstring)."""

        state = {"done": False}
        lock = threading.Lock()

        def timed(*args, **kwargs):
            if state["done"]:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            dt = time.perf_counter() - t0
            with lock:
                first, state["done"] = (not state["done"]), True
            if first:
                self.record(
                    program, trigger, seconds=dt,
                    shapes=abstract_shapes(args, kwargs),
                )
            return out

        timed.__wrapped__ = fn
        return timed

    def total(self) -> int:
        with self._lock:
            return self._total

    def snapshot(self, limit: Optional[int] = None) -> Dict[str, Any]:
        """The /debug/compiles payload: totals by program+trigger and
        the newest-first event ring (bounded)."""

        with self._lock:
            events = list(self._ring)
            total = self._total
        events.reverse()
        if limit is not None:
            events = events[: max(0, int(limit))]
        by_program: Dict[str, Dict[str, Any]] = {}
        m = self.metrics
        if m is not None:
            for labels, v in m.counter_series("compile_total").items():
                lab = dict(labels)
                prog = lab.get("program", "?")
                slot = by_program.setdefault(
                    prog, {"total": 0, "byTrigger": {}}
                )
                slot["total"] += int(v)
                trig = lab.get("trigger", "")
                slot["byTrigger"][trig] = (
                    slot["byTrigger"].get(trig, 0) + int(v)
                )
        return {
            "total": total,
            "processTotal": process_compile_count(),
            "byProgram": by_program,
            "events": events,
        }


# -- (b) the device-memory accountant -------------------------------------

#: the closed component taxonomy (the JAX module's)
HBM_COMPONENTS = (
    "weights",
    "optimizer",
    "kv_arena",
    "swap_staging",
    "program_tmp",
    "other",
)


class HBMAccountant:
    """Per-device byte ledger of the big allocations, with coverage
    against the live bytes the caching allocator reports (see module
    docstring)."""

    def __init__(self, metrics=None, limit_bytes: Optional[int] = None):
        self._lock = threading.Lock()
        self._metrics = metrics
        #: (device, component) -> bytes
        self._components: Dict[tuple, int] = {}
        #: device -> its capacity, read once (``device_limit``)
        self._limits: Dict[str, Optional[int]] = {}
        env = os.environ.get("TPUJOB_DEVICE_LIMIT_BYTES", "")
        self._limit_override = (
            int(limit_bytes) if limit_bytes is not None
            else (int(env) if env.isdigit() else None)
        )

    @property
    def metrics(self):
        if self._metrics is None:
            from tf_operator_tpu_torch.utils.metrics import default_metrics

            self._metrics = default_metrics
        return self._metrics

    @staticmethod
    def _default_device() -> str:
        import torch

        return "cuda:0" if torch.cuda.is_available() else "cpu"

    def set_component(self, component: str, nbytes: int,
                      device: str = "") -> None:
        """Set (not add) one component's bytes on one device.  Callers
        on hot paths pass host-computed ints only."""

        if component not in HBM_COMPONENTS:
            raise ValueError(
                f"unknown HBM component {component!r} "
                f"(taxonomy: {HBM_COMPONENTS})"
            )
        dev = device or self._default_device()
        with self._lock:
            self._components[(dev, component)] = int(nbytes)
        self._emit(dev)

    def add_component(self, component: str, nbytes: int,
                      device: str = "") -> None:
        """Accumulate into a component (several pools, or a pool and its
        draft twin, sharing one accountant each add their arena)."""

        if component not in HBM_COMPONENTS:
            raise ValueError(f"unknown HBM component {component!r}")
        dev = device or self._default_device()
        with self._lock:
            key = (dev, component)
            self._components[key] = self._components.get(key, 0) + int(nbytes)
        self._emit(dev)

    def register_tree(self, component: str, tree) -> None:
        """Account a module, a state dict or a nest of tensors (weights,
        optimizer state, KV arena) under ``component``, split per
        device, each storage once (``tree_device_bytes``)."""

        per_dev = tree_device_bytes(tree)
        if not per_dev:
            per_dev = {self._default_device(): 0}
        for dev, nbytes in per_dev.items():
            self.add_component(component, nbytes, device=dev)

    # -- backend truth ----------------------------------------------------

    @staticmethod
    def backend_bytes() -> Dict[str, Optional[int]]:
        """What the caching allocator says is live on each CUDA device
        (``allocated_bytes.all.current``); no entry for a device it
        cannot see (the CPU: unknown stays unknown)."""

        import torch

        out: Dict[str, Optional[int]] = {}
        if not torch.cuda.is_available():
            return out
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            out[f"cuda:{i}"] = int(stats.get("allocated_bytes.all.current", 0))
        return out

    @staticmethod
    def peak_bytes(device: str) -> Optional[int]:
        """The device's ``max_memory_allocated`` (since the last reset of
        the peak), None for a device the allocator does not track."""

        import torch

        idx = _cuda_index(device)
        if idx is None or not torch.cuda.is_available():
            return None
        return int(torch.cuda.max_memory_allocated(idx))

    def device_limit(self, device: str) -> Optional[int]:
        """The device's byte capacity: the explicit override (ctor or
        TPUJOB_DEVICE_LIMIT_BYTES) wins, else ``mem_get_info``'s total,
        read once per device and cached, else None (the CPU, a host
        label: the headroom gauge is simply not emitted)."""

        if self._limit_override is not None:
            return self._limit_override
        with self._lock:
            if device in self._limits:
                return self._limits[device]
        idx = _cuda_index(device)
        limit = None
        if idx is not None:
            import torch

            if torch.cuda.is_available():
                limit = int(torch.cuda.mem_get_info(idx)[1])
        with self._lock:
            self._limits[device] = limit
        return limit

    def _emit(self, device: str) -> None:
        m = self.metrics
        if m is None:
            return
        with self._lock:
            comps = {
                c: b for (d, c), b in self._components.items()
                if d == device
            }
        accounted = 0
        for comp, nbytes in sorted(comps.items()):
            accounted += nbytes
            m.set(
                "hbm_component_bytes", float(nbytes),
                device=device, component=comp,
            )
        limit = self.device_limit(device)
        if limit is not None:
            m.set("hbm_device_limit_bytes", float(limit), device=device)
            m.set(
                "hbm_headroom_bytes", float(limit - accounted),
                device=device,
            )

    def snapshot(self) -> Dict[str, Any]:
        """The /debug/memory payload: per-device component table,
        accounted total, the allocator's live bytes, limit/headroom and
        the coverage ratio (resident components over live bytes).  Reads
        the peak into ``program_tmp`` first (module docstring)."""

        with self._lock:
            devices = {d for d, _ in self._components}
        for dev in devices:
            peak = self.peak_bytes(dev)
            if peak is None:
                continue
            with self._lock:
                resident = sum(b for (d, c), b in self._components.items()
                               if d == dev and c != "program_tmp")
                self._components[(dev, "program_tmp")] = max(0, peak - resident)
            self._emit(dev)
        with self._lock:
            comps = dict(self._components)
        backend = self.backend_bytes()
        devices = sorted(
            {d for d, _ in comps} | set(backend.keys())
        )
        out_devices = []
        for dev in devices:
            table = {
                c: b for (d, c), b in comps.items() if d == dev
            }
            accounted = sum(table.values())
            resident = accounted - table.get("program_tmp", 0)
            live = backend.get(dev)
            limit = self.device_limit(dev)
            coverage = (
                round(resident / live, 4) if live else None
            )
            out_devices.append({
                "device": dev,
                "components": {
                    c: table.get(c, 0) for c in HBM_COMPONENTS
                },
                "accounted_bytes": accounted,
                "backend_bytes": live,
                "limit_bytes": limit,
                "headroom_bytes": (
                    limit - accounted if limit is not None else None
                ),
                "coverage": coverage,
            })
        # worst headroom first (unknown-limit devices sink to the end)
        out_devices.sort(
            key=lambda d: (
                d["headroom_bytes"] is None,
                d["headroom_bytes"] if d["headroom_bytes"] is not None
                else -d["accounted_bytes"],
            )
        )
        return {
            "devices": out_devices,
            "accounted_bytes": sum(
                d["accounted_bytes"] for d in out_devices
            ),
        }


# -- (c) the step-time sentinel -------------------------------------------


class StepTimeSentinel:
    """Rolling-quantile drift detector over wall-clock signals (see
    module docstring).  ``observe`` / ``_quantiles`` are pure host
    arithmetic: no device traffic, no ``float()`` of anything that could
    be a device value."""

    def __init__(self, metrics=None, window: int = 128, warmup: int = 16):
        self._lock = threading.Lock()
        self._metrics = metrics
        self.window = max(8, int(window))
        self.warmup = max(4, int(warmup))
        self._samples: Dict[str, collections.deque] = {}
        self._reference: Dict[str, tuple] = {}  # signal -> (p50, p99)
        self._count: Dict[str, int] = {}

    @property
    def metrics(self):
        if self._metrics is None:
            from tf_operator_tpu_torch.utils.metrics import default_metrics

            self._metrics = default_metrics
        return self._metrics

    @staticmethod
    def _quantiles(ordered) -> tuple:
        n = len(ordered)
        p50 = ordered[min(n - 1, (n - 1) // 2)]
        p99 = ordered[min(n - 1, (99 * (n - 1)) // 100)]
        return p50, p99

    def observe(self, signal: str, seconds) -> None:
        """One window wall.  Freezes the reference quantiles at the
        ``warmup``-th observation; after that every call refreshes the
        p50/p99 gauges and the drift ratio (rolling_p50 / ref_p50)."""

        with self._lock:
            dq = self._samples.get(signal)
            if dq is None:
                dq = collections.deque(maxlen=self.window)
                self._samples[signal] = dq
                self._count[signal] = 0
            dq.append(seconds)
            self._count[signal] += 1
            n = self._count[signal]
            ordered = sorted(dq)
            p50, p99 = self._quantiles(ordered)
            if n == self.warmup and signal not in self._reference:
                eps = 1e-9
                self._reference[signal] = (
                    p50 if p50 > eps else eps,
                    p99 if p99 > eps else eps,
                )
            ref = self._reference.get(signal)
        m = self.metrics
        if m is not None:
            m.set("step_time_p50_seconds", p50, signal=signal)
            m.set("step_time_p99_seconds", p99, signal=signal)
            if ref is not None:
                m.set(
                    "step_time_drift_ratio", p50 / ref[0], signal=signal
                )

    def reference(self, signal: str) -> Optional[tuple]:
        with self._lock:
            return self._reference.get(signal)

    def reset(self, signal: Optional[str] = None) -> None:
        """Drop state (all signals, or one) — the re-baseline hook a
        deliberate change (new model, new K) uses so the drift gauge
        compares against the NEW steady state."""

        with self._lock:
            if signal is None:
                self._samples.clear()
                self._reference.clear()
                self._count.clear()
                return
            self._samples.pop(signal, None)
            self._reference.pop(signal, None)
            self._count.pop(signal, None)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out = {}
            for sig, dq in self._samples.items():
                ordered = sorted(dq)
                p50, p99 = self._quantiles(ordered) if ordered else (0, 0)
                ref = self._reference.get(sig)
                out[sig] = {
                    "observations": self._count.get(sig, 0),
                    "p50_seconds": p50,
                    "p99_seconds": p99,
                    "reference_p50_seconds": ref[0] if ref else None,
                    "reference_p99_seconds": ref[1] if ref else None,
                    "drift_ratio": (
                        round(p50 / ref[0], 4) if ref else None
                    ),
                }
            return out


# -- the bundle + process global ------------------------------------------


class CostPlane:
    """One metrics registry, three ledgers — what a serving process or
    a training run wires through its planes.  ``compiles`` shares an
    existing ledger (a server passes the process ledger, where the
    kernels record), mirrored into ``metrics``."""

    def __init__(self, metrics=None, ring: int = 256,
                 sentinel_window: int = 128, sentinel_warmup: int = 16,
                 limit_bytes: Optional[int] = None,
                 compiles: Optional[CompileLedger] = None):
        if compiles is None:
            compiles = CompileLedger(metrics=metrics, ring=ring)
        elif metrics is not None:
            compiles.mirror(metrics)
        self.compiles = compiles
        self.hbm = HBMAccountant(metrics=metrics, limit_bytes=limit_bytes)
        self.sentinel = StepTimeSentinel(
            metrics=metrics, window=sentinel_window, warmup=sentinel_warmup
        )

    def snapshot(self) -> Dict[str, Any]:
        return {
            "compiles": self.compiles.snapshot(limit=32),
            "memory": self.hbm.snapshot(),
            "stepTime": self.sentinel.snapshot(),
        }


default_costplane = CostPlane()
