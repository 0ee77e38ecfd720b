"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes plain C entry points.  At first use
every source is compiled by ``nvcc`` for ``sm_90a`` into a shared
library under ``build/torch_kernels/`` at the repository root (listed
in ``.gitignore``), one nvcc process per source, all started together,
and the asked-for library is loaded with ``ctypes``.  A library's file
name carries a hash of its source and the flags, so an edited source
builds anew and an unchanged one is reused.

``launches`` counts kernel launches by kernel name: each wrapper adds
one where it launches its kernel and nowhere else, so a run can show
that its path went through the kernels.

The process compile ledger (``utils/costplane.default_costplane``)
records each source nvcc compiles (program ``csrc/<name>.cu``, trigger
``nvcc``, that nvcc process's wall), each library load (trigger
``load``, the ``ctypes`` load's wall) and, through
:func:`record_first_launch`, the first launch of each kernel variant
class a wrapper chooses.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional, Tuple

from tf_operator_tpu_torch.utils.costplane import abstract_shapes, default_costplane

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "torch_kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

#: kernel name -> launches since the last ``launches.clear()``
launches: "collections.Counter[str]" = collections.Counter()

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: (program, class) of every kernel variant class launched in this process
_classes: set = set()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): "
            "the port's CUDA kernels are compiled with nvcc for sm_90a at "
            "first use"
        )
    return path


def sources() -> List[str]:
    """Names of every ``csrc/<name>.cu``."""

    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _library_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build_all() -> Dict[str, str]:
    """Compile every source whose library does not exist yet, one nvcc
    process per source, all started together.  Returns nvcc's output by
    name (the ptxas register and shared-memory report) for the sources
    it compiled, and raises with the output of each that failed."""

    todo = [n for n in sources() if not os.path.exists(_library_path(n))]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs, walls = {}, {}

    def wait(name, proc, t0):
        # each nvcc's own wall: its waiter returns when it exits
        logs[name] = proc.communicate()[0]
        walls[name] = time.perf_counter() - t0

    logs, failed, waiters = {}, [], []
    for name in todo:
        tmp = f"{_library_path(name)}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        procs[name] = (tmp, proc)
        waiters.append(threading.Thread(target=wait, args=(name, proc, t0)))
        waiters[-1].start()
    for t in waiters:
        t.join()
    for name, (tmp, proc) in procs.items():
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{logs[name]}")
        else:
            os.replace(tmp, _library_path(name))
            default_costplane.compiles.record(f"csrc/{name}.cu", "nvcc",
                                              seconds=walls[name])
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``; the first call whose
    library is missing builds every source (:func:`build_all`)."""

    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _library_path(name)
            if not os.path.exists(path):
                build_all()
            t0 = time.perf_counter()
            lib = ctypes.CDLL(path)
            default_costplane.compiles.record(f"csrc/{name}.cu", "load",
                                              seconds=time.perf_counter() - t0)
            _libs[name] = lib
        return lib


def first_launch(program: str, cls: Tuple) -> Optional[float]:
    """The host clock before a launch of variant class ``cls`` of
    ``program`` that has not launched in this process yet, else None:
    one set lookup, no device call.  The wrapper passes the clock to
    :func:`record_first_launch` after its launch."""

    return time.perf_counter() if (program, cls) not in _classes else None


def record_first_launch(program: str, cls: Tuple, trigger: str, t0: float,
                        tensors=()) -> None:
    """Record the first launch of ``cls`` in the process compile ledger:
    ``trigger`` names the class, the wall is the launch's host wall
    since ``t0`` (no synchronize: the enqueue and the driver's work on a
    kernel's first launch), the shapes those of ``tensors``."""

    seconds = time.perf_counter() - t0
    with _lock:
        if (program, cls) in _classes:
            return
        _classes.add((program, cls))
    default_costplane.compiles.record(program, trigger, seconds=seconds,
                                      shapes=abstract_shapes(tensors))
