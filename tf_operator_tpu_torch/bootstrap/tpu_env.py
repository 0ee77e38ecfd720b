"""The environment the operator injects into a job's processes: the
worker side's read of it (the port's copy of the names and of
``detected_slice_topology`` in ``tf_operator_tpu/bootstrap/tpu_env.py``).

- ``TPUJOB_*``: the job's world, read by ``runtime/bootstrap.from_env``
  and joined by ``runtime/bootstrap.initialize`` (a
  ``torch.distributed`` process group at the coordinator's address);
- ``MEGASCALE_NUM_SLICES`` / ``MEGASCALE_SLICE_ID``: the slice topology
  of a job that spans several slices, read by
  :func:`detected_slice_topology` and by ``parallel/mesh.make_mesh``;
- ``TPU_WORKER_ID`` / ``TPU_WORKER_HOSTNAMES``: a host's place within
  its slice (``dist_multislice`` asserts them);
- the ports and trace context the reconciler stamps per pod (telemetry,
  the KV fabric).

The operator side, which writes this environment, is the JAX package's
(``gen_tpu_env``); a port process only reads it.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

ENV_COORDINATOR = "TPUJOB_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "TPUJOB_NUM_PROCESSES"
ENV_PROCESS_ID = "TPUJOB_PROCESS_ID"
ENV_REPLICA_TYPE = "TPUJOB_REPLICA_TYPE"
ENV_REPLICA_INDEX = "TPUJOB_REPLICA_INDEX"
ENV_JOB_NAME = "TPUJOB_NAME"

#: the pod telemetry server's port (runtime/telemetry.py); unset or 0:
#: no server
ENV_TELEMETRY_PORT = "TPUJOB_TELEMETRY_PORT"
#: the reconciler's ``pod.create`` span, under which the train loop's
#: trace is rooted
ENV_TRACE_ID = "TPUJOB_TRACE_ID"
ENV_PARENT_SPAN_ID = "TPUJOB_PARENT_SPAN_ID"
#: the KV fabric server's port of a serving pod (serve_lm.py); unset or
#: 0: no fabric server
ENV_FABRIC_PORT = "TPUJOB_FABRIC_PORT"

ENV_NUM_SLICES = "MEGASCALE_NUM_SLICES"
ENV_SLICE_ID = "MEGASCALE_SLICE_ID"
ENV_WORKER_ID = "TPU_WORKER_ID"
ENV_WORKER_HOSTNAMES = "TPU_WORKER_HOSTNAMES"


def detected_slice_topology(environ=None) -> Tuple[int, Optional[int]]:
    """(num_slices, slice_id or None) from the MEGASCALE variables the
    operator injects into a multi-slice job's workers.  A world of one
    slice (no variables, or the one-slice case where none are injected)
    reads ``(1, None)``; values that do not parse read as absent."""

    e = os.environ if environ is None else environ
    try:
        n = int(e.get(ENV_NUM_SLICES, "1") or "1")
    except ValueError:
        n = 1
    sid_raw = e.get(ENV_SLICE_ID)
    sid: Optional[int] = None
    if sid_raw not in (None, ""):
        try:
            sid = int(sid_raw)
        except ValueError:
            sid = None
    return max(1, n), sid
