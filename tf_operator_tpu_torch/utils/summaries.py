"""Step-series training metrics (the port of
``tf_operator_tpu/utils/summaries.py``): the JAX package's JSON-lines
format and file layout, so that the operator (``tpujob describe
--metrics``, the dashboard, the job API's metrics endpoint, the health
rollup and the autoscaler) reads a port job's series unchanged.

One file a process, ``metrics-<process_id>.jsonl``, one JSON object a
line: ``{"step": N, "time": <unix>, "loss": ..., ...}``, scalars only,
values floats.  The writer appends and flushes a line at a time, so a
reader can tail the series while it grows.
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import Dict, List, Optional

#: the job annotation naming the summary directory, from which the
#: operator's job API serves the series
ANNOTATION_SUMMARY_DIR = "tpujob.dist/summary-dir"


class SummaryWriter:
    """Append-only JSON-lines scalar series of one process."""

    def __init__(self, directory: str, process_id: int = 0):
        self.directory = directory
        self.process_id = process_id
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, f"metrics-{process_id}.jsonl")
        self._f = open(self.path, "a", buffering=1)  # line-buffered

    def write(self, step: int, **scalars: float) -> None:
        """One record at ``step``; a value that is not a scalar is left
        out (a metric never stops training)."""

        rec: Dict[str, float] = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                continue
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "SummaryWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def latest_checkpoint_time(directory: str, series: Optional[List[dict]] = None
                           ) -> Optional[float]:
    """The newest ``checkpoint_time_unix`` of the series, or None: the
    checkpointer's durability stamp, which a trainer republishes into its
    series at each summary, read by another process (the operator's
    health rollup and the autoscaler's resize gate).  ``series``: an
    already read ``read_series`` tail, to reuse one disk read."""

    if series is None:
        series = read_series(directory, limit=50)
    for rec in reversed(series):
        v = rec.get("checkpoint_time_unix")
        if isinstance(v, (int, float)) and v > 0:
            return float(v)
    return None


def read_series(directory: str, limit: Optional[int] = None) -> List[dict]:
    """Every process's series merged, ordered by (step, time).  A
    malformed line (a writer that died mid-line) is skipped.  ``limit``
    keeps the newest N records after the merge, reading only the tail of
    each file that can hold them."""

    records: List[dict] = []
    for path in sorted(glob.glob(os.path.join(directory, "metrics-*.jsonl"))):
        try:
            with open(path, "rb") as f:
                if limit is not None:
                    # about 300 bytes a record: read enough of the tail
                    budget = max(4096, 400 * limit)
                    f.seek(0, os.SEEK_END)
                    size = f.tell()
                    f.seek(max(0, size - budget))
                    data = f.read()
                    if size > budget:
                        # the first line may be cut
                        data = data.split(b"\n", 1)[-1]
                else:
                    data = f.read()
            for line in data.decode(errors="replace").splitlines():
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(rec, dict) and "step" in rec:
                    records.append(rec)
        except OSError:
            continue
    records.sort(key=lambda r: (r.get("step", 0), r.get("time", 0.0)))
    if limit is not None and len(records) > limit:
        records = records[-limit:]
    return records
