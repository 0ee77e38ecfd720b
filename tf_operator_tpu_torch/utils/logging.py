"""Job-scoped structured logging (a copy of
``tf_operator_tpu/utils/logging.py``).

Loggers with job/replica fields: stdlib logging with a key=value
suffix, or one JSON object a line through ``configure(json_log=True)``.
"""

from __future__ import annotations

import json
import logging
import sys
from typing import Any

_root = logging.getLogger("tpujob")


def configure(level: int = logging.INFO, json_log: bool = False) -> None:
    handler = logging.StreamHandler(sys.stderr)
    if json_log:
        handler.setFormatter(_JsonFormatter())
    else:
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s %(message)s")
        )
    _root.handlers[:] = [handler]
    _root.setLevel(level)


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": self.formatTime(record),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        for k, v in getattr(record, "fields", {}).items():
            out[k] = v
        return json.dumps(out)


class FieldLogger:
    def __init__(self, logger: logging.Logger, **fields: Any):
        self._logger = logger
        self._fields = fields

    def _fmt(self, msg: str) -> str:
        suffix = " ".join(f"{k}={v}" for k, v in self._fields.items())
        return f"{msg} [{suffix}]" if suffix else msg

    def debug(self, msg: str, *a: Any) -> None:
        self._logger.debug(self._fmt(msg), *a, extra={"fields": self._fields})

    def info(self, msg: str, *a: Any) -> None:
        self._logger.info(self._fmt(msg), *a, extra={"fields": self._fields})

    def warning(self, msg: str, *a: Any) -> None:
        self._logger.warning(self._fmt(msg), *a, extra={"fields": self._fields})

    def error(self, msg: str, *a: Any) -> None:
        self._logger.error(self._fmt(msg), *a, extra={"fields": self._fields})


def logger_for_job(namespace: str, name: str) -> FieldLogger:
    return FieldLogger(_root, job=f"{namespace}/{name}")


def logger_for_replica(namespace: str, job: str, rtype: str, index: int) -> FieldLogger:
    return FieldLogger(_root, job=f"{namespace}/{job}", replica=f"{rtype}-{index}")
