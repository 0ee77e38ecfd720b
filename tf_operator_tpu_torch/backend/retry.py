"""The fabric's pull policy (a copy of ``RetryPolicy`` and
``fabric_pull_policy`` from ``tf_operator_tpu/backend/retry.py``).

Exponential backoff with full jitter: attempt ``n`` sleeps ``uniform(0,
min(base * 2**n, max_delay))``.  429/500/502/503/504 responses and
network errors (connection refused or reset, a half-closed socket) are
retried; any other status is an answer and re-raises at once.  A
retryable 429/503 with ``Retry-After`` floors the next sleep at that
value (capped).  ``max_attempts`` bounds the tries and ``deadline`` the
wall a call spends before it dispatches another attempt.  With a
``metrics`` registry each retry, error and give-up counts in
``api_client_{retries,errors,giveups}_total{client}`` and the last error
stamps ``api_client_last_error_unixtime{client}``.  The reference's
circuit breaker and status-returning clients are left out: the fabric
calls neither.
"""

from __future__ import annotations

import http.client
import random
import time
from typing import Callable, Optional

from tf_operator_tpu_torch.utils.trace import current_trace_id

#: statuses safe to retry
RETRYABLE_STATUS = (429, 500, 502, 503, 504)

#: transport-level failures: the request may never have been processed
NETWORK_ERRORS = (OSError, http.client.HTTPException)


class RetryPolicy:
    """Exponential-backoff-with-full-jitter retry around one callable.
    Shareable across threads; ``sleep``, ``rng`` and ``clock`` are
    injectable so that tests run deterministic and instant."""

    def __init__(
        self,
        max_attempts: int = 5,
        base_delay: float = 0.05,
        max_delay: float = 2.0,
        deadline: Optional[float] = 15.0,
        retry_status=RETRYABLE_STATUS,
        retry_after_cap: float = 5.0,
        rng: Optional[random.Random] = None,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.max_attempts = max(1, int(max_attempts))
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.deadline = None if deadline is None else float(deadline)
        self.retry_status = frozenset(retry_status)
        self.retry_after_cap = float(retry_after_cap)
        self._rng = rng or random.Random()
        self._sleep = sleep
        self._clock = clock

    def classify(self, exc: BaseException):
        """(retryable, retry_after_floor) for a raised attempt, read off
        its ``.status`` / ``.retry_after`` where it has them."""

        status = getattr(exc, "status", None)
        if isinstance(status, int):
            if status in self.retry_status:
                ra = getattr(exc, "retry_after", None)
                return True, (float(ra) if ra is not None else None)
            return False, None
        if isinstance(exc, NETWORK_ERRORS):
            return True, None
        return False, None

    def backoff(self, attempt: int) -> float:
        """Full-jitter delay for the 0-based attempt number."""

        cap = min(self.base_delay * (2.0 ** attempt), self.max_delay)
        return self._rng.uniform(0.0, cap)

    def call(self, fn: Callable[[], object], *, client: str = "api", metrics=None):
        """Run ``fn`` under this policy; on give-up the last exception
        re-raises unchanged."""

        start = self._clock()
        attempt = 0
        while True:
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 - classified below
                retryable, retry_after = self.classify(e)
                if not retryable:
                    raise
                if metrics is not None:
                    metrics.inc("api_client_errors_total", exemplar=current_trace_id(),
                                client=client, error=type(e).__name__)
                    metrics.set("api_client_last_error_unixtime", time.time(), client=client)
                if not self._schedule(start, attempt, retry_after, client, metrics):
                    raise
                attempt += 1

    def _schedule(self, start, attempt, retry_after, client, metrics) -> bool:
        """Sleep before the next attempt; False = budget exhausted."""

        if attempt + 1 >= self.max_attempts:
            if metrics is not None:
                metrics.inc("api_client_giveups_total", exemplar=current_trace_id(),
                            client=client)
            return False
        delay = self.backoff(attempt)
        if retry_after is not None:
            delay = max(delay, min(retry_after, self.retry_after_cap))
        if self.deadline is not None and (self._clock() - start) + delay > self.deadline:
            if metrics is not None:
                metrics.inc("api_client_giveups_total", exemplar=current_trace_id(),
                            client=client)
            return False
        if metrics is not None:
            metrics.inc("api_client_retries_total", client=client)
        self._sleep(delay)
        return True


#: a tight budget for the serving plane's fabric pulls: admission blocks
#: on the pull and a recompute is always the fallback, so a flaky peer
#: gets a couple of quick chances
FABRIC_PULL_POLICY_ARGS = dict(max_attempts=3, base_delay=0.02, max_delay=0.2, deadline=2.0)


def fabric_pull_policy(**overrides) -> RetryPolicy:
    args = dict(FABRIC_PULL_POLICY_ARGS)
    args.update(overrides)
    return RetryPolicy(**args)
