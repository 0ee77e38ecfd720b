"""Shared training-run plumbing (the port of
``tf_operator_tpu/runtime/harness.py``): the flags every training entry
point takes, and the train loop with its loss-decrease guard.
Telemetry, the watchdog and trace spans wait for the metrics slice."""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, Iterable, List, Optional

import torch


def standard_parser(description: str, **defaults) -> argparse.ArgumentParser:
    """The flags every training entry point shares, under the JAX
    harness's names.  ``defaults`` overrides any of: steps,
    batch_per_device, learning_rate, steps_per_sync."""

    p = argparse.ArgumentParser(description=description)
    p.add_argument("--steps", type=int, default=defaults.get("steps", 30))
    p.add_argument("--batch-per-device", type=int,
                   default=defaults.get("batch_per_device", 32),
                   help="examples per step (one device, so the whole batch)")
    p.add_argument("--learning-rate", type=float,
                   default=defaults.get("learning_rate", 0.1))
    p.add_argument(
        "--steps-per-sync", type=int, default=defaults.get("steps_per_sync", 8),
        help="K: keep losses on the device and resolve them once per K "
        "steps, one window behind the dispatch.  1 = resolve every step",
    )
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p


def _resolve(pending: List[torch.Tensor]) -> List[float]:
    """A window's device-side losses as host floats: one transfer."""

    return torch.stack([t.float() for t in pending]).cpu().tolist()


def train_loop(
    trainer,
    batch_or_batches,
    steps: int,
    *,
    start_step: int = 0,
    tag: str = "train",
    assert_decreasing: bool = True,
    steps_per_sync: int = 1,
    stats: Optional[Dict] = None,
) -> List[float]:
    """Run ``steps`` steps, print the summary, and (by default) fail
    with exit status 1 if the loss did not decrease over a run of 20 or
    more steps.

    ``batch_or_batches``: one batch reused every step, or an iterator of
    batches.  With ``steps_per_sync`` K > 1 the losses stay on the
    device and each K-step window is resolved after the next window has
    been dispatched, so the host rides one window behind the device.
    ``stats``, when given, receives ``resolved_at``: (steps resolved so
    far, host time) after each resolve, from which a caller reads the
    steady-state step time."""

    batches: Optional[Iterable[Dict]] = None
    fixed = None
    if hasattr(batch_or_batches, "__next__"):
        batches = batch_or_batches
    else:
        fixed = batch_or_batches
    k = max(1, int(steps_per_sync))
    losses: List[float] = []
    pending: List[torch.Tensor] = []
    resolved_at = []

    def resolve(window):
        losses.extend(_resolve(window))
        resolved_at.append((len(losses), time.perf_counter()))

    step = start_step
    while step < steps:
        n = min(k, steps - step)
        window = []
        for _ in range(n):
            batch = next(batches) if batches is not None else fixed
            window.append(trainer.train_step(batch)["loss"])
        if pending:
            resolve(pending)
        pending = window
        step += n
    if pending:
        resolve(pending)
    if stats is not None:
        stats["resolved_at"] = resolved_at

    if losses:
        first, last = losses[0], sum(losses[-5:]) / len(losses[-5:])
        print(f"process 0/1 [{tag}]: steps {start_step}..{steps} "
              f"loss {first:.4f} -> {last:.4f}", flush=True)
        if assert_decreasing and start_step == 0 and steps >= 20 and not last < first:
            print("loss did not decrease", file=sys.stderr, flush=True)
            raise SystemExit(1)
    return losses
