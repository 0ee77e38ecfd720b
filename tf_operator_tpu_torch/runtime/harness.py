"""Shared training-run plumbing (the port of
``tf_operator_tpu/runtime/harness.py``): the flags every training entry
point takes, and the train loop with its loss-decrease guard.  The loop
resolves its losses through the sync ledger (``train_sync_*``), traces
its windows, beats a ``train.<tag>`` heartbeat for the stall watchdog,
feeds the step-time sentinel (``step_time_*{signal="train_sync"}``) and
boots the pod telemetry server from the environment, as the JAX loop
does (``train_loop``'s docstring).  In a joined world every rank runs the
loop; its summary line names the rank and the world."""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch


def standard_parser(description: str, **defaults) -> argparse.ArgumentParser:
    """The flags every training entry point shares, under the JAX
    harness's names.  ``defaults`` overrides any of: steps,
    batch_per_device, learning_rate, steps_per_sync."""

    p = argparse.ArgumentParser(description=description)
    p.add_argument("--steps", type=int, default=defaults.get("steps", 30))
    p.add_argument("--batch-per-device", type=int,
                   default=defaults.get("batch_per_device", 32),
                   help="examples per step on each rank (one device a rank)")
    p.add_argument("--learning-rate", type=float,
                   default=defaults.get("learning_rate", 0.1))
    p.add_argument(
        "--steps-per-sync", type=int, default=defaults.get("steps_per_sync", 8),
        help="K: keep losses on the device and resolve them once per K "
        "steps, one window behind the dispatch.  1 = resolve every step",
    )
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p


def gather_params(trainer) -> Dict[str, torch.Tensor]:
    """The trained parameters, whole, by name.  COLLECTIVE under a mesh:
    every rank must call it (the fsdp shards are gathered into each
    rank's model); afterwards every rank holds the full weights."""

    trainer.gather()
    return {n: p.detach() for n, p in zip(trainer.names, trainer.params)}


def batch_sizes(batch_per_device: int):
    """(global, per-process) batch sizes for the joined world (one
    device a rank)."""

    from tf_operator_tpu_torch.runtime.bootstrap import world

    return batch_per_device * world()[1], max(batch_per_device, 1)


def _resolve_losses(ledger, phase: str, pending: List) -> List[float]:
    """A window's device-side losses as host floats through the sync
    ledger: stacked on the device first, so the window is one counted
    transfer."""

    if all(isinstance(t, torch.Tensor) for t in pending):
        pending = torch.stack([t.detach().float().reshape(-1) for t in pending])
    return np.asarray(ledger.resolve(phase, pending), dtype=np.float64).reshape(-1).tolist()


def train_loop(
    trainer,
    batch_or_batches,
    steps: int,
    *,
    start_step: int = 0,
    tag: str = "train",
    assert_decreasing: bool = True,
    tracer=None,
    steps_per_sync: int = 1,
    sync_ledger=None,
    watchdog=None,
    stats: Optional[Dict] = None,
) -> List[float]:
    """Run ``steps`` steps, print the summary, and (by default) fail
    with exit status 1 if the loss did not decrease over a run of 20 or
    more steps.

    ``batch_or_batches``: one batch reused every step, or an iterator of
    batches.  ``steps_per_sync`` (K): with K > 1 the losses stay on the
    device and each K-step window is resolved after the next window has
    been dispatched, so the host rides one window behind the device: one
    ``window``-phase resolve a window and one ``final`` at the end, each
    a single transfer.  K = 1 resolves every step (one ``step``-phase
    sync a step, the debugging baseline).

    Every resolve goes through ``sync_ledger`` (a
    ``utils/metrics.StepSyncLedger``; one over the default registry
    when not passed), which counts ``train_sync_total{phase}`` and times
    ``train_sync_seconds{phase}``; with an iterator, each ``data.load``
    wait is recorded there too.  If the trainer has a ``sync_ledger``,
    it is pointed at the loop's for the run.

    Traced (``tracer``, default the process tracer): one ``train <tag>``
    trace, rooted under the environment's span context
    (``runtime/telemetry.trace_context_from_env``); K = 1 keeps a
    ``step N`` span a step, K > 1 a ``steps a..b`` span a window, each
    split into ``data.load`` / ``train.step`` children, with the
    ledger's ``sync.<phase>`` spans marking the resolves.

    The loop registers a ``train.<tag>`` heartbeat on ``watchdog``
    (default: the process watchdog, utils/watchdog.py), beaten once a
    window; sets ``train_window_steps_per_second`` on the ledger's
    registry; and feeds the step-time sentinel (``utils/costplane``, on
    the ledger's registry) the window's wall a step, once a window (as
    the JAX loop does), as ``train_sync``.  The pod telemetry server boots
    when ``TPUJOB_TELEMETRY_PORT`` is set (``runtime/telemetry``).  All
    of it is host arithmetic: the window gains no sync.

    ``stats``, when given, receives ``resolved_at``: (steps resolved so
    far, host time) after each resolve, from which a caller reads the
    steady-state step time; ``sync_ledger``, ``sentinel`` and
    ``heartbeat_beats``."""

    from tf_operator_tpu_torch.runtime.telemetry import (
        maybe_start_from_env as _maybe_start_telemetry,
        trace_context_from_env,
    )
    from tf_operator_tpu_torch.utils.costplane import StepTimeSentinel, default_costplane
    from tf_operator_tpu_torch.utils.metrics import StepSyncLedger, default_metrics
    from tf_operator_tpu_torch.utils.trace import default_tracer
    from tf_operator_tpu_torch.utils.watchdog import default_watchdog

    _maybe_start_telemetry()
    env_trace_id, env_parent_id = trace_context_from_env()
    tr = tracer if tracer is not None else default_tracer
    ledger = (sync_ledger if sync_ledger is not None
              else StepSyncLedger(metrics=default_metrics, tracer=tr))
    dog = watchdog if watchdog is not None else default_watchdog
    hb = dog.register(f"train.{tag}")
    mreg = getattr(ledger, "metrics", None)
    sentinel = (StepTimeSentinel(metrics=mreg) if mreg is not None
                else default_costplane.sentinel)

    batches: Optional[Iterable[Dict]] = None
    fixed = None
    if hasattr(batch_or_batches, "__next__"):
        batches = batch_or_batches
    else:
        fixed = batch_or_batches
    k = max(1, int(steps_per_sync))
    prev_trainer_ledger = getattr(trainer, "sync_ledger", None)
    if prev_trainer_ledger is not None:
        trainer.sync_ledger = ledger

    losses: List[float] = []
    pending: List = []
    resolved_at = []
    t_prev = time.perf_counter()

    def resolve(phase: str, window: List) -> None:
        losses.extend(_resolve_losses(ledger, phase, window))
        resolved_at.append((len(losses), time.perf_counter()))

    def observe(n_steps: int) -> None:
        # the window's host wall since the previous one: the throughput
        # gauge, and one sentinel observation of its per-step wall (one
        # a window, as the JAX loop feeds it)
        nonlocal t_prev
        now_t = time.perf_counter()
        if now_t > t_prev:
            if mreg is not None:
                mreg.set("train_window_steps_per_second", n_steps / (now_t - t_prev))
            sentinel.observe("train_sync", (now_t - t_prev) / n_steps)
        t_prev = now_t

    def one_step():
        if batches is not None:
            with tr.span("data.load"):
                t_load = time.perf_counter()
                batch = next(batches)
                ledger.record("data.load", time.perf_counter() - t_load)
        else:
            batch = fixed
        with tr.span("train.step"):
            return trainer.train_step(batch)["loss"]

    try:
        with tr.span(f"train {tag}", trace_id=env_trace_id, parent_id=env_parent_id,
                     attributes={"startStep": start_step, "steps": steps,
                                 "stepsPerSync": k}):
            step = start_step
            while step < steps:
                n = min(k, steps - step)
                name = f"step {step}" if k == 1 else f"steps {step}..{step + n}"
                with tr.span(name, attributes=None if k == 1 else {"k": n}):
                    window = [one_step() for _ in range(n)]
                ledger.step(n)
                hb.beat()
                observe(n)
                step += n
                if k == 1:
                    resolve("step", window)
                    continue
                # the previous window, now that this one is queued
                if pending:
                    resolve("window", pending)
                pending = window
            if pending:
                resolve("final", pending)
    finally:
        dog.unregister(hb.name)
        if prev_trainer_ledger is not None:
            trainer.sync_ledger = prev_trainer_ledger
    if stats is not None:
        stats.update(resolved_at=resolved_at, sync_ledger=ledger, sentinel=sentinel,
                     heartbeat_beats=hb.beats)

    if losses:
        from tf_operator_tpu_torch.runtime.bootstrap import world

        rank, n = world()
        first, last = losses[0], sum(losses[-5:]) / len(losses[-5:])
        print(f"process {rank}/{n} [{tag}]: steps {start_step}..{steps} "
              f"loss {first:.4f} -> {last:.4f}", flush=True)
        if assert_decreasing and start_step == 0 and steps >= 20 and not last < first:
            print("loss did not decrease", file=sys.stderr, flush=True)
            raise SystemExit(1)
    return losses
