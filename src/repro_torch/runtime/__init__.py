"""Training runtime: fault tolerance, straggler detection, resume; ported from
``repro.runtime``.

The loop is deliberately boring: build state → restore-if-possible →
step/checkpoint/watchdog until done.

* **Crash-restart**: any exception in a step triggers restore from the newest
  committed checkpoint and replay (data is a pure function of the step index, so
  replay feeds the same batches).
* **Straggler watchdog**: steps slower than ``deadline_factor ×`` the running
  median are logged and counted; the hook is a callback.
* **Restore onto a device**: ``restore`` places the state on the given device.
* **Placed state**: with ``place`` (a mesh's placements, from
  ``repro_torch.distributed.place``) the fresh state is placed before the step sees
  it, and so is the restore target, so a restored state comes back as this rank's
  shards at the same placements (each rank checkpoints its own shards).

``float(loss)`` waits for the step's device work once per step, as the
reference's ``jax.device_get(loss)`` does.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager

__all__ = ["TrainLoopConfig", "StragglerWatchdog", "train_loop", "TrainResult"]


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 25
    checkpoint_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    )
    keep: int = 3
    log_every: int = 10
    max_restarts: int = 3
    deadline_factor: float = 5.0  # straggler threshold × median step time


class StragglerWatchdog:
    """Flags steps slower than ``factor ×`` the running median."""

    def __init__(self, factor: float = 5.0, warmup: int = 5) -> None:
        self.factor = factor
        self.warmup = warmup
        self.times: list[float] = []
        self.flagged: list[tuple[int, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        slow = False
        if len(self.times) >= self.warmup:
            med = float(np.median(self.times[-50:]))
            if dt > self.factor * med:
                self.flagged.append((step, dt))
                slow = True
        self.times.append(dt)
        return slow


@dataclasses.dataclass
class TrainResult:
    final_step: int
    losses: list[float]
    restarts: int
    straggler_events: list[tuple[int, float]]
    state: Any


def train_loop(
    cfg: TrainLoopConfig,
    step_fn: Callable[[Any, Any], tuple[Any, dict]],
    init_state: Callable[[], Any],
    batch_fn: Callable[[int], Any],
    *,
    device: str | torch.device | None = None,
    on_step: Callable[[int, dict], None] | None = None,
    fault_injector: Callable[[int], None] | None = None,
    place: Callable[[Any], Any] | None = None,
) -> TrainResult:
    """Run the fault-tolerant loop.

    ``step_fn(state, batch) -> (state, metrics)``; ``init_state()`` builds fresh
    state; ``batch_fn(step)`` is the pure data function; ``fault_injector(step)``
    may raise to simulate crashes.  A restored state goes to ``device``, or to the
    devices of the fresh state's leaves; ``place(state)`` places a fresh state
    (and with it the restore target) on a mesh.
    """
    mgr = CheckpointManager(cfg.checkpoint_dir, keep=cfg.keep)
    watchdog = StragglerWatchdog(cfg.deadline_factor)
    losses: list[float] = []
    restarts = 0

    def start_or_resume():
        state = init_state()
        if place is not None:
            state = place(state)
        if mgr.has_checkpoint():
            step, state = mgr.restore_latest(state, device)
            return step + 1, state
        return 0, state

    step, state = start_or_resume()
    while step < cfg.total_steps:
        try:
            if fault_injector is not None:
                fault_injector(step)
            t0 = time.monotonic()
            state, metrics = step_fn(state, batch_fn(step))
            loss = metrics.get("loss")
            if loss is not None:
                loss = float(loss)
                if not np.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at step {step}: {loss}")
                losses.append(loss)
            watchdog.observe(step, time.monotonic() - t0)
            if on_step is not None:
                on_step(step, metrics)
            if cfg.checkpoint_every and (step + 1) % cfg.checkpoint_every == 0:
                mgr.save(step, state)
            step += 1
        except KeyboardInterrupt:  # pragma: no cover
            raise
        except Exception:
            restarts += 1
            if restarts > cfg.max_restarts:
                raise
            step, state = start_or_resume()
    mgr.save(step - 1, state, blocking=True)
    return TrainResult(step, losses, restarts, watchdog.flagged, state)
