"""Fault tolerance & straggler mitigation for the training loop (the
port's copy of `repro.runtime.fault`, pure Python).

`ResilientLoop` wraps a step function with:
  * checkpoint/restart — on any step failure the loop restores the latest
    committed checkpoint and replays from there (bounded retries);
  * failure injection — tests/chaos drills raise at a chosen step via
    `inject_failure_at`;
  * straggler detection — per-step wall-time EMA; a step slower than
    `straggler_factor` x EMA is flagged; `straggler_patience` consecutive
    flags fire the mitigation callback (with several hosts: exclude the
    slow one and resume on the reduced set).

One step is one call of `step_fn`; a failure loses at most
(step - last_ckpt) steps.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional


class InjectedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class LoopReport:
    steps_run: int = 0
    failures: int = 0
    restores: int = 0
    straggler_events: int = 0
    remesh_events: int = 0
    losses: list = dataclasses.field(default_factory=list)


class ResilientLoop:
    def __init__(
        self,
        # (state, step) -> (state, metrics)
        step_fn: Callable[[Any, int], tuple],
        save_fn: Callable[[Any, int], None],
        restore_fn: Callable[[], tuple],        # () -> (state, step)
        *,
        ckpt_every: int = 50,
        max_failures: int = 3,
        straggler_factor: float = 3.0,
        straggler_patience: int = 3,
        on_straggler: Optional[Callable[[], None]] = None,
        inject_failure_at: Optional[int] = None,
    ):
        self.step_fn = step_fn
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.ckpt_every = ckpt_every
        self.max_failures = max_failures
        self.straggler_factor = straggler_factor
        self.straggler_patience = straggler_patience
        self.on_straggler = on_straggler
        self.inject_failure_at = inject_failure_at
        self.report = LoopReport()

    def run(self, state, start_step: int, num_steps: int):
        step = start_step
        failures = 0
        ema = None
        slow_streak = 0
        injected = False
        r = self.report

        while step < start_step + num_steps:
            try:
                if (self.inject_failure_at is not None
                        and step == self.inject_failure_at and not injected):
                    injected = True
                    raise InjectedFailure(f"injected failure at step {step}")

                t0 = time.monotonic()
                state, metrics = self.step_fn(state, step)
                dt = time.monotonic() - t0

                # straggler tracking
                if ema is None:
                    ema = dt
                elif dt > self.straggler_factor * ema:
                    slow_streak += 1
                    r.straggler_events += 1
                    if (slow_streak >= self.straggler_patience
                            and self.on_straggler is not None):
                        self.on_straggler()
                        r.remesh_events += 1
                        slow_streak = 0
                else:
                    slow_streak = 0
                    ema = 0.9 * ema + 0.1 * dt

                if "loss" in metrics:
                    r.losses.append(float(metrics["loss"]))
                step += 1
                r.steps_run += 1
                if step % self.ckpt_every == 0:
                    self.save_fn(state, step)
            except Exception as e:  # noqa: BLE001 — any step failure
                failures += 1
                r.failures += 1
                if failures > self.max_failures:
                    raise RuntimeError(
                        f"exceeded {self.max_failures} failures") from e
                state, step = self.restore_fn()
                r.restores += 1
        return state, step
