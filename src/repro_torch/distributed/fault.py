"""Fault tolerance and elasticity, as :mod:`repro.distributed.fault`.

* **step-level resilience**: :func:`run_resilient` wraps a training
  loop with checkpoint/restart: a step that raises (device loss,
  preemption, an injected fault) rolls back to the last checkpoint and
  replays; the deterministic data streams (:mod:`repro_torch.data.
  synthetic` is a pure function of its key) make the replay exact.
* **cluster-level elasticity**: :func:`remesh` rebuilds the
  ("data", "model") mesh from the ranks now in the group; a checkpoint
  restores onto any mesh width (:mod:`repro_torch.checkpoint`).
* **the failure injector** the drills and the fleet controller use.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

from repro_torch.checkpoint import checkpoint as CKPT
from repro_torch.distributed.mesh import make_local_mesh


@dataclasses.dataclass
class FaultInjector:
    """Deterministic fault schedule for tests and drills: raises on the
    configured step numbers (once each)."""
    fail_at: tuple[int, ...] = ()
    _fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at and step not in self._fired:
            self._fired.add(step)
            raise RuntimeError(f"injected fault at step {step}")


def remesh(model_parallel: int = 1):
    """The elastic mesh of the ranks now in the default group: the same
    function as :func:`repro_torch.distributed.mesh.make_local_mesh`, as
    in the reference (a ``model_parallel`` that does not divide the world
    falls back to 1)."""
    return make_local_mesh(model_parallel)


def backoff_s(attempt: int, base: float = 0.05, cap: float = 1.0) -> float:
    """Bounded exponential backoff: base·2^(attempt-1), capped.  Shared
    by :func:`run_resilient` and the fleet controller's retry loop."""
    return min(cap, base * (2.0 ** max(attempt - 1, 0)))


@dataclasses.dataclass
class RestartTelemetry:
    """What the resilience loop did: how often it restarted, where it
    resumed from, and how long it backed off in total."""
    restarts: int = 0
    from_checkpoint: int = 0
    from_start: int = 0
    backoff_total_s: float = 0.0
    resumed_at: list = dataclasses.field(default_factory=list)


def run_resilient(step_fn: Callable, state, batch_fn: Callable,
                  n_steps: int, ckpt_dir: str, ckpt_every: int = 10,
                  injector: FaultInjector | None = None,
                  max_retries: int = 5, start_step: int = 0,
                  backoff_base_s: float = 0.05, backoff_cap_s: float = 1.0,
                  sleep: Callable = time.sleep):
    """Run ``n_steps`` of ``state, metrics = step_fn(state, batch)`` with
    checkpoint/replay on failure.

    ``batch_fn(step) -> batch`` must be deterministic in ``step``.  On a
    failure the loop backs off (``backoff_s(attempt, backoff_base_s,
    backoff_cap_s)``) and resumes from the latest checkpoint, or, before
    the first one, from the initial ``(state, start_step)``.  Returns
    ``(state, last_metrics, RestartTelemetry)``.
    """
    step = start_step
    state0 = state                   # replay anchor before any checkpoint
    if CKPT.latest_step(ckpt_dir) is not None:
        state, step = CKPT.restore(ckpt_dir, state)
    tel = RestartTelemetry()
    metrics = {}
    while step < n_steps:
        try:
            if injector is not None:
                injector.check(step)
            state, metrics = step_fn(state, batch_fn(step))
            step += 1
            if step % ckpt_every == 0:
                CKPT.save(ckpt_dir, step, state)
        except Exception:
            tel.restarts += 1
            if tel.restarts > max_retries:
                raise
            wait = backoff_s(tel.restarts, backoff_base_s, backoff_cap_s)
            tel.backoff_total_s += wait
            sleep(wait)
            if CKPT.latest_step(ckpt_dir) is not None:
                state, step = CKPT.restore(ckpt_dir, state)
                tel.from_checkpoint += 1
            else:
                state, step = state0, start_step
                tel.from_start += 1
            tel.resumed_at.append(step)
    CKPT.save(ckpt_dir, step, state)
    return state, metrics, tel
