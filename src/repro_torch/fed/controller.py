"""Event-driven elastic fleet controller for the buffered-async round,
as :mod:`repro.fed.controller`.

A simulated-time event loop (a heap of client completion times) drives
an :class:`repro_torch.fed.async_engine.AsyncReplayServer`:

* **admit**: a device joins mid-round with its cut plan
  (:mod:`repro_torch.fed.cutplan`), is dispatched from the current
  global snapshot, and the mesh hook ``remesh_fn`` runs;
* **drop**: a device leaves; its in-flight result is discarded when it
  surfaces;
* **faults**: a :class:`repro_torch.distributed.fault.FaultInjector`
  raises inside a client's local round; the controller retries with
  :func:`repro_torch.distributed.fault.backoff_s` and drops the client
  after ``max_retries``.

Each dispatch records the global version the client pulled, so a client
that completes after the buffer has flushed arrives with staleness
``tau > 0``.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Callable

from repro_torch.distributed import fault as F
from repro_torch.fed.async_engine import AsyncReplayServer
from repro_torch.fed.cutplan import CutPlan, DeviceProfile


@dataclasses.dataclass
class FleetClient:
    cid: int
    profile: DeviceProfile
    cut: int
    duration_s: float          # cutplan's per-round estimate
    base_version: int = 0      # global version at last dispatch
    active: bool = True
    rounds_done: int = 0


@dataclasses.dataclass
class FleetTelemetry:
    admitted: int = 0
    dropped: int = 0
    completed: int = 0
    discarded: int = 0         # in-flight results of dropped clients
    restarts: int = 0
    backoff_total_s: float = 0.0
    remeshes: int = 0


class FleetController:
    """Drives ``local_fn`` per completion event and feeds the server.

    ``local_fn(global_params, cid, round_idx, base_version) -> (token,
    coeffs, mask)`` runs one client's local round from the given global
    snapshot; it must be a pure function of its arguments, so a retry
    after a fault replays exactly.
    """

    def __init__(self, server: AsyncReplayServer, local_fn: Callable, *,
                 injector: F.FaultInjector | None = None,
                 max_retries: int = 3, backoff_base_s: float = 0.05,
                 backoff_cap_s: float = 1.0, sleep: Callable = time.sleep,
                 remesh_fn: Callable | None = None):
        self.server = server
        self.local_fn = local_fn
        self.injector = injector
        self.max_retries = max_retries
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.sleep = sleep
        self.remesh_fn = remesh_fn
        self.mesh = None
        self.clients: dict[int, FleetClient] = {}
        self.now = 0.0
        self.telemetry = FleetTelemetry()
        self._heap: list = []          # (t_done, seq, cid)
        self._seq = 0
        self._events = 0

    @property
    def n_active(self) -> int:
        return sum(c.active for c in self.clients.values())

    def _remesh(self):
        self.telemetry.remeshes += 1
        if self.remesh_fn is not None:
            self.mesh = self.remesh_fn(max(self.n_active, 1))

    def admit(self, profile: DeviceProfile, plan: CutPlan,
              t: float | None = None) -> int:
        """Admit a device with its cut plan and dispatch it from the
        current global snapshot."""
        cid = len(self.clients)
        c = FleetClient(cid, profile, plan.cut, plan.round_s)
        self.clients[cid] = c
        self.telemetry.admitted += 1
        self._dispatch(c, self.now if t is None else t)
        self._remesh()
        return cid

    def drop(self, cid: int):
        if self.clients[cid].active:
            self.clients[cid].active = False
            self.telemetry.dropped += 1
            self._remesh()

    def _dispatch(self, c: FleetClient, t_now: float):
        c.base_version = self.server.version
        heapq.heappush(self._heap, (t_now + c.duration_s, self._seq,
                                    c.cid))
        self._seq += 1

    def run(self, n_completions: int, redispatch: bool = True) -> int:
        """Process completion events until ``n_completions`` client
        rounds are incorporated (or the heap drains).  Returns how many
        were."""
        done = 0
        while done < n_completions and self._heap:
            t, _, cid = heapq.heappop(self._heap)
            self.now = max(self.now, t)
            c = self.clients[cid]
            if not c.active:
                self.telemetry.discarded += 1
                continue
            event = self._events
            self._events += 1
            result = self._attempt(c, event)
            if result is None:             # gave up: client was dropped
                continue
            token, coeffs, mask = result
            self.server.submit(c.cid, token, coeffs,
                               base_version=c.base_version, mask=mask,
                               t_done=t)
            c.rounds_done += 1
            done += 1
            self.telemetry.completed += 1
            if redispatch:
                self._dispatch(c, t)
        return done

    def _attempt(self, c: FleetClient, event: int):
        """One client round under ``run_resilient``'s rules: retry the
        (pure) local trajectory with bounded exponential backoff."""
        attempt = 0
        while True:
            try:
                if self.injector is not None:
                    self.injector.check(event)
                return self.local_fn(self.server.params, c.cid,
                                     c.rounds_done, c.base_version)
            except Exception:
                attempt += 1
                self.telemetry.restarts += 1
                if attempt > self.max_retries:
                    self.drop(c.cid)
                    return None
                wait = F.backoff_s(attempt, self.backoff_base_s,
                                   self.backoff_cap_s)
                self.telemetry.backoff_total_s += wait
                self.sleep(wait)
