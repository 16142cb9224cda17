"""Buffered-async Fed-Server over the lean seed-replay uplink, as
:mod:`repro.fed.async_engine`.

A HERON client's whole round update is a ``(seed, coeffs)`` token, so
the server can apply updates as they arrive:

* arrivals are buffered and the global snapshots forward every ``K``
  arrivals (FedBuff-style; ``buffer_k=0`` = one barrier flush at round
  end, which is the synchronous aggregation bit for bit);
* each entry is scaled by ``w(tau) = (1+tau)^(-alpha)``, ``tau`` the
  global snapshots taken since the client pulled its base model;
* the weight is folded into the per-entry scales of the flattened
  (client, step, pair) stream (:func:`repro_torch.core.aggregate.
  replay_token_stream`), which one walk applies
  (:func:`repro_torch.core.aggregate.replay_apply`: a K1 accumulate
  launch per entry on the kernel stream, a threefry direction per entry
  otherwise).

A single flush holding the full cohort with every weight exactly 1.0
gives the tokens and scales of :func:`repro_torch.core.aggregate.
seed_replay_aggregate` byte for byte, hence the same new global.  The
staleness weights live in the scales, so the replay's ``shard`` /
``mesh`` modes (and its ``chunk``, which changes nothing) compose
unchanged.  ``shardings`` (the datacenter step's placements of the
global params, when the server holds this rank's slabs of them) replays
each direction's slabs: the threefry draws of the slabs' global
counters (the reference pins the draw to the placement) and the kernel
stream's K1 segments of the slabs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core import aggregate as AG
from repro_torch.core import zo as Z


@dataclasses.dataclass(frozen=True)
class StalenessConfig:
    """``w(tau) = (1+tau)^(-alpha)``; ``alpha=0`` keeps every weight at
    exactly 1.0 (the bit-exact synchronous limit)."""
    alpha: float = 0.0

    def weight(self, tau) -> float:
        return staleness_weight(tau, self.alpha)


def staleness_weight(tau, alpha: float) -> float:
    """Polynomial staleness decay, exactly 1.0 at ``tau == 0`` or
    ``alpha == 0``."""
    if alpha == 0.0 or tau == 0:
        return 1.0
    return float((1.0 + float(tau)) ** (-float(alpha)))


@dataclasses.dataclass
class AsyncTelemetry:
    arrivals: int = 0
    flushes: int = 0
    dropped: int = 0            # zero-weight (masked-out) arrivals
    staleness_sum: float = 0.0
    flush_times: list = dataclasses.field(default_factory=list)
    flush_sizes: list = dataclasses.field(default_factory=list)

    @property
    def mean_staleness(self) -> float:
        return self.staleness_sum / max(self.arrivals, 1)


@dataclasses.dataclass
class _Arrival:
    cid: int
    token: Any              # (2,) key words, or an int32 seed (kernel)
    coeffs: Any             # (h, n_pairs)
    mask: float
    base_version: int
    t_done: float


class AsyncReplayServer:
    """Applies seed-replay arrivals to the global client params.

    ``global_params``: the Fed-Server's client-side global tree;
    ``client_lr``: the replayed plain-SGD local rate; ``zo``: the
    threefry stream's :class:`repro_torch.core.zo.ZOConfig` (unused with
    ``kernel=True``, the int32 hash-seed stream, whose seeded leaves
    ``seed_pred`` selects); ``buffer_k``: snapshot every ``buffer_k``
    buffered arrivals, ``0`` = only on an explicit :meth:`flush`;
    ``on_flush(cids, t)``: called after each snapshot with the flushed
    client ids (in client-id order) and the flush's simulated time;
    ``shard`` / ``mesh`` / ``chunk``: each flush's replay mode
    (:func:`repro_torch.core.aggregate.replay_apply`); ``shardings``:
    the placements of ``global_params``' slabs.
    """

    def __init__(self, global_params, client_lr: float,
                 zo: Z.ZOConfig | None = None, *, kernel: bool = False,
                 staleness: StalenessConfig = StalenessConfig(),
                 buffer_k: int = 0, shard: str = "none", mesh=None,
                 chunk=None, shardings=None, seed_pred=None,
                 on_flush: Callable | None = None):
        if not kernel and zo is None:
            raise ValueError("threefry replay needs a ZOConfig")
        self.params = global_params
        self.client_lr = client_lr
        self.zo = zo
        self.kernel = kernel
        self.seed_pred = seed_pred
        self._mode = dict(shard=shard, mesh=mesh, chunk=chunk,
                          shardings=shardings)
        self.staleness = staleness
        self.buffer_k = int(buffer_k)
        self.on_flush = on_flush
        self.version = 0
        self._buf: list[_Arrival] = []
        self.telemetry = AsyncTelemetry()

    @property
    def pending(self) -> int:
        return len(self._buf)

    def submit(self, cid: int, token, coeffs, base_version: int | None = None,
               mask: float = 1.0, t_done: float = 0.0) -> int:
        """Buffer one client's round token: ``token`` the (2,) key words
        (threefry) or the int32 seed (kernel), ``coeffs`` its (h,
        n_pairs) coefficients, ``base_version`` the global version it
        trained from (default: the current one, no staleness), ``mask``
        its participation weight (0.0: buffered, an exact no-op).
        Returns the current global version."""
        if base_version is None:
            base_version = self.version
        self._buf.append(_Arrival(int(cid), token, coeffs, float(mask),
                                  int(base_version), float(t_done)))
        self.telemetry.arrivals += 1
        if float(mask) == 0.0:
            self.telemetry.dropped += 1
        if self.buffer_k and len(self._buf) >= self.buffer_k:
            self.flush()
        return self.version

    def flush(self) -> list[int]:
        """Snapshot a new global from the buffered arrivals, in client-id
        order; staleness ``version - base_version`` at flush time.
        Returns the flushed client ids."""
        if not self._buf:
            return []
        entries = sorted(self._buf, key=lambda e: e.cid)
        self._buf = []
        taus = [self.version - e.base_version for e in entries]
        coeffs = torch.stack([torch.as_tensor(e.coeffs) for e in entries])
        masks = torch.tensor([e.mask for e in entries], dtype=torch.float32,
                             device=coeffs.device)
        weights = torch.tensor([self.staleness.weight(t) for t in taus],
                               dtype=torch.float32,
                               device=coeffs.device) * masks
        tot = torch.clamp(torch.sum(masks), min=1.0)
        tokens, scales = AG.replay_token_stream(
            [e.token for e in entries], coeffs, self.client_lr, weights,
            tot, kernel=self.kernel)
        with torch.no_grad():
            self.params = AG.replay_apply(
                self.params, tokens, scales, kernel=self.kernel, zo=self.zo,
                seed_pred=self.seed_pred, **self._mode)
        self.version += 1
        t = max(e.t_done for e in entries)
        tel = self.telemetry
        tel.flushes += 1
        tel.staleness_sum += float(sum(taus))
        tel.flush_times.append(t)
        tel.flush_sizes.append(len(entries))
        cids = [e.cid for e in entries]
        if self.on_flush is not None:
            self.on_flush(cids, t)
        return cids
