"""Deterministic fault injection at the ``Backend`` protocol seams —
PyTorch port of ``repro.serving.faults``.

* ``FaultPlan`` — a seeded schedule mapping each injection seam to the
  exact call indices that fail. Two runs with the same seed fail at the
  same points, so chaos scenarios are ordinary deterministic tests.
* ``FaultyBackend`` — a transparent wrapper over any real ``Backend``
  that consults the plan at each seam and otherwise delegates. Faults are
  raised BEFORE the inner call, so an injected failure never leaves
  half-written device state.

==============  =====================  =================================
seam            raises                 engine path exercised
==============  =====================  =================================
``alloc``       ``PoolExhausted``      pool-pressure preemption
``page_in``     ``PoolExhausted``      ``plan_page_in`` rollback (lazily,
                                       from the returned allocator)
``swap_corrupt``  ``FaultInjected``    swap-in teardown + bounded
                (at ``upload_park``)   retry-with-recompute
``dispatch``    ``FaultInjected``      per-request quarantine of a
                                       prefill chunk/wave
``decode``      ``FaultInjected``      decode-batch recompute retry
``stall``       (sleeps ``stall_s``)   slow-tick tolerance
``transfer``    ``FaultInjected``      disaggregated KV handoff loss
                (at ``KVTransfer``)    (decode-side recompute)
==============  =====================  =================================

``dense_prefill`` is kept in ``SEAMS`` for plans written against the
reference; the dense slot engine that consults it is not ported yet
(ROADMAP §1). ``transfer`` is consulted by ``serving.disagg.KVTransfer``
directly, outside any ``FaultyBackend``.
"""

from __future__ import annotations

import random
import time
from typing import Iterable, Optional

from repro_torch.kvcache.pool import PoolExhausted

SEAMS = ("alloc", "page_in", "swap_corrupt", "dispatch", "decode",
         "stall", "dense_prefill", "transfer")


class FaultInjected(RuntimeError):
    """An injected backend failure (never raised by real device code).
    ``is_injected`` lets observability tell scheduled chaos from a real
    device error without string matching."""

    is_injected = True


class FaultPlan:
    """Deterministic per-seam schedule of failing call indices.

    ``fire(seam)`` counts every call through the seam and returns True
    exactly on the scheduled indices; ``injected`` logs what fired."""

    def __init__(self, schedule: Optional[dict] = None, *,
                 stall_s: float = 0.0):
        self.schedule: dict[str, set[int]] = {
            k: set(v) for k, v in (schedule or {}).items()}
        unknown = set(self.schedule) - set(SEAMS)
        if unknown:
            raise ValueError(f"unknown fault seams {sorted(unknown)}: "
                             f"choose from {SEAMS}")
        self.stall_s = stall_s
        self.calls: dict[str, int] = {}
        self.injected: list[tuple[str, int]] = []

    @classmethod
    def seeded(cls, seed: int, *, alloc: int = 0, page_in: int = 0,
               swap_corrupt: int = 0, dispatch: int = 0, decode: int = 0,
               stall: int = 0, dense_prefill: int = 0, transfer: int = 0,
               window: int = 40,
               stall_s: float = 0.002) -> "FaultPlan":
        """Schedule ``n`` failures per seam at seed-determined call
        indices inside ``[1, window)`` (index 0 is never scheduled)."""
        rng = random.Random(seed)
        counts = {"alloc": alloc, "page_in": page_in,
                  "swap_corrupt": swap_corrupt, "dispatch": dispatch,
                  "decode": decode, "stall": stall,
                  "dense_prefill": dense_prefill, "transfer": transfer}
        schedule = {}
        for seam, n in counts.items():
            if n > 0:
                schedule[seam] = set(rng.sample(range(1, window),
                                                min(n, window - 1)))
        return cls(schedule, stall_s=stall_s)

    def fire(self, seam: str) -> bool:
        i = self.calls.get(seam, 0)
        self.calls[seam] = i + 1
        if i in self.schedule.get(seam, ()):
            self.injected.append((seam, i))
            return True
        return False

    def fired(self, seams: Optional[Iterable[str]] = None) -> int:
        """Injections that actually happened (optionally per seam set)."""
        if seams is None:
            return len(self.injected)
        seams = set(seams)
        return sum(1 for s, _ in self.injected if s in seams)


_OWN_ATTRS = frozenset({"inner", "plan"})


class FaultyBackend:
    """Transparent ``Backend`` wrapper injecting a ``FaultPlan``.

    Every other attribute delegates to the wrapped backend, writes
    included, so the wrapper can be installed after the engine is built:
    ``engine.backend = FaultyBackend(engine.backend, plan)``."""

    def __init__(self, inner, plan: FaultPlan):
        object.__setattr__(self, "inner", inner)
        object.__setattr__(self, "plan", plan)

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __setattr__(self, name, value):
        if name in _OWN_ATTRS:
            object.__setattr__(self, name, value)
        else:
            setattr(self.inner, name, value)

    # -- injection seams -----------------------------------------------------

    def alloc_chunk(self, pf, start_page: int, n_need: int):
        if self.plan.fire("alloc"):
            raise PoolExhausted("injected: pool exhausted")
        return self.inner.alloc_chunk(pf, start_page, n_need)

    def dispatch_chunk(self, *args, **kwargs):
        if self.plan.fire("dispatch"):
            raise FaultInjected("injected: chunk dispatch failed")
        return self.inner.dispatch_chunk(*args, **kwargs)

    def dispatch_wave(self, *args, **kwargs):
        if self.plan.fire("dispatch"):
            raise FaultInjected("injected: wave dispatch failed")
        return self.inner.dispatch_wave(*args, **kwargs)

    def decode_step(self, slots, tables, lengths):
        if self.plan.stall_s > 0 and self.plan.fire("stall"):
            time.sleep(self.plan.stall_s)
        if self.plan.fire("decode"):
            raise FaultInjected("injected: decode dispatch failed")
        return self.inner.decode_step(slots, tables, lengths)

    def page_in_extend(self, park_js):
        extend = self.inner.page_in_extend(park_js)
        if not self.plan.fire("page_in"):
            return extend
        state = {"failed": False}

        def failing(j: int) -> int:
            # fail once, lazily, like a real mid-plan allocation miss:
            # plan_page_in rolls back and the swap-in retries next tick
            if not state["failed"]:
                state["failed"] = True
                raise PoolExhausted("injected: page-in allocation failed")
            return extend(j)
        return failing

    def upload_park(self, rows, uploads) -> None:
        if self.plan.fire("swap_corrupt"):
            raise FaultInjected("injected: swap payload corrupt")
        return self.inner.upload_park(rows, uploads)
