"""MRCA — Mesh-friendly Ring Communication Algorithm (paper Alg. 1,
Fig. 15): the port's copy of ``repro.core.mrca`` (pure Python).

DRAttention needs a logical ring of Q-chunks, but a physical 2D-mesh NoC has
no wrap-around links. MRCA realizes the ring with two mechanisms:

  * progress wave  — chunks spread outward: CU i forwards chunk (i-t+1)
    upward and chunk (i+t-1) downward each step (lines 4-9);
  * reflux tide    — after step floor(N/2), chunks are replicated locally
    once (line 11) and then flow back so every CU sees every chunk exactly
    once in N steps (lines 10-19), never storing more than 2 chunks.

The port's spatial engine keeps every shard on one device and merges the
partial states over a leading shard axis, so MRCA is, as in the
reference, the schedule generator + simulator that costs the exchange on
a mesh fabric (``spatial.topology.ShardTopology.exchange_cost``).
Indices here are 0-based (the paper is 1-based).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Send:
    src: int
    dest: int
    chunk: int


def mrca_schedule(n: int) -> list[list[Send]]:
    """Alg. 1 for a 1-D mesh of n CUs: per-step list of (src->dest, chunk).

    0-based translation of the paper's 1-based pseudocode: at step t
    (1-based), CU ``src`` (1-based) sends chunk ``src - t + 1`` up and chunk
    ``src + t - 1`` down; reflux starts after step floor(N/2), with a local
    replication step at t = floor(N/2) + 1.
    """
    steps: list[list[Send]] = []
    half = n // 2
    for t in range(1, n + 1):
        sends: list[Send] = []
        for src1 in range(1, n + 1):  # 1-based CU id
            # progress wave, upward (lines 4-6)
            if t <= src1 < n:
                sends.append(Send(src1 - 1, src1, src1 - t))  # chunk i-t+1-1
            # progress wave, downward (lines 7-9)
            if 1 < src1 <= n - t + 1:
                sends.append(Send(src1 - 1, src1 - 2, src1 + t - 2))
            # reflux tides (lines 10-19)
            if t > half:
                if t == half + 1:
                    pass  # local replication only — no transfer (line 11-12)
                else:
                    if t - half <= src1 < t:
                        sends.append(Send(src1 - 1, src1, src1 + n - t))
                    if n - t + 1 < src1 < n - t + 1 + half:
                        sends.append(Send(src1 - 1, src1 - 2,
                                          src1 - n + t - 2))
        steps.append(sends)
    return steps


@dataclasses.dataclass
class SimResult:
    compute_order: list[list[Optional[int]]]  # [cu][step] -> chunk computed
    max_chunks_stored: int
    total_hops: int
    link_conflicts: int


def simulate(n: int, verbose: bool = False, strict: bool = True) -> SimResult:
    """Cycle-level simulation of MRCA on a 1-D mesh.

    Each CU starts holding its own chunk. Per step: (1) compute with one held
    not-yet-computed chunk — the one whose index is closest to the mesh
    centre, i.e. the inner wave; the outer wave's chunk is the one reflux
    re-delivers later (matches Fig. 15: CU2 computes chunk3 at step 2,
    chunk1 returns at step 4); (2) execute the scheduled sends; senders keep
    a local replica at the wave-crossing steps (t = ceil(N/2) .. floor(N/2)+1
    — Alg. 1 line 11, extended to even N where the waves cross mid-step).
    """
    half = n // 2
    keep_steps = {half, half + 1} if n % 2 == 0 else {half + 1}
    held = [{i} for i in range(n)]
    sched = mrca_schedule(n)
    compute_order: list[list[Optional[int]]] = [[] for _ in range(n)]
    max_stored = 1
    hops = 0
    conflicts = 0

    # (dest, chunk) deliveries at each step — for the compute tie-break
    deliveries = [ {(s.dest, s.chunk) for s in sends} for sends in sched ]

    for t1, sends in enumerate(sched, start=1):
        centre = (n - 1) / 2
        future: set = set()
        for d in deliveries[t1:]:
            future |= d
        for cu in range(n):
            cands = [c for c in held[cu] if c not in compute_order[cu]]
            # compute NOW anything that will never be delivered again; defer
            # (to the reflux re-delivery) what will come back.
            urgent = [c for c in cands if (cu, c) not in future]
            pool = urgent or cands
            pick = min(pool, key=lambda c: (abs(c - centre), c)) if pool \
                else None
            compute_order[cu].append(pick)

        # link-conflict check: physical 1-D mesh link (i, i+1) carries at
        # most one message per direction per step
        links: dict[tuple[int, int], int] = {}
        for s in sends:
            assert abs(s.src - s.dest) == 1, "non-neighbor send!"
            if strict:
                assert s.chunk in held[s.src], \
                    f"t={t1}: CU{s.src} scheduled to send chunk{s.chunk} " \
                    f"it does not hold ({sorted(held[s.src])})"
            links[(s.src, s.dest)] = links.get((s.src, s.dest), 0) + 1
            hops += 1
        conflicts += sum(v - 1 for v in links.values() if v > 1)

        new_held = [set(h) for h in held]
        for s in sends:
            if s.chunk in held[s.src]:
                new_held[s.dest].add(s.chunk)
                if t1 not in keep_steps:
                    new_held[s.src].discard(s.chunk)
        # retire chunks that are computed here and never forwarded again
        future = set()
        for later in sched[t1:]:
            future.update((s.src, s.chunk) for s in later)
        for cu in range(n):
            new_held[cu] = {c for c in new_held[cu]
                            if (cu, c) in future
                            or c not in compute_order[cu]}
        held = new_held
        max_stored = max(max_stored, max(len(h) for h in held))
        if verbose:
            print(f"step {t1}: held={[sorted(h) for h in held]}")

    return SimResult(compute_order, max_stored, hops, conflicts)


def ring_equivalent(n: int) -> bool:
    """Does MRCA deliver every chunk to every CU within N steps (the logical
    ring's guarantee)?"""
    sim = simulate(n)
    for cu in range(n):
        seen = {c for c in sim.compute_order[cu] if c is not None}
        if seen != set(range(n)):
            return False
    return True


# ---------------------------------------------------------------------------
# Baseline schedules for the spatial benchmark (Fig. 24)
# ---------------------------------------------------------------------------

def naive_ring_schedule(n: int) -> list[list[Send]]:
    """Logical ring forced onto a mesh WITHOUT wrap-around links: every step
    shifts all chunks by one, and the (n-1 -> 0) 'wrap' message must be
    store-and-forwarded across all n-1 physical links — the tail latency
    MRCA eliminates (paper §V-B2)."""
    steps = []
    for _ in range(n):
        sends = [Send(i, i + 1, -1) for i in range(n - 1)]
        sends.append(Send(n - 1, 0, -1))   # wrap: n-1 physical hops
        steps.append(sends)
    return steps


def schedule_cost(steps: list[list[Send]], hop_ns: float = 20.0,
                  chunk_bytes: float = 1.0) -> dict:
    """Per-step latency = hop_ns x max(longest routed path, worst per-link
    contention); returns total latency + link traffic for a schedule."""
    total = 0.0
    traffic = 0
    for sends in steps:
        links: dict[tuple[int, int], int] = {}
        longest = 0
        for s in sends:
            step_len = abs(s.src - s.dest)
            longest = max(longest, step_len)
            lo = min(s.src, s.dest)
            for i in range(lo, lo + step_len):
                key = (i, i + 1) if s.dest > s.src else (i + 1, i)
                links[key] = links.get(key, 0) + 1
            traffic += step_len
        congestion = max(links.values()) if links else 0
        total += max(congestion, longest) * hop_ns
    return {"latency_ns": total, "hops": traffic,
            "bytes": traffic * chunk_bytes}
