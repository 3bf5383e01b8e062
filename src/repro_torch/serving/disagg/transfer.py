"""KVTransfer: the page fabric between disaggregated instances — PyTorch
port of ``repro.serving.disagg.transfer``.

One ``KVTransfer`` moves committed KV state from a source ``EngineCore``
(the prefill-tuned instance) to a destination core (the decode-tuned
one). The wire format IS the backend-uniform flat-payload swap format
(``kvcache.wire``): the exporter gathers every resident page to host rows
with ``kept == []`` (physical ids never travel).

A handoff is two phases around a staging ``SwapArea``:

    begin(rid)     src.export_request -> validate -> stage -> summary
    complete(rid)  unstage -> dst.adopt (the payload resumes through the
                   swap-in path; None replays by chunked-prefill recompute)

Between the two the payload lives ONLY in ``self.staging`` and the
request ONLY in ``self._reqs``; neither holds a device reference (the
export closed them, and staged rows are numpy arrays, never CUDA
tensors), so ``drop(rid)`` after a fault or cancel leaks nothing.

Staging modes: ``"device"`` passes the gathered host rows through as they
are (the importer's ``upload_park`` is then the only copy, host to
device); ``"host"`` deep-copies every leaf first, a serialisation
boundary: the staged payload shares no buffer with the exporter.

Fault injection: the fabric consults a ``FaultPlan`` at the ``transfer``
seam AFTER export, modelling a payload lost on the hop: the source's
pages are already released, nothing is staged, and the retained request
recovers through ``drop`` + decode-side recompute.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from repro_torch.kvcache import SwapArea
from repro_torch.kvcache.wire import describe, payload_bytes, validate_payload
from repro_torch.obs import NULL_TELEMETRY
from repro_torch.serving.engine import Request
from repro_torch.serving.faults import FaultInjected
from repro_torch.tree import tree_leaves, tree_map

STAGING_MODES = ("device", "host")


class KVTransfer:
    """Move committed KV pages between two engine instances.

    ``plan`` is an optional ``FaultPlan`` consulted at the ``transfer``
    seam; ``telemetry`` stamps transfer spans, byte counters and the
    per-request ``transfer_out``/``transfer_in`` timeline epochs."""

    def __init__(self, src, dst, *, plan=None, telemetry=None,
                 staging: str = "device"):
        if staging not in STAGING_MODES:
            raise ValueError(f"unknown staging mode {staging!r}: "
                             f"choose from {STAGING_MODES}")
        self.src = src
        self.dst = dst
        self.plan = plan
        self.tel = telemetry or NULL_TELEMETRY
        self.staging_mode = staging
        self.staging = SwapArea()
        self._reqs: dict[int, Request] = {}   # begun, not landed
        self.n_transfers = 0
        self.n_recompute = 0
        self.n_faults = 0
        self.bytes_total = 0

    # -- phases --------------------------------------------------------------

    def begin(self, rid: int) -> Optional[dict]:
        """Detach ``rid`` from the source and stage its payload; returns
        the transfer summary (``describe`` + ``recompute`` flag) or None
        when ``rid`` is not in flight on the source. Raises
        ``FaultInjected`` when the plan fires at the seam; the request is
        retained for ``drop``-then-recompute recovery."""
        with self.tel.tracer.span("transfer", rid=rid):
            found = self.src.export_request(rid)
            if found is None:
                return None
            req, payload = found
            self._reqs[rid] = req
            if self.plan is not None and self.plan.fire("transfer"):
                self.n_faults += 1
                if self.tel.enabled:
                    self.tel.recorder.record(
                        "transfer_fault", rid=rid,
                        pages=len(payload["park"]) if payload else 0)
                raise FaultInjected(f"transfer fault: rid {rid} payload "
                                    "lost on the hop")
            if payload is None:
                self.n_recompute += 1
                return {"rid": rid, "recompute": True, "bytes": 0}
            payload = self._stage_rows(payload)
            validate_payload(payload,
                             page_size=self.dst.backend.page_size,
                             transfer=True)
            nbytes = payload_bytes(payload)
            self.staging.put(rid, payload, nbytes)
            self.n_transfers += 1
            self.bytes_total += nbytes
        if self.tel.enabled:
            self.tel.metrics.counter(
                "engine_kv_transfer_bytes_total",
                "KV payload bytes moved between instances").inc(
                nbytes, mode=self.staging_mode)
            self.tel.timeline(rid).transfer_out_ts.append(
                time.perf_counter())
        return dict(describe(payload), rid=rid, recompute=False)

    def complete(self, rid: int) -> Request:
        """Land a begun transfer on the destination: the staged payload
        (or the recompute marker) becomes a ``dst.adopt``."""
        req = self._reqs.pop(rid)
        payload = self.staging.discard(rid)    # None -> recompute replay
        self.dst.adopt(req, payload)
        if self.tel.enabled:
            self.tel.timeline(rid).transfer_in_ts.append(
                time.perf_counter())
        return req

    def drop(self, rid: int) -> Optional[Request]:
        """Abandon an in-flight transfer (fault or cancel mid-hop):
        discard any staged payload and return the detached request (None
        when no transfer for ``rid`` is in flight)."""
        self.staging.discard(rid)
        return self._reqs.pop(rid, None)

    def in_flight(self) -> list[int]:
        return sorted(self._reqs)

    # -- internals -----------------------------------------------------------

    def _stage_rows(self, payload: dict) -> dict:
        rows = payload.get("rows")
        if rows is None:
            return payload
        if not all(isinstance(leaf, np.ndarray) for leaf in tree_leaves(rows)):
            raise TypeError("transfer payload rows must be host numpy "
                            "arrays, never device tensors")
        if self.staging_mode == "device":
            return payload
        # host staging: the staged tree must not alias the exporter's
        return dict(payload, rows=tree_map(lambda x: np.array(x, copy=True),
                                           rows))

    def stats(self) -> dict:
        return {"n_transfers": self.n_transfers,
                "n_recompute": self.n_recompute,
                "n_faults": self.n_faults,
                "bytes_total": self.bytes_total,
                "staging": self.staging.stats(),
                "in_flight": len(self._reqs)}
