"""DisaggRouter: the prefill/decode-disaggregated serving front door —
PyTorch port of ``repro.serving.disagg.router``.

Prefill and decode want opposite tunings: prefill is compute-bound and
batches wide token budgets; decode is memory-bound and wants a big batch
over a deep pool with a narrow DLZS hot set (and, with
``kv_quant="int8"``, a cold tier that doubles what the pool holds). One
instance compromises both, and a long prefill stalls co-resident decodes
behind the shared dispatch. ``DisaggRouter`` runs two engine instances
and moves each request across at the phase boundary:

    submit --> prefill instance (whole-prompt or large-budget prefill)
                  |  first token emitted (prefill complete)
                  v
               KVTransfer.begin/complete  (flat-payload page handoff)
                  |
                  v
               decode instance (deep pool, decode_hot_width, int8
               cold tier) --> finished

It IS an ``LLM`` (same ``submit()/tick()/metrics()/debug_bundle()``),
overriding only the three engine touch-points of the base class
(``_submit_engine``/``_step_engines``/``_cancel_engine``). One
``obs.Telemetry`` is shared by both instances, so a request has one
timeline across its whole journey.

Handoff state machine (per request)::

    PREFILLING --prefill done--> ELIGIBLE --begin--> STAGED
       |                            |                  | complete
       | preempted to decode-kind   | export fault     v
       | payload / recompute mode   v                LANDED (decode)
       +------> ELIGIBLE         RECOMPUTE --adopt(None)--> decode
                                    | retries exhausted
                                    +--> FAILED (terminal)

Conservation holds across BOTH pools plus the fabric every tick: export
closes the source side, staged payloads hold host bytes only, and adopt
re-enters the destination through the audited swap-in path. A transfer
fault loses bytes, never pages: the request replays prompt + emitted
tokens through decode-side prefill, gated by a ``RetryGovernor``.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.serving.api import LLM, json_default
from repro_torch.serving.disagg.transfer import KVTransfer
from repro_torch.serving.engine import Request
from repro_torch.serving.swap_policy import RetryGovernor


class DisaggRouter(LLM):
    """Front door over a (prefill, decode) instance pair.

    ``prefill_engine``/``decode_engine`` are ``EngineCore`` instances of
    any swap-format backend; they need not match (spatial prefill into
    paged decode works).
    ``fault_plan`` injects at the ``transfer`` seam; ``staging`` picks
    the fabric mode (``KVTransfer``). The decode instance is
    ``self.engine``: the base class serves records, metrics and bundles
    from it."""

    def __init__(self, prefill_engine, decode_engine, *, telemetry=None,
                 fault_plan=None, staging: str = "device",
                 transfer_retries: int = 2):
        super().__init__(decode_engine, telemetry=telemetry)
        self.prefill = prefill_engine
        # one telemetry identity across both instances: the engines stamp
        # the SAME timeline objects the router's records wrap
        if hasattr(prefill_engine, "attach_telemetry"):
            prefill_engine.attach_telemetry(self.tel)
        self.transfer = KVTransfer(prefill_engine, decode_engine,
                                   plan=fault_plan, telemetry=self.tel,
                                   staging=staging)
        self.governor = RetryGovernor(max_retries=transfer_retries)

    # -- construction --------------------------------------------------------

    @classmethod
    def from_config(cls, model_cfg, *, backend: str = "paged",
                    prefill_backend: Optional[str] = None,
                    params=None, shards: int = 2, prefill_engine_cfg=None,
                    decode_engine_cfg=None, prefill_sched_cfg=None,
                    decode_sched_cfg=None,
                    generator: Optional["torch.Generator"] = None,
                    device=None, telemetry=None, fault_plan=None,
                    staging: str = "device") -> "DisaggRouter":
        """Build the instance pair around ONE set of params.

        ``backend`` picks the decode instance (``"paged"`` or
        ``"spatial"``, the latter over ``shards`` shards unless its engine
        config says otherwise), ``prefill_backend`` the prefill side
        (default: the same).
        ``device`` defaults to ``cuda`` and raises without a GPU.
        ``generator`` (default: one seeded with 0 on the device) draws
        the random weights when ``params`` is None and drives sampled
        decode on both instances. Default tunings: the prefill instance
        runs the ``"auto"`` prefill token budget; the decode instance the
        full batch and no prefill budget (its only prefills are
        recompute fallbacks)."""
        import torch

        from repro_torch.device import resolve_device
        from repro_torch.models import lm
        from repro_torch.serving.paged import (PagedEngineCfg,
                                               PagedServingEngine)
        from repro_torch.serving.scheduler import SchedulerCfg

        for kind in (backend, prefill_backend or backend):
            if kind not in ("paged", "spatial"):
                raise ValueError(f"unknown disagg backend {kind!r}: "
                                 "choose from ('paged', 'spatial')")
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(0)
        if params is None:
            params = lm.init(model_cfg, generator, dev)

        def build(kind, engine_cfg, sched_cfg):
            if kind == "paged":
                return PagedServingEngine(model_cfg, params,
                                          engine_cfg or PagedEngineCfg(),
                                          sched_cfg, generator=generator)
            from repro_torch.spatial.engine import (SpatialEngineCfg,
                                                    SpatialServingEngine)
            return SpatialServingEngine(
                model_cfg, params,
                engine_cfg or SpatialEngineCfg(n_shards=shards), sched_cfg,
                generator=generator)

        pre = build(prefill_backend or backend, prefill_engine_cfg,
                    prefill_sched_cfg or SchedulerCfg(prefill_tokens="auto"))
        dec = build(backend, decode_engine_cfg,
                    decode_sched_cfg or SchedulerCfg())
        return cls(pre, dec, telemetry=telemetry, fault_plan=fault_plan,
                   staging=staging)

    # -- the LLM engine seam -------------------------------------------------

    def _submit_engine(self, req: Request) -> None:
        self.prefill.submit(req)

    def _cancel_engine(self, rid: int, *, reason: str) -> bool:
        if self.prefill.cancel(rid, reason=reason):
            return True
        req = self.transfer.drop(rid)
        if req is not None:
            # mid-hop: no pages are held anywhere; stamp terminal on the
            # decode side so the finished stream surfaces it
            self.engine.exec_abort(req, "cancelled", reason)
            return True
        return self.engine.cancel(rid, reason=reason)

    def _step_engines(self) -> list[Request]:
        finished = list(self.prefill.step() or ())
        for rid in self._handoff_candidates():
            self._handoff(rid)
        finished += self.engine.step() or []
        return finished

    # -- handoff -------------------------------------------------------------

    def _handoff_candidates(self) -> list[int]:
        """Requests done with prefill on the prefill instance: decoding in
        a slot, parked with a decode-kind payload, or waiting in
        recompute mode with tokens already emitted."""
        pre = self.prefill
        rids = [req.rid for slot, req in pre.active.items()
                if slot not in pre._pf]
        for w in pre.sched.waiting:
            if w.swapped:
                payload = pre.swap_area.peek(w.req.rid)
                if payload is not None and payload.get("kind") == "decode":
                    rids.append(w.req.rid)
            elif w.req.out:
                rids.append(w.req.rid)
        return rids

    def _handoff(self, rid: int) -> None:
        try:
            summary = self.transfer.begin(rid)
        except Exception:
            req = self.transfer.drop(rid)
            if req is None:
                return
            # the payload is gone; the only retry is a decode-side
            # recompute replay (the governor only counts attempts)
            if self.governor.record_fault(rid) is None:
                self.engine.exec_abort(req, "failed", "transfer")
            else:
                self.engine.adopt(req)
            return
        if summary is None:     # finished or cancelled under our feet
            return
        self.transfer.complete(rid)
        self.governor.forget(rid)

    # -- surface -------------------------------------------------------------

    def has_work(self) -> bool:
        pre = self.prefill
        return bool(pre.queue or pre.active
                    or getattr(pre, "_terminal", ())
                    or self.transfer.in_flight()
                    or super().has_work())

    def stats(self) -> dict:
        # decode-side pool/sched stay top-level: base-class metrics()
        # reads occupancy and preemptions from there
        st = self.engine.stats()
        st["prefill"] = self.prefill.stats()
        st["transfer"] = self.transfer.stats()
        return st

    def debug_bundle(self, out_dir: Optional[str] = None) -> str:
        import json
        import os

        out = super().debug_bundle(out_dir)
        if hasattr(self.prefill, "accounting_snapshot"):
            with open(os.path.join(out, "accounting_prefill.json"),
                      "w") as f:
                json.dump(self.prefill.accounting_snapshot(), f,
                          indent=2, default=json_default)
                f.write("\n")
        with open(os.path.join(out, "transfer.json"), "w") as f:
            json.dump(self.transfer.stats(), f, indent=2, default=json_default)
            f.write("\n")
        return out
