"""The dense slot engine — the serving test oracle — and ``Request``, the
live request type shared by every engine of the port. PyTorch port of
``repro.serving.engine``.

The engine is the original slot-based continuous batcher: ``max_batch``
sequence slots over one dense ``[L, max_batch, max_len, nkv, dh]`` KV
slab per attention block, and a state slab per recurrent block (Mamba,
mLSTM, sLSTM), the only engine of either package that serves those. It is not a production path (``launch/serve.py`` defaults to the
paged engine). It stays for two jobs: the parity oracle (its prefill plus
greedy decode over a contiguous dense cache is the simplest correct
serving semantics, ``LLM(backend="dense")`` through the same front door)
and the footprint baseline the paged pool is measured against.

One step of the oracle:
  admit()  — fill free slots from the queue: per-slot prefill + splice
  step()   — one decode for every slot (``lm.decode_step``)
  reap     — emit finished sequences (EOS or max_tokens), free slots

The prefill is ``lm.prefill`` (K4, or K2 -> SADS -> K3 with STAR on, on
a GPU); the decode is plain PyTorch (``attention.apply_decode``), as the
reference leaves it to XLA. Where the reference jits both steps and
rebuilds the cache functionally, this one runs eagerly and writes the
slab in place; its slab is allocated from the model's shapes, where the
reference prefills a dummy batch to learn the structure.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # [T] int32
    max_tokens: int = 32
    max_len: Optional[int] = None   # per-request total-length cap (paged
    #                                 engine; the dense engine's cap is the
    #                                 engine-wide EngineCfg.max_len)
    priority: int = 0           # higher = more important: admitted first,
    #                             preempted last under pool pressure (paged
    #                             engine scheduler; ties break by arrival)
    sla: Optional[str] = None   # QoS class ("interactive" | "standard" |
    #                             "batch"); when set the scheduler maps it
    #                             onto ``priority`` at submit
    out: Optional[list] = None
    deadline_ms: Optional[float] = None      # end-to-end budget from
    #                             submit; exceeded -> EXPIRED terminal
    ttft_deadline_ms: Optional[float] = None  # first-token budget; only
    #                             checked while no token has been emitted
    submit_t: Optional[float] = None  # perf_counter at engine submit —
    #                             the clock deadlines measure against
    finish_reason: Optional[str] = None
    # terminal state: "done" | "cancelled" | "expired" | "failed";
    # None while in flight (docs/serving.md lifecycle state machine)

    def deadline_exceeded(self, now: float) -> bool:
        """Has either budget lapsed at wall-clock ``now``?"""
        if self.submit_t is None:
            return False
        waited_ms = (now - self.submit_t) * 1e3
        if self.deadline_ms is not None and waited_ms > self.deadline_ms:
            return True
        return (self.ttft_deadline_ms is not None and not self.out
                and waited_ms > self.ttft_deadline_ms)


@dataclasses.dataclass(frozen=True)
class EngineCfg:
    max_batch: int = 8
    max_len: int = 512
    eos_id: int = 1
    greedy: bool = True
    temperature: float = 1.0


class ServingEngine:
    """The dense slot engine. ``params`` live on the engine's device (the
    device of ``params["embed"]``); ``generator`` drives sampled decode
    (``EngineCfg(greedy=False)``)."""

    def __init__(self, model_cfg, params, ecfg: EngineCfg,
                 generator: Optional[torch.Generator] = None):
        from repro_torch.models import lm

        if model_cfg.enc_layers:
            # the reference's engine fails at its dummy prefill (no
            # ``enc_tokens``): a request carries no encoder input
            raise ValueError("dense engine needs a decoder-only model: an "
                             "encoder-decoder model runs through "
                             "lm.prefill and lm.decode_step")
        self.cfg = model_cfg
        self.ecfg = ecfg
        self.params = params
        self.device = params["embed"].device
        self.generator = generator
        self.queue: list[Request] = []
        self.active: dict[int, Request] = {}      # slot -> request
        self.budget: dict[int, int] = {}          # slot -> remaining tokens
        self._terminal: list[Request] = []        # aborted, not yet drained
        self.fault_plan = None           # faults.FaultPlan (chaos tests):
        #                                  consulted at the dense_prefill seam
        self.fault_retries = 2           # re-queues granted per request
        #                                  before a fault quarantines it
        self._fault_counts: dict[int, int] = {}
        lm.check_supported(model_cfg)
        b = ecfg.max_batch
        layers = {f"b{i}": {blk.kind: self._slabs(blk.kind)}
                  for i, blk in enumerate(model_cfg.pattern)}
        self.cache = {"layers": layers,
                      "lengths": torch.zeros((b,), dtype=torch.int32,
                                             device=self.device)}
        self.last_token = torch.zeros((b, 1), dtype=torch.int32,
                                      device=self.device)
        self.free = list(range(b))

    def _slabs(self, kind: str) -> dict:
        """One block's slot slabs [L, max_batch, ...], zeroed: attention's
        K/V rows (and LZ codes with STAR); a recurrent block's state in
        the shapes and dtypes its prefill returns (a Mamba block's conv
        window in the activations' dtype, every other state in fp32)."""
        cfg, f32 = self.cfg, torch.float32
        lead = (cfg.n_repeat, self.ecfg.max_batch)
        if kind == "attn":
            rows = lead + (self.ecfg.max_len, cfg.n_kv, cfg.dh)
            shapes = {"k": (rows, cfg.dtype), "v": (rows, cfg.dtype)}
            if cfg.attn_cfg().lz_cache:
                shapes["k_lz"] = (rows, torch.int8)
        elif kind == "mamba":
            m = cfg.mamba
            shapes = {"conv": (lead + (m.d_conv - 1, m.d_inner), cfg.dtype),
                      "state": (lead + (m.n_heads, m.d_state, m.head_dim),
                                f32)}
        elif kind == "mlstm":
            nh, dh = cfg.xlstm_heads, cfg.xlstm_cfg().head_dim
            shapes = {"state": (lead + (nh, dh, dh + 1), f32)}
        else:
            nh, dh = cfg.xlstm_heads, cfg.xlstm_cfg().head_dim
            shapes = {name: (lead + (nh, dh), f32) for name in "cnh"}
        return {name: torch.zeros(shape, dtype=dtype, device=self.device)
                for name, (shape, dtype) in shapes.items()}

    # -- queueing -----------------------------------------------------------

    def submit(self, req: Request):
        req.out = []
        if req.submit_t is None:
            req.submit_t = time.perf_counter()
        self.queue.append(req)

    # -- lifecycle ----------------------------------------------------------

    def _finish_abnormal(self, req: Request, outcome: str) -> None:
        req.finish_reason = outcome
        self._terminal.append(req)

    def cancel(self, rid: int, *, outcome: str = "cancelled",
               reason: str = "client") -> bool:
        """Terminate a queued or in-flight request; frees its slot."""
        for slot, req in list(self.active.items()):
            if req.rid == rid:
                del self.active[slot]
                del self.budget[slot]
                self.free.append(slot)
                self._finish_abnormal(req, outcome)
                return True
        for req in self.queue:
            if req.rid == rid:
                self.queue.remove(req)
                self._finish_abnormal(req, outcome)
                return True
        return False

    def _expire_deadlines(self) -> None:
        now = time.perf_counter()
        expired = [r.rid for r in self.active.values()
                   if r.deadline_exceeded(now)]
        expired += [r.rid for r in self.queue if r.deadline_exceeded(now)]
        for rid in expired:
            self.cancel(rid, outcome="expired", reason="deadline")

    def drain_terminal(self) -> list[Request]:
        """Requests that ended abnormally since the last drain (the
        caller closes their records; ``Request.finish_reason`` says how
        they ended)."""
        out, self._terminal = self._terminal, []
        return out

    def _splice_slot(self, slot: int, cache_one, length: int, token: int):
        """Write a single prefilled sequence into the slabs at ``slot``:
        every leaf of every block, attention rows and recurrent state."""
        for key, blk in cache_one["layers"].items():
            for kind, leaves in blk.items():
                for name, one in leaves.items():
                    self.cache["layers"][key][kind][name][:, slot] = \
                        one[:, 0]
        self.cache["lengths"][slot] = length
        self.last_token[slot, 0] = token

    def admit(self):
        from repro_torch.models import lm

        self._expire_deadlines()
        while self.free and self.queue:
            req = self.queue.pop(0)
            if self.fault_plan is not None \
                    and self.fault_plan.fire("dense_prefill"):
                n = self._fault_counts.get(req.rid, 0) + 1
                self._fault_counts[req.rid] = n
                if n > self.fault_retries:
                    self._finish_abnormal(req, "failed")
                else:
                    self.queue.append(req)     # bounded retry, back of line
                continue
            slot = self.free.pop(0)
            t = len(req.prompt)
            batch = {"tokens": torch.as_tensor(
                np.asarray(req.prompt, np.int32)[None, :],
                device=self.device)}
            with torch.no_grad():
                logits, cache_one = lm.prefill(self.params, self.cfg, batch,
                                               cache_len=self.ecfg.max_len)
            tok = int(torch.argmax(logits[0, :self.cfg.vocab]))
            req.out.append(tok)
            self._splice_slot(slot, cache_one, t, tok)
            self.active[slot] = req
            self.budget[slot] = req.max_tokens - 1

    # -- decode -------------------------------------------------------------

    def _next_tokens(self, logits: torch.Tensor) -> torch.Tensor:
        if self.ecfg.greedy:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / self.ecfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0]

    def step(self):
        from repro_torch.models import lm

        if not self.active:
            return
        # a request whose budget was exhausted by the prefill token (e.g.
        # max_tokens=1) finishes without a decode step
        for slot, req in list(self.active.items()):
            if self.budget[slot] <= 0:
                del self.active[slot]
                del self.budget[slot]
                self.free.append(slot)
                req.finish_reason = "done"
                yield req
        if not self.active:
            return
        with torch.no_grad():
            logits, self.cache = lm.decode_step(self.params, self.cfg,
                                                self.last_token, self.cache)
        nxt = self._next_tokens(logits[:, :self.cfg.vocab])
        self.last_token = nxt[:, None].to(torch.int32)
        nxt_host = nxt.cpu().numpy()
        lengths = self.cache["lengths"].cpu().numpy()
        for slot, req in list(self.active.items()):
            tok = int(nxt_host[slot])
            req.out.append(tok)
            self.budget[slot] -= 1
            done = tok == self.ecfg.eos_id or self.budget[slot] <= 0 or \
                int(lengths[slot]) >= self.ecfg.max_len - 1
            if done:
                del self.active[slot]
                del self.budget[slot]
                self.free.append(slot)
                req.finish_reason = "done"
                yield req

    # -- the run loop -------------------------------------------------------

    def run(self, requests: list[Request], max_steps: int = 10_000):
        """Serve a request list to completion; returns {rid: tokens}."""
        for r in requests:
            self.submit(r)
        done: dict[int, list] = {}
        steps = 0
        while (self.queue or self.active) and steps < max_steps:
            self.admit()
            for fin in self.step() or ():
                done[fin.rid] = fin.out
            for fin in self.drain_terminal():
                done[fin.rid] = fin.out
            steps += 1
        return done
