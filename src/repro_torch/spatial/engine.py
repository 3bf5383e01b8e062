"""Sequence-sharded serving backend — PyTorch port of
``repro.spatial.engine``.

One request's KV context is STRIPED page by page across ``n_shards``
shards (``spatial.topology``), so the longest servable prompt and the
aggregate decode working set scale with the shard count instead of one
pool's size. This is the serving side of the paper's Spatial-STAR
deployment: per-shard pools with per-shard DLZS retention, and partial
softmax ``(m, l, o)`` states merged across shards (DRAttention's
combination) for every cross-shard attention.

The reference places each shard on its own XLA device and runs every
step as one shard_map dispatch. The port keeps every shard on ONE device:
each pool slab is ``[L, S, P_local, page, n_kv, dh]`` (one layer's slab
is the reference's per-shard stack ``[S, P_local, ...]``), and each layer
handles every shard at once:

* chunked prefill (per sequence and batched varlen) — each shard's
  partial state of the chunk queries against its resident past pages,
  merged over the shard axis; the chunk's K/V rows land in the pages
  their owner shards hold (``lm.prefill_chunk[_batch]_spatial``);
* decode — the query is computed once, the new row goes to its owner
  shard's page, one launch of K1's unnormalised (m, l, o) form covers all
  shards' hot pages, and the states merge (``lm.decode_step_spatial``).

On one device this holds no more context than one pool of the same total
size; what it carries is the sharded dataflow and the merge. The entire
executor (admission, chunked + batched prefill, decode loop, lazy
cold-page shedding, preempt/swap) is the SHARED ``EngineCore``; this
module implements the ``Backend`` protocol over sharded pools. Pressure
is shard-tagged: a starved shard picks victims and sheds pages that free
memory THERE.

``stats()["decode_compiles"]`` / ``["prefill_batch_compiles"]`` count the
distinct decode and batched-prefill shapes that ran, as in the port's
paged backend: nothing compiles eagerly, but the count is the number of
CUDA graphs a capture of the step would need, and the backend-conformance
scenarios hold it at one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.kvcache import SCRATCH, bucketing, metrics, quant
from repro_torch.models import lm
from repro_torch.obs import NULL_TELEMETRY
from repro_torch.serving.engine_core import EngineCore
from repro_torch.serving.paged import _to_device, _to_host
from repro_torch.serving.scheduler import (NeedPages, SchedulerCfg,
                                           resolve_prefill_tokens)
from repro_torch.spatial.sharded_pool import ShardedPagePools, ShardPoolExhausted
from repro_torch.spatial.topology import ShardTopology
from repro_torch.tree import tree_items, tree_map

__all__ = ["SpatialEngineCfg", "SpatialBackend", "SpatialServingEngine"]


@dataclasses.dataclass(frozen=True)
class SpatialEngineCfg:
    n_shards: int = 2
    max_batch: int = 8
    page_size: int = 16
    n_pages_local: int = 64      # per-shard pool capacity (page 0 scratch)
    hot_pages_local: int = 16    # W: pages gathered per shard per decode
    recent_pages: int = 2        # newest LOCAL pages always hot per shard
    eos_id: int = 1
    greedy: bool = True
    temperature: float = 1.0
    bucket_pow2: bool = True
    share_prefixes: bool = True
    batch_past_pages: Optional[int] = None
    # Per-SHARD past-page gather width of the batched chunk-prefill
    # dispatch (SchedulerCfg.prefill_tokens); None sizes it to a whole
    # local pool. Fixed at init: one batched-prefill shape.


def _fold(leaf: torch.Tensor) -> torch.Tensor:
    """[L, S, P, ...] -> [L, S·P, ...]: the shards' pools as one page axis
    (what the single-pool page scores reduce over)."""
    return leaf.reshape(leaf.shape[0], -1, *leaf.shape[3:])


class SpatialBackend:
    """Sharded-pool ``engine_core.Backend`` implementation, every shard on
    the device the params live on."""

    def __init__(self, model_cfg, params, pcfg: SpatialEngineCfg,
                 scfg: SchedulerCfg):
        if any(blk.kind != "attn" for blk in model_cfg.pattern):
            raise ValueError("spatial engine supports attention-only "
                             "patterns")
        if model_cfg.enc_layers or not model_cfg.causal:
            raise ValueError("spatial engine needs a causal decoder-only "
                             "model")
        if model_cfg.star is not None:
            raise ValueError(
                "spatial engine serves dense-attention configs; sparsity "
                "comes from per-shard DLZS hot-page retention at decode")
        if scfg.kv_quant not in (None, "int8"):
            raise ValueError(
                f"kv_quant={scfg.kv_quant!r}: choose None or 'int8'")
        self.cfg = model_cfg
        self.pcfg = pcfg
        self.params = params
        self.topo = ShardTopology(pcfg.n_shards)
        self.device = self.mesh = self.topo.make_mesh(params["embed"].device)
        self.pools = ShardedPagePools(
            self.topo, pcfg.n_pages_local, pcfg.page_size,
            recent_pages=pcfg.recent_pages)
        self.tel = NULL_TELEMETRY    # shared via EngineCore.attach_telemetry

        # protocol facts EngineCore reads
        self.page_size = pcfg.page_size
        self.max_batch = pcfg.max_batch
        self.eos_id = pcfg.eos_id
        self.greedy = pcfg.greedy
        self.temperature = pcfg.temperature
        self.bucket_pow2 = pcfg.bucket_pow2
        self.share = pcfg.share_prefixes
        # a shed must keep the newest local page window of EVERY shard
        # resident: striping maps the newest r locals per shard onto the
        # newest ~r*n_shards global pages
        self.keep_recent = max(1, pcfg.recent_pages) * pcfg.n_shards

        # decode-time DLZS sparsity + int8 cold tier. The width cap applies
        # PER SHARD: each shard's slice keeps at most min(hot_pages_local,
        # decode_hot_width) sphere-rule pages; a shard whose slices all
        # come back empty costs K1's stats form nothing (its early exit).
        self.sparse_decode = scfg.decode_hot_width is not None
        self.hot_width = (min(pcfg.hot_pages_local, scfg.decode_hot_width)
                          if self.sparse_decode else pcfg.hot_pages_local)
        self.hot_radius = scfg.decode_hot_radius
        self.kv_quant = scfg.kv_quant == "int8"
        self.decode_sparsity = None  # telemetry dict, set per decode step
        # per shard: decode steps on which its hot set was empty for the
        # whole batch (host bookkeeping: the tables are on the host)
        self.shard_skips = [0] * pcfg.n_shards
        self.decode_steps = 0

        # batched varlen chunk prefill: fixed flat width + fixed per-shard
        # past window => one dispatch shape
        max_tokens = resolve_prefill_tokens(scfg, pcfg.page_size)
        self.batched = max_tokens is not None
        self.budget_tokens = self.batch_wp = None
        if self.batched:
            self.budget_tokens = bucketing.budget_tokens(
                max_tokens, pcfg.page_size, scfg.chunk_pages,
                pow2=pcfg.bucket_pow2)
            self.batch_wp = bucketing.bucket_count(
                pcfg.batch_past_pages or pcfg.n_pages_local - 1,
                pow2=pcfg.bucket_pow2)
        self._decode_shapes: set = set()
        self._prefill_batch_shapes: set = set()

        # Per-shard pool slabs from a one-page probe prefill: each leaf
        # [L, 1, page, nkv, dh] becomes [L, n_shards, P_local, page, ...].
        with torch.no_grad():
            _, cache_one = lm.prefill(
                params, model_cfg,
                {"tokens": self._ints(np.zeros((1, pcfg.page_size)))},
                last_index=self._ints([0]))
        layers = tree_map(
            lambda leaf: torch.zeros(
                (leaf.shape[0], pcfg.n_shards, pcfg.n_pages_local)
                + tuple(leaf.shape[2:]), dtype=leaf.dtype,
                device=self.device),
            cache_one["layers"])
        if self.kv_quant:
            # the int8 tier rides in the same tree ([L, S, P, ...] codes,
            # [L, S, P] scales), so swap and transfer payloads carry it
            layers = quant.add_quant_slabs(layers)
        self.cache = {"layers": layers,
                      "lengths": self._ints(np.zeros((pcfg.max_batch,)))}
        self.last_token = self._ints(np.zeros((pcfg.max_batch, 1)))
        # per-page byte prices (shape-only, one shard's slice): the full
        # tree row a swap payload carries vs the K/V rows a decode gather
        # reads — obs.accounting prices page traffic with these
        one = self._shard_slice(0)
        self.page_bytes_full = metrics.bytes_per_page(one)
        self.page_bytes_gather = metrics.gather_bytes_per_page(one)
        self.page_bytes_int8 = metrics.quant_bytes_per_page(one)

    def _ints(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr), dtype=torch.int32,
                               device=self.device)

    def _shard_slice(self, shard: int):
        """Shard ``shard``'s pools as a single-pool tree [L, P, ...]."""
        return tree_map(lambda leaf: leaf[:, shard], self.cache["layers"])

    def _slabs(self):
        return [leaf for _, leaf in tree_items(self.cache["layers"])]

    def _copy_page(self, shard: int, src: int, dst: int) -> None:
        """COW on one shard: duplicate local page ``src`` into ``dst``."""
        for pool in self._slabs():
            pool[:, shard, dst] = pool[:, shard, src]

    def _pull_scores(self) -> np.ndarray:
        """Per-shard DLZS page scores [n_shards, n_pages_local]."""
        with torch.no_grad():
            sc = metrics.page_scores(tree_map(_fold, self.cache["layers"]))
        return sc.reshape(self.topo.n_shards, -1).cpu().numpy()

    # -- admission ------------------------------------------------------------

    def check_capacity(self, rid: int, total: int, need: int) -> None:
        if not self.pools.fits(need):
            raise ValueError(
                f"request {rid}: {total} tokens needs {need} striped "
                f"pages; {self.topo.n_shards} shards x "
                f"{self.pcfg.n_pages_local - 1} pages cannot hold them")
        if self.batched and self.topo.max_local_count(need) > self.batch_wp:
            raise ValueError(
                f"request {rid}: {need} striped pages exceeds the "
                f"batched chunk-prefill past window ({self.batch_wp} "
                f"pages/shard); raise SpatialEngineCfg.batch_past_pages")

    # -- pool primitives ------------------------------------------------------

    def alloc_chunk(self, pf, start_page: int, n_need: int
                    ) -> tuple[list[int], list[int], bool]:
        scores = self._pull_scores() \
            if any(self.pools.free_pages(s) < n_need
                   for s in range(self.topo.n_shards)) else None
        return self.pools.admit_chunk(pf.toks, start_page, n_need,
                                      scores, sharing=pf.sharing)

    def release_pages(self, pages: list[int], start_global: int) -> None:
        for i, pid in enumerate(pages):
            self.pools.pools[self.topo.owner(start_global + i)].decref(pid)

    def release_table(self, table: list[int]) -> None:
        for j, pid in enumerate(table):
            if pid >= 0:
                self.pools.pools[self.topo.owner(j)].decref(pid)

    def lookup_prefix(self, g: int, key: tuple) -> Optional[int]:
        return self.pools.pools[self.topo.owner(g)].lookup(key)

    def register_prefix(self, g: int, key: tuple, pid: int) -> None:
        self.pools.pools[self.topo.owner(g)].register(key, pid)

    def decref_page(self, g: int, pid: int) -> None:
        self.pools.pools[self.topo.owner(g)].decref(pid)

    def forget_prefix(self, g: int, pid: int) -> None:
        self.pools.pools[self.topo.owner(g)].forget(pid)

    def register_prompt_pages(self, toks, table, fresh_globals,
                              start_page: int) -> None:
        self.pools.register_prompt_pages(toks, table, fresh_globals)

    def ref_of(self, table, j: int) -> int:
        return self.pools.pools[self.topo.owner(j)].ref(table[j])

    def held_pages(self, table, shard: Optional[int] = None) -> int:
        return self.pools.held_pages(table, shard)

    def page_on_shard(self, j: int, shard: Optional[int] = None) -> bool:
        return shard is None or self.topo.owner(j) == shard

    # -- prefill dispatch -----------------------------------------------------

    def _past_state(self, table: list[int], start_page: int
                    ) -> tuple[np.ndarray, np.ndarray]:
        """Per-shard (past_phys, past_logical) [n_shards, 1, Wp] of the
        pages earlier chunks wrote; Wp pow2-bucketed on the largest
        per-shard count."""
        n = self.topo.n_shards
        wp = bucketing.bucket_count(
            max(1, self.topo.max_local_count(start_page)),
            pow2=self.pcfg.bucket_pow2)
        phys = np.full((n, 1, wp), -1, np.int32)
        logical = np.full((n, 1, wp), -1, np.int32)
        for s in range(n):
            globals_ = list(range(s, start_page, n))
            phys[s, 0, :len(globals_)] = [table[j] for j in globals_]
            logical[s, 0, :len(globals_)] = globals_
        return phys, logical

    @torch.no_grad()
    def dispatch_chunk(self, pf, table, start, end, width, last_idx,
                       pages, fresh_globals) -> np.ndarray:
        page = self.page_size
        start_page = start // page
        toks = bucketing.pad_tokens(pf.prompt[start:end], width)
        # chunk page targets: the owner shard writes fresh pages, all
        # else (shared content, bucket padding) -> that shard's scratch
        n = self.topo.n_shards
        fresh_set = set(fresh_globals)
        chunk_phys = np.full((n, 1, width // page), SCRATCH, np.int32)
        for cj in range(len(pages)):
            g = start_page + cj
            if g in fresh_set:
                chunk_phys[self.topo.owner(g), 0, cj] = table[g]
        past_phys, past_logical = self._past_state(table, start_page)
        chunk_state = {
            "past_phys": self._ints(past_phys),
            "past_logical": self._ints(past_logical),
            "chunk_phys": self._ints(chunk_phys),
            "past_len": self._ints([start]),
            "last_index": self._ints([last_idx])}
        logits, _ = lm.prefill_chunk_spatial(
            self.params, self.cfg, {"tokens": self._ints(toks)[None, :]},
            {"layers": self.cache["layers"]}, chunk_state)
        return logits[0].float().cpu().numpy()

    def arena_cost(self, past_pages: int) -> list[int]:
        # striping puts ~past_pages/n past slots on each shard's arena
        return [self.topo.local_count(past_pages, s)
                for s in range(self.topo.n_shards)]

    @torch.no_grad()
    def dispatch_wave(self, flat, seg, pos, past_len, last_index,
                      lanes) -> dict[int, np.ndarray]:
        """Fill the per-SHARD past arenas + chunk scatter targets for one
        wave and run the batched varlen dispatch, the cross-shard softmax
        merged over the shard axis."""
        page, n_sh = self.page_size, self.topo.n_shards
        b_tok, wp = self.budget_tokens, self.batch_wp
        chunk_phys = np.full((n_sh, 1, b_tok // page), SCRATCH, np.int32)
        past_phys = np.full((n_sh, wp), -1, np.int32)
        past_lane = np.full((n_sh, wp), -1, np.int32)
        past_logical = np.full((n_sh, wp), -1, np.int32)
        arena = [0] * n_sh
        for lane in lanes:
            slot, table = lane["slot"], lane["table"]
            sp = lane["start_page"]
            for s in range(n_sh):
                globals_ = list(range(s, sp, n_sh))
                a = arena[s]
                past_phys[s, a:a + len(globals_)] = \
                    [table[j] for j in globals_]
                past_lane[s, a:a + len(globals_)] = slot
                past_logical[s, a:a + len(globals_)] = globals_
                arena[s] = a + len(globals_)
            base = lane["base"]
            for cj, pid in enumerate(lane["pages"]):
                g = sp + cj
                if g in lane["fresh"]:
                    chunk_phys[self.topo.owner(g), 0, base + cj] = pid
        if self.tel.enabled:
            for s in range(n_sh):      # shard-tagged arena occupancy
                self.tel.tracer.instant("arena.fill", tid=s + 1,
                                        shard=s, used=int(arena[s]),
                                        cap=wp, lanes=len(lanes))
                self.tel.metrics.gauge(
                    "engine_arena_pages_used",
                    "past-arena slots filled by the last wave").set(
                    int(arena[s]), shard=s)
        pack_state = {
            "seg_ids": self._ints(seg),
            "positions": self._ints(pos),
            "past_phys": self._ints(past_phys),
            "past_lane": self._ints(past_lane),
            "past_logical": self._ints(past_logical),
            "chunk_phys": self._ints(chunk_phys),
            "past_len": self._ints(past_len),
            "last_index": self._ints(last_index)}
        self._prefill_batch_shapes.add((len(flat), wp, len(past_len)))
        logits, _ = lm.prefill_chunk_batch_spatial(
            self.params, self.cfg, {"tokens": self._ints(flat)[None, :]},
            {"layers": self.cache["layers"]}, pack_state)
        logits_host = logits.float().cpu().numpy()
        return {lane["slot"]: logits_host[lane["slot"]] for lane in lanes}

    # -- decode ---------------------------------------------------------------

    def _page_state(self, slots, tables, lengths) -> dict:
        n = self.topo.n_shards
        b, w = self.pcfg.max_batch, self.hot_width
        page = self.pcfg.page_size
        phys = np.full((n, b, w), -1, np.int32)
        logical = np.full((n, b, w), -1, np.int32)
        write_page = np.full((n, b), SCRATCH, np.int32)
        write_off = np.zeros((n, b), np.int32)

        growers = [slot for slot in slots
                   if int(lengths[slot]) // page == len(tables[slot])]
        grow_by_shard = [0] * n
        for slot in growers:
            grow_by_shard[self.topo.owner(len(tables[slot]))] += 1
        need_scores = (
            self.sparse_decode or self.kv_quant
            or any(self.topo.max_local_count(len(tables[s])) > w
                   for s in slots)
            or any(self.pools.free_pages(s) < grow_by_shard[s]
                   for s in range(n)))
        scores = self._pull_scores() if need_scores else None
        resident = [set() for _ in range(n)]     # local pids per shard
        hot_pids = [set() for _ in range(n)]
        pages_total = pages_hot = 0
        per_slot: dict[int, tuple[int, int]] = {}
        for slot in slots:
            table = tables[slot]
            length = int(lengths[slot])
            idx = length // page
            if idx == len(table):              # tail page full: grow
                try:
                    table.append(self.pools.extend(idx, scores))
                except ShardPoolExhausted as e:
                    raise NeedPages(slot, e.shard) from None
            cow = self.pools.ensure_owned(table, idx)
            if cow is not None:
                self._copy_page(*cow)
            slot_hot = 0
            for s in range(n):
                if self.sparse_decode:
                    ph, lg = self.pools.select_hot_sphere(
                        table, s, w, scores, radius=self.hot_radius)
                else:
                    ph, lg = self.pools.select_hot(table, s, w, scores)
                phys[s, slot] = ph
                logical[s, slot] = lg
                slot_hot += int((lg >= 0).sum())
                if self.kv_quant:
                    locals_, _ = self.pools.local_pages(table, s)
                    resident[s].update(p for p in locals_ if p >= 0)
                    hot_pids[s].update(int(p) for p in ph if p >= 0)
            pages_hot += slot_hot
            n_res = sum(1 for pid in table if pid >= 0)
            pages_total += n_res
            per_slot[slot] = (n_res, slot_hot)
            owner = self.topo.owner(idx)
            write_page[owner, slot] = table[idx]
            write_off[owner, slot] = length % page
        # shards whose hot sets are empty for the ENTIRE batch: K1's stats
        # form exits at once for them and the merge weighs them 0
        skipped = ([s for s in range(n) if not (logical[s] >= 0).any()]
                   if slots else [])
        for s in skipped:
            self.shard_skips[s] += 1
        self.decode_steps += 1
        self.decode_sparsity = {"pages_total": pages_total,
                                "pages_hot": pages_hot,
                                "shard_skips": len(skipped),
                                "per_slot": per_slot}
        out = {"phys": self._ints(phys), "logical": self._ints(logical),
               "write_page": self._ints(write_page),
               "write_off": self._ints(write_off)}
        if self.kv_quant:
            qmask = self._quantize_cold(resident, hot_pids, phys)
            if qmask.any():   # else the decode runs the stats form's fp lane
                out["qmask"] = torch.as_tensor(qmask, device=self.device)
        return out

    def _quantize_cold(self, resident: list, hot_pids: list,
                       phys: np.ndarray) -> np.ndarray:
        """Per-shard cold-page quantization + the step's [S, B, W] qmask
        (single-pool semantics per shard — see serving.paged)."""
        n = self.topo.n_shards
        to_q = [sorted(pid for pid in resident[s] - hot_pids[s]
                       if not self.pools.pools[s].quant.is_quant(pid))
                for s in range(n)]
        if any(to_q):
            wq = bucketing.bucket_count(max(len(t) for t in to_q),
                                        pow2=self.pcfg.bucket_pow2)
            qphys = np.full((n, wq), SCRATCH, np.int32)
            for s in range(n):
                qphys[s, :len(to_q[s])] = to_q[s]
            quant.quantize_pages_sharded(self.cache["layers"],
                                         self._ints(qphys).long())
            for s in range(n):
                for pid in to_q[s]:
                    self.pools.pools[s].quant.mark(pid)
        qmask = np.zeros(phys.shape, bool)
        for s in range(n):
            tracker = self.pools.pools[s].quant
            for i in range(phys.shape[1]):
                qmask[s, i] = [tracker.is_quant(int(p))
                               for p in phys[s, i]]
        return qmask

    @torch.no_grad()
    def decode_step(self, slots, tables, lengths):
        ps = self._page_state(slots, tables, lengths)  # may raise NeedPages
        self.cache["lengths"] = self._ints(lengths)
        self._decode_shapes.add((tuple(self.last_token.shape),
                                 tuple(ps["phys"].shape)))
        logits, self.cache = lm.decode_step_spatial(
            self.params, self.cfg, self.last_token, self.cache, ps)
        return logits

    def set_last_token(self, slot: int, tok: int) -> None:
        self.last_token[slot, 0] = tok

    def get_last_token(self, slot: int) -> int:
        return int(self.last_token[slot, 0])

    def commit_tokens(self, next_tokens) -> None:
        self.last_token = next_tokens[:, None].to(torch.int32)

    # -- shed / swap ----------------------------------------------------------

    def hot_logical(self, table) -> set[int]:
        """Union of every shard's DLZS hot selection (global indices)."""
        scores = self._pull_scores()
        hot: set[int] = set()
        for s in range(self.topo.n_shards):
            if self.sparse_decode:
                _, lg = self.pools.select_hot_sphere(
                    table, s, self.hot_width, scores,
                    radius=self.hot_radius)
            else:
                _, lg = self.pools.select_hot(
                    table, s, self.pcfg.hot_pages_local, scores)
            hot.update(int(j) for j in lg if j >= 0)
        return hot

    def gather_park(self, table, js):
        """Pull global pages ``js`` to the host in flat payload order, each
        from its owner shard's slab (the single-pool backend's payload
        layout exactly). With the int8 tier, the scales of pages whose
        flag is clear are sent as 0 (a recycled page keeps its last
        owner's scale on the device; the receiver reads a positive scale as
        "quantized")."""
        sh = self._ints([self.topo.owner(j) for j in js]).long()
        idx = self._ints([table[j] for j in js]).long()
        rows = tree_map(lambda pool: _to_host(pool[:, sh, idx]),
                        self.cache["layers"])
        if self.kv_quant:
            fp = [i for i, j in enumerate(js)
                  if not self.pools.pools[self.topo.owner(j)].quant
                  .is_quant(table[j])]
            for path, leaf in tree_items(rows):
                if path[-1] in ("k_scale", "v_scale"):
                    leaf[:, fp] = 0.0
        return rows

    def can_hold(self, park_js) -> bool:
        counts = [0] * self.topo.n_shards
        for j in park_js:
            counts[self.topo.owner(j)] += 1
        return all(self.pools.reclaimable(s) >= counts[s]
                   for s in range(self.topo.n_shards))

    def page_in_extend(self, park_js):
        counts = [0] * self.topo.n_shards
        for j in park_js:
            counts[self.topo.owner(j)] += 1
        scores = self._pull_scores() \
            if any(self.pools.free_pages(s) < counts[s]
                   for s in range(self.topo.n_shards)) else None

        def extend(j):
            s = self.topo.owner(j)
            return self.pools.allocs[s].extend(
                scores[s] if scores is not None else None)
        return extend

    def upload_park(self, rows, uploads) -> None:
        """Write flat payload rows back, each page into its owner shard's
        slab at its new local id, leaf by key path. A payload without the
        int8 tier zeroes these pages' tier rows (they read as fp); tier
        leaves this pool lacks are ignored."""
        sh = self._ints([self.topo.owner(j) for _, j, _ in uploads]).long()
        idx = self._ints([pid for _, _, pid in uploads]).long()
        pos = [p for p, _, _ in uploads]
        for path, pool in tree_items(self.cache["layers"]):
            r = rows
            for key in path:
                r = r.get(key) if path[-1] in quant.QUANT_KEYS else r[key]
                if r is None:
                    break
            if r is None:
                pool[:, sh, idx] = 0
            else:
                pool[:, sh, idx] = _to_device(r[:, pos], pool)
        if self.kv_quant:
            scale = quant.find_scale(rows)      # flat payload [L, n_park]
            if scale is not None:
                for p, j, pid in uploads:
                    if float(np.max(scale[:, p])) > 0.0:
                        self.pools.pools[self.topo.owner(j)].quant.mark(pid)

    # -- observability --------------------------------------------------------

    def page_accounting(self) -> dict:
        """Host-side census over every shard pool (obs.accounting) plus a
        per-shard breakdown. No device syncs."""
        tot = {"capacity": 0, "live": 0, "free": 0, "cached": 0,
               "shared": 0, "unique": 0, "quantized_live": 0,
               "quantize_events": 0}
        per_shard = []
        for s in range(self.topo.n_shards):
            pool = self.pools.pools[s]
            live = shared = q_live = 0
            for pid in range(1, pool.n_pages):
                r = pool.ref(pid)
                if r > 0:
                    live += 1
                    if r > 1:
                        shared += 1
                    if pool.quant.is_quant(pid):
                        q_live += 1
            row = {"shard": s, "capacity": pool.n_pages - 1, "live": live,
                   "free": pool.free_pages(),
                   "cached": len(pool.evictable()),
                   "shared": shared, "unique": live - shared,
                   "quantized_live": q_live,
                   "quantize_events": pool.quant.stats().quantize_events}
            per_shard.append(row)
            for k in tot:
                tot[k] += row[k]
        tot["per_shard"] = per_shard
        return tot

    def pool_refs(self) -> dict:
        """(shard, pid) -> refcount for every live page on every shard."""
        out = {}
        for s in range(self.topo.n_shards):
            pool = self.pools.pools[s]
            for pid in range(1, pool.n_pages):
                r = pool.ref(pid)
                if r > 0:
                    out[(s, pid)] = r
        return out

    def owner_of(self, j: int) -> int:
        return self.topo.owner(j)

    def export_page_scores(self, table, js) -> list[float]:
        """Per-page DLZS scores for a transfer payload, resolved on each
        page's owner shard (advisory: the importer recomputes)."""
        scores = self._pull_scores()
        return [float(scores[self.topo.owner(j), table[j]]) for j in js]

    @torch.no_grad()
    def audit_decode(self, slot: int, table, length: int):
        """Exact-attention audit probe, sequence-sharded form (obs.audit).

        Each shard gathers its FULL local resident slice of the slot and
        the per-page masses come back normalised over all shards
        (``lm.audit_decode_spatial``, which leaves the pool as it was), so
        summing any shard subset is exact. None at a page boundary — the
        sampler retries a later tick.
        """
        n = self.topo.n_shards
        page = self.pcfg.page_size
        idx = length // page
        if idx >= len(table) or table[idx] < 0:
            return None
        by_shard = [[j for j, pid in enumerate(table)
                     if pid >= 0 and self.topo.owner(j) == s]
                    for s in range(n)]
        n_res = sum(len(b) for b in by_shard)
        b = self.pcfg.max_batch
        w = bucketing.bucket_count(max(1, max(len(x) for x in by_shard)),
                                   pow2=self.pcfg.bucket_pow2)
        phys = np.full((n, b, w), -1, np.int32)
        logical = np.full((n, b, w), -1, np.int32)
        write_page = np.full((n, b), SCRATCH, np.int32)
        write_off = np.zeros((n, b), np.int32)
        for s in range(n):
            for i, j in enumerate(by_shard[s]):
                phys[s, slot, i] = table[j]
                logical[s, slot, i] = j
        owner = self.topo.owner(idx)
        write_page[owner, slot] = table[idx]
        write_off[owner, slot] = length % page
        ps = {"phys": self._ints(phys), "logical": self._ints(logical),
              "write_page": self._ints(write_page),
              "write_off": self._ints(write_off)}
        lengths_vec = np.zeros((b,), np.int32)
        lengths_vec[slot] = length
        cache = {"layers": self.cache["layers"],
                 "lengths": self._ints(lengths_vec)}
        out = lm.audit_decode_spatial(self.params, self.cfg,
                                      self.last_token, cache, ps
                                      ).cpu().numpy()   # [n, blk, R, B, W]
        n_layers = out.shape[1] * out.shape[2]
        mass_by_shard = [
            out[s].reshape(n_layers, b, w)[:, slot, :len(by_shard[s])]
            for s in range(n)]                # each [n_layers, n_res_s]

        # the hot selection the NEXT decode step would make, per shard
        scores = self._pull_scores()
        hot_js: set[int] = set()
        per_shard = []
        for s in range(n):
            if self.sparse_decode:
                _, lg = self.pools.select_hot_sphere(
                    table, s, self.hot_width, scores,
                    radius=self.hot_radius)
            else:
                _, lg = self.pools.select_hot(table, s, self.hot_width,
                                              scores)
            shard_hot = {int(j) for j in lg if j >= 0}
            hot_js |= shard_hot
            mass_s = float(mass_by_shard[s].sum()) / max(n_layers, 1)
            per_shard.append({
                "shard": s, "pages_resident": len(by_shard[s]),
                "pages_hot": len(shard_hot),
                "mass_share": mass_s,
                "skipped": len(shard_hot) == 0})

        mass = np.concatenate(mass_by_shard, axis=1)  # [n_layers, n_res]
        hot_mask = np.array([j in hot_js
                             for s in range(n) for j in by_shard[s]], bool)
        sl = metrics.page_scores_per_layer(
            tree_map(_fold, self.cache["layers"])).cpu().numpy()
        sl = sl.reshape(sl.shape[0], n, -1)           # [n_layers, S, P]
        scores_layers = np.concatenate(
            [sl[:, s][:, [table[j] for j in by_shard[s]]]
             for s in range(n)], axis=1).tolist()
        tot = np.maximum(mass.sum(axis=1), 1e-30)
        recall = mass[:, hot_mask].sum(axis=1) / tot
        return {"slot": slot, "length": length,
                "pages_resident": n_res,
                "pages_hot": len(hot_js),
                "hot_mask": hot_mask.tolist(),
                "mass_per_layer": mass.tolist(),
                "recall_per_layer": recall.tolist(),
                "scores_per_layer": scores_layers,
                "per_shard": per_shard}

    def stats(self) -> dict:
        pools = self.pools.stats()
        per_page = metrics.bytes_per_page(self._shard_slice(0))
        out = {
            "pools": pools,
            "n_shards": self.topo.n_shards,
            "bytes_per_page": per_page,
            "working_set_bytes": pools["peak_live"] * per_page,
            "slab_bytes": metrics.tree_bytes(self.cache["layers"]),
            "decode_compiles": len(self._decode_shapes),
            "prefill_batch_compiles": len(self._prefill_batch_shapes),
            "hot_width": self.hot_width,
            "decode_steps": self.decode_steps,
            "shard_skips": list(self.shard_skips),
        }
        if self.kv_quant:
            base, tier = quant.split_quant(self._shard_slice(0))
            fp_pp = metrics.bytes_per_page(base)
            q_pp = metrics.bytes_per_page(tier)
            acct = self.page_accounting()
            frac = acct["quantized_live"] / max(acct["live"], 1)
            blended = max((1 - frac) * fp_pp + frac * q_pp, 1.0)
            out["kv_quant"] = {
                "pages_quantized_live": acct["quantized_live"],
                "quantize_events": acct["quantize_events"],
                "bytes_per_page_fp": fp_pp,
                "bytes_per_page_int8": q_pp,
                "effective_capacity_pages": int(
                    pools["capacity"] * fp_pp / blended),
            }
        return out


class SpatialServingEngine(EngineCore):
    """The sequence-sharded serving engine: ``SpatialBackend`` under the
    shared ``EngineCore`` executor. Thin by design — every scheduler-
    visible behavior (including lazy cold-page shedding) lives in
    engine_core.py and is identical to the paged engine's."""

    def __init__(self, model_cfg, params, scfg_engine: SpatialEngineCfg,
                 scfg: Optional[SchedulerCfg] = None,
                 generator: Optional[torch.Generator] = None):
        scfg = scfg or SchedulerCfg()
        super().__init__(SpatialBackend(model_cfg, params, scfg_engine,
                                        scfg), scfg, generator)

    @property
    def pcfg(self) -> SpatialEngineCfg:
        return self.backend.pcfg

    @property
    def pools(self) -> ShardedPagePools:
        return self.backend.pools

    @property
    def topo(self) -> ShardTopology:
        return self.backend.topo

    @property
    def mesh(self) -> torch.device:
        return self.backend.mesh

    @property
    def last_token(self):
        return self.backend.last_token

    @property
    def cache(self):
        return self.backend.cache
