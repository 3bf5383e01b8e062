"""Single-pool serving backend on the paged KV cache — PyTorch port of
``repro.serving.paged``.

``PagedBackend`` is the device driver ``EngineCore`` calls: torch pool
slabs [L, n_pages, page, n_kv, dh] on the serving device, the model's
prefill / chunk / batched-chunk / decode functions, and the single-pool
allocation and prefix index. ``PagedServingEngine`` composes it with the
shared ``EngineCore`` executor.

Where the reference jits each step with donated slabs, the port runs the
same functions eagerly and updates the slabs IN PLACE (index assignment):
one pool lives on the device, never a second copy. Decode shapes stay
fixed at [max_batch, hot width], as the reference's one decode compile
requires; ``stats()`` reports how many distinct decode and batched-prefill
shapes ran (``decode_compiles`` / ``prefill_batch_compiles``, each the
compile count the reference would pay and the CUDA-graph count a later
capture would need).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.kvcache import (SCRATCH, PagePool, PagedAllocator,
                                 PoolExhausted, bucketing, metrics, quant)
from repro_torch.models import lm
from repro_torch.obs import NULL_TELEMETRY
from repro_torch.serving.engine_core import EngineCore
from repro_torch.serving.scheduler import (NeedPages, SchedulerCfg,
                                           resolve_prefill_tokens)
from repro_torch.tree import tree_items, tree_map

__all__ = ["PagedEngineCfg", "PagedBackend", "PagedServingEngine"]


@dataclasses.dataclass(frozen=True)
class PagedEngineCfg:
    max_batch: int = 8
    page_size: int = 16
    n_pages: int = 256           # pool capacity (page 0 is scratch)
    hot_pages: int = 16          # W: pages gathered per decode step
    recent_pages: int = 2        # newest pages always hot (incl. write page)
    eos_id: int = 1
    greedy: bool = True
    temperature: float = 1.0
    bucket_pow2: bool = True     # prompt buckets: pow2 page counts
    share_prefixes: bool = True
    batch_past_pages: Optional[int] = None
    # Past-page gather width of the BATCHED chunk-prefill dispatch. None
    # sizes it to the whole pool (always safe, but every batched prefill's
    # score tensor is then pool-sized); set it to the largest request page
    # count you serve — submit() rejects requests that could not fit.


def _to_host(t: torch.Tensor) -> np.ndarray:
    """Device rows -> host numpy (bf16 travels as its int16 bit pattern:
    numpy has no bfloat16)."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().numpy()


def _to_device(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """Host rows -> ``like``'s device and dtype. bf16 arrives as its int16
    bits, or as a numpy bfloat16 (``ml_dtypes``) array, read as bits."""
    if arr.dtype.name == "bfloat16":
        arr = arr.view(np.int16)
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(like.device)
    return t.view(torch.bfloat16) if like.dtype == torch.bfloat16 \
        else t.to(like.dtype)


class PagedBackend:
    """Single-pool ``engine_core.Backend`` implementation."""

    def __init__(self, model_cfg, params, pcfg: PagedEngineCfg,
                 scfg: SchedulerCfg):
        if any(blk.kind != "attn" for blk in model_cfg.pattern):
            raise ValueError("paged engine supports attention-only patterns")
        if model_cfg.enc_layers or not model_cfg.causal:
            raise ValueError("paged engine needs a causal decoder-only model")
        if scfg.kv_quant not in (None, "int8"):
            raise ValueError(
                f"kv_quant={scfg.kv_quant!r}: choose None or 'int8'")
        self.cfg = model_cfg
        self.pcfg = pcfg
        self.params = params
        self.device = params["embed"].device

        # protocol facts EngineCore reads
        self.page_size = pcfg.page_size
        self.max_batch = pcfg.max_batch
        self.eos_id = pcfg.eos_id
        self.greedy = pcfg.greedy
        self.temperature = pcfg.temperature
        self.bucket_pow2 = pcfg.bucket_pow2
        self.keep_recent = max(1, pcfg.recent_pages)

        # decode-time DLZS sparsity: bound the per-sequence gather at the
        # sphere-rule hot width, fixed at init ([max_batch, hot_width])
        self.sparse_decode = scfg.decode_hot_width is not None
        self.hot_width = (min(pcfg.hot_pages, scfg.decode_hot_width)
                          if self.sparse_decode else pcfg.hot_pages)
        self.hot_radius = scfg.decode_hot_radius
        self.kv_quant = scfg.kv_quant == "int8"
        self.decode_sparsity = None  # telemetry dict, set per decode step

        # Prefix sharing is exact only if a full page never splits a STAR
        # prefill q-tile (tile selection mixes rows within a tile).
        self.share = pcfg.share_prefixes and (
            model_cfg.star is None
            or pcfg.page_size % model_cfg.star.block_q == 0)
        if (model_cfg.star is not None
                and scfg.chunk_pages is not None
                and (scfg.chunk_pages * pcfg.page_size)
                % model_cfg.star.block_q != 0):
            raise ValueError(
                "chunk_pages * page_size must be a multiple of the STAR "
                "q-tile (block_q) so chunk boundaries stay tile-aligned")

        self.pool = PagePool(pcfg.n_pages, pcfg.page_size)
        self.alloc = PagedAllocator(self.pool,
                                    recent_pages=pcfg.recent_pages)
        self.tel = NULL_TELEMETRY    # shared via EngineCore.attach_telemetry

        # batched varlen chunk prefill: fixed flat-buffer width + fixed
        # past-gather window => one dispatch shape
        max_tokens = resolve_prefill_tokens(scfg, pcfg.page_size)
        self.batched = max_tokens is not None
        self.budget_tokens = self.batch_wp = None
        if self.batched:
            self.budget_tokens = bucketing.budget_tokens(
                max_tokens, pcfg.page_size, scfg.chunk_pages,
                pow2=pcfg.bucket_pow2)
            self.batch_wp = bucketing.bucket_count(
                pcfg.batch_past_pages or pcfg.n_pages - 1,
                pow2=pcfg.bucket_pow2)
        self._decode_shapes: set = set()
        self._prefill_batch_shapes: set = set()

        # Pool slabs from a one-page probe prefill: every prefill cache
        # leaf [L, 1, page, nkv, dh] becomes a slab [L, n_pages, page, ...].
        with torch.no_grad():
            _, cache_one = lm.prefill(
                params, model_cfg,
                {"tokens": self._ints(np.zeros((1, pcfg.page_size)))},
                last_index=self._ints([0]))
        layers = tree_map(
            lambda leaf: torch.zeros((leaf.shape[0], pcfg.n_pages)
                                     + tuple(leaf.shape[2:]),
                                     dtype=leaf.dtype, device=self.device),
            cache_one["layers"])
        if self.kv_quant:
            # the int8 cold tier rides IN the cache tree, so swap and
            # transfer payloads carry its rows and scales with the fp ones
            layers = quant.add_quant_slabs(layers)
        self.cache = {"layers": layers,
                      "lengths": self._ints(np.zeros((pcfg.max_batch,)))}
        self.last_token = self._ints(np.zeros((pcfg.max_batch, 1)))
        # per-page byte prices (shape-only): the full tree row a swap
        # payload carries vs the K/V rows a decode gather reads
        self.page_bytes_full = metrics.bytes_per_page(self.cache["layers"])
        self.page_bytes_gather = metrics.gather_bytes_per_page(
            self.cache["layers"])
        self.page_bytes_int8 = metrics.quant_bytes_per_page(
            self.cache["layers"])

    def _ints(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr), dtype=torch.int32,
                               device=self.device)

    # -- in-place pool updates (the reference's donated jits) ---------------

    def _slabs(self):
        return [leaf for _, leaf in tree_items(self.cache["layers"])]

    def _scatter(self, one_layers, phys: np.ndarray) -> None:
        """Write prefilled rows [L, 1, T_pad, ...] into pool pages
        ``phys`` (padding and shared pages target the scratch page). The
        int8 tier is left as it is: fresh pages are fp until they leave
        the DLZS hot set."""
        idx = self._ints(phys).long()
        base, _ = quant.split_quant(self.cache["layers"])
        for (path, pool), (_, one) in zip(tree_items(base),
                                          tree_items(one_layers)):
            rows = one[:, 0]
            rows = rows.reshape(rows.shape[0], -1, self.page_size,
                                *rows.shape[2:])
            pool[:, idx] = rows.to(pool.dtype)

    def _copy_page(self, src: int, dst: int) -> None:
        """COW: duplicate physical page ``src`` into ``dst`` (all layers)."""
        for pool in self._slabs():
            pool[:, dst] = pool[:, src]

    def _pull_scores(self) -> np.ndarray:
        with torch.no_grad():
            return metrics.page_scores(self.cache["layers"]).cpu().numpy()

    def export_page_scores(self, table, js) -> list[float]:
        """Per-page DLZS scores for a transfer payload (advisory: the
        importer recomputes scores from the uploaded page content)."""
        scores = self._pull_scores()
        return [float(scores[table[j]]) for j in js]

    # -- admission ------------------------------------------------------------

    def check_capacity(self, rid: int, total: int, need: int) -> None:
        if need > self.pool.n_pages - 1:
            raise ValueError(
                f"request {rid}: {total} tokens needs {need} pages; "
                f"pool holds {self.pool.n_pages - 1}")
        if self.batched and need - 1 > self.batch_wp:
            raise ValueError(
                f"request {rid}: {need} pages exceeds the batched "
                f"chunk-prefill past window ({self.batch_wp} pages); "
                f"raise PagedEngineCfg.batch_past_pages")

    # -- pool primitives ------------------------------------------------------

    def alloc_chunk(self, pf, start_page: int, n_need: int
                    ) -> tuple[list[int], list[int], bool]:
        scores = (self._pull_scores()
                  if self.pool.free_pages() < n_need else None)
        pages, fresh, _, sharing = self.alloc.admit_chunk(
            pf.toks if pf.toks is not None else pf.prompt,
            start_page, n_need, scores, sharing=pf.sharing)
        fresh_set = set(fresh)
        fresh_globals = [start_page + i for i, pid in enumerate(pages)
                         if pid in fresh_set]
        return pages, fresh_globals, sharing

    def release_pages(self, pages: list[int], start_global: int) -> None:
        self.alloc.release(pages)

    def release_table(self, table: list[int]) -> None:
        self.alloc.release([pid for pid in table if pid >= 0])

    def lookup_prefix(self, g: int, key: tuple) -> Optional[int]:
        return self.pool.lookup(key)

    def register_prefix(self, g: int, key: tuple, pid: int) -> None:
        self.pool.register(key, pid)

    def decref_page(self, g: int, pid: int) -> None:
        self.pool.decref(pid)

    def forget_prefix(self, g: int, pid: int) -> None:
        self.pool.forget(pid)

    def register_prompt_pages(self, toks, table, fresh_globals,
                              start_page: int) -> None:
        page = self.page_size
        for g in fresh_globals:
            end = (g + 1) * page
            if end <= len(toks):
                self.pool.register(toks[:end], table[g])

    def ref_of(self, table, j: int) -> int:
        return self.pool.ref(table[j])

    def held_pages(self, table, shard=None) -> int:
        """Pages preempting this slot would actually FREE (ref-1 pages
        still on the device)."""
        return sum(1 for pid in table
                   if pid >= 0 and self.pool.ref(pid) == 1)

    def page_on_shard(self, j: int, shard=None) -> bool:
        return True

    # -- prefill dispatch -----------------------------------------------------

    @torch.no_grad()
    def dispatch_chunk(self, pf, table, start, end, width, last_idx,
                       pages, fresh_globals) -> np.ndarray:
        page = self.page_size
        start_page = start // page
        toks = bucketing.pad_tokens(pf.prompt[start:end], width)
        batch = {"tokens": self._ints(toks)[None, :]}
        if start == 0:
            logits, cache_one = lm.prefill(self.params, self.cfg, batch,
                                           last_index=self._ints([last_idx]))
        else:
            wp = bucketing.bucket_count(start_page,
                                        pow2=self.pcfg.bucket_pow2)
            past_phys = np.full((1, wp), -1, np.int32)
            past_phys[0, :start_page] = table[:start_page]
            past_logical = np.full((1, wp), -1, np.int32)
            past_logical[0, :start_page] = np.arange(start_page)
            chunk_state = {
                "past_phys": self._ints(past_phys),
                "past_logical": self._ints(past_logical),
                "past_len": self._ints([start]),
                "last_index": self._ints([last_idx])}
            logits, cache_one = lm.prefill_chunk_paged(
                self.params, self.cfg, batch,
                {"layers": self.cache["layers"]}, chunk_state)
        # chunk page j -> its fresh pool page; shared pages (content
        # identical by construction) and bucket padding -> scratch
        fresh_set = set(fresh_globals)
        phys = np.full((width // page,), SCRATCH, np.int32)
        for j, pid in enumerate(pages):
            if start_page + j in fresh_set:
                phys[j] = pid
        self._scatter(cache_one["layers"], phys)
        return logits[0].float().cpu().numpy()

    def arena_cost(self, past_pages: int) -> list[int]:
        return [past_pages]

    @torch.no_grad()
    def dispatch_wave(self, flat, seg, pos, past_len, last_index,
                      lanes) -> dict[int, np.ndarray]:
        """Fill the single-pool past arena + scatter targets for one wave
        and run the batched varlen dispatch."""
        page = self.page_size
        phys_sc = np.full((self.budget_tokens // page,), SCRATCH, np.int32)
        past_phys = np.full((self.batch_wp,), -1, np.int32)
        past_lane = np.full((self.batch_wp,), -1, np.int32)
        past_logical = np.full((self.batch_wp,), -1, np.int32)
        arena = 0
        for lane in lanes:
            slot, table = lane["slot"], lane["table"]
            sp = lane["start_page"]
            past_phys[arena:arena + sp] = table[:sp]
            past_lane[arena:arena + sp] = slot
            past_logical[arena:arena + sp] = np.arange(sp)
            arena += sp
            base = lane["base"]
            for j, pid in enumerate(lane["pages"]):
                if sp + j in lane["fresh"]:
                    phys_sc[base + j] = pid
        if self.tel.enabled:
            self.tel.tracer.instant("arena.fill", used=int(arena),
                                    cap=self.batch_wp,
                                    lanes=len(lanes))
            self.tel.metrics.gauge(
                "engine_arena_pages_used",
                "past-arena slots filled by the last wave").set(int(arena))
        pack_state = {
            "seg_ids": self._ints(seg),
            "positions": self._ints(pos),
            "past_phys": self._ints(past_phys),
            "past_lane": self._ints(past_lane),
            "past_logical": self._ints(past_logical),
            "past_len": self._ints(past_len),
            "last_index": self._ints(last_index)}
        self._prefill_batch_shapes.add((len(flat), self.batch_wp,
                                        len(past_len)))
        logits, cache_flat = lm.prefill_chunk_batch_paged(
            self.params, self.cfg, {"tokens": self._ints(flat)[None, :]},
            {"layers": self.cache["layers"]}, pack_state)
        self._scatter(cache_flat["layers"], phys_sc)
        logits_host = logits.float().cpu().numpy()
        return {lane["slot"]: logits_host[lane["slot"]] for lane in lanes}

    # -- decode ---------------------------------------------------------------

    def _page_state(self, slots, tables, lengths) -> dict:
        """Assemble block-table rows + write coordinates for this step."""
        b, w = self.pcfg.max_batch, self.hot_width
        page = self.pcfg.page_size
        phys = np.full((b, w), -1, np.int32)
        logical = np.full((b, w), -1, np.int32)
        write_page = np.full((b,), SCRATCH, np.int32)
        write_off = np.zeros((b,), np.int32)

        # scores rank cold pages once a table exceeds W, drive eviction
        # when the free list cannot cover every grower, and feed the
        # bounded sphere selection every step
        growers = sum(1 for s in slots
                      if int(lengths[s]) // page == len(tables[s]))
        need_scores = (self.sparse_decode or self.kv_quant
                       or any(len(tables[s]) > w for s in slots)
                       or self.pool.free_pages() < growers)
        scores = self._pull_scores() if need_scores else None
        resident: set[int] = set()
        hot_pids: set[int] = set()
        pages_total = pages_hot = 0
        per_slot: dict[int, tuple[int, int]] = {}
        for slot in slots:
            table = tables[slot]
            length = int(lengths[slot])
            idx = length // page
            if idx == len(table):          # tail page full: grow
                try:
                    table.append(self.alloc.extend(scores))
                except PoolExhausted:
                    raise NeedPages(slot) from None
            cow = self.alloc.ensure_owned(table, idx)
            if cow is not None:            # COW before the write
                self._copy_page(*cow)
            if self.sparse_decode:
                ph, lg = self.alloc.select_hot_sphere(
                    table, w, scores, radius=self.hot_radius)
            else:
                ph, lg = self.alloc.select_hot(table, w, scores)
            phys[slot] = ph
            logical[slot] = lg
            write_page[slot] = table[idx]
            write_off[slot] = length % page
            n_res = sum(1 for pid in table if pid >= 0)
            n_hot = int((lg >= 0).sum())
            pages_total += n_res
            pages_hot += n_hot
            per_slot[slot] = (n_res, n_hot)
            if self.kv_quant:
                resident.update(pid for pid in table if pid >= 0)
                hot_pids.update(int(p) for p in ph if p >= 0)
        self.decode_sparsity = {"pages_total": pages_total,
                                "pages_hot": pages_hot,
                                "shard_skips": 0,
                                "per_slot": per_slot}
        out = {"phys": self._ints(phys), "logical": self._ints(logical),
               "write_page": self._ints(write_page),
               "write_off": self._ints(write_off)}
        if self.kv_quant:
            qmask = self._quantize_cold(resident, hot_pids, phys)
            if qmask.any():   # else the decode runs K1's fp form
                out["qmask"] = torch.as_tensor(qmask, device=self.device)
        return out

    def _quantize_cold(self, resident: set, hot_pids: set,
                       phys: np.ndarray) -> np.ndarray:
        """Quantize the pages that left the DLZS hot set and build the
        step's [B, W] qmask. A page hot for ANY sequence stays fp; a page
        already quantized that turns hot again reads its int8 copy (the
        tier is a one-way door until the page is freed), which is what
        ``qmask`` marks."""
        tracker = self.pool.quant
        to_q = sorted(pid for pid in resident - hot_pids
                      if not tracker.is_quant(pid))
        if to_q:
            quant.quantize_pages(self.cache["layers"],
                                 self._ints(to_q).long())
            for pid in to_q:
                tracker.mark(pid)
        qmask = np.zeros(phys.shape, bool)
        for i in range(phys.shape[0]):
            qmask[i] = [tracker.is_quant(int(p)) for p in phys[i]]
        return qmask

    @torch.no_grad()
    def decode_step(self, slots, tables, lengths):
        ps = self._page_state(slots, tables, lengths)  # may raise NeedPages
        self.cache["lengths"] = self._ints(lengths)
        self._decode_shapes.add((tuple(self.last_token.shape),
                                 tuple(ps["phys"].shape)))
        logits, self.cache = lm.decode_step_paged(
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
        scores = self._pull_scores()
        if self.sparse_decode:
            _, hot = self.alloc.select_hot_sphere(
                table, self.hot_width, scores, radius=self.hot_radius)
        else:
            _, hot = self.alloc.select_hot(table, self.pcfg.hot_pages,
                                           scores)
        return {int(j) for j in hot if j >= 0}

    def gather_park(self, table, js):
        """Pull pages ``js`` to the host (flat payload order). With the
        int8 tier, the scales of pages whose flag is clear are sent as 0:
        a recycled page keeps its last owner's scale on the device, and
        the receiver reads a positive scale as "quantized"."""
        pids = [table[j] for j in js]
        idx = self._ints(pids).long()
        rows = tree_map(lambda pool: _to_host(pool[:, idx]),
                        self.cache["layers"])
        if self.kv_quant:
            fp = [i for i, pid in enumerate(pids)
                  if not self.pool.quant.is_quant(pid)]
            for path, leaf in tree_items(rows):
                if path[-1] in ("k_scale", "v_scale"):
                    leaf[:, fp] = 0.0
        return rows

    def can_hold(self, park_js) -> bool:
        return (self.pool.free_pages() + len(self.pool.evictable())
                >= len(park_js))

    def page_in_extend(self, park_js):
        scores = (self._pull_scores()
                  if self.pool.free_pages() < len(park_js) else None)
        return lambda j: self.alloc.extend(scores)

    def upload_park(self, rows, uploads) -> None:
        """Write payload rows back at new physical ids, leaf by key path
        (a payload's tree may list its keys in another order). A payload
        from an instance without the int8 tier has no tier leaves: those
        pages get zero codes and scales here and read as fp; tier leaves
        this pool lacks are ignored (the fp rows are kept beside them)."""
        idx = self._ints([pid for _, _, pid in uploads]).long()
        pos = [p for p, _, _ in uploads]
        for path, pool in tree_items(self.cache["layers"]):
            r = rows
            for key in path:
                r = r.get(key) if path[-1] in quant.QUANT_KEYS else r[key]
                if r is None:
                    break
            if r is None:
                pool[:, idx] = 0
            else:
                pool[:, idx] = _to_device(r[:, pos], pool)
        if self.kv_quant:
            self._restore_quant_flags(rows, uploads)

    def _restore_quant_flags(self, rows, uploads) -> None:
        """Swap-in wrote the payload's int8-tier rows back with the fp
        rows; re-derive which restored pages were quantized from its
        per-page scales (a written scale is positive, an fp-only page
        carries the zeroed slab row)."""
        scale = quant.find_scale(rows)
        if scale is None:
            return
        for pos, _, pid in uploads:
            if float(np.max(scale[:, pos])) > 0.0:
                self.pool.quant.mark(pid)

    # -- observability --------------------------------------------------------

    def page_accounting(self) -> dict:
        """Host-side pool census for obs.accounting (no device syncs)."""
        pool = self.pool
        live = shared = q_live = 0
        for pid in range(1, pool.n_pages):
            r = pool.ref(pid)
            if r > 0:
                live += 1
                if r > 1:
                    shared += 1
                if pool.quant.is_quant(pid):
                    q_live += 1
        return {"capacity": pool.n_pages - 1, "live": live,
                "free": pool.free_pages(), "cached": len(pool.evictable()),
                "shared": shared, "unique": live - shared,
                "quantized_live": q_live,
                "quantize_events": pool.quant.stats().quantize_events,
                "per_shard": None}

    def pool_refs(self) -> dict:
        """(shard, pid) -> refcount for every referenced page."""
        return {(0, pid): self.pool.ref(pid)
                for pid in range(1, self.pool.n_pages)
                if self.pool.ref(pid) > 0}

    def owner_of(self, j: int) -> int:
        return 0

    @torch.no_grad()
    def audit_decode(self, slot: int, table, length: int):
        """Exact-attention audit probe for one live decode slot (obs.audit).

        Runs the decode step over the slot's FULL resident page set with
        the ``audit`` flag, so every layer reports the softmax mass each
        page receives. The decode writes the probe token's K/V rows in
        place; those rows are saved first and restored after, so the live
        pool is left as it was (the reference runs the probe on a
        non-donated copy). Returns None at a page boundary."""
        page = self.pcfg.page_size
        idx = length // page
        if idx >= len(table) or table[idx] < 0:
            return None
        resident = [(j, pid) for j, pid in enumerate(table) if pid >= 0]
        b = self.pcfg.max_batch
        w = bucketing.bucket_count(len(resident), pow2=self.pcfg.bucket_pow2)
        phys = np.full((b, w), -1, np.int32)
        logical = np.full((b, w), -1, np.int32)
        write_page = np.full((b,), SCRATCH, np.int32)
        write_off = np.zeros((b,), np.int32)
        for i, (j, pid) in enumerate(resident):
            phys[slot, i] = pid
            logical[slot, i] = j
        write_page[slot] = table[idx]
        write_off[slot] = length % page
        ps = {"phys": self._ints(phys), "logical": self._ints(logical),
              "write_page": self._ints(write_page),
              "write_off": self._ints(write_off), "audit": True}
        lengths_vec = np.zeros((b,), np.int32)
        lengths_vec[slot] = length
        rows_at = (ps["write_page"].long(), ps["write_off"].long())
        saved = [(pool, pool[:, rows_at[0], rows_at[1]].clone())
                 for pool in self._slabs()]
        _, out_cache = lm.decode_step_paged(
            self.params, self.cfg, self.last_token,
            {"layers": self.cache["layers"],
             "lengths": self._ints(lengths_vec)}, ps)
        for pool, rows in saved:
            pool[:, rows_at[0], rows_at[1]] = rows
        mass = np.concatenate(
            [leaf[:, slot, :len(resident)].cpu().numpy()
             for path, leaf in tree_items(out_cache["layers"])
             if path[-1] == "audit_mass"], axis=0)   # [n_layers, n_res]

        # the hot set the NEXT decode step would gather
        scores = self._pull_scores()
        if self.sparse_decode:
            _, lg = self.alloc.select_hot_sphere(
                table, self.hot_width, scores, radius=self.hot_radius)
        else:
            _, lg = self.alloc.select_hot(table, self.hot_width, scores)
        hot_js = {int(j) for j in lg if j >= 0}
        hot_mask = np.array([j in hot_js for j, _ in resident], bool)

        pids = [pid for _, pid in resident]
        sl = metrics.page_scores_per_layer(self.cache["layers"]).cpu()
        scores_layers = sl[:, pids].numpy().tolist()
        tot = np.maximum(mass.sum(axis=1), 1e-30)
        recall = mass[:, hot_mask].sum(axis=1) / tot
        return {"slot": slot, "length": length,
                "pages_resident": len(resident),
                "pages_hot": len(hot_js),
                "hot_mask": hot_mask.tolist(),
                "mass_per_layer": mass.tolist(),
                "recall_per_layer": recall.tolist(),
                "scores_per_layer": scores_layers,
                "per_shard": None}

    def stats(self) -> dict:
        pool = self.pool.stats()
        per_page = metrics.bytes_per_page(self.cache["layers"])
        out = {
            "pool": pool,
            "bytes_per_page": per_page,
            "working_set_bytes": pool.peak_live * per_page,
            "slab_bytes": metrics.tree_bytes(self.cache["layers"]),
            "decode_compiles": len(self._decode_shapes),
            "prefill_batch_compiles": len(self._prefill_batch_shapes),
            "hot_width": self.hot_width,
        }
        if self.kv_quant:
            base, tier = quant.split_quant(self.cache["layers"])
            fp_pp = metrics.bytes_per_page(base)
            q_pp = metrics.bytes_per_page(tier)
            acct = self.page_accounting()
            q_live = acct["quantized_live"]
            frac = q_live / max(acct["live"], 1)
            blended = max((1 - frac) * fp_pp + frac * q_pp, 1.0)
            out["kv_quant"] = {
                "pages_quantized_live": q_live,
                "quantize_events": acct["quantize_events"],
                "bytes_per_page_fp": fp_pp,
                "bytes_per_page_int8": q_pp,
                # pages the same byte budget would hold if cold pages
                # were stored int8-only, at the current hot/cold mix
                "effective_capacity_pages": int(pool.capacity * fp_pp
                                                / blended),
            }
        return out


class PagedServingEngine(EngineCore):
    """The single-pool serving engine: ``PagedBackend`` under the shared
    ``EngineCore`` executor. Runs on the device its params live on."""

    def __init__(self, model_cfg, params, pcfg: PagedEngineCfg,
                 scfg: Optional[SchedulerCfg] = None,
                 generator: Optional[torch.Generator] = None):
        scfg = scfg or SchedulerCfg()
        super().__init__(PagedBackend(model_cfg, params, pcfg, scfg),
                         scfg, generator)

    @property
    def pcfg(self) -> PagedEngineCfg:
        return self.backend.pcfg

    @property
    def pool(self) -> PagePool:
        return self.backend.pool

    @property
    def alloc(self) -> PagedAllocator:
        return self.backend.alloc

    @property
    def last_token(self):
        return self.backend.last_token

    @property
    def cache(self):
        return self.backend.cache
