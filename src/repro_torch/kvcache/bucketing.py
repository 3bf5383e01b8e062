"""Prompt-length bucketing + chunk math for recompile-free admission.

Prefill compiles per input shape. Admitting raw prompt lengths would compile
once per distinct length; padding every prompt to one engine-wide maximum
wastes prefill FLOPs quadratically. The middle ground: round the prompt up
to a whole number of KV pages, then (optionally) to a power-of-two page
count, so the number of distinct prefill shapes is O(log max_len) and every
K/V row that matters lands page-aligned for the pool scatter.

Padding is safe for causal models: K/V rows at positions < T depend only on
tokens <= their position, so the junk tail changes nothing that is kept.
(For tile-granular STAR prefill the selection of a boundary q-tile can see
junk rows — a selection-noise effect the engine documents; exactness holds
whenever T is already bucket-aligned.)

Chunked prefill (``chunk_spans``) slices a prompt into page-aligned chunks
of at most ``chunk_pages`` pages so long prompts prefill incrementally,
interleaved with decode steps. Every non-final chunk is exactly
``chunk_pages`` pages wide (one compiled shape); the final remainder is
bucketed like a monolithic prompt, so the set of compiled chunk widths
stays O(log chunk_pages) and the set of past-page gather widths
(``bucket_count``) stays O(log max_pages).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def bucket_pages(n_tokens: int, page_size: int, *, pow2: bool = True) -> int:
    """Number of pages the padded prompt occupies."""
    pages = -(-max(n_tokens, 1) // page_size)
    if pow2:
        p = 1
        while p < pages:
            p *= 2
        pages = p
    return pages


def bucket_len(n_tokens: int, page_size: int, *, pow2: bool = True) -> int:
    return bucket_pages(n_tokens, page_size, pow2=pow2) * page_size


def pad_tokens(tokens: np.ndarray, padded_len: int) -> np.ndarray:
    """Right-pad a [T] int token array to ``padded_len`` with zeros."""
    t = len(tokens)
    assert t <= padded_len, (t, padded_len)
    out = np.zeros((padded_len,), dtype=np.int32)
    out[:t] = tokens
    return out


def bucket_count(n: int, *, pow2: bool = True, lo: int = 1) -> int:
    """Round a plain count (e.g. past pages to gather) up to a bucket."""
    n = max(n, lo)
    if not pow2:
        return n
    p = lo
    while p < n:
        p *= 2
    return p


def budget_tokens(prefill_tokens: int, page_size: int,
                  chunk_pages: int, *, pow2: bool = True) -> int:
    """Fixed flat-buffer width of a batched chunk-prefill dispatch.

    The buffer must be a whole number of pages (chunk K/V rows scatter
    onto pool pages) and at least one chunk wide — the widest single
    chunk is ``bucket_len(chunk_pages * page_size)``, which exceeds
    ``chunk_pages * page_size`` itself when ``chunk_pages`` is not a
    power of two (a bucketed final remainder can round past it). Fixing
    the width here is what keeps the batched prefill at ONE compilation
    regardless of how chunks pack each tick.
    """
    floor = bucket_len(chunk_pages * page_size, page_size, pow2=pow2)
    width = -(-prefill_tokens // page_size) * page_size
    return max(width, floor)


def pack_budget(widths: list, budget: int) -> list[tuple]:
    """Pack candidates' chunk widths into one dispatch token budget.

    ``widths`` is ``[(key, [w0, w1, ...]), ...]`` in priority order,
    each entry listing the candidate's REMAINING chunk widths (w0 next).
    Returns ``[(key, n_chunks)]``: how many CONSECUTIVE chunks each
    packed candidate advances this dispatch — consecutive chunks of one
    sequence concatenate into one larger varlen span, so leftover budget
    deepens sequences instead of going idle.

    Two-stage policy: a strict-priority first sweep takes one chunk per
    candidate in order, stopping at the first non-fit (nothing bypasses
    a starved candidate — cross-tick aging handles its fairness); then
    round-robin deepening sweeps hand every packed candidate one more
    chunk while the budget lasts. The head candidate is always taken
    even when its first chunk alone exceeds ``budget`` — the dispatch
    buffer is sized to hold any single chunk (``budget_tokens``).
    """
    counts: dict = {}
    used = 0
    packed: list = []
    for key, ws in widths:               # sweep 1: strict priority
        if not ws:
            continue
        if packed and used + ws[0] > budget:
            break
        counts[key] = 1
        used += ws[0]
        packed.append((key, ws))
    progress = True
    while progress:                      # deepening: round-robin
        progress = False
        for key, ws in packed:
            k = counts[key]
            if k < len(ws) and used + ws[k] <= budget:
                counts[key] = k + 1
                used += ws[k]
                progress = True
    return [(key, counts[key]) for key, _ in packed]


def chunk_spans(n_tokens: int, page_size: int,
                chunk_pages: Optional[int], *, pow2: bool = True
                ) -> list[tuple[int, int, int]]:
    """Split a prompt into page-aligned prefill chunks.

    Returns ``[(start, end, width), ...]`` in token units: the chunk covers
    prompt tokens ``[start, end)`` and is computed at padded width
    ``width`` (a whole number of pages). ``chunk_pages=None`` disables
    chunking — one span covering the whole prompt at its bucketed width,
    which is exactly the monolithic prefill the engine always did.
    Every ``start`` is a page multiple, so chunk K/V rows scatter onto
    whole pool pages.
    """
    if n_tokens <= 0:
        raise ValueError(f"empty prompt (n_tokens={n_tokens})")
    if chunk_pages is not None and chunk_pages < 1:
        raise ValueError(f"chunk_pages must be >= 1 or None, "
                         f"got {chunk_pages}")
    if chunk_pages is None or n_tokens <= chunk_pages * page_size:
        return [(0, n_tokens, bucket_len(n_tokens, page_size, pow2=pow2))]
    c_tok = chunk_pages * page_size
    spans = []
    start = 0
    while start < n_tokens:
        end = min(start + c_tok, n_tokens)
        width = c_tok if end - start == c_tok else \
            bucket_len(end - start, page_size, pow2=pow2)
        spans.append((start, end, width))
        start = end
    return spans
