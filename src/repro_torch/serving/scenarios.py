"""Reusable serving workloads: the port's own copy of
``repro.serving.scenarios`` (numpy only), giving the same prompts.

An ultra-long prompt that overflows a single device's page pool plus a
tail of ordinary mixed-SLA requests (the long-context example,
``examples/torch_spatial_longctx.py``), and uniform random prompts. The
functions return plain submit-kwargs dicts that a caller feeds
straight into ``LLM.submit(**r)``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

SLA_CYCLE = ("interactive", "standard", "batch")


def uniform_prompts(vocab: int, n: int, length: int,
                    seed: int = 3) -> list[np.ndarray]:
    """``n`` independent random prompts of ``length`` tokens."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=length, dtype=np.int32)
            for _ in range(n)]


def longctx_mix(vocab: int, *, long_tokens: int, long_max_tokens: int,
                n_short: int = 0, short_tokens: int = 24,
                short_max_tokens: int = 16, seed: int = 0,
                long_sla: Optional[str] = "interactive") -> list[dict]:
    """One ultra-long prompt plus ``n_short`` ordinary requests cycling
    through the SLA classes — the spatial deployment's acceptance mix.
    Returns submit-kwargs dicts (``prompt`` / ``max_tokens`` / ``sla``),
    long prompt first."""
    rng = np.random.default_rng(seed)
    reqs = [{"prompt": rng.integers(0, vocab, size=long_tokens,
                                    dtype=np.int32),
             "max_tokens": long_max_tokens, "sla": long_sla}]
    for i in range(n_short):
        reqs.append({"prompt": rng.integers(0, vocab, size=short_tokens,
                                            dtype=np.int32),
                     "max_tokens": short_max_tokens,
                     "sla": SLA_CYCLE[(i + 1) % len(SLA_CYCLE)]})
    return reqs
