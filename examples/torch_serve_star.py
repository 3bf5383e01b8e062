"""Serve a small LM through the paged continuous-batching engine of the
PyTorch port, via the unified ``LLM`` front door (the twin of
``examples/serve_star.py``). Decode sparsity is page-granular: DLZS
scores over the int8 LZ prediction cache decide which KV pages each step
gathers (attention is exact within them), and identical prompt prefixes
share pages copy-on-write. STAR's tile-granular pipeline runs at
prefill.

Run:  python examples/torch_serve_star.py [--device cpu]

It runs on the GPU unless given ``--device cpu``. The weights come from
a seeded ``torch.Generator`` and the prompts from numpy (seed 0).
``main``'s ``cfg`` and ``requests`` (a cut depth, fp32, fewer requests)
are for the tests, which hold the tokens against the JAX engine's.
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import (LLM, PagedEngineCfg,  # noqa: E402
                                 SchedulerCfg)


def model_cfg(layers=None, dtype: str = "bfloat16"):
    """star_paper's smoke config (STAR sparse decode on), its depth cut to
    ``layers`` when given."""
    cfg = get_smoke_config("star_paper")
    return dataclasses.replace(cfg, n_layers=layers or cfg.n_layers,
                               dtype=getattr(torch, dtype))


def prompts(cfg, n: int) -> list:
    """``n`` prompts sharing one page of "system prompt" (block_q tokens),
    each followed by 8 + 4·i tokens of its own."""
    rng = np.random.default_rng(0)
    system = rng.integers(0, cfg.vocab, size=cfg.star.block_q,
                          dtype=np.int32)
    return [np.concatenate([system, rng.integers(
        0, cfg.vocab, size=8 + 4 * i, dtype=np.int32)]) for i in range(n)]


def engine_cfgs(cfg) -> tuple:
    # page_size == star.block_q so full prefix pages never split a prefill
    # tile (keeps prefix sharing exact); hot_pages*page_size = 256-token
    # decode working set regardless of how long a request grows; chunk
    # boundaries stay STAR q-tile aligned
    return (PagedEngineCfg(max_batch=4, page_size=cfg.star.block_q,
                           n_pages=32, hot_pages=4, recent_pages=2,
                           eos_id=-1),
            SchedulerCfg(chunk_pages=1, prefill_tokens="auto"))


def main(argv=None, cfg=None, requests: int = 10) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = cfg or model_cfg()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init(cfg, gen, dev)
    engine_cfg, sched_cfg = engine_cfgs(cfg)
    llm = LLM.from_config(cfg, backend="paged", params=params, device=dev,
                          generator=gen, engine_cfg=engine_cfg,
                          sched_cfg=sched_cfg)

    t0 = time.perf_counter()
    handles = [llm.submit(p, max_tokens=16)
               for p in prompts(cfg, requests)]
    done = llm.run_until_done()
    dt = time.perf_counter() - t0
    n_tok = sum(len(v) for v in done.values())
    st = llm.stats()
    pool = st["pool"]
    print(f"served {len(done)} requests / {n_tok} tokens through "
          f"{llm.engine.pcfg.max_batch} continuous-batching slots in "
          f"{dt:.1f}s ({n_tok / dt:.1f} tok/s on {dev.type})")
    print(f"pool: peak {pool.peak_live}/{pool.capacity} pages live, "
          f"{pool.shared_hits} prefix-share hits, "
          f"{pool.evictions} DLZS evictions; working set "
          f"{st['working_set_bytes'] / 2**20:.1f} MiB "
          f"({st['bytes_per_page'] / 2**20:.2f} MiB/page), "
          f"decode shapes {st['decode_compiles']}")
    for rid in sorted(done)[:3]:
        print(f"  req {rid}: {done[rid][:8]}...")
    if len(done) != requests:
        raise SystemExit(f"served {len(done)} of {requests} requests")
    return {"device": str(dev), "requests": len(done), "tokens": n_tok,
            "outputs": [h.tokens for h in handles], "wall_s": dt,
            "tok_s": n_tok / dt, "peak_live": pool.peak_live,
            "capacity": pool.capacity, "shared_hits": pool.shared_hits,
            "evictions": pool.evictions,
            "working_set_bytes": st["working_set_bytes"],
            "bytes_per_page": st["bytes_per_page"],
            "decode_compiles": st["decode_compiles"]}


if __name__ == "__main__":
    main()
