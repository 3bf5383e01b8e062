"""Serve an ultra-long prompt by sequence-sharding it over a spatial
engine of the PyTorch port, through the unified ``LLM`` front door (the
twin of ``examples/spatial_longctx.py``).

A prompt that overflows one KV page pool is striped page by page over 4
shards: each shard prefills the chunks against its resident pages, with
the cross-shard causal part merged as partial-softmax states, and every
decode step attends shard-locally and merges the partial (m, l, o)
states (K1's stats form on the GPU). Beside it, a handful of normal
requests with mixed SLA classes take the front door's QoS path. The
request mix comes from ``repro_torch.serving.scenarios.longctx_mix``.

Run:  python examples/torch_spatial_longctx.py [--device cpu]

The 4 shards share one device in one process (the JAX script re-execs
itself under 4 fake XLA devices). It runs on the GPU unless given
``--device cpu``. The config is OLMo-1B's smoke config without STAR, its
head width raised from 16 to 64: K1 is built for head widths of 64, 128
and 256 only.
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import (LLM, PagedEngineCfg,  # noqa: E402
                                 SchedulerCfg)
from repro_torch.serving.scenarios import longctx_mix  # noqa: E402
from repro_torch.spatial import SpatialEngineCfg  # noqa: E402

N_SHARDS = 4
PAGES_LOCAL = 12                        # 11 usable pages per shard
PAGE = 16


def model_cfg(dtype: str = "bfloat16"):
    return dataclasses.replace(get_smoke_config("olmo_1b"), star=None,
                               head_dim=64, dtype=getattr(torch, dtype))


def request_mix(cfg) -> list:
    """One 500-token interactive prompt + 3 mixed-SLA shorts."""
    return longctx_mix(cfg.vocab, long_tokens=500, long_max_tokens=16,
                       n_short=3, short_tokens=24, short_max_tokens=16)


def single_pool_cfg() -> PagedEngineCfg:
    """One pool with the per-shard page budget."""
    return PagedEngineCfg(max_batch=4, page_size=PAGE, n_pages=PAGES_LOCAL,
                          hot_pages=8, eos_id=-1)


def main(argv=None, cfg=None) -> dict:
    """``cfg`` (fp32) is for the tests, which hold the tokens against the
    JAX engine's."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = cfg or model_cfg()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init(cfg, gen, dev)
    mix = request_mix(cfg)

    # a single-pool engine with the same per-shard budget cannot admit it
    single = LLM.from_config(cfg, backend="paged", params=params,
                             device=dev, generator=gen,
                             engine_cfg=single_pool_cfg())
    try:
        single.submit(mix[0]["prompt"], max_tokens=mix[0]["max_tokens"])
    except ValueError as e:
        refused = str(e)
    else:
        raise SystemExit("single pool admitted the long prompt")
    print(f"single pool: {refused}")

    llm = LLM.from_config(
        cfg, backend="spatial", params=params, device=dev, generator=gen,
        engine_cfg=SpatialEngineCfg(
            n_shards=N_SHARDS, max_batch=4, page_size=PAGE,
            n_pages_local=PAGES_LOCAL, hot_pages_local=10, eos_id=-1),
        sched_cfg=SchedulerCfg(chunk_pages=2))
    handles = [llm.submit(**r) for r in mix]
    done = llm.run_until_done()
    rep = llm.metrics()
    st = llm.stats()
    print(f"\n{N_SHARDS} shards x {PAGES_LOCAL - 1} pages "
          f"({(PAGES_LOCAL - 1) * PAGE} tokens/shard) served a "
          f"{len(mix[0]['prompt'])}-token prompt + {len(done) - 1} "
          f"mixed-SLA requests on {dev.type}:")
    print(f"  {rep['tokens']} tokens in {rep['wall_s']}s "
          f"({rep['tok_s']} tok/s), ttft p50 {rep['ttft_p50_ms']} ms, "
          f"occupancy {rep['occupancy']}")
    for sla, m in rep["per_sla"].items():
        print(f"  {sla:12s} ttft {m['ttft_mean_ms']} ms")
    print(f"  pools: {st['pools']['live']} live / "
          f"{st['pools']['capacity']} pages aggregate, "
          f"{st['pools']['shared_hits']} prefix hits")
    cost = llm.engine.topo.exchange_cost()
    print(f"  NoC exchange (MRCA vs forced ring): "
          f"{cost['mrca']['latency_ns']:.0f} vs "
          f"{cost['naive_ring']['latency_ns']:.0f} ns/rotation")
    long_handle = handles[0]
    print(f"  long-prompt output head: {long_handle.tokens[:8]}...")
    if not (long_handle.done and len(long_handle.tokens) == 16):
        raise SystemExit("the spatial engine did not serve the long prompt")
    return {"device": str(dev), "refused": refused,
            "long_prompt_tokens": len(mix[0]["prompt"]),
            "requests": len(done), "outputs": [h.tokens for h in handles],
            "tokens": rep["tokens"], "wall_s": rep["wall_s"],
            "ttft_p50_ms": rep["ttft_p50_ms"],
            "pools_capacity": st["pools"]["capacity"],
            "exchange_ns": {k: cost[k]["latency_ns"]
                            for k in ("mrca", "naive_ring")}}


if __name__ == "__main__":
    main()
