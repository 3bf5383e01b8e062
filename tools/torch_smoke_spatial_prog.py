"""Spatial serving smoke of the PyTorch port: 2 shards through the unified
``LLM`` front door (the twin of ``tools/smoke_spatial_prog.py``).

Run:  python tools/torch_smoke_spatial_prog.py [--device cpu] [--smoke]
      python tools/torch_smoke_spatial_prog.py --trace PATH [...]

The reference runs as a subprocess of ``tools/smoke_serve.py`` because XLA
fixes its device count at the first JAX init. The port's spatial engine
folds its shards into the batch on one device, so each scenario here is a
function of ``(cfg, params, device)`` that ``tools/torch_smoke_serve.py``
and ``chip_smoke.py`` call in process:

* ``parity``: the 2-shard engine serves a small mixed-length batch with
  the paged engine's tokens, with one decode compilation (in bf16, where
  the two decode forms can round a token apart, every token of both runs
  by ``chip_smoke.py``'s phase 4 rule instead);
* ``capacity``: a prompt that overflows one shard's pool is refused by a
  single-pool engine (``ValueError``) and served by the 2-shard engine;
* ``shed``: under per-shard pool pressure with ``lazy_swap`` the shared
  EngineCore path sheds DLZS-cold ref-1 pages with no full preemption;
* ``front_door``: ``LLM``-driven tokens/s at least 0.95 x the directly
  driven engine's (both warmed; up to 3 attempts);
* ``trace``: one small traced batched-prefill workload, exported as a
  Chrome/Perfetto trace that must carry shard-tagged events and tick
  spans.

The model is OLMo-1B with ``star=None`` (the spatial engine's setting):
its smoke config with ``--smoke``, as the reference uses, else its full
width. Weights come from ``repro_torch.models.lm.init`` with a generator
seeded 0. It runs on the GPU unless given ``--device cpu``. Prints the
reference's ``SPATIAL_TOKS``/``SPATIAL_OK`` (or ``SPATIAL_TRACE_OK``)
lines; any failed check exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_smoke_config, olmo_1b  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import (LLM, PagedEngineCfg,  # noqa: E402
                                 PagedServingEngine, Request, SchedulerCfg)
from repro_torch.spatial import (SpatialEngineCfg,  # noqa: E402
                                 SpatialServingEngine)

MIXED = (6, 18, 35)
LONG_PROMPT = 150
SHED_PROMPT, SHED_TOKENS = 80, 48
TP_LENGTHS = (40, 64, 28, 52)
FRONT_DOOR_SHARE = 0.95
FRONT_DOOR_ATTEMPTS = 3       # the reference's guard against host noise


def model_cfg(smoke: bool):
    """OLMo-1B without STAR: the smoke config (the reference's) or the
    published widths."""
    cfg = get_smoke_config("olmo_1b") if smoke else olmo_1b.config()
    return dataclasses.replace(cfg, star=None)


def mixed_prompts(cfg, lengths=MIXED) -> list:
    return [(np.arange(n, dtype=np.int32) * 5 + i) % cfg.vocab
            for i, n in enumerate(lengths)]


def submit_all(llm, prompts, max_tokens: int = 4) -> dict:
    for i, p in enumerate(prompts):
        llm.submit(p, max_tokens=max_tokens, rid=i)
    return llm.run_until_done(max_steps=20_000)


def spatial_cfg(**kw) -> SpatialEngineCfg:
    return SpatialEngineCfg(n_shards=2, page_size=16, eos_id=-1, **kw)


def parity(cfg, params, device, strict: bool = True) -> dict:
    """The mixed batch through a paged and a 2-shard spatial ``LLM``; the
    spatial engine compiles decode once. ``strict``: the tokens must be
    equal (the reference's check, which holds in fp32). In bf16 the two
    decode forms (the paged engine's normalised attention, the shards'
    (m, l, o) states and their merge) can round a token apart, so a
    caller that passes ``strict=False`` holds the returned tokens by a
    rounding rule of its own."""
    prompts = mixed_prompts(cfg)
    paged = LLM(PagedServingEngine(cfg, params, PagedEngineCfg(
        max_batch=2, page_size=16, n_pages=24, hot_pages=4, eos_id=-1),
        SchedulerCfg(chunk_pages=1)))
    want = submit_all(paged, prompts)
    sp = LLM(SpatialServingEngine(cfg, params, spatial_cfg(
        max_batch=2, n_pages_local=24, hot_pages_local=4),
        SchedulerCfg(chunk_pages=1)))
    got = submit_all(sp, prompts)
    compiles = sp.stats()["decode_compiles"]
    assert not strict or got == want, \
        f"2-shard parity broke:\n{got}\n{want}"
    assert compiles == 1, compiles
    return {"prompts": prompts, "paged": want, "spatial": got,
            "equal": got == want, "decode_compiles": compiles,
            "tokens_differing": sum(a != b for rid in want
                                    for a, b in zip(want[rid], got[rid]))}


def capacity(cfg, params, device) -> dict:
    """A 150-token prompt: a single pool of 8 pages refuses it, two
    shards of 8 serve it."""
    long_prompt = (np.arange(LONG_PROMPT, dtype=np.int32) * 3 + 7) \
        % cfg.vocab
    small = LLM(PagedServingEngine(cfg, params, PagedEngineCfg(
        max_batch=2, page_size=16, n_pages=8, hot_pages=12, eos_id=-1)))
    try:
        small.submit(long_prompt, max_tokens=4)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("single-pool engine admitted the overflow "
                             "prompt")
    sp = LLM(SpatialServingEngine(cfg, params, spatial_cfg(
        max_batch=2, n_pages_local=8, hot_pages_local=12),
        SchedulerCfg(chunk_pages=2)))
    sp.submit(long_prompt, max_tokens=4, rid=9)
    done = sp.run_until_done(max_steps=20_000)
    assert len(done[9]) == 4 and all(0 <= t < cfg.vocab for t in done[9]), \
        done
    return {"long_prompt": LONG_PROMPT, "refused": refused,
            "tokens": done[9]}


def shed(cfg, params, device) -> dict:
    """Two 80-token prompts, 48 tokens each, over shards of 6 pages with
    ``lazy_swap``: cold pages are shed, no sequence is preempted."""
    llm = LLM(SpatialServingEngine(cfg, params, spatial_cfg(
        max_batch=2, n_pages_local=6, hot_pages_local=2, recent_pages=2),
        SchedulerCfg(chunk_pages=1, swap=True, lazy_swap=True)))
    for i in range(2):
        llm.submit((np.arange(SHED_PROMPT, dtype=np.int32) + i) % cfg.vocab,
                   max_tokens=SHED_TOKENS, rid=i)
    done = llm.run_until_done(max_steps=20_000)
    sched = llm.stats()["sched"]
    assert all(len(v) == SHED_TOKENS for v in done.values()), done
    assert sched.sheds > 0 and sched.preemptions == 0, \
        (sched.sheds, sched.preemptions)
    return {"sheds": sched.sheds, "preemptions": sched.preemptions,
            "tokens": done}


def front_door_engine(cfg, params) -> SpatialServingEngine:
    return SpatialServingEngine(cfg, params, spatial_cfg(
        max_batch=4, n_pages_local=32, hot_pages_local=8),
        SchedulerCfg(chunk_pages=2, prefill_tokens=96))


def front_door_requests(cfg, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=n,
                                               dtype=np.int32),
                    max_tokens=16) for i, n in enumerate(TP_LENGTHS)]


def front_door(cfg, params, device) -> dict:
    """Tokens/s of one engine driven directly against another driven
    through ``LLM``, same config, both warmed: ``LLM`` must keep at least
    0.95 of the direct rate within 3 attempts. Each rate is host clock
    over a drain whose every tick reads its tokens back."""
    direct = front_door_engine(cfg, params)
    direct.run(front_door_requests(cfg, 7))                  # warm-up
    llm = LLM(front_door_engine(cfg, params))
    for r in front_door_requests(cfg, 7):
        llm.submit(r.prompt, max_tokens=r.max_tokens, rid=r.rid)
    llm.run_until_done(max_steps=20_000)                     # warm-up
    llm.clear_finished()
    runs = []
    for _ in range(FRONT_DOOR_ATTEMPTS):
        t0 = time.perf_counter()
        d_done = direct.run(front_door_requests(cfg, 1))
        d_tok_s = sum(len(v) for v in d_done.values()) \
            / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        for r in front_door_requests(cfg, 1):
            llm.submit(r.prompt, max_tokens=r.max_tokens, rid=100 + r.rid)
        l_done = llm.run_until_done(max_steps=20_000)
        l_tok_s = sum(len(v) for v in l_done.values()) \
            / (time.perf_counter() - t0)
        llm.clear_finished()
        runs.append((d_tok_s, l_tok_s))
        if l_tok_s >= FRONT_DOOR_SHARE * d_tok_s:
            break
    assert l_tok_s >= FRONT_DOOR_SHARE * d_tok_s, \
        f"LLM front door lost spatial throughput: {l_tok_s:.1f} vs " \
        f"{d_tok_s:.1f} tok/s"
    print(f"SPATIAL_TOKS direct={d_tok_s:.1f} llm={l_tok_s:.1f}",
          flush=True)
    return {"direct_tok_s": d_tok_s, "llm_tok_s": l_tok_s,
            "ratio": l_tok_s / d_tok_s, "attempts": len(runs),
            "runs": runs, "tokens": sum(len(v) for v in l_done.values())}


def trace(cfg, params, device, path) -> dict:
    """One traced batched-prefill run on the 2-shard engine, exported to
    ``path`` as Chrome trace JSON: shard-tagged events and tick spans
    must be in it."""
    tel = obs.Telemetry({"backend": "spatial", "n_shards": 2})
    llm = LLM(SpatialServingEngine(cfg, params, spatial_cfg(
        max_batch=2, n_pages_local=24, hot_pages_local=4),
        SchedulerCfg(chunk_pages=1, prefill_tokens=48)), telemetry=tel)
    done = submit_all(llm, mixed_prompts(cfg))
    assert all(len(v) == 4 for v in done.values()), done
    tel.tracer.export_chrome(str(path))
    events = obs.load_trace(str(path))
    shard_tagged = [e for e in events
                    if (e.get("args") or {}).get("shard") is not None]
    assert shard_tagged, "no shard-tagged events in spatial trace"
    ticks = [e for e in events if e.get("name") == "tick"]
    assert ticks, "no tick spans in spatial trace"
    print(f"SPATIAL_TRACE_OK events={len(events)} "
          f"shard_tagged={len(shard_tagged)} ticks={len(ticks)}",
          flush=True)
    return {"events": len(events), "shard_tagged": len(shard_tagged),
            "ticks": len(ticks), "tokens": done}


def run_all(cfg, params, device, hold=None) -> dict:
    """The four scenarios in the reference's order, then its OK line.
    ``hold(parity_result)``, where given, holds parity's tokens in place
    of strict equality (see ``parity``)."""
    out = {"parity": parity(cfg, params, device, strict=hold is None)}
    if hold is not None:
        out["parity"]["rule"] = hold(out["parity"])
    out.update(capacity=capacity(cfg, params, device),
               shed=shed(cfg, params, device),
               front_door=front_door(cfg, params, device))
    print(f"SPATIAL_OK parity={len(out['parity']['spatial'])} "
          f"long_prompt={LONG_PROMPT} sheds={out['shed']['sheds']} "
          f"shards=2", flush=True)
    return out


def rounding_rule(cfg, params):
    """Phase 4's rule of ``chip_smoke.py`` (``check_exact``: every token
    the argmax of a dense forward over its served prefix, or a 1- or
    2-step bf16 tie) on both runs of ``parity``: the hold for a bf16
    model."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    def hold(res: dict) -> dict:
        return {name: chip_smoke.check_exact(params, cfg, res["prompts"],
                                             res[name])
                for name in ("paged", "spatial")}
    return hold


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--smoke", action="store_true",
                    help="OLMo-1B's smoke config (the reference's model)")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="run only the traced workload, exported to PATH")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = model_cfg(args.smoke)
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    if args.trace is not None:
        return trace(cfg, params, dev, args.trace)
    hold = None if cfg.dtype == torch.float32 else rounding_rule(cfg,
                                                                params)
    return run_all(cfg, params, dev, hold)


if __name__ == "__main__":
    main()
