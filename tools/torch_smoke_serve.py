"""Serving smoke of the PyTorch port: every backend end to end through the
unified ``LLM`` front door (the twin of ``tools/smoke_serve.py``).

Run:  python tools/torch_smoke_serve.py [--device cpu] [--smoke]
      python tools/torch_smoke_serve.py --trace [DIR] [...]
      python tools/torch_smoke_serve.py --bundle DIR [...]
      python tools/torch_smoke_serve.py --bundle-disagg DIR [...]

Scenarios:

1. ``basic``: a small mixed-length batch through the paged and the dense
   backends via ``LLM``: every request completes with valid tokens,
   variable-length admission compiled decode once, prefix sharing kicked
   in, ``metrics()`` reports the run.
2. ``spatial``: the sequence-sharded backend on 2 shards, in process
   (``tools/torch_smoke_spatial_prog.py``): front-door parity with the
   paged backend, the ultra-long admit, lazy cold-page shedding on the
   sharded pools, and front-door throughput within 5% of the direct
   engine.

The reference's ``overload``, ``batched`` and ``engine_core`` scenarios
drive ``benchmarks.serving`` and refresh ``BENCH_serving.json``; they
wait for that module's twin, and this smoke neither reads nor writes
``BENCH_serving.json``.

``--trace [DIR]`` runs only the telemetry smoke: a small traced workload
per backend (dense, paged, spatial), each exported as a Perfetto-loadable
Chrome trace into DIR (default: a temp dir) and summarized as a phase
table. ``--bundle DIR`` runs only a pressured paged workload with the
DLZS audit sampler on and dumps ``LLM.debug_bundle()`` into DIR;
``--bundle-disagg DIR`` a disaggregated (paged prefill -> paged decode)
run dumped by ``DisaggRouter.debug_bundle()``.

The model is OLMo-1B with ``star=None``: its smoke config with
``--smoke``, as the reference uses, else its published widths. Weights
come from ``repro_torch.models.lm.init`` with a generator seeded 0. It
runs on the GPU unless given ``--device cpu``. Exits non-zero on any
failure.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile
import time

import numpy as np
import torch

TOOLS = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(TOOLS.parent / "src"), str(TOOLS)]

import torch_smoke_spatial_prog as spatial_prog  # noqa: E402
import torch_trace_summary  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import (LLM, DisaggRouter,  # noqa: E402
                                 PagedEngineCfg, PagedServingEngine,
                                 SchedulerCfg)

WAITING = ("overload", "batched", "engine_core")
BUNDLE = {"recorder.jsonl", "trace.json", "metrics.json", "metrics.prom",
          "accounting.json", "audit.json", "timelines.json", "config.json"}
BUNDLE_DISAGG = {"recorder.jsonl", "trace.json", "metrics.json",
                 "metrics.prom", "accounting.json",
                 "accounting_prefill.json", "transfer.json",
                 "timelines.json", "config.json"}
BUNDLE_PROMPTS = (16, 33, 16, 40)
TRACE_PROMPTS = (6, 18, 35)


def bundle_prompts(cfg) -> list:
    return [(np.arange(n, dtype=np.int32) * 3 + i) % cfg.vocab
            for i, n in enumerate(BUNDLE_PROMPTS)]


def basic(cfg, params, device) -> dict:
    t0 = time.time()
    llm = LLM.from_config(cfg, backend="paged", params=params,
                          device=device,
                          engine_cfg=PagedEngineCfg(
                              max_batch=2, page_size=16, n_pages=24,
                              hot_pages=3, eos_id=-1))
    system = np.arange(16, dtype=np.int32)          # one shared full page
    prompts = [np.concatenate([system, np.arange(2 + 3 * i, dtype=np.int32)
                               + i]) for i in range(5)]
    for i, p in enumerate(prompts):
        llm.submit(p, max_tokens=4, rid=i)
    done = llm.run_until_done()

    st = llm.stats()
    m = llm.metrics()
    # the dense backend answers through the same front door
    dense = LLM.from_config(cfg, backend="dense", params=params,
                            device=device)
    dense_prompt = np.arange(12, dtype=np.int32)
    d = dense.submit(dense_prompt, max_tokens=4).result()
    ok = (set(done) == {0, 1, 2, 3, 4}
          and all(len(v) == 4 for v in done.values())
          and all(0 <= t < cfg.vocab for v in done.values() for t in v)
          and st["decode_compiles"] == 1
          and st["pool"].shared_hits >= 4
          and m["requests"] == 5 and m["tokens"] == 20
          and len(d) == 4)
    dt = time.time() - t0
    print(f"smoke_serve[basic]: {len(done)} requests, "
          f"{sum(len(v) for v in done.values())} tokens via LLM, "
          f"{st['pool'].peak_live} peak pages, "
          f"{st['pool'].shared_hits} prefix hits, "
          f"{st['decode_compiles']} decode compile(s), "
          f"dense={len(d)} tokens, {dt:.1f}s "
          f"-> {'PASS' if ok else 'FAIL'}", flush=True)
    return {"ok": ok, "prompts": prompts, "tokens": done,
            "dense_prompt": dense_prompt, "dense_tokens": d,
            "decode_compiles": st["decode_compiles"],
            "shared_hits": st["pool"].shared_hits,
            "peak_pages": st["pool"].peak_live, "requests": m["requests"],
            "n_tokens": m["tokens"], "tok_s": m["tok_s"], "seconds": dt}


def spatial(cfg, params, device, hold=None) -> dict:
    """The 2-shard scenarios in process; ``hold`` as in
    ``torch_smoke_spatial_prog.run_all``."""
    t0 = time.time()
    try:
        out = spatial_prog.run_all(cfg, params, device, hold)
    except AssertionError as e:
        print(f"smoke_serve[spatial]: FAIL ({e})", flush=True)
        return {"ok": False, "error": str(e)}
    fd = out["front_door"]
    dt = time.time() - t0
    print(f"smoke_serve[spatial]: parity={len(out['parity']['spatial'])} "
          f"long_prompt={spatial_prog.LONG_PROMPT} "
          f"sheds={out['shed']['sheds']} direct={fd['direct_tok_s']:.1f} "
          f"llm={fd['llm_tok_s']:.1f} tok/s ({dt:.1f}s) -> PASS",
          flush=True)
    return dict(out, ok=True, seconds=dt)


def _check_trace(events: list[dict], backend: str,
                 want_shards: bool = False) -> None:
    """The Perfetto-loadability contract every traced backend must meet."""
    spans = [e for e in events if e.get("ph") == "X"]
    assert spans, f"{backend}: no spans in trace"
    for e in spans:
        assert {"name", "ts", "dur", "pid", "tid"} <= set(e), e
    ticks = [e for e in spans if e["name"] == "tick"]
    assert ticks, f"{backend}: no tick spans"
    ts = [e["ts"] for e in ticks]
    assert ts == sorted(ts), f"{backend}: tick timestamps not monotonic"
    if want_shards:
        tagged = [e for e in events
                  if (e.get("args") or {}).get("shard") is not None]
        assert tagged, f"{backend}: no shard-tagged events"


def _traced(events: list[dict], backend: str, path, want_shards=False):
    """``_check_trace`` and the phase table; the backend's entry."""
    try:
        _check_trace(events, backend, want_shards)
    except AssertionError as e:
        print(f"smoke_serve[trace:{backend}]: FAIL ({e})", flush=True)
        return {"ok": False, "error": str(e)}
    summary = obs.phase_summary(events)
    print(obs.format_table(summary, title=backend), flush=True)
    print(f"smoke_serve[trace:{backend}]: {path} ({len(events)} events) "
          f"-> PASS", flush=True)
    return {"ok": True, "path": str(path), "events": len(events),
            "spans": sorted({e["name"] for e in events
                             if e.get("ph") == "X"}),
            "phases": summary}


def trace_smoke(cfg, params, device, out_dir: pathlib.Path) -> dict:
    """A traced run per backend, each exported as Chrome trace JSON that
    loads back cleanly (ui.perfetto.dev-compatible) + a phase table."""
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    out = {}
    for backend in ("dense", "paged"):
        tel = obs.Telemetry({"backend": backend})
        kw = {}
        if backend == "paged":
            kw = dict(engine_cfg=PagedEngineCfg(
                max_batch=2, page_size=16, n_pages=24, hot_pages=4,
                eos_id=-1), sched_cfg=SchedulerCfg(chunk_pages=1,
                                                   prefill_tokens=48))
        llm = LLM.from_config(cfg, backend=backend, params=params,
                              device=device, telemetry=tel, **kw)
        done = spatial_prog.submit_all(
            llm, spatial_prog.mixed_prompts(cfg, TRACE_PROMPTS))
        assert all(len(v) == 4 for v in done.values()), (backend, done)
        path = out_dir / f"trace_{backend}.json"
        tel.tracer.export_chrome(str(path))
        out[backend] = _traced(obs.load_trace(str(path)), backend, path)
        out[backend]["tokens"] = done

    sp_path = out_dir / "trace_spatial.json"
    try:
        sp = spatial_prog.trace(cfg, params, device, sp_path)
    except AssertionError as e:
        print(f"smoke_serve[trace:spatial]: FAIL ({e})", flush=True)
        out["spatial"] = {"ok": False, "error": str(e)}
    else:
        out["spatial"] = _traced(obs.load_trace(str(sp_path)), "spatial",
                                 sp_path, want_shards=True)
        out["spatial"].update(shard_tagged=sp["shard_tagged"],
                              tokens=sp["tokens"])
    ok = all(v["ok"] for v in out.values())
    out["seconds"] = time.time() - t0
    print(f"smoke_serve[trace]: all backends in {out['seconds']:.1f}s "
          f"-> {'PASS' if ok else 'FAIL'}", flush=True)
    out["ok"] = ok
    return out


def check_bundle(out: str, want: set) -> dict:
    """The artifacts ``want`` are all there, every JSON one loads, and
    none holds a tensor's ``repr`` where its numbers belong."""
    have = {p.name for p in pathlib.Path(out).iterdir()}
    missing = sorted(want - have)
    reprs = []
    loaded = {}
    for name in sorted(have):
        text = (pathlib.Path(out) / name).read_text()
        if "tensor(" in text:
            reprs.append(name)
        if name.endswith(".json"):
            loaded[name] = json.loads(text)
    return {"ok": not missing and not reprs, "artifacts": sorted(have),
            "missing": missing, "tensor_reprs": reprs, "loaded": loaded}


def bundle_smoke(cfg, params, device, out_dir: pathlib.Path) -> dict:
    """One pressured paged run with full telemetry + the DLZS audit
    sampler, dumped as an ``LLM.debug_bundle()``: the smoke that the
    whole bundle surface stays dumpable."""
    tel = obs.Telemetry({"backend": "paged"})
    llm = LLM.from_config(
        cfg, backend="paged", params=params, device=device, telemetry=tel,
        engine_cfg=PagedEngineCfg(max_batch=4, page_size=16, n_pages=10,
                                  hot_pages=4, eos_id=-1),
        sched_cfg=SchedulerCfg(chunk_pages=1, prefill_tokens=64,
                               swap=True),
        audit_cfg=obs.AuditCfg(every_ticks=4))
    for i, p in enumerate(bundle_prompts(cfg)):
        llm.submit(p, max_tokens=16, rid=i)
    done = llm.run_until_done(max_steps=8000)
    out = llm.debug_bundle(str(out_dir))
    res = check_bundle(out, BUNDLE)
    res.update(tokens=done, audit_runs=llm.engine.auditor.runs)
    if not res["ok"]:
        print(f"smoke_serve[bundle]: FAIL (missing {res['missing']}, "
              f"tensor reprs in {res['tensor_reprs']})", flush=True)
        return res
    print(torch_trace_summary.accounting_table(
        res["loaded"]["metrics.json"], title=out), flush=True)
    print(f"smoke_serve[bundle]: {out} ({len(res['artifacts'])} "
          f"artifacts) -> PASS", flush=True)
    return res


def bundle_disagg_smoke(cfg, params, device, out_dir: pathlib.Path) -> dict:
    """One disaggregated (paged prefill -> paged decode) run with full
    telemetry, dumped as ``DisaggRouter.debug_bundle()``: the router adds
    the fabric artifacts (transfer.json, accounting_prefill.json) on top
    of the base bundle."""
    tel = obs.Telemetry({"backend": "paged", "disagg": True})
    llm = DisaggRouter(
        PagedServingEngine(cfg, params,
                           PagedEngineCfg(max_batch=2, page_size=16,
                                          n_pages=32, hot_pages=4,
                                          eos_id=-1),
                           SchedulerCfg(chunk_pages=1,
                                        prefill_tokens=48)),
        PagedServingEngine(cfg, params,
                           PagedEngineCfg(max_batch=4, page_size=16,
                                          n_pages=64, hot_pages=4,
                                          eos_id=-1),
                           SchedulerCfg(chunk_pages=1)),
        telemetry=tel)
    for i, p in enumerate(bundle_prompts(cfg)):
        llm.submit(p, max_tokens=16, rid=i)
    done = llm.run_until_done(max_steps=8000)
    out = llm.debug_bundle(str(out_dir))
    res = check_bundle(out, BUNDLE_DISAGG)
    tr = llm.transfer.stats()
    res.update(tokens=done, transfer=tr)
    if not res["ok"]:
        print(f"smoke_serve[bundle-disagg]: FAIL (missing "
              f"{res['missing']}, tensor reprs in {res['tensor_reprs']})",
              flush=True)
        return res
    if tr["n_transfers"] == 0 or tr["in_flight"]:
        print(f"smoke_serve[bundle-disagg]: FAIL (fabric stats {tr})",
              flush=True)
        res["ok"] = False
        return res
    print(f"smoke_serve[bundle-disagg]: {out} ({len(res['artifacts'])} "
          f"artifacts, {tr['n_transfers']} transfers) -> PASS", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="serving smoke")
    ap.add_argument("--trace", nargs="?", const="", metavar="DIR",
                    default=None,
                    help="run ONLY the telemetry smoke; export Perfetto "
                         "traces for all three backends into DIR")
    ap.add_argument("--bundle", metavar="DIR", default=None,
                    help="run ONLY a pressured paged workload and dump "
                         "an LLM.debug_bundle() into DIR")
    ap.add_argument("--bundle-disagg", metavar="DIR", default=None,
                    help="run ONLY a disaggregated (prefill -> decode) "
                         "workload and dump a DisaggRouter."
                         "debug_bundle() into DIR")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--smoke", action="store_true",
                    help="OLMo-1B's smoke config (the reference's model)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = spatial_prog.model_cfg(args.smoke)
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)

    if args.trace is not None:
        out_dir = pathlib.Path(args.trace) if args.trace \
            else pathlib.Path(tempfile.mkdtemp(prefix="repro_traces_"))
        return 0 if trace_smoke(cfg, params, dev, out_dir)["ok"] else 1
    if args.bundle is not None:
        return 0 if bundle_smoke(cfg, params, dev,
                                 pathlib.Path(args.bundle))["ok"] else 1
    if args.bundle_disagg is not None:
        return 0 if bundle_disagg_smoke(
            cfg, params, dev, pathlib.Path(args.bundle_disagg))["ok"] else 1

    ok = basic(cfg, params, dev)["ok"]
    hold = None if cfg.dtype == torch.float32 \
        else spatial_prog.rounding_rule(cfg, params)
    ok = spatial(cfg, params, dev, hold)["ok"] and ok
    print(f"smoke_serve[{', '.join(WAITING)}]: not run, waiting for the "
          f"twin of benchmarks.serving", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
