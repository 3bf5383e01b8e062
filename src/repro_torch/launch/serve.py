"""Serving launcher of the port: ``python -m repro_torch.launch.serve
--arch <id> [...]``, the twin of ``repro.launch.serve``.

Drives the serving front door (``repro_torch.serving.api.LLM``) over one
of the ported backends:

* ``--engine paged``   — the default: the paged KV-cache engine with
  chunked prefill and the preemption scheduler (batched varlen prefill
  with the ``prefill_tokens="auto"`` budget controller by default).
* ``--engine spatial`` — the sequence-sharded engine (``--shards N``,
  ``--pages`` per shard): context striped page by page over N shard
  pools, every shard on ``--device``. It serves dense-attention configs,
  so the config's STAR is switched off, as the reference launcher does.
  The reference re-executes itself with more fake XLA devices when it
  has fewer than N; torch has no such limit, so this one does not.
* ``--engine dense``   — the dense slot engine, kept as the parity
  oracle and footprint baseline; serve it only to compare against the
  pool-backed engines.

``--disagg`` serves through the prefill/decode-disaggregated router
(``repro_torch.serving.disagg``): submits land on a prefill-tuned
instance of ``--engine`` (paged or spatial) and the KVTransfer fabric
hands each request to a decode-tuned paged instance at the phase
boundary.

Requests carry an SLA class (``--sla-mix`` cycles interactive / standard
/ batch) that the scheduler maps onto priorities. ``--sla-deadlines``
enforces the SLA-tier default TTFT/end-to-end budgets and
``--shed-watermarks HIGH LOW`` turns on admission shedding of
low-priority traffic under backlog.

The run is on ``--device`` (default ``cuda``; without a GPU it raises:
pass ``--device cpu`` to serve on the CPU, with a smoke config). Smoke
configs by default; ``--full`` serves the published shapes with random
weights from seed 0, e.g. on one H100:

    python -m repro_torch.launch.serve --arch chatglm3_6b --full
    python -m repro_torch.launch.serve --arch olmoe_1b_7b --full
    python -m repro_torch.launch.serve --arch xlstm_125m --full \
        --engine dense

An arch whose weights cannot fit one card keeps its widths and takes a
depth cut under ``--full`` (``FULL_DEPTH_CUT``: Grok-1 serves 2 of its 64
layers; Nemotron-4-340B 4 of its 96, 23.25 B parameters; Jamba-1.5-Large
the first 5 of its 72, layers 0-4 of the published order: every kind of
block and FFN).

The recurrent families (Jamba's Mamba blocks, xLSTM) serve only through
``--engine dense``, as in the reference: the paged and spatial engines
refuse patterns that are not attention-only. The frontend-stub families
(SeamlessM4T's encoder-decoder, InternVL2's embeddings input) are
refused, as the reference launcher refuses them; ``chip_smoke.py`` drives
them through ``LLM`` and ``lm.prefill``/``lm.decode_step``.

The paged engine's prefill chunks are whole STAR q-tiles: the scheduler's
default of 4 pages is rounded up to a multiple of the config's
``block_q`` (8 pages of 16 at the published tiles of 128, which the
paged backend requires; the reference launcher keeps 4 and is refused
there).

Telemetry (``repro_torch.obs``) is on by default: ``--trace PATH``
exports a Perfetto/Chrome trace (``.jsonl`` streams JSONL) and prints
the per-phase time table; ``--metrics TARGET`` writes the Prometheus
text exposition (``-`` for stdout); ``--no-telemetry`` serves with the
no-op telemetry.
"""

from __future__ import annotations

import argparse
import sys
import time

SLA_CYCLE = ("interactive", "standard", "batch")
# published depth cut to this many layers under --full (weights beyond one
# card): Grok-1's 64 layers are 314 B parameters, 2 of them 11.5 B;
# Jamba-1.5-Large's first 5 layers (4 Mamba, 1 attention; 2 MoE FFNs) are
# 24 B of its 398 B
FULL_DEPTH_CUT = {"grok_1_314b": 2, "nemotron_4_340b": 4,
                  "jamba_1_5_large_398b": 5}


def model_config(arch: str, full: bool):
    """The arch's smoke config, or under ``full`` its published one with
    ``FULL_DEPTH_CUT``'s depth: a cut shorter than the published
    super-block keeps that many of its blocks, in order."""
    import dataclasses

    from repro_torch.configs import get_config, get_smoke_config
    if not full:
        return get_smoke_config(arch)
    cfg = get_config(arch)
    if arch in FULL_DEPTH_CUT:
        n = FULL_DEPTH_CUT[arch]
        cfg = dataclasses.replace(cfg, n_layers=n,
                                  pattern=cfg.pattern[:n])
    return cfg


def _parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="olmo_1b")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--engine", default="paged",
                    choices=("dense", "paged", "spatial"))
    ap.add_argument("--disagg", action="store_true",
                    help="prefill/decode disaggregation: serve through "
                         "a (prefill-tuned, decode-tuned) instance pair "
                         "of --engine (paged/spatial) and paged joined by "
                         "the KVTransfer fabric")
    ap.add_argument("--shards", type=int, default=2,
                    help="sequence shards (spatial engine)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pages", type=int, default=64,
                    help="pool pages (paged: total; spatial: per shard)")
    ap.add_argument("--sla-mix", action="store_true",
                    help="cycle requests through interactive/standard/"
                         "batch SLA classes")
    ap.add_argument("--sla-deadlines", action="store_true",
                    help="enforce the SLA-tier default TTFT/e2e deadline "
                         "budgets (paged/spatial; expired requests end "
                         "with outcome 'expired')")
    ap.add_argument("--shed-watermarks", nargs=2, type=int, default=None,
                    metavar=("HIGH", "LOW"),
                    help="enable admission shedding (paged/spatial): shed "
                         "sheddable waiting requests when the backlog "
                         "crosses HIGH, until it is back at LOW")
    ap.add_argument("--shed-below-priority", type=int, default=0,
                    help="with --shed-watermarks: only requests below "
                         "this priority are sheddable (0 sheds 'batch' "
                         "but never 'standard'/'interactive')")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="export a Perfetto/Chrome trace of the run "
                         "(.jsonl streams JSONL) and print the per-phase "
                         "time table")
    ap.add_argument("--metrics", metavar="TARGET", default=None,
                    help="Prometheus text exposition after the run: "
                         "'-' for stdout, else a file path")
    ap.add_argument("--no-telemetry", action="store_true",
                    help="serve with the no-op telemetry (the library "
                         "default); --trace/--metrics are ignored")
    return ap.parse_args(argv)


def tile_chunk_pages(cfg, page_size: int, default: int = 4) -> int:
    """The scheduler's prefill chunk in pages: ``default``, rounded up so
    that a chunk is a whole number of STAR q-tiles."""
    if cfg.star is None:
        return default
    tile = cfg.star.block_q
    tokens = -(-max(default * page_size, tile) // tile) * tile
    if tokens % page_size:
        raise SystemExit(f"--page-size {page_size} does not divide the "
                         f"STAR q-tile chunk of {tokens} tokens")
    return tokens // page_size


def main(argv=None) -> dict:
    """Serve ``--requests`` random prompts; prints one summary line and
    returns the run's ``LLM.metrics()`` (plus ``tokens`` per request)."""
    args = _parse_args(argv)

    import dataclasses
    import pathlib

    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.configs import ARCHS
    from repro_torch.device import resolve_device
    from repro_torch.models import lm
    from repro_torch.serving import (LLM, AdmissionCfg, DisaggRouter,
                                     EngineCfg, PagedEngineCfg, SchedulerCfg)
    from repro_torch.spatial import SpatialEngineCfg

    if args.arch not in ARCHS:
        raise SystemExit(f"unknown arch {args.arch}; choose from "
                         f"{sorted(ARCHS)}")
    if args.disagg and args.engine == "dense":
        raise SystemExit("--disagg needs a pool-backed engine "
                         "(paged/spatial)")
    cfg = model_config(args.arch, args.full)
    if cfg.enc_layers or cfg.embeds_input:
        raise SystemExit(f"{args.arch}: frontend-stub archs serve via "
                         "examples/ drivers")
    dev = resolve_device(args.device)
    if args.engine == "spatial" and cfg.star is not None:
        cfg = dataclasses.replace(cfg, star=None)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = lm.init(cfg, gen, dev)

    if args.engine == "dense":
        engine_cfg = EngineCfg(max_batch=args.slots, max_len=args.max_len,
                               eos_id=-1)
    elif args.engine == "paged":
        engine_cfg = PagedEngineCfg(
            max_batch=args.slots, page_size=args.page_size,
            n_pages=args.pages, hot_pages=args.max_len // args.page_size,
            eos_id=-1)
    else:
        engine_cfg = SpatialEngineCfg(
            n_shards=args.shards, max_batch=args.slots,
            page_size=args.page_size, n_pages_local=args.pages,
            hot_pages_local=args.max_len // args.page_size, eos_id=-1)
    chunk = tile_chunk_pages(cfg, args.page_size)
    sched_cfg = None
    if args.sla_deadlines or args.shed_watermarks:
        if args.engine == "dense":
            print("[serve] --sla-deadlines/--shed-watermarks ignored on "
                  "the dense engine (no scheduler; per-request deadlines "
                  "still apply via submit())")
        else:
            admission = None
            if args.shed_watermarks:
                high, low = args.shed_watermarks
                admission = AdmissionCfg(
                    high_watermark=high, low_watermark=low,
                    shed_below_priority=args.shed_below_priority)
            sched_cfg = SchedulerCfg(prefill_tokens="auto",
                                     chunk_pages=chunk,
                                     sla_deadlines=args.sla_deadlines,
                                     admission=admission)
    if sched_cfg is None and args.engine != "dense":
        sched_cfg = SchedulerCfg(prefill_tokens="auto", chunk_pages=chunk)
    tel = None if args.no_telemetry else obs.Telemetry(
        {"launcher": "repro_torch.launch.serve", "engine": args.engine,
         "arch": args.arch, "disagg": args.disagg, "device": str(dev)})
    if args.disagg:
        llm = DisaggRouter.from_config(
            cfg, backend="paged", prefill_backend=args.engine,
            params=params, shards=args.shards,
            prefill_engine_cfg=engine_cfg if args.engine != "paged"
            else None, prefill_sched_cfg=sched_cfg,
            decode_sched_cfg=SchedulerCfg(chunk_pages=chunk),
            generator=gen, device=dev, telemetry=tel)
    else:
        llm = LLM.from_config(cfg, backend=args.engine, params=params,
                              shards=args.shards, engine_cfg=engine_cfg,
                              sched_cfg=sched_cfg,
                              generator=gen, device=dev, telemetry=tel)

    rng = np.random.default_rng(0)
    t0 = time.time()
    handles = [llm.submit(rng.integers(0, cfg.vocab, size=args.prompt_len,
                                       dtype=np.int32),
                          max_tokens=args.max_tokens,
                          sla=SLA_CYCLE[i % len(SLA_CYCLE)]
                          if args.sla_mix else None)
               for i in range(args.requests)]
    done = llm.run_until_done()
    rep = llm.metrics()
    n_tok = rep.get("tokens", sum(len(v) for v in done.values()))
    extra = ""
    if rep.get("requests"):
        extra = f", ttft_p50={rep['ttft_p50_ms']}ms"
        if rep.get("occupancy") is not None:
            extra += f", occupancy={rep['occupancy']}"
        if args.sla_mix:
            extra += "".join(
                f", {k}={v['ttft_mean_ms']}ms"
                for k, v in rep["per_sla"].items()
                if v["ttft_mean_ms"] is not None)
        abnormal: dict = {}
        for v in rep.get("per_sla", {}).values():
            for outcome, n in v.get("outcomes", {}).items():
                if outcome != "done":
                    abnormal[outcome] = abnormal.get(outcome, 0) + n
        if abnormal:
            extra += ", " + ", ".join(
                f"{k}={n}" for k, n in sorted(abnormal.items()))
    if args.disagg:
        tr = llm.transfer.stats()
        extra += (f", transfers={tr['n_transfers']}"
                  f", transfer_bytes={tr['bytes_total']}")
    dt = time.time() - t0
    shards = f", {args.shards} shards" if args.engine == "spatial" else ""
    mode = ", disagg" if args.disagg else ""
    print(f"[serve] {args.arch} ({'full' if args.full else 'smoke'}, "
          f"{args.engine}{shards}{mode}, {dev}): "
          f"{len(done)} requests, {n_tok} tokens, "
          f"{n_tok / dt:.1f} tok/s, star={'on' if cfg.star else 'off'}"
          f"{extra}")

    if args.trace:
        if tel is None:
            print("[serve] --trace ignored (telemetry disabled)")
        else:
            path = pathlib.Path(args.trace)
            if path.parent != pathlib.Path("."):
                path.parent.mkdir(parents=True, exist_ok=True)
            if path.suffix == ".jsonl":
                tel.tracer.export_jsonl(str(path))
            else:
                tel.tracer.export_chrome(str(path))
            print(obs.format_table(obs.phase_summary(tel.tracer.events),
                                   title=args.engine))
            print(f"[serve] trace -> {path}")

    if args.metrics:
        if tel is None:
            print("[serve] --metrics ignored (telemetry disabled)")
        else:
            text = tel.metrics.render_prometheus()
            if args.metrics == "-":
                sys.stdout.write(text)
            else:
                pathlib.Path(args.metrics).write_text(text)
                print(f"[serve] metrics -> {args.metrics} "
                      f"({len(text.splitlines())} lines)")
    rep["tokens_by_request"] = [h.tokens for h in handles]
    return rep


if __name__ == "__main__":
    main()
