#!/usr/bin/env python3
"""On-card smoke of the PyTorch port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printing its numbers on a line of its own:

1. the card's name and power limit; the build of every CUDA kernel from
   ``src/repro_torch/csrc`` (nvcc, sm_90a) into ``build/``;
2. K1 (paged decode) against its plain PyTorch version on the card, at the
   main path's shapes and at a GQA case with padded slots, bf16 at 2e-2,
   with its time beside its bound, the plain version's and one PyTorch
   call's (SDPA over the gathered rows, a yardstick the port never calls);
3. the main path: full-width OLMo-1B (random weights from a seed) served
   through ``LLM.from_config(backend="paged")``: TTFT, tokens/s, decode
   ticks, and K1's launches, which must equal ticks x layers;
4. exactness: every served token is the greedy argmax of a dense forward
   (``star=None``) over the served prefix, up to a bf16 tie;
5. bounded DLZS sparse decode (``decode_hot_width`` below the live page
   count), which runs the page scores and the sphere selection every tick.

Then one JSON line with every kernel's numbers and, last, the device line.
Without a GPU, or outside a checkout, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import olmo_1b  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import paged as kpaged  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import LLM, PagedEngineCfg, SchedulerCfg  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

SEED = 0
# NVIDIA H100 SXM data sheet: HBM3 rate and dense bf16 tensor-core peak
HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12
TOL = 2e-2                  # bf16 bound of tests/test_kernels.py
L2_FLUSH_BYTES = 256 << 20  # > the 50 MB L2: each timed launch starts cold

MAIN_PROMPTS = (256, 384, 512, 704, 896, 960)
MAIN_MAX_TOKENS = 32


def emit(tag: str, **fields) -> None:
    print(json.dumps({"phase": tag, **fields}), flush=True)


# -- timing ------------------------------------------------------------------

def time_ms(fn, iters: int = 50, flush=None) -> float:
    """Median device time of ``fn`` over ``iters`` launches, CUDA events
    around each launch; ``flush`` (a tensor) is overwritten between
    launches so each one finds the L2 cold, as a decode layer does."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        events.append((start, stop))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in events]))


# -- phase 2: K1 against its plain version ------------------------------------

def paged_inputs(b, g, r, d, page, w, p, kv_len, seed, device):
    """Block tables as the engine builds them: each sequence owns
    ceil(kv_len / page) distinct random pages, the rest of its W slots are
    padding (-1)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((b, g, r, d), generator=gen)
    k = torch.randn((p, page, g, d), generator=gen)
    v = torch.randn((p, page, g, d), generator=gen)
    phys = torch.full((b, w), -1, dtype=torch.int32)
    logical = torch.full((b, w), -1, dtype=torch.int32)
    for i, n_rows in enumerate(kv_len):
        n = -(-n_rows // page)
        phys[i, :n] = (torch.randperm(p - 1, generator=gen)[:n] + 1).int()
        logical[i, :n] = torch.arange(n, dtype=torch.int32)
    kvl = torch.tensor(kv_len, dtype=torch.int32)
    bf = [t.to(device, torch.bfloat16) for t in (q, k, v)]
    return bf + [t.to(device) for t in (phys, logical, kvl)]


def paged_bound_ms(q, k, phys, kv_len) -> float:
    """Least time for the same work on the card: each input read once and
    the output written once (only the K/V rows these block tables name
    below kv_len, the data-dependent part), over the HBM rate; it is
    bound by bytes (4·R·d flops per K/V row pair and head is far below
    the bf16 ridge)."""
    b, g, r, d = q.shape
    rows = int(kv_len.sum())
    kv_bytes = rows * g * d * 2 * k.element_size()
    io_bytes = 2 * q.numel() * q.element_size() \
        + (2 * phys.numel() + kv_len.numel()) * 4
    flops = 4 * rows * g * r * d
    return 1e3 * max((kv_bytes + io_bytes) / HBM_BYTES_S,
                     flops / BF16_FLOP_S)


def sdpa_call(q, k, v, phys, logical, kv_len, scale):
    """One PyTorch call computing the same attention: SDPA over the rows
    gathered beforehand (the gather itself is not in the timed call)."""
    from repro_torch.kvcache.paged_attention import _gather_hot
    b, g, r, d = q.shape
    kg, vg, valid = _gather_hot(k, v, phys, logical, kv_len)
    kh = kg.transpose(1, 2).repeat_interleave(r, dim=1).contiguous()
    vh = vg.transpose(1, 2).repeat_interleave(r, dim=1).contiguous()
    qh = q.reshape(b, g * r, 1, d)
    mask = valid[:, None, None, :]
    fn = torch.nn.functional.scaled_dot_product_attention
    return lambda: fn(qh, kh, vh, attn_mask=mask, scale=scale)


def check_paged_kernel(device, name, b, g, r, d, page, w, p, kv_len, seed,
                       timed: bool) -> dict:
    q, k, v, phys, logical, kvl = paged_inputs(b, g, r, d, page, w, p,
                                               kv_len, seed, device)
    scale = 1.0 / math.sqrt(d)
    got = kpaged.paged_decode_attention(q, k, v, phys, logical, kvl,
                                        scale=scale)
    want = kpaged.paged_decode_reference(q, k, v, phys, logical, kvl,
                                         scale=scale)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    bad = int((err > TOL + TOL * want.float().abs()).sum())
    out = {"case": name, "shape": [b, g, r, d], "page": page, "W": w,
           "P": p, "kv_len": list(kv_len),
           "max_abs_err": float(err.max()), "violations": bad}
    if bad:
        emit("k1_parity", ok=False, **out)
        raise SystemExit(f"K1 disagrees with its plain version: {out}")
    if timed:
        flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
        lib = sdpa_call(q, k, v, phys, logical, kvl, scale)
        out.update(
            kernel_ms=time_ms(lambda: kpaged.paged_decode_attention(
                q, k, v, phys, logical, kvl, scale=scale), flush=flush),
            plain_ms=time_ms(lambda: kpaged.paged_decode_reference(
                q, k, v, phys, logical, kvl, scale=scale), flush=flush),
            library_ms=time_ms(lib, flush=flush),
            bound_ms=paged_bound_ms(q, k, phys, kvl), bound_by="bytes")
        # the kernel once more after the yardsticks, to see the spread
        out["kernel_ms_repeat"] = time_ms(
            lambda: kpaged.paged_decode_attention(
                q, k, v, phys, logical, kvl, scale=scale), flush=flush)
        del flush
    emit("k1_parity", ok=True, **out)
    return out


# -- phases 3-5: the served path ----------------------------------------------

def count_decode_ticks(llm: LLM) -> dict:
    """Wrap the backend's decode step: ``ticks`` counts steps that ran (one
    K1 launch per layer each); ``decode_s`` sums their host time through
    the device's completion (the engine reads the step's tokens back right
    after, so the added synchronise moves no work); ``pages_total`` /
    ``pages_hot`` sum the resident and gathered pages of every step."""
    backend = llm.engine.backend
    step = backend.decode_step
    on_card = backend.device.type == "cuda"
    tally = {"ticks": 0, "decode_s": 0.0, "pages_total": 0, "pages_hot": 0}

    def counted(*args, **kw):
        t0 = time.perf_counter()
        out = step(*args, **kw)
        if on_card:
            torch.cuda.synchronize()
        tally["decode_s"] += time.perf_counter() - t0
        tally["ticks"] += 1
        tally["pages_total"] += backend.decode_sparsity["pages_total"]
        tally["pages_hot"] += backend.decode_sparsity["pages_hot"]
        return out

    backend.decode_step = counted
    tally["restore"] = lambda: setattr(backend, "decode_step", step)
    return tally


def make_prompts(cfg, lengths, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(2, cfg.vocab, size=n).astype(np.int32)
            for n in lengths]


def serve(llm: LLM, prompts, max_tokens: int) -> dict:
    """Submit every prompt, drain, and time it on the host clock (the
    first token of each request is read back to the host, so TTFT
    includes the device's work)."""
    tally = count_decode_ticks(llm)
    kernels.reset_launches()
    t0 = time.perf_counter()
    handles = [llm.submit(p, max_tokens=max_tokens) for p in prompts]
    try:
        llm.run_until_done()
    finally:
        tally["restore"]()
    if llm.engine.backend.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if not all(h.done and h.outcome == "done" for h in handles):
        raise SystemExit("the engine left requests unserved")
    done = [h.tokens for h in handles]
    recs = [llm.records[h.rid] for h in handles]
    n_tok = sum(len(v) for v in done)
    return {"done": done, "ticks": tally["ticks"], "launches": launches,
            "decode_s": tally["decode_s"],
            "pages_total": tally["pages_total"],
            "pages_hot": tally["pages_hot"],
            "ttft_ms": [1e3 * r.ttft for r in recs],
            "tokens": n_tok, "wall_s": wall, "tok_s": n_tok / wall}


def bf16_step(x: torch.Tensor) -> torch.Tensor:
    """One bf16 rounding step (8 significant bits) at |x|."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


@torch.inference_mode()
def check_exact(params, cfg, prompts, done) -> dict:
    """Each served token against the argmax of a dense, cache-free forward
    (``star=None``) over the served prefix. The served path and the
    forward sum bf16 products in different orders and shapes, so a token
    whose dense logit is within one bf16 step of the top is a tie (the
    full-width form of ``tests/engine_core_scenarios.py::_greedy_tie``);
    anything further fails."""
    dense = dataclasses.replace(cfg, star=None)
    dev = params["embed"].device
    n_exact = n_tie = 0
    max_gap = 0.0
    for rid, prompt in enumerate(prompts):
        toks = np.asarray(done[rid], np.int64)
        seq = np.concatenate([prompt.astype(np.int64), toks[:-1]])
        logits = lm.forward(params, dense, {"tokens": torch.as_tensor(
            seq[None], device=dev)})[0, len(prompt) - 1:, :cfg.vocab]
        logits = logits.float()
        served = torch.as_tensor(toks, device=dev)
        top = logits.max(dim=-1).values
        gap = top - logits[torch.arange(len(toks), device=dev), served]
        exact = logits.argmax(dim=-1) == served
        tie = ~exact & (gap <= bf16_step(top))
        if bool((~exact & ~tie).any()):
            i = int((~exact & ~tie).nonzero()[0])
            raise SystemExit(
                f"request {rid} token {i}: served {int(served[i])}, dense "
                f"argmax {int(logits[i].argmax())}, gap {float(gap[i])}")
        n_exact += int(exact.sum())
        n_tie += int(tie.sum())
        max_gap = max(max_gap, float(gap.max()))
    return {"tokens_checked": n_exact + n_tie, "exact": n_exact,
            "bf16_ties": n_tie, "max_gap": max_gap}


def main_path_llm(cfg, params, *, n_pages, hot_pages, past_pages,
                  device, generator, hot_width=None) -> LLM:
    return LLM.from_config(
        cfg, backend="paged", params=params, device=device,
        generator=generator,
        engine_cfg=PagedEngineCfg(max_batch=4, page_size=16,
                                  n_pages=n_pages, hot_pages=hot_pages,
                                  batch_past_pages=past_pages, eos_id=-1),
        # chunk = 8 pages = 128 tokens, the STAR q-tile of olmo_1b
        sched_cfg=SchedulerCfg(chunk_pages=8, prefill_tokens="auto",
                               decode_hot_width=hot_width))


def served_summary(run: dict, n_layers: int) -> dict:
    ttft = run["ttft_ms"]
    return {"requests": len(run["done"]), "tokens": run["tokens"],
            "wall_s": run["wall_s"], "tok_s": run["tok_s"],
            "ttft_ms_p50": float(np.median(ttft)),
            "ttft_ms_max": float(max(ttft)),
            "decode_ticks": run["ticks"],
            "decode_ms_per_tick": 1e3 * run["decode_s"]
            / max(run["ticks"], 1),
            "other_s": run["wall_s"] - run["decode_s"],
            "k1_launches": run["launches"]["paged_decode"],
            "expected_launches": run["ticks"] * n_layers,
            "pages_resident_per_tick": run["pages_total"]
            / max(run["ticks"], 1),
            "pages_gathered_per_tick": run["pages_hot"]
            / max(run["ticks"], 1)}


def require_launches(summary: dict, tag: str) -> None:
    if summary["decode_ticks"] == 0 or \
            summary["k1_launches"] != summary["expected_launches"]:
        raise SystemExit(f"{tag}: K1 launched {summary['k1_launches']} "
                         f"times over {summary['decode_ticks']} decode "
                         f"ticks; expected ticks x layers = "
                         f"{summary['expected_launches']}")


# -- main ---------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)

    # 1. build every kernel from the checkout's sources, in parallel
    t0 = time.perf_counter()
    built = build.build()
    emit("build", seconds=time.perf_counter() - t0,
         libs={k: {"cached": v["cached"], "seconds": v["seconds"]}
               for k, v in built.items()})
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas[{name}] {line.strip()}", flush=True)

    # 2. K1 against its plain version, main-path shapes and a GQA case
    k1 = check_paged_kernel(dev, "main_path", b=4, g=16, r=1, d=128,
                            page=16, w=64, p=1024,
                            kv_len=(1024, 1000, 777, 500), seed=1,
                            timed=True)
    gqa = check_paged_kernel(dev, "gqa_r4_padded", b=3, g=4, r=4, d=128,
                             page=16, w=16, p=256, kv_len=(256, 201, 37),
                             seed=2, timed=False)

    # 3. the main path: full-width OLMo-1B on the paged engine
    cfg = olmo_1b.config()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    params = lm.init(cfg, gen, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    emit("init", seconds=time.perf_counter() - t0, params=n_params,
         dtype=str(cfg.dtype))
    # hot_pages covers the longest sequence (960 + 32 tokens = 62 pages),
    # so decode is exact; the batched prefill's past window is the
    # largest request's page count, not the whole pool
    llm = main_path_llm(cfg, params, n_pages=1024, hot_pages=64,
                        past_pages=64, device=dev, generator=gen)
    backend = llm.engine.backend
    emit("pool", n_pages=1024,
         slab_bytes=backend.stats()["slab_bytes"],
         bytes_per_page=backend.page_bytes_full)
    prompts = make_prompts(cfg, MAIN_PROMPTS, SEED)
    # warm-up request (cuBLAS handles, allocator), not counted
    serve(llm, make_prompts(cfg, (128,), SEED + 1), 2)
    llm.clear_finished()
    run = serve(llm, prompts, MAIN_MAX_TOKENS)
    main = served_summary(run, cfg.n_layers)
    emit("main_path", **main)
    require_launches(main, "main path")

    # 4. exactness against a dense forward on the same weights
    exact = check_exact(params, cfg, prompts, run["done"])
    emit("exactness", **exact)

    # 5. bounded sparse decode: hot width 8 pages under 32+ live pages
    del llm, backend
    torch.cuda.empty_cache()
    sparse_llm = main_path_llm(cfg, params, n_pages=256, hot_pages=64,
                               past_pages=64, device=dev, generator=gen,
                               hot_width=8)
    sp_run = serve(sparse_llm, make_prompts(cfg, (512, 640, 768), SEED + 2),
                   16)
    sparse = served_summary(sp_run, cfg.n_layers)
    emit("sparse_decode", hot_width=sparse_llm.stats()["hot_width"],
         **sparse)
    require_launches(sparse, "sparse decode")
    if not sparse["pages_gathered_per_tick"] < \
            sparse["pages_resident_per_tick"]:
        raise SystemExit("sparse decode gathered every resident page")

    print(json.dumps({"kernels": [{
        "name": "paged_decode", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_decode.cu",
        "replaces": "src/repro/kernels/paged.py:67",
        "launches": main["k1_launches"],
        "max_abs_err": k1["max_abs_err"],
        "max_abs_err_gqa": gqa["max_abs_err"],
        "ms": k1["kernel_ms"], "ms_repeat": k1["kernel_ms_repeat"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": k1["library_ms"],
        "tolerance": TOL}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
