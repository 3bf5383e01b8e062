#!/usr/bin/env python3
"""Peak card memory and time of the training step's memory forms,
blocked against whole-leaf. One GPU:

    python3 tools/torch_optim_memory.py

Each measurement prints one JSON line with the card's name. First, on
fresh bf16 tensors of a leaf that phase 23 or 25 of ``chip_smoke.py``
trains, the bytes the call allocates above what was resident before it
(``max_memory_allocated`` minus the resident bytes) and its ms (CUDA
events, the median of three calls after one), in the blocked form and in
the whole-leaf form (the block thresholds raised past the leaf):

- ``adamw.adamw_update`` on OLMoE-1B-7B's expert leaf [16, 64, 2048, 1024]
  (p, g and bf16 moments), and ``adamw.global_norm`` of its gradient;
- ``adafactor.adafactor_update`` on Grok-1's one-layer expert leaf
  [1, 16, 6144, 16384] (one slice of 16 blocks), Nemotron-4-340B's
  one-layer MLP leaf [1, 18432, 73728] and its embedding [256000, 18432],
  each above ``adafactor.ROW_BLOCK_ELEMENTS`` and so updated a row block
  at a time.

A whole-leaf form that does not fit reports ``"oom": true``. Then, on a
smaller leaf above the threshold ([16, 64, 2048, 128]), the blocked AdamW
update's bits against the whole-leaf form's, and the blocked Adafactor
update's largest difference from its whole-leaf form. Last, phase 23's
Jamba layer 0 (published width, Adafactor, ``train_accum`` 8, 8 x 2048
tokens): the ms and peak of its eight microbatches' gradients summed
leaf by leaf as the backward makes them (``steps.accumulate_grad``, the
training step's form) against whole trees summed after each backward
(``steps.value_and_grad``), and the ms of its Adafactor update on that
sum as the step takes it against whole-leaf (the same form where no leaf
is above the row block, as Jamba's [65536, 8192] embedding is not); each
pair runs A B B A after one untimed call of each.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from repro_torch.optim import adafactor, adamw  # noqa: E402

OLMOE_EXPERTS = (16, 64, 2048, 1024)
ADAFACTOR_LEAVES = {"grok_experts": (1, 16, 6144, 16384),
                    "nemotron_mlp": (1, 18432, 73728),
                    "nemotron_embed": (256000, 18432)}
BITS_LEAF = (16, 64, 2048, 128)
# the attribute whose raising past a leaf gives the whole-leaf form
THRESHOLD = {adamw: "SLICE_ELEMENTS", adafactor: "ROW_BLOCK_ELEMENTS"}


def draw(shape, seed, scale=1.0) -> torch.Tensor:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(
        torch.bfloat16)


def call_ms(fn) -> float:
    """Device ms of one call of ``fn`` (CUDA events around it)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def peak_above(fn, reps: int = 0) -> dict:
    """Run ``fn``; the GB it allocated above the resident bytes, or oom;
    with ``reps``, the median ms of ``reps`` further calls."""
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    try:
        fn()
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        return {"oom": True, "resident_gb": resident / 1e9}
    out = {"oom": False, "resident_gb": resident / 1e9,
           "peak_above_gb": (torch.cuda.max_memory_allocated() - resident)
           / 1e9}
    if reps:
        out["ms"] = sorted(call_ms(fn) for _ in range(reps))[reps // 2]
    return out


def adamw_state(shape, seed):
    cfg = adamw.AdamWConfig(moment_dtype=torch.bfloat16)
    params = {"w": draw(shape, seed, 0.02)}
    state = adamw.adamw_init(params, cfg)
    state["m"]["w"].copy_(draw(shape, seed + 1, 1e-3))
    state["v"]["w"].copy_(draw(shape, seed + 2, 1e-3).abs())
    return cfg, params, {"w": draw(shape, seed + 3, 1e-3)}, state


def adafactor_state(shape, seed):
    cfg = adafactor.AdafactorConfig(lr=6e-4)
    params = {"w": draw(shape, seed, 0.02)}
    return cfg, params, {"w": draw(shape, seed + 1, 1e-3)}, \
        adafactor.adafactor_init(params, cfg)


@contextlib.contextmanager
def form_of(module, form: str):
    """Within the block, ``form`` "whole" raises the module's block
    threshold past any leaf; "blocked" leaves it."""
    old = getattr(module, THRESHOLD[module])
    if form == "whole":
        setattr(module, THRESHOLD[module], 1 << 62)
    try:
        yield
    finally:
        setattr(module, THRESHOLD[module], old)


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_optim_memory: no CUDA device", file=sys.stderr)
        return 1
    card = torch.cuda.get_device_name(0)
    for form in ("blocked", "whole"):
        cfg, p, g, s = adamw_state(OLMOE_EXPERTS, 1)
        with form_of(adamw, form):
            upd = peak_above(lambda: adamw.adamw_update(p, g, s, cfg), 3)
            norm = peak_above(lambda: adamw.global_norm(g), 3)
        emit(card=card, fn="adamw_update", leaf=OLMOE_EXPERTS, form=form,
             blocks=adamw.row_blocks(p["w"], 64) if form == "blocked" else 1,
             **upd)
        emit(card=card, fn="global_norm", leaf=OLMOE_EXPERTS, form=form,
             blocks=adamw.row_blocks(g["w"], 32) if form == "blocked" else 1,
             **norm)
        del p, g, s
        torch.cuda.empty_cache()
    for name, leaf in ADAFACTOR_LEAVES.items():
        for form in ("blocked", "whole"):
            cfg, p, g, s = adafactor_state(leaf, 2)
            with form_of(adafactor, form):
                upd = peak_above(
                    lambda: adafactor.adafactor_update(p, g, s, cfg), 3)
            emit(card=card, fn="adafactor_update", name=name, leaf=leaf,
                 form=form, **upd)
            del p, g, s
            torch.cuda.empty_cache()
    outs = {}
    for form in ("blocked", "whole"):
        cfg, p, g, s = adamw_state(BITS_LEAF, 3)
        with form_of(adamw, form):
            adamw.adamw_update(p, g, s, cfg)
        outs[form] = (p["w"], s["m"]["w"], s["v"]["w"])
    emit(card=card, fn="adamw_update", leaf=BITS_LEAF,
         blocks=adamw.row_blocks(outs["blocked"][0], 64),
         bit_equal=all(torch.equal(a.view(torch.int16), b.view(torch.int16))
                       for a, b in zip(outs["blocked"], outs["whole"])))
    outs = {}
    for form in ("blocked", "whole"):
        cfg, p, g, s = adafactor_state((1, 16, 512, 4096), 4)
        with form_of(adafactor, form):
            adafactor.adafactor_update(p, g, s, cfg)
        outs[form] = p["w"].float()
    emit(card=card, fn="adafactor_update", leaf=(1, 16, 512, 4096),
         max_abs_diff=float((outs["blocked"] - outs["whole"]).abs().max()),
         max_abs_param=float(outs["whole"].abs().max()))
    jamba_step_forms(card)
    return 0


def jamba_step_forms(card: str) -> None:
    """Phase 23's Jamba layer 0: its microbatches' gradients summed by
    ``steps.accumulate_grad`` ("leaf") against whole trees ("tree"), then
    its Adafactor update on the sum, "blocked" against "whole", each pair
    run ABBA (one call each, timed) after one untimed call of each."""
    import chip_smoke as cs
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.tree import tree_items, tree_map
    case = cs.family_cases()["jamba_1_5_large_398b"]
    cfg = cs.cut_layers(case.cfg, case.layers)
    dev = torch.device("cuda")
    params, _ = cs.init_params(cfg, torch.Generator(device=dev), dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(
        vocab=cfg.vocab, seq=case.seq, global_batch=case.batch
    ).batch(0).items()}
    mbs = steps._microbatches(batch, cfg.train_accum)

    def zeros():
        return tree_map(lambda p: torch.zeros(
            p.shape, dtype=cfg.accum_dtype, device=dev), params)

    def leaf(acc):
        for mb in mbs:
            steps.accumulate_grad(params, cfg, mb, acc)

    def tree(acc):
        for mb in mbs:
            _, g = steps.value_and_grad(params, cfg, mb)
            for (_, a), (_, b) in zip(tree_items(acc), tree_items(g)):
                a.add_(b.to(cfg.accum_dtype))
            del g
    forms = {"tree": tree, "leaf": leaf}
    got = {name: [] for name in forms}
    for name in ("tree", "leaf", "tree", "leaf", "leaf", "tree"):
        acc = None
        acc = zeros()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = call_ms(lambda: forms[name](acc))
        got[name].append({"ms": ms, "peak_gb":
                          torch.cuda.max_memory_allocated() / 1e9})
    for name, runs in got.items():
        emit(card=card, fn="jamba_layer0_microbatches", form=name,
             train_accum=cfg.train_accum, tokens=case.batch * case.seq,
             ms=[r["ms"] for r in runs[1:]],
             peak_gb=max(r["peak_gb"] for r in runs))
    ocfg, opt_init, _ = steps.make_optimizer(cfg)
    state = opt_init(params)
    times = {"blocked": [], "whole": []}
    for form in ("whole", "blocked", "whole", "blocked", "blocked",
                 "whole"):
        with form_of(adafactor, form):
            times[form].append(call_ms(lambda: adafactor.adafactor_update(
                params, acc, state, ocfg, 1e-3)))
    for form, ms in times.items():
        emit(card=card, fn="jamba_layer0_adafactor", form=form,
             ms=ms[1:])


if __name__ == "__main__":
    sys.exit(main())
