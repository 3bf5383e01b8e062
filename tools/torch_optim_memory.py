#!/usr/bin/env python3
"""Peak card memory of the optimizers' large-leaf updates, blocked against
whole-leaf. One GPU:

    python3 tools/torch_optim_memory.py

Three measurements, each on fresh bf16 tensors of a leaf that phase 23 of
``chip_smoke.py`` trains, printing one JSON line each: the bytes the call
allocates above what was resident before it (``max_memory_allocated``
minus the resident bytes), in the blocked form and in the whole-leaf form
(the block thresholds raised past the leaf):

- ``adamw.adamw_update`` on OLMoE-1B-7B's expert leaf [16, 64, 2048, 1024]
  (p, g and bf16 moments), and ``adamw.global_norm`` of its gradient;
- ``adafactor.adafactor_update`` on Grok-1's one-layer expert leaf
  [1, 16, 6144, 16384], which the reference updates whole (one slice) and
  the port in two passes over its 16 expert blocks, as it takes every
  slice above 2^24 elements of several blocks (a layer of a deeper cut).

A whole-leaf form that does not fit reports ``"oom": true``. Then, on a
smaller leaf above the threshold ([16, 64, 2048, 128]), the blocked AdamW
update's bits against the whole-leaf form's, and the blocked Adafactor
update's largest difference from its whole-leaf form.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]

from repro_torch.optim import adafactor, adamw  # noqa: E402

OLMOE_EXPERTS = (16, 64, 2048, 1024)
GROK_EXPERTS = (1, 16, 6144, 16384)
BITS_LEAF = (16, 64, 2048, 128)


def draw(shape, seed, scale=1.0) -> torch.Tensor:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(
        torch.bfloat16)


def peak_above(fn) -> dict:
    """Run ``fn``; the GB it allocated above the resident bytes, or oom."""
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    try:
        fn()
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        return {"oom": True, "resident_gb": resident / 1e9}
    return {"oom": False, "resident_gb": resident / 1e9,
            "peak_above_gb": (torch.cuda.max_memory_allocated() - resident)
            / 1e9}


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
    old = module.SLICE_ELEMENTS
    if form == "whole":
        module.SLICE_ELEMENTS = 1 << 62
    try:
        yield
    finally:
        module.SLICE_ELEMENTS = old


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
            upd = peak_above(lambda: adamw.adamw_update(p, g, s, cfg))
            norm = peak_above(lambda: adamw.global_norm(g))
        emit(card=card, fn="adamw_update", leaf=OLMOE_EXPERTS, form=form,
             blocks=adamw.row_blocks(p["w"], 64) if form == "blocked" else 1,
             **upd)
        emit(card=card, fn="global_norm", leaf=OLMOE_EXPERTS, form=form,
             blocks=adamw.row_blocks(g["w"], 32) if form == "blocked" else 1,
             **norm)
        del p, g, s
        torch.cuda.empty_cache()
    for form in ("blocked", "whole"):
        cfg, p, g, s = adafactor_state(GROK_EXPERTS, 2)
        with form_of(adafactor, form):
            upd = peak_above(lambda: adafactor.adafactor_update(p, g, s, cfg))
        emit(card=card, fn="adafactor_update", leaf=GROK_EXPERTS, form=form,
             **upd)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
