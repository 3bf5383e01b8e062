#!/usr/bin/env python3
"""How far apart InternVL2-26B's bf16 evaluations lie, row by row, on
``chip_smoke.py``'s phase 18b: the served logits of the paged engine's
``star=None`` run (K1), of the same run with K1's plain version, and
three cache-free forwards over each served prefix (K4's, the plain dense
form's and ``hybrid_flash``'s, which rounds attention as the served path
does).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 tools/torch_served_logits.py

InternVL2-26B at full width and depth, random weights from the smoke's
seed, phase 18's prompts (1024, 2048 and 4096 tokens, 16 tokens each).
First a JSON line with both runs' tokens and how many agree; then one
line per request: each token's gap below each forward's top and the
served logits' margin over their runner-up (bf16 steps of the top), and
for each row the largest difference over the reference's 16 largest
logits, in bf16 steps of its top, between the served logits and K4's,
the served and the hybrid, the plain and K4's, the hybrid and K4's, and
K1's served run and the plain version's (on requests whose tokens
agree); then a line with the card's name and power limit.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402
from repro_torch.configs import internvl2_26b  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import paged as kpaged  # noqa: E402

TOP = 16


def apart(a, b, k: int = TOP) -> list:
    """Per row, the largest |a - b| over b's k largest entries, in bf16
    steps of b's top (NaN where a row of ``a`` was not recorded)."""
    idx = b.topk(k, dim=-1).indices
    d = (a.gather(-1, idx) - b.gather(-1, idx)).abs().max(dim=-1).values
    return (d / smoke.bf16_step(b.max(dim=-1).values)).tolist()


def serve(cfg, params, prompts, max_tokens, dev, gen, plain_k1: bool):
    """Phase 18b's paged run, its decode logits recorded; with
    ``plain_k1`` K1's wrapper is swapped for its plain version."""
    real = kpaged.paged_decode_attention
    if plain_k1:
        kpaged.paged_decode_attention = kpaged.paged_decode_reference
    try:
        run, _, logits = smoke.serve_exact(cfg, params, prompts,
                                           max_tokens, dev, gen, True)
    finally:
        kpaged.paged_decode_attention = real
    return run["done"], logits


@torch.inference_mode()
def compare(cfg, dev, lengths, max_tokens) -> list:
    """The JSON rows this tool prints (without the card's)."""
    gen = torch.Generator(device=dev)
    params, _ = smoke.init_params(cfg, gen, dev)
    prompts = smoke.make_prompts(cfg, lengths, smoke.SEED + 31)
    dense = dataclasses.replace(cfg, star=None)
    smoke.warm_prefill(params, dense, lengths[0])
    done, served = serve(cfg, params, prompts, max_tokens, dev, gen, False)
    done_plain, served_plain = serve(cfg, params, prompts, max_tokens, dev,
                                     gen, True)
    rows = [{"tokens_equal": sum(a == b for x, y in zip(done, done_plain)
                                 for a, b in zip(x, y)),
             "tokens_k1": done, "tokens_plain_k1": done_plain}]
    real = smoke.ops.flash
    for rid, prompt in enumerate(prompts):
        toks = done[rid]
        seq = torch.as_tensor(smoke.np.concatenate(
            [prompt.astype(smoke.np.int64),
             smoke.np.asarray(toks[:-1], smoke.np.int64)])[None], device=dev)
        at = slice(len(prompt) - 1, len(prompt) - 1 + len(toks))
        fwd = {}
        for name, flash in (("k4", real), ("plain", smoke.plain_flash),
                            ("hybrid", smoke.hybrid_flash(len(prompt)))):
            smoke.ops.flash = flash
            try:
                fwd[name] = smoke.lm.forward(params, dense, {"tokens": seq})[
                    0, at, :cfg.vocab].float()
            finally:
                smoke.ops.flash = real
        ids = torch.as_tensor(toks, device=dev)
        s = served[rid]
        top2 = s.topk(2, dim=-1).values
        row = {"request": rid, "prompt": len(prompt),
               **{f"gap_{n}": smoke.token_gaps(x, ids)[1].tolist()
                  for n, x in fwd.items()},
               "served_margin": ((top2[:, 0] - top2[:, 1])
                                 / smoke.bf16_step(top2[:, 0])).tolist(),
               "served_vs_k4": apart(s, fwd["k4"]),
               "served_vs_hybrid": apart(s, fwd["hybrid"]),
               "plain_vs_k4": apart(fwd["plain"], fwd["k4"]),
               "hybrid_vs_k4": apart(fwd["hybrid"], fwd["k4"])}
        if done_plain[rid] == toks:
            row["k1_vs_plain_k1"] = apart(s, served_plain[rid])
        rows.append(row)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_served_logits: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    for row in compare(internvl2_26b.config(), torch.device("cuda"),
                       smoke.INTERNVL_PROMPTS, smoke.INTERNVL_MAX_TOKENS):
        print(json.dumps(row), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
