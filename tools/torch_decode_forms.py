#!/usr/bin/env python3
"""How far each form of paged decode attention puts the served tokens
from the dense oracles of ``chip_smoke.py``'s phase 4, on a GPU.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 tools/torch_decode_forms.py

It serves the smoke's main path (full-width olmo_1b, random weights from
seed 0, six prompts of 256-960 tokens, 32 tokens each) three times, each
with another function behind ``kernels.paged.paged_decode_attention``:

* ``kernel``: the CUDA kernel (scores and normalised P rounded to bf16,
  as the plain version rounds them);
* ``plain``: the plain version, ``kvcache.paged_attention.
  paged_gather_decode`` (bf16 matmuls);
* ``fp32``: the same split algorithm with no rounding before P·V
  (``ref.paged_decode_split_ref`` on fp32 copies of the operands, the
  output rounded to bf16 once).

For each it prints one JSON line with phase 4's verdict under its own
rules (a token within one bf16 step of the K4 oracle's top logit, or
within two where the plain dense form puts it within one) and every
inexact token with both gaps. Each run's served tokens differ where a
rounding step tips a near-tie, so the line also gives the first token
where each form parts from the kernel's.
"""

from __future__ import annotations

import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402
from repro_torch.configs import olmo_1b  # noqa: E402
from repro_torch.kernels import paged as kpaged  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.models import lm  # noqa: E402


def fp32_form(q, k, v, phys, logical, kv_len, *, scale):
    """The split algorithm without any bf16 rounding before P·V."""
    out, _ = kref.paged_decode_split_ref(
        q.float(), k.float(), v.float(), phys, logical, kv_len, scale=scale,
        n_split=kpaged.split_plan(q.shape[0], q.shape[1], phys.shape[1],
                                  k.shape[1]))
    return out.to(q.dtype)


def serve_with(form, cfg, params, prompts, dev):
    real = kpaged.paged_decode_attention
    kpaged.paged_decode_attention = form
    try:
        gen = torch.Generator(device=dev)
        gen.manual_seed(smoke.SEED)
        llm = smoke.main_path_llm(cfg, params, n_pages=1024, hot_pages=64,
                                  past_pages=64, device=dev, generator=gen)
        smoke.serve(llm, smoke.make_prompts(cfg, (128,), smoke.SEED + 1), 2)
        llm.clear_finished()
        return smoke.serve(llm, prompts, smoke.MAIN_MAX_TOKENS)["done"]
    finally:
        kpaged.paged_decode_attention = real


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_decode_forms: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = olmo_1b.config()
    gen = torch.Generator(device=dev)
    gen.manual_seed(smoke.SEED)
    params = lm.init(cfg, gen, dev)
    prompts = smoke.make_prompts(cfg, smoke.MAIN_PROMPTS, smoke.SEED)
    forms = {"kernel": kpaged.paged_decode_attention,
             "plain": kpaged.paged_decode_reference, "fp32": fp32_form}
    served = {}
    for name, form in forms.items():
        done = served[name] = serve_with(form, cfg, params, prompts, dev)
        first_diff = next(([i, j] for i, toks in enumerate(done)
                           for j, t in enumerate(toks)
                           if t != served["kernel"][i][j]), None)
        line = {"form": name, "first_token_apart_from_kernel": first_diff}
        try:
            ex = smoke.check_exact(params, cfg, prompts, done)
            line.update(phase4="pass", exact=ex["exact"],
                        bf16_ties=ex["bf16_ties"], inexact=ex["inexact"])
        except SystemExit as fail:
            line.update(phase4="fail", reason=str(fail))
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
