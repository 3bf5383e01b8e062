#!/usr/bin/env python3
"""On-card smoke of the PyTorch port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printing its numbers on a line of its own:

1. the card's name and power limit; the build of every CUDA kernel from
   ``src/repro_torch/csrc`` (nvcc, sm_90a) into ``build/``, with ptxas's
   registers and spills for each kernel instantiation;
2. K1 (paged decode) against its plain PyTorch version on the card, at the
   main path's shapes, at the whole-prompt phase's decode shape (W = 130)
   and at a GQA case with padded slots, bf16 at 2e-2, two calls bit-equal,
   with each split plan and, for the first two, the time beside its
   bound, the plain version's and one PyTorch call's (SDPA over the
   gathered rows, a yardstick the port never calls); then K1's int8 form
   (the cold KV tier) at the main path's shape with about half the slots
   marked, against its plain version at 2e-2, two calls bit-equal, timed
   the same way (SDPA over the gathered rows dequantized beforehand), and
   with ``quant`` present but an all-False qmask, bit-equal to the fp
   form. Its codes are drawn apart from the fp rows, each page at its own
   magnitude, and the fp form and the plain version fed the next page's
   scales must each break the tolerance and lie 4x the kernel's error
   off: the check can tell an ignored qmask or a wrong scale. Both forms
   again, timed, at the decode shapes of the wide GQA groups: ChatGLM3-6B
   (G 2, R 16, W covering phase 10's longest sequence), StarCoder2-15B
   (G 4, R 12) and Grok-1 (B 1, G 8, R 6, W covering phase 15's
   sequence); the fp form at InternVL2-26B's (B 3, G 8, R 6, W 258:
   phase 18's three requests). Then K1's unnormalised (m, l, o) form
   over sequence-sharded pools (every shard in one launch sequence), fp
   and int8 lanes, at phase 13's decode shape (4 shards, B 4, G 16, R 1,
   d 128) and at ChatGLM3-6B's group (R 16), each timed beside its bound (the K/V rows read across all
   shards), its plain version and one PyTorch call that yields the same
   merge state (memory-efficient SDPA over every shard's gathered rows with
   its log-sum-exp), and untimed with a shard that holds no row: m, l and
   o/l at 2e-2, two calls bit-equal, the empty shard's state neutral;
3. the main path: full-width OLMo-1B (random weights from a seed) served
   through ``LLM.from_config(backend="paged")``: TTFT, tokens/s, decode
   ticks, and K1's launches, which must equal ticks x layers;
4. exactness: every served token is the greedy argmax of a dense forward
   (``star=None``, K4) over the served prefix, up to a tie of one bf16
   step of the top logit, or of two steps where the plain dense form
   (``attention._dense_chunked``) puts the token within one step
   (``check_exact``);
5. bounded DLZS sparse decode (``decode_hot_width`` below the live page
   count), which runs the page scores and the sphere selection every tick;
6. the prefill tile kernels against their plain versions on the card,
   bf16 at OLMo-1B's served shapes (BH 16, d 128, tiles 128, T = S of
   1024 and 2048), two calls bit-equal for K2 and K3: K2 (DLZS block
   maxima; its wgmma form at the served tiles, also non-causal; its
   mma.sync form at the pool probe's 16-row tile and at 64), K3 (SU-FA,
   both ``strict`` modes, reading the tiles the glue selects in place
   from their ids; its wgmma form at the served tiles and d = 64, its
   mma.sync form at tiles of 16 and 64) and K4 (flash; also at a ragged
   T of 991, at T = S = 1 and 129, and at d = 64), each timed beside its
   bound, its plain version and one PyTorch call (SDPA, for K3 over the
   gathered rows that its old contract read; none computes K2's block
   maxima); and K3 with STAR's element-level sphere mask (T = 2048, both
   modes: its wgmma form at tiles 128, timed, and at d = 64; its mma.sync
   form at tiles of 64, timed), with the share of keys the sphere drops
   and the share of mask elements a default cuBLAS product would set
   otherwise; then, untimed, phases 10-12's shapes: K2, K3
   (both modes, with and without the element mask) and K4 at ChatGLM3-6B's
   longest prompt (BH 32, T 4096), and K3's element mask at star_paper's
   (BH 32, T 2048); then, timed, phase 19's forms at SeamlessM4T's head
   size (BH 16, d 64): K2 and K3 (both modes, on the glue's selection)
   non-causal at 2048 frames, K4 non-causal with T != S (256 decoder rows
   over 2048 encoder rows, and over a ragged 1000), and phase 18's: K2,
   K3 and K4 at InternVL2-26B's BH 48, T 4096, d 128;
7. the fused STAR prefill (``kernels.ops``: K2 -> SADS -> K3) against the
   plain ``core.star_attention_scanq`` at every layer of a 2048-token
   STAR forward, each fed the same q/k/v: the share of (head, q-tile)
   rows whose kept tile set agrees, and the error where it does;
8. the whole-prompt prefill served (``SchedulerCfg(chunk_pages=None)``,
   STAR on): prompts of 1024, 1536 and 2048 tokens, each prefilled whole
   by ``lm.prefill``; K2 and K3 launch prefill calls x layers times (the
   pool probe included), in their wgmma form for every call but the pool
   probe's, K1 ticks x layers; each first token is the
   argmax of a cache-free STAR forward over the same bucketed prompt;
9. disaggregated serving (``DisaggRouter.from_config``): a prefill and a
   decode instance of full-width OLMo-1B over phase 3's params, each with
   512 pages, whole-prompt prefill and decode bounded at 8 pages with the
   int8 cold tier (``kv_quant="int8"``; the prefill instance decodes each
   request's first token before the hop, so it carries the same decode
   tuning), serve phase 8's prompts 32 tokens each; after every router
   tick page conservation and the refcount watchdog hold on both pools.
   The tokens must equal one instance's of the same configs; 3 hops, 0
   faults, payload bytes, both pools drained, pages quantized; K1 once
   per layer of every decode tick on either instance, in its int8 form
   on ticks where a gathered slot reads the tier and in its fp form on
   the others; K2 and K3 once per layer of every prefill call. Then one
   hop is lost to an injected fault (``FaultPlan``): every request still
   finishes, by decode-side recompute. Then the int8 tier is read: pages
   of 128 (STAR's q-tile, so prefixes are shared), the 2048-token prompt
   and, once its hop has landed, its first 1024 tokens as a second
   request, which shares the first's pages that the first's decode
   quantized; gathered slots must read the int8 tier (with distinct
   prompts they never do: a page leaves a lone sequence's hot set for
   good), and the tokens must equal one instance's that gets the second
   request at the same point. TTFT, tokens/s, decode ms per tick,
   transfer ms and bytes, quantized pages and int8 slots read are
   printed;
10. ChatGLM3-6B at full width and depth (28 layers, 32 heads over 2 KV
   heads, random weights from a seed) served through the paged engine
   with whole-prompt prefill, prompts of 1024, 2048 and 4096 tokens, 16
   tokens each: with STAR on, K1 launches = ticks x 28 (R = 16) and K2/K3
   = prefill calls x 28 (BH 32), each first token the argmax of a
   cache-free STAR forward or a 1-step tie; the fused STAR prefill
   against the plain scanq as in phase 7, at layers 0, 7, 14 and 21 of a
   4096-token forward; then the same requests with
   ``star=None`` (a STAR prefill keeps other K/V than a dense one, so only
   that setting has a dense oracle), every token held by phase 4's rule
   against a K4 forward;
11. the same requests through the dense slot engine
   (``LLM.from_config(backend="dense")``, ``star=None``): K4 once per
   layer of each prefill and no other kernel, every token held by phase
   4's rule;
12. StarCoder2-15B (K1 at R = 12) and star_paper (LLaMA-7B's shape) at
   their published widths with depth cut to 4 layers, one 2048-token
   prompt each through the paged engine (star_paper also with
   ``STARConfig(elementwise=True)``, K3's element mask): launch counts and
   first tokens as in phase 10.
13. the spatial (sequence-sharded) engine: full-width OLMo-1B (phase 3's
   seed, ``star=None``) through ``LLM.from_config(backend="spatial")``, 4
   shards on the card of 64 pages each, hot width covering each shard's
   pages, prompts of 1024, 1536 and 2048 tokens, 16 tokens each. A paged
   engine with one shard's pool (64 pages) must refuse the 2048-token
   prompt (129 pages) that the spatial engine serves. K1's stats form must
   launch ticks x 16 times (once per layer for every shard) and the
   normalised K1 never; every token is held by phase 4's rule against a K4
   forward. Then a run with the decode width bounded at 8 pages a shard,
   and a lone short request on the same engine, whose hot sets leave two
   shards empty: the per-shard skip counts, read from the host after the
   run, must be populated. TTFT, tokens/s and decode ms per tick are
   printed.
14. OLMoE-1B-7B at full width and depth (16 layers, 64 experts of d_ff
   1024, top-8; random weights from a seed), the Mixture-of-Experts FFN
   in every layer: (a) STAR on at the reference's capacity factor
   (1.25), prompts of 1024, 2048 and 4096 tokens served whole through the
   paged engine, 16 tokens each, launch counts and first tokens as in
   phase 10 (the forward over the same bucketed prompt routes the same
   tokens), the share of expert choices dropped per prefill printed;
   (b) ``star=None`` at dropless capacity (capacity_factor = experts /
   top_k, so no choice drops and no token's output depends on the
   others routed with it): every token held against dense forwards, K4's
   and the plain form's (each padded to whole pages, harmless when
   nothing drops, so that a prime length does not run one-token chunks),
   that route every row as the served path did: a served expert a
   forward's own gate leaves out (a flip: the two paths' rounding parts
   near-tied experts, and a random-weight MoE amplifies the difference
   into many logit steps) must lie no further below its k-th choice than
   rounding alone moves the gate between the two forwards at that layer,
   and each token is held by phase 4's rule with a third forward in K4's
   place, one that rounds as the served path does (K4 over the prompt,
   the plain form for each decoded row; ``check_exact``,
   ``moe_token_rule``); (c) the same through the dense slot engine; (d) the
   chunked-prefill main path at the reference's capacity (phase 3's
   scheduler and prompts): TTFT, tokens/s, decode ms per tick, K1
   launches = ticks x 16 and the dropped share (with drops a token's
   route depends on its batch, so this path's token parity is held on
   the CPU against the reference); then the MoE's share of the device
   time of one decode tick and of a 4096-token prefill
   (``torch.profiler``, ranges around ``moe.apply`` and its expert FFN).
15. Grok-1 at its published width (48 heads over 8 KV heads, 8 experts
   as 16 virtual ones, tanh GELU), depth cut to 2 of 64 layers: one
   2048-token prompt through the paged engine with STAR on at the
   reference's capacity (K1 at R = 6 launches ticks x 2 times, K2/K3
   prefill calls x 2, the first token as in phase 10), then dropless with
   ``star=None``, every token held as in 14b.
16. Jamba-1.5-Large at its published width (d_model 8192; Mamba blocks of
   256 SSD heads, 64 attention heads over 8 KV heads, 16 experts of d_ff
   24576, top-2), its depth cut to the first 5 of its 72 layers (4 Mamba,
   1 attention; 2 MoE FFNs), served through the dense slot engine (the
   only engine of either package that serves a recurrent block): first K2,
   K3 (both modes) and K4 against their plain versions at its attention
   layer's prefill shape (BH 64 after the GQA expansion, T 4096, tiles
   128), timed as in phase 6; then (a) STAR at the reference's capacity,
   prompts of 1024, 2048 and 4096 tokens, 16 tokens each: K2 = K3 =
   prefill calls x 1 (their wgmma forms), no other kernel, each first
   token against a cache-free STAR forward, the dropped share per
   prefill; (b) dropless ``star=None``: K4 = prefill calls x 1, every
   token held as in 14b; (c) ``backend="paged"`` refuses the pattern
   with the reference's ``ValueError``; then the device time of one
   4096-token prefill (STAR, and ``star=None``) split by block
   (``torch.profiler``): the Mamba blocks and their SSD chunk scan, the
   MoE and its expert FFN, attention and its kernels, the rest.
17. xLSTM-125M at full width and depth (12 layers of alternating mLSTM and
   sLSTM blocks, no attention, no FFN) through the dense slot engine,
   prompts of 1024 and 2048 tokens, 16 tokens each, in bf16 and in fp32:
   no kernel of the port launches (K1-K4 all 0); the fp32 run's every
   token held by phase 4's rule against the port's cache-free fp32
   ``lm.forward`` (its chunk-parallel mLSTM and sLSTM loop, no kernel);
   the bf16 run's, whose random weights amplify rounding past phase 4's
   ties, against the fp32 forward within the bf16 forward's own spread
   (``check_rounding_spread``); then one bf16 2048-token prefill with the
   share of its host time the sLSTM time loop takes, and a 1024-token
   prefill's device split.
18. InternVL2-26B at full width and depth (48 layers, 48 heads over 8 KV
   heads, d_ff 16384; random weights from a seed) served through the
   paged engine with whole-prompt prefill, prompts of 1024, 2048 and 4096
   tokens, 16 tokens each: (a) STAR on, K1 launches = ticks x 48 (R = 6)
   and K2/K3 = prefill calls x 48 (BH 48), each first token the argmax of
   a cache-free STAR forward or a 1-step tie; (b) ``star=None``, every
   token held by phase 4's rule against a K4 forward, with the served
   logits (recorded each tick) as a second witness beside the plain
   form: a token 2 bf16 steps below K4's top is a tie where the served
   logits put K4's top within one step of their own (its 48 random
   layers put one token 2 steps below both forwards' tops at a tie of
   the served logits); again with K1 swapped for its plain version,
   held the same way, its tokens beside K1's; and through the dense
   slot engine, by phase 4's rule alone, with the count of its tokens
   equal to the paged engine's; (c) the ViT stub's
   input: one ``lm.prefill`` over [1, 2048, 6144] patch embeddings from a
   seeded generator (K2 = K3 = 48), its first token against the STAR
   forward over the same embeddings, then 4 ``decode_step``s.
19. SeamlessM4T-large-v2 at full width and depth (24 encoder and 24
   decoder layers, 16 heads of 64, d_ff 8192, vocab 256206) through
   ``lm.prefill`` and ``lm.decode_step`` (no engine of either package
   serves it): two utterances of 1024, then of 2048 speech-frame
   embeddings from a seeded generator, with 256-token decoder prompts,
   then 16 greedy decode steps each. (a) STAR on: K2 = K3 = prefills x 48
   (24 of them the encoder's, non-causal), K4 = prefills x 24 (the
   cross-attention, non-causal, T != S), no K1; each first token against
   a cache-free STAR forward as in phase 8; (b) ``star=None``: K4 =
   prefills x 72, every token held by phase 4's rule against a K4
   forward over the same frames.
20. training: (a) K4's backward (``csrc/flash_bwd.cu``) against its plain
   version at BH 16 and at OLMo-1B's training shape (BH 128; T = S 2048,
   d 128, causal), a ragged T = S = 1000 and non-causal T 256 over S
   2048 at d 64: dQ, dK and dV each within twice the bf16 plain
   gradient's error against the fp32 one (plus 1e-5), two calls
   bit-equal, K4's lse at 1e-4 and its O bit-equal with and without
   lse; the training shape and the non-causal one timed beside their
   bounds, the plain version and SDPA's backward, with each of the
   backward's two kernels' device time (prep, and the key-tile pass that
   computes dK, dV and dQ; by ``torch.profiler``), the achieved TFLOP/s
   and ptxas's register and spill lines of ``flash_bwd.cu``; (b) OLMo-1B
   at full width and depth trained 20 steps of 8 x 2048 ``SyntheticLM``
   tokens through ``launch.steps.make_train_step`` and
   ``runtime.train_loop``
   (AdamW with bf16 moments, ``remat="full"``, lr 6e-4, warmup 5), one
   final save under ``build/`` that the phase removes: the loss falls by
   more than 0.1, every loss and grad norm finite, K4 = steps x 32 and
   its backward steps x 16, K1-K3 never; step ms, tokens/s, MFU, peak
   memory, the save's seconds and bytes, and one more step profiled;
   (c) in a child process with deterministic algorithms (``--restart-child
   DIR``), 2 of its 16 layers: a run failed at step 7 and resumed from
   step 5 ends with the uninterrupted run's params and optimizer state,
   bit for bit; (d) one 2-layer step's loss and gradients against the
   same step on the plain path in fp32 (``flash_ref`` under autograd):
   loss and grad norm within 2e-2, each leaf within twice the bf16 plain
   path's error.
21. STAR in training (``ModelCfg.star_train``): (a) K3's optional lse
   (strict and fast: O bit-equal with and without it, the plain lse at
   1e-4) and K3's backward (``csrc/sufa_bwd.cu``) on the glue's selection
   against its plain version (``sufa_bwd_ref``) by phase 20a's rule, for
   the backward of either forward, two calls bit-equal: OLMo-1B's
   training shape (BH 128, T = S = 2048, d 128, causal, keep 4 of 16),
   SeamlessM4T's encoder (BH 16, T = S = 2048, d 64, not causal), T 256
   over S 2048, and edges (invalid slots, a key tile no q-tile chose
   with dK = dV = 0, a q-tile with no valid slot with dQ = 0); the first
   two timed beside their bounds (10·d flops per visible selected pair),
   the plain version and SDPA's backward under the selection's dense
   mask, with the split of its three kernels; (b) OLMo-1B with
   ``star_train`` trained as in 20b: the loss falls by more than 0.1,
   K2 = K3 = steps x 32, K3's backward steps x 16, K1 and K4 never; step
   ms, tokens/s, MFU, peak memory and one profiled step's split (K2, K3,
   K3's backward, the selection glue, GEMMs, AdamW, the rest); (c) 20c's
   restart check with ``star_train``, in 20c's child process after the
   dense run; (d) 20d's model step with ``star_train``, the plain runs
   taking the kernel run's tile ids.
Phase 4 also counts K4: oracle forwards x attention layers launches (an
encoder-decoder forward's: its encoder, self- and cross-attention
layers).

Then one JSON line with every kernel's numbers and, last, the device line.
Without a GPU, or outside a checkout, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
BUILD_DIR = ROOT / "build"
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import (chatglm3_6b, grok_1_314b,  # noqa: E402
                                 internvl2_26b, jamba_1_5_large_398b,
                                 olmo_1b, olmoe_1b_7b, seamless_m4t_large_v2,
                                 star_paper, starcoder2_15b, xlstm_125m)
from repro_torch.core import sads  # noqa: E402
from repro_torch.core import star_attention as core_star  # noqa: E402
from repro_torch.kernels import build, launch, ops  # noqa: E402
from repro_torch.kernels import dlzs as kdlzs  # noqa: E402
from repro_torch.kernels import flash as kflash  # noqa: E402
from repro_torch.kernels import paged as kpaged  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels import sufa as ksufa  # noqa: E402
from repro_torch.kvcache import bucketing, quant  # noqa: E402
from repro_torch.kvcache.paged_attention import (  # noqa: E402
    dequantized_slabs, fold_shards)
from repro_torch.models import attention, lm, moe, xlstm  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch import profiling  # noqa: E402
from repro_torch.serving import (LLM, DisaggRouter, EngineCfg,  # noqa: E402
                                 FaultPlan, PagedEngineCfg, SchedulerCfg)
from repro_torch.spatial import SpatialEngineCfg  # noqa: E402
from repro_torch.tree import sorted_items, tree_leaves, tree_map  # noqa
from repro_torch.data import PrefetchLoader, SyntheticLM  # noqa: E402
from repro_torch.launch import steps as launch_steps  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import TrainLoopCfg, train_loop  # noqa: E402

SEED = 0
# NVIDIA H100 SXM data sheet: HBM3 rate and dense bf16 tensor-core peak
HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12
TOL = 2e-2                  # bf16 bound of tests/test_kernels.py
REACH = 4                   # a wrong int8 form lies >= 4x K1's error off
L2_FLUSH_BYTES = 256 << 20  # > the 50 MB L2: each timed launch starts cold

MAIN_PROMPTS = (256, 384, 512, 704, 896, 960)
MAIN_MAX_TOKENS = 32
# OLMo-1B's published context is 2048; 1536 is padded to its 2048 bucket
WHOLE_PROMPTS = (1024, 1536, 2048)
WHOLE_MAX_TOKENS = 16
# phase 9: the whole-prompt prompts, 32 tokens each, decode bounded at 8
# pages (the cold tier is read from the first page the window leaves)
DISAGG_MAX_TOKENS = 32
DISAGG_HOT_WIDTH = 8
# phases 10-11: ChatGLM3-6B at full width and depth; its published context
# is 8192
GLM_PROMPTS = (1024, 2048, 4096)
GLM_MAX_TOKENS = 16
# phase 12: StarCoder2-15B and star_paper (LLaMA-7B) at their published
# widths, depth cut to CUT_LAYERS, one CUT_PROMPT-token prompt each
CUT_LAYERS = 4
CUT_PROMPT = 2048
# phase 13: OLMo-1B through the spatial engine, 4 shards of 64 pages on
# the card; the 2048-token prompt needs 129 pages, twice one shard's pool;
# the bounded run gathers at most 8 pages a shard
SPATIAL_PROMPTS = (1024, 1536, 2048)
SPATIAL_MAX_TOKENS = 16
SPATIAL_SHARDS = 4
SPATIAL_PAGES_LOCAL = 64
SPATIAL_HOT_WIDTH = 8
# phase 14: OLMoE-1B-7B at full width and depth; its published context is
# 4096
OLMOE_PROMPTS = (1024, 2048, 4096)
OLMOE_MAX_TOKENS = 16
# phase 15: Grok-1 at its published width, depth cut to GROK_LAYERS of 64
GROK_LAYERS = 2
GROK_PROMPT = 2048
GROK_MAX_TOKENS = 16
# phase 16: Jamba-1.5-Large at its published width, the first JAMBA_LAYERS
# of its 72 layers (the published order: 4 Mamba, 1 attention; MoE FFNs at
# 1 and 3); its published context is 256K, so prompts up to 4096 stay
# multiples of the SSD chunk (256)
JAMBA_LAYERS = 5
JAMBA_PROMPTS = (1024, 2048, 4096)
JAMBA_MAX_TOKENS = 16
# phase 17: xLSTM-125M at full width and depth
XLSTM_PROMPTS = (1024, 2048)
XLSTM_MAX_TOKENS = 16
# phase 18: InternVL2-26B at full width and depth; its published context
# is 8192; then one prefill over INTERNVL_EMBEDS patch embeddings and
# INTERNVL_DECODE_STEPS decode steps
INTERNVL_PROMPTS = (1024, 2048, 4096)
INTERNVL_MAX_TOKENS = 16
INTERNVL_EMBEDS = 2048
INTERNVL_DECODE_STEPS = 4
# phase 19: SeamlessM4T-large-v2 at full width and depth: batches of 2
# utterances of SEAMLESS_FRAMES encoder frames and SEAMLESS_PROMPT decoder
# tokens, SEAMLESS_DECODE_STEPS decode steps each
SEAMLESS_FRAMES = (1024, 2048)
SEAMLESS_PROMPT = 256
SEAMLESS_BATCH = 2
SEAMLESS_DECODE_STEPS = 16
# K2: fp32 sums of exact bf16 x pow2 products, only their order differs
# from the plain version's; K3: tests/test_kernels.py's SU-FA bf16 bound
PREFILL_TOL = {"dlzs_block": 1e-4, "sufa": 3e-2, "flash": TOL}
SDPA = torch.nn.functional.scaled_dot_product_attention
# phase 4's ties, in bf16 steps of the top logit: the K4 oracle (fp32
# scores) and the served path (bf16 scores) round apart at each layer. A
# token within TIE_STEPS of K4's top is a tie; one within PLAIN_TIE_STEPS
# is a tie only where the plain dense form, which rounds scores and P to
# bf16 as the served path does, puts it within TIE_STEPS of its own top.
TIE_STEPS = 1
PLAIN_TIE_STEPS = 2
PLAIN_Q_CHUNK = 1024        # the reference olmo_1b's dense-prefill q-chunk
# phase 20: OLMo-1B trained at full width and depth, TRAIN_STEPS steps of
# TRAIN_BATCH x TRAIN_SEQ tokens (its published context); the restart
# check at RESTART_LAYERS of its 16 layers
TRAIN_SEQ = 2048
TRAIN_BATCH = 8
TRAIN_STEPS = 20
TRAIN_LR = 6e-4
TRAIN_WARMUP = 5
RESTART_LAYERS = 2
RESTART_BATCH = 4
# K4's backward's kernels (csrc/flash_bwd.cu), by name prefix
BWD_KERNELS = ("bwd_prep", "bwd_kv")
# phase 21: STAR in training; K3's backward's kernels (csrc/sufa_bwd.cu)
SUFA_BWD_KERNELS = ("sufa_grad_prep", "sufa_grad_kv", "sufa_grad_q")
STARTED = time.perf_counter()


def emit(tag: str, **fields) -> None:
    """One JSON line for a phase's record, with ``t_s``: the seconds since
    the script started."""
    print(json.dumps({"phase": tag, **fields,
                      "t_s": time.perf_counter() - STARTED}), flush=True)


def attn_layers(cfg) -> int:
    """Attention layers: one K2/K3 or K4 launch each per prefill."""
    return cfg.n_repeat * sum(blk.kind == "attn" for blk in cfg.pattern)


def cross_layers(cfg) -> int:
    """Cross-attention layers: one K4 launch each per prefill or forward
    of an encoder-decoder model."""
    return cfg.n_repeat * sum(blk.cross_attn for blk in cfg.pattern)


def dense_k4_layers(cfg) -> int:
    """K4 launches of one dense (``star=None``) forward or prefill: every
    self-attention layer, the encoder's included, and every
    cross-attention layer."""
    return attn_layers(cfg) + cfg.enc_layers + cross_layers(cfg)


def moe_layers(cfg) -> int:
    """MoE layers: one routing plan each per prefill or decode call."""
    return cfg.n_repeat * sum(blk.ffn == "moe" for blk in cfg.pattern)


# -- timing ------------------------------------------------------------------

HOST_LEAD_CYCLES = 200_000  # ~0.1 ms of device spin before each timed call


def time_ms(fn, iters: int = 50, flush=None) -> float:
    """Median device time of ``fn`` over ``iters`` launches, CUDA events
    around each launch; ``flush`` (a tensor) is overwritten between
    launches so each one finds the L2 cold, as a decode layer does. A
    device-side spin after the flush keeps the card busy while the host
    enqueues the timed call, so a slow host (Python wrappers, several
    launches per call) cannot leave the card idle between the events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(HOST_LEAD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        events.append((start, stop))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in events]))


def nbytes(*tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


def held(tag: str, got, want, tol: float, **case) -> dict:
    """Max error of ``got`` against the plain ``want``; any element past
    tol + tol·|want| fails the run."""
    err = (got.float() - want.float()).abs()
    bad = int((err > tol + tol * want.float().abs()).sum())
    out = {**case, "max_abs_err": float(err.max()), "tolerance": tol,
           "violations": bad}
    if bad:
        emit(tag, ok=False, **out)
        raise SystemExit(f"{tag}: the kernel disagrees with its plain "
                         f"version: {out}")
    return out


def add_times(out: dict, kernel, plain, library, flush, *, bytes_: int,
              flops: int) -> None:
    """Kernel, plain and library times (median of 50 launches after an L2
    flush), the kernel again to see the spread, and the least time the
    card could take: bytes each read or written once over the HBM rate,
    or the bf16 operations over the tensor-core peak, whichever is
    larger."""
    out["ms"] = time_ms(kernel, flush=flush)
    out["plain_ms"] = time_ms(plain, flush=flush)
    out["library_ms"] = None if library is None else time_ms(library,
                                                             flush=flush)
    out["ms_repeat"] = time_ms(kernel, flush=flush)
    t_bytes, t_ops = bytes_ / HBM_BYTES_S, flops / BF16_FLOP_S
    out.update(bound_ms=1e3 * max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bound_bytes=bytes_, bound_flops=flops)


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


def paged_work(q, k, phys, kv_len) -> tuple[int, int]:
    """Bytes and flops of the same work: each input read once and the
    output written once (only the K/V rows these block tables name below
    kv_len, the data-dependent part), and 4·R·d flops per K/V row pair
    and head (far below the bf16 ridge: bound by bytes)."""
    b, g, r, d = q.shape
    rows = int(kv_len.sum())
    kv_bytes = rows * g * d * 2 * k.element_size()
    io_bytes = 2 * nbytes(q) + (2 * phys.numel() + kv_len.numel()) * 4
    return kv_bytes + io_bytes, 4 * rows * g * r * d


def sdpa_call(q, k, v, phys, logical, kv_len, scale, quant=None):
    """One PyTorch call computing the same attention: SDPA over the rows
    gathered (and, with ``quant``, dequantized) beforehand; the gather
    itself is not in the timed call."""
    from repro_torch.kvcache.paged_attention import _gather_hot
    b, g, r, d = q.shape
    kg, vg, valid = _gather_hot(k, v, phys, logical, kv_len, quant)
    kh = kg.transpose(1, 2).repeat_interleave(r, dim=1).contiguous()
    vh = vg.transpose(1, 2).repeat_interleave(r, dim=1).contiguous()
    qh = q.reshape(b, g * r, 1, d)
    mask = valid[:, None, None, :]
    return lambda: SDPA(qh, kh, vh, attn_mask=mask, scale=scale)


def check_paged_kernel(device, name, b, g, r, d, page, w, p, kv_len, seed,
                       timed: bool) -> dict:
    q, k, v, phys, logical, kvl = paged_inputs(b, g, r, d, page, w, p,
                                               kv_len, seed, device)
    scale = 1.0 / math.sqrt(d)
    got = kpaged.paged_decode_attention(q, k, v, phys, logical, kvl,
                                        scale=scale)
    again = kpaged.paged_decode_attention(q, k, v, phys, logical, kvl,
                                          scale=scale)
    want = kpaged.paged_decode_reference(q, k, v, phys, logical, kvl,
                                         scale=scale)
    out = held("k1_parity", got, want, TOL, case=name, shape=[b, g, r, d],
               page=page, W=w, P=p, kv_len=list(kv_len),
               n_split=kpaged.split_plan(b, g, w, page))
    if not torch.equal(got, again):
        raise SystemExit(f"k1_parity {name}: two calls on the same inputs "
                         f"gave different bits")
    if timed:
        flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
        bytes_, flops = paged_work(q, k, phys, kvl)
        add_times(out, lambda: kpaged.paged_decode_attention(
                      q, k, v, phys, logical, kvl, scale=scale),
                  lambda: kpaged.paged_decode_reference(
                      q, k, v, phys, logical, kvl, scale=scale),
                  sdpa_call(q, k, v, phys, logical, kvl, scale), flush,
                  bytes_=bytes_, flops=flops)
        del flush
    emit("k1_parity", ok=True, **out)
    return out


def int8_tier(k, phys, seed, share=0.5):
    """An int8 tier for every page and a qmask marking about ``share`` of
    the pages, and so of the slots: every slot naming a page reads it the
    same way, as the served tier reads a page that is cold, so the int8
    read is the fp read of ``dequantized_slabs`` (``phys`` of a sharded
    pool: its ids folded, ``fold_shards``). The codes quantize
    (``kvcache.quant``, as the served path quantizes a page) K and V rows
    drawn apart from the fp slabs', each page at a magnitude of its own,
    so that a form reading a marked slot's fp rows, or another page's
    scale, lands far from the plain version. V spans 2^±4; K spans 2^±1,
    because wider scores would make the bf16 rounding of scores, which
    the kernel shares with its plain version only up to the order of fp32
    sums, the larger difference."""
    gen = torch.Generator(device="cpu").manual_seed(seed + 1)
    shape = k.shape
    span = {"k": 1.0, "v": 4.0}
    rows = {}
    for name in ("k", "v"):
        mag = 2.0 ** ((2 * torch.rand(shape[0], generator=gen) - 1)
                      * span[name])
        rows[name] = (torch.randn(shape, generator=gen)
                      * mag[:, None, None, None]).to(k.device, k.dtype)
    kq, ks = quant.quantize_rows(rows["k"])
    vq, vs = quant.quantize_rows(rows["v"])
    marked = torch.rand(shape[0], generator=gen) < share
    qmask = marked[phys.clamp(min=0).long().cpu()].to(phys.device)
    return {"kq": kq, "vq": vq, "k_scale": ks, "v_scale": vs,
            "qmask": qmask}


def kv_read(k, logical, kv_len, qmask=None) -> tuple[int, int, int]:
    """The K/V rows that block tables [..., B, W] name below kv_len [B],
    each read once: their bytes (the fp rows of unmarked slots at the
    slab's width; the int8 rows and two fp32 page scales of slots
    ``qmask`` marks), the rows read, and the marked rows among them."""
    page, g, d = k.shape[-3:]
    first = logical.long() * page
    rows = ((kv_len.long()[:, None] - first).clamp(0, page)
            * (logical >= 0)).cpu()                      # [..., B, W]
    marked = (qmask.cpu() if qmask is not None
              else torch.zeros_like(rows, dtype=torch.bool)) & (rows > 0)
    rows_q = int(rows[marked].sum())
    rows_all = int(rows.sum())
    kv_bytes = ((rows_all - rows_q) * 2 * k.element_size() + rows_q * 2) \
        * g * d + int(marked.sum()) * 2 * 4
    return kv_bytes, rows_all, rows_q


def int8_work(q, k, phys, logical, kv_len, qmask) -> tuple[int, int]:
    """Bytes and operations of the int8 form's work: the K/V rows as
    ``kv_read`` counts them; q, the output, the tables and qmask once;
    4·R·d operations per row pair and head, and one product per
    dequantized element."""
    b, g, r, d = q.shape
    w = phys.shape[1]
    kv_bytes, rows_all, rows_q = kv_read(k, logical, kv_len, qmask)
    io_bytes = 2 * nbytes(q) + (2 * b * w + b) * 4 + b * w
    return kv_bytes + io_bytes, 4 * rows_all * g * r * d + 2 * rows_q * g * d


def check_paged_int8(device, name, b, g, r, d, page, w, p, kv_len, seed,
                     timed: bool) -> dict:
    """K1's int8 form against its plain version with about half the slots
    marked; two calls bit-equal; with an all-False qmask, bit-equal to the
    fp form's launch; bit-equal to the fp form's launch over
    ``dequantized_slabs`` (the marked pages' rows replaced by
    bf16(float(code) · scale)). The check's reach is shown on the same
    inputs: the fp form (a form that ignored qmask) and the plain version
    fed the next page's scales (a form that took another page's scale)
    must each break the tolerance and lie at least REACH times the
    kernel's error from the plain version."""
    q, k, v, phys, logical, kvl = paged_inputs(b, g, r, d, page, w, p,
                                               kv_len, seed, device)
    tier = int8_tier(k, phys, seed)
    scale = 1.0 / math.sqrt(d)
    kernel = lambda: kpaged.paged_decode_attention(  # noqa: E731
        q, k, v, phys, logical, kvl, scale=scale, quant=tier)
    plain = lambda: kpaged.paged_decode_reference(  # noqa: E731
        q, k, v, phys, logical, kvl, scale=scale, quant=tier)
    got, want = kernel(), plain()
    valid = logical >= 0
    out = held("k1_int8_parity", got, want, TOL, case=name,
               shape=[b, g, r, d], page=page, W=w, P=p, kv_len=list(kv_len),
               n_split=kpaged.split_plan(b, g, w, page),
               slots_marked=int((tier["qmask"] & valid).sum()),
               slots_valid=int(valid.sum()))
    if not torch.equal(got, kernel()):
        raise SystemExit(f"k1_int8_parity {name}: two calls on the same "
                         f"inputs gave different bits")
    none = dict(tier, qmask=torch.zeros_like(tier["qmask"]))
    fp = kpaged.paged_decode_attention(q, k, v, phys, logical, kvl,
                                       scale=scale)
    if not torch.equal(kpaged.paged_decode_attention(
            q, k, v, phys, logical, kvl, scale=scale, quant=none), fp):
        raise SystemExit(f"k1_int8_parity {name}: an all-False qmask did "
                         f"not give the fp form's bits")
    out["all_false_bit_equal_fp"] = True
    kd, vd = dequantized_slabs(k, v, phys, tier)
    if not torch.equal(got, kpaged.paged_decode_attention(
            q, kd, vd, phys, logical, kvl, scale=scale)):
        raise SystemExit(f"k1_int8_parity {name}: the int8 form is not the "
                         f"fp form over the dequantized slabs, bit for bit")
    out["bit_equal_fp_over_dequantized"] = True
    other_page = dict(tier, k_scale=tier["k_scale"].roll(1),
                      v_scale=tier["v_scale"].roll(1))
    for key, wrong in (("fp_form", fp), ("other_page_scale",
                                         kpaged.paged_decode_reference(
                                             q, k, v, phys, logical, kvl,
                                             scale=scale,
                                             quant=other_page))):
        err = (wrong.float() - want.float()).abs()
        out[f"max_abs_err_{key}"] = float(err.max())
        out[f"violations_{key}"] = int(
            (err > TOL + TOL * want.float().abs()).sum())
        if not out[f"violations_{key}"] or \
                out[f"max_abs_err_{key}"] < REACH * out["max_abs_err"]:
            emit("k1_int8_parity", ok=False, **out)
            raise SystemExit(f"k1_int8_parity {name}: the check cannot "
                             f"tell the {key} from the kernel: {out}")
    if timed:
        flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
        bytes_, flops = int8_work(q, k, phys, logical, kvl, tier["qmask"])
        add_times(out, kernel, plain,
                  sdpa_call(q, k, v, phys, logical, kvl, scale, tier), flush,
                  bytes_=bytes_, flops=flops)
        del flush
    emit("k1_int8_parity", ok=True, **out)
    return out


def sharded_inputs(n_sh, b, g, r, d, page, w, p, kv_len, seed, device,
                   empty_shard=None):
    """A sequence-sharded pool as the spatial engine builds it: global page
    j of a sequence on shard j % n_sh at a random local id (of the shard's
    P pages), its table entry carrying the GLOBAL logical index; W slots a
    shard. ``empty_shard`` holds no page of any sequence."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((b, g, r, d), generator=gen)
    k = torch.randn((n_sh, p, page, g, d), generator=gen)
    v = torch.randn((n_sh, p, page, g, d), generator=gen)
    phys = torch.full((n_sh, b, w), -1, dtype=torch.int32)
    logical = torch.full((n_sh, b, w), -1, dtype=torch.int32)
    for i, n_rows in enumerate(kv_len):
        n = -(-n_rows // page)
        for sh in range(n_sh):
            js = list(range(sh, n, n_sh))
            if sh == empty_shard or not js:
                continue
            phys[sh, i, :len(js)] = (torch.randperm(p - 1, generator=gen)
                                     [:len(js)] + 1).int()
            logical[sh, i, :len(js)] = torch.tensor(js, dtype=torch.int32)
    kvl = torch.tensor(kv_len, dtype=torch.int32)
    bf = [t.to(device, torch.bfloat16) for t in (q, k, v)]
    return bf + [t.to(device) for t in (phys, logical, kvl)]


def stats_work(q, k, logical, kv_len, qmask=None) -> tuple[int, int]:
    """Bytes and operations of the stats form's work: the K/V rows every
    shard's tables name below kv_len, across all shards, as ``kv_read``
    counts them (with ``qmask``, the int8 lane: marked slots at 1 byte an
    element plus their page scales); q, the tables (and qmask) once, the
    fp32 (m, l, o) written once; 4·R·d operations per row pair and head,
    and one product per dequantized element."""
    b, g, r, d = q.shape
    n_sh = logical.shape[0]
    kv_bytes, rows_all, rows_q = kv_read(k, logical, kv_len, qmask)
    io_bytes = nbytes(q) + n_sh * b * g * r * (d + 2) * 4 \
        + (2 * logical.numel() + kv_len.numel()) * 4 \
        + (0 if qmask is None else logical.numel())
    return kv_bytes + io_bytes, 4 * rows_all * g * r * d + 2 * rows_q * g * d


def stats_library(q, k, v, phys, logical, kv_len, scale, quant=None):
    """One PyTorch call yielding the same merge state: memory-efficient
    SDPA over every shard's gathered rows (shards folded into the batch,
    gathered and dequantized beforehand, outside the timed call) with its
    log-sum-exp; (m, l, o) = (lse, 1, o) is the state the merge takes.
    Returns the call and its state's o/l error against the plain version
    (its P·V is bf16, so the error is in bf16 steps of o)."""
    from repro_torch.kvcache.paged_attention import _gather_hot, fold_tier
    b, g, r, d = q.shape
    n_sh, _, w = phys.shape
    kf, pf = fold_shards(k, phys)
    kg, vg, valid = _gather_hot(kf, v.reshape(kf.shape), pf,
                                logical.reshape(n_sh * b, w),
                                kv_len.repeat(n_sh), fold_tier(quant))
    rows = kg.shape[1]
    pad = -rows % 16                 # the kernel's bias alignment
    kh = torch.nn.functional.pad(kg.transpose(1, 2), (0, 0, 0, pad))
    vh = torch.nn.functional.pad(vg.transpose(1, 2), (0, 0, 0, pad))
    kh = kh.repeat_interleave(r, dim=1).contiguous()
    vh = vh.repeat_interleave(r, dim=1).contiguous()
    qh = q.reshape(1, b, g * r, 1, d).expand(n_sh, b, g * r, 1, d).reshape(
        n_sh * b, g * r, 1, d).contiguous()
    ok = torch.nn.functional.pad(valid, (0, pad))
    bias = torch.zeros(ok.shape, dtype=q.dtype, device=q.device)
    bias = bias.masked_fill(~ok, float("-inf"))[:, None, None, :].expand(
        n_sh * b, g * r, 1, rows + pad).contiguous()

    def call():
        return torch.ops.aten._scaled_dot_product_efficient_attention(
            qh, kh, vh, bias, True, 0.0, False, scale=scale)
    o = call()[0]
    _, wl, wo = kpaged.paged_decode_stats_reference(q, k, v, phys, logical,
                                                    kv_len, scale=scale,
                                                    quant=quant)
    live = (wl > 0).reshape(n_sh * b, g * r)
    want = (wo / torch.clamp(wl, min=1e-30)[..., None]).reshape(
        n_sh * b, g * r, d)
    err = (o[:, :, 0].float() - want)[live].abs().max()
    return call, float(err)


def stats_reach(out, tag, name, q, k, v, phys, logical, kv_len, scale,
                tier, want) -> None:
    """The int8 lane check's reach, on the inputs it held: an all-False
    qmask must give the fp lane's bits, and the int8 lane the fp lane's
    over ``dequantized_slabs``; the fp lane (a form that ignored
    qmask) and the plain version fed the next page's scales (a form that
    took another page's scale) must each break the tolerance on o/l and
    lie at least REACH times the kernel's error from ``want``."""
    def stats(fn, quant):
        return fn(q, k, v, phys, logical, kv_len, scale=scale, quant=quant)
    none = dict(tier, qmask=torch.zeros_like(tier["qmask"]))
    fp = stats(kpaged.paged_decode_stats_attention, None)
    if not all(torch.equal(x, y) for x, y in zip(
            stats(kpaged.paged_decode_stats_attention, none), fp)):
        raise SystemExit(f"{tag} {name}: an all-False qmask did not give "
                         f"the fp lane's bits")
    out["all_false_bit_equal_fp"] = True
    kd, vd = dequantized_slabs(k, v, phys, tier)
    if not all(torch.equal(x, y) for x, y in zip(
            stats(kpaged.paged_decode_stats_attention, tier),
            kpaged.paged_decode_stats_attention(q, kd, vd, phys, logical,
                                                kv_len, scale=scale))):
        raise SystemExit(f"{tag} {name}: the int8 lane is not the fp lane "
                         f"over the dequantized slabs, bit for bit")
    out["bit_equal_fp_over_dequantized"] = True
    other_page = dict(tier, k_scale=tier["k_scale"].roll(1),
                      v_scale=tier["v_scale"].roll(1))
    for key, (_, wl, wo) in (("fp_form", fp), ("other_page_scale", stats(
            kpaged.paged_decode_stats_reference, other_page))):
        err = (wo / torch.clamp(wl, min=1e-30)[..., None] - want).abs()
        out[f"max_abs_err_{key}"] = float(err.max())
        out[f"violations_{key}"] = int(
            (err > TOL + TOL * want.abs()).sum())
        if not out[f"violations_{key}"] or \
                out[f"max_abs_err_{key}"] < REACH * out["max_abs_err"]:
            emit(tag, ok=False, **out)
            raise SystemExit(f"{tag} {name}: the check cannot tell the "
                             f"{key} from the kernel: {out}")


def check_paged_stats(device, name, n_sh, b, g, r, d, page, w, p, kv_len,
                      seed, timed: bool, quant: bool = False,
                      empty_shard=None) -> dict:
    """K1's (m, l, o) form over ``n_sh`` shards in one launch sequence
    against its plain version (``paged_gather_decode_stats`` per shard):
    m, l and o/l at the bf16 bound, two calls bit-equal, and (m, l, o) =
    (NEG_INF, 0, 0) wherever a shard holds no valid row of a sequence. With
    ``quant`` the int8 lane, about half the slots marked, its tier drawn
    apart from the fp rows, held as ``check_paged_int8`` holds the
    normalised form's: an all-False qmask gives the fp lane's bits, and
    the fp lane and the plain version fed the next page's scales each
    break the tolerance on o/l and lie at least REACH times the kernel's
    error off."""
    q, k, v, phys, logical, kvl = sharded_inputs(
        n_sh, b, g, r, d, page, w, p, kv_len, seed, device, empty_shard)
    tier = None
    if quant:
        tier = int8_tier(k.view(n_sh * p, *k.shape[2:]),
                         fold_shards(k, phys)[1].view(phys.shape), seed)
        for key in ("kq", "vq", "k_scale", "v_scale"):
            tier[key] = tier[key].view(n_sh, p, *tier[key].shape[1:])
    scale = 1.0 / math.sqrt(d)
    kernel = lambda: kpaged.paged_decode_stats_attention(  # noqa: E731
        q, k, v, phys, logical, kvl, scale=scale, quant=tier)
    plain = lambda: kpaged.paged_decode_stats_reference(  # noqa: E731
        q, k, v, phys, logical, kvl, scale=scale, quant=tier)
    (m, l, o), (wm, wl, wo) = kernel(), plain()
    tag = "k1_stats_parity"
    live = wl > 0
    case = dict(case=name, shards=n_sh, shape=[b, g, r, d], page=page,
                W=w, P=p, kv_len=list(kv_len), lane="int8" if quant else "fp",
                empty_shard=empty_shard,
                n_split=kpaged.split_plan(n_sh * b, g, w, page))
    if not torch.equal(live, l > 0):
        raise SystemExit(f"{tag} {name}: the kernel's empty states differ "
                         f"from its plain version's")
    out = held(tag, o / torch.clamp(l, min=1e-30)[..., None],
               wo / torch.clamp(wl, min=1e-30)[..., None], TOL, **case)
    out["max_abs_err_m"] = held(tag, m[live], wm[live], TOL,
                                **case)["max_abs_err"]
    out["max_abs_err_l"] = held(tag, l[live], wl[live], TOL,
                                **case)["max_abs_err"]
    dead = ~live
    if not (bool((m[dead] == -1e30).all()) and bool((l[dead] == 0).all())
            and bool((o[dead] == 0).all())):
        raise SystemExit(f"{tag} {name}: a shard without a valid row did "
                         f"not give the neutral state")
    out["states_empty"] = int(dead.sum())
    again = kernel()
    if not all(torch.equal(x, y) for x, y in zip((m, l, o), again)):
        raise SystemExit(f"{tag} {name}: two calls on the same inputs gave "
                         f"different bits")
    if quant:
        stats_reach(out, tag, name, q, k, v, phys, logical, kvl, scale, tier,
                    wo / torch.clamp(wl, min=1e-30)[..., None])
    if timed:
        flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
        bytes_, flops = stats_work(q, k, logical, kvl,
                                   None if tier is None else tier["qmask"])
        library, lib_err = stats_library(q, k, v, phys, logical, kvl, scale,
                                         tier)
        add_times(out, kernel, plain, library, flush, bytes_=bytes_,
                  flops=flops)
        out["library"] = ("aten._scaled_dot_product_efficient_attention "
                          "over the gathered rows, with its lse")
        out["library_state_max_abs_err"] = lib_err
        del flush
    emit(tag, ok=True, **out)
    return out


# -- phases 3-5: the served path ----------------------------------------------

def count_decode_ticks(backend) -> dict:
    """Wrap the backend's decode step: ``ticks`` counts steps that ran (one
    K1 launch per layer each); ``decode_s`` sums their host time through
    the device's completion (the engine reads the step's tokens back right
    after, so the added synchronise moves no work); ``pages_total`` /
    ``pages_hot`` sum the resident and gathered pages of every step."""
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


def serve(llm: LLM, prompts, max_tokens: int, reset: bool = True) -> dict:
    """Submit every prompt, drain, and time it on the host clock (the
    first token of each request is read back to the host, so TTFT
    includes the device's work). The launch counts start at 0 here unless
    ``reset`` is False (the caller zeroed them earlier)."""
    tally = count_decode_ticks(llm.engine.backend)
    if reset:
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
    form_launches = dict(kernels.FORM_LAUNCHES)
    if not all(h.done and h.outcome == "done" for h in handles):
        raise SystemExit("the engine left requests unserved")
    done = [h.tokens for h in handles]
    recs = [llm.records[h.rid] for h in handles]
    n_tok = sum(len(v) for v in done)
    return {"done": done, "ticks": tally["ticks"], "launches": launches,
            "form_launches": form_launches,
            "decode_s": tally["decode_s"],
            "pages_total": tally["pages_total"],
            "pages_hot": tally["pages_hot"],
            "ttft_ms": [1e3 * r.ttft for r in recs],
            "tokens": n_tok, "wall_s": wall, "tok_s": n_tok / wall}


def bf16_step(x: torch.Tensor) -> torch.Tensor:
    """One bf16 rounding step (8 significant bits) at |x|."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def plain_flash(q, k, v, *, causal, scale):
    """``ops.flash``'s function in the plain dense form
    ``attention._dense_chunked`` (bf16 scores and P, rounded as the
    served path rounds them), on K4's [BH, T, d] layout."""
    heads = lambda x: x.transpose(0, 1)[None]  # noqa: E731  [1, T, BH, d]
    o = attention._dense_chunked(heads(q), heads(k), heads(v), causal=causal,
                                 q_chunk=PLAIN_Q_CHUNK, scale=scale)
    return o[0].transpose(0, 1)


def token_gaps(logits, served) -> tuple:
    """(argmax == served, the served token's gap below the top logit in
    bf16 steps of the top) for logits [N, V] and tokens [N]."""
    top = logits.max(dim=-1).values
    gap = top - logits[torch.arange(len(served), device=logits.device),
                       served]
    return logits.argmax(dim=-1) == served, gap / bf16_step(top)


def hybrid_flash(prompt_len: int):
    """``ops.flash`` as the served path rounds it: K4 for the first
    ``prompt_len`` query rows (the prefill's kernel: fp32 scores), the
    plain dense form for the rows after them (each a decoded token, whose
    attention K1 or the dense slot decode computes with bf16 scores and
    P, as the plain form does)."""
    real = ops.flash

    def call(q, k, v, *, causal, scale):
        head = real(q, k, v, causal=causal, scale=scale)[:, :prompt_len]
        tail = plain_flash(q, k, v, causal=causal,
                           scale=scale)[:, prompt_len:]
        return torch.cat([head, tail], dim=1)
    return call


def moe_token_rule(hybrid, k4, plain, served) -> dict:
    """Phase 4's rule for an MoE model, whose random weights amplify
    rounding into gaps of many steps, so that either pure form alone is
    no oracle: the forward that rounds as the served path does
    (``hybrid_flash``) takes K4's place. Logits [N, V] (fp32, every
    forward routed as served) and the served tokens [N]: exact where the
    served token is the hybrid forward's argmax; a tie within TIE_STEPS of
    its top, or within PLAIN_TIE_STEPS where a pure form (K4's or the
    plain one's) puts it within TIE_STEPS of its own top; anything further
    fails. Also the pure forms' own disagreement, reported: on the rows
    where both forms' argmax is the served token, the largest difference
    between them in the served token's margin over the plain runner-up,
    in bf16 steps of the top."""
    exact, steps = token_gaps(hybrid, served)
    k4_exact, k4_steps = token_gaps(k4, served)
    plain_exact, plain_steps = token_gaps(plain, served)
    tie = ~exact & ((steps <= TIE_STEPS) | (
        (steps <= PLAIN_TIE_STEPS)
        & (torch.minimum(k4_steps, plain_steps) <= TIE_STEPS)))
    at = torch.arange(len(served), device=served.device)
    runner = plain.topk(2, dim=-1).indices[:, 1]
    margin = [(x[at, served] - x[at, runner]) / bf16_step(x[at, served])
              for x in (k4, plain)]
    agree = (margin[0] - margin[1]).abs()[k4_exact & plain_exact]
    return {"exact": exact, "tie": tie, "steps": steps,
            "k4_steps": k4_steps, "plain_steps": plain_steps,
            "pure_forms_disagree_steps":
                float(agree.max()) if len(agree) else 0.0}


def record_decode_logits() -> dict:
    """Wrap ``lm.decode_step_paged``: each tick's cache lengths before
    the step and its logits [B, V] (fp32, on the device)."""
    real = lm.decode_step_paged
    log = {"ticks": []}

    def recording(params, cfg, tokens, cache, *args, **kw):
        lengths = cache["lengths"].clone()
        logits, cache = real(params, cfg, tokens, cache, *args, **kw)
        log["ticks"].append((lengths, logits[:, :cfg.vocab].float()))
        return logits, cache

    lm.decode_step_paged = recording
    log["restore"] = lambda: setattr(lm, "decode_step_paged", real)
    return log


def served_rows(log: dict, prompts, done) -> list:
    """Each request's recorded decode logits [n, V] in token order: the
    tick whose row holds ``len(prompt) + i - 1`` cached tokens gave token
    i (i >= 1); row 0 (the prefill's token) stays NaN. The prompts'
    lengths must be more than a request's tokens apart, so a length names
    its request; each recorded row must have its served token at its
    top."""
    out = []
    for prompt, toks in zip(prompts, done):
        rows = torch.full((len(toks), log["ticks"][0][1].shape[1]),
                          float("nan"), device=log["ticks"][0][1].device)
        for lengths, logits in log["ticks"]:
            for b, n in enumerate(lengths.tolist()):
                i = n - len(prompt) + 1
                if 1 <= i < len(toks):
                    rows[i] = logits[b]
        got = rows[1:].gather(1, torch.as_tensor(
            toks[1:], device=rows.device)[:, None])[:, 0]
        if not bool((got == rows[1:].max(dim=-1).values).all()):
            raise SystemExit("recorded decode logits do not give the "
                             "served tokens")
        out.append(rows)
    return out


@torch.inference_mode()
def check_exact(params, cfg, prompts, done, routes=None, extra=None,
                served_logits=None) -> dict:
    """Each served token against the argmax of a dense, cache-free forward
    (``star=None``, K4) over the served prefix. The served path (batched
    chunk prefill with bf16 scores, K1 decode) and the forward (K4: fp32
    scores, one rounding at the end) round differently at each of the 16
    layers, so a token within TIE_STEPS bf16 steps of the top is a tie
    (the full-width form of ``tests/engine_core_scenarios.py::_greedy_tie``).
    For a request with any other token, the same forward runs again with
    the plain dense form in K4's place: a token within PLAIN_TIE_STEPS of
    K4's top and TIE_STEPS of the plain form's is a tie too; anything
    further fails. Each inexact token is reported with both gaps.

    ``served_logits`` (phase 18's paged runs alone; ``served_rows``):
    each request's served logits [n, V], one row per decoded token (NaN
    where none was recorded: the first token, the prefill's). The served
    logits then witness as the plain form does, with phase 4's steps: a
    token within PLAIN_TIE_STEPS of K4's top is a tie too where the
    served logits put K4's top within TIE_STEPS of their own (the served
    path saw the two tied). Counted apart (``served_ties``).

    With ``routes`` (a dropless MoE model's served choices per request,
    ``served_routes``) each forward's sequence is padded to whole pages
    (otherwise a prime length runs one-token chunks; padding leaves the
    rows read unchanged when no choice drops), and three forwards run for
    every request, each routing as the served path did
    (``forced_routing``): K4's, the plain form's, and one that rounds as
    the served path does (``hybrid_flash``). A flip (a served choice the
    K4 forward's own top-k leaves out) must be a near-tie: at each layer,
    its gap no larger than the largest gate-logit difference rounding
    alone makes between the K4 and plain forwards at that layer. The
    tokens are held by ``moe_token_rule``: a random-weight MoE (expert
    weights at std sqrt(1/V), as the reference draws them) amplifies
    rounding into gaps of several steps, so K4's top alone is no oracle
    there.

    ``extra`` (one dict per request) adds inputs to each forward's batch:
    an encoder-decoder model's ``enc_embeds``.

    In a model with recurrent blocks (Jamba's Mamba layers come before its
    attention layer, so at those MoE layers K4 and the plain form give the
    same gate logits) a fourth forward, K4's over the sequence one page
    longer, joins the rounding yardstick: the rows read are the same in
    exact arithmetic, so how far its gate logits lie from the first
    forward's is rounding alone (other GEMM shapes, another SSD chunk,
    other MoE chunks), the differences that part the served prefill from
    the forward."""
    dense = dataclasses.replace(cfg, star=None)
    dev = params["embed"].device
    n_exact = n_tie = n_served_tie = 0
    inexact = []
    layers = moe_layers(cfg)
    recurrent = any(blk.kind != "attn" for blk in cfg.pattern)
    flips = {"rows": 0, "flips": 0, "flips_per_layer": [0] * layers,
             "max_gap": [0.0] * layers, "rounding": [0.0] * layers}
    gate_logits = []
    rows_all = []

    def batch_of(rid, seq):
        return {"tokens": seq, **(extra[rid] if extra else {})}

    def forward(rid, seq, tally=True):
        batch = batch_of(rid, seq)
        if routes is None:
            return lm.forward(params, dense, batch)
        with forced_routing(routes[rid], layers, flips if tally else None,
                            gate_logits):
            return lm.forward(params, dense, batch)
    kernels.reset_launches()
    for rid, prompt in enumerate(prompts):
        toks = np.asarray(done[rid], np.int64)
        seq = np.concatenate([prompt.astype(np.int64), toks[:-1]])
        if routes is not None:
            seq = bucketing.pad_tokens(seq, -(-len(seq) // 16) * 16)
        seq = torch.as_tensor(seq[None], device=dev)
        served = torch.as_tensor(toks, device=dev)
        rows = slice(len(prompt) - 1, len(prompt) - 1 + len(toks))
        gate_logits.clear()
        logits = forward(rid, seq)[0, rows][:, :cfg.vocab].float()
        exact, steps = token_gaps(logits, served)
        if bool(exact.all()) and routes is None:
            n_exact += len(toks)
            continue
        real = ops.flash
        ops.flash = plain_flash
        try:
            plain = forward(rid, seq)[0, rows][:, :cfg.vocab].float()
        finally:
            ops.flash = real
        if routes is not None:
            ops.flash = hybrid_flash(len(prompt))
            try:
                hybrid = forward(rid, seq, tally=False)[0, rows]
            finally:
                ops.flash = real
            if recurrent:
                forward(rid, torch.nn.functional.pad(seq, (0, 16)))
            rows_all.append((rid, hybrid[:, :cfg.vocab].float(), logits,
                             plain, served))
            continue
        _, plain_steps = token_gaps(plain, served)
        tie = ~exact & ((steps <= TIE_STEPS) | (
            (steps <= PLAIN_TIE_STEPS) & (plain_steps <= TIE_STEPS)))
        served_steps = None
        served_tie = torch.zeros_like(tie)
        if served_logits is not None:
            # K4's top in bf16 steps below the served logits' top (NaN,
            # so no tie, where no row was recorded)
            _, served_steps = token_gaps(served_logits[rid],
                                         logits.argmax(dim=-1))
            served_tie = ~exact & ~tie & (steps <= PLAIN_TIE_STEPS) & (
                served_steps <= TIE_STEPS)
        for i in (~exact).nonzero().flatten().tolist():
            inexact.append({"request": rid, "token": i,
                            "k4_steps": float(steps[i]),
                            "plain_steps": float(plain_steps[i]),
                            **({} if served_steps is None else
                               {"served_steps": float(served_steps[i])}),
                            "tie": bool(tie[i] | served_tie[i])})
        if bool((~exact & ~tie & ~served_tie).any()):
            raise SystemExit(f"request {rid}: served tokens beyond a bf16 "
                             f"tie of the dense forward: {inexact}")
        n_exact += int(exact.sum())
        n_tie += int(tie.sum())
        n_served_tie += int(served_tie.sum())
    disagree = None
    if routes is not None:
        rule = moe_token_rule(*(torch.cat([r[j] for r in rows_all])
                                for j in (1, 2, 3, 4)))
        disagree = rule["pure_forms_disagree_steps"]
        owner = [(r[0], i) for r in rows_all for i in range(len(r[4]))]
        for j in (~rule["exact"]).nonzero().flatten().tolist():
            inexact.append({"request": owner[j][0], "token": owner[j][1],
                            "steps": float(rule["steps"][j]),
                            "k4_steps": float(rule["k4_steps"][j]),
                            "plain_steps": float(rule["plain_steps"][j]),
                            "tie": bool(rule["tie"][j])})
        n_exact, n_tie = int(rule["exact"].sum()), int(rule["tie"].sum())
        if bool((~rule["exact"] & ~rule["tie"]).any()):
            raise SystemExit(f"served tokens beyond a bf16 tie of the "
                             f"forward that rounds as served: {inexact}")
        over = [layer for layer in range(layers)
                if flips["max_gap"][layer] > flips["rounding"][layer]]
        if over:
            raise SystemExit(f"served routing beyond a gate tie of the "
                             f"dense forward's at layers {over} (gap above "
                             f"the gate-logit difference rounding makes "
                             f"there): {flips}")
    return {"tokens_checked": n_exact + n_tie + n_served_tie,
            "exact": n_exact, "bf16_ties": n_tie,
            **({"served_ties": n_served_tie}
               if served_logits is not None else {}),
            "rule": "phase 4" if routes is None else "moe",
            "tie_steps": TIE_STEPS,
            "plain_tie_steps": PLAIN_TIE_STEPS, "inexact": inexact,
            "forwards": len(prompts),
            "k4_launches": kernels.LAUNCHES["flash"],
            "expected_k4_launches": len(prompts) * dense_k4_layers(cfg)
            * (1 if routes is None else 2 + recurrent),
            **({"routing_forced": flips,
                "pure_forms_disagree_steps": disagree}
               if routes is not None else {})}


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


# -- phase 6: K2, K3, K4 against their plain versions --------------------------

def prefill_inputs(bh, t, d, seed, device):
    """q, k, v [BH, T, d] as tests/test_kernels.py draws them (a peaked
    key prefix), in bf16 on the card."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn((bh, t, d), generator=gen) for _ in range(3))
    k[:, : t // 16] *= 3.0
    return [x.to(device, torch.bfloat16) for x in (q, k, v)]


def visible_pairs(t: int, s: int, causal: bool) -> int:
    """(query, key) pairs the causal mask at offset S - T leaves."""
    if not causal:
        return t * s
    return int(np.clip(np.arange(t) + (s - t) + 1, 0, s).sum())


def check_dlzs(dev, flush, *, bh, t, block, causal, seed, timed,
               d=128) -> dict:
    q, k, _ = prefill_inputs(bh, t, d, seed, dev)
    kw = dict(causal=causal, block_q=block, block_kv=block)
    kernel = lambda: kdlzs.dlzs_block_scores(q, k, **kw)  # noqa: E731
    plain = lambda: kref.dlzs_block_ref(q, k, **kw)  # noqa: E731
    got = kernel()
    if not torch.equal(got, kernel()):
        raise SystemExit(f"dlzs_block T={t} block={block}: two calls on the "
                         f"same inputs gave different bits")
    out = held("prefill_kernel", got, plain(), PREFILL_TOL["dlzs_block"],
               kernel="dlzs_block", form=launch.tile_form(block, block),
               BH=bh, T=t, S=t, d=d, block=block, causal=causal)
    if timed:
        n_out = bh * (t // block) ** 2 * 4
        add_times(out, kernel, plain, None, flush,
                  bytes_=nbytes(q, k) + n_out,
                  flops=2 * d * bh * visible_pairs(t, t, causal))
    emit("prefill_kernel", ok=True, **out)
    return out


def selected_pairs(idx, valid, *, t: int, s: int, block: int,
                   causal: bool = True) -> int:
    """(query, key) pairs K3 computes: the causal keys (every key, when
    not ``causal``) of each valid selected tile, for each query row of
    its q-tile."""
    if not causal:
        return int(valid.sum()) * block * block
    n_qt = t // block
    q_pos = torch.arange(t, device=idx.device).reshape(n_qt, block) + (s - t)
    first = idx[..., None] * block                   # [BH, n_qt, keep, 1]
    seen = (q_pos[None, :, None, :] - first + 1).clamp(0, block)
    return int((seen * valid[..., None]).sum())


def check_sufa(dev, flush, *, bh, t, block, strict, seed, timed,
               d=128, elementwise=False, causal=True) -> dict:
    """K3 on the tiles the glue selects for these inputs, keeping as many
    as olmo_1b's STAR config keeps (ChatGLM3-6B's and star_paper's are the
    same: top-k 0.2, tiles 128, radius 5), read in place from the tile
    ids. With
    ``elementwise`` K3 also applies the element-level sphere (the config's
    radius): its plain version computes the estimates as an fp32-summed
    bf16 product (the kernel's arithmetic up to the order of that sum),
    and the share of mask elements that a default cuBLAS product
    (reduced-precision reductions allowed) would set otherwise is
    printed beside the share of visible keys the sphere drops. Without
    ``causal`` (an encoder's self-attention) every key of a selected tile
    is visible."""
    q, k, v = prefill_inputs(bh, t, d, seed, dev)
    scale = d ** -0.5
    star = olmo_1b.config().star
    keep = dataclasses.replace(star, block_q=block,
                               block_kv=block).keep_blocks(t)
    raw = kdlzs.dlzs_block_scores(q, k, causal=causal, scale=1.0,
                                  block_q=block, block_kv=block)
    idx, valid = ops.select_tiles(raw, keep, scale=scale, radius=star.radius,
                                  dtype=q.dtype)
    kw = dict(block_q=block, block_kv=block, causal=causal, scale=scale,
              strict=strict)
    if elementwise:
        kw.update(elementwise=True, radius=star.radius)
    kernel = lambda: ksufa.sufa_attention(q, k, v, idx, valid, **kw)  # noqa

    def plain():
        if not elementwise:
            return ksufa.sufa_reference(q, k, v, idx, valid, **kw)
        with fp32_summed_bf16_gemms():
            return ksufa.sufa_reference(q, k, v, idx, valid, **kw)
    got = kernel()
    if not torch.equal(got, kernel()):
        raise SystemExit(f"sufa T={t} block={block}: two calls on the same "
                         f"inputs gave different bits")
    # the TPU contract's operands, which the served path no longer writes
    kg, vg, mask = ksufa.gather_selected(k, v, idx, valid, t=t,
                                         block_q=block, block_kv=block,
                                         causal=causal)
    extra = {}
    if elementwise:
        visible = mask
        with fp32_summed_bf16_gemms():
            mask = ksufa.sphere_mask(q, kg, visible, scale=scale,
                                     radius=star.radius)
        default = ksufa.sphere_mask(q, kg, visible, scale=scale,
                                    radius=star.radius)
        n_visible = int(visible.sum())
        extra = {"radius": star.radius, "visible_keys": n_visible,
                 "sphere_dropped_share": 1 - int(mask.sum()) / n_visible,
                 "mask_elements_differ_default_gemm_share":
                     int((mask != default).sum()) / mask.numel()}
    # distinct (head, key tile) pairs that some q-tile reads
    reads = torch.zeros((bh, t // block), dtype=torch.int32, device=dev)
    reads.scatter_add_(1, idx.reshape(bh, -1), valid.reshape(bh, -1).int())
    n_tiles = int((reads > 0).sum())
    tile_bytes = 2 * n_tiles * block * d * k.element_size()
    out = held("prefill_kernel", got, plain(), PREFILL_TOL["sufa"],
               kernel="sufa", form=launch.tile_form(block, block),
               BH=bh, T=t, d=d, block=block, keep=keep, strict=strict,
               causal=causal, elementwise=elementwise,
               valid_tiles=int(valid.sum()),
               distinct_tiles=n_tiles, gathered_bytes_not_moved={
                   "kg": nbytes(kg), "vg": nbytes(vg), "mask": nbytes(mask),
                   "k": nbytes(k)}, **extra)
    if timed:
        # SDPA over the same gathered rows under the boolean mask (the
        # gather, and the element mask's estimates, outside the timed call)
        n = bh * (t // block)
        qs = q.reshape(n, 1, block, d)
        ks, vs = (x.reshape(n, 1, keep * block, d) for x in (kg, vg))
        ms = mask.transpose(2, 3).reshape(n, 1, block, keep * block)
        pairs = selected_pairs(idx, valid, t=t, s=t, block=block,
                               causal=causal)
        # the element mask: one estimate (2·d) per visible pair, then the
        # exact score and P·V (4·d) for the pairs it keeps
        flops = 2 * d * pairs + 4 * d * int(mask.sum()) if elementwise \
            else 4 * d * pairs
        add_times(out, kernel, plain,
                  lambda: SDPA(qs, ks, vs, attn_mask=ms, scale=scale), flush,
                  bytes_=nbytes(q, q, idx, valid) + tile_bytes, flops=flops)
    emit("prefill_kernel", ok=True, **out)
    return out


def check_flash(dev, flush, *, bh, t, causal, seed, timed, d=128,
                s=None) -> dict:
    """K4 over T queries and S keys (S = T unless given: a decoder's
    cross-attention has T != S, unmasked, and S need not be a whole
    tile)."""
    q, k, v = prefill_inputs(bh, t, d, seed, dev)
    s = s or t
    if s != t:
        _, k, v = prefill_inputs(bh, s, d, seed + 1, dev)
    kernel = lambda: kflash.flash_attention(q, k, v, causal=causal)  # noqa
    plain = lambda: kref.flash_ref(q, k, v, causal=causal)  # noqa: E731
    out = held("prefill_kernel", kernel(), plain(), PREFILL_TOL["flash"],
               kernel="flash", BH=bh, T=t, S=s, d=d, causal=causal)
    if timed:
        add_times(out, kernel, plain,
                  lambda: SDPA(q[None], k[None], v[None], is_causal=causal),
                  flush, bytes_=nbytes(q, k, v, q),
                  flops=4 * d * bh * visible_pairs(t, s, causal))
    emit("prefill_kernel", ok=True, **out)
    return out


def check_prefill_kernels(dev) -> dict:
    """Phase 6; returns the timed case of each kernel."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    timed = {}
    for t in (1024, 2048):
        timed["dlzs_block"] = check_dlzs(dev, flush, bh=16, t=t, block=128,
                                         causal=True, seed=t,
                                         timed=t == 2048)
    # non-causal, every q-tile the same work: K2's rate without the causal
    # grid's imbalance
    timed["dlzs_block_noncausal"] = check_dlzs(
        dev, flush, bh=16, t=2048, block=128, causal=False, seed=3,
        timed=True)
    # the mma.sync form: the pool probe's one-page tile, and tiles of 64
    check_dlzs(dev, flush, bh=16, t=16, block=16, causal=True, seed=4,
               timed=False)
    check_dlzs(dev, flush, bh=16, t=1024, block=64, causal=True, seed=5,
               timed=False)
    for strict in (True, False):
        for t in (1024, 2048):
            out = check_sufa(dev, flush, bh=16, t=t, block=128,
                             strict=strict, seed=t + 5, timed=t == 2048)
            if t == 2048:
                timed["sufa" if strict else "sufa_fast"] = out
        check_sufa(dev, flush, bh=16, t=1024, block=128, strict=strict,
                   seed=9, timed=False, d=64)
        # the mma.sync form: the pool probe's tile, and tiles of 64
        check_sufa(dev, flush, bh=16, t=16, block=16, strict=strict, seed=6,
                   timed=False)
        check_sufa(dev, flush, bh=16, t=1024, block=64, strict=strict,
                   seed=7, timed=False)
        # the element-level sphere: the wgmma form at the served tiles
        # and d = 64, the mma.sync form at tiles of 64
        out = check_sufa(dev, flush, bh=16, t=2048, block=128,
                         strict=strict, seed=2053, timed=True,
                         elementwise=True)
        timed["sufa_elementwise" if strict else "sufa_elementwise_fast"] \
            = out
        check_sufa(dev, flush, bh=16, t=1024, block=128, strict=strict,
                   seed=2054, timed=False, d=64, elementwise=True)
        out = check_sufa(dev, flush, bh=16, t=2048, block=64, strict=strict,
                         seed=2055, timed=strict, elementwise=True)
        if strict:
            timed["sufa_elementwise_mma_sync"] = out
    for t in (1024, 2048, 991, 1, 129):
        out = check_flash(dev, flush, bh=16, t=t, causal=True, seed=t + 7,
                          timed=t == 2048)
        if t == 2048:
            timed["flash"] = out
    check_flash(dev, flush, bh=16, t=1024, causal=True, seed=11, timed=False,
                d=64)
    # phases 10-12's shapes: ChatGLM3-6B's longest whole prompt (32 heads,
    # K/V expanded from its 2 KV heads), and star_paper's 32 heads at its
    # 2048-token prompt under the element mask
    check_dlzs(dev, flush, bh=32, t=4096, block=128, causal=True, seed=41,
               timed=False)
    for strict in (True, False):
        check_sufa(dev, flush, bh=32, t=4096, block=128, strict=strict,
                   seed=42, timed=False)
        check_sufa(dev, flush, bh=32, t=4096, block=128, strict=strict,
                   seed=43, timed=False, elementwise=True)
        check_sufa(dev, flush, bh=32, t=2048, block=128, strict=strict,
                   seed=44, timed=False, elementwise=True)
    check_flash(dev, flush, bh=32, t=4096, causal=True, seed=45, timed=False)
    # phase 19's forms (SeamlessM4T, d 64): the encoder's non-causal K2
    # and K3 at 2048 frames; the cross-attention's K4, non-causal with
    # T != S: 256 decoder rows over 2048 encoder rows, and over a ragged
    # 1000
    timed["dlzs_block_encoder"] = check_dlzs(
        dev, flush, bh=16, t=2048, block=128, causal=False, seed=51,
        timed=True, d=64)
    for strict in (True, False):
        timed["sufa_encoder" if strict else "sufa_encoder_fast"] = \
            check_sufa(dev, flush, bh=16, t=2048, block=128, strict=strict,
                       seed=52, timed=True, d=64, causal=False)
    for s in (2048, 1000):
        timed[f"flash_cross_s{s}"] = check_flash(
            dev, flush, bh=16, t=256, s=s, causal=False, seed=53 + s,
            timed=True, d=64)
    del flush
    # phase 18's forms: InternVL2-26B's 48 heads (K/V expanded from 8) at
    # its longest whole prompt
    timed["bh48"] = check_attention_kernels_at(dev, bh=48, t=4096, seed=48)
    return timed


# -- phase 7: the fused STAR prefill against the plain scanq -------------------

@contextlib.contextmanager
def fp32_summed_bf16_gemms():
    """cuBLAS bf16 GEMMs rounded once from their fp32 sum, as the plain STAR
    form's predicted scores assume; only the plain references of phases 6
    (K3's element mask), 7 and 10 run under it, the served phases keep the
    library's default."""
    matmul = torch.backends.cuda.matmul
    old = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = old


@torch.inference_mode()
def star_layer_inputs(params, cfg, t: int, seed: int) -> list:
    """Each layer's (q, k, v) [heads, T, dh] as ``attention.apply_prefill``
    hands them to the glue, from one cache-free STAR forward of a random
    t-token prompt: every layer's input is the glue's own output below."""
    dev = params["embed"].device
    toks = torch.as_tensor(make_prompts(cfg, (t,), seed)[0], device=dev)
    real, seen = ops.star_attention_cfg, []

    def recording(q, k, v, star, **kw):
        seen.append((q, k, v))
        return real(q, k, v, star, **kw)

    ops.star_attention_cfg = recording
    try:
        lm.forward(params, cfg, {"tokens": toks[None]})
    finally:
        ops.star_attention_cfg = real
    return seen


def kept_tiles(idx, valid, n_kt: int) -> torch.Tensor:
    """[..., n_qt, n_kt] bool: the valid tiles of each query tile."""
    kept = torch.zeros(idx.shape[:-1] + (n_kt,), dtype=torch.bool,
                       device=idx.device)
    return kept.scatter_(-1, idx, valid)


def edge_gap_steps(bmax, keep: int, radius: float) -> torch.Tensor:
    """[..., n_qt]: how far a selection over tile maxima ``bmax`` [...,
    n_qt, n_kt] sits from its nearest decision edge, in bf16 steps of its
    keep-th maximum: the gap from the keep-th maximum to the next, or from
    any maximum to the sphere's edge (top - radius)."""
    vals = bmax.float().sort(dim=-1, descending=True).values
    live = vals > sads.NEG_INF / 2
    inf = torch.tensor(float("inf"), device=vals.device)
    kth = vals[..., keep - 1]
    top_k = inf.expand_as(kth)
    if keep < vals.shape[-1]:
        top_k = torch.where(live[..., keep], kth - vals[..., keep], inf)
    sphere = (vals - (vals[..., :1] - radius)).abs().masked_fill(
        ~live, float("inf")).amin(dim=-1)
    return torch.minimum(top_k, sphere) / bf16_step(kth)


def glue_kept(q, k, star) -> torch.Tensor:
    """The glue's kept tiles [nh, n_qt, n_kt] for q/k [nh, T, d] (K2's
    maxima rounded and ranked by ``ops.select_tiles``)."""
    t, dh = q.shape[1], q.shape[2]
    raw = kdlzs.dlzs_block_scores(q, k, causal=True, scale=1.0,
                                  block_q=star.block_q,
                                  block_kv=star.block_kv)
    return kept_tiles(*ops.select_tiles(raw, star.keep_blocks(t),
                                        scale=dh ** -0.5, radius=star.radius,
                                        dtype=q.dtype), t // star.block_kv)


def plain_selection(q, k, star) -> tuple:
    """The plain STAR form's tile maxima of Â and kept tiles, both [nh,
    n_qt, n_kt], for q/k [nh, T, d] (causal, one prefix group)."""
    t, dh = q.shape[1], q.shape[2]
    with fp32_summed_bf16_gemms():
        s_hat = core_star.predict_scores(q, k, scale=dh ** -0.5).masked_fill(
            torch.ones(t, t, dtype=torch.bool, device=q.device).triu(1),
            sads.NEG_INF)
    sel = sads.sads_select_blocks(s_hat, star.block_q, star.block_kv,
                                  star.keep_blocks(t), radius=star.radius)
    return (sads.block_maxima(s_hat, star.block_q, star.block_kv),
            kept_tiles(sel.block_idx, sel.block_valid, t // star.block_kv))


def plain_star(q, k, v, star, *, causal: bool, scale: float):
    """``ops.star_attention_cfg``'s function in the plain form:
    ``core.star_attention_scanq`` per head."""
    with fp32_summed_bf16_gemms():
        return torch.stack([core_star.star_attention_scanq(
            q[i], k[i], v[i], star, causal=causal, scale=scale)
            for i in range(q.shape[0])])


@torch.inference_mode()
def check_layer(q, k, v, star, *, timed: bool) -> dict:
    """One layer: the glue's kept tiles and output against the plain STAR
    form's on the same q/k/v. For rows that disagree, how close the plain
    selection sat to a decision edge (a sum-order flip at a bf16 rounding
    edge is one step or less)."""
    nh, t, dh = q.shape
    kw = dict(causal=True, scale=1.0 / math.sqrt(dh))
    fused_fn = lambda: ops.star_attention_cfg(q, k, v, star, **kw)  # noqa
    plain_fn = lambda: plain_star(q, k, v, star, **kw)  # noqa: E731
    fused, plain = fused_fn(), plain_fn()
    bmax, kept_p = plain_selection(q, k, star)
    agree = (glue_kept(q, k, star) == kept_p).all(dim=-1)     # [nh, n_qt]
    gaps = edge_gap_steps(bmax, star.keep_blocks(t), star.radius)[~agree]
    err = (fused.float() - plain.float()).abs().reshape(
        nh, t // star.block_q, star.block_q, dh).amax(dim=(2, 3))
    out = {"selection_agreement": float(agree.float().mean()),
           "rows_disagreeing": int((~agree).sum()),
           "edge_gap_steps_disagreeing": [float(g) for g in gaps[:16]],
           "max_abs_err_agreeing": float(err[agree].max()) if
           bool(agree.any()) else 0.0,
           "max_abs_err_all": float(err.max()),
           "tolerance": PREFILL_TOL["sufa"] * max(
               1.0, float(plain.float().abs().max()))}
    if timed:
        out.update(fused_ms=time_ms(fused_fn, iters=10),
                   plain_ms=time_ms(plain_fn, iters=10))
    return out


@torch.inference_mode()
def check_fused_star(params, cfg, seed: int, t: int = 2048,
                     timed: bool = True, every: int = 1,
                     tag: str = "fused_star") -> dict:
    """The glue against the plain STAR form at every ``every``-th layer of
    one STAR forward, each layer's two forms fed the same q/k/v: rows
    whose kept tile sets agree must agree in value to SU-FA's bf16 bound,
    scaled by the output's magnitude (the plain form rounds each score to
    bf16 before its softmax, K3 keeps fp32); the agreement itself must
    reach 99% of the rows in every layer checked. Layer 0 is timed."""
    star = cfg.star
    inputs = star_layer_inputs(params, cfg, t, seed)[::every]
    layers = [check_layer(q, k, v, star, timed=timed and i == 0)
              for i, (q, k, v) in enumerate(inputs)]
    del inputs
    nh = cfg.n_heads
    out = {"T": t, "heads": nh, "keep": star.keep_blocks(t),
           "layers_checked": list(range(0, cfg.n_layers, every)),
           "rows_per_layer": nh * (t // star.block_q),
           "selection_agreement_min": min(
               c["selection_agreement"] for c in layers),
           "rows_disagreeing": sum(c["rows_disagreeing"] for c in layers),
           "max_abs_err_agreeing": max(c["max_abs_err_agreeing"]
                                       for c in layers),
           "layers": layers}
    if timed:
        out.update(fused_ms=layers[0]["fused_ms"],
                   plain_ms=layers[0]["plain_ms"])
    ok = all(c["selection_agreement"] >= 0.99 and
             c["max_abs_err_agreeing"] <= c["tolerance"] for c in layers)
    emit(tag, ok=ok, **out)
    if not ok:
        raise SystemExit(f"{tag}: fused STAR prefill disagrees with scanq: "
                         f"{out}")
    return out


# -- phase 8: the whole-prompt prefill, served ----------------------------------

def count_prefills(on_card: bool) -> dict:
    """Wrap ``lm.prefill`` (the pool probe and every whole-prompt
    prefill call it): ``calls``, the padded ``widths`` and ``seconds``
    (each call's, and their sum) of host time through the device's end (the engine reads the logits
    back right after, so the added synchronise moves no work)."""
    real = lm.prefill
    tally = {"calls": 0, "widths": [], "seconds": 0.0, "per_call": []}

    def counted(params, cfg, batch, **kw):
        t0 = time.perf_counter()
        out = real(params, cfg, batch, **kw)
        if on_card:
            torch.cuda.synchronize()
        tally["per_call"].append(time.perf_counter() - t0)
        tally["seconds"] += tally["per_call"][-1]
        tally["calls"] += 1
        tally["widths"].append(int(batch["tokens"].shape[1]))
        return out

    lm.prefill = counted
    tally["restore"] = lambda: setattr(lm, "prefill", real)
    return tally


def serve_whole_prompt(cfg, params, prompts, max_tokens, *, device,
                       generator, n_pages: int = 512):
    """A paged engine whose prefill is one ``lm.prefill`` per prompt
    (``chunk_pages=None``), served from a zero launch count so the pool
    probe's prefill is counted too. hot_pages covers the longest
    sequence, so decode is exact. With STAR on each prefill runs K2 and
    K3 per layer (K3's element-mask form with ``elementwise``), else K4."""
    longest = -(-(max(len(p) for p in prompts) + max_tokens) // 16)
    kernels.reset_launches()
    tally = count_prefills(torch.device(device).type == "cuda")
    try:
        llm = LLM.from_config(
            cfg, backend="paged", params=params, device=device,
            generator=generator,
            engine_cfg=PagedEngineCfg(max_batch=4, page_size=16,
                                      n_pages=n_pages,
                                      hot_pages=longest + 1, eos_id=-1),
            sched_cfg=SchedulerCfg(chunk_pages=None))
        run = serve(llm, prompts, max_tokens, reset=False)
    finally:
        tally["restore"]()
    summary = served_summary(run, cfg.n_layers)
    star = cfg.star
    # K2 and K3 take their wgmma form where a prefill's tiles are 128 x 128
    wgmma_calls = 0 if star is None else sum(
        launch.tile_form(min(star.block_q, w), min(star.block_kv, w))
        == "wgmma" for w in tally["widths"])
    per_call = 0 if star is None else cfg.n_layers
    elem = star is not None and star.elementwise
    summary.update(
        prefill_calls=tally["calls"], prefill_widths=tally["widths"],
        prefill_s=tally["seconds"], prefill_s_per_call=tally["per_call"],
        dlzs_block_launches=run["launches"]["dlzs_block"],
        sufa_launches=run["launches"]["sufa"],
        flash_launches=run["launches"]["flash"],
        form_launches=run["form_launches"],
        expected_prefill_launches=tally["calls"] * per_call,
        expected_flash_launches=tally["calls"] * (cfg.n_layers - per_call),
        expected_wgmma_launches=wgmma_calls * cfg.n_layers,
        expected_sufa_wgmma_launches=wgmma_calls * per_call,
        expected_sufa_elementwise_launches=tally["calls"] * per_call
        if elem else 0)
    return llm, run, summary


def require_prefill_launches(summary: dict, tag: str) -> None:
    """K2 and K3 once per layer of every prefill call, in the wgmma form
    wherever the call's tiles are 128 x 128 (all but the pool probe; K3's
    element-mask calls too, counted also under ``sufa/elementwise``); K4
    once per layer of a dense prefill call."""
    want = summary["expected_prefill_launches"]
    got = (summary["dlzs_block_launches"], summary["sufa_launches"])
    if summary["prefill_calls"] == 0 or got != (want, want):
        raise SystemExit(f"{tag}: K2/K3 launched {got} times over "
                         f"{summary['prefill_calls']} prefill calls; "
                         f"expected prefill calls x layers = {want}")
    forms = summary["form_launches"]
    wgmma = summary["expected_wgmma_launches"]
    got = (forms["dlzs_block/wgmma"], forms["sufa/wgmma"],
           forms["sufa/elementwise"])
    want = (wgmma, summary.get("expected_sufa_wgmma_launches", wgmma),
            summary.get("expected_sufa_elementwise_launches", 0))
    if (want[0] == 0 and summary["expected_prefill_launches"]) \
            or got != want:
        raise SystemExit(f"{tag}: K2/K3 launched their wgmma forms and "
                         f"K3 its element-mask form {got} times over "
                         f"prefill widths {summary['prefill_widths']}; "
                         f"expected {want}")
    flash = summary.get("expected_flash_launches")
    if flash is not None and summary["flash_launches"] != flash:
        raise SystemExit(f"{tag}: K4 launched {summary['flash_launches']} "
                         f"times; expected dense prefill calls x layers = "
                         f"{flash}")


def first_token_rule(logits, served, tag: str) -> tuple:
    """Phase 8's rule for one token: the argmax of ``logits`` (the
    forward's, [V] fp32) or within one bf16 step of its top."""
    top = logits.max()
    exact = int(logits.argmax()) == served
    if not (exact or bool(top - logits[served] <= bf16_step(top))):
        raise SystemExit(f"{tag}: first token {served}, forward argmax "
                         f"{int(logits.argmax())}")
    return int(exact), int(not exact)


@torch.inference_mode()
def check_first_tokens(params, cfg, prompts, done, pow2) -> dict:
    """Each request's first token against the argmax of a cache-free
    forward, STAR on, over the same bucketed prompt the engine prefilled
    (``pow2`` None: the prompt as it is, as the dense engine prefills it).
    Both run K2 -> SADS -> K3 on the same rows, so this holds the pool and
    scatter plumbing; the two take the output head at different shapes,
    so a token within one bf16 step of the top is a tie."""
    dev = params["embed"].device
    n_exact = n_tie = 0
    for rid, prompt in enumerate(prompts):
        width = len(prompt) if pow2 is None else \
            bucketing.bucket_len(len(prompt), 16, pow2=pow2)
        toks = torch.as_tensor(bucketing.pad_tokens(prompt, width)[None],
                               device=dev)
        logits = lm.forward(params, cfg, {"tokens": toks})[
            0, len(prompt) - 1, :cfg.vocab].float()
        exact, tie = first_token_rule(logits, int(done[rid][0]),
                                      f"request {rid}")
        n_exact += exact
        n_tie += tie
    return {"first_tokens_checked": len(prompts), "exact": n_exact,
            "bf16_ties": n_tie}


# -- phase 9: disaggregated serving with the int8 cold tier -------------------

def disagg_cfgs(n_pages: int, hot_pages: int, hot_width: int,
                page_size: int = 16):
    """Both instances' (and the single reference's) engine and scheduler
    configs: whole-prompt prefill, decode bounded at ``hot_width`` pages
    with the int8 cold tier. The prefill instance decodes each request's
    first token after its prefill, in the same tick and before the hop
    (the reference's router does too), so it carries the decode tuning:
    every decoded token then runs in one form, the single instance's."""
    return (PagedEngineCfg(max_batch=4, page_size=page_size,
                           n_pages=n_pages, hot_pages=hot_pages, eos_id=-1),
            SchedulerCfg(chunk_pages=None, decode_hot_width=hot_width,
                         kv_quant="int8"))


def count_int8_reads(backend) -> dict:
    """Wrap the backend's page-state step: ``slots`` counts the gathered
    slots (valid ones) that read the int8 tier, over every decode step,
    and ``ticks`` the steps with a marked slot (the others carry no
    qmask and run K1's fp form)."""
    real = backend._page_state
    tally = {"slots": 0, "ticks": 0}

    def counted(*args, **kw):
        ps = real(*args, **kw)
        if "qmask" in ps:
            tally["ticks"] += 1
            tally["slots"] += int((ps["qmask"]
                                   & (ps["logical"] >= 0)).sum())
        return ps

    backend._page_state = counted
    tally["restore"] = lambda: setattr(backend, "_page_state", real)
    return tally


def time_transfers(transfer, on_card: bool) -> dict:
    """Host time of each hop's ``begin`` (export to host rows, validate,
    stage) + ``complete`` (adopt on the decode instance; its rows upload
    at the decode instance's next swap-in)."""
    begin, complete = transfer.begin, transfer.complete
    tally = {"ms": [], "bytes": []}

    def timed_begin(rid):
        t0 = time.perf_counter()
        out = begin(rid)
        tally["t0"] = t0
        if out is not None:
            tally["bytes"].append(out["bytes"])
        return out

    def timed_complete(rid):
        out = complete(rid)
        if on_card:
            torch.cuda.synchronize()
        tally["ms"].append(1e3 * (time.perf_counter() - tally.pop("t0")))
        return out

    transfer.begin, transfer.complete = timed_begin, timed_complete
    tally["restore"] = lambda: (setattr(transfer, "begin", begin),
                                setattr(transfer, "complete", complete))
    return tally


def drive_disagg(router, prompts, max_tokens: int, on_card: bool,
                 follow_up=None):
    """Submit every prompt and tick the router to idle, holding page
    conservation and the refcount watchdog on BOTH pools after every tick
    (``tests/disagg_scenarios.py``'s rule); the fabric must end empty.
    ``follow_up``, a prompt, is submitted once the first hop has landed.
    Returns the handles, the router ticks, the wall seconds, the seconds
    of it the checks took and how many tokens the first request had when
    the follow-up was submitted."""
    handles = [router.submit(p, max_tokens=max_tokens) for p in prompts]
    t0 = time.perf_counter()
    ticks = 0
    checks_s = 0.0
    follow_at = None
    while router.has_work():
        router.tick()
        if follow_up is not None and router.transfer.n_transfers:
            follow_at = len(handles[0].tokens)
            handles.append(router.submit(follow_up, max_tokens=max_tokens))
            follow_up = None
        ticks += 1
        t_check = time.perf_counter()
        for name, eng in (("prefill", router.prefill),
                          ("decode", router.engine)):
            err = tobs.conservation_error(eng.accounting_snapshot())
            wd = tobs.reconcile_refs(eng._expected_refs(),
                                     eng.backend.pool_refs())
            if err or not wd.ok:
                raise SystemExit(f"disagg: {name} pool at router tick "
                                 f"{ticks}: conservation error {err}, "
                                 f"watchdog {wd.describe()}")
        checks_s += time.perf_counter() - t_check
        if ticks > 100_000:
            raise SystemExit("disagg: the router never drained")
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if router.transfer.in_flight() or len(router.transfer.staging):
        raise SystemExit("disagg: a transfer was left in flight or staged")
    return handles, ticks, wall, checks_s, follow_at


def serve_disagg(cfg, params, prompts, max_tokens, *, device, generator,
                 n_pages, hot_pages, hot_width, fault_plan=None,
                 page_size: int = 16, follow_up=None) -> tuple:
    """The instance pair (``DisaggRouter.from_config``, one params tree,
    one telemetry), served from a zero launch count. Returns the router,
    the served tokens and the summary."""
    on_card = torch.device(device).type == "cuda"
    pcfg, scfg = disagg_cfgs(n_pages, hot_pages, hot_width, page_size)
    router = DisaggRouter.from_config(
        cfg, params=params, device=device, generator=generator,
        prefill_engine_cfg=pcfg, decode_engine_cfg=pcfg,
        prefill_sched_cfg=scfg, decode_sched_cfg=scfg,
        fault_plan=fault_plan)
    pre_ticks = count_decode_ticks(router.prefill.backend)
    dec_ticks = count_decode_ticks(router.engine.backend)
    pre_reads = count_int8_reads(router.prefill.backend)
    dec_reads = count_int8_reads(router.engine.backend)
    hops = time_transfers(router.transfer, on_card)
    prefills = count_prefills(on_card)
    kernels.reset_launches()
    try:
        handles, ticks, wall, checks_s, follow_at = drive_disagg(
            router, prompts, max_tokens, on_card, follow_up)
    finally:
        for t in (pre_ticks, dec_ticks, pre_reads, dec_reads, hops,
                  prefills):
            t["restore"]()
    launches = dict(kernels.LAUNCHES)
    forms = dict(kernels.FORM_LAUNCHES)
    tokens = [h.tokens for h in handles]
    ttft = [1e3 * router.records[h.rid].ttft for h in handles]
    n_tok = sum(len(t) for t in tokens)
    tr = router.transfer.stats()
    wgmma_calls = sum(launch.tile_form(min(cfg.star.block_q, w),
                                       min(cfg.star.block_kv, w)) == "wgmma"
                      for w in prefills["widths"])
    pre_q = router.prefill.backend.page_accounting()["quantize_events"]
    dec_q = router.engine.backend.page_accounting()["quantize_events"]
    summary = {
        "requests": len(handles), "outcomes": [h.outcome for h in handles],
        "follow_up_after_tokens": follow_at, "tokens": n_tok,
        "wall_s": wall, "tok_s": n_tok / wall,
        "router_ticks": ticks, "checks_s": checks_s,
        "ttft_ms_p50": float(np.median(ttft)), "ttft_ms_max": float(max(ttft)),
        "prefill_side_decode_ticks": pre_ticks["ticks"],
        "decode_side_ticks": dec_ticks["ticks"],
        "decode_ms_per_tick": 1e3 * dec_ticks["decode_s"]
        / max(dec_ticks["ticks"], 1),
        "transfers": tr["n_transfers"], "transfer_faults": tr["n_faults"],
        "transfer_recomputes": tr["n_recompute"],
        "transfer_bytes_total": tr["bytes_total"],
        "transfer_bytes": hops["bytes"], "transfer_ms": hops["ms"],
        "transfer_ms_mean": float(np.mean(hops["ms"])) if hops["ms"]
        else None,
        "quantize_events_prefill_side": pre_q,
        "quantize_events_decode_side": dec_q,
        "int8_slots_read_prefill_side": pre_reads["slots"],
        "int8_slots_read_decode_side": dec_reads["slots"],
        "hot_width": hot_width,
        "prefill_calls": prefills["calls"],
        "prefill_widths": prefills["widths"],
        "prefill_s": prefills["seconds"],
        "k1_launches": launches["paged_decode"],
        "k1_fp_launches": forms["paged_decode/fp"],
        "k1_int8_launches": forms["paged_decode/int8"],
        "expected_k1_launches": (pre_ticks["ticks"] + dec_ticks["ticks"])
        * cfg.n_layers,
        "expected_k1_int8_launches": (pre_reads["ticks"]
                                      + dec_reads["ticks"]) * cfg.n_layers,
        "dlzs_block_launches": launches["dlzs_block"],
        "sufa_launches": launches["sufa"],
        "form_launches": forms,
        "expected_prefill_launches": prefills["calls"] * cfg.n_layers,
        "expected_wgmma_launches": wgmma_calls * cfg.n_layers}
    return router, tokens, summary


def require_disagg(summary: dict, router, n_requests: int, tag: str,
                   reads: bool) -> None:
    """Phase 9's holds on a fault-free pair: one hop per request, bytes on
    the wire, both pools drained, pages quantized and, with ``reads``,
    gathered slots read from the int8 tier."""
    fails = []
    if summary["outcomes"] != ["done"] * n_requests:
        fails.append(f"outcomes {summary['outcomes']}")
    if summary["transfers"] != n_requests or summary["transfer_faults"]:
        fails.append(f"{summary['transfers']} transfers, "
                     f"{summary['transfer_faults']} faults")
    if summary["transfer_bytes_total"] <= 0:
        fails.append("no payload bytes crossed the fabric")
    for name, eng in (("prefill", router.prefill), ("decode", router.engine)):
        st = eng.stats()
        if st["pool"].live or st["swap"].entries:
            fails.append(f"{name} pool not drained: {st['pool'].live} live, "
                         f"{st['swap'].entries} parked")
    if summary["quantize_events_decode_side"] <= 0:
        fails.append("the decode side quantized no page")
    if reads and summary["int8_slots_read_prefill_side"] \
            + summary["int8_slots_read_decode_side"] <= 0:
        fails.append("no gathered slot read the int8 tier")
    if fails:
        raise SystemExit(f"{tag}: " + "; ".join(fails))


def require_disagg_launches(summary: dict, tag: str) -> None:
    """K1 once per layer of every decode tick on either instance: in its
    int8 form on ticks with a slot marked, in its fp form on the others;
    K2/K3 once per layer of every prefill call."""
    want = summary["expected_k1_launches"]
    want_int8 = summary["expected_k1_int8_launches"]
    if want == 0 or (summary["k1_launches"], summary["k1_int8_launches"],
                     summary["k1_fp_launches"]) != (want, want_int8,
                                                    want - want_int8):
        raise SystemExit(f"{tag}: K1 launched {summary['k1_launches']} "
                         f"times, {summary['k1_int8_launches']} in its int8 "
                         f"form and {summary['k1_fp_launches']} in its fp "
                         f"form; expected decode ticks x layers = {want}, "
                         f"{want_int8} of them int8 (ticks with a marked "
                         f"slot x layers)")
    require_prefill_launches(summary, tag)


def serve_follow_up(llm: LLM, first, follow_up, max_tokens: int) -> tuple:
    """One instance serves ``first`` and, after the tick that prefilled
    it and emitted its first tokens, ``follow_up``: the pair submits its
    follow-up after that same tick, in which the first hop lands. The
    pair's decode instance has by then decoded the first request once
    more; were that step to quantize a page the follow-up's window later
    reads, the tokens could part, which the comparison would show.
    Returns the tokens and how many the first request had at that
    point."""
    handles = [llm.submit(first, max_tokens=max_tokens)]
    while not handles[0].tokens:
        if not llm.has_work():
            raise SystemExit("the single instance emitted no token")
        llm.tick()
    follow_at = len(handles[0].tokens)
    handles.append(llm.submit(follow_up, max_tokens=max_tokens))
    llm.run_until_done()
    if not all(h.done and h.outcome == "done" for h in handles):
        raise SystemExit("the single instance left requests unserved")
    return [h.tokens for h in handles], follow_at


def require_same_tokens(tokens, want, tag: str) -> None:
    if tokens != want:
        diff = [(i, next((j for j, (a, b) in enumerate(zip(t, w)) if a != b),
                         min(len(t), len(w))))
                for i, (t, w) in enumerate(zip(tokens, want)) if t != w]
        raise SystemExit(f"{tag}: the pair's tokens differ from one "
                         f"instance's at (request, token) {diff}")


def check_disagg(cfg, params, prompts, max_tokens, *, device, generator,
                 n_pages, hot_pages, hot_width, tier_prompt=None) -> dict:
    """Phase 9: the pair against one instance of the same configs, token
    for token; a run that loses one hop (decode-side recompute); and a
    run whose second request reads pages of the first's from the int8
    tier (``tier_prompt`` and its first half; default: the longest
    prompt), also against one instance, which gets the second request at
    the same point, token for token."""
    kw = dict(device=device, generator=generator, n_pages=n_pages,
              hot_pages=hot_pages, hot_width=hot_width)
    router, tokens, pair = serve_disagg(cfg, params, prompts, max_tokens,
                                        **kw)
    require_disagg(pair, router, len(prompts), "disaggregated serving",
                   reads=False)
    del router
    pcfg, scfg = disagg_cfgs(n_pages, hot_pages, hot_width)
    single = LLM.from_config(cfg, backend="paged", params=params,
                             device=device, generator=generator,
                             engine_cfg=pcfg, sched_cfg=scfg)
    require_same_tokens(tokens, serve(single, prompts, max_tokens)["done"],
                        "disaggregated serving")
    del single
    plan = FaultPlan(schedule={"transfer": {0}})
    router, f_tokens, faulted = serve_disagg(cfg, params, prompts,
                                             max_tokens, fault_plan=plan,
                                             **kw)
    if faulted["outcomes"] != ["done"] * len(prompts) or \
            faulted["transfer_faults"] != 1 or plan.fired() != 1:
        raise SystemExit(f"disaggregated serving with a lost hop: outcomes "
                         f"{faulted['outcomes']}, "
                         f"{faulted['transfer_faults']} faults")
    del router
    # the int8 tier read: a request on a page-aligned prefix of an earlier,
    # longer one arrives after that one's first decode quantized its cold
    # pages, and its own window selects some of them (pages of the STAR
    # q-tile, so that sharing a page never splits a tile)
    page = cfg.star.block_q
    long_prompt = max(prompts, key=len) if tier_prompt is None \
        else tier_prompt
    short = long_prompt[:len(long_prompt) // 2 // page * page]
    n_pages = 2 * -(-(len(long_prompt) + max_tokens) // page) + 2
    router, read_tokens, read = serve_disagg(
        cfg, params, [long_prompt], max_tokens, page_size=page,
        follow_up=short, **dict(kw, n_pages=n_pages, hot_pages=n_pages - 1))
    require_disagg(read, router, 2, "int8 tier read", reads=True)
    del router
    pcfg, scfg = disagg_cfgs(n_pages, n_pages - 1, hot_width, page)
    single = LLM.from_config(cfg, backend="paged", params=params,
                             device=device, generator=generator,
                             engine_cfg=pcfg, sched_cfg=scfg)
    want, follow_at = serve_follow_up(single, long_prompt, short, max_tokens)
    del single
    read["single_follow_up_after_tokens"] = follow_at
    require_same_tokens(read_tokens, want, "int8 tier read")
    return {"pair": pair, "tier_read": read, "tokens_equal_single": True,
            "tier_read_tokens_equal_single": True,
            "faulted": {k: faulted[k] for k in (
                "outcomes", "transfers", "transfer_faults", "tokens",
                "tok_s", "ttft_ms_p50", "ttft_ms_max", "prefill_calls",
                "decode_side_ticks", "quantize_events_decode_side")},
            "faulted_tokens_equal_fault_free": f_tokens == tokens,
            "faulted_tokens": f_tokens, "tokens": tokens,
            "tier_read_tokens": read_tokens}


# -- phases 10-12: ChatGLM3-6B, the dense engine, the other configs ----------

def count_dense_decode(on_card: bool) -> dict:
    """Wrap ``lm.decode_step`` (the dense slot engine's decode): ``ticks``
    and their host time through the device's end."""
    real = lm.decode_step
    tally = {"ticks": 0, "decode_s": 0.0}

    def counted(*args, **kw):
        t0 = time.perf_counter()
        out = real(*args, **kw)
        if on_card:
            torch.cuda.synchronize()
        tally["decode_s"] += time.perf_counter() - t0
        tally["ticks"] += 1
        return out

    lm.decode_step = counted
    tally["restore"] = lambda: setattr(lm, "decode_step", real)
    return tally


def serve_dense(cfg, params, prompts, max_tokens, *, device,
                generator) -> tuple:
    """The dense slot engine (``LLM.from_config(backend="dense")``) over
    the prompts, from a zero launch count: one ``lm.prefill`` per request
    (per attention layer K4 with ``star=None``, K2 and K3 with STAR) and
    a plain-PyTorch decode over the dense cache and the recurrent state
    slabs, which launches no kernel of the port."""
    max_len = -(-(max(len(p) for p in prompts) + max_tokens + 1) // 16) * 16
    llm = LLM.from_config(cfg, backend="dense", params=params,
                          device=device, generator=generator,
                          engine_cfg=EngineCfg(max_batch=4, max_len=max_len,
                                               eos_id=-1))
    on_card = torch.device(device).type == "cuda"
    ticks = count_dense_decode(on_card)
    prefills = count_prefills(on_card)
    kernels.reset_launches()
    t0 = time.perf_counter()
    handles = [llm.submit(p, max_tokens=max_tokens) for p in prompts]
    try:
        llm.run_until_done()
    finally:
        ticks["restore"]()
        prefills["restore"]()
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    form_launches = dict(kernels.FORM_LAUNCHES)
    if not all(h.done and h.outcome == "done" for h in handles):
        raise SystemExit("the dense engine left requests unserved")
    done = [h.tokens for h in handles]
    ttft = [1e3 * llm.records[h.rid].ttft for h in handles]
    n_tok = sum(len(t) for t in done)
    slab = sum(x.numel() * x.element_size()
               for x in tree_leaves(llm.engine.cache["layers"]))
    summary = {"requests": len(done), "tokens": n_tok, "wall_s": wall,
               "tok_s": n_tok / wall, "ttft_ms_p50": float(np.median(ttft)),
               "ttft_ms_max": float(max(ttft)), "max_len": max_len,
               "slab_bytes": slab, "decode_ticks": ticks["ticks"],
               "decode_ms_per_tick": 1e3 * ticks["decode_s"]
               / max(ticks["ticks"], 1),
               "prefill_calls": prefills["calls"],
               "prefill_widths": prefills["widths"],
               "prefill_s": prefills["seconds"], "launches": launches}
    star, layers = cfg.star, attn_layers(cfg)
    wgmma_calls = 0 if star is None else sum(
        launch.tile_form(min(star.block_q, w), min(star.block_kv, w))
        == "wgmma" for w in prefills["widths"])
    per_call = 0 if star is None else layers
    summary.update(
        dlzs_block_launches=launches["dlzs_block"],
        sufa_launches=launches["sufa"], flash_launches=launches["flash"],
        form_launches=form_launches,
        expected_prefill_launches=prefills["calls"] * per_call,
        expected_flash_launches=prefills["calls"] * (layers - per_call),
        expected_wgmma_launches=wgmma_calls * layers,
        expected_sufa_wgmma_launches=wgmma_calls * per_call)
    return done, summary


def require_dense_launches(summary: dict, tag: str) -> None:
    """The dense engine: per attention layer of each prefill, K4 with
    ``star=None`` or K2 and K3 (in their wgmma forms at tiles of 128) with
    STAR; K1 never."""
    launches = summary["launches"]
    if launches["paged_decode"] or launches["paged_decode_stats"]:
        raise SystemExit(f"{tag}: K1 launched on the dense engine: "
                         f"{launches}")
    if summary["expected_prefill_launches"]:
        require_prefill_launches(summary, tag)
    elif launches["flash"] != summary["expected_flash_launches"] or \
            launches["dlzs_block"] or launches["sufa"]:
        raise SystemExit(f"{tag}: launches {launches}; expected K4 "
                         f"prefill calls x attention layers = "
                         f"{summary['expected_flash_launches']} and no "
                         f"other kernel")


@torch.inference_mode()
def warm_prefill(params, cfg, t: int) -> None:
    """One ``lm.prefill`` of a t-token prompt, so the served numbers that
    follow do not carry the first call's library set-up."""
    dev = params["embed"].device
    toks = torch.as_tensor(make_prompts(cfg, (t,), SEED + 99)[0][None],
                           device=dev)
    lm.prefill(params, cfg, {"tokens": toks})
    sync(dev)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def init_params(cfg, gen, dev) -> tuple:
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    params = lm.init(cfg, gen, dev)
    sync(dev)
    return params, {"init_s": time.perf_counter() - t0,
                    "params": sum(t.numel() for t in tree_leaves(params))}


def pool_pages(prompts, max_tokens: int) -> int:
    """A page pool twice the size of every request's whole sequence."""
    return 2 * -(-(sum(map(len, prompts)) + len(prompts) * max_tokens)
                 // 16)


def serve_exact(cfg, params, prompts, max_tokens, dev, gen,
                record: bool) -> tuple:
    """``star=None`` through the paged engine with whole-prompt prefill;
    with ``record``, each request's decode logits (``served_rows``), else
    None. Returns (the run, its summary, the logits)."""
    log = record_decode_logits() if record else None
    try:
        llm, run, summary = serve_whole_prompt(
            dataclasses.replace(cfg, star=None), params, prompts,
            max_tokens, device=dev, generator=gen,
            n_pages=pool_pages(prompts, max_tokens))
    finally:
        if log is not None:
            log["restore"]()
    del llm
    free_cache(dev)
    return run, summary, log and served_rows(log, prompts, run["done"])


def serve_star_and_exact(cfg, params, prompts, max_tokens, dev, gen,
                         tag: str, witness: bool = False) -> tuple:
    """A full-depth model through the paged engine with whole-prompt
    prefill: STAR on (launch counts; each first token against a
    cache-free STAR forward), then ``star=None`` (a STAR prefill keeps
    other K/V than a dense one, so only that setting has a dense oracle;
    every token held by phase 4's rule against a K4 forward; with
    ``witness``, the served logits witness as ``check_exact`` says).
    Returns (STAR summary, exact summary, the exact run's tokens)."""
    warm_prefill(params, cfg, len(prompts[0]))
    warm_prefill(params, dataclasses.replace(cfg, star=None),
                 len(prompts[0]))
    llm, run, star = serve_whole_prompt(
        cfg, params, prompts, max_tokens, device=dev, generator=gen,
        n_pages=pool_pages(prompts, max_tokens))
    star.update(check_first_tokens(params, cfg, prompts, run["done"],
                                   llm.engine.backend.pcfg.bucket_pow2))
    star.update(slab_bytes=llm.engine.backend.stats()["slab_bytes"],
                bytes_per_page=llm.engine.backend.page_bytes_full)
    del llm
    free_cache(dev)
    emit(f"{tag}_served", attention="star", **star)
    require_launches(star, f"{tag} served")
    require_prefill_launches(star, f"{tag} served")
    run, exact_run, logits = serve_exact(cfg, params, prompts, max_tokens,
                                         dev, gen, witness)
    require_launches(exact_run, f"{tag} served, star=None")
    require_prefill_launches(exact_run, f"{tag} served, star=None")
    exact_run.update(check_exact(params, cfg, prompts, run["done"],
                                 served_logits=logits))
    emit(f"{tag}_served", attention="dense", **exact_run)
    require_k4(exact_run, f"{tag} exactness")
    return star, exact_run, run["done"]


def check_chatglm(cfg, dev, gen, lengths=GLM_PROMPTS,
                  max_tokens=GLM_MAX_TOKENS) -> dict:
    """Phases 10-11: ChatGLM3-6B at full width and depth (K1 at R = 16,
    K2/K3 at BH = 32). 10a: STAR on, whole-prompt prefill through the
    paged engine, each first token against a cache-free STAR forward;
    then, as phase 7 does, the glue against the plain scanq at every 7th
    layer of a forward of the longest prompt. 10b: the exact-parity
    setting (``star=None``: a STAR prefill keeps other K/V than a dense
    one, so only that setting can be held to a dense forward): the same
    prompts through the paged engine, every decoded token held by phase
    4's rule against a dense K4 forward.
    11: the same requests through the dense slot engine, held the same
    way. Returns each run's summary."""
    params, info = init_params(cfg, gen, dev)
    emit("chatglm3_init", dtype=str(cfg.dtype), **info)
    prompts = make_prompts(cfg, lengths, SEED + 5)
    star, exact_run, paged_done = serve_star_and_exact(
        cfg, params, prompts, max_tokens, dev, gen, "chatglm3")
    fused = check_fused_star(params, cfg, SEED + 7, t=max(lengths),
                             timed=False, every=7, tag="chatglm3_fused_star")
    done, dense_run = serve_dense(dataclasses.replace(cfg, star=None),
                                  params, prompts, max_tokens, device=dev,
                                  generator=gen)
    require_dense_launches(dense_run, "dense engine")
    dense_run.update(check_exact(params, cfg, prompts, done))
    dense_run["tokens_equal_paged"] = sum(
        a == b for x, y in zip(done, paged_done) for a, b in zip(x, y))
    emit("dense_engine", **dense_run)
    require_k4(dense_run, "dense engine exactness")
    del params
    return {"star": star, "fused": fused, "exact": exact_run,
            "dense": dense_run}


def require_k4(summary: dict, tag: str) -> None:
    if summary["k4_launches"] != summary["expected_k4_launches"]:
        raise SystemExit(f"{tag}: K4 launched {summary['k4_launches']} "
                         f"times over {summary['forwards']} oracle "
                         f"forwards; expected forwards x layers (x 2 for "
                         f"an MoE's, K4's and the hybrid one) = "
                         f"{summary['expected_k4_launches']}")


def free_cache(device) -> None:
    """Collect unreachable objects (an engine and its backend refer to
    each other, so a dropped engine and the params it holds wait for the
    cycle collector), then return the freed blocks to the card."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def check_cut_config(name: str, cfg, dev, gen, *, layers=CUT_LAYERS,
                     prompt_len=CUT_PROMPT, max_tokens=GLM_MAX_TOKENS,
                     elementwise_too: bool = False) -> dict:
    """Phase 12: a config at its published widths with its depth cut to
    CUT_LAYERS, one CUT_PROMPT-token prompt served whole through the paged
    engine with STAR on: K1 and K2/K3 launch counts, the first token
    against a cache-free STAR forward. With ``elementwise_too`` the same
    again under ``STARConfig(elementwise=True)`` (K3's element mask)."""
    published = cfg.n_layers
    cfg = dataclasses.replace(cfg, n_layers=layers)
    params, info = init_params(cfg, gen, dev)
    prompts = make_prompts(cfg, (prompt_len,), SEED + 6)
    out = {}
    variants = [("star", cfg)]
    if elementwise_too:
        variants.append(("star_elementwise", dataclasses.replace(
            cfg, star=dataclasses.replace(cfg.star, elementwise=True))))
    for key, c in variants:
        warm_prefill(params, c, prompt_len)
        llm, run, summary = serve_whole_prompt(c, params, prompts,
                                               max_tokens, device=dev,
                                               generator=gen)
        summary.update(check_first_tokens(
            params, c, prompts, run["done"],
            llm.engine.backend.pcfg.bucket_pow2))
        del llm
        emit("cut_config", config=name, attention=key, layers=layers,
             reduced=f"n_layers {layers} of {published}",
             group=cfg.n_heads // cfg.n_kv, **info, **summary)
        require_launches(summary, f"{name} {key}")
        require_prefill_launches(summary, f"{name} {key}")
        out[key] = summary
    del params
    free_cache(dev)
    return out


# -- phase 13: the spatial (sequence-sharded) engine --------------------------

def spatial_llm(cfg, params, *, device, generator, n_shards, pages_local,
                hot_pages_local, hot_width=None) -> LLM:
    return LLM.from_config(
        cfg, backend="spatial", params=params, device=device,
        generator=generator,
        engine_cfg=SpatialEngineCfg(n_shards=n_shards, max_batch=4,
                                    page_size=16, n_pages_local=pages_local,
                                    hot_pages_local=hot_pages_local,
                                    eos_id=-1),
        sched_cfg=SchedulerCfg(chunk_pages=8, prefill_tokens="auto",
                               decode_hot_width=hot_width))


def spatial_summary(run: dict, llm: LLM, n_layers: int) -> dict:
    """Served numbers of a spatial run, its launches (the stats form once
    per layer of every tick, for all shards at once; the normalised K1
    never) and the per-shard skip counts the backend kept on the host."""
    ttft = run["ttft_ms"]
    st = llm.engine.backend.stats()
    return {"requests": len(run["done"]), "tokens": run["tokens"],
            "wall_s": run["wall_s"], "tok_s": run["tok_s"],
            "ttft_ms_p50": float(np.median(ttft)),
            "ttft_ms_max": float(max(ttft)),
            "decode_ticks": run["ticks"],
            "decode_ms_per_tick": 1e3 * run["decode_s"]
            / max(run["ticks"], 1),
            "k1_stats_launches": run["launches"]["paged_decode_stats"],
            "k1_stats_fp_launches": run["form_launches"][
                "paged_decode_stats/fp"],
            "k1_normalised_launches": run["launches"]["paged_decode"],
            "expected_stats_launches": run["ticks"] * n_layers,
            "pages_resident_per_tick": run["pages_total"]
            / max(run["ticks"], 1),
            "pages_gathered_per_tick": run["pages_hot"]
            / max(run["ticks"], 1),
            "shard_skips": st["shard_skips"],
            "decode_steps_total": st["decode_steps"],
            "hot_width": st["hot_width"], "n_shards": st["n_shards"],
            "slab_bytes": st["slab_bytes"]}


def require_spatial_launches(summary: dict, tag: str) -> None:
    if summary["decode_ticks"] == 0 or summary["k1_stats_launches"] != \
            summary["expected_stats_launches"] \
            or summary["k1_normalised_launches"] != 0:
        raise SystemExit(
            f"{tag}: K1's stats form launched "
            f"{summary['k1_stats_launches']} times over "
            f"{summary['decode_ticks']} decode ticks (expected ticks x "
            f"layers = {summary['expected_stats_launches']}), the "
            f"normalised form {summary['k1_normalised_launches']} times "
            f"(expected 0)")


def check_spatial(cfg, dev, gen, *, lengths=SPATIAL_PROMPTS,
                  max_tokens=SPATIAL_MAX_TOKENS, n_shards=SPATIAL_SHARDS,
                  pages_local=SPATIAL_PAGES_LOCAL,
                  hot_width=SPATIAL_HOT_WIDTH, short_len=20) -> dict:
    """Phase 13: OLMo-1B (phase 3's seed) with ``star=None`` through the
    spatial engine, ``n_shards`` shards of ``pages_local`` pages on one
    card. The longest prompt must be refused by a paged engine of one
    shard's pool and served here; K1's stats form launches ticks x layers
    times and the normalised form never; every token is held by phase 4's
    rule against a K4 forward. Then the decode width bounded at
    ``hot_width`` pages a shard, the same prompts and a lone
    ``short_len``-token request: pages gathered fall below pages resident
    and the per-shard skip counts, read after the run, are populated."""
    dense = dataclasses.replace(cfg, star=None)
    params, info = init_params(dense, gen, dev)
    prompts = make_prompts(dense, lengths, SEED + 8)
    need = -(-(max(lengths) + max_tokens) // 16)
    hot_local = -(-need // n_shards)
    one_pool = LLM.from_config(
        dense, backend="paged", params=params, device=dev, generator=gen,
        engine_cfg=PagedEngineCfg(max_batch=4, page_size=16,
                                  n_pages=pages_local, hot_pages=pages_local,
                                  eos_id=-1),
        sched_cfg=SchedulerCfg(chunk_pages=8))
    try:
        one_pool.submit(prompts[-1], max_tokens=max_tokens)
    except ValueError as e:
        refused = str(e)
    else:
        raise SystemExit(f"a paged engine of {pages_local} pages admitted "
                         f"a {max(lengths)}-token prompt ({need} pages)")
    del one_pool
    llm = spatial_llm(dense, params, device=dev, generator=gen,
                      n_shards=n_shards, pages_local=pages_local,
                      hot_pages_local=hot_local)
    # warm-up request (cuBLAS handles, allocator), not counted
    serve(llm, make_prompts(dense, (128,), SEED + 1), 2)
    llm.clear_finished()
    run = serve(llm, prompts, max_tokens)
    served = spatial_summary(run, llm, dense.n_layers)
    served.update(pages_needed_longest=need, one_pool_pages=pages_local,
                  one_pool_refused=refused, **info)
    require_spatial_launches(served, "spatial engine")
    exact = check_exact(params, dense, prompts, run["done"])
    require_k4(exact, "spatial engine exactness")
    served["exactness"] = exact
    emit("spatial_served", **served)
    del llm
    free_cache(dev)

    bounded = spatial_llm(dense, params, device=dev, generator=gen,
                          n_shards=n_shards, pages_local=pages_local,
                          hot_pages_local=hot_local, hot_width=hot_width)
    b_run = serve(bounded, prompts, max_tokens)
    b_sum = spatial_summary(b_run, bounded, dense.n_layers)
    require_spatial_launches(b_sum, "spatial engine, bounded width")
    if not b_sum["pages_gathered_per_tick"] < \
            b_sum["pages_resident_per_tick"]:
        raise SystemExit("spatial bounded run gathered every resident page")
    lone = serve(bounded, make_prompts(dense, (short_len,), SEED + 10),
                 max_tokens)
    lone_sum = spatial_summary(lone, bounded, dense.n_layers)
    require_spatial_launches(lone_sum, "spatial engine, lone request")
    skips = lone_sum["shard_skips"]
    if sum(skips) == 0 or len(skips) != n_shards:
        raise SystemExit(f"spatial bounded run: per-shard skip counts not "
                         f"populated: {skips}")
    b_sum.update(lone_request=lone_sum, shard_skips=skips)
    emit("spatial_bounded", **b_sum)
    del bounded, params
    free_cache(dev)
    return {"served": served, "bounded": b_sum}


# -- phases 14-15: the Mixture-of-Experts family ------------------------------

def drop_summary(log: dict, n_layers: int, decode_rows: int) -> dict:
    """Split ``record_routes``'s route calls: those over ``decode_rows``
    tokens (a decode tick's batch) are decode's, the rest come in runs of
    ``n_layers``, one run per prefill call. Returns each prefill's token
    count and share of choices dropped, and decode's dropped choices."""
    prefill = [c for c in log["routes"] if c[0] != decode_rows]
    decode = [c for c in log["routes"] if c[0] == decode_rows]
    runs = [prefill[i:i + n_layers] for i in range(0, len(prefill),
                                                   n_layers)]
    return {"prefill_tokens": [run[0][0] for run in runs],
            "dropped_share_per_prefill": [
                sum(int(c[2]) for c in run) / sum(c[3] for c in run)
                for run in runs],
            "decode_choices_dropped": sum(int(c[2]) for c in decode),
            "decode_choices": sum(c[3] for c in decode)}


def dropless(cfg):
    """The config at dropless capacity (capacity_factor = experts / top_k:
    cap > tokens a chunk, so no choice drops) and ``star=None``, the
    exact-parity setting of an MoE model."""
    return dataclasses.replace(cfg, star=None, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


@contextlib.contextmanager
def record_routes():
    """Within the block, wrap ``moe.route`` (the routing plan every MoE
    layer serves from) and the model's entry points (``lm.prefill``,
    ``lm.decode_step_paged``, ``lm.decode_step``), and yield their log:
    per route call, the tokens routed (chunks x tokens a chunk), the
    choices (eidx, one row per token) and the choices dropped, kept on
    the device until read after the run (``drop_summary``,
    ``served_routes``); per entry call, its token rows and their
    positions."""
    real = {"route": moe.route, "prefill": lm.prefill,
            "decode_step_paged": lm.decode_step_paged,
            "decode_step": lm.decode_step}
    log = {"calls": [], "routes": []}

    def route(x, *args, **kw):
        plan = real["route"](x, *args, **kw)
        log["routes"].append((
            x.shape[0] * x.shape[1],
            plan["eidx"].reshape(-1, plan["eidx"].shape[-1]),
            (~plan["keep"]).sum(), plan["keep"].numel()))
        return plan

    def prefill(params, cfg, batch, **kw):
        toks = batch["tokens"].cpu().numpy()
        pos = np.broadcast_to(np.arange(toks.shape[1]), toks.shape)
        log["calls"].append((toks, pos, len(log["routes"])))
        return real["prefill"](params, cfg, batch, **kw)

    def decode(name):
        def call(params, cfg, tokens, cache, *args, **kw):
            log["calls"].append((tokens.cpu().numpy(),
                                 cache["lengths"].cpu().numpy()[:, None],
                                 len(log["routes"])))
            return real[name](params, cfg, tokens, cache, *args, **kw)
        return call

    moe.route, lm.prefill = route, prefill
    lm.decode_step_paged = decode("decode_step_paged")
    lm.decode_step = decode("decode_step")
    try:
        yield log
    finally:
        moe.route, lm.prefill = real["route"], real["prefill"]
        lm.decode_step_paged = real["decode_step_paged"]
        lm.decode_step = real["decode_step"]


def served_routes(log: dict, prompts, done, cfg) -> list:
    """Assemble from ``record_routes``'s log, per request, the served
    path's choices at every position the oracle forward reads
    (the prompt, then each decoded token fed back): int [P, layers, k].
    A prefill row belongs to the request whose prompt it carries; a
    decode row (position p, token x) to the request that decoded x at p.
    Rows of the pool probe, of padding and of idle slots match none."""
    n_layers, k = moe_layers(cfg), cfg.moe.top_k
    routes = [np.full((len(p) + len(d) - 1, n_layers, k), -1, np.int64)
              for p, d in zip(prompts, done)]
    filled = [np.zeros((len(p) + len(d) - 1,), bool)
              for p, d in zip(prompts, done)]
    for toks, pos, first in log["calls"]:
        layers = [r[1].cpu().numpy() for r in
                  log["routes"][first:first + n_layers]]
        for b in range(toks.shape[0]):
            for rid, (prompt, out) in enumerate(zip(prompts, done)):
                n = len(prompt)
                if toks.shape[1] > 1:      # a prefill row: the whole prompt
                    if toks.shape[1] < n or \
                            not np.array_equal(toks[b, :n], prompt):
                        continue
                    at = np.arange(n)
                    rows = b * toks.shape[1] + at
                else:                      # a decode row: one fed token
                    p = int(pos[b, 0])
                    if not (n <= p < n + len(out) - 1) or \
                            toks[b, 0] != out[p - n]:
                        continue
                    at, rows = np.array([p]), np.array([b])
                routes[rid][at] = np.stack([e[rows] for e in layers],
                                           axis=-2)
                filled[rid][at] = True
    for rid, ok in enumerate(filled):
        if not ok.all():
            raise SystemExit(f"request {rid}: served routes missing at "
                             f"positions {np.flatnonzero(~ok)[:8]}")
    return routes


@contextlib.contextmanager
def forced_routing(routes, n_layers: int, tally: dict | None, store: list):
    """Within the block, ``lm.forward`` routes its first P rows as
    ``routes`` [P, layers, k] says (the served path's choices), weighted
    by its own gate's probabilities of those experts, renormalised; later
    rows (padding) route as its own gate does. A served choice the
    forward's own top-k leaves out is a flip. A first forward (``store``
    empty) keeps its gate logits in ``store``, and ``tally`` counts the
    rows routed and the flips (also per layer) and keeps each layer's
    largest gap: how far, in fp32 gate logits, the forward ranks a served
    expert below its own k-th choice. A second forward over the same rows
    (``store`` full) keeps in ``tally["rounding"]`` each layer's largest
    difference of its gate logits from the first's: how far rounding
    alone moves this model's gate there. With ``tally`` None the rows are
    routed and nothing is kept."""
    real = moe._gate
    calls = [0]
    compare = len(store) == n_layers

    def gate(x, wg, cfg):
        _, own, aux = real(x, wg, cfg)
        layer = calls[0] % n_layers
        calls[0] += 1
        n, t, k = own.shape
        logits = (x.float() @ wg.float()).reshape(n * t, -1)
        forced = own.reshape(n * t, k).clone()
        p = min(len(routes), n * t)
        forced[:p] = torch.as_tensor(routes[:p, layer], device=x.device)
        top_p = torch.softmax(logits, -1).gather(1, forced)
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
        if tally is None:
            pass
        elif compare:
            tally["rounding"][layer] = max(tally["rounding"][layer], float(
                (logits[:p] - store[layer]).abs().max()))
        else:
            store.append(logits[:p])
            kth = logits.gather(1, own.reshape(n * t, k)).min(-1).values
            gap = (kth[:p, None] - logits[:p].gather(1, forced[:p])
                   ).clamp_min(0).max(-1).values
            n_flips = int((gap > 0).sum())
            tally["rows"] += p
            tally["flips"] += n_flips
            tally["flips_per_layer"][layer] += n_flips
            tally["max_gap"][layer] = max(tally["max_gap"][layer],
                                          float(gap.max()))
        return (top_p.reshape(n, t, k), forced.reshape(n, t, k), aux)

    moe._gate = gate
    try:
        yield
    finally:
        moe._gate = real


MOE_RANGE, FFN_RANGE = "moe.apply", "moe.expert_ffn"


def moe_device_share(fn, on_card: bool) -> dict:
    """Run ``fn`` once under ``torch.profiler`` with ranges around
    ``moe.apply`` (gate, dispatch, expert FFN, combine) and its expert FFN
    (the batched matmuls over every expert): the kernels' summed device
    time, the time the device was busy, the kernels that took the most,
    and each range's kernel time (``repro_torch.profiling``) and its share
    of the summed time. Off the card there are no device kernels, and the
    shares are None."""
    from torch.profiler import ProfilerActivity, profile
    ranges = {(moe, "apply"): MOE_RANGE, (moe, "expert_ffn"): FFN_RANGE}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    with profiling.ranged(ranges), profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if on_card:
            torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    names = set(ranges.values())
    device, busy, top = profiling.device_kernels(prof, names)
    moe_ms, ffn_ms = (profiling.range_device_ms(prof, name, names)
                      for name in (MOE_RANGE, FFN_RANGE))
    share = (lambda ms: ms / device) if device > 0 else (lambda ms: None)
    return {"wall_ms_profiled": wall, "device_ms": device,
            "busy_ms": busy, "top_kernels_ms": {
                k["name"]: k["device_ms"] for k in top[:8]},
            "moe_device_ms": moe_ms, "expert_ffn_device_ms": ffn_ms,
            "moe_share": share(moe_ms), "expert_ffn_share": share(ffn_ms)}


def moe_shares(llm: LLM, params, cfg, prompt_len: int, decode_prompt: int,
               on_card: bool) -> dict:
    """The MoE's share of one decode tick (the backend's third decode step
    while four requests are served) and of one ``prompt_len``-token
    ``lm.prefill`` (STAR as configured). Bytes of every expert's weights
    in one layer are what a decode tick's expert FFN must read per layer
    at a batch this small."""
    backend = llm.engine.backend
    step = backend.decode_step
    out = {}

    def third(*args, **kw):
        third.n += 1
        if third.n != 3:
            return step(*args, **kw)
        res = {}
        out["decode"] = moe_device_share(
            lambda: res.setdefault("v", step(*args, **kw)), on_card)
        return res["v"]
    third.n = 0
    backend.decode_step = third
    try:
        serve(llm, make_prompts(cfg, (decode_prompt,) * 4, SEED + 14), 6)
    finally:
        backend.decode_step = step
    llm.clear_finished()
    toks = torch.as_tensor(
        make_prompts(cfg, (prompt_len,), SEED + 15)[0][None],
        device=params["embed"].device)
    out["prefill"] = moe_device_share(
        lambda: lm.prefill(params, cfg, {"tokens": toks}), on_card)
    out["prefill"]["tokens"] = prompt_len
    ffn = params["blocks"]["b0"]["ffn"]
    out["decode"]["expert_weight_bytes"] = cfg.n_layers * sum(
        ffn[k][0].numel() * ffn[k].element_size()
        for k in ("w1", "w2", "w3") if k in ffn)
    return out


def check_olmoe(cfg, dev, gen, *, lengths=OLMOE_PROMPTS,
                max_tokens=OLMOE_MAX_TOKENS, main_lengths=MAIN_PROMPTS,
                main_tokens=MAIN_MAX_TOKENS, n_pages_main=1024,
                hot_main=64) -> dict:
    """Phase 14: OLMoE-1B-7B at full width and depth (see the module
    docstring): (a) STAR, reference capacity, whole-prompt prefill; (b)
    dropless ``star=None`` against K4 forwards; (c) the dense slot engine,
    dropless; (d) the chunked-prefill main path at the reference's
    capacity; the MoE's share of a decode tick and of the longest
    prefill. Returns each run's summary."""
    on_card = torch.device(dev).type == "cuda"
    params, info = init_params(cfg, gen, dev)
    emit("olmoe_init", dtype=str(cfg.dtype), **info)
    prompts = make_prompts(cfg, lengths, SEED + 11)
    exact_cfg = dropless(cfg)
    warm_prefill(params, cfg, lengths[0])
    warm_prefill(params, exact_cfg, lengths[0])
    n_pages = pool_pages(prompts, max_tokens)
    with record_routes() as log:
        llm, run, star = serve_whole_prompt(cfg, params, prompts,
                                            max_tokens, device=dev,
                                            generator=gen, n_pages=n_pages)
    star.update(drop_summary(log, cfg.n_layers, 4))
    star.update(check_first_tokens(params, cfg, prompts, run["done"],
                                   llm.engine.backend.pcfg.bucket_pow2))
    emit("olmoe_served", attention="star",
         capacity_factor=cfg.moe.capacity_factor, **star)
    require_launches(star, "OLMoE-1B-7B served")
    require_prefill_launches(star, "OLMoE-1B-7B served")
    del llm
    free_cache(dev)

    with record_routes() as log:
        llm, run, exact_run = serve_whole_prompt(
            exact_cfg, params, prompts, max_tokens, device=dev,
            generator=gen, n_pages=n_pages)
    routes = served_routes(log, prompts, run["done"], exact_cfg)
    exact_run.update(drop_summary(log, cfg.n_layers, 4))
    del llm
    free_cache(dev)
    require_launches(exact_run, "OLMoE-1B-7B served, dropless")
    require_prefill_launches(exact_run, "OLMoE-1B-7B served, dropless")
    require_dropless(exact_run, "OLMoE-1B-7B served, dropless")
    exact_run.update(check_exact(params, exact_cfg, prompts, run["done"],
                                 routes=routes))
    emit("olmoe_served", attention="dense",
         capacity_factor=exact_cfg.moe.capacity_factor, **exact_run)
    require_k4(exact_run, "OLMoE-1B-7B exactness")

    with record_routes() as log:
        done, dense_run = serve_dense(exact_cfg, params, prompts,
                                      max_tokens, device=dev, generator=gen)
    routes = served_routes(log, prompts, done, exact_cfg)
    require_dense_launches(dense_run, "OLMoE-1B-7B dense engine")
    dense_run.update(check_exact(params, exact_cfg, prompts, done,
                                 routes=routes))
    dense_run["tokens_equal_paged"] = sum(
        a == b for x, y in zip(done, run["done"]) for a, b in zip(x, y))
    emit("olmoe_dense_engine", **dense_run)
    require_k4(dense_run, "OLMoE-1B-7B dense engine exactness")
    free_cache(dev)

    main_llm = main_path_llm(cfg, params, n_pages=n_pages_main,
                             hot_pages=hot_main, past_pages=hot_main,
                             device=dev, generator=gen)
    serve(main_llm, make_prompts(cfg, (128,), SEED + 1), 2)
    main_llm.clear_finished()
    with record_routes() as log:
        main_run = serve(main_llm, make_prompts(cfg, main_lengths,
                                                SEED + 12), main_tokens)
    main = served_summary(main_run, cfg.n_layers)
    main.update(drop_summary(log, cfg.n_layers, 4))
    emit("olmoe_main_path", capacity_factor=cfg.moe.capacity_factor, **main)
    require_launches(main, "OLMoE-1B-7B main path")
    shares = moe_shares(main_llm, params, cfg, max(lengths),
                        main_lengths[0], on_card)
    emit("olmoe_moe_share", **shares)
    del main_llm, params
    free_cache(dev)
    return {"star": star, "exact": exact_run, "dense": dense_run,
            "main": main, "shares": shares}


def require_dropless(summary: dict, tag: str) -> None:
    dropped = sum(summary["dropped_share_per_prefill"]) \
        + summary["decode_choices_dropped"]
    if dropped:
        raise SystemExit(f"{tag}: choices dropped at dropless capacity: "
                         f"{summary['dropped_share_per_prefill']}, decode "
                         f"{summary['decode_choices_dropped']}")


def check_grok(cfg, dev, gen, *, layers=GROK_LAYERS, prompt_len=GROK_PROMPT,
               max_tokens=GROK_MAX_TOKENS) -> dict:
    """Phase 15: Grok-1 at its published width with its depth cut to
    ``layers``: one ``prompt_len``-token prompt served whole through the
    paged engine with STAR on at the reference's capacity (K1 at R = 6,
    K2/K3 at BH 48; the first token against a STAR forward), then
    dropless with ``star=None`` (every token by phase 4's rule)."""
    published = cfg.n_layers
    cfg = dataclasses.replace(cfg, n_layers=layers)
    params, info = init_params(cfg, gen, dev)
    emit("grok_init", dtype=str(cfg.dtype), layers=layers,
         reduced=f"n_layers {layers} of {published}",
         group=cfg.n_heads // cfg.n_kv, **info)
    prompts = make_prompts(cfg, (prompt_len,), SEED + 13)
    exact_cfg = dropless(cfg)
    warm_prefill(params, cfg, prompt_len)
    warm_prefill(params, exact_cfg, prompt_len)
    out = {}
    for key, c in (("star", cfg), ("exact", exact_cfg)):
        with record_routes() as log:
            llm, run, summary = serve_whole_prompt(c, params, prompts,
                                                   max_tokens, device=dev,
                                                   generator=gen)
        summary.update(drop_summary(log, cfg.n_layers, 4))
        pow2 = llm.engine.backend.pcfg.bucket_pow2
        del llm
        require_launches(summary, f"Grok-1 {key}")
        require_prefill_launches(summary, f"Grok-1 {key}")
        if key == "star":
            summary.update(check_first_tokens(params, c, prompts,
                                              run["done"], pow2))
        else:
            require_dropless(summary, "Grok-1 dropless")
            summary.update(check_exact(params, c, prompts, run["done"],
                                       routes=served_routes(
                                           log, prompts, run["done"], c)))
            require_k4(summary, "Grok-1 exactness")
        emit("grok_served", attention=key, layers=layers,
             capacity_factor=c.moe.capacity_factor, **summary)
        out[key] = summary
    del params
    free_cache(dev)
    return out


# -- phases 16-17: the recurrent families --------------------------------------

def check_attention_kernels_at(dev, *, bh: int, t: int, seed: int) -> dict:
    """K2, K3 (both modes) and K4 against their plain versions at one
    model's attention prefill shape (tiles 128, STAR's keep at top-k 0.2),
    timed as in phase 6 (bound, plain version, SDPA) on the card."""
    timed = torch.device(dev).type == "cuda"
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev) \
        if timed else None
    out = {"dlzs_block": check_dlzs(dev, flush, bh=bh, t=t, block=128,
                                    causal=True, seed=seed, timed=timed),
           "sufa": check_sufa(dev, flush, bh=bh, t=t, block=128,
                              strict=True, seed=seed + 1, timed=timed),
           "sufa_fast": check_sufa(dev, flush, bh=bh, t=t, block=128,
                                   strict=False, seed=seed + 2,
                                   timed=False),
           "flash": check_flash(dev, flush, bh=bh, t=t, causal=True,
                                seed=seed + 3, timed=timed)}
    del flush
    free_cache(dev)
    return out


def warm_dense(params, cfg, dev, gen, t: int = 256) -> None:
    """A short request through the dense engine, not counted, so that the
    served numbers do not carry the first decode tick's set-up (on an
    H100 the first Jamba decode tick took 3.5 s, the next ones 20-25
    ms)."""
    serve_dense(cfg, params, make_prompts(cfg, (t,), SEED + 20), 3,
                device=dev, generator=gen)
    free_cache(dev)


def profiled_prefill(params, cfg, t: int, on_card: bool) -> dict:
    """One ``t``-token ``lm.prefill`` under ``torch.profiler``, its device
    time split by block (``profiling.model_ranges``/``prefill_split``):
    wall, kernels' summed device time, busy time and the split."""
    from torch.profiler import ProfilerActivity, profile
    toks = torch.as_tensor(make_prompts(cfg, (t,), SEED + 18)[0][None],
                           device=params["embed"].device)
    ranges = profiling.model_ranges(cfg)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    with torch.inference_mode(), profiling.ranged(ranges), \
            profile(activities=acts) as prof:
        t0 = time.perf_counter()
        lm.prefill(params, cfg, {"tokens": toks})
        if on_card:
            torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    device, busy, top = profiling.device_kernels(prof, set(ranges.values()))
    return {"tokens": t, "star": cfg.star is not None,
            "wall_ms_profiled": wall, "device_ms": device, "busy_ms": busy,
            "top_kernels_ms": {k["name"]: k["device_ms"] for k in top[:8]},
            "split": profiling.prefill_split(prof, ranges, device, top)
            if device > 0 else None}


def check_jamba(cfg, dev, gen, *, layers=JAMBA_LAYERS, lengths=JAMBA_PROMPTS,
                max_tokens=JAMBA_MAX_TOKENS) -> dict:
    """Phase 16 (see the module docstring): K2/K3/K4 at the attention
    layer's shape (T the longest prompt, in whole tiles of 128), then
    Jamba-1.5-Large's first ``layers`` layers at published width through
    the dense slot engine: (a) STAR at the reference's capacity, (b)
    dropless ``star=None``, (c) the paged engine's refusal; the longest
    prompt's prefill split by block."""
    on_card = torch.device(dev).type == "cuda"
    published = cfg.n_layers
    cfg = dataclasses.replace(cfg, n_layers=layers,
                              pattern=cfg.pattern[:layers])
    tiles = check_attention_kernels_at(dev, bh=cfg.n_heads,
                                       t=-(-max(lengths) // 128) * 128,
                                       seed=61)
    held_before = torch.cuda.memory_allocated() if on_card else 0
    params, info = init_params(cfg, gen, dev)
    emit("jamba_init", dtype=str(cfg.dtype), layers=layers,
         reduced=f"n_layers {layers} of {published}: layers 0-"
                 f"{layers - 1} of the published order",
         blocks=[f"{b.kind}+{b.ffn}" for b in cfg.pattern],
         param_gb=sum(t.numel() * t.element_size()
                      for t in tree_leaves(params)) / 1e9,
         allocated_gb_before_init=held_before / 1e9, **info)
    prompts = make_prompts(cfg, lengths, SEED + 16)
    exact_cfg = dropless(cfg)
    warm_prefill(params, cfg, lengths[0])
    warm_prefill(params, exact_cfg, lengths[0])
    warm_dense(params, cfg, dev, gen)
    warm_dense(params, exact_cfg, dev, gen)

    with record_routes() as log:
        done, star = serve_dense(cfg, params, prompts, max_tokens,
                                 device=dev, generator=gen)
    star.update(drop_summary(log, moe_layers(cfg), 4))
    star.update(check_first_tokens(params, cfg, prompts, done, None))
    emit("jamba_served", attention="star",
         capacity_factor=cfg.moe.capacity_factor, **star)
    require_dense_launches(star, "Jamba-1.5-Large served")
    free_cache(dev)

    with record_routes() as log:
        done, exact_run = serve_dense(exact_cfg, params, prompts, max_tokens,
                                      device=dev, generator=gen)
    routes = served_routes(log, prompts, done, exact_cfg)
    exact_run.update(drop_summary(log, moe_layers(cfg), 4))
    require_dense_launches(exact_run, "Jamba-1.5-Large served, dropless")
    require_dropless(exact_run, "Jamba-1.5-Large served, dropless")
    exact_run.update(check_exact(params, exact_cfg, prompts, done,
                                 routes=routes))
    emit("jamba_served", attention="dense",
         capacity_factor=exact_cfg.moe.capacity_factor, **exact_run)
    require_k4(exact_run, "Jamba-1.5-Large exactness")
    free_cache(dev)

    try:
        LLM.from_config(cfg, backend="paged", params=params, device=dev,
                        generator=gen)
        refused = None
    except ValueError as exc:
        refused = str(exc)
    emit("jamba_paged_refused", error=refused)
    if refused is None or "attention-only" not in refused:
        raise SystemExit(f"the paged engine did not refuse Jamba's "
                         f"pattern: {refused}")

    split = {key: profiled_prefill(params, c, max(lengths), on_card)
             for key, c in (("star", cfg),
                            ("dense", dataclasses.replace(cfg, star=None)))}
    emit("jamba_prefill_split", **split)
    del params
    free_cache(dev)
    return {"tiles": tiles, "star": star, "exact": exact_run,
            "split": split}


def timed_slstm_prefill(params, cfg, t: int, on_card: bool) -> dict:
    """One ``t``-token ``lm.prefill`` on the host clock, and the host time
    its sLSTM time loops (``xlstm._slstm_scan``) take, each measured
    through the device's end."""
    real = xlstm._slstm_scan
    spent = [0.0]

    def timed(*args, **kw):
        sync(params["embed"].device)
        t0 = time.perf_counter()
        out = real(*args, **kw)
        sync(params["embed"].device)
        spent[0] += time.perf_counter() - t0
        return out
    toks = torch.as_tensor(make_prompts(cfg, (t,), SEED + 19)[0][None],
                           device=params["embed"].device)
    xlstm._slstm_scan = timed
    try:
        with torch.inference_mode():
            t0 = time.perf_counter()
            lm.prefill(params, cfg, {"tokens": toks})
            sync(params["embed"].device)
            wall = time.perf_counter() - t0
    finally:
        xlstm._slstm_scan = real
    return {"tokens": t, "prefill_s": wall, "slstm_scan_s": spent[0],
            "slstm_scan_share": spent[0] / wall}


@torch.inference_mode()
def check_rounding_spread(params, cfg, params32, cfg32, prompts, done) -> dict:
    """bf16 served tokens of a model that amplifies rounding past phase 4's
    ties, held against the fp32 forward (the most exact evaluation of the
    same weights): each served token must lie below the fp32 forward's top
    by no more than twice the request's spread, the largest difference
    between the bf16 and the fp32 forwards' logits over its rows (a bf16
    evaluation as far from fp32 as the bf16 forward may move both the top
    and the served token that far), in bf16 steps of the fp32 top. Also
    counted: the tokens that are the bf16 forward's and the fp32
    forward's argmax."""
    dev = params["embed"].device
    out = {"tokens_checked": 0, "exact_bf16_forward": 0,
           "exact_fp32_forward": 0, "spread_steps": [],
           "served_gap_fp32_steps_max": []}
    for rid, prompt in enumerate(prompts):
        toks = np.asarray(done[rid], np.int64)
        seq = torch.as_tensor(np.concatenate([prompt.astype(np.int64),
                                              toks[:-1]])[None], device=dev)
        rows = slice(len(prompt) - 1, len(prompt) - 1 + len(toks))
        served = torch.as_tensor(toks, device=dev)
        lo, hi = (lm.forward(p, c, {"tokens": seq})[0, rows][
            :, :cfg.vocab].float() for p, c in ((params, cfg),
                                                (params32, cfg32)))
        exact_lo, _ = token_gaps(lo, served)
        exact_hi, gap = token_gaps(hi, served)
        spread = float(((lo - hi).abs().max(-1).values
                        / bf16_step(hi.max(-1).values)).max())
        out["tokens_checked"] += len(toks)
        out["exact_bf16_forward"] += int(exact_lo.sum())
        out["exact_fp32_forward"] += int(exact_hi.sum())
        out["spread_steps"].append(spread)
        out["served_gap_fp32_steps_max"].append(float(gap.max()))
        if float(gap.max()) > 2 * spread:
            raise SystemExit(f"request {rid}: a bf16 served token lies "
                             f"{float(gap.max())} steps below the fp32 "
                             f"forward's top, past twice the bf16 forward's "
                             f"spread ({spread})")
    return out


def check_xlstm(cfg, dev, gen, *, lengths=XLSTM_PROMPTS,
                max_tokens=XLSTM_MAX_TOKENS) -> dict:
    """Phase 17: xLSTM-125M at full width and depth through the dense slot
    engine, no kernel of the port launching. In bf16, the config's dtype:
    the served numbers, the sLSTM loop's share of a prefill and each
    token against the fp32 forward within the bf16 forward's own spread
    (``check_rounding_spread``). With random weights this model amplifies
    rounding: on an H100 the bf16 and fp32 forwards' logits differ by up
    to 52 bf16 steps on a row, and two bf16 forwards whose SSD chunks
    differ by up to 47, so phase 4's 1-2 step ties are out of reach of
    any bf16 order of sums. Phase 4's rule holds the same requests served
    in fp32 against the fp32 forward (the plain cache-free form: chunked
    mLSTM, sLSTM loop, no kernel)."""
    on_card = torch.device(dev).type == "cuda"
    params, info = init_params(cfg, gen, dev)
    emit("xlstm_init", dtype=str(cfg.dtype), layers=cfg.n_layers,
         blocks=[b.kind for b in cfg.pattern], **info)
    prompts = make_prompts(cfg, lengths, SEED + 17)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = tree_map(lambda t: t.float(), params)
    out = {}
    for key, c, p in (("bf16", cfg, params), ("fp32", cfg32, params32)):
        warm_prefill(p, c, lengths[0])
        warm_dense(p, c, dev, gen)
        done, run = serve_dense(c, p, prompts, max_tokens, device=dev,
                                generator=gen)
        require_dense_launches(run, f"xLSTM-125M served, {key}")
        if any(run["launches"].values()):
            raise SystemExit(f"xLSTM-125M launched a kernel: "
                             f"{run['launches']}")
        if key == "bf16":
            run.update(check_rounding_spread(params, cfg, params32, cfg32,
                                             prompts, done))
        else:
            run.update(check_exact(p, c, prompts, done))
            require_k4(run, "xLSTM-125M exactness")
        emit("xlstm_served", dtype=key, **run)
        out[key] = run
    timing = timed_slstm_prefill(params, cfg, max(lengths), on_card)
    split = profiled_prefill(params, cfg, min(lengths), on_card)
    emit("xlstm_prefill", **timing, profiled=split)
    del params, params32
    free_cache(dev)
    return {"served": out, "prefill": timing, "split": split}


# -- main ---------------------------------------------------------------------

# -- phases 18-19: the frontend-stub families ---------------------------------

def seeded_normal(shape, seed: int, dev, dtype) -> torch.Tensor:
    """Stand-in frontend output (patch or frame embeddings): normal draws
    from a seeded CPU generator, on the device in the model's dtype."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=gen).to(dev, dtype)


def require_counts(summary: dict, tag: str) -> None:
    """Every kernel's (and form's) launches equal their expectation."""
    got = {name: summary["launches"][name]
           for name in summary["expected_launches"]}
    if got != summary["expected_launches"]:
        raise SystemExit(f"{tag}: launches {got}; expected "
                         f"{summary['expected_launches']}")


def cache_rows(t: int, steps: int) -> int:
    """Dense-cache rows for a t-token prefill and ``steps`` decode steps,
    in whole pages of 16 (STAR's decode splits the rows into segments)."""
    return -(-(t + steps) // 16) * 16


def launched() -> dict:
    return {**kernels.LAUNCHES, **kernels.FORM_LAUNCHES}


def greedy_steps(params, cfg, logits, cache, steps: int, dev,
                 tag: str) -> tuple:
    """``steps`` greedy ``lm.decode_step``s on a dense cache from a
    prefill's last logits [B, V]: (the tokens [B, steps + 1], the
    prefill's first among them; each step's seconds). Every logit must be
    finite."""
    tok = logits[:, :cfg.vocab].argmax(dim=-1, keepdim=True).int()
    out, secs = [tok], []
    for _ in range(steps):
        t0 = time.perf_counter()
        logits, cache = lm.decode_step(params, cfg, tok, cache)
        sync(dev)
        secs.append(time.perf_counter() - t0)
        if not bool(torch.isfinite(logits).all()):
            raise SystemExit(f"{tag}: non-finite decode logits")
        tok = logits[:, :cfg.vocab].argmax(dim=-1, keepdim=True).int()
        out.append(tok)
    return torch.cat(out, dim=1), secs


@torch.inference_mode()
def check_embeds_prefill(params, cfg, dev, t: int, steps: int) -> dict:
    """Phase 18's frontend input: one ``lm.prefill`` over [1, t, H] patch
    embeddings (STAR on: K2 and K3 once per layer), its first token held
    against the STAR forward over the same embeddings by phase 8's rule,
    then ``steps`` ``decode_step``s on the dense cache, every logit
    finite."""
    batch = {"embeds": seeded_normal((1, t, cfg.d_model), SEED + 30, dev,
                                     cfg.dtype)}
    kernels.reset_launches()
    t0 = time.perf_counter()
    logits, cache = lm.prefill(params, cfg, batch,
                               cache_len=cache_rows(t, steps))
    sync(dev)
    prefill_s = time.perf_counter() - t0
    counts = launched()
    layers = attn_layers(cfg)
    out = {"tokens": t, "prefill_s": prefill_s, "launches": counts,
           "expected_launches": {"dlzs_block": layers, "sufa": layers,
                                 "flash": 0, "paged_decode": 0}}
    tokens, decode_s = greedy_steps(params, cfg, logits, cache, steps, dev,
                                    "InternVL2 embeds decode")
    fwd = lm.forward(params, cfg, batch)[0, -1, :cfg.vocab].float()
    exact, tie = first_token_rule(fwd, int(tokens[0, 0]),
                                  "InternVL2 embeds prefill")
    out.update(first_token_exact=exact, first_token_bf16_tie=tie,
               tokens_out=tokens[0].tolist(), decode_steps=steps,
               decode_ms=[1e3 * s for s in decode_s])
    return out


def serve_plain_k1(cfg, params, prompts, max_tokens, dev, gen,
                   k1_done) -> dict:
    """Phase 18b's ``star=None`` paged run again with K1's wrapper
    swapped for its plain version (``paged_decode_reference`` on the
    card; K1 launches 0), every token held by the same rule as K1's run:
    the tokens of the two runs side by side, and the first index where
    each request's part, tell a K1 fault from rounding."""
    real = kpaged.paged_decode_attention
    kpaged.paged_decode_attention = kpaged.paged_decode_reference
    try:
        run, out, logits = serve_exact(cfg, params, prompts, max_tokens,
                                       dev, gen, True)
    finally:
        kpaged.paged_decode_attention = real
    if out["k1_launches"] != 0:
        raise SystemExit(f"InternVL2 plain K1: K1 launched "
                         f"{out['k1_launches']} times")
    out["expected_launches"] = 0
    out.update(check_exact(params, cfg, prompts, run["done"],
                           served_logits=logits))
    require_k4(out, "InternVL2 plain K1 exactness")
    out["tokens_equal_k1"] = sum(a == b for x, y in zip(run["done"], k1_done)
                                 for a, b in zip(x, y))
    out["first_difference"] = [
        next((i for i, (a, b) in enumerate(zip(x, y)) if a != b), None)
        for x, y in zip(run["done"], k1_done)]
    return out


def check_internvl2(cfg, dev, gen, *, lengths=INTERNVL_PROMPTS,
                    max_tokens=INTERNVL_MAX_TOKENS,
                    embeds_len=INTERNVL_EMBEDS,
                    steps=INTERNVL_DECODE_STEPS) -> dict:
    """Phase 18: InternVL2-26B at full width and depth (48 layers, 48
    heads over 8 KV heads: K1 at R = 6, K2/K3/K4 at BH 48). (a) STAR on,
    whole-prompt prefill through the paged engine, each first token
    against a cache-free STAR forward; (b) ``star=None``, every token by
    phase 4's rule against a K4 forward, through the paged engine (the
    served logits a second witness), again with K1's plain version
    (``serve_plain_k1``), and through the dense slot engine (phase 4's
    rule alone); (c) one prefill from patch embeddings and a few decode
    steps (``check_embeds_prefill``)."""
    params, info = init_params(cfg, gen, dev)
    emit("internvl2_init", dtype=str(cfg.dtype), **info)
    prompts = make_prompts(cfg, lengths, SEED + 31)
    star, exact_run, paged_done = serve_star_and_exact(
        cfg, params, prompts, max_tokens, dev, gen, "internvl2",
        witness=True)
    plain_k1 = serve_plain_k1(cfg, params, prompts, max_tokens, dev, gen,
                              paged_done)
    emit("internvl2_plain_k1", **plain_k1)
    done, dense_run = serve_dense(dataclasses.replace(cfg, star=None),
                                  params, prompts, max_tokens, device=dev,
                                  generator=gen)
    free_cache(dev)
    require_dense_launches(dense_run, "InternVL2-26B dense engine")
    dense_run.update(check_exact(params, cfg, prompts, done))
    dense_run["tokens_equal_paged"] = sum(
        a == b for x, y in zip(done, paged_done) for a, b in zip(x, y))
    emit("internvl2_dense_engine", **dense_run)
    require_k4(dense_run, "InternVL2-26B dense engine exactness")
    frontend = check_embeds_prefill(params, cfg, dev, embeds_len, steps)
    emit("internvl2_embeds", **frontend)
    require_counts(frontend, "InternVL2-26B embeds prefill")
    del params
    free_cache(dev)
    return {"star": star, "exact": exact_run, "plain_k1": plain_k1,
            "dense": dense_run, "embeds": frontend}


def seamless_batch(cfg, dev, frames: int, prompt_len: int, seed: int):
    """SEAMLESS_BATCH utterances: stand-in speech-frame embeddings [B,
    frames, H] for the encoder and decoder prompts [B, prompt_len]."""
    toks = np.stack(make_prompts(cfg, (prompt_len,) * SEAMLESS_BATCH, seed))
    return {"enc_embeds": seeded_normal(
                (SEAMLESS_BATCH, frames, cfg.d_model), seed, dev, cfg.dtype),
            "tokens": torch.as_tensor(toks, device=dev)}


@torch.inference_mode()
def run_encdec(params, cfg, batches, steps: int, dev) -> dict:
    """Each batch through ``lm.prefill`` (the encoder, then the decoder
    with its per-layer cross K/V cached), then ``steps`` greedy
    ``decode_step``s on the dense cache; launches counted from 0. With
    STAR on, K2 and K3 run once per self-attention layer of the prefill
    (non-causal in the encoder) and K4 once per cross-attention layer
    (non-causal); with ``star=None`` K4 runs at every layer of both. No
    kernel runs in decode (the dense cache's plain softmax)."""
    kernels.reset_launches()
    prefill_s, decode_s, done = [], [], []
    for batch in batches:
        t = batch["tokens"].shape[1]
        t0 = time.perf_counter()
        logits, cache = lm.prefill(params, cfg, batch,
                                   cache_len=cache_rows(t, steps))
        sync(dev)
        prefill_s.append(time.perf_counter() - t0)
        tokens, secs = greedy_steps(params, cfg, logits, cache, steps, dev,
                                    cfg.name)
        decode_s.extend(secs)
        done.extend(tokens.tolist())
    n, enc, dec, cross = (len(batches), cfg.enc_layers, attn_layers(cfg),
                          cross_layers(cfg))
    if cfg.star is not None:
        want = {"dlzs_block": n * (enc + dec), "sufa": n * (enc + dec),
                "flash": n * cross, "dlzs_block/noncausal": n * enc,
                "sufa/noncausal": n * enc, "flash/noncausal": n * cross}
    else:
        want = {"dlzs_block": 0, "sufa": 0, "flash": n * (enc + dec + cross),
                "flash/noncausal": n * (enc + cross)}
    want["paged_decode"] = 0
    return {"done": done, "prefill_calls": n,
            "frames": [int(b["enc_embeds"].shape[1]) for b in batches],
            "prompt_tokens": [int(b["tokens"].shape[1]) for b in batches],
            "batch": SEAMLESS_BATCH, "prefill_s": prefill_s,
            "decode_steps": len(decode_s),
            "decode_ms_per_step": 1e3 * float(np.mean(decode_s)),
            "decode_ms_first_step": 1e3 * decode_s[0],
            "tokens": sum(len(d) for d in done), "launches": launched(),
            "expected_launches": want}


@torch.inference_mode()
def check_encdec_first_tokens(params, cfg, batches, done) -> dict:
    """Each utterance's first token against the STAR forward over the
    same frames and prompt (phase 8's rule). The forwards' launches are
    reported beside the served run's."""
    kernels.reset_launches()
    n_exact = n_tie = 0
    for i, batch in enumerate(batches):
        logits = lm.forward(params, cfg, batch)[:, -1, :cfg.vocab].float()
        for row in range(SEAMLESS_BATCH):
            e, t = first_token_rule(logits[row],
                                    done[i * SEAMLESS_BATCH + row][0],
                                    f"{cfg.name} batch {i} row {row}")
            n_exact, n_tie = n_exact + e, n_tie + t
    return {"first_tokens_checked": n_exact + n_tie, "exact": n_exact,
            "bf16_ties": n_tie, "forward_launches": launched()}


def check_seamless(cfg, dev, gen, *, frames=SEAMLESS_FRAMES,
                   prompt_len=SEAMLESS_PROMPT,
                   steps=SEAMLESS_DECODE_STEPS) -> dict:
    """Phase 19: SeamlessM4T-large-v2 at full width and depth (24 encoder
    and 24 decoder layers, 16 heads of 64) through ``lm.prefill`` and
    ``lm.decode_step``, the paths the reference runs it on (no engine of
    either package serves it). (a) STAR on: launch counts (the encoder's
    K2/K3 non-causal, the cross-attention's K4 non-causal with T != S)
    and each first token against a STAR forward; (b) ``star=None``: every
    token held by phase 4's rule against a K4 forward over the same
    frames."""
    params, info = init_params(cfg, gen, dev)
    emit("seamless_init", dtype=str(cfg.dtype), **info)
    batches = [seamless_batch(cfg, dev, f, prompt_len, SEED + 40 + i)
               for i, f in enumerate(frames)]
    dense = dataclasses.replace(cfg, star=None)
    for c in (cfg, dense):     # each shape's first-call library set-up
        run_encdec(params, c, batches, 1, dev)
    star = run_encdec(params, cfg, batches, steps, dev)
    require_counts(star, "SeamlessM4T STAR")
    star.update(check_encdec_first_tokens(params, cfg, batches,
                                          star["done"]))
    emit("seamless_served", attention="star", **info,
         **{k: v for k, v in star.items() if k != "done"})
    exact = run_encdec(params, dense, batches, steps, dev)
    require_counts(exact, "SeamlessM4T star=None")
    prompts = [row.cpu().numpy() for b in batches for row in b["tokens"]]
    extra = [{"enc_embeds": b["enc_embeds"][row:row + 1]} for b in batches
             for row in range(SEAMLESS_BATCH)]
    exact.update(check_exact(params, cfg, prompts, exact["done"],
                             extra=extra))
    emit("seamless_served", attention="dense",
         **{k: v for k, v in exact.items() if k != "done"})
    require_k4(exact, "SeamlessM4T exactness")
    del params
    free_cache(dev)
    return {"star": star, "exact": exact}


# -- phase 20: training -------------------------------------------------------

def plain_attention_lowp(q, k, v, *, causal: bool, scale: float):
    """The FlashAttention repository's yardstick for a low-precision
    gradient (its tests' reference attention without upcasting): scores,
    softmax and P·V in the inputs' dtype, so autograd through it rounds
    every product as a bf16 implementation does. q [BH,T,d], k/v [BH,S,d]
    with the causal mask at offset S - T."""
    t, s = q.shape[1], k.shape[1]
    sc = torch.einsum("btd,bsd->bts", q, k) * scale
    if causal:
        sc = sc.masked_fill(~kref._causal_mask(t, s, q.device), kref.NEG_INF)
    p = torch.softmax(sc, dim=-1).to(v.dtype)
    return torch.einsum("bts,bsd->btd", p, v)


def grads_of(fn, q, k, v, do) -> tuple:
    """(dq, dk, dv) of ``fn(q, k, v)`` for the output gradient ``do``."""
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    with torch.enable_grad():
        return torch.autograd.grad(fn(q, k, v), (q, k, v), do)


def gradient_rule(tag: str, got: dict, want: dict, lowp: dict,
                  **case) -> dict:
    """The FlashAttention repository's rule for a low-precision gradient:
    each of ``got``'s tensors lies no further from the fp32 ``want`` than
    twice the bf16 plain form ``lowp`` does (plus 1e-5)."""
    out = dict(case)
    for name in got:
        w = want[name].float()
        err = float((got[name].float() - w).abs().max())
        ref = float((lowp[name].float() - w).abs().max())
        out[f"max_abs_err_{name}"] = err
        out[f"bf16_plain_err_{name}"] = ref
        if not err <= 2 * ref + 1e-5:
            emit(tag, ok=False, **out)
            raise SystemExit(f"{tag}: {name} lies {err} from the fp32 "
                             f"gradient, past 2 x the bf16 plain form's "
                             f"{ref} + 1e-5: {out}")
    out["max_abs_err"] = max(out[f"max_abs_err_{n}"] for n in got)
    out["tolerance"] = "2 x bf16 plain error + 1e-5"
    return out


def check_flash_bwd(dev, flush, *, bh, t, causal, seed, timed, d=128,
                    s=None) -> dict:
    """Phase 20a: K4's backward against its plain version. K4's forward
    with ``return_lse`` must give the O bits it gives without, and its lse
    the plain log-sum-exp at 1e-4; dQ, dK and dV must meet
    ``gradient_rule`` against the fp32 plain gradient (``flash_bwd_ref``
    on fp32 copies of the inputs, the fp32 forward's O and lse). Timed:
    the kernel, its plain version on the same bf16 inputs, its bound (10·d
    flops per visible pair, or its bytes) and SDPA's backward alone
    (``torch.autograd.grad`` on a retained graph)."""
    s = s or t
    q, k, v = prefill_inputs(bh, t, d, seed, dev)
    if s != t:
        _, k, v = prefill_inputs(bh, s, d, seed + 1, dev)
    gen = torch.Generator(device="cpu").manual_seed(seed + 2)
    do = torch.randn((bh, t, d), generator=gen).to(dev, torch.bfloat16)
    scale = 1.0 / math.sqrt(d)
    case = dict(kernel="flash_bwd", BH=bh, T=t, S=s, d=d, causal=causal)
    o, lse = kflash.flash_attention(q, k, v, causal=causal, return_lse=True)
    if not torch.equal(o.view(torch.int16), kflash.flash_attention(
            q, k, v, causal=causal).view(torch.int16)):
        raise SystemExit(f"flash_bwd {case}: K4's O changes when lse is "
                         f"asked for")
    f32 = [x.float() for x in (q, k, v)]
    o32, lse32 = kref.flash_ref(*f32, causal=causal, scale=scale,
                                return_lse=True)
    lse_case = held("flash_lse", lse, lse32, 1e-4, **case)
    names = ("dq", "dk", "dv")
    got = dict(zip(names, kflash.flash_bwd(q, k, v, o, lse, do,
                                           causal=causal, scale=scale)))
    want = dict(zip(names, kref.flash_bwd_ref(*f32, o32, lse32, do.float(),
                                              causal=causal, scale=scale)))
    lowp = dict(zip(names, grads_of(functools.partial(
        plain_attention_lowp, causal=causal, scale=scale), q, k, v, do)))
    again = kflash.flash_bwd(q, k, v, o, lse, do, causal=causal, scale=scale)
    out = gradient_rule("flash_bwd", got, want, lowp, **case)
    out["two_calls_bit_equal"] = all(
        torch.equal(a.view(torch.int16), got[n].view(torch.int16))
        for a, n in zip(again, names))
    if not out["two_calls_bit_equal"]:
        raise SystemExit(f"flash_bwd {case}: two calls differ")
    out["lse_max_abs_err"] = lse_case["max_abs_err"]
    del want, lowp, again, o32, lse32, f32
    if timed:
        def kernel():
            kflash.flash_bwd(q, k, v, o, lse, do, causal=causal, scale=scale)

        def plain():
            kref.flash_bwd_ref(q, k, v, o, lse, do, causal=causal,
                               scale=scale)
        library = None
        if not causal or s == t:   # SDPA's causal mask is top-left
            leaves = [x.detach()[None].requires_grad_() for x in (q, k, v)]
            with torch.enable_grad():
                sdpa_out = SDPA(*leaves, is_causal=causal)

            def library():
                torch.autograd.grad(sdpa_out, leaves, do[None],
                                    retain_graph=True)
        pairs = bh * visible_pairs(t, s, causal)
        add_times(out, kernel, plain, library, flush,
                  bytes_=nbytes(q, k, v, o, do, q, k, v) + nbytes(lse),
                  flops=10 * d * pairs)
        out.update(flash_bwd_split(kernel, flush))
        # achieved rate by the 10·d flops per visible pair the gradient
        # needs (and the kernel executes: no product is computed twice)
        out["tflop_s_10d"] = 10 * d * pairs / out["ms"] / 1e9
    emit("flash_bwd", ok=True, **out)
    return out


def flash_bwd_split(fn, flush, iters: int = 10,
                    parts=BWD_KERNELS) -> dict:
    """Device ms per launch of each kernel a backward launches (K4's:
    the prep pass, and the key-tile pass that computes dK, dV and dQ;
    K3's with ``parts=SUFA_BWD_KERNELS``: prep, dK/dV, dQ), from
    ``torch.profiler`` over ``iters`` calls of ``fn``, each after an L2
    flush (averaged over the launches the trace holds); their sum beside
    them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    _, _, top = profiling.device_kernels(prof, set())
    out = {}
    for part in parts:
        mine = [k for k in top if f"{part}_kernel" in k["name"]]
        out[f"{part}_launches_traced"] = sum(k["calls"] for k in mine)
        out[f"{part}_ms"] = sum(k["device_ms"] for k in mine) / max(
            1, out[f"{part}_launches_traced"])
    out["split_sum_ms"] = sum(out[f"{part}_ms"] for part in parts)
    return out


def check_flash_bwd_shapes(dev, ptxas=()) -> dict:
    """Phase 20a's shapes: OLMo-1B's attention at BH 16 and at its
    training shape (seq 2048 x batch 8: BH 128), T = S = 2048, d 128,
    causal; a ragged T = S = 1000; non-causal T 256 over S 2048 at d 64.
    Returns {case: numbers}; the training shape and the non-causal one
    are timed. ``ptxas``: the backward's register and spill lines from
    the build log, emitted beside them."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    out = {"bh16": check_flash_bwd(dev, flush, bh=16, t=2048, causal=True,
                                   seed=2001, timed=False),
           "train": check_flash_bwd(dev, flush, bh=TRAIN_BATCH * 16,
                                    t=TRAIN_SEQ, causal=True, seed=2002,
                                    timed=True),
           "ragged": check_flash_bwd(dev, flush, bh=16, t=1000, causal=True,
                                     seed=2003, timed=False),
           "noncausal": check_flash_bwd(dev, flush, bh=16, t=256, s=2048,
                                        causal=False, seed=2004, timed=True,
                                        d=64)}
    emit("flash_bwd_build", ptxas=[f"{fn} {line}" for fn, line in ptxas])
    del flush
    free_cache(dev)
    return out


def free_disk_gb(path: pathlib.Path) -> float:
    return shutil.disk_usage(path).free / 1e9


def train_run(cfg, params, opt_state, *, steps: int, seq: int, batch: int,
              ckpt_dir, dev, ckpt_every: int = 10 ** 9,
              fail_at: int | None = None, lr: float = TRAIN_LR) -> dict:
    """``train_loop`` over ``launch.steps.make_train_step`` on
    ``SyntheticLM`` batches (``data.PrefetchLoader`` on ``dev``): every
    step's loss, grad norm and host seconds (each step ends in a sync),
    the final save's seconds and the final params and optimizer state.
    With ``ckpt_dir`` None the same steps run from the same loader
    without ``train_loop``: no checkpoint, no final save."""
    step = launch_steps.make_train_step(cfg, lr=lr, warmup=TRAIN_WARMUP,
                                        total_steps=steps)
    rec = {"loss": [], "grad_norm": [], "step_s": []}

    def step_fn(p, o, b):
        t0 = time.perf_counter()
        p, o, m = step(p, o, b)
        rec["loss"].append(float(m["loss"]))
        rec["grad_norm"].append(float(m["grad_norm"]))
        sync(dev)
        rec["step_s"].append(time.perf_counter() - t0)
        rec["end"] = time.perf_counter()
        return p, o, m
    ds = SyntheticLM(vocab=cfg.vocab, seq=seq, global_batch=batch)
    if ckpt_dir is None:
        loader = PrefetchLoader(ds, dev)
        for i, b in loader:
            if i >= steps:
                break
            params, opt_state, _ = step_fn(params, opt_state, b)
        loader.stop()
        rec.pop("end")
        rec.update(save_s=None, params=params, opt=opt_state)
        return rec
    loop = TrainLoopCfg(total_steps=steps, ckpt_every=ckpt_every,
                        ckpt_dir=str(ckpt_dir), log_every=steps + 1,
                        fail_at_step=fail_at)
    params, opt_state, _ = train_loop(step_fn, params, opt_state,
                                      PrefetchLoader(ds, dev), loop,
                                      log_fn=lambda *_: None)
    rec["save_s"] = time.perf_counter() - rec.pop("end")
    rec.update(params=params, opt=opt_state)
    return rec


def star_trained(cfg) -> bool:
    return cfg.star_train and cfg.star is not None


def profile_train_step(cfg, params, opt_state, batch, on_card: bool) -> dict:
    """One more training step under ``torch.profiler``: its device time
    split into K4's forward and backward (with ``star_train``: K2, K3's
    forward, K3's backward and the selection glue, a profiler range
    around ``ops.select_tiles``), the GEMMs, the optimizer update (a
    profiler range around ``adamw_update``) and the rest (norms,
    activations, softmax-CE, casts, the embedding), and the device's busy
    share of the step's wall time."""
    if not on_card:
        return {}
    from torch.profiler import ProfilerActivity, profile
    step = launch_steps.make_train_step(cfg, lr=TRAIN_LR,
                                        warmup=TRAIN_WARMUP,
                                        total_steps=TRAIN_STEPS)
    ranges = {(adamw, "adamw_update"): "optimizer"}
    if star_trained(cfg):
        ranges[ops, "select_tiles"] = "selection"
    with profiling.ranged(ranges), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, opt_state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    names = set(ranges.values())
    device_ms, busy_ms, top = profiling.device_kernels(prof, names)

    def by_name(*keys):
        return sum(k["device_ms"] for k in top
                   if any(p in k["name"].lower() for p in keys))
    if star_trained(cfg):
        parts = {"k2_ms": by_name("dlzs_wgmma_kernel", "dlzs_mma_kernel"),
                 "k3_forward_ms": by_name("sufa_wgmma_kernel",
                                          "sufa_mma_kernel"),
                 "k3_backward_ms": by_name(*SUFA_BWD_KERNELS),
                 "selection_ms": profiling.range_device_ms(
                     prof, "selection", names)}
    else:
        parts = {"k4_forward_ms": by_name("flash_kernel"),
                 "k4_backward_ms": by_name(*BWD_KERNELS)}
    parts.update(gemm_ms=by_name(*profiling.GEMM_NAMES),
                 optimizer_ms=profiling.range_device_ms(prof, "optimizer",
                                                        names))
    parts["other_ms"] = device_ms - sum(parts.values())
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": busy_ms / wall_ms, **parts,
            **{k[:-3] + "_share": v / device_ms for k, v in parts.items()},
            "top_kernels": top[:12]}


def check_training(cfg, dev, gen, *, steps=TRAIN_STEPS, seq=TRAIN_SEQ,
                   batch=TRAIN_BATCH, lr=TRAIN_LR, save: bool = True) -> dict:
    """Phase 20b: ``cfg`` trained from ``lm.init`` (seed 0) with the
    reference's optimizer (``make_optimizer``: AdamW, bf16 moments) and
    ``remat="full"``, ``steps`` steps of ``batch`` x ``seq`` tokens
    through ``train_loop``, one final save into a directory under
    ``build/`` that the phase removes (with ``save`` False, as phase 21b
    runs it, the same steps without ``train_loop``: 20b covers the
    checkpointer).
    The loss must fall by more than 0.1 from the first step to the last
    (``tests/test_train_serve.py::test_training_reduces_loss``), every
    loss and grad norm be finite, and the kernels launch exactly: K4
    twice per attention layer and step (the forward and its recompute
    under remat), its backward once, K1-K3 never; with ``star_train``
    (phase 21b) K2 and K3 twice and K3's backward once instead, K1 and K4
    never."""
    on_card = torch.device(dev).type == "cuda"
    params, info = init_params(cfg, gen, dev)
    _, opt_init, _ = launch_steps.make_optimizer(cfg, lr)
    opt_state = opt_init(params)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "star_train": star_trained(cfg),
           "seq": seq, "batch": batch, "steps": steps, "lr": lr,
           "warmup": TRAIN_WARMUP, "remat": cfg.remat, **info,
           "free_disk_gb_before": free_disk_gb(BUILD_DIR)}
    emit("training_setup", **out)
    ckpt_dir = pathlib.Path(tempfile.mkdtemp(prefix="train_ckpt_",
                                             dir=BUILD_DIR)) if save else None
    try:
        kernels.reset_launches()
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        run = train_run(cfg, params, opt_state, steps=steps, seq=seq,
                        batch=batch, ckpt_dir=ckpt_dir, dev=dev, lr=lr)
        got = launched()
        out["save_bytes"] = sum(
            f.stat().st_size for f in ckpt_dir.rglob("*")
            if f.is_file()) if save else None
        data = SyntheticLM(vocab=cfg.vocab, seq=seq,
                           global_batch=batch).batch(steps)
        out["profiled_step"] = profile_train_step(
            cfg, run["params"], run["opt"],
            {k: torch.from_numpy(v).to(dev) for k, v in data.items()},
            on_card)
    finally:
        if save:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    layers = attn_layers(cfg)
    want = {name: 0 for name in kernels.LAUNCHES}
    if on_card and star_trained(cfg):
        want.update(dlzs_block=steps * layers * 2, sufa=steps * layers * 2,
                    sufa_bwd=steps * layers)
    elif on_card:
        want.update(flash=steps * layers * 2, flash_bwd=steps * layers)
    tokens = seq * batch
    step_s = float(np.median(run["step_s"][1:] or run["step_s"]))
    out.update(loss=run["loss"], grad_norm=run["grad_norm"],
               step_ms=[1e3 * x for x in run["step_s"]],
               step_ms_median=1e3 * step_s, tokens_per_step=tokens,
               tokens_per_s=tokens / step_s,
               mfu=6 * info["params"] * tokens / step_s / BF16_FLOP_S,
               mfu_formula="6 * params * tokens per step / median step s "
                           "(steps 1..) / 989e12",
               peak_memory_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                               if on_card else None),
               save_s=run["save_s"], launches=got,
               expected_launches=want)
    emit("training", **out)
    bad = [x for x in run["loss"] + run["grad_norm"] if not math.isfinite(x)]
    if bad:
        raise SystemExit(f"training: non-finite loss or grad norm {bad}")
    if not run["loss"][-1] < run["loss"][0] - 0.1:
        raise SystemExit(f"training: the loss did not fall by 0.1: "
                         f"{run['loss']}")
    if {k: got[k] for k in want} != want:
        raise SystemExit(f"training: launches {got}; expected {want}")
    del run, params, opt_state
    free_cache(dev)
    return out


def restart_child(workdir: str, dev="cuda", cfg=None, seq: int = TRAIN_SEQ,
                  batch: int = RESTART_BATCH) -> dict:
    """Phase 20c, in a process of its own (``CUBLAS_WORKSPACE_CONFIG`` set
    before cuBLAS starts, deterministic algorithms on, so an op without a
    deterministic form raises): OLMo-1B at full width cut to
    RESTART_LAYERS layers, 10 steps uninterrupted (a checkpoint every 5),
    then the same run failed at step 7 and resumed from a fresh init. The
    final params and optimizer state must be the same bits. Phase 21c
    passes OLMo-1B with ``star_train`` as ``cfg``."""
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(dev)
    cfg = dataclasses.replace(cfg or olmo_1b.config(),
                              n_layers=RESTART_LAYERS)
    gen = torch.Generator(device=dev)
    root = pathlib.Path(workdir)

    def fresh():
        params, _ = init_params(cfg, gen, dev)
        _, opt_init, _ = launch_steps.make_optimizer(cfg, TRAIN_LR)
        return params, opt_init(params)
    kw = dict(steps=10, seq=seq, batch=batch, dev=dev, ckpt_every=5)
    t0 = time.perf_counter()
    whole = train_run(cfg, *fresh(), ckpt_dir=root / "a", **kw)
    try:
        train_run(cfg, *fresh(), ckpt_dir=root / "b", fail_at=7, **kw)
        raise SystemExit("restart: the injected failure did not fire")
    except RuntimeError as err:
        if "injected failure" not in str(err):
            raise
    resumed = train_run(cfg, *fresh(), ckpt_dir=root / "b", **kw)
    pairs = [(p, a, b) for (p, a), (_, b) in zip(
        sorted_items({"params": whole["params"], "opt": whole["opt"]}),
        sorted_items({"params": resumed["params"], "opt": resumed["opt"]}))]
    differ = [_key_path(p) for p, a, b in pairs
              if a.shape != b.shape or not torch.equal(_bits(a), _bits(b))]
    return {"reduced": {"n_layers": f"{RESTART_LAYERS} of 16"},
            "star_train": star_trained(cfg),
            "seq": seq, "batch": batch, "steps": 10,
            "fail_at": 7, "resumed_from": 5, "leaves": len(pairs),
            "leaves_differ": differ, "bit_equal": not differ,
            "loss_uninterrupted": whole["loss"],
            "loss_resumed": resumed["loss"],
            "seconds": time.perf_counter() - t0}


def _key_path(path: tuple) -> str:
    return "/".join(path)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes (a 0-d tensor as itself), for bit equality."""
    return t.view(torch.uint8) if t.dim() else t


def restart_children(workdir: str) -> list:
    """Phases 20c and 21c in one deterministic process (one start-up):
    ``restart_child`` for OLMo-1B, then with ``star_train``."""
    cfg = olmo_1b.config()
    return [restart_child(str(pathlib.Path(workdir) / name), cfg=c)
            for name, c in (("dense", cfg), ("star", dataclasses.replace(
                cfg, star_train=True)))]


def check_restart(dev) -> tuple:
    """Phases 20c and 21c: ``restart_children`` in a child process; its
    result line is the last of its output. Returns (dense, star)."""
    workdir = tempfile.mkdtemp(prefix="restart_", dir=BUILD_DIR)
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    try:
        proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                               "--restart-child", workdir], env=env,
                              capture_output=True, text=True, timeout=600)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if proc.returncode != 0:
        raise SystemExit(f"restart child failed ({proc.returncode}):\n"
                         f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    runs = json.loads(proc.stdout.strip().splitlines()[-1])
    for tag, out in zip(("training_restart", "star_training_restart"), runs):
        emit(tag, **out)
        if not out["bit_equal"]:
            raise SystemExit(f"{tag}: resumed run differs from the "
                             f"uninterrupted one at {out['leaves_differ']}")
    return tuple(runs)


def plain_flash_train(q, k, v, *, causal, scale):
    """``ops.flash`` as its plain version under autograd (20d's plain
    path): ``flash_ref``'s fp32 softmax, differentiated by torch."""
    return kref.flash_ref(q, k, v, causal=causal, scale=scale)


def plain_sufa_train(q, k, v, idx, valid, *, scale, **kw):
    """``ops.sufa_attention`` as its plain version under autograd (21d's
    plain path): ``sufa_reference``'s fp32 softmax over the gathered
    tiles, differentiated by torch."""
    return ksufa.sufa_reference(q, k, v, idx, valid, scale=scale, **kw)


def model_grads(params, cfg, batch, plain: bool, tiles=None) -> tuple:
    """(loss, metrics, grads) of one ``lm.loss_fn`` step, with the kernels
    and their backwards, or ``plain`` with the plain versions in their
    place (``plain_flash_train``, K2's ``dlzs_block_ref``,
    ``plain_sufa_train``). With ``tiles`` (a list; STAR in training) a
    kernel run appends each STAR call's (tile ids, validity) to it, and a
    plain run takes them from it in call order, so both compute attention
    over the tiles the kernels' selection kept."""
    names = ("flash", "dlzs_block_scores", "select_tiles", "sufa_attention")
    real = {name: getattr(ops, name) for name in names}
    replay = iter(tiles or ())
    if plain:
        ops.flash = plain_flash_train
        ops.dlzs_block_scores = kref.dlzs_block_ref
        ops.sufa_attention = plain_sufa_train
        if tiles is not None:
            ops.select_tiles = lambda raw, keep, **kw: next(replay)
    elif tiles is not None:
        def record(raw, keep, **kw):
            tiles.append(real["select_tiles"](raw, keep, **kw))
            return tiles[-1]
        ops.select_tiles = record
    try:
        (loss, metrics), grads = launch_steps.value_and_grad(params, cfg,
                                                             batch)
    finally:
        for name, fn in real.items():
            setattr(ops, name, fn)
    if plain and tiles is not None and next(replay, None) is not None:
        raise SystemExit("training step: the plain run made fewer STAR "
                         "calls than the kernel run")
    return loss, metrics, grads


def check_model_step(cfg, dev, gen, *, layers=RESTART_LAYERS, seq=TRAIN_SEQ,
                     batch=2) -> dict:
    """Phase 20d: one training step's loss and gradients at ``layers``
    layers, ``batch`` x ``seq`` tokens, with K4 and its backward, held
    against the same step on the plain path in fp32 (``flash_ref`` under
    autograd, fp32 weights and activations): the loss and the global grad
    norm within 2e-2 relative, and every leaf no further from the fp32
    gradient than twice the bf16 plain path's (plus 1e-5), phase 20a's
    rule at model level. With ``star_train`` (phase 21d) the plain runs,
    fp32 and bf16, take the kernel run's tile ids call by call (an fp32
    selection rounds its estimates apart and may keep other tiles, a
    different function), and the recompute's selection under remat must
    be the forward's."""
    star = star_trained(cfg)
    tiles = [] if star else None
    tag = "star_training_step" if star else "training_step"
    reduced = {"n_layers": f"{layers} of {cfg.n_layers}"}
    cfg = dataclasses.replace(cfg, n_layers=layers)
    params, _ = init_params(cfg, gen, dev)
    data = SyntheticLM(vocab=cfg.vocab, seq=seq, global_batch=batch).batch(0)
    bt = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = tree_map(lambda t: t.float(), params)
    loss, _, g = model_grads(params, cfg, bt, plain=False, tiles=tiles)
    loss32, _, g32 = model_grads(p32, cfg32, bt, plain=True, tiles=tiles)
    loss_lp, _, g_lp = model_grads(params, cfg, bt, plain=True, tiles=tiles)
    gn, gn32 = float(adamw.global_norm(g)), float(adamw.global_norm(g32))
    out = {"reduced": reduced, "seq": seq, "batch": batch,
           "loss": float(loss),
           "loss_fp32_plain": float(loss32),
           "loss_bf16_plain": float(loss_lp), "grad_norm": gn,
           "grad_norm_fp32_plain": gn32}
    out["loss_rel_err"] = abs(out["loss"] - out["loss_fp32_plain"]) / abs(
        out["loss_fp32_plain"])
    out["grad_norm_rel_err"] = abs(gn - gn32) / gn32
    if star:
        # under remat each layer's recompute follows the forward, the
        # layers in reverse order
        out["star_calls"] = len(tiles)
        n = attn_layers(cfg)
        out["recompute_selection_equal"] = len(tiles) == 2 * n and all(
            torch.equal(a, b) for i in range(n)
            for a, b in zip(tiles[i], tiles[2 * n - 1 - i]))
        if not out["recompute_selection_equal"]:
            emit(tag, ok=False, **out)
            raise SystemExit(f"{tag}: the recompute kept other tiles than "
                             f"the forward")
    names = [_key_path(p) for p, _ in sorted_items(g)]
    leaves = gradient_rule(
        tag,
        dict(zip(names, (x for _, x in sorted_items(g)))),
        dict(zip(names, (x for _, x in sorted_items(g32)))),
        dict(zip(names, (x for _, x in sorted_items(g_lp)))))
    out["leaves"] = {n: [leaves[f"max_abs_err_{n}"],
                         leaves[f"bf16_plain_err_{n}"]] for n in names}
    out["leaves_format"] = "[kernel path max error, bf16 plain path's]"
    emit(tag, **out)
    if out["loss_rel_err"] > 2e-2 or out["grad_norm_rel_err"] > 2e-2:
        raise SystemExit(f"training step: loss or grad norm off the fp32 "
                         f"plain step by more than 2e-2: {out}")
    del params, p32, g, g32, g_lp
    free_cache(dev)
    return out


# -- phase 21: STAR in training -----------------------------------------------

def selection_mask(idx, valid, *, t: int, s: int, block: int,
                   causal: bool) -> torch.Tensor:
    """The dense [BH, T, S] boolean mask of the keys K3 sees under a
    selection: each valid selected tile, causal at offset S - T."""
    bh, n_qt, keep = idx.shape
    n_kt = s // block
    rows = torch.empty((bh, s, 1), device=idx.device)
    _, _, mask = ksufa.gather_selected(rows, rows, idx, valid, t=t,
                                       block_q=block, block_kv=block,
                                       causal=causal)
    dense = torch.zeros((bh, n_qt, n_kt, block, block), dtype=torch.bool,
                        device=idx.device)
    heads = torch.arange(bh, device=idx.device)[:, None]
    qts = torch.arange(n_qt, device=idx.device)[None, :]
    for j in range(keep):
        dense[heads, qts, idx[..., j]] |= mask[:, :, j]
    return dense.permute(0, 1, 3, 2, 4).reshape(bh, t, s)


def plain_masked_lowp(q, k, v, *, dense, scale: float):
    """``plain_attention_lowp`` under a dense boolean mask: scores,
    softmax and P·V in the inputs' dtype; a row that sees no key gives 0,
    as K3 gives it."""
    sc = torch.einsum("btd,bsd->bts", q, k) * scale
    p = torch.softmax(sc.masked_fill(~dense, kref.NEG_INF), dim=-1)
    return torch.einsum("bts,bsd->btd", p.masked_fill(~dense, 0.0).to(
        v.dtype), v)


def lse_held(tag: str, got, want, **case) -> dict:
    """``held`` at 1e-4 for a log-sum-exp: +inf (a row that sees no key)
    in the same places, the finite rows within the tolerance."""
    if not torch.equal(torch.isinf(got), torch.isinf(want)):
        emit(tag, ok=False, **case)
        raise SystemExit(f"{tag}: lse is +inf at other rows than the plain "
                         f"version's: {case}")
    fin = torch.isfinite(want)
    return held(tag, got[fin], want[fin], 1e-4,
                inf_rows=int((~fin).sum()), **case)


def check_sufa_bwd(dev, flush, *, bh, t, s, d, causal, seed, timed,
                   edges=False, block=128) -> dict:
    """Phase 21a: K3's lse and backward on the glue's selection (K2, then
    ``ops.select_tiles`` keeping as many tiles as olmo_1b's STAR config).
    K3's forward, strict and fast, must give the same O bits with and
    without lse, and its lse the plain version's at 1e-4; the backward
    of each forward's o and lse (one function) must meet
    ``gradient_rule`` against the fp32 plain gradient (``sufa_bwd_ref``
    on fp32 copies, the fp32 strict forward's o and lse), the bf16
    yardstick being autograd through the bf16 plain form under the
    selection's dense mask, and two calls must give the same bits. With
    ``edges``: invalid slots, a key tile of head 0 that no q-tile chose
    (dK = dV = 0 exactly) and a q-tile of head 1 with no valid slot
    (dQ = 0 exactly, its lse +inf). Timed: the kernel, its plain
    version, its bound (10·d flops per visible selected pair, or its
    bytes) and SDPA's backward under the dense mask (``autograd.grad`` on
    a retained graph), with the split of its three kernels."""
    q, k, v = prefill_inputs(bh, t, d, seed, dev)
    if s != t:
        _, k, v = prefill_inputs(bh, s, d, seed + 1, dev)
    gen = torch.Generator(device="cpu").manual_seed(seed + 2)
    do = torch.randn((bh, t, d), generator=gen).to(dev, torch.bfloat16)
    scale = d ** -0.5
    star = olmo_1b.config().star
    keep = dataclasses.replace(star, block_q=block,
                               block_kv=block).keep_blocks(s)
    raw = kdlzs.dlzs_block_scores(q, k, causal=causal, scale=1.0,
                                  block_q=block, block_kv=block)
    idx, valid = ops.select_tiles(raw, keep, scale=scale, radius=star.radius,
                                  dtype=q.dtype)
    case = dict(kernel="sufa_bwd", BH=bh, T=t, S=s, d=d, block=block,
                keep=keep, causal=causal, edges=edges)
    if edges:
        unchosen = int(idx[0, -1, 0])
        valid[0] &= idx[0] != unchosen
        valid[:, :, -1] = False
        valid[1, -1] = False
        case.update(unchosen_key_tile=unchosen, empty_q_tile=t // block - 1)
    case["valid_slots"] = int(valid.sum())
    kw = dict(block_q=block, block_kv=block, causal=causal, scale=scale)
    fwd, lse_err = {}, {}
    for strict in (True, False):
        o, lse = ksufa.sufa_attention(q, k, v, idx, valid, strict=strict,
                                      return_lse=True, **kw)
        if not torch.equal(o.view(torch.int16), ksufa.sufa_attention(
                q, k, v, idx, valid, strict=strict, **kw).view(torch.int16)):
            raise SystemExit(f"sufa {case}: K3's O changes when lse is "
                             f"asked for (strict={strict})")
        _, plain_lse = ksufa.sufa_reference(q, k, v, idx, valid,
                                            strict=strict, return_lse=True,
                                            **kw)
        lse_err[strict] = lse_held("sufa_lse", lse, plain_lse, strict=strict,
                                   **case)["max_abs_err"]
        fwd[strict] = (o, lse)
    f32 = [x.float() for x in (q, k, v)]
    o32, lse32 = ksufa.sufa_reference(*f32, idx, valid, strict=True,
                                      return_lse=True, **kw)
    names = ("dq", "dk", "dv")
    want = dict(zip(names, ksufa.sufa_bwd_ref(*f32, idx, valid, o32, lse32,
                                             do.float(), **kw)))
    del f32, o32, lse32
    dense = selection_mask(idx, valid, t=t, s=s, block=block, causal=causal)
    lowp = dict(zip(names, grads_of(functools.partial(
        plain_masked_lowp, dense=dense, scale=scale), q, k, v, do)))
    modes = {}
    for strict in (True, False):
        o, lse = fwd[strict]
        got = dict(zip(names, ksufa.sufa_bwd(q, k, v, idx, valid, o, lse,
                                             do, **kw)))
        again = ksufa.sufa_bwd(q, k, v, idx, valid, o, lse, do, **kw)
        res = gradient_rule("sufa_bwd", got, want, lowp, strict=strict,
                            **case)
        res["two_calls_bit_equal"] = all(
            torch.equal(a.view(torch.int16), got[n].view(torch.int16))
            for a, n in zip(again, names))
        if not res["two_calls_bit_equal"]:
            raise SystemExit(f"sufa_bwd {case}: two calls differ")
        if edges:
            tile = slice(unchosen * block, (unchosen + 1) * block)
            res["unchosen_dk_dv_zero"] = not (got["dk"][0, tile].any()
                                              or got["dv"][0, tile].any())
            res["empty_q_tile_dq_zero"] = not got["dq"][1, t - block:].any()
            if not (res["unchosen_dk_dv_zero"]
                    and res["empty_q_tile_dq_zero"]):
                raise SystemExit(f"sufa_bwd {case}: an unchosen key tile or "
                                 f"an empty q-tile has a gradient: {res}")
        res["lse_max_abs_err"] = lse_err[strict]
        modes[strict] = res
    out = dict(modes[True])
    out["fast"] = {key: modes[False][key] for key in (
        "max_abs_err", "lse_max_abs_err", "two_calls_bit_equal")}
    del want, lowp
    if timed:
        o, lse = fwd[True]

        def kernel():
            ksufa.sufa_bwd(q, k, v, idx, valid, o, lse, do, **kw)

        def plain():
            ksufa.sufa_bwd_ref(q, k, v, idx, valid, o, lse, do, **kw)
        leaves = [x.detach()[None].requires_grad_() for x in (q, k, v)]
        with torch.enable_grad():
            sdpa_out = SDPA(*leaves, attn_mask=dense[None], scale=scale)

        def library():
            torch.autograd.grad(sdpa_out, leaves, do[None],
                                retain_graph=True)
        pairs = selected_pairs(idx, valid, t=t, s=s, block=block,
                               causal=causal)
        add_times(out, kernel, plain, library, flush,
                  bytes_=nbytes(q, k, v, o, do, q, k, v, lse, idx, valid),
                  flops=10 * d * pairs)
        out.update(flash_bwd_split(kernel, flush, parts=SUFA_BWD_KERNELS))
        out["selected_pairs"] = pairs
        out["dense_causal_pairs"] = bh * visible_pairs(t, s, causal)
        out["tflop_s_10d"] = 10 * d * pairs / out["ms"] / 1e9
        del sdpa_out, leaves
    emit("sufa_bwd", ok=True, **out)
    return out


def check_sufa_bwd_shapes(dev, ptxas=()) -> dict:
    """Phase 21a's shapes: OLMo-1B's training shape (BH 128, T = S =
    2048, d 128, causal, keep 4 of 16), timed; SeamlessM4T's encoder
    (BH 16, T = S = 2048, d 64, not causal), timed; T 256 over S 2048,
    causal; the edges at BH 16, T = S = 1024. ``ptxas``: the backward's
    register and spill lines from the build log, emitted beside them."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    out = {"train": check_sufa_bwd(dev, flush, bh=TRAIN_BATCH * 16,
                                   t=TRAIN_SEQ, s=TRAIN_SEQ, d=128,
                                   causal=True, seed=2101, timed=True),
           "encoder": check_sufa_bwd(dev, flush, bh=16, t=2048, s=2048, d=64,
                                     causal=False, seed=2102, timed=True),
           "t256": check_sufa_bwd(dev, flush, bh=16, t=256, s=2048, d=128,
                                  causal=True, seed=2103, timed=False),
           "edges": check_sufa_bwd(dev, flush, bh=16, t=1024, s=1024, d=128,
                                   causal=True, seed=2104, timed=False,
                                   edges=True)}
    emit("sufa_bwd_build", ptxas=[f"{fn} {line}" for fn, line in ptxas])
    del flush
    free_cache(dev)
    return out


def demangle(mangled: str) -> str:
    """``name<args>`` of a kernel template instantiation whose arguments
    are ints and bools (``...19paged_scores_kernelILi64ELi1ELb1EEEv...`` ->
    ``paged_scores_kernel<64,1,1>``); the mangled name if it is not one."""
    pattern = r"(?=(\d{1,2})([A-Za-z_]\w*?kernel)I((?:L[ib]\d+E)+)E)"
    for m in re.finditer(pattern, mangled):
        if int(m[1]) == len(m[2]):
            args = re.findall(r"(\d+)E", m[3])
            return f"{m[2]}<{','.join(args)}>"
    return mangled


def ptxas_report(log: str) -> list:
    """(kernel instantiation, line) for each register, spill, wgmma and
    warning line of ``nvcc -Xptxas=-v``'s log; the instantiation is read
    from the mangled name ptxas reports before them, as ``name<args>``."""
    out, fn = [], ""
    for line in log.splitlines():
        if "Function properties for" in line:
            fn = demangle(line.split("for", 1)[1].strip())
        elif any(w in line for w in ("registers", "spill", "wgmma",
                                     "warning")):
            out.append((fn, line.strip()))
    return out


def print_device_line() -> None:
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--restart-child"]:  # phases 20c and 21c
        print(json.dumps(restart_children(sys.argv[2])), flush=True)
        return 0
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
        for fn, line in ptxas_report(info["log"]):
            print(f"ptxas[{name}] {fn} {line}", flush=True)

    # 2. K1 against its plain version: main-path shapes, phase 8's decode
    # shape (W = 130), and a GQA case
    k1 = check_paged_kernel(dev, "main_path", b=4, g=16, r=1, d=128,
                            page=16, w=64, p=1024,
                            kv_len=(1024, 1000, 777, 500), seed=1,
                            timed=True)
    k1_w130 = check_paged_kernel(dev, "whole_prompt_w130", b=3, g=16, r=1,
                                 d=128, page=16, w=130, p=512,
                                 kv_len=(1040, 2064, 2064), seed=3,
                                 timed=True)
    gqa = check_paged_kernel(dev, "gqa_r4_padded", b=3, g=4, r=4, d=128,
                             page=16, w=16, p=256, kv_len=(256, 201, 37),
                             seed=2, timed=False)
    # the int8 form at the main path's shape, about half the slots marked
    k1_int8 = check_paged_int8(dev, "main_path_int8", b=4, g=16, r=1,
                               d=128, page=16, w=64, p=1024,
                               kv_len=(1024, 1000, 777, 500), seed=1,
                               timed=True)
    # the wide GQA groups at their served decode shapes, both forms:
    # ChatGLM3-6B (G 2, R 16; W covers phase 10's longest sequence) and
    # StarCoder2-15B (G 4, R 12; phase 12's one 2048-token prompt)
    glm_w = -(-(max(GLM_PROMPTS) + GLM_MAX_TOKENS) // 16) + 1
    glm_kv = tuple(n + GLM_MAX_TOKENS for n in GLM_PROMPTS)
    sc2_w = -(-(CUT_PROMPT + GLM_MAX_TOKENS) // 16) + 1
    sc2_kv = (CUT_PROMPT + GLM_MAX_TOKENS,)
    k1_r16 = {form: check(dev, f"chatglm3_decode_{form}", b=3, g=2, r=16,
                          d=128, page=16, w=glm_w, p=512, kv_len=glm_kv,
                          seed=4, timed=True)
              for form, check in (("fp", check_paged_kernel),
                                  ("int8", check_paged_int8))}
    k1_r12 = {form: check(dev, f"starcoder2_decode_{form}", b=1, g=4, r=12,
                          d=128, page=16, w=sc2_w, p=256, kv_len=sc2_kv,
                          seed=5, timed=True)
              for form, check in (("fp", check_paged_kernel),
                                  ("int8", check_paged_int8))}
    # Grok-1's group (G 8, R 6) at phase 15's decode shape
    grok_w = -(-(GROK_PROMPT + GROK_MAX_TOKENS) // 16) + 1
    k1_r6 = {form: check(dev, f"grok_decode_{form}", b=1, g=8, r=6, d=128,
                         page=16, w=grok_w, p=256,
                         kv_len=(GROK_PROMPT + GROK_MAX_TOKENS,), seed=9,
                         timed=True)
             for form, check in (("fp", check_paged_kernel),
                                 ("int8", check_paged_int8))}
    # InternVL2-26B's group (G 8, R 6) at phase 18's decode shape: its
    # three requests batched, W covering the longest sequence
    ivl_w = -(-(max(INTERNVL_PROMPTS) + INTERNVL_MAX_TOKENS) // 16) + 1
    k1_ivl = check_paged_kernel(
        dev, "internvl2_decode", b=3, g=8, r=6, d=128, page=16, w=ivl_w,
        p=512, kv_len=tuple(n + INTERNVL_MAX_TOKENS for n in INTERNVL_PROMPTS),
        seed=10, timed=True)
    # K1's (m, l, o) form: phase 13's decode shape (4 shards, the three
    # requests at their last tick and an idle slot; W covers each shard's
    # pages) and ChatGLM3-6B's group, both lanes, timed; a shard with no
    # row, untimed
    sp_kv = tuple(n + SPATIAL_MAX_TOKENS for n in SPATIAL_PROMPTS) + (1,)
    sp_w = -(-(-(-max(sp_kv) // 16)) // SPATIAL_SHARDS)
    k1_stats = {lane: check_paged_stats(
        dev, f"spatial_decode_{lane}", SPATIAL_SHARDS, b=4, g=16, r=1,
        d=128, page=16, w=sp_w, p=SPATIAL_PAGES_LOCAL, kv_len=sp_kv, seed=6,
        timed=True, quant=lane == "int8") for lane in ("fp", "int8")}
    glm_sw = -(-glm_w // SPATIAL_SHARDS)
    k1_stats_r16 = {lane: check_paged_stats(
        dev, f"spatial_chatglm3_{lane}", SPATIAL_SHARDS, b=3, g=2, r=16,
        d=128, page=16, w=glm_sw, p=glm_sw + 8, kv_len=glm_kv, seed=7,
        timed=True, quant=lane == "int8") for lane in ("fp", "int8")}
    for lane in ("fp", "int8"):
        check_paged_stats(dev, f"spatial_empty_shard_{lane}",
                          SPATIAL_SHARDS, b=4, g=16, r=1, d=128, page=16,
                          w=sp_w, p=SPATIAL_PAGES_LOCAL,
                          kv_len=(1040, 33, 500, 1), seed=8, timed=False,
                          quant=lane == "int8", empty_shard=2)

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

    # 4. exactness against a dense forward on the same weights (K4)
    exact = check_exact(params, cfg, prompts, run["done"])
    emit("exactness", **exact)
    if exact["k4_launches"] != exact["expected_k4_launches"]:
        raise SystemExit(f"K4 launched {exact['k4_launches']} times over "
                         f"{exact['forwards']} oracle forwards; expected "
                         f"forwards x layers = "
                         f"{exact['expected_k4_launches']}")

    # 5. bounded sparse decode: hot width 8 pages under 32+ live pages
    del llm, backend
    free_cache(dev)
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
    del sparse_llm
    free_cache(dev)

    # 6. K2, K3, K4 against their plain versions at the served shapes
    tiles = check_prefill_kernels(dev)

    # 7. the fused STAR prefill against the plain scanq, layer 0
    check_fused_star(params, cfg, SEED + 3)

    # 8. the whole-prompt prefill served: K2 -> SADS -> K3 in lm.prefill
    whole_prompts = make_prompts(cfg, WHOLE_PROMPTS, SEED + 4)
    whole_llm, whole_run, whole = serve_whole_prompt(
        cfg, params, whole_prompts, WHOLE_MAX_TOKENS, device=dev,
        generator=gen)
    whole.update(check_first_tokens(
        params, cfg, whole_prompts, whole_run["done"],
        whole_llm.engine.backend.pcfg.bucket_pow2))
    emit("whole_prompt_prefill", **whole)
    require_launches(whole, "whole-prompt prefill")
    require_prefill_launches(whole, "whole-prompt prefill")
    del whole_llm
    free_cache(dev)

    # 9. disaggregated serving: prefill and decode instances over one
    # params tree, the int8 cold tier, a hop lost to an injected fault
    disagg = check_disagg(cfg, params, whole_prompts, DISAGG_MAX_TOKENS,
                          device=dev, generator=gen, n_pages=512,
                          hot_pages=130, hot_width=DISAGG_HOT_WIDTH)
    emit("disaggregated_serving", **disagg)
    pair = disagg["pair"]
    require_disagg_launches(pair, "disaggregated serving")
    require_disagg_launches(disagg["tier_read"], "int8 tier read")
    del params
    free_cache(dev)

    # 10-11. ChatGLM3-6B at full width: the paged engine (STAR, then the
    # exact-parity setting) and the dense slot engine
    glm = check_chatglm(chatglm3_6b.config(), dev, gen)

    # 12. StarCoder2-15B (K1 at R = 12) and star_paper (LLaMA-7B's shape;
    # also with K3's element mask), published widths, depth cut
    cut = {"starcoder2_15b": check_cut_config(
               "starcoder2_15b", starcoder2_15b.config(), dev, gen),
           "star_paper": check_cut_config(
               "star_paper", star_paper.config(), dev, gen,
               elementwise_too=True)}

    # 13. the spatial engine: OLMo-1B (phase 3's seed, star=None) over 4
    # shards on the card; K1's (m, l, o) form on every decode layer
    spatial = check_spatial(olmo_1b.config(), dev, gen)

    # 14. OLMoE-1B-7B at full width and depth: the MoE FFN in every layer
    olmoe = check_olmoe(olmoe_1b_7b.config(), dev, gen)

    # 15. Grok-1 at its published width, 2 of 64 layers: K1 at R = 6
    grok = check_grok(grok_1_314b.config(), dev, gen)

    # 16. Jamba-1.5-Large at its published width, 5 of 72 layers: Mamba,
    # MoE and one attention layer (K2/K3/K4 at BH 64) on the dense engine
    jamba = check_jamba(jamba_1_5_large_398b.config(), dev, gen)

    # 17. xLSTM-125M at full width and depth: no kernel of the port
    check_xlstm(xlstm_125m.config(), dev, gen)

    # 18. InternVL2-26B at full width and depth through the paged engine
    # (K1 at R = 6, K2/K3/K4 at BH 48), and its patch-embeddings input
    ivl = check_internvl2(internvl2_26b.config(), dev, gen)

    # 19. SeamlessM4T-large-v2 at full width and depth: the non-causal
    # encoder (K2/K3) and the cross-attention (K4, T != S)
    seamless = check_seamless(seamless_m4t_large_v2.config(), dev, gen)

    # 20. training: K4's backward against its plain version (20a),
    # OLMo-1B trained at full width and depth (20b), restart exactness in
    # a deterministic child process (20c; 21c's in the same child), one
    # model step against the plain path (20d)
    bwd = check_flash_bwd_shapes(dev,
                                 ptxas_report(built["flash_bwd"]["log"]))
    train = check_training(olmo_1b.config(), dev, gen)
    restart, star_restart = check_restart(dev)
    check_model_step(olmo_1b.config(), dev, gen)

    # 21. STAR in training: K3's lse and backward against their plain
    # versions (21a), OLMo-1B with star_train trained at full width and
    # depth (21b), one model step against the plain path on the same
    # tiles (21d); restart exactness (21c) ran in 20c's child
    sbwd = check_sufa_bwd_shapes(dev, ptxas_report(built["sufa_bwd"]["log"]))
    star_cfg = dataclasses.replace(olmo_1b.config(), star_train=True)
    star_train = check_training(star_cfg, dev, gen, save=False)
    check_model_step(star_cfg, dev, gen)

    def line(name, source, replaces, launches, case, **extra):
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": case["max_abs_err"],
                "tolerance": case["tolerance"], "ms": case["ms"],
                "ms_repeat": case["ms_repeat"],
                "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
                "bound_by": case["bound_by"],
                "library_ms": case["library_ms"], **extra}

    def int8_keys(case):
        return {f"{key}_int8": case[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms",
            "slots_marked", "slots_valid")}

    def int8_keys_stats(case):
        return {f"{key}_int8": case[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")}

    def forms(name):
        return {f: whole["form_launches"][f"{name}/{f}"]
                for f in ("wgmma", "mma_sync")}

    def bh64(name):
        """Phase 16's BH-64 (Jamba's attention layer, T 4096) numbers."""
        case = jamba["tiles"][name]
        return {f"{key}_bh64": case[key] for key in (
            "max_abs_err", "ms", "ms_repeat", "plain_ms", "bound_ms",
            "bound_by", "library_ms")}

    def served(run, name):
        return run["launches"][name]

    print(json.dumps({"kernels": [
        line("paged_decode", "paged_decode.cu",
             "src/repro/kernels/paged.py:67", main["k1_launches"], k1,
             launches_olmoe_main_path=olmoe["main"]["k1_launches"],
             max_abs_err_gqa=gqa["max_abs_err"], n_split=k1["n_split"],
             ms_w130=k1_w130["ms"], bound_ms_w130=k1_w130["bound_ms"],
             plain_ms_w130=k1_w130["plain_ms"],
             library_ms_w130=k1_w130["library_ms"],
             n_split_w130=k1_w130["n_split"]),
        # the int8 form: the reference serves this read path through its
        # XLA gather (src/repro/kvcache/paged_attention.py:68); it runs on
        # the decode ticks that read the tier, those of the tier-read run
        line("paged_decode/int8", "paged_decode.cu",
             "src/repro/kernels/paged.py:67",
             disagg["tier_read"]["k1_int8_launches"], k1_int8,
             slots_marked=k1_int8["slots_marked"],
             slots_valid=k1_int8["slots_valid"],
             max_abs_err_fp_form=k1_int8["max_abs_err_fp_form"],
             max_abs_err_other_page_scale=k1_int8[
                 "max_abs_err_other_page_scale"],
             launches_from="phase 9's tier-read run, both instances",
             launches_fp_form_tier_read=disagg["tier_read"][
                 "k1_fp_launches"],
             launches_pair=pair["k1_int8_launches"],
             slots_read_tier_read=disagg["tier_read"][
                 "int8_slots_read_prefill_side"]
             + disagg["tier_read"]["int8_slots_read_decode_side"]),
        line("dlzs_block", "dlzs_block.cu", "src/repro/kernels/dlzs.py:65",
             whole["dlzs_block_launches"], tiles["dlzs_block"],
             launches_olmoe=olmoe["star"]["dlzs_block_launches"],
             form=tiles["dlzs_block"]["form"],
             launches_by_form=forms("dlzs_block"),
             ms_noncausal=tiles["dlzs_block_noncausal"]["ms"],
             bound_ms_noncausal=tiles["dlzs_block_noncausal"]["bound_ms"],
             launches_jamba=jamba["star"]["dlzs_block_launches"],
             **bh64("dlzs_block")),
        line("sufa", "sufa.cu", "src/repro/kernels/sufa.py:72",
             whole["sufa_launches"], tiles["sufa"],
             launches_olmoe=olmoe["star"]["sufa_launches"],
             form=tiles["sufa"]["form"], launches_by_form=forms("sufa"),
             ms_fast_path=tiles["sufa_fast"]["ms"],
             ms_fast_path_repeat=tiles["sufa_fast"]["ms_repeat"],
             plain_ms_fast_path=tiles["sufa_fast"]["plain_ms"],
             library_ms_fast_path=tiles["sufa_fast"]["library_ms"],
             gathered_bytes_not_moved=tiles["sufa"][
                 "gathered_bytes_not_moved"],
             launches_jamba=jamba["star"]["sufa_launches"],
             max_abs_err_fast_path_bh64=jamba["tiles"]["sufa_fast"][
                 "max_abs_err"],
             launches_star_training=star_train["launches"]["sufa"],
             lse_max_abs_err={
                 "strict": sbwd["train"]["lse_max_abs_err"],
                 "fast": sbwd["train"]["fast"]["lse_max_abs_err"],
                 "tolerance": 1e-4}, **bh64("sufa")),
        line("flash", "flash.cu", "src/repro/kernels/flash.py:67",
             exact["k4_launches"], tiles["flash"],
             launches_training=train["launches"]["flash"],
             launches_olmoe_oracle=olmoe["exact"]["k4_launches"],
             launches_jamba=jamba["exact"]["flash_launches"],
             launches_jamba_oracle=jamba["exact"]["k4_launches"],
             **bh64("flash")),
        # K1 at ChatGLM3-6B's group (R = 16): phase 10a's served path;
        # its int8 form timed beside it (no served path reads the tier
        # at this group)
        line("paged_decode/r16", "paged_decode.cu",
             "src/repro/kernels/paged.py:67", glm["star"]["k1_launches"],
             k1_r16["fp"], launches_from="phase 10a, ChatGLM3-6B served",
             **int8_keys(k1_r16["int8"])),
        line("paged_decode/r12", "paged_decode.cu",
             "src/repro/kernels/paged.py:67",
             cut["starcoder2_15b"]["star"]["k1_launches"], k1_r12["fp"],
             launches_from="phase 12, StarCoder2-15B served",
             **int8_keys(k1_r12["int8"])),
        # K1 at Grok-1's group (R = 6): phase 15's served path
        line("paged_decode/r6", "paged_decode.cu",
             "src/repro/kernels/paged.py:67", grok["star"]["k1_launches"],
             k1_r6["fp"], launches_from="phase 15, Grok-1 served",
             launches_dropless=grok["exact"]["k1_launches"],
             n_split=k1_r6["fp"]["n_split"], **int8_keys(k1_r6["int8"])),
        # K3's element mask: phase 12's star_paper run with
        # STARConfig(elementwise=True); its wgmma form at the served tiles,
        # its mma.sync form (tiles of 64) timed beside it
        line("sufa/elementwise", "sufa.cu", "src/repro/kernels/sufa.py:72",
             cut["star_paper"]["star_elementwise"]["form_launches"][
                 "sufa/elementwise"], tiles["sufa_elementwise"],
             launches_from="phase 12, star_paper served with "
                           "elementwise=True",
             form=tiles["sufa_elementwise"]["form"],
             launches_wgmma=cut["star_paper"]["star_elementwise"][
                 "form_launches"]["sufa/wgmma"],
             ms_fast_path=tiles["sufa_elementwise_fast"]["ms"],
             library_ms_fast_path=tiles["sufa_elementwise_fast"][
                 "library_ms"],
             mma_sync={key: tiles["sufa_elementwise_mma_sync"][key]
                       for key in ("block", "max_abs_err", "ms",
                                   "plain_ms", "bound_ms", "library_ms")},
             sphere_dropped_share=tiles["sufa_elementwise"][
                 "sphere_dropped_share"],
             mask_elements_differ_default_gemm_share=tiles[
                 "sufa_elementwise"][
                 "mask_elements_differ_default_gemm_share"]),
        # K1's unnormalised (m, l, o) form: phase 13's served path, every
        # shard in one launch sequence (the reference computes this state
        # in XLA, src/repro/kvcache/paged_attention.py:136; its TPU kernel
        # keeps it in _paged_kernel and divides in the wrapper)
        line("paged_decode_stats", "paged_decode.cu",
             "src/repro/kernels/paged.py:67",
             spatial["served"]["k1_stats_launches"], k1_stats["fp"],
             launches_from="phase 13, OLMo-1B over 4 shards",
             launches_bounded_run=spatial["bounded"]["k1_stats_launches"],
             library=k1_stats["fp"]["library"],
             max_abs_err_m=k1_stats["fp"]["max_abs_err_m"],
             max_abs_err_l=k1_stats["fp"]["max_abs_err_l"],
             n_split=k1_stats["fp"]["n_split"],
             **int8_keys_stats(k1_stats["int8"]),
             r16={lane: {key: k1_stats_r16[lane][key] for key in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms",
                 "library_ms")} for lane in ("fp", "int8")}),
        # phase 18: InternVL2-26B's decode group (R = 6, B 3, W 258) and
        # its attention prefill at BH 48 (48 heads; K/V expanded from 8)
        line("paged_decode/r6_internvl2", "paged_decode.cu",
             "src/repro/kernels/paged.py:67", ivl["star"]["k1_launches"],
             k1_ivl, launches_from="phase 18a, InternVL2-26B served",
             launches_dropless=ivl["exact"]["k1_launches"],
             n_split=k1_ivl["n_split"]),
        line("dlzs_block/bh48", "dlzs_block.cu",
             "src/repro/kernels/dlzs.py:65",
             ivl["star"]["dlzs_block_launches"], tiles["bh48"]["dlzs_block"],
             launches_from="phase 18a, InternVL2-26B's whole prompts",
             launches_embeds_prefill=served(ivl["embeds"], "dlzs_block")),
        line("sufa/bh48", "sufa.cu", "src/repro/kernels/sufa.py:72",
             ivl["star"]["sufa_launches"], tiles["bh48"]["sufa"],
             launches_from="phase 18a, InternVL2-26B's whole prompts",
             launches_embeds_prefill=served(ivl["embeds"], "sufa"),
             max_abs_err_fast_path=tiles["bh48"]["sufa_fast"][
                 "max_abs_err"]),
        line("flash/bh48", "flash.cu", "src/repro/kernels/flash.py:67",
             ivl["exact"]["flash_launches"], tiles["bh48"]["flash"],
             launches_from="phase 18b, InternVL2-26B star=None prefills",
             launches_dense_engine=ivl["dense"]["flash_launches"],
             launches_oracle=ivl["exact"]["k4_launches"]),
        # phase 19: SeamlessM4T-large-v2's encoder (K2/K3 non-causal, d 64,
        # 2048 frames) and cross-attention (K4 non-causal, T 256 != S)
        line("dlzs_block/noncausal", "dlzs_block.cu",
             "src/repro/kernels/dlzs.py:65",
             served(seamless["star"], "dlzs_block/noncausal"),
             tiles["dlzs_block_encoder"],
             launches_from="phase 19a, SeamlessM4T's encoder layers"),
        line("sufa/noncausal", "sufa.cu", "src/repro/kernels/sufa.py:72",
             served(seamless["star"], "sufa/noncausal"),
             tiles["sufa_encoder"],
             launches_from="phase 19a, SeamlessM4T's encoder layers",
             **{f"{key}_fast_path": tiles["sufa_encoder_fast"][key]
                for key in ("max_abs_err", "ms", "plain_ms", "library_ms")}),
        line("flash/noncausal", "flash.cu", "src/repro/kernels/flash.py:67",
             served(seamless["star"], "flash/noncausal"),
             tiles["flash_cross_s2048"],
             launches_from="phase 19a, SeamlessM4T's cross-attention",
             launches_star_none=served(seamless["exact"], "flash/noncausal"),
             launches_oracle=seamless["exact"]["k4_launches"],
             **{f"{key}_s1000": tiles["flash_cross_s1000"][key] for key in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms")}),
        # phase 20: K4's backward (training has no TPU kernel: the
        # reference differentiates XLA's dense softmax; this is the
        # gradient of K4's function) at OLMo-1B's training shape
        line("flash_bwd", "flash_bwd.cu", "src/repro/kernels/flash.py:67",
             train["launches"]["flash_bwd"], bwd["train"],
             launches_from="phase 20b, OLMo-1B trained",
             lse_max_abs_err=bwd["train"]["lse_max_abs_err"],
             max_abs_err_by_grad={n: bwd["train"][f"max_abs_err_{n}"]
                                  for n in ("dq", "dk", "dv")},
             bf16_plain_err_by_grad={n: bwd["train"][f"bf16_plain_err_{n}"]
                                     for n in ("dq", "dk", "dv")},
             noncausal_d64={key: bwd["noncausal"][key] for key in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "tflop_s_10d")},
             split_ms={part: bwd["train"][f"{part}_ms"]
                       for part in BWD_KERNELS},
             tflop_s_10d=bwd["train"]["tflop_s_10d"],
             restart_bit_equal=restart["bit_equal"]),
        # phase 21: K3's backward (STAR in training has no TPU kernel: the
        # reference differentiates core.sufa.sufa_gathered through XLA;
        # this is the gradient of K3's function) at OLMo-1B's training
        # shape
        line("sufa_bwd", "sufa_bwd.cu",
             "none: the reference differentiates sufa_gathered through XLA "
             "(src/repro/core/sufa.py:107)",
             star_train["launches"]["sufa_bwd"], sbwd["train"],
             launches_from="phase 21b, OLMo-1B trained with star_train",
             max_abs_err_by_grad={n: sbwd["train"][f"max_abs_err_{n}"]
                                  for n in ("dq", "dk", "dv")},
             bf16_plain_err_by_grad={n: sbwd["train"][f"bf16_plain_err_{n}"]
                                     for n in ("dq", "dk", "dv")},
             max_abs_err_fast_forward=sbwd["train"]["fast"]["max_abs_err"],
             noncausal_d64={key: sbwd["encoder"][key] for key in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "tflop_s_10d")},
             max_abs_err_t256=sbwd["t256"]["max_abs_err"],
             max_abs_err_edges=sbwd["edges"]["max_abs_err"],
             split_ms={part: sbwd["train"][f"{part}_ms"]
                       for part in SUFA_BWD_KERNELS},
             tflop_s_10d=sbwd["train"]["tflop_s_10d"],
             restart_bit_equal=star_restart["bit_equal"]),
    ]}), flush=True)
    print_device_line()
    return 0


if __name__ == "__main__":
    sys.exit(main())
