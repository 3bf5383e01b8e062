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
17. xLSTM-125M at full width, its depth cut to 6 of its 12 layers of
   alternating mLSTM and sLSTM blocks (no attention, no FFN;
   ``XLSTM_SERVE_CUT``), through the dense slot engine,
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
   d 128, causal), a ragged T = S = 1000, non-causal T 256 over S 2048
   at d 64, and causal T = S = 256 at d 64 and BH 96 (phase 22's
   star_paper model: batch 8 x 12 heads): dQ, dK and dV each within
   twice the bf16 plain
   gradient's error against the fp32 one (plus 1e-5), two calls
   bit-equal, K4's lse at 1e-4 and its O bit-equal with and without
   lse; the training shape and both d 64 cases timed beside their
   bounds, the plain version and SDPA's backward, with each of the
   backward's two kernels' device time (prep, and the key-tile pass that
   computes dK, dV and dQ; by ``torch.profiler``), the achieved TFLOP/s
   and ptxas's register and spill lines of ``flash_bwd.cu``; and K4's
   forward at the training shape against its plain version, timed beside
   its bound and SDPA; (b) OLMo-1B
   at full width and depth trained 20 steps of 8 x 2048 ``SyntheticLM``
   tokens through ``launch.steps.make_train_step`` and
   ``runtime.train_loop``
   (AdamW with bf16 moments, ``remat="full"``, lr 6e-4, warmup 5), one
   final save under ``build/`` that the phase removes: the loss falls by
   more than 0.1, every loss and grad norm finite, K4 = steps x 32 and
   its backward steps x 16, K1-K3 never; step ms, tokens/s, MFU by the
   reference's convention (``launch.roofline.model_flops``: 6·N·D with
   N the body parameters, embedding and output head excluded) and, as
   ``mfu_all_params``, by all parameters, peak memory, the save's
   seconds and bytes, and one more step profiled;
   (c) in a child process with deterministic algorithms (``--restart-child
   DIR olmo``), 2 of its 16 layers: a run failed at step 7 and resumed from
   step 5 ends with the uninterrupted run's params and optimizer state,
   bit for bit; (d) one 2-layer step's loss and gradients against the
   same step on the plain path in fp32 (``flash_ref`` under autograd):
   loss and grad norm within 2e-2, each leaf within twice the bf16 plain
   path's error.
21. STAR in training (``ModelCfg.star_train``): (a) K3's optional lse
   (strict and fast: O bit-equal with and without it, the plain lse at
   1e-4) and K3's backward (``csrc/sufa_bwd.cu``) on the glue's selection
   against its plain version (``sufa_bwd_ref``) by phase 20a's rule, for
   the backward of either forward, two calls bit-equal, in the form the
   tiles pick: the ``wgmma`` form (tiles of 128) at OLMo-1B's training
   shape (BH 128, T = S = 2048, d 128, causal, keep 4 of 16),
   SeamlessM4T's encoder (BH 16, T = S = 2048, d 64, not causal), T 256
   over S 2048, edges (invalid slots, a key tile no q-tile chose with
   dK = dV = 0, a q-tile with no valid slot with dQ = 0) and a key tile
   chosen by every q-tile of a head; the ``mma_sync`` form at tiles of
   64 with the edges; the first two timed beside their bounds (10·d
   flops per visible selected pair), the plain version and SDPA's
   backward under the selection's dense mask, with the split of the
   ``wgmma`` form's two kernels; and K3's forward (strict) at the
   training shape on the glue's selection (keep 4 of 16) against its
   plain version, timed beside its bound and SDPA over the gathered
   rows; (b) OLMo-1B with ``star_train``
   trained as in 20b but 12 steps (``STAR_STEPS_CUT``) and without the
   final save: the loss falls by more than 0.1, K2 = K3 = steps x
   32, K3's backward steps x 16 (all ``wgmma``), K1 and K4 never; step
   ms, tokens/s, MFU, peak memory and one profiled step's split (K2, K3,
   K3's backward, the selection glue, GEMMs, AdamW, the rest); (c) 20c's
   restart check with ``star_train``, in 20c's child process after the
   dense run; (d) 20d's model step with ``star_train``, the plain runs
   taking the kernel run's tile ids; 21a also holds, with the element
   mask (K3's forward writes its keep bits, the backward reads them), the
   ``wgmma`` form at the training shape (timed) and with the edges, each
   pair where the bits differ from ``sphere_mask``'s within one bf16 step
   of its row's edge, O and lse the same bits with and without the keep
   bits; the ``mma_sync`` form at tiles 16 x 16, 32 x 32, 48 x 48, 16 x
   64 and 64 x 16, d 64 and 128, causal (with the edges) and not, with and
   without the element mask (BH 4, T = S = 768), and at tiles of 16 and
   32 at the training shape (timed; 16 also with the mask); (e) OLMo-1B
   with ``star_train`` and ``STARConfig(top_k_ratio=0.2,
   elementwise=True)`` (tiles 128, radius 5) trained as 21b: the loss
   falls by more than 0.1, K2 = K3 = steps x 32 (``sufa/elementwise``
   too), K3's backward steps x 16 in the ``wgmma`` form and as
   ``elementwise``, K1 and K4 never; then 21d's step, the plain runs
   taking the kernel run's tile ids and keep bits; (f) OLMo-1B at its
   published width cut to 2 layers, STAR at tiles of 16 (keep 26 of 128),
   21d's step at 2 x 2048 tokens without and with the element mask, K3's
   backward once per layer in the ``mma_sync`` form.
22. the examples: each twin in ``examples/torch_*.py`` run through its
   ``main`` on the GPU at the JAX example's sizes, with every kernel's
   launches counted from 0 and held to the count its path gives: the
   quickstart (T 512, S 2048, d 128; no kernel: ``core`` is plain
   PyTorch) with its rel error and reduction within 1e-4 of the same
   twin's CPU run; serve_star (star_paper's smoke config, 12 layers,
   pages of 64, 10 requests on a shared system page): every request
   served and prefix-share hits, K1 = decode ticks x 12, K2 = K3 =
   prefill calls (the pool's probe) x 12; train_star_lm (the 100M model,
   60 steps of 8 x 256, ``star_train`` off): every loss finite and the
   last below the first, K4 = steps x 24 and its backward steps x 12
   (causal, d 64, BH 96), its checkpoints under ``build/`` removed;
   spatial_longctx (OLMo-1B's smoke config, head width 64, ``star``
   off): one pool refuses the 500-token prompt and 4 shards on the card
   serve it, K1's stats form = spatial decode ticks x 2, K4 = prefill
   calls (the probes) x 2; the ring demo (8 shards of 128 x 64, fp32):
   max |err| <= 1e-4 against dense attention, 0 link conflicts, no
   kernel.
23. training beyond OLMo-1B, each config with its own optimizer,
   ``train_accum`` and ``remat``: first K4 and its backward at the new
   training shapes by 20a's rule (OLMoE's BH 128 and Grok-1's BH 48,
   T 2048, d 128; Grok-1's timed); then (a) OLMoE-1B-7B at full width and
   depth (AdamW, bf16 moments, the blocked large-leaf update), (b)
   Grok-1 at published width, 1 of 64 layers (Adafactor, 8 microbatches,
   GQA 48 over 8 heads), (c) Jamba-1.5-Large's layer 0 (Mamba + dense FFN,
   the pattern cut with it; Adafactor, 8 microbatches; no kernel; layers
   0-1 ran out of the card's memory, ``JAMBA_TRAIN_CUT``) and (d)
   xLSTM-125M at full width, 4 of 12 layers, at 256 tokens a row (no
   kernel; ``XLSTM_TRAIN_DEPTH_CUT``), each trained 12 steps of 8 rows
   through ``make_train_step``: the loss
   falls by more than 0.1, every loss and grad norm finite, MoE aux above
   0, K4 = steps x attention layers x microbatches x 2 and its backward x
   1, K1-K3 never; step ms, tokens/s, MFU, the training state's
   reckoning, peak memory and a profiled step's split (the optimizer's
   range around ``adamw_update`` or ``adafactor_update``); then each
   config's one-step gradients by 20d's rule (OLMoE at 2 layers, Grok-1
   at its 1, its bf16 gradients parked on the host; the plain runs
   route as the kernel run routed, gate call by gate call), Jamba's and
   xLSTM's loss and grad norm reported against the fp32 plain step; (e)
   OLMo-1B cut to 2 layers: one step's gradients under ``remat`` none and
   dots bit-equal to full's (K4 once a layer under none, twice under the
   others). A child like 20c's (``--restart-child DIR jamba``), run while
   phase 1's kernels build (Jamba's layer 0 launches none), resumes
   Jamba's layer 0 with its Adafactor state (8 x 2048 tokens) bit-equal
   to an uninterrupted run. Each cut
   is on its line's ``reduced`` with its reason.
24. Nemotron-4-340B (head_dim 192, 96 heads over 8 KV heads: GQA group
   12): (a) every kernel of its path at its shapes against its plain
   version, two calls bit-equal, timed beside its bound, its plain
   version and one PyTorch call: K1 at (192, 12) in its four lanes (fp
   and int8, normalised and the (m, l, o) form over 4 shards) at B 1, G
   8, W covering the 2064-token sequence; K2, K3 (strict and fast, with
   and without the element mask) and K4 at BH 96, T = S = 2048, d 192,
   the mma.sync forms also at tiles of 16 and 64 and K4 also at the
   ragged T = S = 2064; (b) its published widths (d_model 18432, d_ff
   73728, vocab 256000) with its depth cut to 4 of 96 layers, one
   2048-token prompt served whole through the paged engine with STAR
   on: K1 = ticks x 4 (R = 12), K2 = K3 = prefill calls x 4, the first
   token against a cache-free STAR forward; (c) the same request with
   ``star=None``, every token held by phase 4's rule against a K4
   forward; the card's peak memory.
25. Nemotron-4-340B trained at head_dim 192: (a) K4's and K3's
   backwards at its training shape (BH 96, T = S = 2048, d 192, causal)
   against their plain versions by 20a's and 21a's rules, two calls
   bit-equal: K4's timed beside SDPA's backward; K3's on the glue's
   selection at Nemotron's top_k_ratio 0.2, its wgmma form with and
   without the element mask (timed beside SDPA's backward under the
   selection's mask), the edges and a key tile every q-tile chose, its
   mma.sync form at tiles of 64 (timed) and 16; (b) one layer at its
   published width (``lm._block_apply`` on a [2, 2048, 18432] input and
   a seeded upstream gradient), dense and with ``star_train``, every
   parameter's and the input's gradient by 20d's rule against the fp32
   plain layer; (c) its published widths cut to 1 of 96 layers (12.89 B
   parameters with the untied embedding and head), 8 steps of 8 x 2048
   tokens (``NEMOTRON_STEPS_CUT``) with its own Adafactor and
   ``train_accum`` 8, dense and then with ``star_train``: the loss falls
   by more than 0.1, every loss and grad norm finite, K4 = steps x 8 x 2
   and its backward steps x 8 (K2 =
   K3 = steps x 8 x 2 and K3's backward steps x 8 in its wgmma form with
   ``star_train``); step ms, tokens/s, MFU, the state's reckoning (one
   gradient tree: ``launch.steps.accumulate_grad``) and peak memory.
26. the serving smoke's twins (``tools/torch_smoke_serve.py``,
   ``tools/torch_smoke_spatial_prog.py``), run after phase 9 on phase 3's
   weights (OLMo-1B at full width; ``star=None`` where the twins take it),
   each sub-phase's kernel launches counted from 0 against its decode
   steps, audit probes and ``lm.prefill`` calls (K1 once per layer of each
   paged step and probe, its (m, l, o) form of each spatial step, K4 of
   each dense prefill; ``serving_launches``): (a) ``basic``, paged and
   dense through ``LLM`` with the reference's assertions; (b) the 2-shard
   spatial scenarios: parity with the paged engine, each run's every
   token held by phase 4's rule (the two decode forms round apart in
   bf16), one decode compilation; the overflow prompt refused by one pool
   and served by two shards; cold pages shed with no preemption; ``LLM``
   at 0.95 of the direct engine's tokens/s or better within 3 attempts;
   (c) three Perfetto traces (dense, paged, spatial) that load back, tick
   spans in order with every other span inside a tick, the spatial one
   shard-tagged, their phase tables; (d) ``LLM.debug_bundle`` after a
   pressured run with the DLZS audit and ``DisaggRouter.debug_bundle``:
   every artifact present, every JSON file loading with no tensor
   ``repr`` in it, an audit report, a hop landed and none in flight; (e)
   phase 5's bounded sparse decode four times more, without, with (and
   an audit probe every 4 ticks), with and without telemetry: phase 5's
   tokens each time, each layer's attention-mass recall finite and in
   [0, 1], tokens/s with and without telemetry beside phase 5's. Phase 2
   holds K1, its (m, l, o) form over 2 shards and K4 at every shape
   these runs reach (``SERVE_TWIN_K1``, ``SERVE_TWIN_K1_STATS``,
   ``SERVE_TWIN_K4``) before them.
27. the configs the reference trains that no earlier phase trained, at
   their published widths, each with its own optimizer (AdamW, bf16
   moments), ``train_accum`` (1) and ``remat`` (full): (a) K4's forward
   and backward at BH 256 (8 rows x 32 heads: star_paper, and
   ChatGLM3-6B after ``_repeat_kv``) and BH 384 (StarCoder2-15B, 8 x
   48), K2, K3's forward and K3's backward (``wgmma``, the glue's
   selection, keep 4 of 16) at BH 256, T = S = 2048, d 128, causal, by
   20a's and 21a's rules, each timed beside its bound, its plain version
   and SDPA; (b) one step's gradients of star_paper, ChatGLM3-6B (GQA
   16, half-dim rotary, QKV bias) and StarCoder2-15B (LayerNorm with
   bias, tanh-GELU) at 2 layers and 2 x 2048 tokens by 20d's rule, each
   dense and with ``star_train`` (the plain runs on the kernel run's tile
   ids); (c) star_paper with ``star_train`` (32 of 32 layers),
   ChatGLM3-6B dense and with ``star_train`` (28 of 28) and
   StarCoder2-15B dense at its first ``STARCODER2_TRAIN_LAYERS`` of 40
   layers, each 12 steps of 8 x 2048 tokens: the loss falls by more than
   0.1, every loss and grad norm finite, K4 = steps x layers x 2 and its
   backward x 1, or K2 = K3 = steps x layers x 2 and K3's backward x 1 in
   its ``wgmma`` form; step ms, tokens/s, MFU, the state's reckoning,
   peak memory and a profiled step's split.
Phase 4 also counts K4: oracle forwards x attention layers launches (an
encoder-decoder forward's: its encoder, self- and cross-attention
layers).

Then one JSON line with every kernel's numbers and, last, the device line.
Without a GPU, or outside a checkout, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import functools
import gc
import importlib.util
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
                                 nemotron_4_340b, olmo_1b, olmoe_1b_7b,
                                 seamless_m4t_large_v2, star_paper,
                                 starcoder2_15b, xlstm_125m)
from repro_torch.core import sads  # noqa: E402
core_star = importlib.import_module("repro_torch.core.star_attention")
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
from repro_torch.serving.paged import PagedBackend  # noqa: E402
from repro_torch.spatial import SpatialEngineCfg  # noqa: E402
from repro_torch.spatial.engine import SpatialBackend  # noqa: E402
from repro_torch.tree import sorted_items, tree_leaves, tree_map  # noqa
from repro_torch.data import PrefetchLoader, SyntheticLM  # noqa: E402
from repro_torch.launch import roofline, shapes  # noqa: E402
from repro_torch.launch import steps as launch_steps  # noqa: E402
from repro_torch.optim import adafactor, adamw  # noqa: E402
from repro_torch.runtime import TrainLoopCfg, train_loop  # noqa: E402

SEED = 0
# NVIDIA H100 SXM data sheet: HBM3 rate and dense bf16 tensor-core peak
HBM_BYTES_S, BF16_FLOP_S = roofline.HBM_BW, roofline.PEAK_FLOPS
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
# phase 17 serves 6 of xLSTM-125M's 12 layers (3 mLSTM, 3 sLSTM blocks):
# with phase 26 the whole script ran 1111 s on an H100 against its 1200 s
# limit, and phase 17, host-bound in its sLSTM time loop, took 66 s of it
XLSTM_SERVE_LAYERS = 6
XLSTM_SERVE_CUT = (
    f"{XLSTM_SERVE_LAYERS} of 12, for chip_smoke.py's 1200 s: the full "
    "depth's 66 s of host-bound sLSTM loop halves; the alternating "
    "mLSTM/sLSTM pattern and every width stay")
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
# phases 21b and 21e train OLMo-1B with star_train for fewer steps
STAR_TRAIN_STEPS = 12
STAR_STEPS_CUT = (
    "12 of 20, for the script's clock beside phase 27: a step takes about "
    "0.67 s on an H100, so the two runs take about 11 s less; in 20-step "
    "runs there the loss fell 0.6 by step 5")
TRAIN_LR = 6e-4
TRAIN_WARMUP = 5
RESTART_LAYERS = 2
RESTART_BATCH = 4
XLSTM_TRAIN_SEQ = 256       # phase 23d's cut (family_cases)
# the most copies of the training state a restart check holds on disk at
# once: the uninterrupted run's saves at steps 5 and 10, then the resumed
# run's at 5 and 10 and its final save's copy of 10 while it is written
RESTART_STATE_COPIES = 5
# A profiled split window: the host sleep before and after its calls, and
# the most sessions it takes. On an H100 the trace of a session late in this
# script can lack its first launches, or all of them, most often in the
# first session after other work; another session on the same calls mostly
# holds them all (PERF.md §7).
PROFILE_MARGIN_S = 0.5
SPLIT_SESSIONS = 4
# K4's backward's kernels (csrc/flash_bwd.cu), by name prefix; at head_dim
# 192 its key-tile pass is a kernel of its own
BWD_KERNELS = ("bwd_prep", "bwd_kv")
BWD_KERNELS_D192 = ("bwd_prep", "bwd_kv192")
# phase 21: STAR in training; the kernels of K3's backward's wgmma form
# (csrc/sufa_bwd.cu, 128 x 128 tiles) in launch order, by name prefix; at
# head_dim 192 its dK/dV pass is a kernel of its own
SUFA_BWD_KERNELS = ("sufa_grad_q_wgmma", "sufa_grad_kv_wgmma")
SUFA_BWD_KERNELS_D192 = ("sufa_grad_q_wgmma", "sufa_grad_kv_wgmma192")
# and of its mma_sync form (other tilings), in launch order
SUFA_BWD_MMA_KERNELS = ("sufa_grad_prep", "sufa_grad_kv", "sufa_grad_q")
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
              flops: int, plain_iters: int = 50) -> None:
    """Kernel, plain and library times (median of 50 launches after an L2
    flush; the plain version's of ``plain_iters``), the kernel again to
    see the spread, and the least time the card could take: bytes each
    read or written once over the HBM rate, or the bf16 operations over
    the tensor-core peak, whichever is larger."""
    out["ms"] = time_ms(kernel, flush=flush)
    out["plain_ms"] = time_ms(plain, iters=plain_iters, flush=flush)
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
                  device, generator, hot_width=None, telemetry=None,
                  audit_cfg=None) -> LLM:
    return LLM.from_config(
        cfg, backend="paged", params=params, device=device,
        generator=generator, telemetry=telemetry, audit_cfg=audit_cfg,
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
               d=128, plain_iters: int = 50) -> dict:
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
                  flops=2 * d * bh * visible_pairs(t, t, causal),
                  plain_iters=plain_iters)
    emit("prefill_kernel", ok=True, **out)
    return out


def selected_pairs(idx, valid, *, t: int, s: int, block: int = 128,
                   block_kv: int | None = None, causal: bool = True,
                   block_q: int | None = None) -> int:
    """(query, key) pairs K3 computes: the causal keys (every key, when
    not ``causal``) of each valid selected tile, for each query row of
    its q-tile (tiles ``block_q`` x ``block_kv``, both ``block`` unless
    given)."""
    block_q, block_kv = block_q or block, block_kv or block
    if not causal:
        return int(valid.sum()) * block_q * block_kv
    n_qt = t // block_q
    q_pos = torch.arange(t, device=idx.device).reshape(n_qt, block_q) \
        + (s - t)
    first = idx[..., None] * block_kv                # [BH, n_qt, keep, 1]
    seen = (q_pos[None, :, None, :] - first + 1).clamp(0, block_kv)
    return int((seen * valid[..., None]).sum())


def check_sufa(dev, flush, *, bh, t, block, strict, seed, timed,
               d=128, elementwise=False, causal=True,
               plain_iters: int = 50) -> dict:
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
                  bytes_=nbytes(q, q, idx, valid) + tile_bytes, flops=flops,
                  plain_iters=plain_iters)
    emit("prefill_kernel", ok=True, **out)
    return out


def check_flash(dev, flush, *, bh, t, causal, seed, timed, d=128,
                s=None, plain_iters: int = 50) -> dict:
    """K4 over T queries and S keys (S = T unless given: a decoder's
    cross-attention has T != S, unmasked, and S need not be a whole
    tile); two calls bit-equal."""
    q, k, v = prefill_inputs(bh, t, d, seed, dev)
    s = s or t
    if s != t:
        _, k, v = prefill_inputs(bh, s, d, seed + 1, dev)
    kernel = lambda: kflash.flash_attention(q, k, v, causal=causal)  # noqa
    plain = lambda: kref.flash_ref(q, k, v, causal=causal)  # noqa: E731
    got = kernel()
    if not torch.equal(got, kernel()):
        raise SystemExit(f"flash T={t} S={s} d={d}: two calls on the same "
                         f"inputs gave different bits")
    out = held("prefill_kernel", got, plain(), PREFILL_TOL["flash"],
               kernel="flash", BH=bh, T=t, S=s, d=d, causal=causal)
    if timed:
        add_times(out, kernel, plain,
                  lambda: SDPA(q[None], k[None], v[None], is_causal=causal),
                  flush, bytes_=nbytes(q, k, v, q),
                  flops=4 * d * bh * visible_pairs(t, s, causal),
                  plain_iters=plain_iters)
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
    # phase 22's forms (d 64): examples/torch_serve_star.py's K2 and K3
    # (star_paper's smoke config: 12 heads, one q-tile of 64 at tiles of
    # 64), and examples/torch_spatial_longctx.py's K4 (4 heads, a causal
    # 16-token prefill)
    check_dlzs(dev, flush, bh=12, t=64, block=64, causal=True, seed=61,
               timed=False, d=64)
    for strict in (True, False):
        check_sufa(dev, flush, bh=12, t=64, block=64, strict=strict,
                   seed=62, timed=False, d=64)
    check_flash(dev, flush, bh=4, t=16, causal=True, seed=63, timed=False,
                d=64)
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


def free_card_bytes(device) -> int:
    """Bytes the card can still allocate: its free memory and what the
    caching allocator holds unused."""
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) \
        - torch.cuda.memory_allocated(device)


def free_cache(device) -> None:
    """Collect unreachable objects (an engine and its backend refer to
    each other, so a dropped engine and the params it holds wait for the
    cycle collector), then return the freed blocks to the card."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def check_cut_config(name: str, cfg, dev, gen, *, layers=CUT_LAYERS,
                     prompt_len=CUT_PROMPT, max_tokens=GLM_MAX_TOKENS,
                     elementwise_too: bool = False,
                     exact_too: bool = False) -> dict:
    """Phase 12: a config at its published widths with its depth cut to
    CUT_LAYERS, one CUT_PROMPT-token prompt served whole through the paged
    engine with STAR on: K1 and K2/K3 launch counts, the first token
    against a cache-free STAR forward. With ``elementwise_too`` the same
    again under ``STARConfig(elementwise=True)`` (K3's element mask); with
    ``exact_too`` (phase 24) the same request with ``star=None``, every
    token held by phase 4's rule against a K4 forward. The peak of the
    card's memory over the phase is in ``info``."""
    published = cfg.n_layers
    cfg = dataclasses.replace(cfg, n_layers=layers)
    reset_peak_memory(dev)
    params, info = init_params(cfg, gen, dev)
    info["peak_gb_after_init"] = peak_memory_gb(dev)
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
    if exact_too:
        warm_prefill(params, dataclasses.replace(cfg, star=None), prompt_len)
        run, exact, _ = serve_exact(cfg, params, prompts, max_tokens, dev,
                                    gen, record=False)
        require_launches(exact, f"{name} star=None")
        require_prefill_launches(exact, f"{name} star=None")
        exact.update(check_exact(params, cfg, prompts, run["done"]))
        emit("cut_config", config=name, attention="dense", layers=layers,
             reduced=f"n_layers {layers} of {published}",
             group=cfg.n_heads // cfg.n_kv, **info, **exact)
        require_k4(exact, f"{name} exactness")
        out["exact"] = exact
    out["info"] = dict(info, peak_gb=peak_memory_gb(dev))
    del params
    free_cache(dev)
    return out


def reset_peak_memory(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_memory_gb(device):
    """The card's peak allocation since the last reset, in GB; None off
    the card."""
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 1e9


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
                max_tokens=XLSTM_MAX_TOKENS, layers=None) -> dict:
    """Phase 17: xLSTM-125M at full width through the dense slot engine, its
    depth cut to ``layers`` where given (``XLSTM_SERVE_CUT``), no kernel of
    the port launching. In bf16, the config's dtype:
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
    reduced = None
    if layers is not None:
        reduced = {"n_layers": XLSTM_SERVE_CUT}
        cfg = cut_layers(cfg, layers)
    params, info = init_params(cfg, gen, dev)
    emit("xlstm_init", dtype=str(cfg.dtype), layers=cfg.n_layers,
         blocks=[b.kind for b in cfg.pattern], reduced=reduced, **info)
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
        emit("xlstm_served", dtype=key, reduced=reduced, **run)
        out[key] = run
    timing = timed_slstm_prefill(params, cfg, max(lengths), on_card)
    split = profiled_prefill(params, cfg, min(lengths), on_card)
    emit("xlstm_prefill", reduced=reduced, **timing, profiled=split)
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
        err = float((got[name].to(w.device).float() - w).abs().max())
        ref = float((lowp[name].to(w.device).float() - w).abs().max())
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
                    s=None, plain_iters: int = 50) -> dict:
    """Phase 20a: K4's backward against its plain version. K4's forward
    with ``return_lse`` must give the O bits it gives without, and its lse
    the plain log-sum-exp at 1e-4; dQ, dK and dV must meet
    ``gradient_rule`` against the fp32 plain gradient (``flash_bwd_ref``
    on fp32 copies of the inputs, the fp32 forward's O and lse). Timed:
    the kernel, its plain version on the same bf16 inputs, its bound (10·d
    flops per visible pair, or its bytes) and SDPA's backward alone
    (``torch.autograd.grad`` on a retained graph), and each of its
    kernels' device time (``flash_bwd_split``)."""
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
                  flops=10 * d * pairs, plain_iters=plain_iters)
        out.update(flash_bwd_split(
            kernel, flush, parts=BWD_KERNELS_D192 if d == 192
            else BWD_KERNELS))
        # achieved rate by the 10·d flops per visible pair the gradient
        # needs (and the kernel executes: no product is computed twice)
        out["tflop_s_10d"] = 10 * d * pairs / out["ms"] / 1e9
    emit("flash_bwd", ok=True, **out)
    return out


def flash_bwd_split(fn, flush, iters: int = 10,
                    parts=BWD_KERNELS) -> dict:
    """Device ms per launch of each kernel a backward launches (K4's:
    the prep pass, and the key-tile pass that computes dK, dV and dQ;
    K3's ``wgmma`` form with ``parts=SUFA_BWD_KERNELS``: the dQ pass
    that also sums D, then dK/dV), from
    ``torch.profiler`` over ``iters`` calls of ``fn``, each after an L2
    flush, ``PROFILE_MARGIN_S`` from either end of the window; the session
    is run again, up to ``SPLIT_SESSIONS`` in all, until its trace holds
    every launch (the one holding the most is read: averaged over the
    launches it holds); their sum beside them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    best = None
    for session in range(1, SPLIT_SESSIONS + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_MARGIN_S)
            for _ in range(iters):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_MARGIN_S)
        _, _, top = profiling.device_kernels(prof, set())
        mine = {part: [k for k in top if f"{part}_kernel" in k["name"]]
                for part in parts}
        traced = sum(k["calls"] for ks in mine.values() for k in ks)
        if best is None or traced > best[0]:
            best = (traced, mine)
        if traced == iters * len(parts):
            break
    out = {"split_sessions": session}
    for part, ks in best[1].items():
        out[f"{part}_launches_traced"] = sum(k["calls"] for k in ks)
        out[f"{part}_ms"] = sum(k["device_ms"] for k in ks) / max(
            1, out[f"{part}_launches_traced"])
    out["split_sum_ms"] = sum(out[f"{part}_ms"] for part in parts)
    return out


def check_flash_bwd_shapes(dev, ptxas=()) -> dict:
    """Phase 20a's shapes: OLMo-1B's attention at BH 16 and at its
    training shape (seq 2048 x batch 8: BH 128), T = S = 2048, d 128,
    causal; a ragged T = S = 1000; non-causal T 256 over S 2048 at d 64;
    causal T = S = 256 at d 64, BH 96; and K4's forward at the training
    shape. Returns {case: numbers}; all but BH 16 and the ragged case are
    timed. ``ptxas``: the backward's register and spill lines from
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
                                        d=64),
           # phase 22's star_paper model: batch 8 x 12 heads of 64
           "causal_d64": check_flash_bwd(dev, flush, bh=96, t=256,
                                         causal=True, seed=2005, timed=True,
                                         d=64),
           # K4's forward at the training shape (phase 20b launches it
           # twice per layer and step: the forward and its recompute)
           "forward_train": check_flash(dev, flush, bh=TRAIN_BATCH * 16,
                                        t=TRAIN_SEQ, causal=True, seed=2006,
                                        timed=True)}
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
    step's loss, grad norm, MoE aux loss and host seconds (each step ends
    in a sync),
    the final save's seconds and the final params and optimizer state.
    With ``ckpt_dir`` None the same steps run from the same loader
    without ``train_loop``: no checkpoint, no final save."""
    step = launch_steps.make_train_step(cfg, lr=lr, warmup=TRAIN_WARMUP,
                                        total_steps=steps)
    rec = {"loss": [], "grad_norm": [], "aux": [], "step_s": []}

    def step_fn(p, o, b):
        t0 = time.perf_counter()
        p, o, m = step(p, o, b)
        rec["loss"].append(float(m["loss"]))
        rec["grad_norm"].append(float(m["grad_norm"]))
        rec["aux"].append(float(m["aux"]))
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


OPTIMIZER_RANGES = {(adamw, "adamw_update"): "optimizer",
                    (adafactor, "adafactor_update"): "optimizer"}


def profile_train_step(cfg, params, opt_state, batch, on_card: bool) -> dict:
    """One more training step under ``torch.profiler``: its device time
    split into K4's forward and backward (with ``star_train``: K2, K3's
    forward, K3's backward and the selection glue, a profiler range
    around ``ops.select_tiles``), the GEMMs, the optimizer update (a
    profiler range around ``adamw_update`` or ``adafactor_update``,
    ``OPTIMIZER_RANGES``) and the rest (norms, activations, softmax-CE,
    casts, the embedding), and the device's busy share of the step's wall
    time; the port's kernels the trace holds (``kernels_traced``) beside
    those the step launches (``kernels_expected``: a backward launch is
    two kernels, three in K3's ``mma_sync`` form). ``ranges_seen``: each
    range's count of host spans (off the card the only numbers, with the
    wall time; on it the profiler also records a device-side span of
    each)."""
    from torch.profiler import ProfilerActivity, profile
    step = launch_steps.make_train_step(cfg, lr=TRAIN_LR,
                                        warmup=TRAIN_WARMUP,
                                        total_steps=TRAIN_STEPS)
    ranges = dict(OPTIMIZER_RANGES)
    if star_trained(cfg):
        ranges[ops, "select_tiles"] = "selection"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    with profiling.ranged(ranges), profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(params, opt_state, batch)
        sync(batch["tokens"].device)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    names = set(ranges.values())
    seen = profiling.host_counts(prof, names)
    if not on_card:
        return {"wall_ms": wall_ms, "ranges_seen": seen}
    device_ms, busy_ms, top = profiling.device_kernels(prof, names)

    def by_name(*keys, key="device_ms"):
        return sum(k[key] for k in top
                   if any(p in k["name"].lower() for p in keys))
    # the port's kernels in the trace against one step's launches (each
    # backward launch runs two kernels, three in K3's mma_sync form): a
    # window that lost some reads short (PERF.md §7)
    want = training_launches(cfg, 1)
    if star_trained(cfg):
        per_bwd = 3 if launch.tile_form(cfg.star.block_q,
                                        cfg.star.block_kv) == "mma_sync" \
            else 2
        kernel_keys = {"dlzs_block": ("dlzs_wgmma_kernel",
                                      "dlzs_mma_kernel"),
                       "sufa": ("sufa_wgmma_kernel", "sufa_mma_kernel"),
                       "sufa_bwd": ("sufa_grad_",)}
        expected = {"dlzs_block": want["dlzs_block"], "sufa": want["sufa"],
                    "sufa_bwd": want["sufa_bwd"] * per_bwd}
    else:
        kernel_keys = {"flash": ("flash_kernel",), "flash_bwd": BWD_KERNELS}
        expected = {"flash": want["flash"],
                    "flash_bwd": want["flash_bwd"] * len(BWD_KERNELS)}
    traced = {k: by_name(*v, key="calls") for k, v in kernel_keys.items()}
    if star_trained(cfg):
        parts = {"k2_ms": by_name("dlzs_wgmma_kernel", "dlzs_mma_kernel"),
                 "k3_forward_ms": by_name("sufa_wgmma_kernel",
                                          "sufa_mma_kernel"),
                 "k3_backward_ms": by_name("sufa_grad_"),
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
            "device_busy_share": busy_ms / wall_ms,
            "kernels_traced": traced, "kernels_expected": expected,
            "window_holds_every_launch": traced == expected, **parts,
            **{k[:-3] + "_share": v / device_ms for k, v in parts.items()},
            "ranges_seen": seen, "top_kernels": top[:12]}


def training_launches(cfg, steps: int) -> dict:
    """The kernel launches of ``steps`` training steps of ``cfg`` on the
    card: one backward per attention layer and microbatch
    (``train_accum`` a step), the forward twice under remat (the forward
    and its recompute) and once under ``remat="none"``; K4 and its
    backward, or with ``star_train`` K2, K3 and K3's backward in the form
    the tiles pick (and as ``elementwise`` under the element mask); every
    other kernel never."""
    per = steps * attn_layers(cfg) * cfg.train_accum
    fwd = 1 if cfg.remat == "none" else 2
    want = {name: 0 for name in kernels.LAUNCHES}
    if star_trained(cfg):
        want.update(dlzs_block=per * fwd, sufa=per * fwd, sufa_bwd=per)
        form = launch.tile_form(cfg.star.block_q, cfg.star.block_kv)
        elem = cfg.star.elementwise
        want.update({f"sufa_bwd/{f}": per * (f == form)
                     for f in ("wgmma", "mma_sync")})
        want.update({"sufa/elementwise": per * fwd * elem,
                     "sufa_bwd/elementwise": per * elem})
    else:
        want.update(flash=per * fwd, flash_bwd=per)
    return want


def check_training(cfg, dev, gen, *, steps=TRAIN_STEPS, seq=TRAIN_SEQ,
                   batch=TRAIN_BATCH, lr=TRAIN_LR, save: bool = True,
                   tag: str = "training", reduced=None) -> dict:
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
    never, each launch of K3 and its backward in the form the config's
    tiles pick, and counted as ``elementwise`` where the config has the
    element mask (phase 21e). Phase 23 runs it with each config's own
    optimizer, ``train_accum`` and ``remat`` (``tag`` names its lines,
    ``reduced`` its cuts): every count is per microbatch (times
    ``train_accum``), K4 once per layer under ``remat="none"`` (no
    recompute), and a config with MoE layers must report an aux loss
    above 0 and finite at every step."""
    on_card = torch.device(dev).type == "cuda"
    params, info = init_params(cfg, gen, dev)
    _, opt_init, _ = launch_steps.make_optimizer(cfg, lr)
    opt_state = opt_init(params)
    info["state_gb"] = state_gb(params, opt_state, cfg)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "star_train": star_trained(cfg),
           "star": dataclasses.asdict(cfg.star) if star_trained(cfg)
           else None,
           "seq": seq, "batch": batch, "steps": steps, "lr": lr,
           "warmup": TRAIN_WARMUP, "remat": cfg.remat,
           "optimizer": cfg.optimizer, "train_accum": cfg.train_accum,
           "reduced": reduced, **info,
           "free_disk_gb_before": free_disk_gb(BUILD_DIR)}
    emit(f"{tag}_setup", **out)
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
    want = training_launches(cfg, steps) if on_card \
        else {name: 0 for name in kernels.LAUNCHES}
    tokens = seq * batch
    train_shape = shapes.ShapeCfg("train", seq, batch, "train")
    step_s = float(np.median(run["step_s"][1:] or run["step_s"]))
    out.update(loss=run["loss"], grad_norm=run["grad_norm"],
               aux=run["aux"], step_ms=[1e3 * x for x in run["step_s"]],
               step_ms_median=1e3 * step_s, tokens_per_step=tokens,
               tokens_per_s=tokens / step_s,
               mfu=roofline.model_flops(cfg, train_shape) / step_s
               / BF16_FLOP_S,
               mfu_formula="launch.roofline.model_flops (6 * body params, "
                           "embedding and output head excluded, * tokens "
                           "per step) / median step s (steps 1..) / 989e12",
               mfu_all_params=6 * info["params"] * tokens / step_s
               / BF16_FLOP_S,
               mfu_all_params_formula="6 * all params * tokens per step / "
                                      "median step s (steps 1..) / 989e12",
               body_params=roofline.count_params(cfg)[1],
               peak_memory_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                               if on_card else None),
               save_s=run["save_s"], launches=got,
               expected_launches=want)
    emit(tag, **out)
    bad = [x for x in run["loss"] + run["grad_norm"] if not math.isfinite(x)]
    if bad:
        raise SystemExit(f"{tag}: non-finite loss or grad norm {bad}")
    if moe_layers(cfg) and not all(0 < x < math.inf for x in run["aux"]):
        raise SystemExit(f"{tag}: MoE aux loss not above 0 and finite: "
                         f"{run['aux']}")
    if not run["loss"][-1] < run["loss"][0] - 0.1:
        raise SystemExit(f"{tag}: the loss did not fall by 0.1: "
                         f"{run['loss']}")
    if {k: got[k] for k in want} != want:
        raise SystemExit(f"{tag}: launches {got}; expected {want}")
    del run, params, opt_state
    free_cache(dev)
    return out


def cut_layers(cfg, layers: int):
    """``cfg`` cut to its first ``layers`` layers in the published order;
    a hybrid's pattern is sliced with them (``n_layers`` alone trips
    ``ModelCfg.n_repeat``'s assert)."""
    pattern = cfg.pattern[:layers] if layers < len(cfg.pattern) \
        else cfg.pattern
    return dataclasses.replace(cfg, n_layers=layers, pattern=pattern)


def restart_child(workdir: str, dev="cuda", cfg=None, seq: int = TRAIN_SEQ,
                  batch: int = RESTART_BATCH,
                  layers: int = RESTART_LAYERS) -> dict:
    """Phase 20c, in a process of its own (``CUBLAS_WORKSPACE_CONFIG`` set
    before cuBLAS starts, deterministic algorithms on, so an op without a
    deterministic form raises): OLMo-1B at full width cut to
    RESTART_LAYERS layers, 10 steps uninterrupted (a checkpoint every 5),
    then the same run failed at step 7 and resumed from a fresh init. The
    final params and optimizer state must be the same bits. Phase 21c
    passes OLMo-1B with ``star_train`` as ``cfg``; phase 23c Jamba's
    layer 0 (Adafactor state, ``train_accum`` 8). Free disk under the
    run's directory is read first and must hold ``RESTART_STATE_COPIES``
    copies of the state's bytes."""
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(dev)
    cfg = cfg or olmo_1b.config()
    published = cfg.n_layers
    cfg = cut_layers(cfg, layers)
    gen = torch.Generator(device=dev)
    root = pathlib.Path(workdir)

    def fresh():
        params, _ = init_params(cfg, gen, dev)
        _, opt_init, _ = launch_steps.make_optimizer(cfg, TRAIN_LR)
        return params, opt_init(params)
    kw = dict(steps=10, seq=seq, batch=batch, dev=dev, ckpt_every=5)
    t0 = time.perf_counter()
    first = fresh()
    disk = {"free_disk_gb_before": free_disk_gb(root.parent),
            "disk_needed_gb": RESTART_STATE_COPIES * sum(
                t.numel() * t.element_size()
                for _, t in sorted_items(dict(zip("po", first)))) / 1e9}
    if disk["free_disk_gb_before"] < disk["disk_needed_gb"]:
        raise SystemExit(f"restart ({cfg.name}): {disk} under build/")
    whole = train_run(cfg, *first, ckpt_dir=root / "a", **kw)
    del first
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
    return {"arch": cfg.name,
            "reduced": {"n_layers": f"{layers} of {published}"},
            "star_train": star_trained(cfg), "optimizer": cfg.optimizer,
            "train_accum": cfg.train_accum,
            "seq": seq, "batch": batch, "steps": 10,
            "fail_at": 7, "resumed_from": 5, "leaves": len(pairs),
            "leaves_differ": differ, "bit_equal": not differ,
            **disk, "loss_uninterrupted": whole["loss"],
            "loss_resumed": resumed["loss"],
            "seconds": time.perf_counter() - t0}


def _key_path(path: tuple) -> str:
    return "/".join(path)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes (a 0-d tensor as itself), for bit equality."""
    return t.view(torch.uint8) if t.dim() else t


RESTART_TAGS = {"olmo": ("training_restart", "star_training_restart"),
                "jamba": ("family_training_restart",)}


def restart_children(workdir: str, which: str = "olmo") -> list:
    """One deterministic process's restart checks (one start-up):
    ``which`` "olmo", phases 20c and 21c: ``restart_child`` for OLMo-1B,
    then with ``star_train``; "jamba", phase 23c's: Jamba-1.5-Large's
    layer 0 with its Adafactor state and ``train_accum`` 8 (its batch 8
    rows of 2048 tokens, one a microbatch). Jamba's layer 0 launches no
    kernel, so its child runs while the kernels build."""
    root = pathlib.Path(workdir)
    if which == "jamba":
        return [restart_child(str(root / "jamba"),
                              cfg=jamba_1_5_large_398b.config(), layers=1,
                              batch=TRAIN_BATCH)]
    cfg = olmo_1b.config()
    return [restart_child(str(root / name), cfg=c)
            for name, c in (("dense", cfg), ("star", dataclasses.replace(
                cfg, star_train=True)))]


def start_restart(which: str) -> tuple:
    """``chip_smoke.py --restart-child DIR which`` started in a child
    process (``CUBLAS_WORKSPACE_CONFIG`` set before cuBLAS starts), its
    output into files under DIR; returns (process, DIR). The process is
    killed at exit if it still runs."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    workdir = pathlib.Path(tempfile.mkdtemp(prefix="restart_",
                                            dir=BUILD_DIR))
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    with open(workdir / "out.txt", "w") as out, \
            open(workdir / "err.txt", "w") as err:
        proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                 "--restart-child", str(workdir), which],
                                env=env, stdout=out, stderr=err)
    atexit.register(proc.kill)
    return proc, workdir


def finish_restart(proc, workdir, which: str) -> tuple:
    """Wait for ``start_restart``'s child, emit each of its runs' lines
    (``RESTART_TAGS[which]``) and fail where it failed or a resumed run
    differs from the uninterrupted one; its directory is removed."""
    try:
        proc.wait(timeout=600)
        stdout = (workdir / "out.txt").read_text()
        stderr = (workdir / "err.txt").read_text()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if proc.returncode != 0:
        raise SystemExit(f"restart child ({which}) failed "
                         f"({proc.returncode}):\n{stdout[-4000:]}\n"
                         f"{stderr[-4000:]}")
    runs = json.loads(stdout.strip().splitlines()[-1])
    for tag, out in zip(RESTART_TAGS[which], runs):
        emit(tag, **out)
        if not out["bit_equal"]:
            raise SystemExit(f"{tag}: resumed run differs from the "
                             f"uninterrupted one at {out['leaves_differ']}")
    return tuple(runs)


def check_restart(dev) -> tuple:
    """Phases 20c and 21c's restart: ``restart_children`` for OLMo-1B in a
    child process. Returns (dense, star)."""
    return finish_restart(*start_restart("olmo"), "olmo")


def plain_flash_train(q, k, v, *, causal, scale):
    """``ops.flash`` as its plain version under autograd (20d's plain
    path): ``flash_ref``'s fp32 softmax, differentiated by torch."""
    return kref.flash_ref(q, k, v, causal=causal, scale=scale)


def plain_sufa_train(q, k, v, idx, valid, *, scale, keeps=None, **kw):
    """``ops.sufa_attention`` as its plain version under autograd (21d's
    plain path): ``sufa_reference``'s fp32 softmax over the gathered
    tiles, differentiated by torch; with the element mask, over the keys
    of the kernel run's keep bits where ``keeps`` (an iterator) gives
    them."""
    bits = next(keeps) if keeps is not None and kw.get("elementwise") \
        else None
    return ksufa.sufa_reference(q, k, v, idx, valid, scale=scale,
                                keep_bits=bits, **kw)


@contextlib.contextmanager
def plain_attention(keeps=None):
    """Within the block, K4, K2 and K3 run as their plain versions under
    autograd (``plain_flash_train``, ``dlzs_block_ref``,
    ``plain_sufa_train`` with ``keeps``): the plain path of 20d, 21d and
    ``tools/torch_nemotron_train.py --compare``."""
    names = ("flash", "dlzs_block_scores", "sufa_attention")
    real = {name: getattr(ops, name) for name in names}
    ops.flash = plain_flash_train
    ops.dlzs_block_scores = kref.dlzs_block_ref
    ops.sufa_attention = functools.partial(plain_sufa_train, keeps=keeps)
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(ops, name, fn)


@contextlib.contextmanager
def recorded_gates(store: list):
    """Within the block, every call of ``moe._gate`` appends its choices
    (eidx as [rows, k]) to ``store``, in call order."""
    real = moe._gate

    def gate(x, wg, cfg):
        top_p, eidx, aux = real(x, wg, cfg)
        store.append(eidx.reshape(-1, eidx.shape[-1]))
        return top_p, eidx, aux
    moe._gate = gate
    try:
        yield
    finally:
        moe._gate = real


def model_grads(params, cfg, batch, plain: bool, tiles=None,
                keeps=None, routes=None,
                grad_fn=launch_steps.value_and_grad) -> tuple:
    """(loss, metrics, grads) of one ``lm.loss_fn`` step (or of
    ``grad_fn(params, cfg, batch)``, ``layer_value_and_grad`` for phase
    25b's layer), with the kernels
    and their backwards, or ``plain`` with the plain versions in their
    place (``plain_flash_train``, K2's ``dlzs_block_ref``,
    ``plain_sufa_train``). With ``tiles`` (a list; STAR in training) a
    kernel run appends each STAR call's (tile ids, validity) to it, and a
    plain run takes them from it in call order, so both compute attention
    over the tiles the kernels' selection kept; ``keeps`` (a list; the
    element mask) does the same with K3's keep bits, so both compute it
    over the keys the kernel kept. ``routes`` (a list; MoE) does the same
    with the gate's choices, gate call by gate call (under remat the
    recompute's calls follow the forward's, layers in reverse order): a
    plain run routes every row as the kernel run did (``forced_routing``,
    the gate's own probabilities of those experts), so a near-tie that two
    roundings rank apart cannot make the two runs different functions."""
    names = ("flash", "dlzs_block_scores", "select_tiles", "sufa_attention")
    real = {name: getattr(ops, name) for name in names}
    real_forward = ksufa._forward
    replay = iter(tiles or ())
    replay_keeps = None if keeps is None else iter(keeps)
    if plain:
        if tiles is not None:
            ops.select_tiles = lambda raw, keep, **kw: next(replay)
    else:
        if tiles is not None:
            def record(raw, keep, **kw):
                tiles.append(real["select_tiles"](raw, keep, **kw))
                return tiles[-1]
            ops.select_tiles = record
        if keeps is not None:
            def record_keep(*args, **kw):
                got = real_forward(*args, **kw)
                if kw.get("with_keep"):
                    keeps.append(got[-1])
                return got
            ksufa._forward = record_keep
    gates = []
    if routes is None:
        routing = contextlib.nullcontext()
    elif plain:
        routing = forced_routing(torch.stack(routes, dim=1), len(routes),
                                 None, [])
    else:
        routing = recorded_gates(routes)
    try:
        with routing, (recorded_gates(gates) if plain and routes is not None
                       else contextlib.nullcontext()), \
                (plain_attention(replay_keeps) if plain
                 else contextlib.nullcontext()):
            (loss, metrics), grads = grad_fn(params, cfg, batch)
    finally:
        for name, fn in real.items():
            setattr(ops, name, fn)
        ksufa._forward = real_forward
    if plain and routes is not None and not (
            len(gates) == len(routes)
            and all(torch.equal(a, b) for a, b in zip(gates, routes))):
        raise SystemExit("training step: the plain run did not route as the "
                         "kernel run did")
    for left in (replay, replay_keeps):
        if plain and left is not None and next(left, None) is not None:
            raise SystemExit("training step: the plain run made fewer STAR "
                             "calls than the kernel run")
    return loss, metrics, grads


def check_model_step(cfg, dev, gen, *, layers=RESTART_LAYERS, seq=TRAIN_SEQ,
                     batch=2, tag=None, gate: bool = True) -> dict:
    """Phase 20d: one training step's loss and gradients at ``layers``
    layers, ``batch`` x ``seq`` tokens, with K4 and its backward, held
    against the same step on the plain path in fp32 (``flash_ref`` under
    autograd, fp32 weights and activations): the loss and the global grad
    norm within 2e-2 relative, and every leaf no further from the fp32
    gradient than twice the bf16 plain path's (plus 1e-5), phase 20a's
    rule at model level. With ``star_train`` (phase 21d) the plain runs,
    fp32 and bf16, take the kernel run's tile ids call by call (an fp32
    selection rounds its estimates apart and may keep other tiles, a
    different function), with the element mask also K3's keep bits
    (phase 21e; phase 21f at tiles of 16), and the recompute's selection
    under remat must be the forward's. With MoE layers (phase 23) the
    plain runs route as the kernel run routed (``model_grads(routes=)``).
    A hybrid's pattern is cut with its layers (``cut_layers``). With
    ``gate`` False (phase 23's families that launch no kernel, where the
    kernel run is the bf16 plain run) the loss and grad norm are reported
    against the fp32 plain step and nothing is held. On the card the bf16
    gradients wait on the host while the fp32 step runs where the fp32
    parameters and gradients (8 bytes a parameter) and a second bf16
    gradient tree do not fit in the memory free beside the first
    (Grok-1's layer; ``offload`` on the line). ``launches``: the kernel
    run's, its one step's. ``tag`` names the phase's line."""
    star = star_trained(cfg)
    tiles = [] if star else None
    keeps = [] if star and cfg.star.elementwise else None
    tag = tag or ("star_training_step" if star else "training_step")
    reduced = {"n_layers": f"{layers} of {cfg.n_layers}"}
    cfg = cut_layers(cfg, layers)
    routes = [] if moe_layers(cfg) else None
    params, _ = init_params(cfg, gen, dev)
    data = SyntheticLM(vocab=cfg.vocab, seq=seq, global_batch=batch).batch(0)
    bt = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    replay = dict(tiles=tiles, keeps=keeps, routes=routes)
    kernels.reset_launches()
    loss, metrics, g = model_grads(params, cfg, bt, plain=False, **replay)
    launches = launched()
    gn = float(adamw.global_norm(g))
    offload = torch.device(dev).type == "cuda" and 10 * sum(
        t.numel() for t in tree_leaves(params)) > free_card_bytes(dev)
    park = (lambda t: t.cpu()) if offload else (lambda t: t)
    g = tree_map(park, g)
    if gate:
        loss_lp, _, g_lp = model_grads(params, cfg, bt, plain=True, **replay)
        g_lp = tree_map(park, g_lp)
    p32 = tree_map(lambda t: t.float(), params)
    del params
    loss32, _, g32 = model_grads(p32, cfg32, bt, plain=True, **replay)
    del p32
    gn32 = float(adamw.global_norm(g32))
    out = {"arch": cfg.name, "reduced": reduced, "seq": seq,
           "batch": batch, "optimizer": cfg.optimizer,
           "star": dataclasses.asdict(cfg.star) if star else None,
           "launches": launches, "held": gate,
           "loss": float(loss), "aux": float(metrics["aux"]),
           "loss_fp32_plain": float(loss32),
           "loss_bf16_plain": float(loss_lp) if gate else None,
           "grad_norm": gn, "grad_norm_fp32_plain": gn32,
           "gate_calls": len(routes) if routes is not None else None,
           "offload": offload}
    out["loss_rel_err"] = abs(out["loss"] - out["loss_fp32_plain"]) / abs(
        out["loss_fp32_plain"])
    out["grad_norm_rel_err"] = abs(gn - gn32) / gn32
    if keeps is not None:
        # the keys the element mask kept of those its tiles made visible
        kept = visible = 0
        for (ids, ok), bits in zip(tiles, keeps):
            rows = torch.empty((ids.shape[0], seq, 1), device=ids.device)
            kept += int(ksufa.unpack_keep_bits(bits,
                                               cfg.star.block_kv).sum())
            visible += int(ksufa.gather_selected(
                rows, rows, ids, ok, t=seq, block_q=cfg.star.block_q,
                block_kv=cfg.star.block_kv, causal=cfg.causal)[2].sum())
        out.update(kept_pairs=kept, visible_pairs=visible)
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
    if not gate:
        emit(tag, **out)
        del g, g32
        free_cache(dev)
        return out
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
    del g, g32, g_lp
    free_cache(dev)
    return out


# -- phase 21: STAR in training -----------------------------------------------

def selection_mask(idx, valid, *, t: int, s: int, block_q: int,
                   block_kv: int, causal: bool, keep_bits=None
                   ) -> torch.Tensor:
    """The dense [BH, T, S] boolean mask of the keys K3 sees under a
    selection: each valid selected tile, causal at offset S - T, cut by
    the forward's ``keep_bits`` (the element mask) where given."""
    bh, n_qt, keep = idx.shape
    n_kt = s // block_kv
    rows = torch.empty((bh, s, 1), device=idx.device)
    _, _, mask = ksufa.gather_selected(rows, rows, idx, valid, t=t,
                                       block_q=block_q, block_kv=block_kv,
                                       causal=causal)
    if keep_bits is not None:
        mask &= ksufa.unpack_keep_bits(keep_bits, block_kv)
    dense = torch.zeros((bh, n_qt, n_kt, block_q, block_kv),
                        dtype=torch.bool, device=idx.device)
    heads = torch.arange(bh, device=idx.device)[:, None]
    qts = torch.arange(n_qt, device=idx.device)[None, :]
    for j in range(keep):
        dense[heads, qts, idx[..., j]] |= mask[:, :, j]
    return dense.permute(0, 1, 3, 2, 4).reshape(bh, t, s)


def keep_bits_vs_sphere(q, k, idx, valid, bits, *, block_q: int,
                        block_kv: int, causal: bool, scale: float,
                        radius: float) -> dict:
    """The forward's keep bits against ``sufa.sphere_mask``'s on the same
    inputs, its estimates an fp32-summed bf16 product (the kernel's
    arithmetic up to the order of that sum): the pairs kept and visible,
    the pairs where the two differ, the largest gap of such a pair's
    estimate from its row's edge bf16(max - radius) in bf16 steps of the
    edge, and the kept pairs outside the validity x causal mask."""
    bh, t, d = q.shape
    kg, _, visible = ksufa.gather_selected(k, k, idx, valid, t=t,
                                           block_q=block_q, block_kv=block_kv,
                                           causal=causal)
    qt = q.reshape(bh, t // block_q, block_q, d)
    with fp32_summed_bf16_gemms():
        est = torch.einsum("bqtd,bqjcd->bqjtc", qt,
                           ksufa.pow2_quantize(kg)) * scale
    del kg
    est = est.masked_fill(~visible, kref.NEG_INF)
    edge = est.amax(dim=(2, 4), keepdim=True) - radius
    got = ksufa.unpack_keep_bits(bits, block_kv)
    differ = got != (visible & (est >= edge))
    gap = ((est.float() - edge.float()).abs()
           / bf16_step(edge.float()))[differ]
    return {"kept_pairs": int(got.sum()), "visible_pairs": int(visible.sum()),
            "pairs_differ_from_sphere_mask": int(differ.sum()),
            "max_gap_steps": float(gap.max()) if gap.numel() else 0.0,
            "outside_visible": int((got & ~visible).sum())}


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
                   edges=False, all_choosers=False, block=128,
                   block_kv=None, elementwise=False, star=None,
                   plain_iters=None) -> dict:
    """Phase 21a: K3's lse and backward on the glue's selection (K2, then
    ``ops.select_tiles`` keeping as many tiles as olmo_1b's STAR config,
    or ``star``'s where given: phase 25a's Nemotron-4-340B)
    at tiles ``block`` x ``block_kv`` (square unless given).
    K3's forward, strict and fast, must give the same O bits with and
    without lse (and, with ``elementwise``, its keep bits), and its lse
    the plain version's at 1e-4; the backward
    of each forward's o and lse (one function) must meet
    ``gradient_rule`` against the fp32 plain gradient (``sufa_bwd_ref``
    on fp32 copies, the fp32 strict forward's o and lse), the bf16
    yardstick being autograd through the bf16 plain form under the
    selection's dense mask, and two calls must give the same bits, every
    launch in the form the tiles pick (``launch.tile_form``: ``wgmma`` at
    128 x 128, ``mma_sync`` otherwise). With ``elementwise`` (the
    config's radius) the forward's keep bits must be the same in both
    modes, every pair where they differ from ``sphere_mask``'s on the same
    inputs must lie within one bf16 step of its row's edge
    (``keep_bits_vs_sphere``), and the backward, its fp32 plain version
    and the dense mask all take the kernel's bits; each backward launch
    also counts as ``sufa_bwd/elementwise``. With ``edges``: invalid
    slots, a key tile
    of head 0 that no q-tile chose (dK = dV = 0 exactly) and a q-tile of
    head 1 with no valid slot (dQ = 0 exactly, its lse +inf). With
    ``all_choosers``: key tile 0 in a slot of every q-tile of head 0
    (the dK/dV pass's longest walk; no slot names a tile twice, so the
    dense mask stays the yardstick's). Timed: the kernel, its plain
    version, its bound (10·d flops per visible selected pair, or its
    bytes; the keep bits' bytes counted; the plain version over 5 calls in
    the ``mma_sync`` form, ``plain_iters`` where given) and SDPA's
    backward under the dense mask (``autograd.grad`` on a retained
    graph), and the split of the form's kernels (each traced at least
    once)."""
    block_q, block_kv = block, block_kv or block
    q, k, v = prefill_inputs(bh, t, d, seed, dev)
    if s != t:
        _, k, v = prefill_inputs(bh, s, d, seed + 1, dev)
    gen = torch.Generator(device="cpu").manual_seed(seed + 2)
    do = torch.randn((bh, t, d), generator=gen).to(dev, torch.bfloat16)
    scale = d ** -0.5
    star = star or olmo_1b.config().star
    keep = dataclasses.replace(star, block_q=block_q,
                               block_kv=block_kv).keep_blocks(s)
    raw = kdlzs.dlzs_block_scores(q, k, causal=causal, scale=1.0,
                                  block_q=block_q, block_kv=block_kv)
    idx, valid = ops.select_tiles(raw, keep, scale=scale, radius=star.radius,
                                  dtype=q.dtype)
    form = launch.tile_form(block_q, block_kv)
    case = dict(kernel="sufa_bwd", BH=bh, T=t, S=s, d=d, block_q=block_q,
                block_kv=block_kv, keep=keep, causal=causal, edges=edges,
                all_choosers=all_choosers, elementwise=elementwise,
                form=form)
    if all_choosers:
        named = ((idx[0] == 0) & valid[0]).any(dim=-1)
        idx[0, ~named, -1] = 0
        valid[0, ~named, -1] = True
        case["key_tile_0_choosers"] = int(((idx[0] == 0) & valid[0]).any(
            dim=-1).sum())
    if edges:
        unchosen = int(idx[0, -1, 0])
        valid[0] &= idx[0] != unchosen
        valid[:, :, -1] = False
        valid[1, -1] = False
        case.update(unchosen_key_tile=unchosen,
                    empty_q_tile=t // block_q - 1)
    case["valid_slots"] = int(valid.sum())
    kw = dict(block_q=block_q, block_kv=block_kv, causal=causal, scale=scale)
    if elementwise:
        kw.update(elementwise=True, radius=star.radius)
    fwd, lse_err, bits = {}, {}, {}
    for strict in (True, False):
        o, lse, *kb = ksufa.sufa_attention(q, k, v, idx, valid, strict=strict,
                                           return_lse=True,
                                           return_keep=elementwise, **kw)
        plain_o = ksufa.sufa_attention(q, k, v, idx, valid, strict=strict,
                                       **kw)
        if not torch.equal(o.view(torch.int16), plain_o.view(torch.int16)):
            raise SystemExit(f"sufa {case}: K3's O changes when lse (and the "
                             f"keep bits) are asked for (strict={strict})")
        if elementwise:
            o_lse = ksufa.sufa_attention(q, k, v, idx, valid, strict=strict,
                                         return_lse=True, **kw)
            if not (torch.equal(o_lse[0].view(torch.int16),
                                plain_o.view(torch.int16))
                    and torch.equal(o_lse[1], lse)):
                raise SystemExit(f"sufa {case}: K3's O or lse changes when "
                                 f"the keep bits are asked for "
                                 f"(strict={strict})")
            bits[strict] = kb[0]
        _, plain_lse = ksufa.sufa_reference(
            q, k, v, idx, valid, strict=strict, return_lse=True,
            keep_bits=kb[0] if kb else None, **kw)
        lse_err[strict] = lse_held("sufa_lse", lse, plain_lse, strict=strict,
                                   **case)["max_abs_err"]
        fwd[strict] = (o, lse)
    keep_bits = None
    if elementwise:
        keep_bits = bits[True]
        if not torch.equal(keep_bits, bits[False]):
            raise SystemExit(f"sufa {case}: the strict and the fast forward "
                             f"kept other keys")
        audit = keep_bits_vs_sphere(q, k, idx, valid, keep_bits,
                                    block_q=block_q, block_kv=block_kv,
                                    causal=causal, scale=scale,
                                    radius=star.radius)
        case.update(audit)
        if audit["outside_visible"] or audit["max_gap_steps"] > 1.0:
            emit("sufa_bwd", ok=False, **case)
            raise SystemExit(f"sufa {case}: the forward's keep bits differ "
                             f"from sphere_mask's away from the edge")
    f32 = [x.float() for x in (q, k, v)]
    o32, lse32 = ksufa.sufa_reference(*f32, idx, valid, strict=True,
                                      return_lse=True, keep_bits=keep_bits,
                                      **kw)
    names = ("dq", "dk", "dv")
    want = dict(zip(names, ksufa.sufa_bwd_ref(*f32, idx, valid, o32, lse32,
                                             do.float(), keep_bits=keep_bits,
                                             **kw)))
    del f32, o32, lse32
    dense = selection_mask(idx, valid, t=t, s=s, block_q=block_q,
                           block_kv=block_kv, causal=causal,
                           keep_bits=keep_bits)
    lowp = dict(zip(names, grads_of(functools.partial(
        plain_masked_lowp, dense=dense, scale=scale), q, k, v, do)))
    modes = {}
    before = launched()
    for strict in (True, False):
        o, lse = fwd[strict]
        got = dict(zip(names, ksufa.sufa_bwd(q, k, v, idx, valid, o, lse,
                                             do, keep_bits=keep_bits, **kw)))
        again = ksufa.sufa_bwd(q, k, v, idx, valid, o, lse, do,
                               keep_bits=keep_bits, **kw)
        res = gradient_rule("sufa_bwd", got, want, lowp, strict=strict,
                            **case)
        res["two_calls_bit_equal"] = all(
            torch.equal(a.view(torch.int16), got[n].view(torch.int16))
            for a, n in zip(again, names))
        if not res["two_calls_bit_equal"]:
            raise SystemExit(f"sufa_bwd {case}: two calls differ")
        if edges:
            tile = slice(unchosen * block_kv, (unchosen + 1) * block_kv)
            res["unchosen_dk_dv_zero"] = not (got["dk"][0, tile].any()
                                              or got["dv"][0, tile].any())
            res["empty_q_tile_dq_zero"] = not got["dq"][1, t - block_q:].any()
            if not (res["unchosen_dk_dv_zero"]
                    and res["empty_q_tile_dq_zero"]):
                raise SystemExit(f"sufa_bwd {case}: an unchosen key tile or "
                                 f"an empty q-tile has a gradient: {res}")
        res["lse_max_abs_err"] = lse_err[strict]
        modes[strict] = res
    on_card = torch.device(dev).type == "cuda"
    kinds = ("wgmma", "mma_sync", "elementwise")
    calls = {f"sufa_bwd/{f}": launched()[f"sufa_bwd/{f}"]
             - before[f"sufa_bwd/{f}"] for f in kinds}
    if calls != {f"sufa_bwd/{f}": 4 * (on_card and (
            f == form or (f == "elementwise" and elementwise)))
                 for f in kinds}:
        raise SystemExit(f"sufa_bwd {case}: launches by form {calls}, not "
                         f"4 in the {form} form")
    out = dict(modes[True])
    out["form_launches"] = calls
    out["fast"] = {key: modes[False][key] for key in (
        "max_abs_err", "lse_max_abs_err", "two_calls_bit_equal")}
    del want, lowp
    if timed:
        o, lse = fwd[True]

        def kernel():
            ksufa.sufa_bwd(q, k, v, idx, valid, o, lse, do,
                           keep_bits=keep_bits, **kw)

        def plain():
            ksufa.sufa_bwd_ref(q, k, v, idx, valid, o, lse, do,
                               keep_bits=keep_bits, **kw)
        leaves = [x.detach()[None].requires_grad_() for x in (q, k, v)]
        with torch.enable_grad():
            sdpa_out = SDPA(*leaves, attn_mask=dense[None], scale=scale)

        def library():
            torch.autograd.grad(sdpa_out, leaves, do[None],
                                retain_graph=True)
        # the pairs the gradient needs: each kept (query, key) pair, the
        # element mask's bits applied where it is on
        pairs = int(dense.sum()) if elementwise else selected_pairs(
            idx, valid, t=t, s=s, block_q=block_q, block_kv=block_kv,
            causal=causal)
        extra = () if keep_bits is None else (keep_bits,)
        # the plain version's scatter is a Python loop over every (q-tile,
        # slot): 0.64 s a call at tiles of 16, so 5 calls of it there
        add_times(out, kernel, plain, library, flush,
                  bytes_=nbytes(q, k, v, o, do, q, k, v, lse, idx, valid,
                                *extra),
                  flops=10 * d * pairs, plain_iters=plain_iters or (
                      50 if form == "wgmma" else 5))
        parts = SUFA_BWD_MMA_KERNELS if form == "mma_sync" else (
            SUFA_BWD_KERNELS_D192 if d == 192 else SUFA_BWD_KERNELS)
        out.update(flash_bwd_split(kernel, flush, parts=parts))
        if not all(out[f"{part}_launches_traced"] for part in parts):
            raise SystemExit(f"sufa_bwd {case}: the trace holds no "
                             f"launch of one of {parts}: {out}")
        out["selected_pairs"] = pairs
        out["dense_causal_pairs"] = bh * visible_pairs(t, s, causal)
        out["tflop_s_10d"] = 10 * d * pairs / out["ms"] / 1e9
        del sdpa_out, leaves
    emit("sufa_bwd", ok=True, **out)
    return out


# phase 21a's mma.sync cases: every kind of small and mixed tiling, both
# head dims, causal or not, with and without the element mask
MMA_BWD_TILES = ((16, 16), (32, 32), (48, 48), (16, 64), (64, 16))
MMA_BWD_SHAPE = dict(bh=4, t=768, s=768)   # 768: a multiple of 48 and 64


def check_sufa_bwd_shapes(dev, ptxas=()) -> dict:
    """Phase 21a's shapes, in the wgmma form (tiles of 128): OLMo-1B's
    training shape (BH 128, T = S = 2048, d 128, causal, keep 4 of 16),
    timed, and again with the element mask (phase 21e's), timed;
    SeamlessM4T's encoder (BH 16, T = S = 2048, d 64, not causal), timed;
    T 256 over S 2048, causal; the edges at BH 16, T = S = 1024, without
    and with the element mask; key tile 0 chosen by every q-tile of a
    head (BH 16, T = S = 2048). In the mma_sync form: tiles of 64, BH 16,
    T = S = 1024, d 128, causal, with the edges; each tiling of
    ``MMA_BWD_TILES`` at d 64 and 128, causal (with the edges) and not,
    without and with the element mask, at ``MMA_BWD_SHAPE``; tiles of 16
    and 32 at the training shape, timed (16 also with the element mask,
    phase 21f's). K3's forward at the training shape, timed.
    ``ptxas``: the register and spill lines of K3's forward and backward
    from the build log, emitted beside them."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    train = dict(bh=TRAIN_BATCH * 16, t=TRAIN_SEQ, s=TRAIN_SEQ, d=128,
                 causal=True)
    out = {"train": check_sufa_bwd(dev, flush, seed=2101, timed=True,
                                   **train),
           "train_elementwise": check_sufa_bwd(dev, flush, seed=2108,
                                               timed=True, elementwise=True,
                                               **train),
           "encoder": check_sufa_bwd(dev, flush, bh=16, t=2048, s=2048, d=64,
                                     causal=False, seed=2102, timed=True),
           "t256": check_sufa_bwd(dev, flush, bh=16, t=256, s=2048, d=128,
                                  causal=True, seed=2103, timed=False),
           "edges": check_sufa_bwd(dev, flush, bh=16, t=1024, s=1024, d=128,
                                   causal=True, seed=2104, timed=False,
                                   edges=True),
           "edges_elementwise": check_sufa_bwd(
               dev, flush, bh=16, t=1024, s=1024, d=128, causal=True,
               seed=2109, timed=False, edges=True, elementwise=True),
           "all_choosers": check_sufa_bwd(dev, flush, bh=16, t=2048, s=2048,
                                          d=128, causal=True, seed=2105,
                                          timed=False, all_choosers=True),
           "mma_sync": check_sufa_bwd(dev, flush, bh=16, t=1024, s=1024,
                                      d=128, causal=True, seed=2106,
                                      timed=False, edges=True, block=64)}
    seed = 2200
    for bq, bk in MMA_BWD_TILES:
        for d in (64, 128):
            for causal in (True, False):
                for elem in (False, True):
                    seed += 1
                    out[f"mma_{bq}x{bk}_d{d}_{'causal' if causal else 'full'}"
                        f"{'_elementwise' if elem else ''}"] = check_sufa_bwd(
                        dev, flush, d=d, causal=causal, seed=seed,
                        timed=False, edges=causal, block=bq, block_kv=bk,
                        elementwise=elem, **MMA_BWD_SHAPE)
    for block, elem in ((16, False), (32, False), (16, True)):
        out[f"train_tiles{block}{'_elementwise' if elem else ''}"] = \
            check_sufa_bwd(dev, flush, seed=2110 + block + elem, timed=True,
                           block=block, elementwise=elem, **train)
    # K3's forward at the training shape, timed (phase 21b launches it
    # twice per layer and step: the forward and its remat recompute)
    out["forward_train"] = check_sufa(dev, flush, bh=TRAIN_BATCH * 16,
                                      t=TRAIN_SEQ, block=128, strict=True,
                                      seed=2107, timed=True)
    emit("sufa_bwd_build", ptxas=[f"{fn} {line}" for fn, line in ptxas])
    del flush
    free_cache(dev)
    return out


def elementwise_star(cfg):
    """``cfg`` with the element-level sphere mask on (STARConfig(
    top_k_ratio=0.2, elementwise=True): tiles 128, radius 5)."""
    return dataclasses.replace(cfg, star=dataclasses.replace(
        cfg.star, elementwise=True))


SMALL_TILE = 16     # phase 21f: the smallest tile K3 takes


def check_small_tiles(cfg, dev, gen, *, tile: int = SMALL_TILE,
                      layers: int = RESTART_LAYERS, seq: int = TRAIN_SEQ,
                      batch: int = 2) -> dict:
    """Phase 21f: ``cfg`` (OLMo-1B with ``star_train``) at its published
    width, cut to ``layers`` layers, STAR at tiles of ``tile`` (keep
    ceil(0.2 x S / tile)), one step of ``batch`` x ``seq`` tokens held to
    21d's rule (``check_model_step``), once without and once with the
    element mask; its kernel run launches K3's backward once per layer,
    every launch in the ``mma_sync`` form (and ``elementwise`` with the
    mask), K4 never."""
    small = dataclasses.replace(cfg, star=dataclasses.replace(
        cfg.star, block_q=tile, block_kv=tile))
    out = {}
    for name, c in (("tiles", small), ("elementwise", elementwise_star(
            small))):
        step = check_model_step(c, dev, gen, layers=layers, seq=seq,
                                batch=batch,
                                tag=f"star_training_step_tiles{tile}_"
                                    f"{name}")
        got, n = step["launches"], attn_layers(dataclasses.replace(
            c, n_layers=layers))
        on_card = torch.device(dev).type == "cuda"
        want = {"sufa_bwd": n, "sufa_bwd/mma_sync": n, "sufa_bwd/wgmma": 0,
                "sufa_bwd/elementwise": n * c.star.elementwise,
                "sufa": 2 * n, "dlzs_block": 2 * n, "flash": 0,
                "flash_bwd": 0}
        want = {k: v * on_card for k, v in want.items()}
        if {k: got[k] for k in want} != want:
            raise SystemExit(f"phase 21f ({name}): launches {got}; expected "
                             f"{want}")
        out[name] = step
    return out


# -- phase 22: the example twins ---------------------------------------------

EXAMPLE_TRAIN_STEPS = 60     # the JAX script's 300, cut for the time limit
QUICKSTART_TOL = 1e-4        # the card's numbers against its CPU run
RING_TOL = 1e-4              # DRAttention against dense attention, fp32


def load_example(name: str, folder: str = "examples"):
    """``<folder>/torch_<name>.py`` of this checkout, as a module."""
    path = ROOT / folder / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def counted_calls(owner, name: str, tally: dict):
    """Count the calls of ``owner.name`` (a class's method or a module's
    function) that return into ``tally[name]`` while the block runs: a
    decode step that raises ``NeedPages`` under pool pressure does so
    before it launches anything."""
    real = getattr(owner, name)

    def counted(*args, **kw):
        out = real(*args, **kw)
        tally[name] += 1
        return out
    setattr(owner, name, counted)
    try:
        yield
    finally:
        setattr(owner, name, real)


@contextlib.contextmanager
def recorded_losses(losses: list):
    """Record every training step's loss of a ``make_train_step`` made
    while the block runs."""
    real = launch_steps.make_train_step

    def make(*args, **kw):
        step = real(*args, **kw)

        def recorded(params, opt_state, batch):
            params, opt_state, metrics = step(params, opt_state, batch)
            losses.append(float(metrics["loss"]))
            return params, opt_state, metrics
        return recorded
    launch_steps.make_train_step = make
    try:
        yield
    finally:
        launch_steps.make_train_step = real


def run_example(name: str, dev, argv: list, expected, *,
                backend=None) -> dict:
    """``main(argv)`` of one twin on ``dev`` from a zero launch count,
    with the decode ticks of ``backend`` (a backend class) and the
    ``lm.prefill`` calls counted; ``expected(calls)`` gives every
    kernel's and form's launches on the card (0 unless named; all 0 off
    the card, where the plain versions run). Fails unless the launches
    equal them."""
    on_card = torch.device(dev).type == "cuda"
    mod = load_example(name)
    calls = {"decode_step": 0, "prefill": 0}
    kernels.reset_launches()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(counted_calls(lm, "prefill", calls))
        if backend is not None:
            stack.enter_context(counted_calls(backend, "decode_step", calls))
        out = mod.main(argv + ["--device", torch.device(dev).type])
    sync(dev)
    seconds = time.perf_counter() - t0
    got = launched()
    want = {key: 0 for key in got}
    if on_card:
        want.update(expected(calls))
    out = {key: val for key, val in out.items() if key != "outputs"}
    out.update(seconds=seconds, calls=calls,
               launches={k: v for k, v in got.items() if v},
               expected_launches={k: v for k, v in want.items() if v})
    if got != want:
        raise SystemExit(f"example {name}: launches {got}; expected "
                         f"{want}")
    return out


def check_examples(dev, train_steps: int = EXAMPLE_TRAIN_STEPS) -> dict:
    """Phase 22: each example twin's ``main`` on the card at the JAX
    example's sizes (train_star_lm cut to ``train_steps`` steps), its
    numbers held and its launches counted."""
    t0 = time.perf_counter()
    out = {}
    qs = run_example("quickstart", dev, [], lambda c: {})
    cpu = load_example("quickstart").main(["--device", "cpu"])
    qs.update({f"{key}_cpu": cpu[key] for key in ("rel_err", "reduction")})
    out["quickstart"] = qs
    emit("example_quickstart", **qs)
    if max(abs(qs["rel_err"] - cpu["rel_err"]),
           abs(qs["reduction"] - cpu["reduction"])) > QUICKSTART_TOL:
        raise SystemExit(f"quickstart: card {qs['rel_err']}, "
                         f"{qs['reduction']}; CPU {cpu['rel_err']}, "
                         f"{cpu['reduction']}")

    layers = attn_layers(star_paper.smoke_config())
    ss = run_example(
        "serve_star", dev, [], lambda c: {
            "paged_decode": c["decode_step"] * layers,
            "paged_decode/fp": c["decode_step"] * layers,
            "dlzs_block": c["prefill"] * layers,
            "dlzs_block/mma_sync": c["prefill"] * layers,
            "sufa": c["prefill"] * layers,
            "sufa/mma_sync": c["prefill"] * layers},
        backend=PagedBackend)
    out["serve_star"] = ss
    emit("example_serve_star", **ss)
    if ss["requests"] != 10 or ss["shared_hits"] <= 0 \
            or not ss["calls"]["decode_step"]:
        raise SystemExit(f"serve_star: {ss['requests']} of 10 requests "
                         f"served, {ss['shared_hits']} prefix-share hits")

    losses = []
    ckpt = pathlib.Path(tempfile.mkdtemp(prefix="example_ckpt_",
                                         dir=BUILD_DIR))
    try:
        with recorded_losses(losses):
            tr = run_example(
                "train_star_lm", dev, ["--steps", str(train_steps),
                                  "--seq", "256", "--batch", "8", "--ckpt",
                                  str(ckpt)],
                lambda c: {"flash": train_steps * layers * 2,
                           "flash_bwd": train_steps * layers})
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    tr["loss"] = losses
    out["train_star_lm"] = tr
    emit("example_train_star_lm", **tr)
    if len(losses) != train_steps or not all(
            math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise SystemExit(f"train_star_lm: losses {losses}")

    sl_layers = olmo_1b.smoke_config().n_layers
    sl = run_example(
        "spatial_longctx", dev, [], lambda c: {
            "paged_decode_stats": c["decode_step"] * sl_layers,
            "paged_decode_stats/fp": c["decode_step"] * sl_layers,
            "flash": c["prefill"] * sl_layers},
        backend=SpatialBackend)
    out["spatial_longctx"] = sl
    emit("example_spatial_longctx", **sl)
    if not sl["refused"] or sl["requests"] != 4 \
            or not sl["calls"]["decode_step"]:
        raise SystemExit(f"spatial_longctx: {sl}")

    rd = run_example("spatial_ring_demo", dev, [], lambda c: {})
    out["spatial_ring_demo"] = rd
    emit("example_spatial_ring_demo", **rd)
    if not rd["max_abs_err"] <= RING_TOL or rd["link_conflicts"]:
        raise SystemExit(f"spatial_ring_demo: max |err| "
                         f"{rd['max_abs_err']}, {rd['link_conflicts']} "
                         f"link conflicts")
    out["seconds"] = time.perf_counter() - t0
    emit("examples", ok=True, seconds=out["seconds"])
    free_cache(dev)
    return out


# -- phase 23: training beyond OLMo-1B ---------------------------------------

FAMILY_STEPS = 12           # steps of each phase-23 training run
FAMILY_STEP_BATCH = 2       # rows of each phase-23 one-step gradient check


@dataclasses.dataclass(frozen=True)
class FamilyCase:
    """One phase-23 training run: the published config, the layers
    trained (its first, in the published order), the batch, the sequence,
    the base learning rate and ``reduced``, every cut with its reason.
    Widths are never cut."""
    cfg: object
    layers: int
    batch: int
    seq: int
    lr: float
    reduced: dict


XLSTM_CUT = (
    f"{XLSTM_TRAIN_SEQ} of {TRAIN_SEQ}, to keep phase 23 within its 240 s: "
    "on an H100 a step takes 33 s at 2048 tokens and 5-5.5 s at 512 (the "
    "sLSTM time loop's eager ops, three passes a step under remat); the "
    "case's 12 steps, profiled step and one-step check take about 68 s at "
    "256 and about twice that at 512, beside about 155 s for phase 23's "
    "other cases and Jamba's restart")
XLSTM_TRAIN_LAYERS = 4      # of 12: mLSTM, sLSTM, mLSTM, sLSTM
XLSTM_TRAIN_DEPTH_CUT = (
    "4 of 12 (the pattern's mLSTM, sLSTM pair twice), for the script's "
    "clock beside phase 27: on an H100 a step at 256 tokens a row takes "
    "3.78 s at 12 layers, 1.98 at 6 and 1.44 at 4 (the sLSTM loop's eager "
    "ops), so the case takes about 45 s less; in 12 steps at lr 3e-3 the "
    "loss falls 1.71 at 4 layers, 1.13 at 6 and 0.36 at 12")


# layers 0-1 measured on the H100 since the one gradient tree
# (tools/torch_family_probe.py jamba_1_5_large_398b@2 6e-4 12)
JAMBA_TRAIN_CUT = (
    "1 of 72, pattern[:1] (Mamba + dense FFN): layers 0-1 (the second "
    "Mamba + MoE) are 12.15 B parameters; with Adafactor x 8 and one "
    "gradient tree their first step's backward ran out of the card's "
    "memory: 66.0 GiB allocated and 73.4 GiB in use when the MoE "
    "experts' 6.0 GiB gradient leaf was asked for, a peak of at least "
    "77.3 GB")


def family_cases() -> dict:
    """Phase 23's training runs by arch. The learning rates come from short
    runs on the H100 (``tools/torch_family_probe.py``): at 6e-4 OLMoE's
    loss stays flat for 12 steps and xLSTM's falls by less than 0.1; at
    2e-3 Grok-1's and Jamba's diverge. xLSTM's sequence and depth are cut
    to keep its run (the sLSTM loop, and the profiler's record of every op
    in it) within the script's time (``XLSTM_CUT``,
    ``XLSTM_TRAIN_DEPTH_CUT``)."""
    grok = grok_1_314b.config()
    jamba = jamba_1_5_large_398b.config()
    xl = xlstm_125m.config()
    return {
        "olmoe_1b_7b": FamilyCase(olmoe_1b_7b.config(), 16, TRAIN_BATCH,
                                  TRAIN_SEQ, 2e-3, {}),
        "grok_1_314b": FamilyCase(grok, 1, TRAIN_BATCH, TRAIN_SEQ,
                                  TRAIN_LR, {
            "n_layers": f"1 of {grok.n_layers}: 2 layers are 11.45 B "
                        "parameters, 68.7 GB of bf16 params, grads and "
                        "accumulation buffer before activations"}),
        "jamba_1_5_large_398b": FamilyCase(jamba, 1, TRAIN_BATCH, TRAIN_SEQ,
                                           TRAIN_LR, {
            "n_layers": JAMBA_TRAIN_CUT}),
        "xlstm_125m": FamilyCase(xl, XLSTM_TRAIN_LAYERS, TRAIN_BATCH,
                                 XLSTM_TRAIN_SEQ, 3e-3, {
            "seq": XLSTM_CUT, "n_layers": XLSTM_TRAIN_DEPTH_CUT}),
    }


def check_family_k4(dev, shapes_: dict, timed: bool) -> dict:
    """Phase 23's K4 shapes held by phase 20a's rule before phase 23
    relies on them: ``shapes_`` name -> (BH, T), causal, d 128 (OLMoE's
    16 heads x batch; Grok-1's 48 query heads x its microbatch of 1, K/V
    expanded from 8 heads): K4's forward against its plain version, and
    its backward (``check_flash_bwd``), the backward timed where ``timed``
    and phase 20a has not timed the shape (OLMo-1B's BH 128, T 2048)."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev) \
        if timed else None
    out = {}
    for i, (name, (bh, t)) in enumerate(shapes_.items()):
        timed_in_20a = (bh, t) == (TRAIN_BATCH * 16, TRAIN_SEQ)
        out[name] = {
            "forward": check_flash(dev, flush, bh=bh, t=t, causal=True,
                                   seed=2301 + 2 * i, timed=False),
            "backward": check_flash_bwd(dev, flush, bh=bh, t=t, causal=True,
                                        seed=2302 + 2 * i,
                                        timed=timed and not timed_in_20a)}
    del flush
    free_cache(dev)
    return out


def state_gb(params, opt_state, cfg) -> dict:
    """The training state's reckoning in GB: bf16 params, a step's
    gradients (the same bytes), the optimizer's state and, with
    ``train_accum`` > 1, the accumulation buffer (``cfg.accum_dtype``).
    Where that buffer is in the parameters' dtype the step keeps one
    gradient tree (``launch.steps.accumulate_grad``): the gradients are
    then its largest leaf's, the one that may live beside the sum."""
    nb = lambda tree: sum(t.numel() * t.element_size()  # noqa: E731
                          for _, t in sorted_items(tree)) / 1e9
    out = {"params": nb(params), "grads": nb(params),
           "optimizer": nb(opt_state)}
    if cfg.train_accum > 1:
        out["accum_buffer"] = sum(
            t.numel() for t in tree_leaves(params)) * torch.tensor(
            [], dtype=cfg.accum_dtype).element_size() / 1e9
        if cfg.accum_dtype == cfg.dtype:
            out["grads"] = max(t.numel() * t.element_size()
                               for t in tree_leaves(params)) / 1e9
            out["grads_form"] = "one leaf beside the sum"
    out["total"] = sum(v for v in out.values() if isinstance(v, float))
    return out


def check_remat_policies(dev, gen, *, cfg=None, layers=RESTART_LAYERS,
                         seq=TRAIN_SEQ, batch=FAMILY_STEP_BATCH) -> dict:
    """Phase 23e: OLMo-1B at published width cut to ``layers`` layers, one
    step's loss and gradients (``launch.steps.value_and_grad``) under
    ``remat`` none and dots, each the same bits as under full
    (``tests/test_torch_train_smoke.py::test_remat_policies_give_equal_grads``
    on the CPU). K4 launches once per layer under none (no recompute),
    twice under full and dots (the selective policy saves only
    unbatched matmuls); its backward once per layer. ``cfg``: OLMo-1B
    unless given."""
    on_card = torch.device(dev).type == "cuda"
    cfg = cfg or olmo_1b.config()
    published = cfg.n_layers
    cfg = cut_layers(cfg, layers)
    params, _ = init_params(cfg, gen, dev)
    data = SyntheticLM(vocab=cfg.vocab, seq=seq, global_batch=batch).batch(0)
    bt = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
    runs, out = {}, {"arch": cfg.name, "seq": seq, "batch": batch,
                     "reduced": {"n_layers": f"{layers} of {published}"}}
    for remat in ("full", "none", "dots"):
        kernels.reset_launches()
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        (loss, _), g = launch_steps.value_and_grad(
            params, dataclasses.replace(cfg, remat=remat), bt)
        sync(dev)
        got = launched()
        want = {k: v * on_card for k, v in training_launches(
            dataclasses.replace(cfg, remat=remat), 1).items()}
        runs[remat] = (loss, g)
        out[remat] = {"loss": float(loss), "seconds": time.perf_counter() - t0,
                      "peak_memory_gb": (torch.cuda.max_memory_allocated(dev)
                                         / 1e9 if on_card else None),
                      "launches": {k: got[k] for k in want},
                      "expected_launches": want}
        if remat != "full":
            loss0, g0 = runs["full"]
            out[remat]["loss_bit_equal"] = torch.equal(loss, loss0)
            out[remat]["leaves_differ"] = [
                _key_path(p) for (p, a), (_, b) in zip(sorted_items(g),
                                                       sorted_items(g0))
                if not torch.equal(_bits(a), _bits(b))]
            out[remat]["leaves"] = len(tree_leaves(g))
    emit("remat_policies", **out)
    for remat in ("none", "dots"):
        case = out[remat]
        if not case["loss_bit_equal"] or case["leaves_differ"]:
            raise SystemExit(f"remat {remat}: loss or gradients differ from "
                             f"remat full's at {case['leaves_differ']}")
    for remat in runs:
        if out[remat]["launches"] != out[remat]["expected_launches"]:
            raise SystemExit(f"remat {remat}: launches {out[remat]}")
    del runs, params
    free_cache(dev)
    return out


def check_family_training(dev, gen, *, cases=None, steps=FAMILY_STEPS,
                          step_seq=TRAIN_SEQ, remat_cfg=None) -> dict:
    """Phase 23 (see the module docstring): K4 at the new training shapes
    (``check_family_k4``, timed where phase 20a has not timed the shape),
    then each of ``cases`` (``family_cases()``: OLMoE-1B-7B, Grok-1's
    layer, Jamba's layer 0, xLSTM-125M) trained ``steps`` steps by
    ``check_training`` with its config's optimizer, ``train_accum`` and
    ``remat``, and its one-step gradients by phase 20d's rule
    (``check_model_step``: an MoE model at 2 layers or fewer, Grok-1's
    with the bf16 gradients parked on the host, routed as the kernel run
    routed; a model that launches no kernel, Jamba's layer 0 and xLSTM,
    only reported, at ``step_seq`` tokens or fewer); then 23e, the remat
    policies (``check_remat_policies`` on ``remat_cfg``, OLMo-1B unless
    given). Jamba's restart runs in a child of its own during phase 1's
    build (``restart_children(..., "jamba")``)."""
    on_card = torch.device(dev).type == "cuda"
    cases = cases or family_cases()
    k4_shapes = {}
    for name, case in cases.items():
        if attn_layers(cut_layers(case.cfg, case.layers)):
            k4_shapes[name] = (case.batch // case.cfg.train_accum
                               * case.cfg.n_heads, case.seq)
    out = {"k4": check_family_k4(dev, k4_shapes, timed=on_card)}
    for name, case in cases.items():
        t0 = time.perf_counter()
        cut = cut_layers(case.cfg, case.layers)
        train = check_training(cut, dev, gen, steps=steps, seq=case.seq,
                               batch=case.batch, lr=case.lr, save=False,
                               tag="family_training", reduced=case.reduced)
        step = check_model_step(
            case.cfg, dev, gen, layers=min(case.layers, 2)
            if moe_layers(cut) else case.layers,
            seq=min(case.seq, step_seq), batch=FAMILY_STEP_BATCH,
            tag="family_training_step", gate=bool(attn_layers(cut)))
        out[name] = {"train": train, "step": step,
                     "seconds": time.perf_counter() - t0}
        emit("family_case", arch=name, seconds=out[name]["seconds"])
    out["remat"] = check_remat_policies(dev, gen, cfg=remat_cfg,
                                        seq=step_seq)
    return out


# -- phase 24: Nemotron-4-340B, head_dim 192 -----------------------------------

NEMOTRON_LAYERS = 4         # of 96: 23.25 B parameters, 46.5 GB in bf16
NEMOTRON_PROMPT = 2048
NEMOTRON_MAX_TOKENS = 16


def check_head_dim_192_kernels(dev, *, bh: int = 96, t: int = NEMOTRON_PROMPT,
                               probe_t: int = 1024,
                               kv: int = NEMOTRON_PROMPT + NEMOTRON_MAX_TOKENS,
                               seed: int = 240) -> dict:
    """Phase 24a: every kernel of Nemotron-4-340B's path at its shapes,
    against its plain version on the card with two calls bit-equal, and
    timed there beside its bound, its plain version's time and one PyTorch
    call's: K1 at (192, 12) in its four lanes (fp and int8, normalised and
    the (m, l, o) form over 4 shards) at B 1, G 8, W covering a ``kv``-row
    sequence; K2, K3 (strict and fast; the element mask in both forms)
    and K4 at BH ``bh`` (96 heads, K/V expanded from 8), T = S = ``t``,
    d 192; the mma.sync forms also at the pool probe's tiles of 16 and at
    tiles of 64 (T ``probe_t``), K4 also at the ragged T = S = ``kv`` of
    the exactness oracle's forward."""
    on_card = torch.device(dev).type == "cuda"
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev) \
        if on_card else None
    d = 192
    w = -(-kv // 16) + 1
    out = {"k1": {form: check(dev, f"nemotron_decode_{form}", b=1, g=8,
                              r=12, d=d, page=16, w=w, p=w + 128,
                              kv_len=(kv,), seed=seed, timed=on_card)
                  for form, check in (("fp", check_paged_kernel),
                                      ("int8", check_paged_int8))}}
    sw = -(-w // SPATIAL_SHARDS)
    out["k1_stats"] = {lane: check_paged_stats(
        dev, f"spatial_nemotron_{lane}", SPATIAL_SHARDS, b=1, g=8, r=12,
        d=d, page=16, w=sw, p=sw + 8, kv_len=(kv,), seed=seed + 1,
        timed=on_card, quant=lane == "int8") for lane in ("fp", "int8")}
    out["dlzs_block"] = check_dlzs(dev, flush, bh=bh, t=t, block=128,
                                   causal=True, seed=seed + 2,
                                   timed=on_card, d=d)
    check_dlzs(dev, flush, bh=bh, t=16, block=16, causal=True,
               seed=seed + 3, timed=False, d=d)
    check_dlzs(dev, flush, bh=bh, t=probe_t, block=64, causal=True,
               seed=seed + 4, timed=False, d=d)
    for strict in (True, False):
        name = "sufa" if strict else "sufa_fast"
        out[name] = check_sufa(dev, flush, bh=bh, t=t, block=128,
                               strict=strict, seed=seed + 5, timed=on_card,
                               d=d)
        out[f"{name}_elementwise"] = check_sufa(
            dev, flush, bh=bh, t=t, block=128, strict=strict, seed=seed + 6,
            timed=on_card, d=d, elementwise=True)
        check_sufa(dev, flush, bh=bh, t=16, block=16, strict=strict,
                   seed=seed + 7, timed=False, d=d)
        out[f"{name}_mma_sync"] = check_sufa(
            dev, flush, bh=bh, t=probe_t, block=64, strict=strict,
            seed=seed + 8, timed=on_card and strict, d=d)
        out[f"{name}_elementwise_mma_sync"] = check_sufa(
            dev, flush, bh=bh, t=probe_t, block=64, strict=strict,
            seed=seed + 9, timed=False, d=d, elementwise=True)
    out["flash"] = check_flash(dev, flush, bh=bh, t=t, causal=True,
                               seed=seed + 10, timed=on_card, d=d)
    out["flash_ragged"] = check_flash(dev, flush, bh=bh, t=kv, causal=True,
                                      seed=seed + 11, timed=False, d=d)
    del flush
    free_cache(dev)
    return out


def check_nemotron(cfg, dev, gen, *, layers=NEMOTRON_LAYERS,
                   prompt_len=NEMOTRON_PROMPT,
                   max_tokens=NEMOTRON_MAX_TOKENS, kernels_kw=None) -> dict:
    """Phase 24: Nemotron-4-340B (head_dim 192, 96 heads over 8 KV heads,
    squared ReLU, layernorm) at its published widths. (a) its kernels at
    its shapes (``check_head_dim_192_kernels``); (b) ``layers`` of its 96
    layers served through ``LLM.from_config(backend="paged")``, one
    ``prompt_len``-token prompt prefilled whole with STAR on: K1 = ticks x
    layers, K2 = K3 = prefill calls x layers, the first token against a
    cache-free STAR forward; (c) the same with ``star=None``: every token
    held by phase 4's rule against a K4 forward (``check_cut_config``).
    The card's peak memory is reported."""
    t0 = time.perf_counter()
    out = {"kernels": check_head_dim_192_kernels(dev, **(kernels_kw or {}))}
    out["kernels_s"] = time.perf_counter() - t0
    out["served"] = check_cut_config("nemotron_4_340b", cfg, dev, gen,
                                     layers=layers, prompt_len=prompt_len,
                                     max_tokens=max_tokens, exact_too=True)
    out["seconds"] = time.perf_counter() - t0
    emit("nemotron", layers=layers, reduced=f"n_layers {layers} of "
         f"{cfg.n_layers}", head_dim=cfg.dh, group=cfg.n_heads // cfg.n_kv,
         params=out["served"]["info"]["params"],
         peak_gb=out["served"]["info"]["peak_gb"],
         peak_gb_after_init=out["served"]["info"]["peak_gb_after_init"],
         kernels_s=out["kernels_s"], seconds=out["seconds"])
    return out


# -- phase 25: Nemotron-4-340B trained, head_dim 192 --------------------------

NEMOTRON_TRAIN_LAYERS = 1   # of 96: 12.89 B parameters with embedding and head
# from runs on the H100 (tools/torch_nemotron_train.py LR): at 6e-4 (phase
# 23's Adafactor rate) one update at 1.2e-4 lowers the loss by 0.8 and the
# run diverges from the update at 3.6e-4 (12.87 -> 33.2 by step 7)
NEMOTRON_TRAIN_LR = 1e-4
NEMOTRON_STEP_BATCH = 2     # rows of phase 25b's layer gradient
NEMOTRON_TRAIN_STEPS = 8    # of phase 23's 12
NEMOTRON_STEPS_CUT = (
    "8 of 12, for the script's clock beside phase 27: a step takes about "
    "3.13 s on an H100, so the two runs take about 25 s less; in 12-step "
    "runs there the loss fell 1.4 by step 4 and 1.17 by step 7")
NEMOTRON_TRAIN_CUT = (
    "1 of 96: the layer is 3.45 B parameters beside 9.44 B of untied "
    "embedding and head, 12.89 B in all: 25.8 GB of bf16 params and 25.8 "
    "GB of bf16 accumulation buffer, and the head's gradient summed over "
    "the CE chunks (two 9.4 GB trees at once) on top; 2 layers are 16.34 B "
    "parameters, 65.4 GB of params and buffer before that 18.9 GB, past "
    "the card's 80 GB")


def check_head_dim_192_backwards(dev, *, bh: int = 96,
                                 t: int = TRAIN_SEQ, seed: int = 250
                                 ) -> dict:
    """Phase 25a: K4's and K3's backwards at Nemotron-4-340B's training
    shape (one 2048-token row a microbatch x 96 heads, K/V expanded from
    8; T = S = ``t``, d 192, causal) against their plain versions by 20a's
    and 21a's rules (``check_flash_bwd``, ``check_sufa_bwd`` on the glue's
    selection at Nemotron's ``top_k_ratio``), two calls bit-equal: K4's
    timed beside SDPA's backward; K3's ``wgmma`` form (tiles 128) with and
    without the element mask, timed; its edges (invalid slots, an unchosen
    key tile, an empty q-tile) and a key tile every q-tile of a head
    chose; its ``mma_sync`` form at tiles of 64 (timed) and of 16 with
    the edges; each timed backward's kernels' device times from a profiler
    trace (``flash_bwd_split``)."""
    on_card = torch.device(dev).type == "cuda"
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev) \
        if on_card else None
    star = nemotron_4_340b.config().star
    d = 192
    out = {"flash_bwd": check_flash_bwd(dev, flush, bh=bh, t=t, causal=True,
                                        seed=seed, timed=on_card, d=d)}
    k3 = functools.partial(check_sufa_bwd, dev, flush, bh=bh, t=t, s=t, d=d,
                           causal=True, star=star)
    out["sufa_bwd"] = k3(seed=seed + 1, timed=on_card)
    out["sufa_bwd_elementwise"] = k3(seed=seed + 2, timed=on_card,
                                     elementwise=True)
    out["sufa_bwd_edges"] = k3(seed=seed + 3, timed=False, edges=True)
    out["sufa_bwd_all_choosers"] = k3(seed=seed + 4, timed=False,
                                      all_choosers=True)
    out["sufa_bwd_tiles64"] = k3(seed=seed + 5, timed=on_card, block=64)
    out["sufa_bwd_tiles16"] = k3(seed=seed + 6, timed=False, block=16,
                                 edges=True)
    del flush
    free_cache(dev)
    return out


def layer_value_and_grad(params, cfg, batch) -> tuple:
    """((loss, metrics), grads) of one decoder layer (``lm._block_apply``
    of ``cfg``'s first block in train mode) on ``batch["x"]`` [B, S, d]:
    the loss is sum(y · ``batch["dy"]``) in fp32, so the gradients are the
    layer's VJP of the upstream gradient dy; grads = {"layer": the
    parameters', "x": the input's}."""
    work = tree_map(lambda p: p.detach().requires_grad_(), params)
    x = batch["x"].detach().requires_grad_()
    leaves = tree_leaves(work)
    positions = torch.arange(x.shape[1], device=x.device)
    with torch.enable_grad():
        y, _, _ = lm._block_apply(work, cfg, cfg.pattern[0], x, positions,
                                  mode="train")
        loss = (y.float() * batch["dy"].float()).sum()
        *grads, dx = torch.autograd.grad(loss, leaves + [x])
    it = iter(grads)
    aux = torch.zeros((), device=x.device)
    return (loss.detach(), {"aux": aux}), {
        "layer": tree_map(lambda _: next(it), params), "x": dx}


def check_layer_grads(cfg, dev, gen, *, seq: int = TRAIN_SEQ,
                      batch: int = NEMOTRON_STEP_BATCH,
                      tag: str = "nemotron_layer_grads") -> dict:
    """Phase 25b: one of ``cfg``'s layers at its published width, its
    gradient by 20d's rule: ``layer_value_and_grad`` on a seeded [batch,
    seq, d_model] input and upstream gradient, with the kernels (K4 and
    its backward, or with ``star_train`` K2, K3 and K3's backward), then
    on the plain path in bf16 and in fp32 (``model_grads(plain=True)``,
    the STAR runs on the kernel run's tile ids); every parameter's and the
    input's gradient no further from the fp32 one than twice the bf16
    plain one is (plus 1e-5). A layer and not the model: the model's fp32
    plain step would not fit on the card."""
    star = star_trained(cfg)
    tiles = [] if star else None
    gen.manual_seed(SEED)
    blocks = lm._blocks_init(gen, cfg, cfg.pattern[:1], 1, dev)
    layer = lm._unbind_layers(blocks["b0"], 1)[0]
    bt = {"x": seeded_normal((batch, seq, cfg.d_model), SEED + 1, dev,
                             cfg.dtype),
          "dy": seeded_normal((batch, seq, cfg.d_model), SEED + 2, dev,
                              cfg.dtype)}
    run = functools.partial(model_grads, grad_fn=layer_value_and_grad,
                            tiles=tiles)
    kernels.reset_launches()
    _, _, g = run(layer, cfg, bt, plain=False)
    launches = launched()
    _, _, g_lp = run(layer, cfg, bt, plain=True)
    p32 = tree_map(lambda t: t.float(), layer)
    del blocks, layer
    _, _, g32 = run(p32, dataclasses.replace(cfg, dtype=torch.float32),
                    {k: v.float() for k, v in bt.items()}, plain=True)
    del p32
    names = [_key_path(p) for p, _ in sorted_items(g)]
    case = {"arch": cfg.name, "d_model": cfg.d_model, "head_dim": cfg.dh,
            "star_train": star, "seq": seq, "batch": batch,
            "layer_params": sum(t.numel() for t in tree_leaves(g["layer"])),
            "launches": launches,
            "star_calls": len(tiles) if star else None}
    leaves = gradient_rule(
        tag, dict(zip(names, (x for _, x in sorted_items(g)))),
        dict(zip(names, (x for _, x in sorted_items(g32)))),
        dict(zip(names, (x for _, x in sorted_items(g_lp)))), **case)
    case["leaves"] = {n: [leaves[f"max_abs_err_{n}"],
                          leaves[f"bf16_plain_err_{n}"]] for n in names}
    case["leaves_format"] = "[kernel path max error, bf16 plain path's]"
    case.update(max_abs_err=leaves["max_abs_err"],
                tolerance=leaves["tolerance"])
    emit(tag, **case)
    want = ({"dlzs_block": 1, "sufa": 1, "sufa_bwd": 1} if star
            else {"flash": 1, "flash_bwd": 1})
    if torch.device(dev).type != "cuda":   # the plain versions ran
        want = {k: 0 for k in launches}
    if {k: launches[k] for k in want} != want:
        raise SystemExit(f"{tag}: launches {launches}; expected {want}")
    del g, g_lp, g32
    free_cache(dev)
    return case


def check_nemotron_training(cfg, dev, gen, *, layers=NEMOTRON_TRAIN_LAYERS,
                            steps=NEMOTRON_TRAIN_STEPS, seq=TRAIN_SEQ,
                            batch=TRAIN_BATCH, lr=NEMOTRON_TRAIN_LR,
                            kernels_kw=None) -> dict:
    """Phase 25: Nemotron-4-340B trained at head_dim 192. (a) K4's and
    K3's backwards at its training shape
    (``check_head_dim_192_backwards``); (b) one layer's gradient at its
    published width, dense and with ``star_train``
    (``check_layer_grads``); (c) its published widths cut to ``layers``
    of 96 layers (``NEMOTRON_TRAIN_CUT``), trained ``steps`` steps
    (``NEMOTRON_STEPS_CUT``) of ``batch`` x ``seq`` tokens with its own
    Adafactor and ``train_accum``
    8 (``check_training``: the loss falls by > 0.1, every loss and grad
    norm finite, K4 = steps x 8 x 2 and its backward steps x 8), then the
    same with ``star_train`` (K2 = K3 = steps x 8 x 2, K3's backward in
    its ``wgmma`` form steps x 8, K4 0)."""
    t0 = time.perf_counter()
    out = {"kernels": check_head_dim_192_backwards(dev,
                                                   **(kernels_kw or {}))}
    star_cfg = dataclasses.replace(cfg, star_train=True)
    out["layer"] = {name: check_layer_grads(c, dev, gen, seq=seq)
                    for name, c in (("dense", cfg), ("star", star_cfg))}
    reduced = {"n_layers": NEMOTRON_TRAIN_CUT} if layers == 1 else {
        "n_layers": f"{layers} of {cfg.n_layers}"}
    if steps == NEMOTRON_TRAIN_STEPS:
        reduced["steps"] = NEMOTRON_STEPS_CUT
    for name, c in (("dense", cfg), ("star", star_cfg)):
        out[name] = check_training(cut_layers(c, layers), dev, gen,
                                   steps=steps, seq=seq, batch=batch, lr=lr,
                                   save=False, tag="nemotron_training",
                                   reduced=reduced)
    out["seconds"] = time.perf_counter() - t0
    emit("nemotron_trained", layers=layers, head_dim=cfg.dh,
         optimizer=cfg.optimizer, train_accum=cfg.train_accum,
         reduced=reduced, seconds=out["seconds"],
         peak_memory_gb={n: out[n]["peak_memory_gb"]
                         for n in ("dense", "star")},
         state_gb=out["dense"]["state_gb"],
         step_ms_median={n: out[n]["step_ms_median"]
                         for n in ("dense", "star")})
    return out


# -- phase 26: the serving smoke's twins --------------------------------------

# The kernel shapes the twins reach at OLMo-1B's width (G 16, R 1, d 128,
# pages of 16), recorded by wrapping the kernels' wrappers while phase 26
# runs on the CPU (tests/test_torch_smoke_serve.py holds the list): the
# normalised K1's (B, W), its (m, l, o) form's (B, W a shard) over 2
# shards, and K4's T at BH 16 (the dense backend's prompts, the pool
# probes' 16 tokens and the 26b rule's forwards). Phase 2 holds each
# before phase 26 launches it.
SERVE_TWIN_K1 = ((2, 3), (2, 4), (4, 2), (4, 4), (4, 8), (4, 64))
SERVE_TWIN_K1_STATS = ((2, 2), (2, 4), (2, 12), (4, 8))
SERVE_TWIN_K4 = (6, 9, 12, 16, 18, 21, 35, 38)
TWIN_AUDIT_EVERY = 4        # the reference bundle's AuditCfg(every_ticks=4)
TWIN_TAGS = ("basic", "spatial", "trace", "bundle", "bundle_disagg",
             "sparse")


def check_serve_twin_kernels(dev) -> dict:
    """Phase 2's part for phase 26: K1 (normalised) at each of
    ``SERVE_TWIN_K1``'s (B, W), its (m, l, o) form over 2 shards at each
    of ``SERVE_TWIN_K1_STATS``'s and K4 causal at BH 16 at each of
    ``SERVE_TWIN_K4``'s T, OLMo-1B's heads (G 16, R 1, d 128, pages of
    16), each against its plain version, two calls bit-equal, untimed;
    the rows run up to each table's capacity."""
    out = {"k1": [], "k1_stats": [], "k4": []}
    for i, (b, w) in enumerate(SERVE_TWIN_K1):
        kv = tuple(max(1, w * 16 - 7 * j) for j in range(b))
        out["k1"].append(check_paged_kernel(
            dev, f"serve_twin_b{b}_w{w}", b=b, g=16, r=1, d=128, page=16,
            w=w, p=max(64, 2 * w + 1), kv_len=kv, seed=260 + i,
            timed=False)["max_abs_err"])
    for i, (b, w) in enumerate(SERVE_TWIN_K1_STATS):
        kv = tuple(max(1, 2 * w * 16 - 9 * j) for j in range(b))
        out["k1_stats"].append(check_paged_stats(
            dev, f"serve_twin_stats_b{b}_w{w}", 2, b=b, g=16, r=1, d=128,
            page=16, w=w, p=max(32, w + 1), kv_len=kv, seed=270 + i,
            timed=False)["max_abs_err"])
    for i, t in enumerate(SERVE_TWIN_K4):
        out["k4"].append(check_flash(dev, None, bh=16, t=t, causal=True,
                                     seed=280 + i, timed=False)[
                                         "max_abs_err"])
    emit("serve_twin_kernels", k1_shapes=SERVE_TWIN_K1,
         k1_stats_shapes=SERVE_TWIN_K1_STATS, k4_t=SERVE_TWIN_K4,
         **{f"max_abs_err_{k}": max(v) for k, v in out.items()})
    return out


@contextlib.contextmanager
def counted_serving(calls: dict):
    """Within the block, count into ``calls`` what launches the serving
    kernels: the paged and the spatial backends' decode steps (class-level,
    every instance), the audit probes that ran (a probe that declines at a
    page boundary launches nothing) and the ``lm.prefill`` calls. The
    launch counts start at 0."""
    for key in ("paged", "spatial", "audit", "prefill"):
        calls[key] = 0
    real_audit = PagedBackend.audit_decode

    def audit(self, *args, **kw):
        report = real_audit(self, *args, **kw)
        calls["audit"] += report is not None
        return report
    tally = {"decode_step": 0, "prefill": 0}
    kernels.reset_launches()
    with contextlib.ExitStack() as stack:
        for name, backend in (("paged", PagedBackend),
                              ("spatial", SpatialBackend)):
            counts = {"decode_step": 0}
            stack.enter_context(counted_calls(backend, "decode_step",
                                              counts))
            stack.callback(lambda n=name, c=counts: calls.__setitem__(
                n, c["decode_step"]))
        stack.enter_context(counted_calls(lm, "prefill", tally))
        stack.callback(lambda: calls.__setitem__("prefill",
                                                 tally["prefill"]))
        PagedBackend.audit_decode = audit
        stack.callback(setattr, PagedBackend, "audit_decode", real_audit)
        yield calls


def serving_launches(calls: dict, cfg, on_card: bool) -> dict:
    """The launches ``calls`` give on the card: K1 (fp lane) once per layer
    of every paged decode step and audit probe, its (m, l, o) form once per
    layer of every spatial step, and per ``lm.prefill`` call K4 (dense)
    or K2 and K3 (STAR) once per layer; nothing else, and nothing off the
    card."""
    want = {key: 0 for key in launched()}
    if not on_card:
        return want
    layers = cfg.n_layers
    k1 = (calls["paged"] + calls["audit"]) * layers
    want.update({"paged_decode": k1, "paged_decode/fp": k1,
                 "paged_decode_stats": calls["spatial"] * layers,
                 "paged_decode_stats/fp": calls["spatial"] * layers})
    if cfg.star is None:
        want["flash"] = calls["prefill"] * layers
    else:
        want["dlzs_block"] = want["sufa"] = calls["prefill"] * layers
        got = launched()
        for kernel in ("dlzs_block", "sufa"):
            for form in ("wgmma", "mma_sync"):   # the tiles pick the form
                want[f"{kernel}/{form}"] = got[f"{kernel}/{form}"]
    return want


def require_serving_launches(calls: dict, cfg, on_card: bool,
                             tag: str) -> dict:
    got, want = launched(), serving_launches(calls, cfg, on_card)
    if got != want:
        raise SystemExit(f"{tag}: launches {got} over {calls}; expected "
                         f"{want}")
    return {k: v for k, v in got.items() if v}


def spans_outside_ticks(events: list[dict]) -> int:
    """The complete spans that no ``tick`` span of the trace contains (a
    tick's phases and dispatches must nest inside it on the host clock,
    whatever the device is still running; 1 ns of slack for the
    exporter's rounding)."""
    ticks = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("ph") == "X" and e["name"] == "tick"]
    return sum(1 for e in events if e.get("ph") == "X"
               and e["name"] != "tick"
               and not any(t0 - 1e-3 <= e["ts"]
                           and e["ts"] + e["dur"] <= t1 + 1e-3
                           for t0, t1 in ticks))


def twin_pair_rule(params, cfg) -> callable:
    """26b's hold of the spatial parity's two runs: every token of each by
    phase 4's rule against K4's forward (``check_exact``); the tokens
    where the runs part are counted."""
    def hold(res: dict) -> dict:
        out = {name: check_exact(params, cfg, res["prompts"], res[name])
               for name in ("paged", "spatial")}
        out["tokens_differing"] = res["tokens_differing"]
        return out
    return hold


def check_serve_twins(params, cfg, dev, gen, *, sparse_run: dict,
                      sparse_prompts, workdir=BUILD_DIR,
                      n_pages: int = 256) -> dict:
    """Phase 26: ``tools/torch_smoke_serve.py`` and
    ``tools/torch_smoke_spatial_prog.py`` through their functions on
    ``dev`` with ``params`` (OLMo-1B, ``cfg`` with STAR; the twins take it
    with ``star=None``), each sub-phase's launches counted from 0 and held
    (``serving_launches``): (a) ``basic``; (b) the spatial scenarios, the
    parity runs held by phase 4's rule (``twin_pair_rule``), the front
    door at 0.95 of the direct engine; (c) ``trace_smoke``'s three traces
    under ``workdir``; (d) both debug bundles; (e) phase 5's bounded
    sparse decode (``sparse_run`` on ``sparse_prompts``, with STAR) again
    with telemetry and the audit every ``TWIN_AUDIT_EVERY`` ticks: the
    same tokens, each audit's per-layer recall finite and in [0, 1]."""
    t_phase = time.perf_counter()
    on_card = torch.device(dev).type == "cuda"
    serve_twin = load_example("smoke_serve", "tools")
    prog = serve_twin.spatial_prog
    dense_cfg = dataclasses.replace(cfg, star=None)   # the twins' model
    out = {}

    def counted(tag, fn):
        calls = {}
        t0 = time.perf_counter()
        with counted_serving(calls):
            res = fn()
        sync(dev)
        res["seconds"] = time.perf_counter() - t0
        res["calls"] = dict(calls)
        res["launches"] = require_serving_launches(
            calls, dense_cfg, on_card, f"phase 26 {tag}")
        if not res.get("ok", True):
            raise SystemExit(f"phase 26 {tag}: {res}")
        return res

    basic = counted("basic", lambda: serve_twin.basic(dense_cfg, params,
                                                      dev))
    out["basic"] = basic
    emit("serve_twin_basic", **{k: basic[k] for k in (
        "decode_compiles", "shared_hits", "peak_pages", "requests",
        "n_tokens", "tok_s", "seconds", "calls", "launches")},
        dense_tokens=len(basic["dense_tokens"]))

    held = []
    sp = counted("spatial", lambda: serve_twin.spatial(
        dense_cfg, params, dev, hold=lambda res: held.append(res)
        or "held after the launch count"))
    rule = twin_pair_rule(params, dense_cfg)(held[0])
    fd = sp["front_door"]
    out["spatial"] = sp
    emit("serve_twin_spatial", parity_equal=sp["parity"]["equal"],
         tokens_differing=rule["tokens_differing"],
         **{f"{name}_{key}": rule[name][key] for name in ("paged", "spatial")
            for key in ("tokens_checked", "exact", "bf16_ties", "inexact")},
         decode_compiles=sp["parity"]["decode_compiles"],
         long_prompt=prog.LONG_PROMPT, refused=sp["capacity"]["refused"],
         sheds=sp["shed"]["sheds"], preemptions=sp["shed"]["preemptions"],
         direct_tok_s=fd["direct_tok_s"], llm_tok_s=fd["llm_tok_s"],
         front_door_ratio=fd["ratio"], front_door_attempts=fd["attempts"],
         front_door_runs=fd["runs"], seconds=sp["seconds"],
         calls=sp["calls"], launches=sp["launches"])

    workdir = pathlib.Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        tr = counted("trace", lambda: serve_twin.trace_smoke(
            dense_cfg, params, dev, pathlib.Path(tmp) / "traces"))
        out["trace"] = tr
        for backend in ("dense", "paged", "spatial"):
            tr[backend]["outside_ticks"] = spans_outside_ticks(
                tobs.load_trace(tr[backend]["path"]))
            if tr[backend]["outside_ticks"]:
                raise SystemExit(f"phase 26 trace {backend}: "
                                 f"{tr[backend]['outside_ticks']} spans "
                                 f"outside every tick")
        emit("serve_twin_trace", seconds=tr["seconds"], calls=tr["calls"],
             launches=tr["launches"], **{
                 backend: {key: tr[backend][key] for key in (
                     "events", "spans", "outside_ticks")}
                 | {key: tr[backend]["phases"][key] for key in (
                     "ticks", "wall_ms", "totals_ms", "per_tick_ms",
                     "compile_ms")}
                 for backend in ("dense", "paged", "spatial")})
        for tag, fn in (("bundle", serve_twin.bundle_smoke),
                        ("bundle_disagg", serve_twin.bundle_disagg_smoke)):
            res = counted(tag, lambda fn=fn, tag=tag: fn(
                dense_cfg, params, dev, pathlib.Path(tmp) / tag))
            audit = res["loaded"].get("audit.json", {})
            line = {"artifacts": res["artifacts"],
                    "audit_reports": len(audit.get("reports", ())),
                    "audit_runs": audit.get("runs"),
                    "seconds": res["seconds"], "calls": res["calls"],
                    "launches": res["launches"]}
            if tag == "bundle":
                if not line["audit_reports"]:
                    raise SystemExit(f"phase 26 bundle: audit.json holds no "
                                     f"report: {audit}")
                line["recall_min"] = min(r["recall_min"]
                                         for r in audit["reports"])
            else:
                line["transfer"] = {k: res["transfer"][k] for k in (
                    "n_transfers", "in_flight")}
            out[tag] = res
            emit(f"serve_twin_{tag}", **line)

    # 26e: phase 5's engine and requests four times, without telemetry,
    # with it (and the audit), with, without: each run must serve phase
    # 5's tokens; the warm pairs give telemetry's cost on one host
    calls = {}
    runs = []
    with counted_serving(calls):
        for telemetry in (False, True, True, False):
            tel = tobs.Telemetry({"backend": "paged"}) if telemetry \
                else None
            llm = main_path_llm(
                cfg, params, n_pages=n_pages, hot_pages=64, past_pages=64,
                device=dev, generator=gen, hot_width=8, telemetry=tel,
                audit_cfg=tobs.AuditCfg(every_ticks=TWIN_AUDIT_EVERY)
                if telemetry else None)
            run = serve(llm, sparse_prompts, len(sparse_run["done"][0]),
                        reset=False)
            if run["done"] != sparse_run["done"]:
                raise SystemExit(f"phase 26e: the served tokens "
                                 f"{run['done']} (telemetry {telemetry}) "
                                 f"against phase 5's {sparse_run['done']}")
            auditor = llm.engine.auditor if telemetry else None
            runs.append((telemetry, run, auditor,
                         len(tel.tracer.events) if telemetry else 0))
            del llm
    launches = require_serving_launches(calls, cfg, on_card,
                                        "phase 26 sparse")
    auditor = runs[1][2]
    recall = [r["recall_per_layer"] for r in auditor.reports]
    if not recall or not all(len(r) == cfg.n_layers and all(
            math.isfinite(x) and 0.0 <= x <= 1.0 for x in r)
            for r in recall):
        raise SystemExit(f"phase 26e: audit recall {recall}")
    tok_s = {key: [run["tok_s"] for tel_on, run, _, _ in runs
                   if tel_on == (key == "telemetry")]
             for key in ("telemetry", "plain")}
    out["sparse"] = {"tok_s": tok_s, "tok_s_phase5": sparse_run["tok_s"],
                     "audit_runs": auditor.runs, "recall_per_layer": recall,
                     "calls": calls, "launches": launches}
    emit("serve_twin_sparse_telemetry", tokens_equal_phase5=True,
         runs="without, with, with, without telemetry",
         tok_s_with=tok_s["telemetry"], tok_s_without=tok_s["plain"],
         telemetry_cost=1 - sum(tok_s["telemetry"]) / sum(tok_s["plain"]),
         tok_s_phase5=sparse_run["tok_s"], decode_ticks=runs[1][1]["ticks"],
         audit_runs=auditor.runs, audit_skipped=auditor.skipped,
         recall_mean_per_layer=[float(np.mean(col)) for col in zip(*recall)],
         recall_min=min(min(r) for r in recall), trace_events=runs[1][3],
         calls=calls, launches=launches)
    del runs
    free_cache(dev)
    out["seconds"] = time.perf_counter() - t_phase
    emit("serve_twins", ok=True, seconds=out["seconds"])
    return out


# -- phase 27: the configs the reference trains, never trained on the card ---

# StarCoder2-15B's training cut: its first layers, as deep as the card holds
# with AdamW's 8 bytes a parameter and the activations of 8 x 2048 tokens
STARCODER2_TRAIN_LAYERS = 19
STARCODER2_TRAIN_CUT = (
    "19 of 40: a layer is 383.8 M parameters beside 0.60 B of untied "
    "embedding and head; AdamW keeps bf16 params, one bf16 gradient tree "
    "and bf16 moments, 8 bytes a parameter: 40 layers are 15.96 B, 128 GB "
    "of state; 19 are 7.89 B, 63.1 GB. Measured on an H100 "
    "(tools/torch_family_probe.py starcoder2_15b@L 6e-4 12): peak 68.82 GB "
    "at 19 layers, 65.75 at 18, 59.61 at 16; at 20 the first step's "
    "backward ran out of the card's memory")


def untrained_step_cfgs() -> dict:
    """Phase 27b's configs: star_paper, ChatGLM3-6B and StarCoder2-15B at
    their published widths, each dense and with ``star_train``."""
    out = {}
    for cfg in (star_paper.config(), chatglm3_6b.config(),
                starcoder2_15b.config()):
        out[cfg.name] = cfg
        out[f"{cfg.name}_star"] = dataclasses.replace(cfg, star_train=True)
    return out


def untrained_cases() -> dict:
    """Phase 27c's training runs by name, each with its config's own
    optimizer (AdamW), ``train_accum`` (1) and ``remat`` (full) at the
    phase's base learning rate: star_paper at full depth with
    ``star_train``, ChatGLM3-6B at full depth dense and with
    ``star_train``, StarCoder2-15B dense cut to its first
    ``STARCODER2_TRAIN_LAYERS`` layers (``STARCODER2_TRAIN_CUT``). Widths
    are never cut."""
    cfgs = untrained_step_cfgs()
    full = functools.partial(FamilyCase, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                             lr=TRAIN_LR, reduced={})
    sc2 = cfgs["starcoder2_15b"]
    return {
        **{name: full(cfgs[name], cfgs[name].n_layers) for name in (
            "star_paper_star", "chatglm3_6b", "chatglm3_6b_star")},
        "starcoder2_15b": dataclasses.replace(
            full(sc2, STARCODER2_TRAIN_LAYERS),
            reduced={"n_layers": STARCODER2_TRAIN_CUT}),
    }


def untrained_kernel_shapes(rows: int = TRAIN_BATCH) -> dict:
    """Phase 27a's attention shapes by config, ``rows`` rows a microbatch
    times the query heads (K/V expanded to them by ``_repeat_kv``):
    star_paper's BH 256 (ChatGLM3-6B's too, its 2 KV heads expanded to
    32), StarCoder2-15B's BH 384."""
    return {name: rows * mod.config().n_heads
            for name, mod in (("star_paper", star_paper),
                              ("starcoder2_15b", starcoder2_15b))}


# calls the plain versions are timed over in phase 27a: each takes 18-82
# ms at BH 256-384 on an H100, 17 s of the script's clock at the usual 50
UNTRAINED_PLAIN_ITERS = 10


def check_untrained_kernels(dev, *, shapes_=None, t: int = TRAIN_SEQ,
                            seed: int = 2700) -> dict:
    """Phase 27a: the kernels at phase 27's training shapes, held before
    anything relies on them (T = S = ``t``, d 128, causal, tiles 128):
    K4's forward against its plain version and its backward by 20a's rule
    (``check_flash_bwd``) at each BH of ``shapes_``
    (``untrained_kernel_shapes()``); at star_paper's BH, K2 against its
    plain version, K3's forward on the glue's selection (keep 4 of 16 at
    2048) and K3's backward by 21a's rule in its ``wgmma`` form
    (``check_sufa_bwd``, star_paper's STAR config). On the card each is
    timed beside its bound, its plain version (over
    ``UNTRAINED_PLAIN_ITERS`` calls) and SDPA."""
    on_card = torch.device(dev).type == "cuda"
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev) \
        if on_card else None
    shapes_ = shapes_ or untrained_kernel_shapes()
    kw = dict(t=t, causal=True, timed=on_card,
              plain_iters=UNTRAINED_PLAIN_ITERS)
    out = {}
    for i, (name, bh) in enumerate(shapes_.items()):
        out[name] = {
            "forward": check_flash(dev, flush, bh=bh, seed=seed + 2 * i,
                                   **kw),
            "backward": check_flash_bwd(dev, flush, bh=bh,
                                        seed=seed + 2 * i + 1, **kw)}
    bh = shapes_["star_paper"]
    star = star_paper.config().star
    out["star"] = {
        "dlzs_block": check_dlzs(dev, flush, bh=bh, block=star.block_q,
                                 seed=seed + 10, **kw),
        "sufa": check_sufa(dev, flush, bh=bh, block=star.block_q,
                           strict=True, seed=seed + 11, **kw),
        "sufa_bwd": check_sufa_bwd(dev, flush, bh=bh, s=t, d=128,
                                   seed=seed + 12, star=star, **kw)}
    del flush
    free_cache(dev)
    return out


def check_untrained_training(dev, gen, *, cases=None, step_cfgs=None,
                             steps=FAMILY_STEPS,
                             step_layers: int = RESTART_LAYERS,
                             step_seq: int = TRAIN_SEQ,
                             kernels_kw=None) -> dict:
    """Phase 27 (see the module docstring): (a) the kernels at its
    training shapes (``check_untrained_kernels``); (b) one step's
    gradients of each of ``step_cfgs`` (``untrained_step_cfgs()``) at
    ``step_layers`` layers and ``FAMILY_STEP_BATCH`` x ``step_seq``
    tokens by 20d's rule (``check_model_step``; with ``star_train`` the
    plain runs on the kernel run's tile ids); (c) each of ``cases``
    (``untrained_cases()``) trained ``steps`` steps by ``check_training``
    with its config's own optimizer, ``train_accum`` and ``remat``."""
    t0 = time.perf_counter()
    out = {"kernels": check_untrained_kernels(dev, **(kernels_kw or {}))}
    out["kernels_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    out["steps"] = {
        name: check_model_step(cfg, dev, gen, layers=step_layers,
                               seq=step_seq, batch=FAMILY_STEP_BATCH,
                               tag="untrained_training_step")
        for name, cfg in (step_cfgs or untrained_step_cfgs()).items()}
    out["steps_s"] = time.perf_counter() - t1
    runs = {}
    for name, case in (cases or untrained_cases()).items():
        t1 = time.perf_counter()
        runs[name] = check_training(
            cut_layers(case.cfg, case.layers), dev, gen, steps=steps,
            seq=case.seq, batch=case.batch, lr=case.lr, save=False,
            tag="untrained_training", reduced=case.reduced)
        out[name] = {"train": runs[name],
                     "seconds": time.perf_counter() - t1}
        emit("untrained_case", case=name, seconds=out[name]["seconds"])
    out["seconds"] = time.perf_counter() - t0
    emit("untrained_trained", seconds=out["seconds"],
         kernels_s=out["kernels_s"], steps_s=out["steps_s"],
         **{key: {n: r[key] for n, r in runs.items()} for key in (
             "layers", "reduced", "step_ms_median", "tokens_per_s", "mfu",
             "mfu_all_params", "peak_memory_gb")},
         state_gb={n: r["state_gb"]["total"] for n, r in runs.items()},
         loss_drop={n: r["loss"][0] - r["loss"][-1]
                    for n, r in runs.items()})
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
    if sys.argv[1:2] == ["--restart-child"]:  # phases 20c, 21c, 23c
        print(json.dumps(restart_children(*sys.argv[2:4])), flush=True)
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    # 23c's restart of Jamba's layer 0 launches no kernel: its child runs
    # while the kernels build, and is waited for before phase 2
    jamba_restart = start_restart("jamba")

    # 1. build every kernel from the checkout's sources, in parallel
    t0 = time.perf_counter()
    built = build.build()
    build_s = time.perf_counter() - t0
    emit("build", seconds=build_s,
         libs={k: {"cached": v["cached"], "seconds": v["seconds"]}
               for k, v in built.items()})
    family_restart, = finish_restart(*jamba_restart, "jamba")
    emit("restart_wait", seconds=time.perf_counter() - t0 - build_s)
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
    # phase 22's decode shapes (d 64): examples/torch_serve_star.py's
    # (star_paper's smoke config, G 12, pages of 64, W its 4 hot pages of
    # a 32-page pool) and examples/torch_spatial_longctx.py's stats form
    # (4 shards of 12 pages, G 4, pages of 16, W its 10 hot pages; the
    # 500-token prompt and three short requests at their last tick)
    k1_examples = {
        "serve_star": check_paged_kernel(
            dev, "serve_star_example", b=4, g=12, r=1, d=64, page=64, w=4,
            p=32, kv_len=(123, 111, 87, 73), seed=11, timed=False),
        "spatial_longctx": check_paged_stats(
            dev, "spatial_longctx_example", 4, b=4, g=4, r=1, d=64,
            page=16, w=10, p=12, kv_len=(515, 40, 33, 25), seed=12,
            timed=False)}
    # phase 26's shapes: the serving smoke's twins at OLMo-1B's width
    twin_kernels = check_serve_twin_kernels(dev)

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
    sparse_prompts = make_prompts(cfg, (512, 640, 768), SEED + 2)
    sp_run = serve(sparse_llm, sparse_prompts, 16)
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

    # 26. the serving smoke's twins (tools/torch_smoke_serve.py,
    # tools/torch_smoke_spatial_prog.py) on phase 3's weights: every
    # backend, telemetry, traces, the debug bundles, and phase 5's sparse
    # decode again with telemetry and the DLZS audit
    twins = check_serve_twins(params, cfg, dev, gen, sparse_run=sp_run,
                              sparse_prompts=sparse_prompts)
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

    # 17. xLSTM-125M at full width, 6 of 12 layers: no kernel of the port
    check_xlstm(xlstm_125m.config(), dev, gen, layers=XLSTM_SERVE_LAYERS)

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
    sbwd = check_sufa_bwd_shapes(
        dev, ptxas_report(built["sufa"]["log"])
        + ptxas_report(built["sufa_bwd"]["log"]))
    star_cfg = dataclasses.replace(olmo_1b.config(), star_train=True)
    star_train = check_training(star_cfg, dev, gen, save=False,
                                steps=STAR_TRAIN_STEPS,
                                reduced={"steps": STAR_STEPS_CUT})
    check_model_step(star_cfg, dev, gen)

    # 21e. OLMo-1B with star_train and the element mask (tiles 128,
    # radius 5), trained as 21b, and 21d's model step on the kernel run's
    # tiles and keep bits
    elem_cfg = elementwise_star(star_cfg)
    elem_train = check_training(elem_cfg, dev, gen, save=False,
                                steps=STAR_TRAIN_STEPS,
                                reduced={"steps": STAR_STEPS_CUT})
    check_model_step(elem_cfg, dev, gen, tag="star_training_step_elementwise")

    # 21f. OLMo-1B at its published width cut to 2 layers, STAR at tiles
    # of 16: 21d's model step without and with the element mask, K3's
    # backward in its mma_sync form
    small = check_small_tiles(star_cfg, dev, gen)

    # 22. the example twins on the card, their launches counted
    ex = check_examples(dev)

    # 23. training beyond OLMo-1B: K4 at the new training shapes, then
    # OLMoE-1B-7B, Grok-1's layer, Jamba's layer 0 and xLSTM-125M trained
    # with their own optimizers and accumulation, their one-step
    # gradients, and the remat policies; Jamba's restart ran during phase 1
    fam = check_family_training(dev, gen)

    # 24. Nemotron-4-340B at its published width, 4 of 96 layers: every
    # kernel at head_dim 192 (K1 at R = 12), served with STAR and with
    # star=None through the paged engine
    nem = check_nemotron(nemotron_4_340b.config(), dev, gen)
    k24, nem24 = nem["kernels"], nem["served"]

    # 25. Nemotron-4-340B trained at head_dim 192: K4's and K3's backwards
    # at its training shape, one layer's gradient at its published width,
    # and 1 of its 96 layers trained with its Adafactor and train_accum 8,
    # dense and with star_train
    nt = check_nemotron_training(nemotron_4_340b.config(), dev, gen)
    k25 = nt["kernels"]

    # 27. the configs the reference trains that no earlier phase trained:
    # the kernels at their training shapes (BH 256 and 384), one 2-layer
    # step of each dense and with star_train, then star_paper with
    # star_train and ChatGLM3-6B dense and with star_train at full width
    # and depth, StarCoder2-15B at published width cut in depth
    ut = check_untrained_training(dev, gen)
    k27 = ut["kernels"]

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

    def example(name, kernel):
        """Phase 22's launches of ``kernel`` in one example twin."""
        return ex[name]["launches"].get(kernel, 0)

    def family(kernel):
        """Phase 23's launches of ``kernel`` in each training run."""
        return {name: fam[name]["train"]["launches"][kernel]
                for name in family_cases()}

    def timed(case):
        return {key: case[key] for key in (
            "max_abs_err", "tolerance", "ms", "ms_repeat", "plain_ms",
            "bound_ms", "bound_by", "library_ms")}

    def untrained(kernel, *names):
        """Phase 27c's launches of ``kernel`` in each named run."""
        return {name: ut[name]["train"]["launches"][kernel]
                for name in names}

    def by_grad(case):
        return {"max_abs_err_by_grad": {n: case[f"max_abs_err_{n}"]
                                        for n in ("dq", "dk", "dv")},
                "bf16_plain_err_by_grad": {n: case[f"bf16_plain_err_{n}"]
                                           for n in ("dq", "dk", "dv")}}
    star_runs = ("star_paper_star", "chatglm3_6b_star")
    sc2_layers = ut["starcoder2_15b"]["train"]["layers"]

    print(json.dumps({"kernels": [
        line("paged_decode", "paged_decode.cu",
             "src/repro/kernels/paged.py:67", main["k1_launches"], k1,
             launches_olmoe_main_path=olmoe["main"]["k1_launches"],
             max_abs_err_gqa=gqa["max_abs_err"], n_split=k1["n_split"],
             ms_w130=k1_w130["ms"], bound_ms_w130=k1_w130["bound_ms"],
             plain_ms_w130=k1_w130["plain_ms"],
             library_ms_w130=k1_w130["library_ms"],
             n_split_w130=k1_w130["n_split"],
             launches_serve_star_example=example("serve_star",
                                                 "paged_decode"),
             max_abs_err_serve_star_example=k1_examples["serve_star"][
                 "max_abs_err"],
             launches_serve_twins={tag: twins[tag]["launches"].get(
                 "paged_decode", 0) for tag in TWIN_TAGS},
             max_abs_err_serve_twins=max(twin_kernels["k1"])),
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
             launches_serve_star_example=example("serve_star",
                                                 "dlzs_block"),
             launches_serve_twin_sparse=twins["sparse"]["launches"].get(
                 "dlzs_block", 0),
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
                 "tolerance": 1e-4},
             launches_serve_star_example=example("serve_star", "sufa"),
             launches_serve_twin_sparse=twins["sparse"]["launches"].get(
                 "sufa", 0),
             forward_train=dict(timed(sbwd["forward_train"]),
                                keep=sbwd["forward_train"]["keep"],
                                launches_per_step=star_train["launches"][
                                    "sufa"] // star_train["steps"]),
             **bh64("sufa")),
        line("flash", "flash.cu", "src/repro/kernels/flash.py:67",
             exact["k4_launches"], tiles["flash"],
             launches_training=train["launches"]["flash"],
             launches_olmoe_oracle=olmoe["exact"]["k4_launches"],
             launches_jamba=jamba["exact"]["flash_launches"],
             launches_jamba_oracle=jamba["exact"]["k4_launches"],
             launches_train_example=example("train_star_lm", "flash"),
             launches_spatial_longctx_example=example("spatial_longctx",
                                                      "flash"),
             launches_serve_twins={tag: twins[tag]["launches"].get(
                 "flash", 0) for tag in TWIN_TAGS},
             max_abs_err_serve_twins=max(twin_kernels["k4"]),
             forward_train=dict(timed(bwd["forward_train"]),
                                launches_per_step=train["launches"][
                                    "flash"] // train["steps"]),
             launches_family_training=family("flash"),
             max_abs_err_family_training={
                 name: case["forward"]["max_abs_err"]
                 for name, case in fam["k4"].items()},
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
             launches_spatial_longctx_example=example(
                 "spatial_longctx", "paged_decode_stats"),
             max_abs_err_spatial_longctx_example=k1_examples[
                 "spatial_longctx"]["max_abs_err"],
             launches_serve_twins={tag: twins[tag]["launches"].get(
                 "paged_decode_stats", 0) for tag in TWIN_TAGS},
             max_abs_err_serve_twins=max(twin_kernels["k1_stats"]),
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
             causal_d64=dict(timed(bwd["causal_d64"]),
                             tflop_s_10d=bwd["causal_d64"]["tflop_s_10d"]),
             launches_train_example=example("train_star_lm", "flash_bwd"),
             restart_bit_equal=restart["bit_equal"],
             launches_family_training=family("flash_bwd"),
             family_training={
                 name: {"BH": case["backward"]["BH"],
                        "max_abs_err_by_grad": {
                            n: case["backward"][f"max_abs_err_{n}"]
                            for n in ("dq", "dk", "dv")},
                        "bf16_plain_err_by_grad": {
                            n: case["backward"][f"bf16_plain_err_{n}"]
                            for n in ("dq", "dk", "dv")},
                        **{key: case["backward"].get(key) for key in (
                            "ms", "plain_ms", "bound_ms", "bound_by",
                            "library_ms", "tflop_s_10d")}}
                 for name, case in fam["k4"].items()},
             launches_remat_policies={
                 remat: {k: fam["remat"][remat]["launches"][k]
                         for k in ("flash", "flash_bwd")}
                 for remat in ("full", "none", "dots")},
             adafactor_restart_bit_equal=family_restart["bit_equal"]),
        # phase 21: K3's backward (STAR in training has no TPU kernel: the
        # reference differentiates core.sufa.sufa_gathered through XLA;
        # this is the gradient of K3's function) at OLMo-1B's training
        # shape
        line("sufa_bwd", "sufa_bwd.cu",
             "none: the reference differentiates sufa_gathered through XLA "
             "(src/repro/core/sufa.py:107)",
             star_train["launches"]["sufa_bwd"], sbwd["train"],
             launches_from="phase 21b, OLMo-1B trained with star_train",
             form=sbwd["train"]["form"],
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
             max_abs_err_all_choosers=sbwd["all_choosers"]["max_abs_err"],
             launches_by_form={f: star_train["launches"][f"sufa_bwd/{f}"]
                               for f in ("wgmma", "mma_sync")},
             mma_sync_tiles64={key: sbwd["mma_sync"][key] for key in (
                 "max_abs_err", "tolerance", "two_calls_bit_equal")},
             split_ms={part: sbwd["train"][f"{part}_ms"]
                       for part in SUFA_BWD_KERNELS},
             tflop_s_10d=sbwd["train"]["tflop_s_10d"],
             restart_bit_equal=star_restart["bit_equal"]),
        # K3's backward with the element mask (the forward's keep bits):
        # phase 21e's training run at OLMo-1B's training shape
        line("sufa_bwd/elementwise", "sufa_bwd.cu",
             "none: the reference differentiates sufa_gathered through XLA "
             "(src/repro/core/sufa.py:107)",
             elem_train["launches"]["sufa_bwd/elementwise"],
             sbwd["train_elementwise"],
             launches_from="phase 21e, OLMo-1B trained with star_train and "
                           "elementwise=True",
             form=sbwd["train_elementwise"]["form"],
             launches_wgmma=elem_train["launches"]["sufa_bwd/wgmma"],
             kept_pairs=sbwd["train_elementwise"]["kept_pairs"],
             visible_pairs=sbwd["train_elementwise"]["visible_pairs"],
             pairs_differ_from_sphere_mask=sbwd["train_elementwise"][
                 "pairs_differ_from_sphere_mask"],
             split_ms={part: sbwd["train_elementwise"][f"{part}_ms"]
                       for part in SUFA_BWD_KERNELS},
             max_abs_err_edges=sbwd["edges_elementwise"]["max_abs_err"]),
        # its mma_sync form at small and mixed tiles: phase 21f's 2-layer
        # steps at tiles of 16, timed at the training shape
        line("sufa_bwd/mma_sync", "sufa_bwd.cu",
             "none: the reference differentiates sufa_gathered through XLA "
             "(src/repro/core/sufa.py:107)",
             small["tiles"]["launches"]["sufa_bwd/mma_sync"]
             + small["elementwise"]["launches"]["sufa_bwd/mma_sync"],
             sbwd["train_tiles16"],
             launches_from="phase 21f, OLMo-1B at 2 layers, tiles of 16, "
                           "one step without and one with the element mask",
             tiles32=timed(sbwd["train_tiles32"]),
             tiles16_elementwise=timed(sbwd["train_tiles16_elementwise"]),
             split_ms={part: sbwd["train_tiles16"][f"{part}_ms"]
                       for part in SUFA_BWD_MMA_KERNELS},
             max_abs_err_by_tiling={
                 key[4:]: val["max_abs_err"] for key, val in sbwd.items()
                 if key.startswith("mma_")}),
        # phase 24: Nemotron-4-340B at head_dim 192 (K1 at R = 12), its
        # 4-layer cut served with STAR (K1, K2, K3) and star=None (K4)
        line("paged_decode/d192", "paged_decode.cu",
             "src/repro/kernels/paged.py:67", nem24["star"]["k1_launches"],
             k24["k1"]["fp"], launches_from="phase 24b, Nemotron-4-340B "
                                            "served with STAR",
             launches_star_none=nem24["exact"]["k1_launches"],
             n_split=k24["k1"]["fp"]["n_split"],
             **int8_keys(k24["k1"]["int8"]),
             stats_form={lane: {key: k24["k1_stats"][lane][key] for key in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")}
                 for lane in ("fp", "int8")}),
        line("dlzs_block/d192", "dlzs_block.cu",
             "src/repro/kernels/dlzs.py:65",
             nem24["star"]["dlzs_block_launches"], k24["dlzs_block"],
             launches_from="phase 24b, Nemotron-4-340B's whole prompt",
             launches_by_form={f: nem24["star"]["form_launches"][
                 f"dlzs_block/{f}"] for f in ("wgmma", "mma_sync")}),
        line("sufa/d192", "sufa.cu", "src/repro/kernels/sufa.py:72",
             nem24["star"]["sufa_launches"], k24["sufa"],
             launches_from="phase 24b, Nemotron-4-340B's whole prompt",
             launches_by_form={f: nem24["star"]["form_launches"][
                 f"sufa/{f}"] for f in ("wgmma", "mma_sync")},
             fast_path=timed(k24["sufa_fast"]),
             elementwise=timed(k24["sufa_elementwise"]),
             elementwise_fast_path=timed(k24["sufa_fast_elementwise"]),
             mma_sync_tiles64=timed(k24["sufa_mma_sync"])),
        line("flash/d192", "flash.cu", "src/repro/kernels/flash.py:67",
             nem24["exact"]["flash_launches"], k24["flash"],
             launches_from="phase 24c, Nemotron-4-340B star=None prefills",
             launches_oracle=nem24["exact"]["k4_launches"],
             max_abs_err_ragged=k24["flash_ragged"]["max_abs_err"],
             launches_training=nt["dense"]["launches"]["flash"]),
        # phase 25: the backwards at head_dim 192 (64-key tiles, the
        # warpgroups split by product), Nemotron-4-340B trained
        line("flash_bwd/d192", "flash_bwd.cu",
             "src/repro/kernels/flash.py:67", nt["dense"]["launches"][
                 "flash_bwd"], k25["flash_bwd"],
             launches_from="phase 25c, Nemotron-4-340B trained (1 of 96 "
                           "layers, Adafactor, train_accum 8)",
             max_abs_err_by_grad={n: k25["flash_bwd"][f"max_abs_err_{n}"]
                                  for n in ("dq", "dk", "dv")},
             bf16_plain_err_by_grad={
                 n: k25["flash_bwd"][f"bf16_plain_err_{n}"]
                 for n in ("dq", "dk", "dv")},
             split_ms={part: k25["flash_bwd"][f"{part}_ms"]
                       for part in BWD_KERNELS_D192},
             tflop_s_10d=k25["flash_bwd"]["tflop_s_10d"],
             layer_grads_max_abs_err=nt["layer"]["dense"]["max_abs_err"]),
        line("sufa_bwd/d192", "sufa_bwd.cu",
             "none: the reference differentiates sufa_gathered through XLA "
             "(src/repro/core/sufa.py:107)",
             nt["star"]["launches"]["sufa_bwd"], k25["sufa_bwd"],
             launches_from="phase 25c, Nemotron-4-340B trained with "
                           "star_train (1 of 96 layers)",
             form=k25["sufa_bwd"]["form"],
             launches_by_form={f: nt["star"]["launches"][f"sufa_bwd/{f}"]
                               for f in ("wgmma", "mma_sync")},
             max_abs_err_by_grad={n: k25["sufa_bwd"][f"max_abs_err_{n}"]
                                  for n in ("dq", "dk", "dv")},
             split_ms={part: k25["sufa_bwd"][f"{part}_ms"]
                       for part in SUFA_BWD_KERNELS_D192},
             tflop_s_10d=k25["sufa_bwd"]["tflop_s_10d"],
             elementwise=timed(k25["sufa_bwd_elementwise"]),
             mma_sync_tiles64=timed(k25["sufa_bwd_tiles64"]),
             max_abs_err_edges=k25["sufa_bwd_edges"]["max_abs_err"],
             max_abs_err_all_choosers=k25["sufa_bwd_all_choosers"][
                 "max_abs_err"],
             max_abs_err_tiles16=k25["sufa_bwd_tiles16"]["max_abs_err"],
             layer_grads_max_abs_err=nt["layer"]["star"]["max_abs_err"]),
        # phase 27: the training shapes of star_paper and ChatGLM3-6B (8
        # rows x 32 heads, ChatGLM3-6B's 2 KV heads expanded) and of
        # StarCoder2-15B (8 x 48), T = S = 2048, d 128
        line("flash/bh256", "flash.cu", "src/repro/kernels/flash.py:67",
             ut["chatglm3_6b"]["train"]["launches"]["flash"],
             k27["star_paper"]["forward"],
             launches_from="phase 27c, ChatGLM3-6B trained (28 layers)"),
        line("flash/bh384", "flash.cu", "src/repro/kernels/flash.py:67",
             ut["starcoder2_15b"]["train"]["launches"]["flash"],
             k27["starcoder2_15b"]["forward"],
             launches_from=f"phase 27c, StarCoder2-15B trained ("
                           f"{sc2_layers} of 40 layers)"),
        line("flash_bwd/bh256", "flash_bwd.cu",
             "src/repro/kernels/flash.py:67",
             ut["chatglm3_6b"]["train"]["launches"]["flash_bwd"],
             k27["star_paper"]["backward"],
             launches_from="phase 27c, ChatGLM3-6B trained (28 layers)",
             **by_grad(k27["star_paper"]["backward"]),
             split_ms={part: k27["star_paper"]["backward"][f"{part}_ms"]
                       for part in BWD_KERNELS},
             tflop_s_10d=k27["star_paper"]["backward"]["tflop_s_10d"]),
        line("flash_bwd/bh384", "flash_bwd.cu",
             "src/repro/kernels/flash.py:67",
             ut["starcoder2_15b"]["train"]["launches"]["flash_bwd"],
             k27["starcoder2_15b"]["backward"],
             launches_from=f"phase 27c, StarCoder2-15B trained ("
                           f"{sc2_layers} of 40 layers)",
             **by_grad(k27["starcoder2_15b"]["backward"]),
             split_ms={part: k27["starcoder2_15b"]["backward"][f"{part}_ms"]
                       for part in BWD_KERNELS},
             tflop_s_10d=k27["starcoder2_15b"]["backward"]["tflop_s_10d"]),
        line("dlzs_block/bh256", "dlzs_block.cu",
             "src/repro/kernels/dlzs.py:65",
             sum(untrained("dlzs_block", *star_runs).values()),
             k27["star"]["dlzs_block"],
             launches_from="phase 27c, star_paper (32 layers) and "
                           "ChatGLM3-6B (28) trained with star_train",
             launches_by_run=untrained("dlzs_block", *star_runs)),
        line("sufa/bh256", "sufa.cu", "src/repro/kernels/sufa.py:72",
             sum(untrained("sufa", *star_runs).values()),
             k27["star"]["sufa"],
             launches_from="phase 27c, star_paper (32 layers) and "
                           "ChatGLM3-6B (28) trained with star_train",
             launches_by_run=untrained("sufa", *star_runs)),
        line("sufa_bwd/bh256", "sufa_bwd.cu",
             "none: the reference differentiates sufa_gathered through XLA "
             "(src/repro/core/sufa.py:107)",
             sum(untrained("sufa_bwd", *star_runs).values()),
             k27["star"]["sufa_bwd"],
             launches_from="phase 27c, star_paper (32 layers) and "
                           "ChatGLM3-6B (28) trained with star_train",
             launches_by_run=untrained("sufa_bwd", *star_runs),
             launches_wgmma=sum(untrained("sufa_bwd/wgmma",
                                          *star_runs).values()),
             form=k27["star"]["sufa_bwd"]["form"],
             **by_grad(k27["star"]["sufa_bwd"]),
             split_ms={part: k27["star"]["sufa_bwd"][f"{part}_ms"]
                       for part in SUFA_BWD_KERNELS},
             tflop_s_10d=k27["star"]["sufa_bwd"]["tflop_s_10d"]),
    ]}), flush=True)
    print_device_line()
    return 0


if __name__ == "__main__":
    sys.exit(main())
