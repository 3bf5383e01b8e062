"""Decoder LM of attention, Mamba (SSD), mLSTM and sLSTM blocks with a
dense or MoE FFN, optionally behind an encoder stack with per-layer
cross-attention, or fed embeddings by a frontend stub: prefill, chunked
paged prefill, paged decode, dense-cache decode and the spatial
(sequence-sharded) chunk prefills, decode and audit probe. PyTorch port
of the serving paths of ``repro.models.lm``.

Parameters are nested dicts with the reference's keys; each super-block
leaf is stacked on a leading layer axis exactly like the reference's
vmapped init (``blocks.b0.core.wq`` is [L, H, nh, dh]), so the converter
maps leaves one to one. The layer loop is a Python loop over that axis
(the reference's ``lax.scan``).

A recurrent block (``mamba``, ``mlstm``, ``slstm``) runs in the forward,
the prefill and the dense-cache decode, the modes the dense slot engine
serves; its state is the block's cache entry under its kind. The
pool-backed modes (chunked and paged prefill, paged and spatial decode)
serve attention-only patterns: the paged and spatial engines refuse
the others first, as the reference's do. An encoder-decoder model
(``enc_layers`` > 0) runs its non-causal encoder stack over
``batch["enc_embeds"]`` (or ``enc_tokens``) in the forward and the
prefill; each cross-attention layer builds its encoder K/V there and
keeps it in the cache under ``"cross"``, which decode reads. No engine
serves it, as in the reference. A batch with ``"embeds"`` (a frontend
stub's embeddings) skips the token embedding.

Training (``loss_fn``) runs the stack in ``mode="train"``: each layer's
super-block under the ``remat`` policy (``torch.utils.checkpoint``), the
dense attention through K4 and its backward (STAR is off in training,
as in the reference, unless ``star_train``, which needs K3's backward
and is refused), and the MoE blocks' load-balance loss summed as
``aux · aux_loss_weight``; the serving modes drop that loss.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.core.star_attention import STARConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention, common, mlp, moe, ssm, xlstm

RECURRENT = ("mamba", "mlstm", "slstm")


@dataclasses.dataclass(frozen=True)
class BlockCfg:
    kind: str              # attn | mamba | mlstm | slstm
    ffn: str = "dense"     # dense | moe | none
    cross_attn: bool = False


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    name: str
    d_model: int
    n_layers: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    pattern: tuple = (BlockCfg("attn", "dense"),)
    norm: str = "rmsnorm"
    mlp_act: str = "silu"
    mlp_gated: bool = True
    rope_fraction: float = 1.0
    rope_theta: float = 1e4
    qkv_bias: bool = False
    head_dim: Optional[int] = None
    moe: Optional[moe.MoECfg] = None
    mamba: Optional[ssm.MambaCfg] = None
    xlstm_heads: int = 0
    enc_layers: int = 0            # > 0 => encoder-decoder
    embeds_input: bool = False     # modality frontend stub feeds embeddings
    star: Optional[STARConfig] = None   # serving-time sparse attention
    star_train: bool = False            # STAR in training (refused: needs
    #                                     K3's backward)
    star_chunk_sparse: bool = False     # DLZS page selection inside later
    #                                     prefill chunks (approximate)
    causal: bool = True
    q_chunk: int = 1024            # the reference's dense-attention chunk
    seq_loss_chunk: int = 1024     # CE chunk (largest divisor of S <= it)
    vocab_pad_to: int = 2048
    remat: str = "full"            # none | full | dots
    optimizer: str = "adamw"       # adamw | adafactor (giants: factored v)
    train_accum: int = 1           # gradient-accumulation microbatches
    accum_dtype: Any = torch.bfloat16   # grad accumulation buffer dtype
    dtype: Any = torch.bfloat16

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_repeat(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, \
            f"{self.n_layers} layers not a multiple of pattern " \
            f"{len(self.pattern)}"
        return self.n_layers // len(self.pattern)

    @property
    def vocab_padded(self) -> int:
        p = self.vocab_pad_to
        return -(-self.vocab // p) * p

    def attn_cfg(self, causal: Optional[bool] = None, mode: str = "serve"
                 ) -> attention.AttentionCfg:
        """The attention layer's config; ``mode="train"`` drops STAR
        unless ``star_train``, as the reference's does."""
        use_star = self.star if (mode != "train" or self.star_train) \
            else None
        return attention.AttentionCfg(
            d_model=self.d_model, n_heads=self.n_heads, n_kv=self.n_kv,
            head_dim=self.dh, rope_fraction=self.rope_fraction,
            rope_theta=self.rope_theta, qkv_bias=self.qkv_bias,
            causal=self.causal if causal is None else causal,
            star=use_star,
            chunk_sparse=self.star_chunk_sparse, dtype=self.dtype)

    def mlp_cfg(self) -> mlp.MLPCfg:
        return mlp.MLPCfg(self.d_model, self.d_ff, self.mlp_act,
                          self.mlp_gated, self.dtype)

    def xlstm_cfg(self) -> xlstm.XLSTMCfg:
        return xlstm.XLSTMCfg(self.d_model, self.xlstm_heads,
                              dtype=self.dtype)


ENC_PATTERN = (BlockCfg("attn", "dense"),)


def check_supported(cfg: ModelCfg) -> None:
    for blk in cfg.pattern:
        if blk.kind not in ("attn",) + RECURRENT \
                or blk.ffn not in ("dense", "moe", "none"):
            raise ValueError(f"{cfg.name}: unknown block {blk}")
        if blk.ffn == "moe" and cfg.moe is None:
            raise ValueError(f"{cfg.name}: an moe block needs ModelCfg.moe")
        if blk.kind == "mamba" and cfg.mamba is None:
            raise ValueError(f"{cfg.name}: a mamba block needs "
                             f"ModelCfg.mamba")
        if blk.kind in ("mlstm", "slstm") and cfg.xlstm_heads <= 0:
            raise ValueError(f"{cfg.name}: an {blk.kind} block needs "
                             f"ModelCfg.xlstm_heads")


def _core_init(generator, cfg: ModelCfg, kind: str, device, n_layers):
    if kind == "attn":
        return attention.init(generator, cfg.attn_cfg(), device,
                              n_layers=n_layers)
    if kind == "mamba":
        return ssm.init(generator, cfg.mamba, device, n_layers=n_layers)
    init = xlstm.mlstm_init if kind == "mlstm" else xlstm.slstm_init
    return init(generator, cfg.xlstm_cfg(), device, n_layers=n_layers)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init(cfg: ModelCfg, generator: torch.Generator, device=None):
    """Random parameters (the reference's distribution, drawn from
    ``generator``) on ``device`` (default ``cuda``; raises without one)."""
    check_supported(cfg)
    dev = resolve_device(device)
    vp = cfg.vocab_padded
    p = {
        "embed": common.truncated_normal_init(generator, (vp, cfg.d_model),
                                              1.0, cfg.dtype, dev),
        "final_norm": common.norm_init(cfg.norm, cfg.d_model, device=dev),
        "out_head": common.truncated_normal_init(
            generator, (cfg.d_model, vp), 1.0, cfg.dtype, dev),
    }
    p["blocks"] = _blocks_init(generator, cfg, cfg.pattern, cfg.n_repeat,
                               dev)
    if cfg.enc_layers:
        p["enc_blocks"] = _blocks_init(generator, cfg, ENC_PATTERN,
                                       cfg.enc_layers, dev)
        p["enc_norm"] = common.norm_init(cfg.norm, cfg.d_model, device=dev)
    return p


def _blocks_init(generator, cfg: ModelCfg, pattern, L: int, dev):
    """A stack of ``L`` super-blocks of ``pattern``, each leaf on a
    leading layer axis."""
    blocks = {}
    for i, blk in enumerate(pattern):
        b = {"norm1": _stack_norm(cfg, L, dev),
             "core": _core_init(generator, cfg, blk.kind, dev, L)}
        if blk.cross_attn:
            b["norm_cross"] = _stack_norm(cfg, L, dev)
            b["cross"] = attention.cross_init(
                generator, cfg.attn_cfg(causal=False), dev, n_layers=L)
        if blk.ffn != "none":
            b["norm2"] = _stack_norm(cfg, L, dev)
            b["ffn"] = moe.init(generator, cfg.moe, dev, n_layers=L) \
                if blk.ffn == "moe" else \
                mlp.init(generator, cfg.mlp_cfg(), dev, n_layers=L)
        blocks[f"b{i}"] = b
    return blocks


def _stack_norm(cfg: ModelCfg, n_layers: int, device):
    return {k: v[None].repeat(n_layers, *([1] * v.dim()))
            for k, v in common.norm_init(cfg.norm, cfg.d_model,
                                         device=device).items()}


# ---------------------------------------------------------------------------
# Forward paths
# ---------------------------------------------------------------------------

def _layer(tree, i: int):
    """Layer ``i``'s slice of a layer-stacked dict tree (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _recurrent_apply(params, cfg: ModelCfg, kind: str, h, *, mode: str,
                     cache=None, page_state=None, spatial: bool = False):
    """A Mamba, mLSTM or sLSTM core. Returns (y, its new cache entry or
    None). Decode writes the new state into the cache entry in place (the
    dense slot engine's slabs) and returns that entry."""
    if spatial or page_state is not None or mode not in (
            "forward", "prefill", "decode", "train"):
        raise ValueError(
            f"a {kind} block runs only in the forward, the prefill, the "
            f"dense-cache decode and training; the paged and spatial "
            f"engines serve attention-only patterns")
    if kind == "mamba":
        full, step, kcfg = ssm.apply, ssm.apply_decode, cfg.mamba
    elif kind == "mlstm":
        full, step, kcfg = (xlstm.mlstm_apply, xlstm.mlstm_decode,
                            cfg.xlstm_cfg())
    else:
        full, step, kcfg = (xlstm.slstm_apply, xlstm.slstm_decode,
                            cfg.xlstm_cfg())
    if mode != "decode":
        return full(params, kcfg, h, make_cache=(mode == "prefill"))
    y, new = step(params, kcfg, h, cache[kind])
    for name, leaf in new.items():
        cache[kind][name].copy_(leaf)
    return y, cache[kind]


def _block_apply(params, cfg: ModelCfg, blk: BlockCfg, x, positions, *,
                 mode: str, causal: Optional[bool] = None, cache=None,
                 enc_cache=None, lengths=None, cache_len=None,
                 page_state=None, spatial: bool = False):
    """One block. Returns (y, new_cache, aux): ``aux`` is an MoE FFN's
    load-balance loss times ``aux_loss_weight`` (None without one)."""
    aux = None
    h = common.norm_apply(cfg.norm, params["norm1"], x)
    acfg = cfg.attn_cfg(causal, mode)
    new_cache = {}
    if blk.kind in RECURRENT:
        y, c = _recurrent_apply(params["core"], cfg, blk.kind, h, mode=mode,
                                cache=cache, page_state=page_state,
                                spatial=spatial)
        if c is not None:
            new_cache[blk.kind] = c
    elif spatial and mode == "prefill_chunk_batch":
        y, new_cache["attn"] = attention.apply_prefill_chunk_batch_spatial(
            params["core"], acfg, h, positions, cache["attn"], page_state)
    elif spatial and mode == "prefill_chunk":
        y, new_cache["attn"] = attention.apply_prefill_chunk_spatial(
            params["core"], acfg, h, positions, cache["attn"], page_state)
    elif spatial and mode == "decode":
        y, new_cache["attn"] = attention.apply_decode_spatial(
            params["core"], acfg, h, cache["attn"], lengths, page_state)
    elif mode == "prefill_chunk_batch":
        y, new_cache["attn"] = attention.apply_prefill_chunk_batch(
            params["core"], acfg, h, positions, cache["attn"], page_state)
    elif mode == "prefill_chunk":
        y, new_cache["attn"] = attention.apply_prefill_chunk(
            params["core"], acfg, h, positions, cache["attn"],
            page_state["past_phys"], page_state["past_logical"],
            page_state["past_len"])
    elif mode == "decode" and page_state is not None:
        y, new_cache["attn"] = attention.apply_decode_paged(
            params["core"], acfg, h, cache["attn"], lengths, page_state)
    elif mode == "decode":
        y, new_cache["attn"] = attention.apply_decode(
            params["core"], acfg, h, cache["attn"], lengths)
    else:
        y, c = attention.apply_prefill(
            params["core"], acfg, h, positions,
            make_cache=(mode == "prefill"), cache_len=cache_len)
        if c is not None:
            new_cache["attn"] = c
    x = x + y
    if blk.cross_attn:
        if mode == "decode":
            layer_cross = cache["cross"]        # built at prefill
            new_cache["cross"] = layer_cross
        elif enc_cache is not None:
            # this layer's cross K/V from the encoder output
            layer_cross = attention.cross_encode(params["cross"], acfg,
                                                 enc_cache)
            if mode == "prefill":
                new_cache["cross"] = layer_cross
        else:
            layer_cross = None
        if layer_cross is not None:
            hc = common.norm_apply(cfg.norm, params["norm_cross"], x)
            x = x + attention.cross_apply(params["cross"], acfg, hc,
                                          layer_cross)
    if blk.ffn != "none":
        h2 = common.norm_apply(cfg.norm, params["norm2"], x)
        if blk.ffn == "moe":
            y2, a = moe.apply(params["ffn"], cfg.moe, h2)
            aux = a * cfg.moe.aux_loss_weight
        else:
            y2 = mlp.apply(params["ffn"], cfg.mlp_cfg(), h2)
        x = x + y2
    return x, new_cache, aux


def _run_stack(blocks, cfg: ModelCfg, x, positions, *, mode, caches=None,
               causal: Optional[bool] = None, enc_cache=None, lengths=None,
               cache_len=None, page_state=None, spatial: bool = False):
    """Loop the super-block over the layer axis. Returns (x, caches):
    prefill modes stack each layer's fresh cache on axis 0 ([L, ...]);
    decode, and every ``spatial`` mode, write the pool (or dense) slabs in
    place, a recurrent block's state too, and return a shallow copy of
    the cache tree (plus ``audit_mass`` [L, ...] when auditing)."""
    check_supported(cfg)
    per_layer = []
    for i in range(cfg.n_repeat):
        out = {}
        for j, blk in enumerate(cfg.pattern):
            key = f"b{j}"
            x, out[key], _ = _block_apply(
                _layer(blocks[key], i), cfg, blk, x, positions, mode=mode,
                causal=causal,
                cache=_layer(caches[key], i) if caches else None,
                enc_cache=enc_cache, lengths=lengths, cache_len=cache_len,
                page_state=page_state, spatial=spatial)
        per_layer.append(out)
    if mode == "decode" or spatial:
        new = {}
        for key in caches:
            new[key] = {kind: dict(leaves)
                        for kind, leaves in caches[key].items()}
            if "audit_mass" in per_layer[0][key].get("attn", {}):
                new[key]["attn"]["audit_mass"] = torch.stack(
                    [pl[key]["attn"]["audit_mass"] for pl in per_layer])
        return x, new
    if not per_layer[0] or not any(per_layer[0].values()):
        return x, None
    return x, _stack_trees(per_layer)


def _stack_trees(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _embed_inputs(params, cfg: ModelCfg, batch):
    if "embeds" in batch:
        return batch["embeds"].to(cfg.dtype)
    return params["embed"][batch["tokens"].long()]


def _encode(params, cfg: ModelCfg, batch):
    """The encoder stack of an encoder-decoder model, non-causal, over
    ``batch["enc_embeds"]`` (or the embedded ``enc_tokens``), then
    ``enc_norm``: the encoder output [B, S, H]. With STAR on its
    self-attention runs K2 -> SADS -> K3 non-causal."""
    x = batch["enc_embeds"].to(cfg.dtype) if "enc_embeds" in batch \
        else params["embed"][batch["enc_tokens"].long()]
    enc = dataclasses.replace(cfg, n_layers=cfg.enc_layers,
                              pattern=ENC_PATTERN, enc_layers=0)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _ = _run_stack(params["enc_blocks"], enc, x, positions, mode="encode",
                      causal=False)
    return common.norm_apply(cfg.norm, params["enc_norm"], x)


def logits(params, cfg: ModelCfg, x):
    """Final norm + output head: x [..., H] -> [..., vocab_padded]."""
    x = common.norm_apply(cfg.norm, params["final_norm"], x)
    return x @ params["out_head"]


def forward(params, cfg: ModelCfg, batch):
    """Dense full-sequence forward without caches: logits [B, S, vocab_p]
    at every position (the exactness oracle of the serving path)."""
    x = _embed_inputs(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    enc_cache = _encode(params, cfg, batch) if cfg.enc_layers else None
    x, _ = _run_stack(params["blocks"], cfg, x, positions, mode="forward",
                      enc_cache=enc_cache)
    return logits(params, cfg, x)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

# ``remat="dots"`` keeps the outputs of products without batch dimensions
# (the projections and FFN matmuls), as JAX's
# ``dots_with_no_batch_dims_saveable`` does, and recomputes the rest
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelCfg):
    """``fn`` under ``cfg.remat``: ``none`` as is, ``full`` saving only its
    inputs (``torch.utils.checkpoint``, non-reentrant), ``dots`` also
    saving its unbatched matmul outputs (a selective-checkpoint policy).
    Nothing in the stack draws random numbers, so the RNG state is not
    stashed."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        context_fn = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    elif cfg.remat == "full":
        context_fn = ckpt.noop_context_fn
    else:
        raise ValueError(f"{cfg.name}: unknown remat {cfg.remat!r}")
    return functools.partial(ckpt.checkpoint, fn, use_reentrant=False,
                             preserve_rng_state=False, context_fn=context_fn)


def _unbind_layers(tree, n: int) -> list:
    """A layer-stacked tree as ``n`` trees, one per layer (``unbind``
    views: the backward stacks the layers' gradients once, where indexing
    each layer would add a leaf-sized zero tensor per layer)."""
    if isinstance(tree, dict):
        per = {k: _unbind_layers(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per.items()} for i in range(n)]
    return tree.unbind(0)


def _train_stack(blocks, cfg: ModelCfg, x, positions, *, enc_cache=None):
    """The decoder stack in ``mode="train"``, each layer's super-block
    (the reference's scan body) under ``_remat``. Returns (x, aux)."""
    check_supported(cfg)
    layers = {key: _unbind_layers(blocks[key], cfg.n_repeat)
              for key in blocks}

    def body(xc, i: int):
        aux = torch.zeros((), dtype=torch.float32, device=xc.device)
        for j, blk in enumerate(cfg.pattern):
            key = f"b{j}"
            xc, _, a = _block_apply(layers[key][i], cfg, blk, xc, positions,
                                    mode="train", enc_cache=enc_cache)
            if a is not None:
                aux = aux + a
        return xc, aux

    run = _remat(body, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_repeat):
        x, a = run(x, i)
        aux = aux + a
    return x, aux


def _ce_chunk(xc, labels, out_head, vocab_ok):
    """Summed CE, summed squared lse and the count of valid labels over
    one chunk: xc [B, c, H], labels [B, c] (< 0: ignored)."""
    logits = (xc @ out_head).float()
    logits = logits.masked_fill(~vocab_ok, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    valid = (labels >= 0).float()
    return ((lse - gold) * valid).sum(), (lse.square() * valid).sum(), \
        valid.sum()


def loss_fn(params, cfg: ModelCfg, batch):
    """Next-token CE loss (+ MoE aux + z-loss). batch: tokens|embeds,
    labels [B, S] (negative labels are ignored); an encoder-decoder model
    also takes its encoder input. Returns (loss, metrics: ce, aux, zloss,
    tokens).

    The logits are computed in sequence chunks of the largest divisor of
    S at most ``seq_loss_chunk``, each under ``torch.utils.checkpoint``,
    so the [B, chunk, vocab] logits are recomputed in the backward and
    [B, S, vocab] never materialises (the reference's
    ``jax.checkpoint(ce_chunk)``)."""
    if cfg.star_train and cfg.star is not None:
        raise NotImplementedError(
            f"{cfg.name}: STAR in training needs K2/K3 in train mode and "
            f"K3's backward (ROADMAP §1 item 7)")
    x = _embed_inputs(params, cfg, batch)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    enc_cache = _encode(params, cfg, batch) if cfg.enc_layers else None
    x, aux = _train_stack(params["blocks"], cfg, x, positions,
                          enc_cache=enc_cache)
    x = common.norm_apply(cfg.norm, params["final_norm"], x)

    labels = batch["labels"].long()
    chunk = min(cfg.seq_loss_chunk, s)
    while s % chunk:
        chunk -= 1
    vocab_ok = torch.arange(cfg.vocab_padded, device=x.device) < cfg.vocab
    sums = [ckpt.checkpoint(_ce_chunk, x[:, off:off + chunk],
                            labels[:, off:off + chunk], params["out_head"],
                            vocab_ok, use_reentrant=False,
                            preserve_rng_state=False)
            for off in range(0, s, chunk)]
    ce_sum, z_sum, count = (torch.stack(v).sum() for v in zip(*sums))
    n_tok = torch.clamp(count, min=1.0)
    ce = ce_sum / n_tok
    zloss = 1e-4 * z_sum / n_tok
    loss = ce + zloss + aux
    return loss, {"ce": ce, "aux": aux, "zloss": zloss, "tokens": n_tok}


def prefill(params, cfg: ModelCfg, batch, *, cache_len: Optional[int] = None,
            last_index: Optional[torch.Tensor] = None):
    """Process the prompt; build caches. Returns (last_logits, caches).
    ``last_index`` [B] selects which position's logits to return."""
    x = _embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    enc_cache = _encode(params, cfg, batch) if cfg.enc_layers else None
    x, caches = _run_stack(params["blocks"], cfg, x, positions,
                           mode="prefill", enc_cache=enc_cache,
                           cache_len=cache_len)
    if last_index is None:
        x_last = x[:, -1:, :]
        lengths = torch.full((b,), s, dtype=torch.int32, device=x.device)
    else:
        li = last_index.long()
        x_last = x[torch.arange(b, device=x.device), li][:, None, :]
        lengths = (li + 1).to(torch.int32)
    return logits(params, cfg, x_last)[:, 0], {"layers": caches,
                                               "lengths": lengths}


def prefill_chunk_paged(params, cfg: ModelCfg, batch, cache, chunk_state):
    """Prefill one page-aligned chunk from a NONZERO cache offset against
    the pool pages earlier chunks wrote (read-only). ``chunk_state``:
    past_phys/past_logical [B,Wp], past_len [B], last_index [B]. Returns
    (logits [B, vocab_padded], {"layers": chunk caches [L, B, C, ...]})."""
    x = _embed_inputs(params, cfg, batch)
    b, c, _ = x.shape
    positions = chunk_state["past_len"][:, None] + torch.arange(
        c, device=x.device)[None, :]
    x, chunk_caches = _run_stack(params["blocks"], cfg, x, positions,
                                 mode="prefill_chunk",
                                 caches=cache["layers"],
                                 page_state=chunk_state)
    li = chunk_state["last_index"].long()
    x_last = x[torch.arange(b, device=x.device), li][:, None, :]
    return logits(params, cfg, x_last)[:, 0], {"layers": chunk_caches}


def prefill_chunk_batch_paged(params, cfg: ModelCfg, batch, cache,
                              pack_state):
    """Prefill MANY sequences' chunks as ONE flat varlen dispatch.
    batch["tokens"] [1, B_tok]; ``pack_state`` carries seg_ids/positions
    [B_tok], the past arena past_phys/past_lane/past_logical [Wp],
    past_len [S] and last_index [S] (flat). Returns (logits
    [S, vocab_padded], {"layers": chunk caches [L, 1, B_tok, ...]})."""
    x = _embed_inputs(params, cfg, batch)
    positions = pack_state["positions"][None, :]
    x, chunk_caches = _run_stack(params["blocks"], cfg, x, positions,
                                 mode="prefill_chunk_batch",
                                 caches=cache["layers"],
                                 page_state=pack_state)
    x_last = x[0][pack_state["last_index"].long()][None]
    return logits(params, cfg, x_last)[0], {"layers": chunk_caches}


def decode_step(params, cfg: ModelCfg, tokens, cache):
    """One decode step against the dense slot cache (written in place):
    tokens [B, 1]; ``cache["layers"]`` leaves are [L, B, S_max, nkv, dh]
    (what ``prefill(cache_len=S_max)`` returns). Returns (logits [B,
    vocab_padded], {"layers", "lengths": lengths + 1})."""
    x = params["embed"][tokens.long()]
    lengths = cache["lengths"]
    x, new_caches = _run_stack(params["blocks"], cfg, x, lengths[:, None],
                               mode="decode", caches=cache["layers"],
                               lengths=lengths)
    return logits(params, cfg, x)[:, 0], {"layers": new_caches,
                                          "lengths": lengths + 1}


def decode_step_paged(params, cfg: ModelCfg, tokens, cache, page_state):
    """One decode step against the paged pools (written in place).

    ``cache["layers"]`` leaves are page slabs [L, n_pages, page, n_kv, dh];
    ``page_state`` carries phys/logical [B, W] and write_page/write_off
    [B]. Shapes depend only on (max_batch, hot width, pool size). Returns
    (logits [B, vocab_padded], {"layers", "lengths": lengths + 1})."""
    x = params["embed"][tokens.long()]
    lengths = cache["lengths"]
    x, new_caches = _run_stack(params["blocks"], cfg, x, lengths[:, None],
                               mode="decode", caches=cache["layers"],
                               lengths=lengths, page_state=page_state)
    return logits(params, cfg, x)[:, 0], {"layers": new_caches,
                                          "lengths": lengths + 1}


# ---------------------------------------------------------------------------
# Spatial (sequence-sharded) paths. The reference dispatches each as one
# shard_map over a mesh axis with per-shard slabs [S, L, P_local, ...]; the
# port keeps every shard on one device with slabs [L, S, P_local, page,
# n_kv, dh] (the layer axis first, as ``_layer`` slices every slab of the
# port), so each layer reads its [S, P_local, ...] slab as one block. Each
# layer handles all shards at once: there is no loop over shards.
# ---------------------------------------------------------------------------

def prefill_chunk_spatial(params, cfg: ModelCfg, batch, cache, chunk_state):
    """Prefill one chunk of a sequence-sharded prompt; the chunk's K/V rows
    are written into the owner shards' pages in place. ``chunk_state``:
    past_phys/past_logical [S,B,Wp] (shard-LOCAL ids / GLOBAL logical
    pages of pages earlier chunks wrote), chunk_phys [S,B,C//page]
    (SCRATCH where another shard owns the page), past_len/last_index [B].
    Returns (logits [B, vocab_padded], {"layers"})."""
    x = _embed_inputs(params, cfg, batch)
    b, c, _ = x.shape
    positions = chunk_state["past_len"][:, None] + torch.arange(
        c, device=x.device)[None, :]
    x, layers = _run_stack(params["blocks"], cfg, x, positions,
                           mode="prefill_chunk", caches=cache["layers"],
                           page_state=chunk_state, spatial=True)
    li = chunk_state["last_index"].long()
    x_last = x[torch.arange(b, device=x.device), li][:, None, :]
    return logits(params, cfg, x_last)[:, 0], {"layers": layers}


def prefill_chunk_batch_spatial(params, cfg: ModelCfg, batch, cache,
                                pack_state):
    """Batched varlen chunk prefill over sequence-sharded pools: the flat
    layout of ``prefill_chunk_batch_paged`` with per-shard arena leaves
    past_phys/past_lane/past_logical [S,Wp] and scatter targets chunk_phys
    [S,1,B_tok//page]; seg_ids/positions/past_len/last_index as there.
    Returns (logits [S_lanes, vocab_padded], {"layers"})."""
    x = _embed_inputs(params, cfg, batch)
    positions = pack_state["positions"][None, :]
    x, layers = _run_stack(params["blocks"], cfg, x, positions,
                           mode="prefill_chunk_batch",
                           caches=cache["layers"], page_state=pack_state,
                           spatial=True)
    x_last = x[0][pack_state["last_index"].long()][None]
    return logits(params, cfg, x_last)[0], {"layers": layers}


def decode_step_spatial(params, cfg: ModelCfg, tokens, cache, page_state):
    """One decode step against sequence-sharded paged pools (written in
    place): every shard attends over its hot pages through one launch of
    K1's stats form per layer, and the partial states merge over the
    shards. ``page_state``: phys/logical [S,B,W], write_page/write_off
    [S,B], optional qmask [S,B,W]. Shapes depend only on (max_batch, hot
    width, pool size). Returns (logits [B, vocab_padded], {"layers",
    "lengths": lengths + 1})."""
    x = params["embed"][tokens.long()]
    lengths = cache["lengths"]
    x, new_caches = _run_stack(params["blocks"], cfg, x, lengths[:, None],
                               mode="decode", caches=cache["layers"],
                               lengths=lengths, page_state=page_state,
                               spatial=True)
    return logits(params, cfg, x)[:, 0], {"layers": new_caches,
                                          "lengths": lengths + 1}


def audit_decode_spatial(params, cfg: ModelCfg, tokens, cache, page_state):
    """Exact-attention audit probe over sequence-sharded pools (obs.audit):
    ``decode_step_spatial``'s dispatch with the ``audit`` flag, returning
    only the per-page masses, normalised over all shards:
    [S, n_blocks, n_repeat, B, W] f32. Read-only: the K/V rows the probe's
    decode writes are saved first and restored after, as the reference's
    functional probe leaves its (never donated) cache untouched."""
    ps = dict(page_state, audit=True)
    wp = ps["write_page"].long()
    at = (torch.arange(wp.shape[0], device=wp.device)[:, None].expand_as(wp),
          wp, ps["write_off"].long())
    written = [leaf for key in cache["layers"]
               for name, leaf in cache["layers"][key]["attn"].items()
               if name in ("k", "v", "k_lz")]
    saved = [leaf[(slice(None),) + at].clone() for leaf in written]
    _, out = decode_step_spatial(params, cfg, tokens, cache, ps)
    for leaf, rows in zip(written, saved):
        leaf[(slice(None),) + at] = rows
    masses = torch.stack([out["layers"][key]["attn"]["audit_mass"]
                          for key in out["layers"]])   # [blk, R, S, B, W]
    return masses.permute(2, 0, 1, 3, 4)
