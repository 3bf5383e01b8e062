"""SeamlessM4T-large-v2 [audio] — 24L(+24 enc) d_model=1024 16H (kv=16)
d_ff=8192 vocab=256206, encoder-decoder, multimodal.
[arXiv:2308.11596; hf] — the port's twin of
``repro.configs.seamless_m4t_large_v2`` (same fields, torch dtype).

The speech frontend is a stub: the encoder takes precomputed frame
embeddings (``batch["enc_embeds"]``); the decoder consumes tokens. STAR
applies to the encoder's (non-causal) and the decoder's self-attention;
cross-attention is dense.
"""

from repro_torch.core.star_attention import STARConfig
from repro_torch.models.lm import BlockCfg, ModelCfg


def config() -> ModelCfg:
    return ModelCfg(
        name="seamless_m4t_large_v2",
        d_model=1024, n_layers=24, n_heads=16, n_kv=16, d_ff=8192,
        vocab=256206,
        pattern=(BlockCfg("attn", "dense", cross_attn=True),),
        enc_layers=24,
        norm="layernorm", mlp_act="relu", mlp_gated=False,
        rope_fraction=0.0,
        star=STARConfig(top_k_ratio=0.2),
    )


def smoke_config() -> ModelCfg:
    return ModelCfg(
        name="seamless_smoke",
        d_model=64, n_layers=2, n_heads=4, n_kv=4, d_ff=128, vocab=512,
        pattern=(BlockCfg("attn", "dense", cross_attn=True),),
        enc_layers=2,
        norm="layernorm", mlp_act="relu", mlp_gated=False,
        rope_fraction=0.0,
        star=STARConfig(top_k_ratio=0.5, block_q=16, block_kv=16),
        q_chunk=64, seq_loss_chunk=64, vocab_pad_to=64,
    )
