"""StarCoder2-15B [dense] — 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152, GQA + RoPE.  [arXiv:2402.19173; hf] — the port's twin of
``repro.configs.starcoder2_15b`` (same fields, torch dtype)."""

from repro_torch.core.star_attention import STARConfig
from repro_torch.models.lm import BlockCfg, ModelCfg


def config() -> ModelCfg:
    return ModelCfg(
        name="starcoder2_15b",
        d_model=6144, n_layers=40, n_heads=48, n_kv=4, d_ff=24576,
        vocab=49152,
        pattern=(BlockCfg("attn", "dense"),),
        norm="layernorm", mlp_act="gelu", mlp_gated=False,
        star=STARConfig(top_k_ratio=0.2),
    )


def smoke_config() -> ModelCfg:
    return ModelCfg(
        name="starcoder2_smoke",
        d_model=64, n_layers=2, n_heads=4, n_kv=2, d_ff=128, vocab=512,
        pattern=(BlockCfg("attn", "dense"),),
        norm="layernorm", mlp_act="gelu", mlp_gated=False,
        star=STARConfig(top_k_ratio=0.5, block_q=16, block_kv=16),
        q_chunk=64, seq_loss_chunk=64, vocab_pad_to=64,
    )
