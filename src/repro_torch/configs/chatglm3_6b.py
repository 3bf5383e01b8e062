"""ChatGLM3-6B [dense] — 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024, 2d-RoPE (rotary on half the head dim), QKV bias.
[arXiv:2406.12793; hf] — the port's twin of ``repro.configs.chatglm3_6b``
(same fields, torch dtype)."""

from repro_torch.core.star_attention import STARConfig
from repro_torch.models.lm import BlockCfg, ModelCfg


def config() -> ModelCfg:
    return ModelCfg(
        name="chatglm3_6b",
        d_model=4096, n_layers=28, n_heads=32, n_kv=2, d_ff=13696,
        vocab=65024,
        pattern=(BlockCfg("attn", "dense"),),
        norm="rmsnorm", mlp_act="silu", mlp_gated=True,
        rope_fraction=0.5, qkv_bias=True,
        star=STARConfig(top_k_ratio=0.2),
    )


def smoke_config() -> ModelCfg:
    return ModelCfg(
        name="chatglm3_smoke",
        d_model=64, n_layers=2, n_heads=4, n_kv=2, d_ff=128, vocab=512,
        pattern=(BlockCfg("attn", "dense"),),
        norm="rmsnorm", mlp_act="silu", mlp_gated=True,
        rope_fraction=0.5, qkv_bias=True,
        star=STARConfig(top_k_ratio=0.5, block_q=16, block_kv=16),
        q_chunk=64, seq_loss_chunk=64, vocab_pad_to=64,
    )
