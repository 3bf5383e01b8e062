"""OLMo-1B [dense] — 16L d_model=2048 16H (kv=16) d_ff=8192 vocab=50304,
non-parametric LayerNorm.  [arXiv:2402.00838; hf] — the port's twin of
``repro.configs.olmo_1b`` (same fields, torch dtype)."""

from repro_torch.core.star_attention import STARConfig
from repro_torch.models.lm import BlockCfg, ModelCfg


def config() -> ModelCfg:
    return ModelCfg(
        name="olmo_1b",
        d_model=2048, n_layers=16, n_heads=16, n_kv=16, d_ff=8192,
        vocab=50304,
        pattern=(BlockCfg("attn", "dense"),),
        norm="nonparametric_ln", mlp_act="silu", mlp_gated=True,
        star=STARConfig(top_k_ratio=0.2),
    )


def smoke_config() -> ModelCfg:
    return ModelCfg(
        name="olmo_smoke",
        d_model=64, n_layers=2, n_heads=4, n_kv=4, d_ff=128, vocab=512,
        pattern=(BlockCfg("attn", "dense"),),
        norm="nonparametric_ln", mlp_act="silu", mlp_gated=True,
        star=STARConfig(top_k_ratio=0.5, block_q=16, block_kv=16),
        q_chunk=64, seq_loss_chunk=64, vocab_pad_to=64,
    )
