"""OLMoE-1B-7B [moe] — 16L d_model=2048 16H (kv=16) d_ff=1024 vocab=50304,
MoE 64 experts top-8.  [arXiv:2409.02060; hf] — the port's twin of
``repro.configs.olmoe_1b_7b`` (same fields, torch dtype)."""

from repro_torch.core.star_attention import STARConfig
from repro_torch.models.lm import BlockCfg, ModelCfg
from repro_torch.models.moe import MoECfg


def config() -> ModelCfg:
    return ModelCfg(
        name="olmoe_1b_7b",
        d_model=2048, n_layers=16, n_heads=16, n_kv=16, d_ff=1024,
        vocab=50304,
        pattern=(BlockCfg("attn", "moe"),),
        norm="rmsnorm", mlp_act="silu", mlp_gated=True,
        moe=MoECfg(d_model=2048, d_ff=1024, n_experts=64, top_k=8),
        star=STARConfig(top_k_ratio=0.2),
    )


def smoke_config() -> ModelCfg:
    return ModelCfg(
        name="olmoe_smoke",
        d_model=64, n_layers=2, n_heads=4, n_kv=4, d_ff=32, vocab=512,
        pattern=(BlockCfg("attn", "moe"),),
        norm="rmsnorm", mlp_act="silu", mlp_gated=True,
        moe=MoECfg(d_model=64, d_ff=32, n_experts=8, top_k=2,
                   token_chunk=64),
        star=STARConfig(top_k_ratio=0.5, block_q=16, block_kv=16),
        q_chunk=64, seq_loss_chunk=64, vocab_pad_to=64,
    )
