"""grok-1 314B [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2.  [hf:xai-org/grok-1; unverified] —
the port's twin of ``repro.configs.grok_1_314b`` (same fields, torch
dtype).

8 experts are fewer than the reference's 16-way expert axis, so each
expert's FFN is stored split 2 ways (16 virtual experts; ``models.moe``).
Its weights do not fit one card: on the H100 it serves at its published
width with its depth cut.
"""

from repro_torch.core.star_attention import STARConfig
from repro_torch.models.lm import BlockCfg, ModelCfg
from repro_torch.models.moe import MoECfg


def config() -> ModelCfg:
    return ModelCfg(
        name="grok_1_314b",
        d_model=6144, n_layers=64, n_heads=48, n_kv=8, d_ff=32768,
        vocab=131072,
        pattern=(BlockCfg("attn", "moe"),),
        norm="rmsnorm", mlp_act="gelu", mlp_gated=True,
        moe=MoECfg(d_model=6144, d_ff=32768, n_experts=8, top_k=2,
                   act="gelu"),
        star=STARConfig(top_k_ratio=0.2),
        optimizer="adafactor", train_accum=8,
    )


def smoke_config() -> ModelCfg:
    return ModelCfg(
        name="grok_smoke",
        d_model=64, n_layers=2, n_heads=4, n_kv=2, d_ff=128, vocab=512,
        pattern=(BlockCfg("attn", "moe"),),
        norm="rmsnorm", mlp_act="gelu", mlp_gated=True,
        moe=MoECfg(d_model=64, d_ff=128, n_experts=8, top_k=2, act="gelu",
                   token_chunk=64),
        star=STARConfig(top_k_ratio=0.5, block_q=16, block_kv=16),
        q_chunk=64, seq_loss_chunk=64, vocab_pad_to=64,
    )
