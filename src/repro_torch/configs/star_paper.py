"""The paper's own evaluation configuration (STAR on a LLaMA-7B-class
model, LTPP T=128, INT16-equivalent formal compute -> bf16 here) — the
port's twin of ``repro.configs.star_paper`` (same fields, torch dtype)."""

from repro_torch.core.star_attention import STARConfig
from repro_torch.models.lm import BlockCfg, ModelCfg


def config() -> ModelCfg:
    # LLaMA-7B shape, the paper's largest evaluated model.
    return ModelCfg(
        name="star_paper",
        d_model=4096, n_layers=32, n_heads=32, n_kv=32, d_ff=11008,
        vocab=32000,
        pattern=(BlockCfg("attn", "dense"),),
        norm="rmsnorm", mlp_act="silu", mlp_gated=True,
        star=STARConfig(top_k_ratio=0.2, block_q=128, block_kv=128,
                        radius=5.0),
    )


def smoke_config() -> ModelCfg:
    # the reference's ~100M-class config of examples/train_star_lm.py
    return ModelCfg(
        name="star_paper_100m",
        d_model=768, n_layers=12, n_heads=12, n_kv=12, d_ff=2048,
        vocab=32000,
        pattern=(BlockCfg("attn", "dense"),),
        norm="rmsnorm", mlp_act="silu", mlp_gated=True,
        star=STARConfig(top_k_ratio=0.25, block_q=64, block_kv=64),
        q_chunk=256, seq_loss_chunk=256, vocab_pad_to=256,
    )
