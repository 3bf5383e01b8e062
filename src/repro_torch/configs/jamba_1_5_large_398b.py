"""Jamba-1.5-large 398B [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16 experts top-2, Mamba:attention 7:1
interleave.  [arXiv:2403.19887; hf] — the port's twin of
``repro.configs.jamba_1_5_large_398b`` (same fields, torch dtypes).

Super-block pattern (x9): 8 layers, attention at index 4, MoE on odd
indices. Mamba layers use the SSD chunked form (``models.ssm``). Its
weights do not fit one card: on the H100 it serves at its published
width with its depth cut to the first layers of the published order
(``launch.serve.FULL_DEPTH_CUT``).
"""

from repro_torch.core.star_attention import STARConfig
from repro_torch.models.lm import BlockCfg, ModelCfg
from repro_torch.models.moe import MoECfg
from repro_torch.models.ssm import MambaCfg


def _pattern():
    blocks = []
    for i in range(8):
        kind = "attn" if i == 4 else "mamba"
        ffn = "moe" if i % 2 == 1 else "dense"
        blocks.append(BlockCfg(kind, ffn))
    return tuple(blocks)


def config() -> ModelCfg:
    return ModelCfg(
        name="jamba_1_5_large_398b",
        d_model=8192, n_layers=72, n_heads=64, n_kv=8, d_ff=24576,
        vocab=65536,
        pattern=_pattern(),
        norm="rmsnorm", mlp_act="silu", mlp_gated=True,
        moe=MoECfg(d_model=8192, d_ff=24576, n_experts=16, top_k=2),
        mamba=MambaCfg(d_model=8192, expand=2, head_dim=64, d_state=16),
        star=STARConfig(top_k_ratio=0.2),
        optimizer="adafactor", train_accum=8,
    )


def smoke_config() -> ModelCfg:
    return ModelCfg(
        name="jamba_smoke",
        d_model=64, n_layers=8, n_heads=4, n_kv=2, d_ff=128, vocab=512,
        pattern=_pattern(),
        norm="rmsnorm", mlp_act="silu", mlp_gated=True,
        moe=MoECfg(d_model=64, d_ff=128, n_experts=4, top_k=2,
                   token_chunk=64),
        mamba=MambaCfg(d_model=64, expand=2, head_dim=16, d_state=8,
                       chunk=32),
        star=STARConfig(top_k_ratio=0.5, block_q=16, block_kv=16),
        q_chunk=64, seq_loss_chunk=64, vocab_pad_to=64,
    )
