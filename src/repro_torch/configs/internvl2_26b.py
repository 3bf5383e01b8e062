"""InternVL2-26B [vlm] — 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553, InternViT + InternLM2.  [arXiv:2404.16821; hf] — the port's
twin of ``repro.configs.internvl2_26b`` (same fields, torch dtype).

The ViT frontend is a stub: a batch may carry precomputed patch
embeddings (``batch["embeds"]``) in place of tokens; the serving engines
feed tokens.
"""

from repro_torch.core.star_attention import STARConfig
from repro_torch.models.lm import BlockCfg, ModelCfg


def config() -> ModelCfg:
    return ModelCfg(
        name="internvl2_26b",
        d_model=6144, n_layers=48, n_heads=48, n_kv=8, d_ff=16384,
        vocab=92553,
        pattern=(BlockCfg("attn", "dense"),),
        norm="rmsnorm", mlp_act="silu", mlp_gated=True,
        embeds_input=True,
        star=STARConfig(top_k_ratio=0.2),
        train_accum=2,
    )


def smoke_config() -> ModelCfg:
    return ModelCfg(
        name="internvl2_smoke",
        d_model=64, n_layers=2, n_heads=4, n_kv=2, d_ff=128, vocab=512,
        pattern=(BlockCfg("attn", "dense"),),
        norm="rmsnorm", mlp_act="silu", mlp_gated=True,
        embeds_input=True,
        star=STARConfig(top_k_ratio=0.5, block_q=16, block_kv=16),
        q_chunk=64, seq_loss_chunk=64, vocab_pad_to=64,
    )
