"""Nemotron-4-340B [dense] — 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000, squared-ReLU MLP.  [arXiv:2402.16819; unverified] — the
port's twin of ``repro.configs.nemotron_4_340b`` (same shapes and
training fields, torch dtype). Its head_dim of 192 and GQA group of 12
are built into every forward kernel (K1 at (192, 12), K2, K3, K4) and
into K4's and K3's backwards, so it serves and trains on the card:
``chip_smoke.py`` trains its published widths cut to 1 of 96 layers with
this Adafactor and ``train_accum``."""

from repro_torch.core.star_attention import STARConfig
from repro_torch.models.lm import BlockCfg, ModelCfg


def config() -> ModelCfg:
    return ModelCfg(
        name="nemotron_4_340b",
        d_model=18432, n_layers=96, n_heads=96, n_kv=8, d_ff=73728,
        vocab=256000,
        pattern=(BlockCfg("attn", "dense"),),
        norm="layernorm", mlp_act="relu2", mlp_gated=False,
        star=STARConfig(top_k_ratio=0.2),
        optimizer="adafactor", train_accum=8,
    )


def smoke_config() -> ModelCfg:
    return ModelCfg(
        name="nemotron_smoke",
        d_model=64, n_layers=2, n_heads=4, n_kv=2, d_ff=256, vocab=512,
        pattern=(BlockCfg("attn", "dense"),),
        norm="layernorm", mlp_act="relu2", mlp_gated=False,
        star=STARConfig(top_k_ratio=0.5, block_q=16, block_kv=16),
        q_chunk=64, seq_loss_chunk=64, vocab_pad_to=64,
    )
