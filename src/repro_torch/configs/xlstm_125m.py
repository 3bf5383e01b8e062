"""xLSTM-125M [ssm] — 12L d_model=768 4H vocab=50304, alternating
mLSTM + sLSTM blocks, no FFN (d_ff=0).  [arXiv:2405.04517; unverified]
— the port's twin of ``repro.configs.xlstm_125m`` (same fields, torch
dtype).

STAR applicability: none — the model has no softmax attention, so it
runs no kernel of the port; it serves through the dense slot engine.
"""

from repro_torch.models.lm import BlockCfg, ModelCfg


def config() -> ModelCfg:
    return ModelCfg(
        name="xlstm_125m",
        d_model=768, n_layers=12, n_heads=4, n_kv=4, d_ff=0, vocab=50304,
        pattern=(BlockCfg("mlstm", "none"), BlockCfg("slstm", "none")),
        norm="layernorm", xlstm_heads=4, rope_fraction=0.0,
        star=None,
    )


def smoke_config() -> ModelCfg:
    return ModelCfg(
        name="xlstm_smoke",
        d_model=64, n_layers=2, n_heads=4, n_kv=4, d_ff=0, vocab=512,
        pattern=(BlockCfg("mlstm", "none"), BlockCfg("slstm", "none")),
        norm="layernorm", xlstm_heads=4, rope_fraction=0.0,
        star=None, q_chunk=64, seq_loss_chunk=64, vocab_pad_to=64,
    )
