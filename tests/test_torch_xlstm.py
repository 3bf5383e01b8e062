"""Port parity: the xLSTM blocks (``repro_torch.models.xlstm``) and the
xLSTM model, against ``repro.models.xlstm`` and ``repro.models.lm`` at
smoke size; and what both recurrent families share at the entry points.

* ``mlstm_apply`` / ``mlstm_decode`` (the SSD core with the normaliser
  column) at S = 64 and 17 (prime: chunk 17), and ``slstm_apply`` /
  ``slstm_decode`` (the time loop), fp32 and bf16.
* xLSTM smoke (mLSTM + sLSTM, layernorm, no FFN): ``lm.prefill``, two
  ``decode_step`` ticks and ``lm.forward``; greedy tokens of the port's
  dense engine against the JAX dense ``ServingEngine``; the port's init
  against the reference's tree and each leaf's spread (the per-head
  weights are drawn 2-D, so their fan-in is d_model, not their leading
  axis).
* The registry resolves ``jamba_1_5_large_398b`` and ``xlstm_125m`` field
  for field; the paged and spatial engines refuse both patterns, with
  the reference's ``ValueError``; a recurrent block refuses the
  pool-backed modes.

Tolerances: 2e-5 x max(1, |ref|max) in fp32, 2e-2 x max(1, |ref|max) in
bf16 (``tests/test_torch_ssm.py``'s helpers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Smoke shapes run as fast on one thread, and the other test workers
# keep the remaining cores.
torch.set_num_threads(1)

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import xlstm as txlstm  # noqa: E402
from repro_torch.serving import LLM  # noqa: E402
from test_torch_ssm import (both, close, close_trees,  # noqa: E402
                            engine_tokens_match, init_matches_reference,
                            layer0, model_params_and_cache_match, models)

RECURRENT_ARCHS = ("jamba_1_5_large_398b", "xlstm_125m")


# -- the blocks ----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,s", [("mlstm", 64), ("mlstm", 17),
                                    ("slstm", 17)])
def test_block_apply_and_decode(kind, s, dtype):
    """``{kind}_apply`` with its cache, then two ``{kind}_decode`` steps
    from it, on layer 0 of the xLSTM smoke config's block of that kind."""
    jcfg, jp, tcfg, tp = models("xlstm_125m", dtype, False)
    key = "b0" if kind == "mlstm" else "b1"
    jparams, tparams = layer0(jp["blocks"][key]["core"],
                              tp["blocks"][key]["core"])
    jx, tx_cfg = jcfg.xlstm_cfg(), tcfg.xlstm_cfg()
    rng = np.random.RandomState(s)
    x = rng.randn(2, s + 2, jcfg.d_model).astype(np.float32)
    (jxs,), (txs,) = both((x,), dtype)
    japply, jdecode = getattr(jxlstm, f"{kind}_apply"), \
        getattr(jxlstm, f"{kind}_decode")
    tapply, tdecode = getattr(txlstm, f"{kind}_apply"), \
        getattr(txlstm, f"{kind}_decode")
    want, jcache = japply(jparams, jx, jxs[:, :s], make_cache=True)
    got, tcache = tapply(tparams, tx_cfg, txs[:, :s], make_cache=True)
    close(got, want, dtype, f"{kind}_apply")
    close_trees(tcache, jcache, dtype, f"{kind}_apply cache")
    for t in range(s, s + 2):
        want, jcache = jdecode(jparams, jx, jxs[:, t:t + 1], jcache)
        got, tcache = tdecode(tparams, tx_cfg, txs[:, t:t + 1], tcache)
        close(got, want, dtype, f"{kind}_decode at {t}")
        close_trees(tcache, jcache, dtype, f"{kind}_decode cache at {t}")


# -- the xLSTM model -----------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xlstm_prefill_decode_forward(dtype):
    model_params_and_cache_match("xlstm_125m", dtype, False, seq_len=40,
                                 max_len=64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xlstm_dense_engine_tokens(dtype):
    """More prompts than slots (state slabs reused), a prime-length
    prompt (chunk 17) and a request of one token."""
    engine_tokens_match("xlstm_125m", dtype, False, (5, 17, 32))


def test_xlstm_init_matches_reference():
    init_matches_reference("xlstm_125m")


# -- the entry points ----------------------------------------------------

@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_registry_resolves_the_recurrent_configs(arch):
    """``repro_torch.configs`` resolves both archs to the reference's
    published and smoke configs, field for field; the converter maps the
    Mamba config with its torch dtype."""
    assert arch in tconfigs.ARCHS
    assert tconfigs.get_config(arch) == \
        convert.model_cfg_from_reference(jget_config(arch))
    assert tconfigs.get_smoke_config(arch) == \
        convert.model_cfg_from_reference(jget_smoke(arch))
    assert tconfigs.registry.NOT_YET_PORTED == ()
    jcfg = jget_config(arch)
    if jcfg.mamba is not None:
        mcfg = convert.mamba_cfg_from_reference(jcfg.mamba)
        assert mcfg.dtype == torch.bfloat16 and mcfg.n_heads == 256
        assert mcfg.d_inner == 16384 and mcfg.chunk == 256


@pytest.mark.parametrize("backend", ["paged", "spatial"])
@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_pool_backed_engines_refuse_recurrent_patterns(arch, backend):
    """As in the reference, only the dense slot engine serves a pattern
    with a recurrent block; the spatial engine's check comes before its
    refusal of STAR, as the reference's does."""
    cfg = tconfigs.get_smoke_config(arch)
    params = tlm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match=f"{backend} engine supports "
                                         f"attention-only patterns"):
        LLM.from_config(cfg, backend=backend, params=params, device="cpu")


def test_recurrent_block_refuses_pool_backed_modes():
    """A Mamba block has no paged mode: ``prefill_chunk_paged`` raises
    before it reaches any pool."""
    cfg = dataclasses.replace(tconfigs.get_smoke_config(
        "jamba_1_5_large_398b"), star=None)
    params = tlm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    state = {"past_len": torch.zeros((1,), dtype=torch.int32)}
    with pytest.raises(ValueError, match="attention-only patterns"):
        tlm.prefill_chunk_paged(params, cfg, {"tokens": torch.zeros(
            (1, 16), dtype=torch.int32)}, {"layers": None}, state)
