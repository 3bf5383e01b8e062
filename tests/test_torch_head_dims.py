"""Port parity at head_dim 192 (Nemotron-4-340B: 96 heads of 192 over 8
KV heads, a GQA group of 12), on the CPU.

* Every registered config with attention layers has a head_dim that the
  forward tile kernels build (``kernels.launch.HEAD_DIMS``) and a
  (head_dim, GQA group) pair that K1 builds (``kernels.paged.SUPPORTED``):
  no model family is refused by the card's kernels.
* The plain versions of K1 (with padded slots, and the int8 tier's read
  path), K2, K3 (both modes; the element mask through the glue) and K4
  (causal, not causal, ragged) at d 192 against the JAX package's Pallas
  kernels in interpret mode and its oracles (``repro.kernels.ref``, the
  XLA gather, ``core.star_attention_scanq``).
* A 2-layer model with Nemotron's pattern (layernorm, squared ReLU, no
  gate) at head_dim 192 and group 12, its d_model narrowed through
  ``ModelCfg.head_dim``: prefill logits and greedy served tokens (paged,
  STAR and ``star=None``) against ``repro.models.lm`` and the JAX paged
  engine, weights through ``repro_torch.convert``.

Inputs are drawn with numpy from fixed seeds. Tolerances: fp32 at 2e-5
(the reference tests' bound), bf16 at 2e-2 (SU-FA too, inside its 3e-2
bound of tests/test_kernels.py); pow2 values and LZ codes bit for bit.
The CUDA kernels at d 192 are held against these plain versions on the
card in tests/test_torch_cuda.py.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Smoke shapes run as fast on one thread, and the other test workers
# keep the remaining cores.
torch.set_num_threads(1)

import engine_core_scenarios as scen  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.core import dlzs as jdlzs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import paged as jpaged  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.dlzs import _pow2_bitwise  # noqa: E402
from repro.kvcache import paged_attention as jpa  # noqa: E402
from repro.kvcache import quant as jquant  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import LLM as JLLM  # noqa: E402
from repro.serving import PagedEngineCfg as JPagedEngineCfg  # noqa: E402
from repro.serving import PagedServingEngine as JPaged  # noqa: E402
from repro.serving import SchedulerCfg as JSchedulerCfg  # noqa: E402
from repro_torch import convert, kernels  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import dlzs as tdlzs  # noqa: E402
from repro_torch.kernels import dlzs as kdlzs  # noqa: E402
from repro_torch.kernels import launch  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import paged as kpaged  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serving import (LLM, PagedEngineCfg,  # noqa: E402
                                 PagedServingEngine, SchedulerCfg)

tstar = importlib.import_module("repro_torch.core.star_attention")
jstar = importlib.import_module("repro.core.star_attention")

D = 192
R = 12
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _attention_archs() -> list:
    """The registered configs whose pattern holds an attention block."""
    return [a for a in registry.ARCHS
            if any(b.kind == "attn" for b in registry.get_config(a).pattern)]


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np32(got), _np32(want), **tol, err_msg=what)


def _both(arrays, dtype="float32"):
    """The same numpy arrays as JAX and torch tensors: floats in
    ``dtype``, integers and booleans as they are."""
    def j(a):
        return jnp.asarray(a).astype(getattr(jnp, dtype)) \
            if a.dtype == np.float32 else jnp.asarray(a)

    def t(a):
        x = torch.from_numpy(a.copy())
        return x.to(getattr(torch, dtype)) if a.dtype == np.float32 else x
    return [j(a) for a in arrays], [t(a) for a in arrays]


# -- every attention config is built -------------------------------------------

@pytest.mark.parametrize("arch", _attention_archs())
def test_every_attention_config_has_its_kernels(arch):
    """The config's head_dim is in the forward kernels' set and its
    (head_dim, n_heads / n_kv) pair in K1's, so neither its prefill (K2,
    K3, K4) nor its decode (K1) is refused on the card."""
    cfg = registry.get_config(arch)
    assert cfg.dh in launch.HEAD_DIMS
    assert (cfg.dh, cfg.n_heads // cfg.n_kv) in kpaged.SUPPORTED


def test_head_dim_sets():
    """Nemotron's head is built into the forwards and the backwards: K4's
    and K3's backwards take every head dim their forwards take, and every
    tile kernel refuses one that is not built, naming it."""
    assert (D, R) in kpaged.SUPPORTED and D in launch.HEAD_DIMS
    assert not hasattr(launch, "BWD_HEAD_DIMS")
    for d in launch.HEAD_DIMS:
        for kernel in ("flash", "flash_bwd", "sufa", "sufa_bwd"):
            launch.check_head_dim(kernel, d)
    for kernel in ("flash_bwd", "sufa_bwd"):
        with pytest.raises(ValueError, match="head_dim 96 not built"):
            launch.check_head_dim(kernel, 96)


# -- K1 --------------------------------------------------------------------------

def _k1_inputs(seed, b=3, g=2, n_pages=21, page=8, w=6,
               kv_len=(44, 19, 0)):
    """Query [B, G, R, d], pools [P, page, G, d], block tables with a
    padded slot inside one sequence and a sequence with kv_len 0."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, g, R, D).astype(np.float32)
    kp = rng.randn(n_pages, page, g, D).astype(np.float32)
    vp = (rng.randn(n_pages, page, g, D) * 2).astype(np.float32)
    phys = np.stack([rng.permutation(n_pages - 1)[:w] + 1
                     for _ in range(b)]).astype(np.int32)
    logical = np.tile(np.arange(w, dtype=np.int32), (b, 1))
    phys[1, 2], logical[1, 2] = 0, -1
    return q, kp, vp, phys, logical, np.asarray(kv_len, np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_paged_decode_matches_pallas_and_gather(dtype, seed):
    """K1's plain version at (192, 12) against the Pallas kernel in
    interpret mode (pool as [G, P, page, d]) and the reference's XLA
    gather; no launch off the card; an empty sequence gives zeros."""
    arrays = _k1_inputs(seed)
    (jq, jk, jv, jph, jlg, jkl), (q, k, v, ph, lg, kl) = _both(arrays,
                                                               dtype)
    b, g = q.shape[:2]
    kernels.reset_launches()
    got = kpaged.paged_decode_attention(q, k, v, ph, lg, kl,
                                        scale=D ** -0.5)
    assert kernels.LAUNCHES["paged_decode"] == 0
    pallas = jpaged.paged_decode_attention(
        jq, jnp.moveaxis(jk, 2, 0), jnp.moveaxis(jv, 2, 0), jph, jlg, jkl,
        scale=D ** -0.5, interpret=True)
    _close(got, pallas, TOL[dtype], "pallas")
    gather = jpa.paged_gather_decode(jq.reshape(b, g * R, D), jk, jv, jph,
                                     jlg, jkl, n_kv=g)
    _close(got.reshape(b, g * R, D), gather, TOL[dtype], "gather")
    assert float(got[2].float().abs().max()) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_int8_tier_matches_reference(dtype):
    """K1's int8 read path at (192, 12): the tier quantized by the
    reference's own quantizer (codes equal to the port's, bit for bit),
    a mixed qmask (a padded slot marked too), against the reference's
    gather with the same tier; the tier really is read."""
    from repro_torch.kvcache import quant as tquant
    arrays = _k1_inputs(2)
    (jq, jk, jv, jph, jlg, jkl), (q, k, v, ph, lg, kl) = _both(arrays,
                                                               dtype)
    b, g = q.shape[:2]
    jkq, jks = jquant.quantize_rows(jk)
    jvq, jvs = jquant.quantize_rows(jv)
    tkq, tks = tquant.quantize_rows(k)
    np.testing.assert_array_equal(tkq.numpy(), np.asarray(jkq))
    np.testing.assert_array_equal(tks.numpy(), np.asarray(jks))
    qmask = np.random.RandomState(3).rand(*arrays[3].shape) < 0.5
    qmask[1, 2] = True
    jtier = {"kq": jkq, "vq": jvq, "k_scale": jks, "v_scale": jvs,
             "qmask": jnp.asarray(qmask)}
    ttier = {name: torch.from_numpy(np.asarray(x).copy())
             for name, x in jtier.items()}
    got = kpaged.paged_decode_attention(q, k, v, ph, lg, kl,
                                        scale=D ** -0.5, quant=ttier)
    want = jpa.paged_gather_decode(jq.reshape(b, g * R, D), jk, jv, jph,
                                   jlg, jkl, n_kv=g, quant=jtier)
    mag = max(1.0, float(np.abs(_np32(want)).max()))
    tol = dict(TOL[dtype])
    tol["atol"] *= mag
    _close(got.reshape(b, g * R, D), want, tol)
    fp = kpaged.paged_decode_attention(q, k, v, ph, lg, kl, scale=D ** -0.5)
    assert not torch.equal(fp, got)


# -- K2 ------------------------------------------------------------------------

def _qkv(bh, t, s, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(bh, t, D).astype(np.float32)
    k = rng.randn(bh, s, D).astype(np.float32)
    v = rng.randn(bh, s, D).astype(np.float32)
    k[:, : s // 16] *= 3.0
    return q, k, v


@pytest.mark.parametrize("causal", [True, False])
def test_dlzs_blockmax_matches_pallas_and_ref(causal):
    """K2's plain version at d 192 against the Pallas kernel and the
    oracle, fp32 at 2e-5; its pow2 quantizer and LZ codes bit for bit."""
    q, k, _ = _qkv(2, 128, 256, seed=1)
    (jq, jk), (tq, tk) = _both((q, k))
    got = tops.dlzs_blockmax(tq, tk, causal=causal, block_q=64,
                             block_kv=64)
    _close(got, jops.dlzs_blockmax(jq, jk, causal=causal, block_q=64,
                                   block_kv=64), TOL["float32"], "pallas")
    _close(got, jref.dlzs_block_ref(jq, jk, causal=causal, block_q=64,
                                    block_kv=64), TOL["float32"], "ref")
    np.testing.assert_array_equal(
        kdlzs.pow2_bitwise(tk).numpy().view(np.uint32),
        np.asarray(_pow2_bitwise(jk)).view(np.uint32))
    np.testing.assert_array_equal(tdlzs.lz_pack(tk).numpy(),
                                  np.asarray(jdlzs.lz_pack(jk)))


# -- K3 ------------------------------------------------------------------------

def _selection(q, k, keep, block, causal, seed):
    """Tile ids [BH, n_qt, keep] in a random order (which the fast path's
    frozen max does not assume), valid where the tile holds a visible
    key, with one invalid slot."""
    bh, t, _ = q.shape
    n_qt, n_kt = t // block, k.shape[1] // block
    bmax = np.asarray(jref.dlzs_block_ref(jnp.asarray(q), jnp.asarray(k),
                                          causal=causal, block_q=block,
                                          block_kv=block))
    rng = np.random.RandomState(seed)
    idx = np.stack([rng.permutation(n_kt)[:keep]
                    for _ in range(bh * n_qt)]).reshape(bh, n_qt, keep)
    valid = np.take_along_axis(bmax, idx, axis=-1) > -1e29
    valid[0, 0, 0] = False
    return idx.astype(np.int64), valid


def _pallas_sufa(jq, jk, jv, idx, valid, *, block, causal, strict):
    """The Pallas kernel on the tiles and mask the JAX fused pipeline
    gathers for tile ids ``idx`` / ``valid``."""
    bh, t, d = jq.shape
    s = jk.shape[1]
    n_qt, n_kt = t // block, s // block
    keep = idx.shape[-1]
    idx, valid = jnp.asarray(idx), jnp.asarray(valid)
    take = lambda x: jnp.take_along_axis(  # noqa: E731
        x.reshape(bh, n_kt, block, d)[:, None], idx[..., None, None],
        axis=2)
    mask = jnp.broadcast_to(valid[..., None, None],
                            (bh, n_qt, keep, block, block))
    if causal:
        q_pos = (jnp.arange(t) + (s - t)).reshape(n_qt, block)
        kv_pos = idx[..., None] * block + jnp.arange(block)
        mask = mask & (kv_pos[:, :, :, None, :]
                       <= q_pos[None, :, None, :, None])
    return jops.sufa(jq, take(jk), take(jv), mask, strict=strict)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("causal", [True, False])
def test_sufa_matches_pallas(causal, strict, dtype):
    """K3's plain version at d 192 (tile ids read in place, S > T) in both
    modes against the Pallas kernel over the JAX gather of the same
    tiles; no launch off the card."""
    q, k, v = _qkv(2, 128, 256, seed=4)
    idx, valid = _selection(q, k, 3, 32, causal, seed=4)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), dtype)
    kernels.reset_launches()
    got = tops.sufa(tq, tk, tv, torch.from_numpy(idx),
                    torch.from_numpy(valid), block_q=32, block_kv=32,
                    causal=causal, strict=strict)
    assert kernels.LAUNCHES["sufa"] == 0
    _close(got, _pallas_sufa(jq, jk, jv, idx, valid, block=32,
                             causal=causal, strict=strict), TOL[dtype])


@pytest.mark.parametrize("mode", ["strict", "fast"])
def test_star_elementwise_matches_scanq(mode):
    """The glue at d 192 with ``STARConfig(elementwise=True)`` (K2 -> SADS
    -> K3 with its element mask; plain versions on the CPU) against the
    JAX ``star_attention_scanq`` over two q-chunks, fp32 at 2e-5; at
    radius 2 the sphere drops keys the tile selection keeps."""
    rs = np.random.RandomState(13)
    q, k, v = (rs.randn(2, 128, D).astype(np.float32) for _ in range(3))
    k[:, :8] *= 3.0
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v))
    cfg = dict(top_k_ratio=0.5, block_q=16, block_kv=16, radius=2.0,
               elementwise=True, use_scan=mode == "fast",
               strict=mode == "strict")
    got = tops.star_attention_cfg(tq, tk, tv, tstar.STARConfig(**cfg),
                                  causal=True)
    want = np.stack([np.asarray(jstar.star_attention_scanq(
        jq[i], jk[i], jv[i], jstar.STARConfig(**cfg), causal=True))
        for i in range(2)])
    _close(got, want, TOL["float32"])
    tile_only = tops.star_attention_cfg(
        tq, tk, tv, tstar.STARConfig(**dict(cfg, elementwise=False)),
        causal=True)
    assert float((tile_only - got).abs().max()) > 1e-2


# -- K4 ------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_pallas_and_ref(causal, dtype):
    """K4's plain version at d 192 against the Pallas kernel and the
    oracle (S > T); no launch off the card."""
    q, k, v = _qkv(2, 128, 256, seed=7)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), dtype)
    kernels.reset_launches()
    got = tops.flash(tq, tk, tv, causal=causal)
    assert kernels.LAUNCHES["flash"] == 0
    _close(got, jops.flash(jq, jk, jv, causal=causal, block_q=64,
                           block_kv=64), TOL[dtype], "pallas")
    _close(got, jref.flash_ref(jq, jk, jv, causal=causal), TOL[dtype],
           "ref")


@pytest.mark.parametrize("t,s", [(37, 37), (67, 131)])
def test_flash_ragged_matches_ref(t, s):
    """K4 takes any T and S (the oracle forward runs at prompt +
    generated tokens); the TPU kernel needs tile multiples, so the
    yardstick is the reference's oracle."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, t, s, seed=t))
    _close(tops.flash(tq, tk, tv, causal=True),
           jref.flash_ref(jq, jk, jv, causal=True), TOL["float32"])


# -- a model at head_dim 192 ---------------------------------------------------

@pytest.fixture(scope="module")
def nemotron_192():
    """Nemotron's smoke config at head_dim 192 and group 12 (24 heads
    over 2 KV heads, d_model 64), fp32, in both packages; the weights
    from ``repro.models.lm.init`` through the converter."""
    jcfg = dataclasses.replace(jget_smoke("nemotron_4_340b"), n_heads=24,
                               n_kv=2, head_dim=D, dtype=jnp.float32)
    assert (jcfg.dh, jcfg.n_heads // jcfg.n_kv) == (D, R)
    assert (jcfg.norm, jcfg.mlp_act, jcfg.mlp_gated) == (
        "layernorm", "relu2", False)
    jp = jlm.init(jax.random.PRNGKey(7), jcfg)
    tp = convert.to_torch(jax.tree.map(np.asarray, jp))
    return jcfg, jp, convert.model_cfg_from_reference(jcfg), tp


@pytest.mark.parametrize("attn", ["star", "dense"])
def test_model_prefill_matches_reference(nemotron_192, attn):
    """``lm.prefill`` logits at a ragged last index and the cache-free
    ``lm.forward`` at the same positions, with STAR and without, against
    the JAX ``lm.prefill``, fp32 at 2e-5."""
    jcfg, jp, tcfg, tp = nemotron_192
    if attn == "dense":
        jcfg = dataclasses.replace(jcfg, star=None)
        tcfg = dataclasses.replace(tcfg, star=None)
    toks = np.random.RandomState(1).randint(
        2, jcfg.vocab, size=(2, 48)).astype(np.int32)
    last = np.array([47, 30], np.int32)
    want, _ = jlm.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                          last_index=jnp.asarray(last))
    got, cache = tlm.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                             last_index=torch.from_numpy(last))
    _close(got, want, TOL["float32"], "prefill logits")
    assert cache["layers"]["b0"]["attn"]["k"].shape[-1] == D
    fwd = tlm.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    _close(fwd[torch.arange(2), torch.from_numpy(last).long()], want,
           TOL["float32"], "forward logits")


@pytest.mark.parametrize("attn", ["star", "dense"])
def test_model_served_tokens_match_reference_engine(nemotron_192, attn):
    """Greedy tokens served through the paged engine (whole prompts with
    STAR, so the port runs K2 -> SADS -> K3 at d 192; chunked prefill
    with ``star=None``) equal the JAX paged engine's on the same
    weights; K1's plain version serves every decode tick at (192, 12)."""
    jcfg, jp, tcfg, tp = nemotron_192
    if attn == "dense":
        jcfg = dataclasses.replace(jcfg, star=None)
        tcfg = dataclasses.replace(tcfg, star=None)
    prompts = scen._prompts(jcfg, (40, 57, 33))

    def pcfg(cls):
        return cls(max_batch=2, page_size=16, n_pages=32, hot_pages=8,
                   eos_id=-1)

    def scfg(cls):
        return cls(chunk_pages=None) if attn == "star" else cls()

    want = scen._run_llm(JLLM(JPaged(jcfg, jp, pcfg(JPagedEngineCfg),
                                     scfg(JSchedulerCfg))),
                         prompts, max_tokens=8)
    kernels.reset_launches()
    got = scen._run_llm(LLM(PagedServingEngine(
        tcfg, tp, pcfg(PagedEngineCfg), scfg(SchedulerCfg))), prompts,
        max_tokens=8)
    assert got == want
    assert not any(kernels.LAUNCHES.values())
