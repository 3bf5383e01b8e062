"""Port parity: ``repro_torch.core`` (DLZS, SADS, SU-FA, STAR) against the
JAX reference ``repro.core`` on the same inputs.

Inputs are drawn with numpy from fixed seeds at the shapes of
tests/test_core_{dlzs,sads,sufa,star}.py and handed to both packages.
Tolerances: pow2 / LZ codes and tile selections must match bit for bit;
attention outputs agree to 2e-5 in fp32 (the reference tests' own bound).
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Smoke shapes run as fast on one thread, and the other test workers
# keep the remaining cores.
torch.set_num_threads(1)

from repro.core import dlzs as jdlzs  # noqa: E402
from repro.core import sads as jsads  # noqa: E402
from repro.core import sufa as jsufa  # noqa: E402
from repro_torch.core import dlzs as tdlzs  # noqa: E402
from repro_torch.core import sads as tsads  # noqa: E402
tstar = importlib.import_module("repro_torch.core.star_attention")
from repro_torch.core import sufa as tsufa  # noqa: E402

# ``repro.core`` re-exports the function ``star_attention`` under the
# module's own name, so the module is fetched by its dotted path.
jstar = importlib.import_module("repro.core.star_attention")

TOL = dict(rtol=2e-5, atol=2e-5)


def _np(t):
    return t.detach().numpy()


def _qkv(t, s, d, seed, peaked=True):
    rng = np.random.RandomState(seed)
    q = rng.randn(t, d).astype(np.float32)
    k = rng.randn(s, d).astype(np.float32)
    v = rng.randn(s, d).astype(np.float32)
    if peaked:   # a few dominant keys (paper Type I)
        k[: s // 16] *= 3.0
    return q, k, v


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


# -- DLZS ---------------------------------------------------------------------

def _dlzs_inputs(seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(4096) * 10.0).astype(np.float32)
    x[:2] = [0.0, -0.0]
    x[2:10] = [2.0 ** e for e in range(-4, 4)]
    return x


# Beyond the clip range of the int8 code (|exponent| > 63).
_EXTREMES = np.array([1e-30, -1e30, 2.0 ** 70, -(2.0 ** -70)], np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pow2_and_lz_codes_bit_exact(dtype):
    x = _dlzs_inputs(0)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    bits = np.uint32 if dtype == "float32" else np.uint16
    view = torch.int32 if dtype == "float32" else torch.int16

    jq = np.asarray(jdlzs.pow2_quantize(jx)).view(bits)
    tq = tdlzs.pow2_quantize(tx).view(view).numpy().view(bits)
    np.testing.assert_array_equal(tq, jq)

    jc = np.asarray(jdlzs.lz_pack(jx))
    tc = tdlzs.lz_pack(tx).numpy()
    np.testing.assert_array_equal(tc, jc)

    ju = np.asarray(jdlzs.lz_unpack(jnp.asarray(jc), jnp.float32))
    tu = tdlzs.lz_unpack(torch.from_numpy(tc), torch.float32).numpy()
    np.testing.assert_array_equal(tu.view(np.uint32), ju.view(np.uint32))


def test_lz_codes_clip_range_bit_exact():
    """The int8 codes clip identically far outside the model's range. The
    float reconstruction there is an exact power of two in the port; the
    reference's XLA ``exp2`` on the CPU is off by a few ulp for exponents
    beyond about ±12, so only the codes are compared with it."""
    jc = np.asarray(jdlzs.lz_pack(jnp.asarray(_EXTREMES)))
    tc = tdlzs.lz_pack(torch.from_numpy(_EXTREMES)).numpy()
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tc, [1, -127, 127, -1])
    tq = tdlzs.pow2_quantize(torch.from_numpy(_EXTREMES)).numpy()
    _, e = np.frexp(_EXTREMES)
    exact = np.sign(_EXTREMES) * np.ldexp(np.float32(1), e - 1)
    np.testing.assert_array_equal(tq, exact.astype(np.float32))


def test_dlzs_scores_match():
    q, k, _ = _qkv(64, 256, 64, seed=2, peaked=False)
    (jq, jk), (tq, tk) = _both(q, k)
    ref = jdlzs.dlzs_scores(jq, jdlzs.pow2_quantize(jk), 0.125)
    got = tdlzs.dlzs_scores(tq, tdlzs.pow2_quantize(tk), 0.125)
    np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)


# -- SADS ---------------------------------------------------------------------

@pytest.mark.parametrize("case", ["normal", "pow2_ties", "causal"])
def test_sads_select_blocks_bit_exact(case):
    """Tile ids, validity and order match the reference exactly,
    including the tie-heavy inputs (pow2-quantized scores; causally
    masked tiles that all equal NEG_INF) where top-k tie order matters."""
    rng = np.random.RandomState(1)
    scores = rng.randn(256, 1024).astype(np.float32)
    if case == "pow2_ties":
        scores = np.asarray(jdlzs.pow2_quantize(jnp.asarray(scores)))
    causal = case == "causal"
    bq, bkv, keep = (64, 64, 8) if causal else (64, 128, 4)
    (js,), (ts,) = _both(scores)
    ref = jsads.sads_select_blocks(js, bq, bkv, keep, radius=2.0,
                                   causal=causal)
    got = tsads.sads_select_blocks(ts, bq, bkv, keep, radius=2.0,
                                   causal=causal)
    np.testing.assert_array_equal(_np(got.block_idx),
                                  np.asarray(ref.block_idx))
    np.testing.assert_array_equal(_np(got.block_valid),
                                  np.asarray(ref.block_valid))
    np.testing.assert_array_equal(_np(got.block_max),
                                  np.asarray(ref.block_max))


def test_gather_blocks_match():
    kv = np.arange(8 * 4 * 2, dtype=np.float32).reshape(32, 2)
    idx = np.array([[3, 1], [0, 2]], np.int32)
    ref = jsads.gather_blocks(jnp.asarray(kv), jnp.asarray(idx), 8)
    got = tsads.gather_blocks(torch.from_numpy(kv),
                              torch.from_numpy(idx).long(), 8)
    np.testing.assert_array_equal(_np(got), np.asarray(ref))


# -- SU-FA --------------------------------------------------------------------

def _selection(q, k, keep, seed_mask=None):
    scale = 1.0 / np.sqrt(q.shape[-1])
    scores = (q @ k.T) * scale
    jsel = jsads.sads_select_blocks(jnp.asarray(scores), 64, 64, keep=keep,
                                    radius=1e9)
    tsel = tsads.BlockSelection(
        torch.from_numpy(np.asarray(jsel.block_idx)).long(),
        torch.from_numpy(np.asarray(jsel.block_valid)),
        torch.from_numpy(np.asarray(jsel.block_max)))
    return scale, jsel, tsel


@pytest.mark.parametrize("keep,strict", [(1, True), (2, True), (4, True),
                                         (4, False)])
def test_sufa_scan_matches(keep, strict):
    q, k, v = _qkv(256, 512, 64, seed=keep)
    scale, jsel, tsel = _selection(q, k, keep)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    ref = jsufa.sufa_scan(jq, jk, jv, jsel, scale=scale, block_q=64,
                          block_kv=64, strict=strict)
    got = tsufa.sufa_scan(tq, tk, tv, tsel, scale=scale, block_q=64,
                          block_kv=64, strict=strict)
    np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("elem", [False, True])
def test_sufa_gathered_matches(elem):
    q, k, v = _qkv(256, 512, 64, seed=6)
    scale, jsel, tsel = _selection(q, k, 4)
    emask = None
    if elem:
        emask = np.random.RandomState(7).rand(4, 4, 64, 64) < 0.8
        emask[:, 0, :, 0] = True
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    ref = jsufa.sufa_gathered(
        jq, jk, jv, jsel, scale=scale, block_q=64, block_kv=64,
        elem_mask=None if emask is None else jnp.asarray(emask))
    got = tsufa.sufa_gathered(
        tq, tk, tv, tsel, scale=scale, block_q=64, block_kv=64,
        elem_mask=None if emask is None else torch.from_numpy(emask))
    np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)


# -- STAR pipeline ------------------------------------------------------------

def _cfg_pair(**kw):
    return jstar.STARConfig(**kw), tstar.STARConfig(**kw)


@pytest.mark.parametrize("causal", [False, True])
def test_dense_attention_matches(causal):
    q, k, v = _qkv(256, 512 if not causal else 256, 64, seed=3)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    ref = jstar.dense_attention(jq, jk, jv, causal=causal)
    got = tstar.dense_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("variant", ["noncausal", "causal", "elementwise",
                                     "scan_strict", "scan_fast"])
def test_star_attention_matches(variant):
    kw = dict(top_k_ratio=0.25, block_q=64, block_kv=64)
    causal = variant != "noncausal"
    if variant == "elementwise":
        kw.update(radius=2.0, elementwise=True)
    if variant.startswith("scan"):
        kw.update(use_scan=True, strict=variant == "scan_strict")
    jcfg, tcfg = _cfg_pair(**kw)
    q, k, v = _qkv(256, 512 if not causal else 256, 64, seed=4)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    ref = jstar.star_attention(jq, jk, jv, jcfg, causal=causal)
    got = tstar.star_attention(tq, tk, tv, tcfg, causal=causal)
    np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_star_attention_scanq_prefix_groups(groups):
    """Query-chunked STAR (the model's prefill form), with causal prefix
    groups predicting only over their visible K prefix."""
    jcfg, tcfg = _cfg_pair(top_k_ratio=0.25, block_q=32, block_kv=32,
                           chunk_tiles=2, prefix_groups=groups)
    q, k, v = _qkv(512, 512, 32, seed=5)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    ref = jstar.star_attention_scanq(jq, jk, jv, jcfg, causal=True)
    got = tstar.star_attention_scanq(tq, tk, tv, tcfg, causal=True)
    np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)


def test_star_config_fields_match_reference():
    """The converter builds the port's STARConfig from the reference's
    fields: the two dataclasses must keep the same fields and defaults."""
    jf = {f.name: f.default for f in dataclasses.fields(jstar.STARConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tstar.STARConfig)}
    assert jf == tf
