"""Port parity: the encoder-decoder family (SeamlessM4T-large-v2) in
``repro_torch`` against ``repro.models`` at smoke size.

Weights come from ``repro.models.lm.init`` with every bias and norm
scale redrawn (numpy), and travel through ``repro_torch.convert``;
inputs are drawn with numpy from fixed seeds in the shapes of
``tests/test_models_smoke.py::_batch`` (encoder frames [2, 64, H] rounded
to bf16, decoder tokens) and handed to both packages. Held: the configs
and the converter (``enc_layers`` survives; ``enc_blocks``, ``enc_norm``,
``cross`` and ``norm_cross`` leaf for leaf), the port's own init against
the reference's tree, ``cross_encode`` / ``cross_apply`` at T != S (and
T = 1, the decode form) with and without GQA, the non-causal encoder
(``_encode``, with STAR and with ``star=None``), ``lm.prefill`` logits
and caches (the ``"cross"`` entries included) followed by three
``decode_step``s, the port's ``forward`` oracle, and the engines'
refusal of the family in both packages.

Tolerances: 2e-5 in fp32; 2e-2 in bf16, scaled by the tensor's largest
magnitude above 1 (tests/test_torch_model.py). STAR runs through the
whole model in fp32 and over one encoder and one decoder layer in bf16
(ROADMAP §3: through several bf16 layers two STAR implementations keep
other tiles); bf16 dense attention runs the whole smoke depth.
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
from repro.models import attention as jattention  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import dlzs as tdlzs  # noqa: E402
from repro_torch.models import attention as tattention  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402

ARCH = "seamless_m4t_large_v2"
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# (dtype, attention, layers per stack: None = the smoke config's)
VARIANTS = [("float32", "star", None), ("float32", "dense", None),
            ("bfloat16", "dense", None), ("bfloat16", "star", 1)]
IDS = [f"{d}-{a}-{n or 'all'}" for d, a, n in VARIANTS]
B, S_ENC = 2, 64
CACHE_LEN = 80


def _paths(tree):
    return [tuple(k.key for k in p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype, what):
    want = _np32(want)
    tol = dict(TOL[dtype])
    if dtype == "bfloat16":
        tol["atol"] *= max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(_np32(got), want, **tol, err_msg=what)


def _redraw_affine(params, seed):
    """Every bias and norm scale drawn anew (numpy, in the leaf's dtype):
    the reference initialises them to constants."""
    rng = np.random.RandomState(seed)

    def redraw(path, leaf):
        name = path[-1].key
        if name in ("bq", "bk", "bv", "bias"):
            new = 0.5 * rng.randn(*leaf.shape)
        elif name == "scale":
            new = 1.0 + 0.3 * rng.randn(*leaf.shape)
        else:
            return leaf
        return jnp.asarray(new.astype(np.float32)).astype(leaf.dtype)
    return jax.tree_util.tree_map_with_path(redraw, params)


def _jcfg(dtype, attn, layers):
    jcfg = jget_smoke(ARCH)
    return dataclasses.replace(
        jcfg, dtype=getattr(jnp, dtype),
        star=jcfg.star if attn == "star" else None,
        n_layers=layers or jcfg.n_layers,
        enc_layers=layers or jcfg.enc_layers)


@pytest.fixture(scope="module")
def models():
    """(jax cfg, jax params, torch cfg, torch params) per variant."""
    out = {}
    for variant in VARIANTS:
        jcfg = _jcfg(*variant)
        jp = _redraw_affine(jlm.init(jax.random.PRNGKey(3), jcfg), 4)
        tp = convert.to_torch(jax.tree.map(np.asarray, jp))
        out[variant] = (jcfg, jp, convert.model_cfg_from_reference(jcfg),
                        tp)
    return out


def _frames(shape, seed):
    """Frame embeddings as ``_batch`` draws them: normal, rounded to
    bf16; (jax, torch) with the same bits."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    j = jnp.asarray(x).astype(jnp.bfloat16)
    return j, convert.array_to_torch(np.asarray(j))


def _tokens(cfg, shape, seed):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab, size=shape).astype(np.int32)


def _batches(jcfg, t, seed):
    je, te = _frames((B, S_ENC, jcfg.d_model), seed)
    toks = _tokens(jcfg, (B, t), seed + 1)
    return ({"enc_embeds": je, "tokens": jnp.asarray(toks)},
            {"enc_embeds": te, "tokens": torch.from_numpy(toks)})


def _compare_cache(got_layers, want_layers, dtype, what):
    got = dict(tree_items(got_layers))
    want = dict(tree_items(jax.tree.map(np.asarray, want_layers)))
    assert set(got) == {tuple(p) for p in _paths(want_layers)}, what
    for path, leaf in got.items():
        if path[-1] == "k_lz":
            # the port's own K packed (the code is a pure function of K,
            # held bit for bit in test_torch_core.py)
            np.testing.assert_array_equal(
                leaf.numpy(), tdlzs.lz_pack(got[path[:-1] + ("k",)]).numpy(),
                err_msg=f"{what} {path}")
        else:
            _close(leaf, want[path], dtype, f"{what} {path}")


# -- configs and the converter -------------------------------------------------

def test_configs_resolve_field_for_field():
    """Published and smoke configs equal the reference's, converted;
    the encoder's depth survives the converter."""
    for get_t, get_j in ((tconfigs.get_config, jget_config),
                         (tconfigs.get_smoke_config, jget_smoke)):
        jcfg = get_j(ARCH)
        tcfg = convert.model_cfg_from_reference(jcfg)
        assert get_t(ARCH) == tcfg
        assert tcfg.enc_layers == jcfg.enc_layers > 0
        assert tcfg.pattern[0].cross_attn and not tcfg.embeds_input
    assert tconfigs.get_config(ARCH).enc_layers == 24


def test_converter_refuses_star_train():
    """Only STAR in training stays unported (ROADMAP §1 item 7)."""
    jcfg = dataclasses.replace(jget_smoke(ARCH), star_train=True)
    with pytest.raises(NotImplementedError, match="item 7"):
        convert.model_cfg_from_reference(jcfg)


@pytest.mark.parametrize("variant", [VARIANTS[0], VARIANTS[2]], ids=IDS[::2])
def test_converter_round_trip(models, variant):
    jcfg, jp, tcfg, tp = models[variant]
    back = convert.to_numpy(tp)
    paths = _paths(jp)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(jp)[0],
            jax.tree_util.tree_flatten_with_path(back)[0]):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    for prefix in (("enc_blocks", "b0", "core", "wq"), ("enc_norm", "scale"),
                   ("blocks", "b0", "cross", "wk"),
                   ("blocks", "b0", "norm_cross", "bias")):
        assert prefix in paths, prefix
    assert tuple(tp["enc_blocks"]["b0"]["core"]["wq"].shape) == \
        (jcfg.enc_layers, jcfg.d_model, jcfg.n_heads, jcfg.dh)


def test_port_init_matches_reference_tree():
    """The port's own init (no JAX on the card's machine) builds the
    reference's tree, encoder and cross-attention included; the cross
    projections are drawn as the self-attention's are."""
    jcfg = jget_smoke(ARCH)
    tcfg = tconfigs.get_smoke_config(ARCH)
    shapes = jax.eval_shape(lambda: jlm.init(jax.random.PRNGKey(0), jcfg))
    tp = tlm.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    want = {tuple(p): (s.shape, np.dtype(s.dtype).name)
            for p, s in zip(_paths(shapes), jax.tree.leaves(shapes))}
    got = {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for p, t in tree_items(tp)}
    assert got == want
    jp = jlm.init(jax.random.PRNGKey(0), jcfg)
    for path in (("blocks", "b0", "cross", "wq"),
                 ("enc_blocks", "b0", "core", "wv")):
        a = np.asarray(jp[path[0]][path[1]][path[2]][path[3]], np.float32)
        t = tp[path[0]][path[1]][path[2]][path[3]].float().numpy()
        np.testing.assert_allclose(t.std(), a.std(), rtol=0.1)


# -- cross-attention -----------------------------------------------------------

def _cross_cfgs(dtype, gqa):
    kw = dict(d_model=64, n_heads=4, n_kv=2 if gqa else 4, head_dim=16,
              rope_fraction=0.0, qkv_bias=gqa, causal=False)
    return (jattention.AttentionCfg(dtype=getattr(jnp, dtype), **kw),
            tattention.AttentionCfg(dtype=getattr(torch, dtype), **kw))


@pytest.mark.parametrize("t", [1, 24])
@pytest.mark.parametrize("gqa", [False, True], ids=["mha", "gqa"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_encode_and_apply_match(dtype, gqa, t):
    """K/V of the encoder output, then queries of T rows (1: the decode
    form; 24: K4 non-causal) against S_ENC = 64 encoder rows."""
    jcfg, tcfg = _cross_cfgs(dtype, gqa)
    jp = _redraw_affine(jattention.cross_init(jax.random.PRNGKey(9), jcfg),
                        10)
    tp = convert.to_torch(jax.tree.map(np.asarray, jp))
    jenc, tenc = _frames((B, S_ENC, 64), 11)
    jx, tx = _frames((B, t, 64), 12)
    jenc, jx = jenc.astype(jcfg.dtype), jx.astype(jcfg.dtype)
    tenc, tx = tenc.to(tcfg.dtype), tx.to(tcfg.dtype)
    want_kv = jattention.cross_encode(jp, jcfg, jenc)
    got_kv = tattention.cross_encode(tp, tcfg, tenc)
    for name in ("k", "v"):
        assert tuple(got_kv[name].shape) == (B, S_ENC, tcfg.n_kv, 16)
        _close(got_kv[name], want_kv[name], dtype, f"cross {name}")
    want = jattention.cross_apply(jp, jcfg, jx, want_kv)
    got = tattention.cross_apply(tp, tcfg, tx, got_kv)
    assert tuple(got.shape) == (B, t, 64)
    _close(got, want, dtype, "cross_apply")


# -- the model -----------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS, ids=IDS)
def test_encode_matches(models, variant):
    """The encoder stack, non-causal (STAR: K2 -> SADS -> K3 in their
    plain versions here), then ``enc_norm``."""
    jcfg, jp, tcfg, tp = models[variant]
    jb, tb = _batches(jcfg, 16, 20)
    want = jlm._encode(jp, jcfg, jb)
    got = tlm._encode(tp, tcfg, tb)
    assert got.dtype == tcfg.dtype
    _close(got, want, variant[0], "encoder output")


@pytest.mark.parametrize("variant,t", [(v, 64) for v in VARIANTS]
                         + [(VARIANTS[0], 32)],
                         ids=[f"{i}-64" for i in IDS] + [f"{IDS[0]}-32"])
def test_prefill_then_decode_matches(models, variant, t):
    """``lm.prefill`` (decoder prompts of T = S_ENC and T < S_ENC):
    last-token logits and every cache leaf, the per-layer cross K/V
    included; then three ``decode_step``s on the same tokens, each
    reading the cross K/V from the cache."""
    jcfg, jp, tcfg, tp = models[variant]
    dtype = variant[0]
    jb, tb = _batches(jcfg, t, 30 + t)
    want_logits, want_cache = jlm.prefill(jp, jcfg, jb, cache_len=CACHE_LEN)
    got_logits, got_cache = tlm.prefill(tp, tcfg, tb, cache_len=CACHE_LEN)
    _close(got_logits, want_logits, dtype, "prefill logits")
    _compare_cache(got_cache["layers"], want_cache["layers"], dtype,
                   "prefill cache")
    cross = got_cache["layers"]["b0"]["cross"]["k"]
    assert tuple(cross.shape) == (tcfg.n_layers, B, S_ENC, tcfg.n_kv,
                                  tcfg.dh)
    steps = _tokens(jcfg, (3, B, 1), 40 + t)
    for i, toks in enumerate(steps):
        want_logits, want_cache = jlm.decode_step(
            jp, jcfg, jnp.asarray(toks), want_cache)
        got_logits, got_cache = tlm.decode_step(
            tp, tcfg, torch.from_numpy(toks), got_cache)
        _close(got_logits, want_logits, dtype, f"decode step {i}")
        np.testing.assert_array_equal(got_cache["lengths"].numpy(),
                                      np.asarray(want_cache["lengths"]))
    _compare_cache(got_cache["layers"], want_cache["layers"], dtype,
                   "cache after decode")


@pytest.mark.parametrize("variant", VARIANTS[:2], ids=IDS[:2])
def test_forward_matches_prefill_logits(models, variant):
    """The port's cache-free ``forward`` (chip_smoke's oracle) at a
    position equals the reference prefill's logits there."""
    jcfg, jp, tcfg, tp = models[variant]
    jb, tb = _batches(jcfg, 48, 50)
    got = tlm.forward(tp, tcfg, tb)
    assert tuple(got.shape) == (B, 48, tcfg.vocab_padded)
    for j in (47, 20):
        want, _ = jlm.prefill(jp, jcfg, jb,
                              last_index=jnp.full((B,), j, jnp.int32))
        _close(got[:, j], want, variant[0], f"position {j}")


# -- serving -------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["paged", "dense"])
@pytest.mark.parametrize("package", ["reference", "port"])
def test_engines_refuse_the_family(package, backend):
    """Neither engine of either package serves an encoder-decoder model:
    a request carries no encoder input. The reference's paged engine
    names the reason; its dense engine fails at its dummy prefill for
    want of ``enc_tokens``; the port's engines refuse before building
    anything."""
    if package == "reference":
        from repro.serving import LLM as JLLM
        jcfg = jget_smoke(ARCH)
        jp = jlm.init(jax.random.PRNGKey(0), jcfg)
        err = (ValueError, "causal decoder-only") if backend == "paged" \
            else (KeyError, "enc_tokens")
        with pytest.raises(err[0], match=err[1]):
            JLLM.from_config(jcfg, backend=backend, params=jp)
        return
    from repro_torch.serving import LLM
    cfg = tconfigs.get_smoke_config(ARCH)
    params = tlm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    match = "causal decoder-only" if backend == "paged" \
        else "encoder-decoder model runs through lm.prefill"
    with pytest.raises(ValueError, match=match):
        LLM.from_config(cfg, backend=backend, params=params, device="cpu")
