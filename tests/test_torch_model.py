"""Port parity: the attention-only decoder (``repro_torch.models.lm``)
against ``repro.models.lm`` on the olmo smoke config.

Weights come from ``repro.models.lm.init`` and travel through
``repro_torch.convert``; pool slabs, prompts and block tables are drawn
with numpy from fixed seeds and handed to both packages. Every path of
the paged engine is held: ``prefill``, ``prefill_chunk_paged``,
``prefill_chunk_batch_paged`` (with and without the chunk-sparse DLZS
sphere) and ``decode_step_paged`` (with the audit probe), with
``star=None`` and with STAR, in fp32 and bf16. Logits and the fp cache
leaves agree to 2e-5 in fp32 (the reference tests' bound) and 2e-2 in
bf16 (tests/test_kernels.py's bf16 bound). In bf16 the absolute bound
scales with the tensor's largest magnitude when that exceeds 1: XLA and
PyTorch sum a bf16 matmul in different orders, so a hidden state of
magnitude m can land one bf16 step (m/128) apart, and that step carries
into the next layer's K and logits.

The int8 LZ codes of K are compared exactly wherever the two K values
are bit-identical; everywhere they are the port's own K packed (the code
is a pure function of K, held bit for bit in test_torch_core.py).
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

from repro.configs import get_smoke_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import olmo_1b as tolmo  # noqa: E402
from repro_torch.core import dlzs as tdlzs  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
PAGE = 16
N_PAGES = 12

VARIANTS = [("float32", "dense"), ("float32", "star"),
            ("bfloat16", "dense"), ("bfloat16", "star")]
# the chunk paths also run with the chunk-sparse DLZS sphere (needs STAR)
CHUNK_VARIANTS = [(d, a, False) for d, a in VARIANTS] + [
    ("float32", "star", True), ("bfloat16", "star", True)]


def _cfgs(dtype: str, attn: str, chunk_sparse: bool = False):
    jcfg = get_smoke_config("olmo_1b")
    jcfg = dataclasses.replace(
        jcfg, dtype=getattr(jnp, dtype),
        star=None if attn == "dense" else jcfg.star,
        star_chunk_sparse=chunk_sparse)
    return jcfg, convert.model_cfg_from_reference(jcfg)


@pytest.fixture(scope="module")
def models():
    """(jax cfg, jax params, torch cfg, torch params) per variant."""
    out = {}
    for dtype, attn in VARIANTS:
        for sparse in (False, True):
            if sparse and attn == "dense":
                continue
            jcfg, tcfg = _cfgs(dtype, attn, sparse)
            jp = jlm.init(jax.random.PRNGKey(7), jcfg)
            tp = convert.to_torch(jax.tree.map(np.asarray, jp))
            out[dtype, attn, sparse] = (jcfg, jp, tcfg, tp)
    return out


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


def _lz_close(got_lz, want_lz, got_k, want_k, what):
    """LZ codes equal the reference's wherever K is bit-identical, and
    are the port's own K packed everywhere."""
    same = _np32(got_k) == _np32(want_k)
    np.testing.assert_array_equal(got_lz.numpy()[same],
                                  np.asarray(want_lz)[same], err_msg=what)
    np.testing.assert_array_equal(got_lz.numpy(),
                                  tdlzs.lz_pack(got_k).numpy(), err_msg=what)


def _compare_cache(got_layers, want_layers, dtype, what):
    got = dict(tree_items(got_layers))
    want = dict(tree_items(jax.tree.map(np.asarray, want_layers)))
    assert set(got) == {tuple(p) for p in _paths(want_layers)}, what
    for path, leaf in got.items():
        if path[-1] == "k_lz":
            kp = path[:-1] + ("k",)
            _lz_close(leaf, want[path], got[kp], want[kp], f"{what} {path}")
        elif path[-1] != "audit_mass":
            _close(leaf, want[path], dtype, f"{what} {path}")


def _paths(tree):
    return [tuple(k.key for k in p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _tokens(cfg, shape, seed):
    return np.random.RandomState(seed).randint(
        2, cfg.vocab, size=shape).astype(np.int32)


def _pool(jcfg, seed):
    """Random pool slabs [L, P, page, nkv, dh] (+ the LZ slab) as the
    engine holds them, in the model's dtype, for both packages."""
    rng = np.random.RandomState(seed)
    shape = (jcfg.n_layers, N_PAGES, PAGE, jcfg.n_kv, jcfg.dh)
    k = jnp.asarray(rng.randn(*shape).astype(np.float32)).astype(jcfg.dtype)
    v = jnp.asarray(rng.randn(*shape).astype(np.float32)).astype(jcfg.dtype)
    from repro.core import dlzs
    jtree = {"b0": {"attn": {"k": k, "v": v, "k_lz": dlzs.lz_pack(k)}}}
    return jtree, convert.to_torch(jax.tree.map(np.asarray, jtree))


# -- converter ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_converter_round_trip(models, dtype):
    jcfg, jp, tcfg, tp = models[dtype, "star", False]
    assert tcfg.dtype == getattr(torch, dtype) and tcfg.star is not None
    back = convert.to_numpy(tp)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(jp)[0],
            jax.tree_util.tree_flatten_with_path(back)[0]):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    # the stacked layer axis of the vmapped init is kept leaf for leaf
    assert tuple(tp["blocks"]["b0"]["core"]["wq"].shape) == \
        (jcfg.n_layers, jcfg.d_model, jcfg.n_heads, jcfg.dh)


def test_converter_rejects_unported_families():
    moe = get_smoke_config("olmoe_1b_7b")
    with pytest.raises(NotImplementedError, match="not ported"):
        convert.model_cfg_from_reference(moe)


def test_port_init_matches_reference_tree():
    """The port's own init (no JAX on the card's machine) builds the
    reference's tree: same keys, shapes and dtypes."""
    jcfg = get_smoke_config("olmo_1b")
    tcfg = tolmo.smoke_config()
    assert tcfg == convert.model_cfg_from_reference(jcfg)
    shapes = jax.eval_shape(lambda: jlm.init(jax.random.PRNGKey(0), jcfg))
    tp = tlm.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    want = {tuple(p): (s.shape, np.dtype(s.dtype).name)
            for p, s in zip(_paths(shapes), jax.tree.leaves(shapes))}
    got = {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for p, t in tree_items(tp)}
    assert got == want
    w = tp["blocks"]["b0"]["ffn"]["w1"].float()
    assert float(w.abs().max()) <= 2.0 / np.sqrt(jcfg.d_model) + 1e-6


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    """Without a GPU, an entry point raises unless the caller asked for
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.init(tolmo.smoke_config(), torch.Generator(), None)


# -- forward paths ------------------------------------------------------------

@pytest.mark.parametrize("dtype,attn", VARIANTS)
def test_prefill_matches(models, dtype, attn):
    jcfg, jp, tcfg, tp = models[dtype, attn, False]
    toks = _tokens(jcfg, (2, 48), seed=1)
    last = np.array([47, 30], np.int32)
    want_logits, want_cache = jlm.prefill(
        jp, jcfg, {"tokens": jnp.asarray(toks)},
        last_index=jnp.asarray(last))
    got_logits, got_cache = tlm.prefill(
        tp, tcfg, {"tokens": torch.from_numpy(toks)},
        last_index=torch.from_numpy(last))
    _close(got_logits, want_logits, dtype, "logits")
    np.testing.assert_array_equal(got_cache["lengths"].numpy(),
                                  np.asarray(want_cache["lengths"]))
    _compare_cache(got_cache["layers"], want_cache["layers"], dtype,
                   "prefill cache")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_forward_matches_prefill(models, dtype):
    """``lm.forward`` (the serving path's exactness oracle) gives every
    position's logits: each equals the reference's prefill at that
    position."""
    jcfg, jp, tcfg, tp = models[dtype, "dense", False]
    toks = _tokens(jcfg, (1, 40), seed=2)
    got = tlm.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    assert tuple(got.shape) == (1, 40, jcfg.vocab_padded)
    for j in (0, 17, 39):
        want, _ = jlm.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                              last_index=jnp.asarray([j]))
        _close(got[:, j], want, dtype, f"position {j}")


@pytest.mark.parametrize("dtype,attn,sparse", CHUNK_VARIANTS)
def test_prefill_chunk_paged_matches(models, dtype, attn, sparse):
    jcfg, jp, tcfg, tp = models[dtype, attn, sparse]
    jpool, tpool = _pool(jcfg, seed=3)
    toks = _tokens(jcfg, (2, 32), seed=4)
    past_phys = np.array([[3, 7, 1, -1], [5, 2, -1, -1]], np.int32)
    past_logical = np.array([[0, 1, 2, -1], [0, 1, -1, -1]], np.int32)
    past_len = np.array([45, 32], np.int32)       # 45: a partial page
    last = np.array([31, 12], np.int32)
    state = dict(past_phys=past_phys, past_logical=past_logical,
                 past_len=past_len, last_index=last)
    want_logits, want_cache = jlm.prefill_chunk_paged(
        jp, jcfg, {"tokens": jnp.asarray(toks)}, {"layers": jpool},
        {k: jnp.asarray(v) for k, v in state.items()})
    got_logits, got_cache = tlm.prefill_chunk_paged(
        tp, tcfg, {"tokens": torch.from_numpy(toks)}, {"layers": tpool},
        {k: torch.from_numpy(v) for k, v in state.items()})
    _close(got_logits, want_logits, dtype, "logits")
    _compare_cache(got_cache["layers"], want_cache["layers"], dtype,
                   "chunk cache")


@pytest.mark.parametrize("dtype,attn,sparse", CHUNK_VARIANTS)
def test_prefill_chunk_batch_paged_matches(models, dtype, attn, sparse):
    jcfg, jp, tcfg, tp = models[dtype, attn, sparse]
    jpool, tpool = _pool(jcfg, seed=5)
    # lane 0: first chunk (no past); lane 2: a later chunk over 2 pages of
    # past; a padding tail; lane 1 idle. Flat width 64 tokens.
    seg = np.full((64,), -1, np.int32)
    pos = np.zeros((64,), np.int32)
    seg[0:16], pos[0:16] = 0, np.arange(16)
    seg[16:48], pos[16:48] = 2, 32 + np.arange(32)
    toks = _tokens(jcfg, (1, 64), seed=6)
    past_phys = np.array([4, 9, -1, -1, -1, -1, -1, -1], np.int32)
    past_lane = np.array([2, 2, -1, -1, -1, -1, -1, -1], np.int32)
    past_logical = np.array([0, 1, -1, -1, -1, -1, -1, -1], np.int32)
    state = dict(seg_ids=seg, positions=pos, past_phys=past_phys,
                 past_lane=past_lane, past_logical=past_logical,
                 past_len=np.array([0, 0, 32], np.int32),
                 last_index=np.array([15, 0, 47], np.int32))
    want_logits, want_cache = jlm.prefill_chunk_batch_paged(
        jp, jcfg, {"tokens": jnp.asarray(toks)}, {"layers": jpool},
        {k: jnp.asarray(v) for k, v in state.items()})
    got_logits, got_cache = tlm.prefill_chunk_batch_paged(
        tp, tcfg, {"tokens": torch.from_numpy(toks)}, {"layers": tpool},
        {k: torch.from_numpy(v) for k, v in state.items()})
    _close(got_logits, want_logits, dtype, "logits")
    _compare_cache(got_cache["layers"], want_cache["layers"], dtype,
                   "batched chunk cache")


@pytest.mark.parametrize("audit", [False, True])
@pytest.mark.parametrize("dtype,attn", VARIANTS)
def test_decode_step_paged_matches(models, dtype, attn, audit):
    """One decode tick: logits, the in-place pool writes (k, v, k_lz) and,
    with the audit flag, the per-layer page masses."""
    jcfg, jp, tcfg, tp = models[dtype, attn, False]
    jpool, tpool = _pool(jcfg, seed=8)
    tokens = _tokens(jcfg, (3, 1), seed=9)
    lengths = np.array([37, 16, 0], np.int32)
    phys = np.array([[2, 6, 8, -1], [3, 10, -1, -1], [0, -1, -1, -1]],
                    np.int32)
    logical = np.array([[0, 1, 2, -1], [0, 1, -1, -1], [-1, -1, -1, -1]],
                       np.int32)
    state = dict(phys=phys, logical=logical,
                 write_page=np.array([8, 10, 0], np.int32),
                 write_off=np.array([5, 0, 0], np.int32))
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    tstate = {k: torch.from_numpy(v) for k, v in state.items()}
    if audit:
        jstate["audit"] = jnp.zeros((), jnp.int32)
        tstate["audit"] = True
    want_logits, want_cache = jlm.decode_step_paged(
        jp, jcfg, jnp.asarray(tokens),
        {"layers": jpool, "lengths": jnp.asarray(lengths)}, jstate)
    got_logits, got_cache = tlm.decode_step_paged(
        tp, tcfg, torch.from_numpy(tokens),
        {"layers": tpool, "lengths": torch.from_numpy(lengths)}, tstate)
    _close(got_logits, want_logits, dtype, "logits")
    np.testing.assert_array_equal(got_cache["lengths"].numpy(),
                                  np.asarray(want_cache["lengths"]))
    _compare_cache(got_cache["layers"], want_cache["layers"], dtype,
                   "pool after decode")
    # the live pool was written in place
    assert got_cache["layers"]["b0"]["attn"]["k"] is \
        tpool["b0"]["attn"]["k"]
    if audit:
        _close(got_cache["layers"]["b0"]["attn"]["audit_mass"],
               want_cache["layers"]["b0"]["attn"]["audit_mass"], dtype,
               "audit mass")
