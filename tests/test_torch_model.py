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
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Smoke shapes run as fast on one thread, and the other test workers
# keep the remaining cores.
torch.set_num_threads(1)

from repro.configs import get_smoke_config  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import olmo_1b as tolmo  # noqa: E402
from repro_torch.core import dlzs as tdlzs  # noqa: E402
from repro_torch.models import attention as tattention  # noqa: E402
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
    """Every model family converts now; STAR in training (ROADMAP §1 item
    7) is what the converter still refuses."""
    train = dataclasses.replace(get_smoke_config("olmo_1b"),
                                star_train=True)
    with pytest.raises(NotImplementedError, match="not ported"):
        convert.model_cfg_from_reference(train)


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


@pytest.mark.parametrize("attn", ["dense", "star"])
def test_prefill_hands_kernels_their_layout(models, monkeypatch, attn):
    """``apply_prefill`` gives the kernel glue contiguous [B·nh, T, d]
    tensors at any batch (the CUDA wrappers refuse strided operands), and
    routes ``star=None`` to K4 and STAR to the fused glue."""
    from repro_torch.kernels import ops as tops
    jcfg, _, tcfg, tp = models["float32", attn, False]
    seen = []

    def spy(real):
        def wrapped(q, k, v, *args, **kw):
            seen.append(all(t.is_contiguous() and t.dim() == 3
                            for t in (q, k, v)))
            return real(q, k, v, *args, **kw)
        return wrapped

    name = "flash" if attn == "dense" else "star_attention_cfg"
    monkeypatch.setattr(tops, name, spy(getattr(tops, name)))
    for batch in (1, 2):
        tlm.forward(tp, tcfg, {"tokens": torch.from_numpy(
            _tokens(jcfg, (batch, 32), seed=batch))})
    assert seen == [True] * (2 * jcfg.n_layers)


@pytest.mark.parametrize("t,groups", [(128, 1), (256, 1), (128, 2),
                                      (256, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_star_prefill_scan_matches(models, monkeypatch, dtype, t, groups):
    """STAR prefill longer than one q-chunk (smoke tiles of 16 with
    chunk_tiles 4, so ``scanq`` really scans), and with ``prefix_groups``
    2, through the port's K2 -> SADS -> K3 glue (``kernels.ops``, plain
    versions on the CPU).

    fp32: the whole ``lm.prefill`` against the JAX ``lm.prefill``. bf16:
    every layer's ``attention.apply_prefill`` against the reference's,
    both fed the input the port's own STAR forward hands that layer; and
    with one prefix group, every layer's kept tile sets equal the plain
    SADS selection over the plain Â on the same q/k. Through several bf16
    layers the comparison stops being one of the glue: a layer's output
    one bf16 step off moves the next layer's pow2(K), hence its predicted
    tile maxima by many steps, and a near-tie at the top-k edge then
    keeps another tile (ROADMAP §3, ``tools/torch_star_drift.py``).
    """
    jcfg, jp, _, tp = models[dtype, "star", False]
    assert jcfg.star.chunk_tiles * jcfg.star.block_q < t
    jcfg = dataclasses.replace(jcfg, star=dataclasses.replace(
        jcfg.star, prefix_groups=groups))
    tcfg = convert.model_cfg_from_reference(jcfg)
    if dtype == "bfloat16":
        from repro_torch.core import sads as tsads
        from repro_torch.kernels import ops as tops
        core_star = importlib.import_module("repro_torch.core.star_attention")
        inputs, qks = [], []
        apply_prefill, star_cfg = tattention.apply_prefill, \
            tops.star_attention_cfg

        def record_input(params, acfg, h, positions, **kw):
            inputs.append(h)
            return apply_prefill(params, acfg, h, positions, **kw)

        def record_qk(q, k, v, star, **kw):
            qks.append((q, k))
            return star_cfg(q, k, v, star, **kw)

        monkeypatch.setattr(tattention, "apply_prefill", record_input)
        monkeypatch.setattr(tops, "star_attention_cfg", record_qk)
        tlm.forward(tp, tcfg, {"tokens": torch.from_numpy(
            _tokens(jcfg, (2, t), seed=t + groups))})
        monkeypatch.undo()
        assert len(inputs) == len(qks) == jcfg.n_layers
        for i, h in enumerate(inputs):
            want = jattention.apply_prefill(
                jax.tree.map(lambda a: a[i], jp["blocks"]["b0"]["core"]),
                jcfg.attn_cfg("prefill"),
                jnp.asarray(h.float().numpy()).astype(jnp.bfloat16),
                jnp.arange(t))[0]
            got = tattention.apply_prefill(
                tlm._layer(tp["blocks"]["b0"]["core"], i), tcfg.attn_cfg(),
                h, torch.arange(t))[0]
            _close(got, want, dtype, f"layer {i} attention")
        if groups > 1:
            return
        star = tcfg.star
        keep, n_kt = star.keep_blocks(t), t // star.block_kv
        scale = tcfg.dh ** -0.5
        causal = torch.ones(t, t, dtype=torch.bool).triu(1)
        for i, (q, k) in enumerate(qks):
            raw = tops.dlzs_blockmax(q, k, causal=True, scale=1.0,
                                     block_q=star.block_q,
                                     block_kv=star.block_kv)
            idx, valid = tops.select_tiles(raw, keep, scale=scale,
                                           radius=star.radius, dtype=q.dtype)
            sel = tsads.sads_select_blocks(
                core_star.predict_scores(q, k, scale=scale).masked_fill(
                    causal, tsads.NEG_INF),
                star.block_q, star.block_kv, keep, radius=star.radius)

            def kept(ids, ok):
                return torch.zeros(ids.shape[:-1] + (n_kt,),
                                   dtype=torch.bool).scatter_(-1, ids, ok)

            assert torch.equal(kept(idx, valid),
                               kept(sel.block_idx, sel.block_valid)), i
        return
    toks = _tokens(jcfg, (2, t), seed=t + groups)
    last = np.array([t - 1, t // 2 + 3], np.int32)
    want_logits, want_cache = jlm.prefill(
        jp, jcfg, {"tokens": jnp.asarray(toks)},
        last_index=jnp.asarray(last))
    got_logits, got_cache = tlm.prefill(
        tp, tcfg, {"tokens": torch.from_numpy(toks)},
        last_index=torch.from_numpy(last))
    _close(got_logits, want_logits, dtype, "logits")
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
