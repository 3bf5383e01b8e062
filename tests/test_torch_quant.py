"""Port parity: the int8 cold KV tier (``repro_torch.kvcache.quant``) and
the paged decode's int8 read path against ``repro.kvcache``.

Inputs are drawn with numpy from fixed seeds. The tier's math is held bit
for bit: both packages quantize symmetrically (absmax / 127, round half to
even, clip to ±127), so codes and scales must be equal. The decode read
path (``_gather_hot(quant=...)``) is held at 2e-5 in fp32 (the reference
tests' bound) and at 2e-2 scaled by the output's magnitude in bf16
(tests/test_kernels.py's bf16 bound); an all-False qmask must give the fp
path's bits. K1's int8 form itself runs only on a GPU
(tests/test_torch_cuda.py); here its wrapper takes the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _hypothesis_shim import hnp, hypothesis, st

torch = pytest.importorskip("torch")
# Smoke shapes run as fast on one thread, and the other test workers
# keep the remaining cores.
torch.set_num_threads(1)

from repro.kvcache import paged_attention as jpa  # noqa: E402
from repro.kvcache import quant as jquant  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import paged as kpaged  # noqa: E402
from repro_torch.kvcache import paged_attention as tpa  # noqa: E402
from repro_torch.kvcache import quant as tquant  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402

TOL32 = dict(rtol=2e-5, atol=2e-5)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x)


@pytest.mark.parametrize("seed,shape,spread", [
    (0, (3, 4, 2, 8), 1.0),          # [pages, page, nkv, dh]
    (1, (2, 5, 4, 1, 16), 40.0),     # [L, pages, page, nkv, dh]
    (2, (6, 16, 2, 64), 1e-3),
])
def test_quantize_rows_bit_exact(seed, shape, spread):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * spread).astype(np.float32)
    x.reshape(-1)[::7] = 0.0
    # exact halves of a code step: round half to even decides them
    x.reshape(-1)[1] = np.abs(x).max()
    jq, js = jquant.quantize_rows(jnp.asarray(x))
    tq, ts = tquant.quantize_rows(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(_np(tq), np.asarray(jq))
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    np.testing.assert_array_equal(
        _np(tquant.dequantize_rows(tq, ts)),
        np.asarray(jquant.dequantize_rows(jq, js)))


def test_quantize_rows_all_zero_page():
    x = np.zeros((2, 4, 1, 8), np.float32)
    jq, js = jquant.quantize_rows(jnp.asarray(x))
    tq, ts = tquant.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(_np(tq), np.asarray(jq))
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    assert not np.any(_np(tq))


@hypothesis.settings(max_examples=40, deadline=None)
@hypothesis.given(hnp.arrays(
    np.float32, hnp.array_shapes(min_dims=3, max_dims=5, min_side=1,
                                 max_side=6),
    elements=st.floats(-1e4, 1e4, width=32)))
def test_roundtrip_error_within_half_scale(x):
    """Symmetric per-page absmax: every element's round trip is off by at
    most scale / 2 (plus an ulp of the scale's own product)."""
    q, s = tquant.quantize_rows(torch.from_numpy(x))
    back = tquant.dequantize_rows(q, s).numpy()
    bound = s.numpy()[..., None, None, None] / 2
    assert np.all(np.abs(back - x) <= bound * (1 + 1e-5) + 1e-30)


def _cache_tree(seed, dtype="float32", L=2, P=7, page=4, nkv=2, dh=8):
    """A two-block layer tree of attention caches, in numpy."""
    rng = np.random.RandomState(seed)

    def attn():
        return {"k": rng.randn(L, P, page, nkv, dh).astype(np.float32),
                "v": rng.randn(L, P, page, nkv, dh).astype(np.float32),
                "k_lz": rng.randint(-9, 9, (L, P, page, nkv, dh)
                                    ).astype(np.int8)}
    return {"b0": {"attn": attn()}, "b1": {"attn": attn()}}


def _as_jax(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(dtype)
                        if a.dtype == np.float32 else jnp.asarray(a), tree)


def _as_torch(tree, dtype):
    from repro_torch.tree import tree_map
    tdt = getattr(torch, dtype)
    return tree_map(lambda a: torch.from_numpy(a.copy()).to(tdt)
                    if a.dtype == np.float32 else torch.from_numpy(a.copy()),
                    tree)


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_pages_and_tree_helpers_match(dtype):
    """``add_quant_slabs`` -> ``quantize_pages`` on the same pages (one
    repeated) -> ``split_quant``/``merge_quant``: every leaf of the port's
    tree equals the reference's, bit for bit."""
    tree = _cache_tree(3)
    jt = jquant.add_quant_slabs(_as_jax(tree, getattr(jnp, dtype)))
    tt = tquant.add_quant_slabs(_as_torch(tree, dtype))
    assert tquant.has_quant(tt) and not tquant.has_quant(_as_torch(tree,
                                                                   dtype))
    assert float(tquant.find_scale(tt).abs().max()) == 0.0
    phys = np.array([2, 5, 1, 5], np.int32)
    jt = jquant.quantize_pages(jt, jnp.asarray(phys))
    tt = tquant.quantize_pages(tt, torch.from_numpy(phys))
    n = 0
    for path, leaf in tree_items(tt):
        want = np.asarray(_leaf(jt, path))
        got = leaf.view(torch.int16).numpy() if leaf.dtype == torch.bfloat16 \
            else leaf.numpy()
        if want.dtype == jnp.bfloat16:
            want = want.view(np.int16)
        np.testing.assert_array_equal(got, want, err_msg=str(path))
        n += 1
    assert n == 2 * 7
    assert float(tquant.find_scale(tt)[:, 5].min()) > 0.0
    assert float(tquant.find_scale(tt)[:, 3].max()) == 0.0

    base, tier = tquant.split_quant(tt)
    jbase, jtier = jquant.split_quant(jt)
    assert _paths(base) == _jax_paths(jbase)
    assert _paths(tier) == _jax_paths(jtier)
    assert set(tier["b0"]["attn"]) == set(tquant.QUANT_KEYS)
    merged = tquant.merge_quant(base, tier)
    assert _paths(merged) == _paths(tt)
    for path, leaf in tree_items(merged):
        assert leaf is _leaf(tt, path)


def _paths(tree) -> list:
    return sorted(p for p, _ in tree_items(tree))


def _jax_paths(tree) -> list:
    return sorted(tuple(k.key for k in p)
                  for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0])


def _quant_inputs(seed, dtype, nh=4, nkv=2, d=8, P=9, page=4):
    """Paged-decode inputs with the tier: fp pools, int8 mirrors of every
    page from the reference's own quantizer, and a mixed qmask over slots
    (a padded slot marked too)."""
    rng = np.random.RandomState(seed)
    q = rng.randn(2, nh, d).astype(np.float32)
    kp = rng.randn(P, page, nkv, d).astype(np.float32)
    vp = (rng.randn(P, page, nkv, d) * 3).astype(np.float32)
    phys = np.array([[1, 4, 2], [5, 3, -1]], np.int32)
    logical = np.array([[0, 1, 2], [0, 1, -1]], np.int32)
    kv_len = np.array([10, 7], np.int32)
    qmask = np.array([[True, False, True], [False, True, True]])
    jdt = getattr(jnp, dtype)
    kq, ks = jquant.quantize_rows(jnp.asarray(kp).astype(jdt))
    vq, vs = jquant.quantize_rows(jnp.asarray(vp).astype(jdt))
    tier = {"kq": np.asarray(kq), "vq": np.asarray(vq),
            "k_scale": np.asarray(ks), "v_scale": np.asarray(vs),
            "qmask": qmask}
    return (q, kp, vp, phys, logical, kv_len), tier, nkv


def _both(arrays, tier, dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    aj = [jnp.asarray(a).astype(jdt) if a.dtype == np.float32
          else jnp.asarray(a) for a in arrays]
    at = [torch.from_numpy(a.copy()).to(tdt) if a.dtype == np.float32
          else torch.from_numpy(a.copy()) for a in arrays]
    qj = {k: jnp.asarray(v) for k, v in tier.items()}
    qt = {k: torch.from_numpy(v.copy()) for k, v in tier.items()}
    return aj, at, qj, qt


def _assert_close(got, want, dtype):
    got, want = _np(got).astype(np.float32), np.asarray(
        jnp.asarray(want).astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **TOL32)
    else:
        mag = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2 * mag)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed,nh", [(0, 4), (1, 8)])
def test_gather_decode_quant_matches_reference(dtype, seed, nh):
    arrays, tier, nkv = _quant_inputs(seed, dtype, nh=nh)
    aj, at, qj, qt = _both(arrays, tier, dtype)
    want = jpa.paged_gather_decode(*aj, n_kv=nkv, quant=qj)
    got = tpa.paged_gather_decode(*at, n_kv=nkv, quant=qt)
    assert got.dtype == at[0].dtype
    _assert_close(got, want, dtype)
    # the quantized rows really were read: the fp path differs
    fp = tpa.paged_gather_decode(*at, n_kv=nkv)
    assert not torch.equal(fp, got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_decode_stats_quant_matches_reference(dtype):
    arrays, tier, nkv = _quant_inputs(2, dtype)
    aj, at, qj, qt = _both(arrays, tier, dtype)
    jm, jl, jo = jpa.paged_gather_decode_stats(*aj, n_kv=nkv, quant=qj)
    tm, tl, to = tpa.paged_gather_decode_stats(*at, n_kv=nkv, quant=qt)
    for got, want in ((tm, jm), (tl, jl), (to, jo)):
        assert got.dtype == torch.float32
        _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_all_false_qmask_is_the_fp_path(dtype):
    arrays, tier, nkv = _quant_inputs(3, dtype)
    tier["qmask"][:] = False
    _, at, _, qt = _both(arrays, tier, dtype)
    assert torch.equal(tpa.paged_gather_decode(*at, n_kv=nkv, quant=qt),
                       tpa.paged_gather_decode(*at, n_kv=nkv))
    for a, b in zip(tpa.paged_gather_decode_stats(*at, n_kv=nkv, quant=qt),
                    tpa.paged_gather_decode_stats(*at, n_kv=nkv)):
        assert torch.equal(a, b)
    assert torch.equal(tpa.paged_decode(*at, n_kv=nkv, quant=qt),
                       tpa.paged_decode(*at, n_kv=nkv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_wrapper_quant_on_cpu_is_plain(dtype):
    """``kernels.paged.paged_decode_attention(quant=...)`` on CPU tensors:
    the plain version, held against the reference's gather with the same
    tier; the int8 form counts no launch off the card."""
    arrays, tier, nkv = _quant_inputs(4, dtype, nh=8)
    aj, at, qj, qt = _both(arrays, tier, dtype)
    q, kp, vp, phys, logical, kv_len = at
    b, nh, d = q.shape
    kernels.reset_launches()
    got = kpaged.paged_decode_attention(
        q.reshape(b, nkv, nh // nkv, d), kp, vp, phys, logical, kv_len,
        scale=d ** -0.5, quant=qt)
    assert kernels.LAUNCHES["paged_decode"] == 0
    assert kernels.FORM_LAUNCHES["paged_decode/int8"] == 0
    want = jpa.paged_gather_decode(*aj, n_kv=nkv, quant=qj)
    _assert_close(got.reshape(b, nh, d), want, dtype)


# the shapes of tests/test_torch_cuda.py::test_paged_decode_int8_lane_
# matches_plain: (b, g, r, d, w, kv_len, page)
INT8_LANE_SHAPES = [
    (4, 16, 1, 128, 64, [1024, 1000, 777, 500], 16),   # the main path
    (3, 4, 4, 128, 16, [256, 201, 37], 16),
    (3, 4, 4, 64, 16, [256, 0, 93], 16),
    (2, 8, 2, 64, 9, [140, 17], 16),
    (2, 16, 1, 128, 8, [1000, 700], 128)]               # phase 9's tier read


def _own_pages(rng, b, w, kv_len, page, n_pages):
    """Block tables in which every sequence owns pages no other names
    (never page 0, where padded slots point): [B, W] phys and logical."""
    need = [-(-n // page) for n in kv_len]
    perm = rng.permutation(np.arange(1, n_pages))[:sum(need)]
    phys = np.full((b, w), -1, np.int32)
    logical = np.full((b, w), -1, np.int32)
    at = 0
    for i, n in enumerate(need):
        phys[i, :n] = perm[at:at + n]
        logical[i, :n] = np.arange(n)
        at += n
    return phys, logical


def _bf16_tier(rng, shape, table_shape):
    """An int8 tier quantized from rows drawn apart from the fp slabs'
    (V at 3x K's magnitude), in bf16 as the served path quantizes, and a
    qmask marking about half the slots."""
    tier = {}
    for name, mag in (("k", 1.0), ("v", 3.0)):
        rows = torch.from_numpy((rng.randn(*shape) * mag).astype(
            np.float32)).to(torch.bfloat16)
        tier[f"{name}q"], tier[f"{name}_scale"] = tquant.quantize_rows(rows)
    tier["qmask"] = torch.from_numpy(rng.rand(*table_shape) < 0.5)
    return tier


@pytest.mark.parametrize("b,g,r,d,w,kv_len,page", INT8_LANE_SHAPES)
def test_int8_read_is_fp_read_over_dequantized_slabs(b, g, r, d, w, kv_len,
                                                     page):
    """The plain int8 read (``paged_gather_decode(quant=...)``) equals,
    bit for bit, the plain fp read over ``dequantized_slabs`` (the marked
    slots' pages replaced by their tier rows), on block tables whose
    slots name distinct pages: the invariant K1's int8 lane is held to on
    the card. Both lie within the bf16 bound of the reference's int8
    read."""
    rng = np.random.RandomState(b * w + d)
    n_pages = sum(-(-n // page) for n in kv_len) + 8
    phys, logical = _own_pages(rng, b, w, kv_len, page, n_pages)
    q = rng.randn(b, g * r, d).astype(np.float32)
    kp, vp = (rng.randn(n_pages, page, g, d).astype(np.float32)
              for _ in range(2))
    kv = np.array(kv_len, np.int32)
    at = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, kp, vp)] \
        + [torch.from_numpy(a) for a in (phys, logical, kv)]
    tier = _bf16_tier(rng, kp.shape, phys.shape)
    got = tpa.paged_gather_decode(*at, n_kv=g, quant=tier)
    kd, vd = tpa.dequantized_slabs(at[1], at[2], at[3], tier)
    assert torch.equal(got, tpa.paged_gather_decode(
        at[0], kd, vd, *at[3:], n_kv=g))
    assert not torch.equal(got, tpa.paged_gather_decode(*at, n_kv=g))
    aj = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, kp, vp)] \
        + [jnp.asarray(a) for a in (phys, logical, kv)]
    want = jpa.paged_gather_decode(*aj, n_kv=g, quant={
        name: jnp.asarray(_np(t)) for name, t in tier.items()})
    _assert_close(got, want, "bfloat16")


def test_int8_stats_read_is_fp_read_over_dequantized_slabs():
    """The stats form's plain int8 read over a sharded pool (chip_smoke
    phase 13's decode shape: 4 shards, its three sequences at their last
    tick and an idle slot; each shard's sequences on pages of their own)
    equals, bit for bit in m, l and o, its fp read over
    ``dequantized_slabs`` of the sharded slabs."""
    n_sh, b, g, r, d, page = 4, 4, 16, 1, 128, 16
    kv_len = [1056, 1568, 2080, 1]
    rng = np.random.RandomState(13)
    n_pages = [-(-n // page) for n in kv_len]
    w = max(-(-n // n_sh) for n in n_pages)
    p_local = b * w + 4
    phys = np.full((n_sh, b, w), -1, np.int32)
    logical = np.full((n_sh, b, w), -1, np.int32)
    for s in range(n_sh):
        perm = rng.permutation(np.arange(1, p_local))
        at = 0
        for i, n in enumerate(n_pages):
            js = np.arange(s, n, n_sh)
            phys[s, i, :len(js)] = perm[at:at + len(js)]
            logical[s, i, :len(js)] = js
            at += len(js)
    q = rng.randn(b, g, r, d).astype(np.float32)
    kp, vp = (rng.randn(n_sh, p_local, page, g, d).astype(np.float32)
              for _ in range(2))
    q, kp, vp = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, kp, vp))
    phys, logical = torch.from_numpy(phys), torch.from_numpy(logical)
    kv = torch.tensor(kv_len, dtype=torch.int32)
    tier = _bf16_tier(rng, kp.shape, phys.shape)
    got = kpaged.paged_decode_stats_reference(
        q, kp, vp, phys, logical, kv, scale=d ** -0.5, quant=tier)
    kd, vd = tpa.dequantized_slabs(kp, vp, phys, tier)
    want = kpaged.paged_decode_stats_reference(
        q, kd, vd, phys, logical, kv, scale=d ** -0.5)
    for a, b_ in zip(got, want):
        assert torch.equal(a, b_)
    fp = kpaged.paged_decode_stats_reference(q, kp, vp, phys, logical, kv,
                                             scale=d ** -0.5)
    assert not torch.equal(got[2], fp[2])
