"""Port parity: paged decode (K1's plain version and dispatch), the
audit probe and the DLZS page scores against ``repro.kvcache``.

Inputs are drawn with numpy from fixed seeds at the shapes of
``tests/test_kvcache.py::_paged_inputs`` (B=2, nh=4, nkv=2, d=8, P=9,
page=4, W=3, a padded slot, kv_len not a page multiple), plus a wider GQA
group (R=4) and bf16. Tolerances: 2e-5 in fp32 (the reference tests'
bound), 2e-2 in bf16 (tests/test_kernels.py's bf16 bound); page scores
are integers and must be equal.

The CUDA kernel itself runs only on a GPU: tests/test_torch_cuda.py
holds it against this plain version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Smoke shapes run as fast on one thread, and the other test workers
# keep the remaining cores.
torch.set_num_threads(1)

from repro.core import dlzs as jdlzs  # noqa: E402
from repro.kvcache import metrics as jmetrics  # noqa: E402
from repro.kvcache import paged_attention as jpa  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.core import dlzs as tdlzs  # noqa: E402
from repro_torch.kernels import paged as kpaged  # noqa: E402
from repro_torch.kvcache import metrics as tmetrics  # noqa: E402
from repro_torch.kvcache import paged_attention as tpa  # noqa: E402

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _paged_inputs(seed=0, nh=4, nkv=2, d=8, P=9, page=4):
    rng = np.random.RandomState(seed)
    q = rng.randn(2, nh, d).astype(np.float32)
    kp = rng.randn(P, page, nkv, d).astype(np.float32)
    vp = rng.randn(P, page, nkv, d).astype(np.float32)
    phys = np.array([[1, 4, 2], [5, 3, -1]], np.int32)
    logical = np.array([[0, 1, 2], [0, 1, -1]], np.int32)
    kv_len = np.array([10, 7], np.int32)
    return q, kp, vp, phys, logical, kv_len, nkv


def _jax(arrays, dtype):
    return [jnp.asarray(a).astype(dtype) if a.dtype == np.float32
            else jnp.asarray(a) for a in arrays]


def _torch(arrays, dtype):
    tdt = getattr(torch, dtype)
    return [torch.from_numpy(a.copy()).to(tdt) if a.dtype == np.float32
            else torch.from_numpy(a.copy()) for a in arrays]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


CASES = [("float32", 4), ("float32", 8), ("bfloat16", 4), ("bfloat16", 8)]


@pytest.mark.parametrize("dtype,nh", CASES)
@pytest.mark.parametrize("seed", [0, 3])
def test_paged_decode_matches_reference(dtype, nh, seed):
    """The port's dispatch on CPU tensors (the plain version) against the
    reference's XLA gather AND its Pallas kernel in interpret mode."""
    q, kp, vp, phys, logical, kv_len, nkv = _paged_inputs(seed, nh=nh)
    args_j = _jax((q, kp, vp, phys, logical, kv_len), dtype)
    args_t = _torch((q, kp, vp, phys, logical, kv_len), dtype)
    got = tpa.paged_decode(*args_t, n_kv=nkv)
    assert got.dtype == args_t[0].dtype and got.shape == args_t[0].shape
    for backend in ("xla", "pallas"):
        want = jpa.paged_decode(*args_j, n_kv=nkv, backend=backend)
        np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype],
                                   err_msg=backend)


@pytest.mark.parametrize("nh", [4, 8])
def test_paged_gather_decode_stats_match(nh):
    q, kp, vp, phys, logical, kv_len, nkv = _paged_inputs(1, nh=nh)
    # a sequence whose only slot is padding: the merge's neutral element
    phys[1] = [-1, -1, -1]
    logical[1] = [-1, -1, -1]
    want = jpa.paged_gather_decode_stats(
        *_jax((q, kp, vp, phys, logical, kv_len), "float32"), n_kv=nkv)
    got = tpa.paged_gather_decode_stats(
        *_torch((q, kp, vp, phys, logical, kv_len), "float32"), n_kv=nkv)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_f32(g), _f32(w), **TOL["float32"])
    assert float(got[1][1].abs().max()) == 0.0


@pytest.mark.parametrize("nh", [4, 8])
def test_page_attention_mass_matches(nh):
    q, kp, _, phys, logical, kv_len, nkv = _paged_inputs(2, nh=nh)
    want = jpa.page_attention_mass(
        *_jax((q, kp, phys, logical, kv_len), "float32"), n_kv=nkv)
    got = tpa.page_attention_mass(
        *_torch((q, kp, phys, logical, kv_len), "float32"), n_kv=nkv)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL["float32"])
    np.testing.assert_allclose(_f32(got).sum(axis=1), 1.0, rtol=1e-6)


def test_kernel_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors the wrapper returns the plain version and does not
    count a launch; the kernel's query layout is [B, G, R, d]."""
    q, kp, vp, phys, logical, kv_len, nkv = _paged_inputs(4, nh=8)
    tq, tk, tv, tph, tlg, tkl = _torch((q, kp, vp, phys, logical, kv_len),
                                       "bfloat16")
    before = dict(kernels.LAUNCHES)
    got = kpaged.paged_decode_attention(tq.reshape(2, nkv, 4, 8), tk, tv,
                                        tph, tlg, tkl, scale=8 ** -0.5)
    want = tpa.paged_gather_decode(tq, tk, tv, tph, tlg, tkl, n_kv=nkv)
    np.testing.assert_array_equal(_f32(got.reshape(2, 8, 8)), _f32(want))
    assert kernels.LAUNCHES == before


def _kernel_args(b=2, g=2, r=2, d=64, p=9, page=16, w=3):
    q = torch.zeros((b, g, r, d), dtype=torch.bfloat16)
    k = torch.zeros((p, page, g, d), dtype=torch.bfloat16)
    ints = torch.zeros((b, w), dtype=torch.int32)
    return [q, k, k.clone(), ints, ints.clone(),
            torch.zeros((b,), dtype=torch.int32)]


@pytest.mark.parametrize("bad", ["dtype_q", "dtype_table", "shape_pool",
                                 "kv_len", "head_dim", "stride"])
def test_kernel_wrapper_rejects_bad_inputs(bad):
    """The checks run before any launch: every input the kernel does not
    take raises instead of reaching the card."""
    args = _kernel_args()
    if bad == "dtype_q":
        args[0] = args[0].float()
    elif bad == "dtype_table":
        args[3] = args[3].long()
    elif bad == "shape_pool":
        args[1] = torch.zeros((9, 16, 3, 64), dtype=torch.bfloat16)
    elif bad == "kv_len":
        args[5] = torch.zeros((3,), dtype=torch.int32)
    elif bad == "head_dim":
        args = _kernel_args(d=48)
    elif bad == "stride":
        args[1] = torch.zeros((9, 16, 2, 128), dtype=torch.bfloat16)[..., ::2]
        args[2] = args[1]
    with pytest.raises((TypeError, ValueError)):
        kpaged._check(*args)
    kpaged._check(*_kernel_args())                 # the valid case passes


def test_paged_decode_quant_raises():
    """An int8 tier without its qmask is refused, never read as the fp
    path (the tier's read path itself: tests/test_torch_quant.py)."""
    q, kp, vp, phys, logical, kv_len, nkv = _paged_inputs()
    args = _torch((q, kp, vp, phys, logical, kv_len), "float32")
    tier = {"kq": torch.zeros(kp.shape, dtype=torch.int8),
            "vq": torch.zeros(kp.shape, dtype=torch.int8),
            "k_scale": torch.ones(kp.shape[0]),
            "v_scale": torch.ones(kp.shape[0])}
    with pytest.raises(KeyError, match="qmask"):
        tpa.paged_decode(*args, n_kv=nkv, quant=tier)


def test_page_scores_match():
    """``page_scores`` / ``page_scores_per_layer`` over the LZ slab, and
    the pack-on-the-fly fallback without one, equal the reference's."""
    rng = np.random.RandomState(5)
    k = (rng.randn(2, 5, 4, 3, 8) * 4).astype(np.float32)
    k[1, 2, 0, 0, 0] = 64.0
    k[:, 3] = 0.0                                    # an empty page
    jk = jnp.asarray(k).astype(jnp.bfloat16)
    tk = torch.from_numpy(k).to(torch.bfloat16)
    jtree = {"b0": {"attn": {"k": jk, "k_lz": jdlzs.lz_pack(jk)}}}
    ttree = {"b0": {"attn": {"k": tk, "k_lz": tdlzs.lz_pack(tk)}}}
    for fn in ("page_scores", "page_scores_per_layer"):
        want = np.asarray(getattr(jmetrics, fn)(jtree))
        got = getattr(tmetrics, fn)(ttree).numpy()
        np.testing.assert_array_equal(got, want)
    no_lz_j = {"b0": {"attn": {"k": jk}}}
    no_lz_t = {"b0": {"attn": {"k": tk}}}
    np.testing.assert_array_equal(tmetrics.page_scores(no_lz_t).numpy(),
                                  np.asarray(jmetrics.page_scores(no_lz_j)))
    assert tmetrics.gather_bytes_per_page(ttree) == \
        jmetrics.gather_bytes_per_page(jtree)
    assert tmetrics.bytes_per_page(ttree) == jmetrics.bytes_per_page(jtree)
