"""Port parity: the prefill tile kernels' plain versions (K2 DLZS block
maxima, K3 SU-FA, K4 flash) and the fused STAR glue (``kernels.ops``)
against the JAX package's Pallas kernels in interpret mode
(``repro.kernels.ops``), its oracles (``repro.kernels.ref``) and its core
STAR pipeline. K3 takes tile ids and reads the selected tiles in place;
its yardstick is the Pallas kernel fed the tiles and mask that the JAX
fused pipeline gathers for the same ids.

The shapes mirror tests/test_kernels.py. Inputs are drawn with numpy from
fixed seeds and handed to both packages. Tolerances: 2e-5 in fp32 (the
reference tests' bound; 2e-4 for fused against core, as there), 2e-2 for
flash and 3e-2 for SU-FA in bf16 (tests/test_kernels.py's bf16 bounds);
pow2 values, LZ codes and tile selections must be equal.

The CUDA kernels run only on a GPU: tests/test_torch_cuda.py holds them
against these plain versions on the card.
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

from repro.core import dlzs as jdlzs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.core import dlzs as tdlzs  # noqa: E402
from repro_torch.core import sads as tsads  # noqa: E402
tstar = importlib.import_module("repro_torch.core.star_attention")
from repro_torch.kernels import dlzs as kdlzs  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

# ``repro.core.star_attention`` the module (the package re-exports a
# function of the same name)
jstar = importlib.import_module("repro.core.star_attention")

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SUFA_BF16 = dict(rtol=3e-2, atol=3e-2)


def _qkv(bh, t, s, d, seed=0, peaked=True):
    rng = np.random.RandomState(seed)
    q = rng.randn(bh, t, d).astype(np.float32)
    k = rng.randn(bh, s, d).astype(np.float32)
    v = rng.randn(bh, s, d).astype(np.float32)
    if peaked:
        k[:, : s // 16] *= 3.0
    return q, k, v


def _both(arrays, dtype="float32"):
    """The same numpy arrays as JAX and torch tensors of ``dtype``."""
    j = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]
    t = [torch.from_numpy(a.copy()).to(getattr(torch, dtype)) for a in arrays]
    return j, t


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np32(got), _np32(want), **tol, err_msg=what)


# -- K4: flash -----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 128, 128, 64), (1, 256, 256, 32),
                                   (3, 128, 384, 128), (2, 256, 512, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_pallas_and_ref(shape, causal):
    bh, t, s, d = shape
    (jq, jk, jv), (q, k, v) = _both(_qkv(bh, t, s, d))
    kernels.reset_launches()
    got = tops.flash(q, k, v, causal=causal)
    assert kernels.LAUNCHES["flash"] == 0        # no kernel off the card
    _close(got, jops.flash(jq, jk, jv, causal=causal, block_q=64,
                           block_kv=64), TOL["float32"], "pallas")
    _close(got, jref.flash_ref(jq, jk, jv, causal=causal), TOL["float32"],
           "ref")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_dtypes(dtype):
    (jq, jk, jv), (q, k, v) = _both(_qkv(2, 128, 256, 64), dtype)
    got = tops.flash(q, k, v, causal=True)
    assert got.dtype == getattr(torch, dtype)
    _close(got, jops.flash(jq, jk, jv, causal=True, block_q=64,
                           block_kv=64), TOL[dtype])


def test_flash_block_shape_sweep():
    """The port's ``flash`` takes no tiles (K4 picks its own); it matches
    the Pallas kernel at each of that kernel's tile shapes."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(1, 256, 256, 64, seed=3))
    got = tops.flash(q, k, v, causal=True)
    for bq, bkv in [(32, 32), (64, 128), (128, 64), (256, 256)]:
        _close(got, jops.flash(jq, jk, jv, causal=True, block_q=bq,
                               block_kv=bkv), TOL["float32"],
               f"block {bq}x{bkv}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,s", [(40, 40), (287, 287), (33, 71)])
def test_flash_ragged_length(dtype, t, s):
    """K4 takes any T and S (the served oracle forward runs at prompt +
    generated tokens); the TPU kernel needs tile multiples, so the
    yardstick is the reference's oracle."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(2, t, s, 32, seed=t), dtype)
    got = tops.flash(q, k, v, causal=True)
    _close(got, jref.flash_ref(jq, jk, jv, causal=True), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [40, 128])
def test_flash_matches_dense_chunked(dtype, t):
    """K4's path in the model's layout against the model's plain dense
    form ``attention._dense_chunked`` (q_chunk 64: T=128 runs two chunks,
    T=40 one ragged chunk) on the same q/k/v; bf16 at flash's 2e-2
    (the plain form rounds P to bf16 before P·V, K4 divides at the end)."""
    from repro_torch.models import attention
    rng = np.random.RandomState(t)
    q, k, v = (torch.from_numpy(rng.randn(2, t, 4, 32).astype(np.float32))
               .to(getattr(torch, dtype)) for _ in range(3))
    want = attention._dense_chunked(q, k, v, causal=True, q_chunk=64,
                                    scale=32 ** -0.5)
    heads = lambda x: x.transpose(1, 2).reshape(8, t, 32)  # noqa: E731
    got = tops.flash(heads(q), heads(k), heads(v), causal=True)
    _close(got.reshape(2, 4, t, 32).transpose(1, 2), want, TOL[dtype])


# -- K2: DLZS block maxima -------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 128, 256, 64), (1, 256, 512, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_dlzs_blockmax_matches_pallas_and_ref(shape, causal):
    bh, t, s, d = shape
    (jq, jk, _), (q, k, _) = _both(_qkv(bh, t, s, d, seed=1))
    kernels.reset_launches()
    got = tops.dlzs_blockmax(q, k, causal=causal, block_q=64, block_kv=64)
    assert got.dtype == torch.float32 and kernels.LAUNCHES["dlzs_block"] == 0
    _close(got, jops.dlzs_blockmax(jq, jk, causal=causal, block_q=64,
                                   block_kv=64), TOL["float32"], "pallas")
    _close(got, jref.dlzs_block_ref(jq, jk, causal=causal, block_q=64,
                                    block_kv=64), TOL["float32"], "ref")


def test_pow2_bitwise_is_exact():
    """The kernel's mantissa-mask quantizer equals the reference's
    float-domain ``pow2_quantize`` and bitwise ``_pow2_bitwise``, and the
    LZ round trip, bit for bit on normal-range inputs."""
    from repro.kernels.dlzs import _pow2_bitwise
    x = (np.random.RandomState(2).randn(4096) * 100).astype(np.float32)
    got = kdlzs.pow2_bitwise(torch.from_numpy(x)).numpy()
    for want in (jdlzs.pow2_quantize(jnp.asarray(x)),
                 _pow2_bitwise(jnp.asarray(x))):
        np.testing.assert_array_equal(got.view(np.uint32),
                                      np.asarray(want).view(np.uint32))
    lz = tdlzs.lz_pack(torch.from_numpy(x))
    np.testing.assert_array_equal(lz.numpy(),
                                  np.asarray(jdlzs.lz_pack(jnp.asarray(x))))
    np.testing.assert_array_equal(
        tdlzs.lz_unpack(lz, torch.float32).numpy().view(np.uint32),
        got.view(np.uint32))
    # bf16: the kernel keeps bits & 0xFF80 of each bf16 value
    xb = torch.from_numpy(x).bfloat16()
    bits = xb.view(torch.int16).numpy().view(np.uint16) & 0xFF80
    np.testing.assert_array_equal(
        kdlzs.pow2_bitwise(xb).bfloat16().view(torch.int16).numpy()
        .view(np.uint16), bits)


# -- K3: SU-FA -----------------------------------------------------------------

def _selection(q, k, keep, block=64, causal=False, order="predicted",
               seed=0):
    """(idx int64, valid bool) [BH, n_qt, keep] as numpy, selected as
    tests/test_kernels.py selects them (tile order from the reference's
    predicted maxima), or in a random order that the fast path's frozen
    max does not assume."""
    bh, t, _ = q.shape
    s = k.shape[1]
    n_qt, n_kt = t // block, s // block
    bmax = np.asarray(jref.dlzs_block_ref(jnp.asarray(q), jnp.asarray(k),
                                          causal=causal, block_q=block,
                                          block_kv=block))
    if order == "predicted":
        vals, idx = (np.asarray(a) for a in jax.lax.top_k(bmax, keep))
    else:
        rng = np.random.RandomState(seed)
        idx = np.stack([rng.permutation(n_kt)[:keep]
                        for _ in range(bh * n_qt)]).reshape(bh, n_qt, keep)
        vals = np.take_along_axis(bmax, idx, axis=-1)
    return idx.astype(np.int64), vals > -1e29


def _pallas_sufa(jq, jk, jv, idx, valid, *, block_q=64, block_kv=64,
                 causal=False, strict):
    """The Pallas kernel (interpret mode) on the operands the JAX fused
    pipeline gathers for tile ids ``idx`` / ``valid``
    (repro/kernels/ops.py::star_attention_fused)."""
    bh, t, d = jq.shape
    s = jk.shape[1]
    n_qt, n_kt = t // block_q, s // block_kv
    keep = idx.shape[-1]
    idx, valid = jnp.asarray(idx), jnp.asarray(valid)
    take = lambda x: jnp.take_along_axis(  # noqa: E731
        x.reshape(bh, n_kt, block_kv, d)[:, None], idx[..., None, None],
        axis=2)
    mask = jnp.broadcast_to(valid[..., None, None],
                            (bh, n_qt, keep, block_q, block_kv))
    if causal:
        q_pos = (jnp.arange(t) + (s - t)).reshape(n_qt, block_q)
        kv_pos = idx[..., None] * block_kv + jnp.arange(block_kv)
        mask = mask & (kv_pos[:, :, :, None, :]
                       <= q_pos[None, :, None, :, None])
    return jops.sufa(jq, take(jk), take(jv), mask, strict=strict)


def _port_sufa(q, k, v, idx, valid, *, block_q=64, block_kv=64,
               causal=False, strict):
    return tops.sufa(q, k, v, torch.from_numpy(idx), torch.from_numpy(valid),
                     block_q=block_q, block_kv=block_kv, causal=causal,
                     strict=strict)


@pytest.mark.parametrize("keep", [1, 2, 4])
def test_sufa_strict_matches_pallas_and_ref(keep):
    """K3's contract (tile ids read in place) against the Pallas kernel
    over the JAX gather of the same tiles, and against the reference's
    exact masked softmax over them."""
    q, k, v = _qkv(2, 128, 256, 64, seed=4)
    idx, valid = _selection(q, k, keep)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v))
    kernels.reset_launches()
    got = _port_sufa(tq, tk, tv, idx, valid, strict=True)
    assert kernels.LAUNCHES["sufa"] == 0
    _close(got, _pallas_sufa(jq, jk, jv, idx, valid, strict=True),
           TOL["float32"], "pallas")
    take = lambda x: np.take_along_axis(  # noqa: E731
        x.reshape(2, 1, 4, 64, 64), idx[..., None, None], axis=2)
    mask = np.broadcast_to(valid[..., None, None], (2, 2, keep, 64, 64))
    _close(got, jref.sufa_ref(jq, jnp.asarray(take(k)), jnp.asarray(take(v)),
                              jnp.asarray(mask)), TOL["float32"], "ref")


@pytest.mark.parametrize("order", ["predicted", "random"])
@pytest.mark.parametrize("causal", [False, True])
def test_sufa_fast_path_matches_pallas(order, causal):
    """``strict=False`` (the frozen max) against the Pallas kernel, not
    the exact ref: out of order it is a different function, and the
    plain version follows the kernel's recurrence."""
    q, k, v = _qkv(2, 128, 512, 64, seed=5)
    idx, valid = _selection(q, k, 4, causal=causal, order=order, seed=5)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v))
    got = _port_sufa(tq, tk, tv, idx, valid, causal=causal, strict=False)
    _close(got, _pallas_sufa(jq, jk, jv, idx, valid, causal=causal,
                             strict=False), TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sufa_dtype_sweep(dtype):
    q, k, v = _qkv(1, 128, 256, 32, seed=6)
    idx, valid = _selection(q, k, keep=2)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), dtype)
    got = _port_sufa(tq, tk, tv, idx, valid, strict=True)
    assert got.dtype == getattr(torch, dtype)
    tol = SUFA_BF16 if dtype == "bfloat16" else TOL["float32"]
    _close(got, _pallas_sufa(jq, jk, jv, idx, valid, strict=True), tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("causal", [False, True])
def test_sufa_modes_orders_and_tiles(causal, strict, dtype):
    """Both modes, in the predicted and a random order, on tiles of 32
    with S > T (the queries are the last T positions), at SU-FA's fp32
    and bf16 bounds."""
    q, k, v = _qkv(2, 64, 128, 32, seed=13)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), dtype)
    tol = SUFA_BF16 if dtype == "bfloat16" else TOL["float32"]
    for order in ("predicted", "random"):
        idx, valid = _selection(q, k, 3, block=32, causal=causal,
                                order=order, seed=13)
        got = _port_sufa(tq, tk, tv, idx, valid, block_q=32, block_kv=32,
                         causal=causal, strict=strict)
        _close(got, _pallas_sufa(jq, jk, jv, idx, valid, block_q=32,
                                 block_kv=32, causal=causal, strict=strict),
               tol, order)


@pytest.mark.parametrize("strict", [True, False])
def test_sufa_invalid_tiles_change_nothing(strict):
    """A tile with valid=False adds nothing in either mode (K3 skips it):
    invalid tiles first, between and last in the order, and a q-tile with
    no valid tile at all (its rows are zero); the same ids with the
    invalid ones dropped give the same output."""
    q, k, v = _qkv(2, 128, 256, 32, seed=14)
    idx, _ = _selection(q, k, 4, block=32, order="random", seed=14)
    valid = np.random.RandomState(14).rand(*idx.shape) < 0.5
    valid[0, 0] = [False, True, False, True]
    valid[0, 1] = [True, False, False, False]
    valid[1, 2] = False
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v))
    kw = dict(block_q=32, block_kv=32, causal=True, strict=strict)
    got = _port_sufa(tq, tk, tv, idx, valid, **kw)
    _close(got, _pallas_sufa(jq, jk, jv, idx, valid, **kw), TOL["float32"])
    assert float(got[1, 64:96].abs().max()) == 0.0
    moved = np.argsort(~valid, axis=-1, kind="stable")    # valid ones first
    _close(got, _port_sufa(tq, tk, tv, np.take_along_axis(idx, moved, -1),
                           np.take_along_axis(valid, moved, -1), **kw),
           TOL["float32"], "invalid tiles last")


def test_sufa_fast_path_row_unseen_in_first_tile():
    """Under the fast path a row's max is frozen by the first tile in
    which that row sees a key. With q-tiles of 64 and key tiles of 32,
    causal, q-tile 1 (rows 64..127) visits key tile 3 (keys 96..127)
    first: rows 64..95 see none of it, so their max comes from the next
    tile, while rows 96..127 freeze theirs on tile 3."""
    q, k, v = _qkv(1, 128, 128, 32, seed=15)
    idx = np.array([[[0, 1, 2], [3, 0, 2]]], np.int64)
    valid = np.ones(idx.shape, bool)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v))
    kw = dict(block_q=64, block_kv=32, causal=True, strict=False)
    got = _port_sufa(tq, tk, tv, idx, valid, **kw)
    want = _pallas_sufa(jq, jk, jv, idx, valid, **kw)
    _close(got, want, TOL["float32"])
    assert np.isfinite(_np32(got)).all()


# -- the fused STAR prefill ------------------------------------------------------

@pytest.mark.parametrize("radius", [1e9, 5.0])
@pytest.mark.parametrize("causal", [True, False])
def test_fused_star_matches_core_pipeline(causal, radius):
    """K2 -> SADS -> K3 against the core pipeline of both packages (and
    the JAX fused form), in fp32, without and with the sphere."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(1, 256, 256, 64, seed=7))
    keep = 2
    got = tops.star_attention_fused(q, k, v, keep=keep, causal=causal,
                                    block_q=64, block_kv=64, radius=radius,
                                    strict=True)
    cfg = dict(top_k_ratio=keep / 4, block_q=64, block_kv=64, radius=radius)
    want = jstar.star_attention(jq[0], jk[0], jv[0], jstar.STARConfig(**cfg),
                                causal=causal)
    tol = dict(rtol=2e-4, atol=2e-4)
    _close(got[0], want, tol, "jax core")
    _close(got[0], tstar.star_attention(q[0], k[0], v[0],
                                        tstar.STARConfig(**cfg),
                                        causal=causal), tol, "port core")
    _close(got, jops.star_attention_fused(jq, jk, jv, keep=keep,
                                          causal=causal, block_q=64,
                                          block_kv=64, radius=radius,
                                          strict=True),
           TOL["float32"], "jax fused")


def test_fused_star_full_keep_equals_flash():
    (jq, jk, jv), (q, k, v) = _both(_qkv(1, 128, 128, 64, seed=8,
                                         peaked=False))
    got = tops.star_attention_fused(q, k, v, keep=2, causal=True,
                                    block_q=64, block_kv=64, radius=1e9,
                                    strict=True)
    _close(got, jref.flash_ref(jq, jk, jv, causal=True), TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_tile_selection_equals_core(dtype, causal):
    """The glue rounds K2's fp32 maxima as the plain form rounds Â, so
    its tile ids and validity equal ``sads_select_blocks`` over the
    plain form's scores, ties included (bf16 ties often)."""
    q, k, _ = _qkv(4, 256, 256, 64, seed=9)
    _, (tq, tk) = _both((q, k), dtype)
    scale = 64 ** -0.5
    raw = tops.dlzs_blockmax(tq, tk, causal=causal, block_q=32, block_kv=32,
                             scale=1.0)
    idx, valid = tops.select_tiles(raw, 3, scale=scale, radius=5.0,
                                   dtype=tq.dtype)
    s_hat = tdlzs.dlzs_scores(tq, tdlzs.pow2_quantize(tk), scale)
    if causal:
        s_hat = s_hat.masked_fill(
            torch.ones(256, 256, dtype=torch.bool).triu(1), -1e30)
    sel = tsads.sads_select_blocks(s_hat, 32, 32, 3, radius=5.0)
    assert torch.equal(idx, sel.block_idx)
    assert torch.equal(valid, sel.block_valid)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,groups", [(64, 1), (128, 1), (256, 1), (256, 2),
                                      (256, 4)])
def test_star_cfg_matches_scanq(dtype, t, groups):
    """The model's form: ``star_attention_cfg`` over [BH, T, d] against
    the JAX ``star_attention_scanq`` per head (smoke tiles of 16,
    chunk_tiles 4: T=64 is one chunk, longer T scans; prefix groups shrink
    keep with the prefix).

    In bf16 the selections are equal (test_tile_selection_equals_core),
    but the reference rounds each raw score Q·Kᵀ to bf16 before its
    softmax while K3, like the TPU kernel, keeps it in fp32: a score of
    magnitude m moves by up to m/256, which moves an output of magnitude
    m' by a few bf16 steps of m'. So the bf16 bound scales with the
    output's largest magnitude, as tests/test_torch_model.py's does."""
    q, k, v = _qkv(3, t, t, 16, seed=t + groups)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), dtype)
    cfg = dict(top_k_ratio=0.5, block_q=16, block_kv=16, chunk_tiles=4,
               prefix_groups=groups)
    got = tops.star_attention_cfg(tq, tk, tv, tstar.STARConfig(**cfg),
                                  causal=True, scale=0.25)
    for h in range(3):
        want = jstar.star_attention_scanq(jq[h], jk[h], jv[h],
                                          jstar.STARConfig(**cfg),
                                          causal=True, scale=0.25)
        tol = dict(TOL[dtype])
        if dtype == "bfloat16":
            tol = dict(SUFA_BF16)
            tol["atol"] *= max(1.0, float(np.abs(_np32(want)).max()))
        _close(got[h], want, tol, f"head {h}")


@pytest.mark.parametrize("strict", [True, False])
def test_star_cfg_scan_mode_matches_scanq(strict):
    """``use_scan`` STAR configs run SU-FA's recurrence in the plain form,
    and the glue runs K3 in the config's ``strict`` mode (the gathered
    form, the model's, is the strict one). The input makes the modes
    differ: two key tiles tie on their predicted max (pow2 maps 1.0 and
    1.99 alike), so the lower one leads, but the other's true scores are
    119 higher. The fast path's frozen max then overflows exp to inf and
    its rows turn NaN in both packages; the strict path stays finite."""
    d, t = 16, 32
    q = np.full((1, t, d), 30.0, np.float32)
    k = np.concatenate([np.full((1, 16, d), 1.0, np.float32),
                        np.full((1, 16, d), 1.99, np.float32)], axis=1)
    v = np.random.RandomState(12).randn(1, t, d).astype(np.float32)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v))
    cfg = dict(top_k_ratio=1.0, block_q=16, block_kv=16, use_scan=True,
               strict=strict)
    got = tops.star_attention_cfg(tq, tk, tv, tstar.STARConfig(**cfg),
                                  causal=True)
    want = jstar.star_attention_scanq(jq[0], jk[0], jv[0],
                                      jstar.STARConfig(**cfg), causal=True)
    assert bool(torch.isnan(got[0, 16:]).all()) != strict
    _close(got[0], want, TOL["float32"])


@pytest.mark.parametrize("mode", ["strict", "fast"])
@pytest.mark.parametrize("causal", [True, False])
def test_star_cfg_elementwise_matches_scanq(causal, mode):
    """``STARConfig(elementwise=True)``: the glue (K2 -> SADS -> K3 with
    its element mask; plain versions on the CPU) computes what JAX
    ``star_attention_scanq`` computes, over two q-chunks, in the gathered
    (strict) form and the scan form's fast path. A radius of 2 makes the
    element sphere drop keys that the tile selection keeps, so the result
    differs from the same config without it."""
    rs = np.random.RandomState(13)
    q, k, v = (rs.randn(3, 128, 16).astype(np.float32) for _ in range(3))
    k[:, :8] *= 3.0
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v))
    cfg = dict(top_k_ratio=0.5, block_q=16, block_kv=16, radius=2.0,
               elementwise=True, use_scan=mode == "fast",
               strict=mode == "strict")
    got = tops.star_attention_cfg(tq, tk, tv, tstar.STARConfig(**cfg),
                                  causal=causal)
    want = np.stack([np.asarray(jstar.star_attention_scanq(
        jq[i], jk[i], jv[i], jstar.STARConfig(**cfg), causal=causal))
        for i in range(3)])
    _close(got, want, TOL["float32"])
    tile_only = tops.star_attention_cfg(
        tq, tk, tv, tstar.STARConfig(**dict(cfg, elementwise=False)),
        causal=causal)
    assert float((tile_only - got).abs().max()) > 1e-2


def test_star_cfg_follows_scanq_chunk_rule():
    """T longer than one chunk must divide by it, as in ``scanq``."""
    q = torch.zeros((1, 80, 16))
    cfg = dataclasses.replace(tstar.STARConfig(block_q=16, block_kv=16),
                              chunk_tiles=4)
    with pytest.raises(ValueError, match="q-chunk"):
        tops.star_attention_cfg(q, q, q, cfg, causal=True)


@pytest.mark.parametrize("block,form", [(128, "wgmma"), (16, "mma_sync"),
                                        (48, "mma_sync"), (64, "mma_sync")])
def test_tile_form_by_shape(block, form):
    """K2's and K3's form, element mask or not, by tile shape alone:
    ``wgmma`` at 128 x 128 (the served tiles; K3's element-level sphere
    mask included), ``mma_sync`` at the pool probe's 16 and at 48 and
    64."""
    from repro_torch.kernels import launch
    assert launch.tile_form(block, block) == form
    assert launch.tile_form(block, 128) == launch.tile_form(128, block) \
        == ("wgmma" if block == 128 else "mma_sync")
