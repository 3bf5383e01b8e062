"""The port's CUDA kernels on the card, each against its plain PyTorch
version. No JAX here: the machine with the card has none. Every test is
marked ``cuda`` and skips without a GPU; run them there with

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import functools
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import paged as kpaged  # noqa: E402

BF16_TOL = dict(rtol=2e-2, atol=2e-2)     # tests/test_kernels.py's bf16 bound
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d,r", [(64, 2), (128, 1), (128, 4), (256, 2)])
def test_paged_decode_kernel_matches_plain(cuda_device, d, r):
    """K1 against its plain version, bf16 at 2e-2, with a padded slot, a
    kv_len that is not a page multiple, a sequence with no valid row, and
    one counted launch."""
    gen = torch.Generator(device="cpu").manual_seed(d + r)
    b, g, page, p, w = 4, 4, 16, 64, 8
    q = torch.randn((b, g, r, d), generator=gen)
    k = torch.randn((p, page, g, d), generator=gen)
    v = torch.randn((p, page, g, d), generator=gen)
    q, k, v = (t.to(cuda_device, torch.bfloat16) for t in (q, k, v))
    phys = torch.randint(1, p, (b, w), generator=gen, dtype=torch.int32)
    logical = torch.arange(w, dtype=torch.int32).repeat(b, 1)
    phys[2, 5:] = -1
    logical[2, 5:] = -1
    logical[3] = -1
    kv_len = torch.tensor([w * page, w * page - 5, 5 * page - 9, 7],
                          dtype=torch.int32)
    args = [t.to(cuda_device) for t in (phys, logical, kv_len)]
    kernels.reset_launches()
    got = kpaged.paged_decode_attention(q, k, v, *args, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["paged_decode"] == 1
    want = kpaged.paged_decode_reference(q, k, v, *args, scale=d ** -0.5)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **BF16_TOL)
    assert float(got[3].float().abs().max()) == 0.0


def _k1_inputs(b, g, r, d, w, kv_len, seed, device, page=16, n_pages=272):
    """Block tables as the engine builds them: each sequence owns
    ceil(kv_len / page) distinct random pages, its other slots are padding."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((b, g, r, d), generator=gen)
    k = torch.randn((n_pages, page, g, d), generator=gen)
    v = torch.randn((n_pages, page, g, d), generator=gen)
    phys = torch.full((b, w), -1, dtype=torch.int32)
    logical = torch.full((b, w), -1, dtype=torch.int32)
    for i, n_rows in enumerate(kv_len):
        n = -(-n_rows // page)
        phys[i, :n] = (torch.randperm(n_pages - 1, generator=gen)[:n]
                       + 1).int()
        logical[i, :n] = torch.arange(n, dtype=torch.int32)
    bf = [t.to(device, torch.bfloat16) for t in (q, k, v)]
    kvl = torch.tensor(kv_len, dtype=torch.int32)
    return bf + [t.to(device) for t in (phys, logical, kvl)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,g,r,w,kv_len,n_split", [
    (33, 16, 1, 8, [128] * 20 + [77] * 13, 1),   # 528 blocks: no split
    (33, 8, 2, 8, [128, 5] * 16 + [0], 2),
    (1, 2, 4, 12, [150], 12),                    # the most: one per slot
    (3, 16, 1, 130, [1040, 2064, 2064], 11),     # the whole-prompt phase
    (4, 4, 8, 16, [1, 256, 17, 0], 16)])         # kv_len 1 and 0
def test_paged_decode_kernel_splits(cuda_device, b, g, r, w, kv_len,
                                    n_split):
    """K1 against its plain version, bf16 at 2e-2, at plans of 1, 2 and
    the most splits, at W = 130 and at kv_len 1 and 0; one counted launch
    per call, and two calls on the same inputs give the same bits (the
    splits merge in a fixed order, without atomics)."""
    assert kpaged.split_plan(b, g, w, 16) == n_split
    args = _k1_inputs(b, g, r, 128, w, kv_len, seed=b + w, device=cuda_device)
    kernels.reset_launches()
    got = kpaged.paged_decode_attention(*args, scale=128 ** -0.5)
    again = kpaged.paged_decode_attention(*args, scale=128 ** -0.5)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["paged_decode"] == 2
    assert torch.equal(got, again)
    want = kpaged.paged_decode_reference(*args, scale=128 ** -0.5)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **BF16_TOL)
    for i, n in enumerate(kv_len):
        if n == 0:
            assert float(got[i].float().abs().max()) == 0.0


@pytest.mark.cuda
def test_paged_decode_kernel_rejects_cpu_fallback(cuda_device):
    """On a CUDA tensor the wrapper launches or raises: a float32 query
    is refused, never served by the plain version."""
    q = torch.zeros((1, 2, 1, 64), device=cuda_device)
    k = torch.zeros((4, 16, 2, 64), device=cuda_device, dtype=torch.bfloat16)
    ints = torch.zeros((1, 2), device=cuda_device, dtype=torch.int32)
    with pytest.raises(TypeError):
        kpaged.paged_decode_attention(q, k, k, ints, ints,
                                      ints[:, 0].contiguous(), scale=0.125)


def _k1_tier(k, v, phys, mode, seed):
    """The int8 cold tier of every page (``kvcache.quant``) and a qmask:
    about half the slots (padded ones included), all, or none. Page 0,
    where padded slots point, gets scale 0, which must read as zeros."""
    from repro_torch.kvcache import quant
    kq, ks = quant.quantize_rows(k)
    vq, vs = quant.quantize_rows(v)
    ks[0] = vs[0] = 0.0
    gen = torch.Generator(device="cpu").manual_seed(seed)
    qmask = {"mixed": torch.rand(phys.shape, generator=gen) < 0.5,
             "all": torch.ones(phys.shape, dtype=torch.bool),
             "none": torch.zeros(phys.shape, dtype=torch.bool)}[mode]
    return {"kq": kq, "vq": vq, "k_scale": ks, "v_scale": vs,
            "qmask": qmask.to(phys.device)}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["mixed", "all", "none"])
@pytest.mark.parametrize("b,g,r,d,w,kv_len,page", [
    (4, 16, 1, 128, 64, [1024, 1000, 777, 500], 16),  # the main path
    (3, 4, 4, 128, 16, [256, 201, 37], 16),           # GQA, padded slots
    (3, 4, 4, 64, 16, [256, 0, 93], 16),              # d 64, kv_len 0
    (2, 8, 2, 64, 9, [140, 17], 16),
    (2, 16, 1, 128, 8, [1000, 700], 128)])            # phase 9's tier read
def test_paged_decode_int8_lane_matches_plain(cuda_device, mode, b, g, r, d,
                                              w, kv_len, page):
    """K1's int8 form against its plain version (``_gather_hot(quant=)``),
    bf16 at 2e-2; two calls bit-equal; one counted int8-form launch per
    call. With an all-False qmask it gives the fp form's bits."""
    args = _k1_inputs(b, g, r, d, w, kv_len, seed=w + d, device=cuda_device,
                      page=page, n_pages=64 if page == 128 else 272)
    q, k, v, phys = args[:4]
    tier = _k1_tier(k, v, phys, mode, seed=b + w)
    kernels.reset_launches()
    got = kpaged.paged_decode_attention(*args, scale=d ** -0.5, quant=tier)
    again = kpaged.paged_decode_attention(*args, scale=d ** -0.5, quant=tier)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["paged_decode"] == 2
    assert kernels.FORM_LAUNCHES["paged_decode/int8"] == 2
    assert torch.equal(got, again)
    assert bool(torch.isfinite(got.float()).all())
    want = kpaged.paged_decode_reference(*args, scale=d ** -0.5, quant=tier)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **BF16_TOL)
    fp = kpaged.paged_decode_attention(*args, scale=d ** -0.5)
    assert kernels.FORM_LAUNCHES["paged_decode/fp"] == 1
    if mode == "none":
        assert torch.equal(got, fp)
    else:
        assert not torch.equal(got, fp)
    for i, n in enumerate(kv_len):
        if n == 0:
            assert float(got[i].float().abs().max()) == 0.0


def _own_pages(phys, n_pages):
    """Block tables ``phys`` re-drawn so that no two slots name one page
    of the pool's ``n_pages`` (page 0, where padding points, never)."""
    used = phys >= 0
    fresh = torch.randperm(n_pages - 1, generator=torch.Generator()
                           .manual_seed(n_pages))[:int(used.sum())] + 1
    out = phys.clone()
    out[used] = fresh.to(phys.device, phys.dtype)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("b,g,r,d,w,kv_len,page", [
    (4, 16, 1, 128, 64, [1024, 1000, 777, 500], 16),  # the main path
    (3, 4, 4, 128, 16, [256, 201, 37], 16),
    (3, 4, 4, 64, 16, [256, 0, 93], 16),
    (2, 8, 2, 64, 9, [140, 17], 16),
    (2, 16, 1, 128, 8, [1000, 700], 128),             # phase 9's tier read
    (3, 2, 16, 128, 258, [1040, 2064, 4112], 16),     # ChatGLM3-6B's group
    (1, 4, 12, 128, 130, [2064], 16),                 # StarCoder2-15B's
    (1, 8, 6, 128, 130, [2064], 16),                  # Grok-1's
    (2, 4, 8, 64, 16, [256, 100], 16),
    (2, 2, 4, 256, 16, [256, 100], 16)])
def test_paged_decode_int8_lane_is_fp_over_dequantized(cuda_device, b, g, r,
                                                       d, w, kv_len, page):
    """K1's int8 lane equals, bit for bit, its fp form run over slabs whose
    marked pages hold bf16(float(code) · scale)
    (``kvcache.paged_attention.dequantized_slabs``), on block tables whose
    slots name distinct pages, about half of them marked."""
    from repro_torch.kvcache.paged_attention import dequantized_slabs
    n_pages = sum(-(-n // page) for n in kv_len) + 8
    args = _k1_inputs(b, g, r, d, w, kv_len, seed=w + d, device=cuda_device,
                      page=page, n_pages=n_pages)
    args[3] = _own_pages(args[3], n_pages)
    q, k, v, phys = args[:4]
    tier = _k1_tier(k, v, phys, "mixed", seed=b + w)
    kernels.reset_launches()
    got = kpaged.paged_decode_attention(*args, scale=d ** -0.5, quant=tier)
    kd, vd = dequantized_slabs(k, v, phys, tier)
    fp = kpaged.paged_decode_attention(q, kd, vd, *args[3:],
                                       scale=d ** -0.5)
    torch.cuda.synchronize()
    assert kernels.FORM_LAUNCHES["paged_decode/int8"] == 1
    assert kernels.FORM_LAUNCHES["paged_decode/fp"] == 1
    assert torch.equal(got, fp)


@pytest.mark.cuda
@pytest.mark.parametrize("n_sh,b,g,r,kv_len", [
    (4, 4, 16, 1, [1056, 1568, 2080, 1]),   # chip_smoke phase 13's shape
    (2, 3, 2, 16, [1040, 2064, 17]),        # ChatGLM3-6B's group
    (2, 1, 8, 6, [2064])])                  # Grok-1's group
def test_paged_decode_stats_int8_lane_is_fp_over_dequantized(
        cuda_device, n_sh, b, g, r, kv_len):
    """K1's stats form: its int8 lane equals, bit for bit in m, l and o,
    its fp lane over ``dequantized_slabs`` of the sharded slabs, on
    tables in which each shard's sequences name pages of their own."""
    from repro_torch.kvcache.paged_attention import dequantized_slabs
    n_local = sum(-(-n // 16) for n in kv_len) + 8
    args = _k1_sharded_inputs(n_sh, b, g, r, 128, kv_len, seed=b + r,
                              device=cuda_device, n_local=n_local)
    args[3] = torch.stack([_own_pages(t, n_local) for t in args[3]])
    q, k, v, phys = args[:4]
    tier = _k1_sharded_tier(k, phys, seed=r)
    kernels.reset_launches()
    got = kpaged.paged_decode_stats_attention(*args, scale=128 ** -0.5,
                                              quant=tier)
    kd, vd = dequantized_slabs(k, v, phys, tier)
    fp = kpaged.paged_decode_stats_attention(q, kd, vd, *args[3:],
                                             scale=128 ** -0.5)
    torch.cuda.synchronize()
    assert kernels.FORM_LAUNCHES["paged_decode_stats/int8"] == 1
    assert kernels.FORM_LAUNCHES["paged_decode_stats/fp"] == 1
    for a, b_ in zip(got, fp):
        assert torch.equal(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("b,g,r,w,kv_len", [
    (3, 2, 16, 258, [1040, 2064, 4112]),   # ChatGLM3-6B's served decode
    (1, 4, 12, 130, [2064]),               # StarCoder2-15B's
    (1, 8, 6, 130, [2064]),                # Grok-1's
    (4, 2, 16, 9, [140, 17, 0, 1]),
    (3, 4, 12, 16, [256, 201, 37]),
    (3, 8, 6, 16, [256, 0, 37])])
def test_paged_decode_wide_gqa_groups(cuda_device, quant, b, g, r, w,
                                      kv_len):
    """K1 at the GQA groups of ChatGLM3-6B (R = 16), StarCoder2-15B
    (R = 12) and Grok-1 (R = 6; neither a power of two), fp and int8
    forms, against its plain version, bf16 at 2e-2; two calls bit-equal;
    one counted launch each."""
    args = _k1_inputs(b, g, r, 128, w, kv_len, seed=r + w,
                      device=cuda_device)
    tier = _k1_tier(args[1], args[2], args[3], "mixed", seed=b + r) \
        if quant else None
    kernels.reset_launches()
    got = kpaged.paged_decode_attention(*args, scale=128 ** -0.5, quant=tier)
    again = kpaged.paged_decode_attention(*args, scale=128 ** -0.5,
                                          quant=tier)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["paged_decode"] == 2
    assert kernels.FORM_LAUNCHES["paged_decode/int8" if quant
                                 else "paged_decode/fp"] == 2
    assert torch.equal(got, again)
    want = kpaged.paged_decode_reference(*args, scale=128 ** -0.5,
                                         quant=tier)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **BF16_TOL)
    for i, n in enumerate(kv_len):
        if n == 0:
            assert float(got[i].float().abs().max()) == 0.0


@pytest.mark.cuda
def test_paged_decode_quant_never_takes_the_gather(cuda_device,
                                                   monkeypatch):
    """``kvcache.paged_attention.paged_decode(quant=...)`` on CUDA tensors
    launches K1's int8 form and never enters the plain gather; a tier the
    kernel does not take raises instead of falling back."""
    from repro_torch.kvcache import paged_attention as tpa

    def refuse(*a, **kw):
        raise AssertionError("the plain gather ran on the card")
    monkeypatch.setattr(tpa, "_gather_hot", refuse)
    args = _k1_inputs(2, 4, 2, 128, 8, [100, 64], seed=3,
                      device=cuda_device)
    q, k, v, phys = args[:4]
    tier = _k1_tier(k, v, phys, "mixed", seed=4)
    kernels.reset_launches()
    out = tpa.paged_decode(q.reshape(2, 8, 128), k, v, *args[3:], n_kv=4,
                           quant=tier)
    torch.cuda.synchronize()
    assert out.shape == (2, 8, 128)
    assert kernels.FORM_LAUNCHES["paged_decode/int8"] == 1
    with pytest.raises(TypeError, match="qmask"):
        tpa.paged_decode(q.reshape(2, 8, 128), k, v, *args[3:], n_kv=4,
                         quant=dict(tier, qmask=tier["qmask"].int()))
    assert kernels.FORM_LAUNCHES["paged_decode/int8"] == 1


def _k1_sharded_inputs(n_sh, b, g, r, d, kv_len, seed, device, page=16,
                       n_local=72, empty_shard=None):
    """A sequence-sharded pool as the spatial engine builds it: global page
    j of each sequence on shard j % n_sh at a random local id, its table
    entry carrying the GLOBAL logical index. ``empty_shard`` holds no
    page of any sequence (its hot sets come back empty)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((b, g, r, d), generator=gen)
    k = torch.randn((n_sh, n_local, page, g, d), generator=gen)
    v = torch.randn((n_sh, n_local, page, g, d), generator=gen)
    n_pages = [-(-n // page) for n in kv_len]
    w = max(1, max(-(-n // n_sh) for n in n_pages))
    phys = torch.full((n_sh, b, w), -1, dtype=torch.int32)
    logical = torch.full((n_sh, b, w), -1, dtype=torch.int32)
    for i, n in enumerate(n_pages):
        for s in range(n_sh):
            js = list(range(s, n, n_sh))
            if s == empty_shard or not js:
                continue
            phys[s, i, :len(js)] = (torch.randperm(
                n_local - 1, generator=gen)[:len(js)] + 1).int()
            logical[s, i, :len(js)] = torch.tensor(js, dtype=torch.int32)
    bf = [t.to(device, torch.bfloat16) for t in (q, k, v)]
    kvl = torch.tensor(kv_len, dtype=torch.int32)
    return bf + [t.to(device) for t in (phys, logical, kvl)]


def _k1_sharded_tier(k, phys, seed):
    """The int8 tier of every page of every shard, about half the slots
    marked. Its codes quantize K and V rows drawn apart from the fp
    slabs', each page at a magnitude of its own (K within 2^±1, V within
    2^±4), so that a lane reading a marked slot's fp rows, or another
    page's scale, lands far from the plain version."""
    from repro_torch.kvcache import quant
    gen = torch.Generator(device="cpu").manual_seed(seed)
    tier = {}
    for name, span in (("k", 1.0), ("v", 4.0)):
        mag = 2.0 ** ((2 * torch.rand(k.shape[:2], generator=gen) - 1)
                      * span)
        rows = (torch.randn(k.shape, generator=gen)
                * mag[..., None, None, None]).to(k.device, k.dtype)
        tier[f"{name}q"], tier[f"{name}_scale"] = quant.quantize_rows(rows)
    tier["qmask"] = (torch.rand(phys.shape, generator=gen) < 0.5).to(
        phys.device)
    return tier


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("n_sh,b,g,r,kv_len,empty", [
    (4, 4, 16, 1, [1040, 1552, 2064, 2064], None),  # chip_smoke phase 13
    (4, 4, 16, 1, [1040, 1552, 2064, 33], 2),       # a shard with no row
    (2, 3, 2, 16, [1040, 2064, 17], None),          # ChatGLM3-6B's group
    (2, 1, 8, 6, [2064], None),                     # Grok-1's group
    (4, 2, 2, 16, [300, 5], 3)])
def test_paged_decode_stats_matches_plain(cuda_device, quant, n_sh, b, g, r,
                                          kv_len, empty):
    """K1's unnormalised (m, l, o) form over every shard in one launch
    sequence, against its plain version (``paged_gather_decode_stats`` on
    each shard), fp and int8 lanes: m, l and o/l at the bf16 bound 2e-2;
    a shard with no valid row gives (NEG_INF, 0, 0); two calls bit-equal;
    counted under its own name, never as the normalised form."""
    args = _k1_sharded_inputs(n_sh, b, g, r, 128, kv_len, seed=b + r,
                              device=cuda_device, empty_shard=empty)
    tier = _k1_sharded_tier(args[1], args[3], seed=r) if quant else None
    kernels.reset_launches()
    got = kpaged.paged_decode_stats_attention(*args, scale=128 ** -0.5,
                                              quant=tier)
    again = kpaged.paged_decode_stats_attention(*args, scale=128 ** -0.5,
                                                quant=tier)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["paged_decode_stats"] == 2
    assert kernels.LAUNCHES["paged_decode"] == 0
    assert kernels.FORM_LAUNCHES["paged_decode_stats/int8" if quant
                                 else "paged_decode_stats/fp"] == 2
    for a, a2 in zip(got, again):
        assert torch.equal(a, a2)
    want = kpaged.paged_decode_stats_reference(*args, scale=128 ** -0.5,
                                               quant=tier)
    (m, l, o), (wm, wl, wo) = got, want
    live = wl > 0
    assert torch.equal(live, l > 0)
    np.testing.assert_allclose(m[live].cpu().numpy(), wm[live].cpu().numpy(),
                               **BF16_TOL)
    np.testing.assert_allclose(l[live].cpu().numpy(), wl[live].cpu().numpy(),
                               **BF16_TOL)
    on = (o / torch.clamp(l, min=1e-30)[..., None])[live]
    won = (wo / torch.clamp(wl, min=1e-30)[..., None])[live]
    np.testing.assert_allclose(on.cpu().numpy(), won.cpu().numpy(),
                               **BF16_TOL)
    assert bool((m[~live] == -1e30).all()) and bool((o[~live] == 0).all())
    if empty is not None:
        assert not bool(live[empty].any())
    if quant:
        # the check's reach: the fp lane (a lane that ignored qmask) and
        # the plain version fed the next page's scales break the bound;
        # an all-False qmask gives the fp lane's bits
        fp = kpaged.paged_decode_stats_attention(*args, scale=128 ** -0.5)
        none = dict(tier, qmask=torch.zeros_like(tier["qmask"]))
        for a, a2 in zip(kpaged.paged_decode_stats_attention(
                *args, scale=128 ** -0.5, quant=none), fp):
            assert torch.equal(a, a2)
        rolled = dict(tier, k_scale=tier["k_scale"].roll(1),
                      v_scale=tier["v_scale"].roll(1))
        for _, bl, bo in (fp, kpaged.paged_decode_stats_reference(
                *args, scale=128 ** -0.5, quant=rolled)):
            bad = (bo / torch.clamp(bl, min=1e-30)[..., None])[live]
            assert not np.allclose(bad.cpu().numpy(), won.cpu().numpy(),
                                   **BF16_TOL)


# -- the prefill tile kernels: K2 (DLZS block maxima), K3 (SU-FA), K4 --------

# K2's maxima are fp32 sums of exact bf16 x pow2 products: only the order
# of the sum differs from the plain version's fp32 matmul.
K2_TOL = dict(rtol=1e-4, atol=1e-4)
SUFA_TOL = dict(rtol=3e-2, atol=3e-2)     # tests/test_kernels.py's sufa bound


def _bf16(shape, gen, device, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to(device,
                                                          torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("t,s,block,causal", [
    (256, 256, 128, True), (256, 256, 128, False), (256, 256, 16, True),
    (128, 384, 64, True), (96, 96, 32, True)])
def test_dlzs_block_kernel_matches_plain(cuda_device, d, t, s, block,
                                         causal):
    """K2 against ``ref.dlzs_block_ref``: wholly masked tiles are NEG_INF
    in both, the rest agree up to the fp32 sum order."""
    from repro_torch.kernels import dlzs as kdlzs
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cpu").manual_seed(d + t + block)
    q = _bf16((4, t, d), gen, cuda_device)
    k = _bf16((4, s, d), gen, cuda_device, scale=3.0)
    kernels.reset_launches()
    got = kdlzs.dlzs_block_scores(q, k, causal=causal, block_q=block,
                                  block_kv=block)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["dlzs_block"] == 1
    want = ref.dlzs_block_ref(q, k, causal=causal, block_q=block,
                              block_kv=block)
    assert got.dtype == torch.float32 and got.shape == want.shape
    masked = want <= -1e29
    assert torch.equal(got <= -1e29, masked)
    np.testing.assert_allclose(got[~masked].cpu().numpy(),
                               want[~masked].cpu().numpy(), **K2_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("t,s,causal", [
    (128, 128, True), (1024, 1024, True), (2048, 2048, True),
    (1024, 1024, False), (256, 640, True), (128, 384, False)])
def test_dlzs_block_wgmma_form(cuda_device, d, t, s, causal):
    """K2's wgmma form (128 x 128 tiles) against ``ref.dlzs_block_ref`` at
    1e-4, up to the served T = S = 2048 and at S > T; one launch, counted
    under its form; two calls give the same bits."""
    from repro_torch.kernels import dlzs as kdlzs
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cpu").manual_seed(d + t + s)
    q = _bf16((4, t, d), gen, cuda_device)
    k = _bf16((4, s, d), gen, cuda_device, scale=3.0)
    kernels.reset_launches()
    got = kdlzs.dlzs_block_scores(q, k, causal=causal)
    again = kdlzs.dlzs_block_scores(q, k, causal=causal)
    torch.cuda.synchronize()
    assert kernels.FORM_LAUNCHES["dlzs_block/wgmma"] == 2
    assert torch.equal(got, again)
    want = ref.dlzs_block_ref(q, k, causal=causal)
    masked = want <= -1e29
    assert torch.equal(got <= -1e29, masked)
    np.testing.assert_allclose(got[~masked].cpu().numpy(),
                               want[~masked].cpu().numpy(), **K2_TOL)


def _selection(bh, t, s, keep, block_q, block_kv, gen, device):
    """Tile ids in a random order and a random validity pattern (some
    q-tiles with their first tile invalid)."""
    n_qt, n_kt = t // block_q, s // block_kv
    idx = torch.stack([torch.randperm(n_kt, generator=gen)[:keep]
                       for _ in range(bh * n_qt)]).reshape(bh, n_qt, keep)
    valid = torch.rand((bh, n_qt, keep), generator=gen) < 0.8
    valid[..., -1] = True
    return idx.to(device), valid.to(device)


def _check_sufa(q, k, v, idx, valid, *, block, strict, causal=True,
                form):
    from repro_torch.kernels import sufa as ksufa
    kw = dict(block_q=block, block_kv=block, causal=causal, strict=strict)
    kernels.reset_launches()
    got = ksufa.sufa_attention(q, k, v, idx, valid, **kw)
    again = ksufa.sufa_attention(q, k, v, idx, valid, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sufa"] == 2
    assert kernels.FORM_LAUNCHES[f"sufa/{form}"] == 2
    assert torch.equal(got, again)
    want = ksufa.sufa_reference(q, k, v, idx, valid,
                                scale=q.shape[-1] ** -0.5, **kw)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **SUFA_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("d,block,keep", [(64, 16, 3), (128, 64, 2),
                                          (128, 128, 4), (64, 48, 1)])
def test_sufa_kernel_matches_plain(cuda_device, strict, d, block, keep):
    """K3 in both modes against ``kernels.sufa.sufa_reference`` (the exact
    masked softmax, or the frozen-max recurrence, over the gathered
    tiles), bf16 at 3e-2, reading the tiles in place from ids in a random
    order, with invalid tiles and rows that see no key in their first
    tile; tiles of 128 take the wgmma form, the others mma.sync."""
    gen = torch.Generator(device="cpu").manual_seed(d + block + keep)
    t = 4 * block
    q, k, v = (_bf16((3, t, d), gen, cuda_device) for _ in range(3))
    idx, valid = _selection(3, t, t, keep, block, block, gen, cuda_device)
    _check_sufa(q, k, v, idx, valid, block=block, strict=strict,
                form="wgmma" if block == 128 else "mma_sync")


@pytest.mark.cuda
@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("block,t,s,keep,causal", [
    (128, 2048, 2048, 4, True), (128, 512, 1024, 3, True),
    (128, 384, 384, 1, True), (128, 256, 768, 2, False),
    (16, 64, 96, 3, True), (48, 96, 192, 2, True), (64, 128, 256, 4, False)])
def test_sufa_kernel_forms(cuda_device, strict, d, block, t, s, keep,
                           causal):
    """Both forms (wgmma at 128 tiles, mma.sync at 16/48/64) in both modes
    at d 64 and 128: the served T = S = 2048, S > T, keep 1, non-causal;
    two calls bit-equal."""
    gen = torch.Generator(device="cpu").manual_seed(d + block + t + s)
    q = _bf16((2, t, d), gen, cuda_device)
    k, v = (_bf16((2, s, d), gen, cuda_device) for _ in range(2))
    idx, valid = _selection(2, t, s, keep, block, block, gen, cuda_device)
    _check_sufa(q, k, v, idx, valid, block=block, strict=strict,
                causal=causal, form="wgmma" if block == 128 else "mma_sync")


@pytest.mark.cuda
@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("d,block,t,s,keep,causal,bh", [
    (128, 128, 1024, 1024, 3, True, 2), (64, 128, 1024, 1024, 3, True, 2),
    (128, 128, 4096, 4096, 7, True, 32), (64, 16, 64, 96, 3, True, 2),
    (128, 64, 128, 256, 4, False, 2), (128, 48, 96, 192, 2, True, 2)])
def test_sufa_kernel_elementwise(cuda_device, strict, d, block, t, s, keep,
                                 causal, bh):
    """K3's element-level sphere mask (the wgmma form at 128 tiles, d 64
    and 128, up to BH 32 and T 4096; the mma.sync form at 16, 48 and 64)
    against ``sufa_reference(elementwise=True)``, bf16 at 3e-2, both
    modes; two calls bit-equal; at radius 2 the mask drops keys (the
    output differs from the tile-level call's). The plain version's
    estimates come from an fp32-summed bf16 product, as the kernel's."""
    from repro_torch.kernels import sufa as ksufa
    gen = torch.Generator(device="cpu").manual_seed(d + block + t + s)
    q = _bf16((bh, t, d), gen, cuda_device)
    k, v = (_bf16((bh, s, d), gen, cuda_device) for _ in range(2))
    idx, valid = _selection(bh, t, s, keep, block, block, gen, cuda_device)
    kw = dict(block_q=block, block_kv=block, causal=causal, strict=strict,
              radius=2.0)
    form = "wgmma" if block == 128 else "mma_sync"
    kernels.reset_launches()
    got = ksufa.sufa_attention(q, k, v, idx, valid, elementwise=True, **kw)
    again = ksufa.sufa_attention(q, k, v, idx, valid, elementwise=True,
                                 **kw)
    torch.cuda.synchronize()
    assert kernels.FORM_LAUNCHES[f"sufa/{form}"] == 2
    assert kernels.FORM_LAUNCHES["sufa/elementwise"] == 2
    assert torch.equal(got, again)
    matmul = torch.backends.cuda.matmul
    old = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        want = ksufa.sufa_reference(q, k, v, idx, valid, scale=d ** -0.5,
                                    elementwise=True, **kw)
    finally:
        matmul.allow_bf16_reduced_precision_reduction = old
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **SUFA_TOL)
    tiles = ksufa.sufa_attention(q, k, v, idx, valid, **kw)
    assert float((tiles.float() - got.float()).abs().max()) > 3e-2


@pytest.mark.cuda
@pytest.mark.parametrize("block", [128, 32])
def test_sufa_kernel_all_invalid_rows_are_zero(cuda_device, block):
    """A q-tile with no valid tile writes zeros, in both forms."""
    from repro_torch.kernels import sufa as ksufa
    gen = torch.Generator(device="cpu").manual_seed(block)
    q, k, v = (_bf16((2, 2 * block, 64), gen, cuda_device) for _ in range(3))
    idx, valid = _selection(2, 2 * block, 2 * block, 2, block, block, gen,
                            cuda_device)
    valid[1, 0] = False
    got = ksufa.sufa_attention(q, k, v, idx, valid, block_q=block,
                               block_kv=block, strict=False)
    torch.cuda.synchronize()
    assert float(got[1, :block].float().abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("t,s,causal", [
    (256, 256, True), (256, 256, False), (991, 991, True), (200, 200, False),
    (100, 300, True), (300, 100, True), (2048, 2048, True),
    (1024, 1024, True), (1, 1, True), (1, 300, True), (129, 129, True),
    (300, 1, True), (1, 1, False)])
def test_flash_kernel_matches_plain(cuda_device, d, t, s, causal):
    """K4 against ``ref.flash_ref``, bf16 at 2e-2, at ragged T and S (the
    kernel masks the edge itself, within one tile too: T or S of 1), at
    T > S, where the first rows see no key and are zero, and at the served
    T = S = 2048."""
    from repro_torch.kernels import flash as kflash
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cpu").manual_seed(d + t + s)
    q = _bf16((4, t, d), gen, cuda_device)
    k, v = (_bf16((4, s, d), gen, cuda_device) for _ in range(2))
    kernels.reset_launches()
    got = kflash.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash"] == 1
    want = ref.flash_ref(q, k, v, causal=causal)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("t,groups", [(512, 1), (1024, 2)])
def test_star_glue_matches_plain_scanq(cuda_device, t, groups):
    """The fused STAR prefill (K2 -> SADS -> K3) against the plain
    ``core.star_attention_scanq`` on the card, bf16, olmo_1b's STAR tiles:
    SU-FA's bound scaled by the output's magnitude (the plain form rounds
    each score to bf16 before its softmax, K3 keeps fp32); one launch of
    each kernel per prefix group."""
    from repro_torch.configs import olmo_1b
    from repro_torch.core.star_attention import star_attention_scanq
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cpu").manual_seed(t + groups)
    q, k, v = (_bf16((4, t, 128), gen, cuda_device) for _ in range(3))
    star = dataclasses.replace(olmo_1b.config().star, prefix_groups=groups)
    kernels.reset_launches()
    got = ops.star_attention_cfg(q, k, v, star, causal=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["dlzs_block"] == kernels.LAUNCHES["sufa"] == \
        groups
    want = torch.stack([star_attention_scanq(q[i], k[i], v[i], star,
                                             causal=True)
                        for i in range(4)]).float().cpu().numpy()
    tol = dict(SUFA_TOL)
    tol["atol"] *= max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().cpu().numpy(), want, **tol)


def _fp32_calls(device):
    """One call per wrapper on float32 CUDA operands."""
    from repro_torch.kernels import dlzs as kdlzs
    from repro_torch.kernels import flash as kflash
    from repro_torch.kernels import sufa as ksufa
    q = torch.zeros((2, 64, 64), device=device)
    idx = torch.zeros((2, 1, 1), device=device, dtype=torch.int64)
    valid = torch.ones((2, 1, 1), device=device, dtype=torch.bool)
    return {"dlzs_block": lambda: kdlzs.dlzs_block_scores(
                q, q, block_q=64, block_kv=64),
            "sufa": lambda: ksufa.sufa_attention(q, q, q, idx, valid,
                                                 block_q=64, block_kv=64),
            "flash": lambda: kflash.flash_attention(q, q, q)}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["dlzs_block", "sufa", "flash"])
def test_prefill_kernel_rejects_cpu_fallback(cuda_device, kernel):
    """On CUDA tensors the wrapper launches or raises: float32 operands
    are refused, never served by the plain version, and not counted."""
    kernels.reset_launches()
    with pytest.raises(TypeError):
        _fp32_calls(cuda_device)[kernel]()
    assert kernels.LAUNCHES[kernel] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["idx_int32", "valid_int8", "idx_shape",
                                  "tiles", "idx_on_cpu"])
def test_sufa_kernel_rejects_bad_ids(cuda_device, case):
    """K3's wrapper raises on tile ids it cannot launch on (and counts
    nothing): int32 ids, an int8 validity, ids of another tiling, T not a
    multiple of the q-tile, ids left on the CPU."""
    from repro_torch.kernels import sufa as ksufa
    q = torch.zeros((2, 256, 64), device=cuda_device, dtype=torch.bfloat16)
    idx = torch.zeros((2, 2, 1), device=cuda_device, dtype=torch.int64)
    valid = torch.ones((2, 2, 1), device=cuda_device, dtype=torch.bool)
    kw = dict(block_q=128, block_kv=128)
    call, err = {
        "idx_int32": ((q, q, q, idx.int(), valid), TypeError),
        "valid_int8": ((q, q, q, idx, valid.to(torch.int8)), TypeError),
        "idx_shape": ((q, q, q, idx[:, :1], valid[:, :1]), ValueError),
        "tiles": ((q[:, :200].contiguous(), q, q, idx, valid), ValueError),
        "idx_on_cpu": ((q, q, q, idx.cpu(), valid.cpu()), TypeError)}[case]
    kernels.reset_launches()
    with pytest.raises(err):
        ksufa.sufa_attention(*call, **kw)
    assert kernels.LAUNCHES["sufa"] == 0


# -- the forms the frontend-stub families serve (phases 18-19) -----------------

def _glue_selection(q, k, *, causal):
    """The tiles the STAR glue selects for q, k (olmo_1b's STAR config,
    tiles 128), as the encoder's prefill would."""
    from repro_torch.configs import olmo_1b
    from repro_torch.kernels import dlzs as kdlzs
    from repro_torch.kernels import ops
    star = olmo_1b.config().star
    raw = kdlzs.dlzs_block_scores(q, k, causal=causal, scale=1.0)
    return ops.select_tiles(raw, star.keep_blocks(k.shape[1]),
                            scale=q.shape[-1] ** -0.5, radius=star.radius,
                            dtype=q.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dlzs_block", "sufa_strict", "sufa_fast",
                                  "flash_s2048", "flash_s1000"])
def test_encoder_and_cross_forms_match_plain(cuda_device, case):
    """SeamlessM4T's prefill forms at its shapes (BH 16, d 64): the
    encoder's K2 and K3 non-causal at 2048 frames, K3 on the glue's own
    selection; the cross-attention's K4 non-causal over 256 decoder rows
    and 2048 encoder rows, or a ragged 1000 (keys past S stay masked,
    ``q_offset`` = S - T has no effect). Each launch counted under
    ``<kernel>/noncausal``; two calls bit-equal."""
    from repro_torch.kernels import dlzs as kdlzs
    from repro_torch.kernels import flash as kflash
    from repro_torch.kernels import ref
    from repro_torch.kernels import sufa as ksufa
    gen = torch.Generator(device="cpu").manual_seed(len(case))
    t = 256 if case.startswith("flash") else 2048
    s = int(case[len("flash_s"):]) if case.startswith("flash") else t
    q = _bf16((16, t, 64), gen, cuda_device)
    k = _bf16((16, s, 64), gen, cuda_device, scale=3.0)
    v = _bf16((16, s, 64), gen, cuda_device)
    if case == "dlzs_block":
        call = lambda: kdlzs.dlzs_block_scores(q, k, causal=False)  # noqa
        want, tol = ref.dlzs_block_ref(q, k, causal=False), K2_TOL
    elif case.startswith("sufa"):
        idx, valid = _glue_selection(q, k, causal=False)
        kw = dict(block_q=128, block_kv=128, causal=False,
                  strict=case == "sufa_strict")
        call = lambda: ksufa.sufa_attention(q, k, v, idx, valid,  # noqa
                                            **kw)
        want = ksufa.sufa_reference(q, k, v, idx, valid, scale=0.125, **kw)
        tol = SUFA_TOL
    else:
        call = lambda: kflash.flash_attention(q, k, v, causal=False)  # noqa
        want, tol = ref.flash_ref(q, k, v, causal=False), BF16_TOL
    name = case.split("_")[0] if case != "dlzs_block" else case
    kernels.reset_launches()
    got, again = call(), call()
    torch.cuda.synchronize()
    assert kernels.FORM_LAUNCHES[f"{name}/noncausal"] == 2
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["dlzs_block", "sufa", "flash"])
def test_bh48_forms_match_plain(cuda_device, kernel):
    """InternVL2-26B's prefill forms: BH 48 (48 heads, K/V expanded from
    8), T = S = 4096, d 128, causal; no non-causal launch counted."""
    from repro_torch.kernels import dlzs as kdlzs
    from repro_torch.kernels import flash as kflash
    from repro_torch.kernels import ref
    from repro_torch.kernels import sufa as ksufa
    gen = torch.Generator(device="cpu").manual_seed(48)
    q, k, v = (_bf16((48, 4096, 128), gen, cuda_device) for _ in range(3))
    kernels.reset_launches()
    if kernel == "dlzs_block":
        got = kdlzs.dlzs_block_scores(q, k, causal=True)
        want, tol = ref.dlzs_block_ref(q, k, causal=True), K2_TOL
        masked = want <= -1e29
        assert torch.equal(got <= -1e29, masked)
        got, want = got[~masked], want[~masked]
    elif kernel == "sufa":
        idx, valid = _glue_selection(q, k, causal=True)
        kw = dict(block_q=128, block_kv=128, causal=True, strict=True)
        got = ksufa.sufa_attention(q, k, v, idx, valid, **kw)
        want = ksufa.sufa_reference(q, k, v, idx, valid,
                                    scale=128 ** -0.5, **kw)
        tol = SUFA_TOL
    else:
        got = kflash.flash_attention(q, k, v, causal=True)
        want, tol = ref.flash_ref(q, k, v, causal=True), BF16_TOL
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[kernel] == 1
    assert kernels.FORM_LAUNCHES[f"{kernel}/noncausal"] == 0
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)


@pytest.mark.cuda
def test_paged_decode_internvl2_group(cuda_device):
    """K1 at InternVL2-26B's served decode shape: B 3, G 8, R 6, d 128,
    W 258 (its 1024-, 2048- and 4096-token prompts 16 tokens on)."""
    args = _k1_inputs(3, 8, 6, 128, 258, [1040, 2064, 4112], 21,
                      cuda_device, n_pages=512)
    kernels.reset_launches()
    got = kpaged.paged_decode_attention(*args, scale=128 ** -0.5)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["paged_decode"] == 1
    want = kpaged.paged_decode_reference(*args, scale=128 ** -0.5)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **BF16_TOL)


@pytest.mark.cuda
def test_encdec_prefill_and_decode_on_card(cuda_device):
    """A small encoder-decoder model (Seamless's smoke pattern at head_dim
    64, tiles 128) through ``lm.prefill`` and two ``decode_step``s on the
    card, ``star=None``: K4 runs non-causal in the encoder and the
    cross-attention; the logits agree with the same weights' run on the
    CPU (the plain versions) at the bf16 bound scaled by magnitude."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_smoke_config("seamless_m4t_large_v2"),
                              d_model=256, star=None)
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator(device="cpu").manual_seed(1)
    batch = {"enc_embeds": torch.randn((2, 256, 256), generator=gen)
             .bfloat16(),
             "tokens": torch.randint(0, cfg.vocab, (2, 128), generator=gen)}
    toks = torch.randint(0, cfg.vocab, (2, 2, 1), generator=gen).int()

    def run(device):
        p = _to(params, device)
        b = {k: v.to(device) for k, v in batch.items()}
        logits, cache = lm.prefill(p, cfg, b, cache_len=144)
        out = [logits]
        for tok in toks:
            logits, cache = lm.decode_step(p, cfg, tok.to(device), cache)
            out.append(logits)
        return torch.stack(out).float().cpu()

    kernels.reset_launches()
    got = run(cuda_device)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash"] == 2 * 2 + 2
    assert kernels.FORM_LAUNCHES["flash/noncausal"] == 2 + 2
    want = run("cpu")
    tol = dict(BF16_TOL)
    tol["atol"] *= max(1.0, float(want.abs().max()))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


# -- K4's backward (training) -------------------------------------------------

def _lowp_attention(q, k, v, *, causal, scale):
    """Attention computed in the inputs' dtype (scores, softmax, P·V), the
    FlashAttention repository's yardstick for a bf16 gradient."""
    from repro_torch.kernels import ref
    t, s = q.shape[1], k.shape[1]
    sc = torch.einsum("btd,bsd->bts", q, k) * scale
    if causal:
        sc = sc.masked_fill(~ref._causal_mask(t, s, q.device), ref.NEG_INF)
    return torch.einsum("bts,bsd->btd", torch.softmax(sc, -1).to(v.dtype), v)


def _lowp_grads(q, k, v, do, *, causal, scale):
    """The bf16 plain gradient. Rows that see no key (causal, T > S) are
    left out of its forward, as K4 leaves them (a plain softmax spreads
    them evenly over the masked keys): their dQ is 0, and they add
    nothing to dK and dV."""
    cut = max(q.shape[1] - k.shape[1], 0) if causal else 0
    leaves = [x.detach().requires_grad_() for x in (q[:, cut:], k, v)]
    dq, dk, dv = torch.autograd.grad(
        _lowp_attention(*leaves, causal=causal, scale=scale), leaves,
        do[:, cut:])
    return torch.cat([torch.zeros_like(q[:, :cut]), dq], dim=1), dk, dv


# the backward's tile edges: 64-row query tiles, 128-key tiles
_BWD_EDGES = (63, 64, 65, 127, 128, 129)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("bh,t,s,causal", [
    (4, 256, 256, True), (4, 1000, 1000, True), (4, 256, 2048, False),
    (4, 300, 100, False), (4, 100, 300, True), (4, 129, 129, True),
    (4, 1, 1, True), (4, 2048, 2048, True)] + [
    (1, t, s, causal) for causal in (True, False) for t in _BWD_EDGES
    for s in _BWD_EDGES])
def test_flash_bwd_kernel_matches_plain(cuda_device, d, bh, t, s, causal):
    """K4's backward against ``ref.flash_bwd_ref`` in fp32: dQ, dK and dV
    each no further from it than twice the bf16 plain gradient is (plus
    1e-5), the FlashAttention repository's rule, at the usual shapes and
    at every pair of T, S around the kernel's tile edges; rows that see
    no key (causal, T > S) get dQ = 0 exactly; one counted launch; three
    calls bit-equal, one of them on a side stream (the ordered dQ
    reduction, no free-running atomics)."""
    from repro_torch.kernels import flash as kflash
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cpu").manual_seed(d * 7 + t + s + bh)
    q = _bf16((bh, t, d), gen, cuda_device)
    k, v = (_bf16((bh, s, d), gen, cuda_device) for _ in range(2))
    do = _bf16((bh, t, d), gen, cuda_device)
    scale = d ** -0.5
    o, lse = kflash.flash_attention(q, k, v, causal=causal, return_lse=True)
    kernels.reset_launches()
    got = kflash.flash_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_bwd"] == 1
    again = kflash.flash_bwd(q, k, v, o, lse, do, causal=causal)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        third = kflash.flash_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert all(torch.equal(a.view(torch.int16), b.view(torch.int16))
               for other in (again, third) for a, b in zip(got, other))
    blind = max(t - s, 0) if causal else 0
    assert bool((got[0][:, :blind] == 0).all())
    f32 = [x.float() for x in (q, k, v)]
    o32, lse32 = ref.flash_ref(*f32, causal=causal, return_lse=True)
    want = ref.flash_bwd_ref(*f32, o32, lse32, do.float(), causal=causal)
    lowp = _lowp_grads(q, k, v, do, causal=causal, scale=scale)
    for g, w, p in zip(got, want, lowp):
        err = float((g.float() - w).abs().max())
        assert err <= 2 * float((p.float() - w).abs().max()) + 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("t,s,causal,d", [
    (2048, 2048, True, 128), (991, 991, True, 64), (256, 2048, False, 64),
    (300, 100, True, 128)])
def test_flash_lse_output(cuda_device, t, s, causal, d):
    """K4's optional lse: the plain log-sum-exp at 1e-4 (+inf on the rows
    of T > S that see no key), and the same O bits with it as without."""
    from repro_torch.kernels import flash as kflash
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cpu").manual_seed(t + s + d)
    q = _bf16((4, t, d), gen, cuda_device)
    k, v = (_bf16((4, s, d), gen, cuda_device) for _ in range(2))
    o, lse = kflash.flash_attention(q, k, v, causal=causal, return_lse=True)
    plain = kflash.flash_attention(q, k, v, causal=causal)
    assert torch.equal(o.view(torch.int16), plain.view(torch.int16))
    _, want = ref.flash_ref(q, k, v, causal=causal, return_lse=True)
    assert torch.equal(torch.isinf(lse), torch.isinf(want))
    fin = torch.isfinite(want)
    np.testing.assert_allclose(lse[fin].cpu().numpy(),
                               want[fin].cpu().numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_training_step_launches_k4_backward(cuda_device):
    """A loss's backward through ``lm.loss_fn`` on the card runs K4's
    backward once per attention layer and K4's forward twice (forward and
    recompute under ``remat="full"``); the gradients agree with the same
    step on the CPU's plain path at the bf16 bound."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(get_smoke_config("olmo_1b"), star=None,
                              n_heads=2, n_kv=2)        # head_dim 32 -> 64
    cfg = dataclasses.replace(cfg, d_model=128, d_ff=256)
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (2, 128), generator=gen)
             for k in ("tokens", "labels")}
    kernels.reset_launches()
    (loss, _), grads = steps.value_and_grad(
        _to(params, cuda_device), cfg,
        {k: v.to(cuda_device) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_bwd"] == cfg.n_layers
    assert kernels.LAUNCHES["flash"] == 2 * cfg.n_layers
    (loss_cpu, _), grads_cpu = steps.value_and_grad(params, cfg, batch)
    assert abs(float(loss) - float(loss_cpu)) <= 2e-2 * float(loss_cpu)
    for g, w in zip(tree_leaves(grads), tree_leaves(grads_cpu)):
        w = w.float()
        np.testing.assert_allclose(
            g.float().cpu().numpy(), w.numpy(), rtol=2e-2,
            atol=2e-2 * max(1.0, float(w.abs().max())))


@pytest.mark.cuda
def test_kernels_without_backward_refuse_grad(cuda_device):
    """K2 has no backward (STAR's selection is not differentiated):
    operands that require grad raise rather than lose their gradient."""
    from repro_torch.kernels import dlzs as kdlzs
    gen = torch.Generator(device="cpu").manual_seed(0)
    q, k = (_bf16((2, 256, 128), gen, cuda_device).requires_grad_()
            for _ in range(2))
    with pytest.raises(RuntimeError, match="no backward"):
        kdlzs.dlzs_block_scores(q, k, causal=True)


# -- K3's backward (STAR in training) ----------------------------------------

def _star_selection(q, k, block, keep):
    """The glue's selection for q, k (K2's maxima, SADS at radius 5)."""
    from repro_torch.kernels import dlzs as kdlzs
    from repro_torch.kernels import ops
    raw = kdlzs.dlzs_block_scores(q, k, causal=True, scale=1.0,
                                  block_q=block, block_kv=block)
    return ops.select_tiles(raw, keep, scale=q.shape[-1] ** -0.5,
                            radius=5.0, dtype=q.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("d,block,t,s,causal", [
    (128, 128, 2048, 2048, True), (64, 128, 1024, 1024, False),
    (128, 128, 256, 2048, True), (128, 64, 512, 512, True),
    (64, 16, 256, 256, True), (128, 48, 192, 384, False)])
def test_sufa_lse_output(cuda_device, strict, d, block, t, s, causal):
    """K3's optional lse in both forms and modes: the plain log-sum-exp at
    1e-4 (+inf on a q-tile with no valid slot), and the same O bits with
    it as without."""
    from repro_torch.kernels import sufa as ksufa
    gen = torch.Generator(device="cpu").manual_seed(d + block + t + s)
    q = _bf16((4, t, d), gen, cuda_device)
    k, v = (_bf16((4, s, d), gen, cuda_device) for _ in range(2))
    idx, valid = _selection(4, t, s, min(3, s // block), block, block, gen,
                            cuda_device)
    valid[1, 0] = False
    kw = dict(block_q=block, block_kv=block, causal=causal, strict=strict)
    o, lse = ksufa.sufa_attention(q, k, v, idx, valid, return_lse=True, **kw)
    plain = ksufa.sufa_attention(q, k, v, idx, valid, **kw)
    assert torch.equal(o.view(torch.int16), plain.view(torch.int16))
    _, want = ksufa.sufa_reference(q, k, v, idx, valid, scale=d ** -0.5,
                                   return_lse=True, **kw)
    assert torch.equal(torch.isinf(lse), torch.isinf(want))
    assert bool(torch.isinf(lse[1, :block]).all())
    fin = torch.isfinite(want)
    np.testing.assert_allclose(lse[fin].cpu().numpy(),
                               want[fin].cpu().numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("bh,t,s,block,causal,edges", [
    (4, 2048, 2048, 128, True, False), (4, 1024, 1024, 128, False, True),
    (4, 256, 2048, 128, True, True), (2, 512, 512, 64, True, True),
    (2, 256, 512, 64, False, False), (1, 128, 128, 128, True, False),
    (1, 64, 128, 64, True, True)])
def test_sufa_bwd_kernel_matches_plain(cuda_device, monkeypatch, d, bh, t,
                                       s, block, causal, edges):
    """K3's backward on the glue's selection against ``sufa.sufa_bwd_ref``
    in fp32: dQ, dK and dV each no further from it than twice the bf16
    plain gradient under the selection's mask is (plus 1e-5); with
    ``edges`` an invalid slot, a key tile of head 0 that no q-tile chose
    (dK = dV = 0 exactly) and a q-tile of head 1 with no valid slot
    (dQ = 0 exactly); one counted launch; three calls bit-equal, one on a
    side stream."""
    from repro_torch.kernels import sufa as ksufa
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke as cs
    gen = torch.Generator(device="cpu").manual_seed(d * 3 + t + s + block)
    q = _bf16((bh, t, d), gen, cuda_device)
    k = _bf16((bh, s, d), gen, cuda_device)
    v, do = _bf16((bh, s, d), gen, cuda_device), _bf16((bh, t, d), gen,
                                                       cuda_device)
    keep = max(1, min(s // block, -(-s // block // 5)))
    if causal:
        idx, valid = _star_selection(q, k, block, keep)
    else:
        idx, valid = _selection(bh, t, s, keep, block, block, gen,
                                cuda_device)
    if edges:
        unchosen = int(idx[0, -1, 0])
        valid[0] &= idx[0] != unchosen
        valid[:, 0, -1] = False
        valid[min(1, bh - 1), -1] = False
    kw = dict(block_q=block, block_kv=block, causal=causal)
    o, lse = ksufa.sufa_attention(q, k, v, idx, valid, return_lse=True,
                                  strict=True, **kw)
    kernels.reset_launches()
    got = ksufa.sufa_bwd(q, k, v, idx, valid, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sufa_bwd"] == 1
    assert kernels.FORM_LAUNCHES["sufa_bwd/noncausal"] == int(not causal)
    again = ksufa.sufa_bwd(q, k, v, idx, valid, o, lse, do, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        third = ksufa.sufa_bwd(q, k, v, idx, valid, o, lse, do, **kw)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert all(torch.equal(a.view(torch.int16), b.view(torch.int16))
               for other in (again, third) for a, b in zip(got, other))
    if edges:
        sl = slice(unchosen * block, (unchosen + 1) * block)
        assert float(got[1][0, sl].abs().max()) == 0.0
        assert float(got[2][0, sl].abs().max()) == 0.0
        assert float(got[0][min(1, bh - 1), t - block:].abs().max()) == 0.0
    f32 = [x.float() for x in (q, k, v)]
    o32, lse32 = ksufa.sufa_reference(*f32, idx, valid, scale=d ** -0.5,
                                      strict=True, return_lse=True, **kw)
    want = ksufa.sufa_bwd_ref(*f32, idx, valid, o32, lse32, do.float(), **kw)
    dense = cs.selection_mask(idx, valid, t=t, s=s, block=block,
                              causal=causal)
    lowp = cs.grads_of(functools.partial(
        cs.plain_masked_lowp, dense=dense, scale=d ** -0.5), q, k, v, do)
    for g, w, p in zip(got, want, lowp):
        err = float((g.float() - w).abs().max())
        assert err <= 2 * float((p.float() - w).abs().max()) + 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["elementwise", "tile16", "tile96"])
def test_sufa_backward_refuses_uncovered_cases(cuda_device, case):
    """Where the card's backward does not reach (the element mask, tiles
    other than 64 and 128) the differentiable K3 raises before it
    launches, and never runs the plain backward on the card."""
    from repro_torch.kernels import sufa as ksufa
    block = {"elementwise": 128, "tile16": 16, "tile96": 96}[case]
    gen = torch.Generator(device="cpu").manual_seed(0)
    q, k, v = (_bf16((2, 384, 64), gen, cuda_device).requires_grad_()
               for _ in range(3))
    idx, valid = _selection(2, 384, 384, 1, block, block, gen, cuda_device)
    kernels.reset_launches()
    with pytest.raises(NotImplementedError, match="item 7"):
        ksufa.sufa_attention(q, k, v, idx, valid, block_q=block,
                             block_kv=block,
                             elementwise=case == "elementwise")
    assert kernels.LAUNCHES["sufa"] == kernels.LAUNCHES["sufa_bwd"] == 0


@pytest.mark.cuda
def test_star_training_step_launches_k3_backward(cuda_device):
    """A loss's backward through ``lm.loss_fn`` with ``star_train`` on the
    card runs K2 and K3 twice per attention layer (forward and recompute
    under ``remat="full"``) and K3's backward once, K4 never; the loss and
    gradients agree with the same step on the CPU's plain path at the
    bf16 bound."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.star_attention import STARConfig
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(
        get_smoke_config("olmo_1b"), n_heads=2, n_kv=2, d_model=128,
        d_ff=256, star_train=True,
        star=STARConfig(top_k_ratio=0.5, block_q=64, block_kv=64))
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (2, 256), generator=gen)
             for k in ("tokens", "labels")}
    kernels.reset_launches()
    (loss, _), grads = steps.value_and_grad(
        _to(params, cuda_device), cfg,
        {k: v.to(cuda_device) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sufa_bwd"] == cfg.n_layers
    assert kernels.LAUNCHES["sufa"] == kernels.LAUNCHES["dlzs_block"] == \
        2 * cfg.n_layers
    assert kernels.LAUNCHES["flash"] == kernels.LAUNCHES["flash_bwd"] == 0
    (loss_cpu, _), grads_cpu = steps.value_and_grad(params, cfg, batch)
    assert abs(float(loss) - float(loss_cpu)) <= 2e-2 * float(loss_cpu)
    for g, w in zip(tree_leaves(grads), tree_leaves(grads_cpu)):
        w = w.float()
        np.testing.assert_allclose(
            g.float().cpu().numpy(), w.numpy(), rtol=2e-2,
            atol=2e-2 * max(1.0, float(w.abs().max())))
