"""Port parity: the paper's analysis layer in ``repro_torch`` against the
JAX reference on the same inputs.

Covered: the equivalent-add op model (``core/opcount.py``) and the
segment DSE (``core/dse.py``) at the configurations of
``benchmarks/complexity_reduction.py`` and ``fa_overhead.py``; the SLZS
baseline, ``predict_khat`` and the integer DLZS path (``core/dlzs.py``);
the sphere share rho (``sads.sphere_stats``); ``sufa.masked_attention_ref``
and ``selection_to_mask``; ``star_attention_batched``; the exports of
``repro_torch.core``; the hit rate of ``benchmarks/topk_hit.py``; and the
model side of the roofline (``launch/roofline.py``) and the shapes
(``launch/shapes.py``) over every full config.

Tolerances: op counts, DSE tables, parameter counts, model FLOPs, shapes,
masks, selections and LZ codes are equal; attention outputs agree to 2e-5
in fp32. The integer DLZS path differs from the reference only where
XLA's CPU ``log2``/``exp2`` are inexact, and the test lists those
magnitudes.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core as jcore  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import dlzs as jdlzs  # noqa: E402
from repro.core import dse as jdse  # noqa: E402
from repro.core import opcount as jop  # noqa: E402
from repro.core import sads as jsads  # noqa: E402
from repro.core import sufa as jsufa  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.launch import shapes as jshapes  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.core import dlzs as tdlzs  # noqa: E402
from repro_torch.core import dse as tdse  # noqa: E402
from repro_torch.core import opcount as top  # noqa: E402
from repro_torch.core import sads as tsads  # noqa: E402
from repro_torch.core import sufa as tsufa  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch import roofline as troof  # noqa: E402
from repro_torch.launch import shapes as tshapes  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402

jstar = importlib.import_module("repro.core.star_attention")
tstar = importlib.import_module("repro_torch.core.star_attention")

TOL = dict(rtol=2e-5, atol=2e-5)


def _np(t):
    return t.detach().numpy()


def _counts(c):
    return dataclasses.astuple(c) + (c.equivalent_adds,)


# -- the op model and the DSE ---------------------------------------------------

def _measured_rho_scores(s=4096, d=64, rows=128, seed=0):
    """``complexity_reduction._measured_rho``'s scores from numpy: peaked
    keys (the first S/16 scaled by 3), q·kᵀ/√d in fp32."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((s, d), dtype=np.float32)
    k[: s // 16] *= 3.0
    q = rng.standard_normal((rows, d), dtype=np.float32)
    return (q @ k.T) / np.float32(np.sqrt(d))


def test_sphere_stats_equal_on_measured_rho_shape():
    """rho over 4096 keys in 32 segments at radius 5: equal."""
    scores = _measured_rho_scores()
    for n_seg, radius in ((32, 5.0), (16, 2.0), (4, 1e9)):
        j = float(jsads.sphere_stats(jnp.asarray(scores), n_seg, radius))
        t = float(tsads.sphere_stats(torch.from_numpy(scores), n_seg,
                                     radius))
        assert j == t, (n_seg, radius, j, t)
    assert 0.0 < j <= 1.0


def _op_cases():
    """(name, fn name, args, kwargs) at the benchmarks' configurations."""
    rho = float(tsads.sphere_stats(torch.from_numpy(_measured_rho_scores()),
                                   32, 5.0))
    t, s, d, bc = 128, 4096, 64, 128
    cases = [("matmul", "matmul_ops", (3, 5, 7), {}),
             ("shift_matmul", "shift_matmul_ops", (3, 5, 7), {}),
             ("dlzs_khat", "dlzs_khat_ops", (s, 2048, 128), {})]
    # Fig. 18a's ablation (complexity_reduction.run)
    cases += [("fig18a_base_pred", "dense_predict_ops", (t, s, d), {}),
              ("fig18a_base_sort", "full_sort_topk_ops", (t, s, 0.2), {}),
              ("fig18a_base_fa", "fa2_ops", (t, max(bc, int(s * 0.2)), d,
                                             bc), {}),
              ("fig18a_dlzs", "dlzs_predict_ops", (t, s, d), {}),
              ("fig18a_sads", "sads_ops", (t, s, 0.2, s // bc, rho), {}),
              ("fig18a_star", "star_total_ops", (t, s, d),
               dict(block_kv=bc, k_ratio=0.2, n_segments=s // bc, rho=rho,
                    strict=False)),
              ("baseline_ds", "baseline_ds_ops", (t, s, d),
               dict(block_kv=bc, k_ratio=0.2))]
    # Fig. 16 at the loss-matched top-k ratios
    for kr in (0.25, 0.2, 0.15):
        cases += [(f"fig16_dense_k{kr}", "vanilla_attention_ops", (t, s, d),
                   {}),
                  (f"fig16_star_k{kr}", "star_total_ops", (t, s, d),
                   dict(block_kv=bc, k_ratio=kr, n_segments=s // bc,
                        rho=rho, strict=False))]
    # SADS vs the full sort at S 1024 (paper §IV-B)
    cases += [("sads_s1024_full", "full_sort_topk_ops", (1, 1024, 0.25), {}),
              ("sads_s1024", "sads_ops", (1, 1024, 0.25, 4, 0.4), {})]
    # Fig. 5 (fa_overhead.run): Bc 16, S 512..4096
    for s5 in (512, 1024, 2048, 4096):
        cases += [(f"fig5_vanilla_s{s5}", "vanilla_attention_ops",
                   (t, s5, d), {}),
                  (f"fig5_fa2_s{s5}", "fa2_ops", (t, s5, d, 16), {}),
                  (f"fig5_sufa_s{s5}", "sufa_ops", (t, s5, d, 16),
                   dict(keep_ratio=1.0, strict=False))]
    for strict in (False, True):
        cases.append((f"sufa_keep02_strict{strict}", "sufa_ops",
                      (t, 2048, d, 128, 0.2), dict(strict=strict)))
    return cases


def test_opcount_equal_at_benchmark_configurations():
    for name, fn, args, kw in _op_cases():
        j = getattr(jop, fn)(*args, **kw)
        t = getattr(top, fn)(*args, **kw)
        assert _counts(j) == _counts(t), name
    # the arithmetic of OpCount itself
    a, b = jop.OpCount(1, 2, 3, 4, 5), top.OpCount(1, 2, 3, 4, 5)
    assert _counts(a + a.scaled(0.5)) == _counts(b + b.scaled(0.5))
    assert (top.ALPHA, top.BETA, top.GAMMA, top.DELTA, top.EPSILON) == (
        jop.ALPHA, jop.BETA, jop.GAMMA, jop.DELTA, jop.EPSILON)


@pytest.mark.parametrize("seq_len", [1024, 2048, 4096, 8192, 32768])
def test_segment_dse_equal(seq_len):
    assert tdse.PAPER_COEFFS == jdse.PAPER_COEFFS
    kws = [{}, dict(k_ratio=0.1, rho=0.2), dict(strict=True, t=64, d=64),
           dict(candidates=(16, 32, 64, 128), k_ratio=0.25)]
    for kw in kws:
        j = jdse.segment_dse(seq_len, **kw)
        t = tdse.segment_dse(seq_len, **kw)
        assert dataclasses.asdict(j) == dataclasses.asdict(t), kw
    for model in list(jdse.PAPER_COEFFS) + ["unknown"]:
        assert dataclasses.asdict(jdse.dse_for_model(model, seq_len)) == \
            dataclasses.asdict(tdse.dse_for_model(model, seq_len))


def test_segment_dse_refuses_what_the_reference_refuses():
    for mod in (jdse, tdse):
        with pytest.raises(ValueError, match="no feasible segment size"):
            mod.segment_dse(100)


# -- DLZS: the symmetric baseline, K̂ and the integer path ----------------------

def test_slzs_and_predict_khat_match():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 64, 32), dtype=np.float32)
    k = rng.standard_normal((2, 96, 32), dtype=np.float32) * 3
    j = jdlzs.slzs_scores(jnp.asarray(q), jnp.asarray(k), 0.125)
    t = tdlzs.slzs_scores(torch.from_numpy(q), torch.from_numpy(k), 0.125)
    np.testing.assert_allclose(_np(t), np.asarray(j), **TOL)
    x = rng.standard_normal((3, 40, 48), dtype=np.float32)
    wk = np.array(jdlzs.pow2_quantize(jnp.asarray(
        rng.standard_normal((48, 32), dtype=np.float32))))
    j = jdlzs.predict_khat(jnp.asarray(x), jnp.asarray(wk))
    t = tdlzs.predict_khat(torch.from_numpy(x), torch.from_numpy(wk))
    np.testing.assert_allclose(_np(t), np.asarray(j), **TOL)


@pytest.mark.parametrize("w", [4, 8, 12, 16])
def test_int_quantize_equal(w):
    x = np.random.default_rng(w).standard_normal(4096).astype(np.float32)
    x[:16] *= 40
    ji, js = jdlzs.int_quantize(jnp.asarray(x), w)
    ti, ts = tdlzs.int_quantize(torch.from_numpy(x), w)
    np.testing.assert_array_equal(_np(ti), np.asarray(ji))
    assert float(ts) == float(js)


# Where XLA's CPU build is inexact (floor(log2(8192.)) = 12, exp2(13.) =
# 8192.0039): the reference's LZ code is off at magnitude 8192, and its
# value at every magnitude of exponent 13. Reachable from w = 15 on.
LZ_OFF = {8192}
VALUE_OFF = set(range(8192, 16384))


@pytest.mark.parametrize("w", [2, 4, 8, 12, 14, 15, 16])
def test_int_lz_and_value_exact_and_equal_where_the_reference_is(w):
    top_mag = 2 ** (w - 1) - 1
    xi = np.arange(-top_mag, top_mag + 1).astype(np.float32)
    mags = np.abs(xi).astype(np.int64)
    exp = np.array([max(int(m).bit_length() - 1, 0) for m in mags])
    want_lz = np.where(mags == 0, w, (w - 1) - exp).astype(np.int32)
    want_val = np.where(mags == 0, 0.0,
                        np.sign(xi) * 2.0 ** exp).astype(np.float32)
    t_lz = _np(tdlzs.int_lz(torch.from_numpy(xi), w))
    t_val = _np(tdlzs.int_dlzs_value(torch.from_numpy(xi), w))
    np.testing.assert_array_equal(t_lz, want_lz)       # the port: exact
    np.testing.assert_array_equal(t_val, want_val)
    assert t_lz.dtype == np.int32 and t_val.dtype == np.float32
    j_lz = np.asarray(jdlzs.int_lz(jnp.asarray(xi), w))
    j_val = np.asarray(jdlzs.int_dlzs_value(jnp.asarray(xi), w))
    reachable = set(range(top_mag + 1))
    assert set(mags[j_lz != t_lz].tolist()) == LZ_OFF & reachable
    assert set(mags[j_val != t_val].tolist()) == VALUE_OFF & reachable
    if w <= 14:                     # magnitudes below 8192: bit for bit
        np.testing.assert_array_equal(t_lz, j_lz)
        np.testing.assert_array_equal(t_val, j_val)


# -- SU-FA's oracle and masks, the batched STAR form ----------------------------

def _selection(seed, t=64, s=128, block=16, keep=3):
    rng = np.random.default_rng(seed)
    scores = rng.standard_normal((t, s)).astype(np.float32)
    jsel = jsads.sads_select_blocks(jnp.asarray(scores), block, block, keep,
                                    radius=1.5, causal=True)
    tsel = tsads.sads_select_blocks(torch.from_numpy(scores), block, block,
                                    keep, radius=1.5, causal=True)
    np.testing.assert_array_equal(_np(tsel.block_idx),
                                  np.asarray(jsel.block_idx))
    elem = rng.random((t // block, keep, block, block)) < 0.6
    return jsel, tsel, elem


@pytest.mark.parametrize("with_elem", [False, True])
def test_selection_to_mask_and_masked_attention_ref(with_elem):
    t, s, d, block = 64, 128, 32, 16
    jsel, tsel, elem = _selection(3)
    jm = jsufa.selection_to_mask(jsel, t, s, block, block,
                                 jnp.asarray(elem) if with_elem else None)
    tm = tsufa.selection_to_mask(tsel, t, s, block, block,
                                 torch.from_numpy(elem) if with_elem
                                 else None)
    assert tm.dtype == torch.bool and tuple(tm.shape) == (t, s)
    np.testing.assert_array_equal(_np(tm), np.asarray(jm))  # bit for bit
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((n, d), dtype=np.float32)
               for n in (t, s, s))
    jo = jsufa.masked_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jm, scale=d ** -0.5)
    to = tsufa.masked_attention_ref(*map(torch.from_numpy, (q, k, v)), tm,
                                    scale=d ** -0.5)
    np.testing.assert_allclose(_np(to), np.asarray(jo), **TOL)


@pytest.mark.parametrize("scan_q,lead,causal", [
    (False, (3,), True), (False, (2, 2), False), (True, (2, 2), True)])
def test_star_attention_batched_matches(scan_q, lead, causal):
    """Both forms over one and two lead dims (the scan form over 4 query
    chunks)."""
    t, d = 128, 32
    cfg = dict(top_k_ratio=0.25, block_q=16, block_kv=16, radius=5.0,
               chunk_tiles=2)
    rng = np.random.default_rng(len(lead) + 10 * scan_q)
    q, k, v = (rng.standard_normal(lead + (t, d), dtype=np.float32)
               for _ in range(3))
    k[..., : t // 16, :] *= 3.0
    jo = jstar.star_attention_batched(
        *map(jnp.asarray, (q, k, v)), jstar.STARConfig(**cfg),
        causal=causal, scan_q=scan_q)
    to = tstar.star_attention_batched(
        *map(torch.from_numpy, (q, k, v)), tstar.STARConfig(**cfg),
        causal=causal, scan_q=scan_q)
    assert tuple(to.shape) == lead + (t, d)
    np.testing.assert_allclose(_np(to), np.asarray(jo), **TOL)


def test_core_exports_the_reference_names():
    assert sorted(tcore.__all__) == sorted(jcore.__all__)
    for name in tcore.__all__:
        assert callable(getattr(tcore, name)), name
    assert tcore.star_attention is tstar.star_attention


# -- benchmarks/topk_hit.py's hit rate ------------------------------------------

def _hit_rate(select, exact, approx, ratio, n_segments=16):
    """``topk_hit._hit_rate`` over one package's ``sads_select``."""
    s = exact.shape[-1]
    kk = int(ratio * s) // n_segments * n_segments
    idx = np.asarray(select(approx, kk, n_segments))
    hits = 0
    for r in range(exact.shape[0]):
        true_top = set(np.argsort(exact[r])[-kk:].tolist())
        hits += len(true_top & set(idx[r].tolist())) / kk
    return hits / exact.shape[0]


def test_topk_hit_rate_equal_for_dlzs_and_slzs():
    rng = np.random.default_rng(0)
    s, d, rows = 2048, 64, 64
    q = rng.standard_normal((rows, d), dtype=np.float32)
    k = rng.standard_normal((s, d), dtype=np.float32)
    k[: s // 16] *= 3.0
    exact = (q @ k.T) / np.float32(np.sqrt(d))
    scale = 1.0 / np.sqrt(float(d))
    jq, jk, tq, tk = (jnp.asarray(q), jnp.asarray(k), torch.from_numpy(q),
                      torch.from_numpy(k))
    approx = {
        "dlzs": (jdlzs.dlzs_scores(jq, jdlzs.pow2_quantize(jk), scale),
                 tdlzs.dlzs_scores(tq, tdlzs.pow2_quantize(tk), scale)),
        "slzs": (jdlzs.slzs_scores(jq, jk, scale),
                 tdlzs.slzs_scores(tq, tk, scale))}
    # the same estimates into each package's selection: equal rates
    for name, (ja, ta) in approx.items():
        np.testing.assert_allclose(_np(ta), np.asarray(ja), **TOL)
        est = np.array(ja)
        for ratio in (0.05, 0.1, 0.2):
            j = _hit_rate(lambda a, kk, n: jsads.sads_select(
                jnp.asarray(a), kk, n, radius=1e9).indices, exact, est,
                ratio)
            t = _hit_rate(lambda a, kk, n: tsads.sads_select(
                torch.from_numpy(a), kk, n, radius=1e9).indices, exact,
                est, ratio)
            assert j == t, (name, ratio, j, t)
    assert 0.5 < t <= 1.0


# -- the roofline's model side and the shapes -----------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_and_params_specs_equal(arch):
    """(total, active) exactly, and the parameter tree's paths, shapes and
    dtypes, over the full config, with nothing allocated."""
    jcfg, tcfg = jget_config(arch), tget_config(arch)
    assert troof.count_params(tcfg) == jroof.count_params(jcfg)
    want = {tuple(str(p.key) for p in path): (tuple(leaf.shape),
                                             _dtype(leaf))
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                jshapes.params_specs(jcfg))[0]}
    got = {path: (tuple(leaf.shape), _dtype(leaf))
           for path, leaf in tree_items(tshapes.params_specs(tcfg))}
    assert got == want
    assert all(leaf.device.type == "meta"
               for _, leaf in tree_items(tshapes.params_specs(tcfg)))


# the reference's count_params on this box, for the record
REFERENCE_COUNTS = {
    "olmo_1b": (1_073_741_824,) * 2,
    "olmoe_1b_7b": (6_713_051_136, 1_075_906_560),
    "grok_1_314b": (314_878_728_192, 82_950_494_208),
    "jamba_1_5_large_398b": (396_521_479_424, 73_090_309_376),
    "xlstm_125m": (38_989_824,) * 2,
    "seamless_m4t_large_v2": (1_107_546_112,) * 2,
    "chatglm3_6b": (5_710_907_392,) * 2,
    "starcoder2_15b": (15_352_147_968,) * 2,
    "nemotron_4_340b": (331_592_011_776,) * 2,
    "internvl2_26b": (18_723_969_024,) * 2,
    "star_paper": (6_476_271_616,) * 2,
}


def test_count_params_records():
    assert {a: troof.count_params(tget_config(a)) for a in ARCHS} == \
        REFERENCE_COUNTS


def test_meta_device_is_for_shape_trees_only():
    """``lm.init`` alone takes the ``meta`` device (a shape-only tree, as
    above); the entry points' resolver refuses it."""
    with pytest.raises(ValueError, match="unsupported device meta"):
        resolve_device("meta")


def _dtype(spec):
    """'bfloat16', 'int32', ... of a ShapeDtypeStruct or a tensor."""
    if isinstance(spec, torch.Tensor):
        return str(spec.dtype).split(".")[-1]
    return str(jnp.dtype(spec.dtype))


@pytest.mark.parametrize("shape_name", list(jshapes.SHAPES))
def test_shapes_model_flops_and_batch_specs_equal(shape_name):
    js, ts = jshapes.SHAPES[shape_name], tshapes.SHAPES[shape_name]
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    for arch in ARCHS:
        jcfg, tcfg = jget_config(arch), tget_config(arch)
        assert tshapes.is_subquadratic(tcfg) == jshapes.is_subquadratic(jcfg)
        for allow in (False, True):
            assert tshapes.applicability(tcfg, ts, allow) == \
                jshapes.applicability(jcfg, js, allow), (arch, allow)
        assert troof.model_flops(tcfg, ts) == jroof.model_flops(jcfg, js)
        if tshapes.applicability(tcfg, ts) is not None:
            continue
        want = {k: (tuple(v.shape), _dtype(v))
                for k, v in jshapes.batch_specs(jcfg, js).items()}
        got = {k: (tuple(v.shape), _dtype(v))
               for k, v in tshapes.batch_specs(tcfg, ts).items()}
        assert got == want, arch


def test_analyze_terms():
    """The reference's fields from the same FLOPs and bytes; the terms by
    the card's peaks, the collective term 0 on one card."""
    cfg_j, cfg_t = jget_config("olmoe_1b_7b"), tget_config("olmoe_1b_7b")
    shape_j, shape_t = jshapes.SHAPES["train_4k"], tshapes.SHAPES["train_4k"]
    flops, bytes_ = 3.0e16, 2.0e12
    ref = jroof.analyze({"flops": flops, "bytes accessed": bytes_},
                        jroof.CollectiveStats(), 1, cfg_j, shape_j)
    got = troof.analyze(flops, bytes_, cfg_t, shape_t)
    for key in ("flops_per_device", "bytes_per_device", "model_flops",
                "hlo_total_flops", "useful_ratio"):
        assert getattr(got, key) == getattr(ref, key), key
    assert (troof.PEAK_FLOPS, troof.HBM_BW) == (989e12, 3.35e12)
    assert got.compute_s == flops / 989e12
    assert got.memory_s == bytes_ / 3.35e12
    assert got.collective_s == 0.0 and got.collective_bytes == 0.0
    assert got.bottleneck == "compute"
    assert troof.analyze(1.0, 1e9, cfg_t, shape_t).bottleneck == "memory"
