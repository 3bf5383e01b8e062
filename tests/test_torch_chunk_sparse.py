"""The chunk-sparse page sphere of the port's chunk prefills
(``AttentionCfg.chunk_sparse``, ``ModelCfg.star_chunk_sparse``): a later
prefill chunk drops a whole past page when its best DLZS estimate lies
more than ``radius`` below the best of the query row's own pages, per
(sequence, KV head, query head, query) row.

Held two ways, on the per-sequence (``apply_prefill_chunk``) and the
batched varlen (``apply_prefill_chunk_batch``) forms:

* the criteria of the reference's
  ``tests/test_kvcache.py::test_star_chunk_sparse_prefill_within_tolerance``
  on its layout (three pages of tiny keys, one dominant page): an
  unbounded sphere keeps every page and equals the dense chunk path; the
  real radius drops pages, so the output differs from dense, but by at
  most 0.02;
* a per-row mass bound: with the past values one-hot per page and the
  output projection the identity, the attention output of each row is
  its softmax mass on each past page, so the dense run measures every
  row's mass per page and the sparse run shows which pages the row
  dropped. No row may lose more than e^-radius of its dense mass for
  each key it drops: the sphere keeps a page within ``radius`` of the
  row's best estimate, so a dropped key weighs about e^-radius of the
  row's largest term or less. (The estimates are DLZS's, not the
  scores: on the second seed a row drops three pages carrying 2.8e-6 of
  its mass, above e^-radius = 8.3e-7 for the row as a whole, and far
  below the 24 dropped keys' 2.0e-5.)

A sphere taken over the whole chunk fails both: rows whose own best
estimate sits far below the chunk's lose the pages that carry most of
their mass.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import dlzs  # noqa: E402
from repro_torch.core.star_attention import STARConfig  # noqa: E402
from repro_torch.models import attention  # noqa: E402

NKV, NH, DH, PAGE, C = 2, 4, 16, 8, 8
H = NH * DH
RADIUS = 14.0
ACFG = attention.AttentionCfg(
    d_model=H, n_heads=NH, n_kv=NKV, head_dim=DH,
    star=STARConfig(block_q=8, block_kv=8, radius=RADIUS),
    chunk_sparse=True, dtype=torch.float32)
# per-sequence form: one sequence over pages 1, 2, 4 (dominant), 3
SEQ_PHYS = [1, 2, 4, 3]
# batched form: lane 0 as above, lane 1 a chunk over pages 0 and 5
LANE_PHYS = ([1, 2, 4, 3], [0, 5])
ARENA = [p for phys in LANE_PHYS for p in phys]


def _dense(acfg):
    return dataclasses.replace(acfg, star=None, chunk_sparse=False)


def _keep_all(acfg):
    return dataclasses.replace(acfg, star=dataclasses.replace(
        acfg.star, radius=1e9))


def _params(seed, mass: bool):
    p = attention.init(torch.Generator().manual_seed(seed), ACFG, "cpu")
    if mass:
        # chunk values 0, output projection the identity: the output
        # holds each row's attention-weighted past values
        p["wv"] = torch.zeros_like(p["wv"])
        p["wo"] = torch.eye(H).reshape(NH, DH, H)
    return p


def _cache(seed, mass: bool):
    """Six pool pages: tiny keys, page 4 dominant (the reference test's
    layout). With ``mass`` the values of page ``ARENA[j]`` are e_j."""
    rng = np.random.RandomState(seed)
    kp = rng.randn(6, PAGE, NKV, DH) * 0.01
    kp[4] = rng.randn(PAGE, NKV, DH) * 20.0
    vp = rng.randn(6, PAGE, NKV, DH)
    if mass:
        vp = np.zeros_like(vp)
        for slot, phys in enumerate(ARENA):
            vp[phys, :, :, slot] = 1.0
    k = torch.tensor(kp, dtype=torch.float32)
    return {"k": k, "v": torch.tensor(vp, dtype=torch.float32),
            "k_lz": dlzs.lz_pack(k)}


def _x(seed, tokens):
    rng = np.random.RandomState(seed)
    return torch.tensor(rng.randn(1, tokens, H), dtype=torch.float32)


def _run(form, params, acfg, cache, seed):
    """The form's output [rows, NH, DH] (rows: the chunk's queries, lane
    0's then lane 1's in the batched form)."""
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    if form == "chunk":
        wp = len(SEQ_PHYS)
        x = _x(seed, C)
        pos = (wp * PAGE + torch.arange(C))[None]
        y, _ = attention.apply_prefill_chunk(
            params, acfg, x, pos, cache, i32([SEQ_PHYS]),
            i32([list(range(wp))]), i32([wp * PAGE]))
        return y[0].reshape(C, NH, DH)
    x = _x(seed, 2 * C)
    past_len = [len(phys) * PAGE for phys in LANE_PHYS]
    pos = torch.cat([n + torch.arange(C) for n in past_len])
    seg = torch.cat([torch.full((C,), lane) for lane in range(2)])
    state = {"seg_ids": seg.int(), "past_phys": i32(ARENA),
             "past_lane": i32([lane for lane, phys in enumerate(LANE_PHYS)
                               for _ in phys]),
             "past_logical": i32([j for phys in LANE_PHYS
                                  for j in range(len(phys))]),
             "past_len": i32(past_len)}
    y, _ = attention.apply_prefill_chunk_batch(
        params, acfg, x, pos[None].int(), cache, state)
    return y[0].reshape(2 * C, NH, DH)


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("form", ["chunk", "batch"])
def test_chunk_sparse_within_tolerance_of_dense(form, seed):
    """The reference test's criteria: all pages kept equals dense; the
    real radius differs from dense but lies within 0.02 of it. (On seed 1
    a whole-chunk sphere moves the output only 0.0048, inside 0.02: the
    dropped pages carry 0.0069 of a row's mass, which the per-row bound
    below catches; seeds 0 and 5 move it 0.37 and 0.50.)"""
    params, cache = _params(seed, False), _cache(seed, False)
    run = lambda a: _run(form, params, a, cache, seed)  # noqa: E731
    dense = run(_dense(ACFG))
    np.testing.assert_allclose(run(_keep_all(ACFG)).numpy(), dense.numpy(),
                               rtol=1e-5, atol=1e-5)
    sparse = run(ACFG)
    assert float((sparse - dense).abs().max()) > 1e-7
    np.testing.assert_allclose(sparse.numpy(), dense.numpy(), atol=0.02)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("form", ["chunk", "batch"])
def test_chunk_sparse_row_loses_at_most_e_minus_radius(form, seed):
    """Each (query, head) row's dense softmax mass on the pages its
    sparse run drops is at most e^-radius per dropped key; some row
    drops a page."""
    params, cache = _params(seed, True), _cache(seed, True)
    n_slots = len(SEQ_PHYS) if form == "chunk" else len(ARENA)
    dense = _run(form, params, _dense(ACFG), cache, seed)[..., :n_slots]
    sparse = _run(form, params, ACFG, cache, seed)[..., :n_slots]
    assert float(dense.sum(dim=-1).max()) <= 1 + 1e-5
    # a page the row reads in the dense run but not in the sparse one
    # (another lane's pages weigh 0 in both)
    dropped = (sparse == 0) & (dense != 0)
    assert bool(dropped.any())
    lost = (dense * dropped).sum(dim=-1)
    bound = dropped.sum(dim=-1) * PAGE * math.exp(-RADIUS)
    worst = int((lost - bound).argmax())
    assert bool((lost <= bound).all()), \
        f"a row loses {float(lost.flatten()[worst])} of its mass, over " \
        f"{float(bound.flatten()[worst])}"
    if form == "batch":
        # a row never attends to another lane's pages
        assert float(dense[:C, :, len(LANE_PHYS[0]):].abs().max()) == 0
        assert float(dense[C:, :, :len(LANE_PHYS[0])].abs().max()) == 0
