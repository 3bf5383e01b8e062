"""Port parity: the spatial (sequence-sharded) slice below the engine —
``repro_torch.spatial.topology`` / ``sharded_pool``, ``core.mrca``,
``core.dr_attention``, the sharded ``page_attention_mass``,
``quant.quantize_pages_sharded`` and ``attention.apply_decode_spatial`` —
held against the reference in process.

The reference's own spatial tests run shard_map programs on fake XLA
devices in subprocesses; here no JAX mesh is needed. The host-side
objects (topology, pools, MRCA) run the same calls in both packages and
give the same results. The merge and DRAttention are held against the
reference's ``_merge_two_stats`` / ``_local_attn_stats`` +
``_merge_stats`` composed in process, and ``apply_decode_spatial``
against the composition the reference's shard_map computes: JAX
``paged_gather_decode_stats`` on each shard's slab, folded with
``_merge_two_stats``, divided and projected by ``wo``. fp32 at 2e-5.
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
from repro.core import mrca as jmrca  # noqa: E402
from repro.kvcache import paged_attention as jpa  # noqa: E402
from repro.kvcache import quant as jquant  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.spatial.sharded_pool import ShardedPagePools as JPools  # noqa
from repro.spatial.sharded_pool import ShardPoolExhausted as JExhausted
from repro.spatial.topology import ShardTopology as JTopo  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import dr_attention as tdr  # noqa: E402
from repro_torch.core import mrca as tmrca  # noqa: E402
from repro_torch.core import dlzs as tdlzs  # noqa: E402
from repro_torch.kvcache import paged_attention as tpa  # noqa: E402
from repro_torch.kvcache import quant as tquant  # noqa: E402
from repro_torch.models import attention as tattention  # noqa: E402
from repro_torch.spatial import ShardedPagePools as TPools  # noqa: E402
from repro_torch.spatial import ShardPoolExhausted as TExhausted  # noqa
from repro_torch.spatial import ShardTopology as TTopo  # noqa: E402

jdr = importlib.import_module("repro.core.dr_attention")
F32 = dict(rtol=2e-5, atol=2e-5)
NEG_INF = -1e30


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# -- topology, MRCA -----------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4, 6])
def test_topology_striping_matches_reference(n):
    jt, tt = JTopo(n), TTopo(n)
    for pages in range(0, 13):
        assert tt.max_local_count(pages) == jt.max_local_count(pages)
        for s in range(n):
            assert tt.local_count(pages, s) == jt.local_count(pages, s)
    assert [tt.owner(j) for j in range(20)] == \
        [jt.owner(j) for j in range(20)]
    assert tt.exchange_cost(hop_ns=7.0, chunk_bytes=3.0) == \
        jt.exchange_cost(hop_ns=7.0, chunk_bytes=3.0)
    for cls in (JTopo, TTopo):
        with pytest.raises(ValueError):
            cls(0)
    assert tt.make_mesh("cpu") == torch.device("cpu")


def _sends(schedule):
    return [[(x.src, x.dest, x.chunk) for x in step] for step in schedule]


@pytest.mark.parametrize("n", range(2, 9))
def test_mrca_schedules_match_reference(n):
    """The port's copy of MRCA gives the reference's schedules, costs and
    simulation for n = 2..8; the neighbor schedule is mesh-legal and
    beats the naive forced ring (paper §V-B2)."""
    assert _sends(tmrca.mrca_schedule(n)) == _sends(jmrca.mrca_schedule(n))
    assert _sends(tmrca.naive_ring_schedule(n)) == \
        _sends(jmrca.naive_ring_schedule(n))
    for sched in (tmrca.mrca_schedule(n), tmrca.naive_ring_schedule(n)):
        j_sched = [[jmrca.Send(x.src, x.dest, x.chunk) for x in step]
                   for step in sched]
        assert tmrca.schedule_cost(sched, 20.0, 2.0) == \
            jmrca.schedule_cost(j_sched, 20.0, 2.0)
    assert dataclasses.asdict(tmrca.simulate(n)) == \
        dataclasses.asdict(jmrca.simulate(n))
    assert tmrca.ring_equivalent(n) == jmrca.ring_equivalent(n)
    sched = TTopo(n).neighbor_schedule()
    assert all(abs(x.src - x.dest) == 1 for step in sched for x in step)
    cost = TTopo(n).exchange_cost()
    if n >= 3:
        assert cost["mrca"]["latency_ns"] < cost["naive_ring"]["latency_ns"]
    assert TTopo(1).neighbor_schedule() == []


# -- sharded pools: the same calls on both packages' objects ------------------

def _pool_pair(n_shards=2, n_pages_local=8, page=4):
    return (JPools(JTopo(n_shards), n_pages_local, page),
            TPools(TTopo(n_shards), n_pages_local, page))


def _admit_stripes(pools):
    toks = tuple(range(16))                     # 4 full pages
    table, fresh, sharing = pools.admit_chunk(toks, 0, 4)
    return (table, fresh, sharing,
            [pools.pools[s].live_pages() for s in (0, 1)],
            pools.local_pages(table, 0), pools.local_pages(table, 1))


def _prefix_sharing(pools):
    toks = tuple(range(16))
    t1, fresh, _ = pools.admit_chunk(toks, 0, 4)
    pools.register_prompt_pages(toks, t1, fresh)
    t2, fresh2, sharing = pools.admit_chunk(toks, 0, 4)
    held = [pools.held_pages(t1)]
    pools.release(t2)
    held += [pools.held_pages(t1), pools.held_pages(t1, shard=0)]
    return (t1, t2, fresh2, sharing, held,
            [pools.pools[s].stats().shared_hits for s in (0, 1)])


def _extend_exhaustion(pools):
    table, _, _ = pools.admit_chunk(None, 0, 4, sharing=False)
    try:
        pools.extend(4)
        starved = None
    except (JExhausted, TExhausted) as e:
        starved = e.shard
    free = pools.free_pages(1)
    pools.release(table)
    return starved, free, pools.free_pages(0), pools.free_pages(1)


def _rollback(pools):
    table, _, _ = pools.admit_chunk(None, 0, 4, sharing=False)
    pools.pools[1].decref(table[1])
    try:
        pools.admit_chunk(None, 5, 2, sharing=False)
        starved = None
    except (JExhausted, TExhausted) as e:
        starved = e.shard
    return starved, pools.free_pages(1)


def _fits(pools):
    return ([pools.fits(n) for n in range(8)], pools.capacity_pages(),
            pools.reclaimable(0))


def _select_hot(pools):
    table, _, _ = pools.admit_chunk(None, 0, 6, sharing=False)
    scores = np.arange(2 * 8, dtype=np.int32).reshape(2, 8) % 5
    out = []
    for s, w in ((0, 2), (1, 4), (0, 1)):
        for sc in (None, scores):
            ph, lg = pools.select_hot(table, s, w, sc)
            out.append((list(ph), list(lg)))
    for s in (0, 1):
        ph, lg = pools.select_hot_sphere(table, s, 2, scores, radius=1.0)
        out.append((list(ph), list(lg)))
    cow = pools.ensure_owned(table, 2)
    return table, out, cow, pools.stats()["live"]


def _stats(pools):
    toks = tuple(range(16))
    t1, fresh, _ = pools.admit_chunk(toks, 0, 4)
    pools.register_prompt_pages(toks, t1, fresh)
    pools.admit_chunk(toks, 0, 4)
    st = pools.stats()
    st["per_shard"] = [dataclasses.asdict(p) for p in st["per_shard"]]
    return st


@pytest.mark.parametrize("scenario", [
    _admit_stripes, _prefix_sharing, _extend_exhaustion, _rollback, _fits,
    _select_hot, _stats], ids=lambda f: f.__name__.strip("_"))
def test_sharded_pools_match_reference(scenario):
    """Twins of tests/test_spatial.py's pool tests: striping, per-shard
    prefix sharing, extend/exhaustion naming the shard, admit rollback
    naming the starved shard, per-shard ``fits``, hot selection (with and
    without scores, and the sphere rule) — same calls, same results."""
    kw = dict(n_pages_local=3) if scenario in (_extend_exhaustion,
                                               _rollback, _fits) else {}
    jpools, tpools = _pool_pair(**kw)
    want, got = scenario(jpools), scenario(tpools)
    assert repr(got) == repr(want)


# -- the merge, DRAttention ---------------------------------------------------

def _states(n_sh, shape, d, seed, empty=()):
    """Per-shard partial states as a shard computes them; shards in
    ``empty`` hold no row (m = NEG_INF, l = 0, o = 0)."""
    rng = np.random.RandomState(seed)
    m = rng.randn(n_sh, *shape).astype(np.float32) * 3
    l = rng.rand(n_sh, *shape).astype(np.float32) * 5 + 0.5
    o = rng.randn(n_sh, *shape, d).astype(np.float32)
    for s in empty:
        m[s], l[s], o[s] = NEG_INF, 0.0, 0.0
    return m, l, o


@pytest.mark.parametrize("n_sh,empty", [(2, ()), (2, (1,)), (4, (0, 2)),
                                        (4, (0, 1, 2, 3))])
def test_merge_matches_reference(n_sh, empty):
    """``_merge_two_stats`` against the reference's, and ``merge_shards``
    (the stand-in for ``_psum_merge_stats``) against the reference's
    ``dr_attention._merge_stats`` folded over the shards in order,
    empty shards included."""
    m, l, o = _states(n_sh, (3, 5), 8, seed=n_sh + len(empty), empty=empty)
    got2 = tattention._merge_two_stats(*(torch.from_numpy(x[i])
                                         for i in (0,) for x in (m, l, o)),
                                       *(torch.from_numpy(x[1])
                                         for x in (m, l, o)))
    want2 = jattention._merge_two_stats(*(jnp.asarray(x[0])
                                          for x in (m, l, o)),
                                        *(jnp.asarray(x[1])
                                          for x in (m, l, o)))
    for g, w in zip(got2, want2):
        np.testing.assert_allclose(_np(g), _np(w), **F32)
    got = tdr.merge_shards(*map(torch.from_numpy, (m, l, o)))
    want = tuple(jnp.asarray(x[0].reshape(15, *x.shape[3:])
                             if x.ndim > 3 else x[0].reshape(15))
                 for x in (m, l, o))
    for s in range(1, n_sh):
        want = jdr._merge_stats(*want, *(jnp.asarray(
            x[s].reshape(15, *x.shape[3:]) if x.ndim > 3
            else x[s].reshape(15)) for x in (m, l, o)))
    np.testing.assert_allclose(_np(got[0]).reshape(15), _np(want[0]), **F32)
    np.testing.assert_allclose(_np(got[1]).reshape(15), _np(want[1]), **F32)
    np.testing.assert_allclose(_np(got[2]).reshape(15, 8), _np(want[2]),
                               **F32)
    if len(empty) == n_sh:
        assert float(got[1].abs().max()) == 0.0


def _dense_causal(q, k, v, length=None):
    s, d = k.shape
    sc = (q @ k.T) / np.sqrt(d)
    if q.shape[0] == s:
        sc = sc.masked_fill(torch.ones(s, s).triu(1).bool(), NEG_INF)
    if length is not None:
        sc[:, length:] = NEG_INF
    return torch.softmax(sc, dim=-1) @ v


@pytest.mark.parametrize("n_sh", [2, 4])
def test_dr_attention_matches_dense_and_reference(n_sh):
    """Ring-flow attention over 2 and 4 shards equals dense causal
    attention and the reference's ring composed in process
    (``_local_attn_stats`` + ``_merge_stats`` hop by hop); the decode
    merge equals dense attention over the valid prefix."""
    s, d = 32, 16
    rng = np.random.RandomState(n_sh)
    q, k, v = (rng.randn(s, d).astype(np.float32) for _ in range(3))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = tdr.dr_attention(tq, tk, tv, n_shards=n_sh)
    np.testing.assert_allclose(_np(got), _np(_dense_causal(tq, tk, tv)),
                               **F32)
    chunk = s // n_sh
    pos = np.arange(s).reshape(n_sh, chunk)
    want = []
    for c in range(n_sh):                   # Q chunk c visits c, c+1, ...
        state = (jnp.full((chunk,), NEG_INF, jnp.float32),
                 jnp.zeros((chunk,), jnp.float32),
                 jnp.zeros((chunk, d), jnp.float32))
        for t in range(n_sh):
            at = (c + t) % n_sh
            mask = pos[at][None, :] <= pos[c][:, None]
            hop = jdr._local_attn_stats(
                jnp.asarray(q[pos[c]]), jnp.asarray(k[pos[at]]),
                jnp.asarray(v[pos[at]]), scale=d ** -0.5,
                mask=jnp.asarray(mask))
            state = jdr._merge_stats(*state, *hop)
        want.append(state[2] / jnp.maximum(state[1], 1e-30)[:, None])
    np.testing.assert_allclose(_np(got), np.concatenate(
        [_np(w) for w in want]), **F32)
    noncausal = tdr.dr_attention(tq, tk, tv, n_shards=n_sh, causal=False)
    np.testing.assert_allclose(
        _np(noncausal), _np(torch.softmax(tq @ tk.T / d ** 0.5, -1) @ tv),
        **F32)
    for length in (s, 13, 1):
        dec = tdr.distributed_decode_merge(tq[5], tk, tv, n_shards=n_sh,
                                           length=length)
        np.testing.assert_allclose(
            _np(dec), _np(_dense_causal(tq[5:6], tk, tv, length)[0]),
            **F32)


# -- sharded pool slabs for the attention-level parity ------------------------

PAGE = 8
P_LOCAL = 12


def _sharded_pool(n_sh, n_kv, dh, seed):
    """Random fp32 K/V slabs [S, P, page, nkv, dh]."""
    rng = np.random.RandomState(seed)
    shape = (n_sh, P_LOCAL, PAGE, n_kv, dh)
    k = rng.randn(*shape).astype(np.float32)
    v = rng.randn(*shape).astype(np.float32)
    return k, v


def _tables(n_sh, lengths, empty_shard=None, seed=0):
    """Striped block tables [S, B, W] (shard-LOCAL ids, GLOBAL logical),
    the write coordinates of each sequence's next row, on its owner."""
    rng = np.random.RandomState(seed)
    b = len(lengths)
    n_pages = [length // PAGE + 1 for length in lengths]
    w = max(-(-n // n_sh) for n in n_pages)
    phys = np.full((n_sh, b, w), -1, np.int32)
    logical = np.full((n_sh, b, w), -1, np.int32)
    write_page = np.zeros((n_sh, b), np.int32)
    write_off = np.zeros((n_sh, b), np.int32)
    free = [list(rng.permutation(np.arange(1, P_LOCAL)))
            for _ in range(n_sh)]           # distinct pages per sequence
    for i, n in enumerate(n_pages):
        for j in range(n):
            s = j % n_sh
            phys[s, i, j // n_sh] = free[s].pop()
            logical[s, i, j // n_sh] = j
        last = n - 1
        write_page[last % n_sh, i] = phys[last % n_sh, i, last // n_sh]
        write_off[last % n_sh, i] = lengths[i] % PAGE
    if empty_shard is not None:       # nothing hot there this step
        phys[empty_shard] = -1
        logical[empty_shard] = -1
    return dict(phys=phys, logical=logical, write_page=write_page,
                write_off=write_off)


def _attn_params(arch):
    jcfg = dataclasses.replace(get_smoke_config(arch), star=None,
                               dtype=jnp.float32)
    jp = jlm.init(jax.random.PRNGKey(3), jcfg)
    core = jax.tree.map(lambda a: np.asarray(a[0]), jp["blocks"]["b0"]["core"])
    tcfg = convert.model_cfg_from_reference(jcfg)
    return (jcfg.attn_cfg("decode"), jax.tree.map(jnp.asarray, core),
            tcfg.attn_cfg(), convert.to_torch(core))


@pytest.mark.parametrize("arch", ["olmo_1b", "chatglm3_6b"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("n_sh,empty", [(1, None), (2, None), (2, 1),
                                        (4, 3)])
def test_apply_decode_spatial_matches_reference(arch, quant, n_sh, empty):
    """One decode layer over 1, 2 and 4 shards, fp and int8 lanes, with a
    shard whose hot set is empty for every sequence: the port's output
    and pool writes against the reference's shard_map composed in
    process — per-shard ``paged_gather_decode_stats``, folded with
    ``_merge_two_stats``, divided, projected by ``wo``. fp32 at 2e-5."""
    jacfg, jcore, tacfg, tcore = _attn_params(arch)
    n_kv, dh = jacfg.n_kv, jacfg.head_dim
    k, v = _sharded_pool(n_sh, n_kv, dh, seed=n_sh)
    lengths = np.array([37, 16, 5], np.int32)
    st = _tables(n_sh, lengths, empty_shard=empty, seed=n_sh)
    rng = np.random.RandomState(7)
    x = rng.randn(3, 1, jacfg.d_model).astype(np.float32)
    qmask = rng.rand(*st["phys"].shape) < 0.5

    # the reference, shard by shard
    q, k_new, v_new = jattention._project_qkv(
        jcore, jacfg, jnp.asarray(x), jnp.asarray(lengths)[:, None])
    scale = 1.0 / np.sqrt(dh)
    state = None
    for s in range(n_sh):
        ks = jnp.asarray(k[s]).at[st["write_page"][s], st["write_off"][s]
                                  ].set(k_new[:, 0])
        vs = jnp.asarray(v[s]).at[st["write_page"][s], st["write_off"][s]
                                  ].set(v_new[:, 0])
        jq = None
        if quant:
            kq, kscale = jquant.quantize_rows(ks)
            vq, vscale = jquant.quantize_rows(vs)
            jq = {"kq": kq, "vq": vq, "k_scale": kscale, "v_scale": vscale,
                  "qmask": jnp.asarray(qmask[s])}
        part = jpa.paged_gather_decode_stats(
            q[:, 0], ks, vs, jnp.asarray(st["phys"][s]),
            jnp.asarray(st["logical"][s]), jnp.asarray(lengths + 1),
            n_kv=n_kv, scale=scale, quant=jq)
        state = part if state is None else \
            jattention._merge_two_stats(*state, *part)
    o = state[2] / jnp.maximum(state[1], 1e-30)[..., None]
    want = jnp.einsum("bnd,ndh->bh", o.reshape(3, jacfg.n_heads, dh),
                      jcore["wo"])[:, None, :]

    # the port: every shard at once, one stats call
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    cache = {"k": tk, "v": tv, "k_lz": tdlzs.lz_pack(tk)}
    ps = {name: torch.from_numpy(a) for name, a in st.items()}
    if quant:
        # the tier of the pages as they will stand after the row write,
        # as the reference quantizes them above
        tk2, tv2 = tk.clone(), tv.clone()
        at = (torch.arange(n_sh)[:, None].expand(n_sh, 3),
              ps["write_page"].long(), ps["write_off"].long())
        _, tkn, tvn = tattention._project_qkv(
            tcore, tacfg, torch.from_numpy(x),
            torch.from_numpy(lengths)[:, None])
        tk2[at], tv2[at] = tkn[:, 0], tvn[:, 0]
        cache["kq"], cache["k_scale"] = tquant.quantize_rows(tk2)
        cache["vq"], cache["v_scale"] = tquant.quantize_rows(tv2)
        ps["qmask"] = torch.from_numpy(qmask)
    got, out_cache = tattention.apply_decode_spatial(
        tcore, tacfg, torch.from_numpy(x), cache,
        torch.from_numpy(lengths), ps)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    assert out_cache["k"] is tk                   # written in place
    for i in range(3):
        s = int(np.nonzero(st["write_page"][:, i])[0][0]) \
            if st["write_page"][:, i].any() else 0
        row = tk[s, st["write_page"][s, i], st["write_off"][s, i]]
        np.testing.assert_allclose(_np(row), _np(k_new[i, 0]), **F32)
    np.testing.assert_array_equal(out_cache["k_lz"].numpy(),
                                  tdlzs.lz_pack(tk).numpy())


@pytest.mark.parametrize("n_sh", [2, 4])
def test_sharded_page_attention_mass_matches_one_pool(n_sh):
    """The audit probe's sharded form: each shard's masses, side by side,
    equal the reference's one-pool masses over the same pages, and each
    sequence's masses sum to 1 across the shards."""
    k, _ = _sharded_pool(n_sh, 2, 8, seed=5)
    lengths = np.array([40, 9], np.int32)
    st = _tables(n_sh, lengths, seed=4)
    q = np.random.RandomState(2).randn(2, 4, 8).astype(np.float32)
    got = tpa.page_attention_mass(
        torch.from_numpy(q), torch.from_numpy(k),
        torch.from_numpy(st["phys"]), torch.from_numpy(st["logical"]),
        torch.from_numpy(lengths + 1), n_kv=2, sharded=True)   # [S, B, W]
    one_phys = np.concatenate(
        [np.where(st["phys"][s] >= 0, st["phys"][s] + s * P_LOCAL, -1)
         for s in range(n_sh)], axis=1)
    one_logical = np.concatenate(list(st["logical"]), axis=1)
    want = jpa.page_attention_mass(
        jnp.asarray(q), jnp.asarray(k.reshape(n_sh * P_LOCAL, PAGE, 2, 8)),
        jnp.asarray(one_phys), jnp.asarray(one_logical),
        jnp.asarray(lengths + 1), n_kv=2)                      # [B, S·W]
    np.testing.assert_allclose(
        np.concatenate([_np(got[s]) for s in range(n_sh)], axis=1),
        _np(want), **F32)
    np.testing.assert_allclose(_np(got).sum(axis=(0, 2)), 1.0, rtol=1e-6)


@pytest.mark.parametrize("n_sh", [2, 4])
def test_quantize_pages_sharded_matches_reference(n_sh):
    """``quantize_pages_sharded`` gives the reference's codes and scales
    bit for bit (its slabs [S, L, P, ...], the port's [L, S, P, ...]),
    and leaves every other page's tier untouched."""
    rng = np.random.RandomState(n_sh)
    shape = (n_sh, 2, P_LOCAL, PAGE, 2, 8)
    k = (rng.randn(*shape) * 3).astype(np.float32)
    v = rng.randn(*shape).astype(np.float32)
    jlayers = jquant.add_quant_slabs(
        {"b0": {"attn": {"k": jnp.asarray(k), "v": jnp.asarray(v)}}})
    phys = np.stack([rng.permutation(np.arange(1, P_LOCAL))[:3]
                     for _ in range(n_sh)]).astype(np.int32)
    phys[-1, -1] = 0                                # the scratch pad
    want = jquant.quantize_pages_sharded(jlayers, jnp.asarray(phys))
    tlayers = tquant.add_quant_slabs(
        {"b0": {"attn": {"k": torch.from_numpy(k.swapaxes(0, 1).copy()),
                         "v": torch.from_numpy(v.swapaxes(0, 1).copy())}}})
    got = tquant.quantize_pages_sharded(tlayers, torch.from_numpy(phys))
    for name in ("kq", "vq", "k_scale", "v_scale"):
        w = np.asarray(want["b0"]["attn"][name]).swapaxes(0, 1)
        np.testing.assert_array_equal(got["b0"]["attn"][name].numpy(), w,
                                      err_msg=name)
    untouched = np.ones((n_sh, P_LOCAL), bool)
    for s in range(n_sh):
        untouched[s, phys[s]] = False
    assert float(got["b0"]["attn"]["k_scale"][:, untouched].abs().max()) \
        == 0.0


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_stats_form_wrapper_matches_reference_on_cpu(quant):
    """K1's stats-form wrapper on CPU tensors runs its plain version (no
    launch counted): every shard's (m, l, o) equals JAX
    ``paged_gather_decode_stats`` on that shard's slab, an empty shard
    gives the neutral state. fp32 at 2e-5."""
    from repro_torch import kernels
    from repro_torch.kernels import paged as kpaged
    n_sh, n_kv, r, dh = 3, 2, 2, 8
    k, v = _sharded_pool(n_sh, n_kv, dh, seed=9)
    lengths = np.array([60, 23, 1], np.int32)
    st = _tables(n_sh, lengths, empty_shard=2, seed=3)
    rng = np.random.RandomState(4)
    q = rng.randn(3, n_kv, r, dh).astype(np.float32)
    qmask = rng.rand(*st["phys"].shape) < 0.5
    tq = torch.from_numpy(k), torch.from_numpy(v)
    tier = jt = None
    if quant:
        kq, ks = tquant.quantize_rows(tq[0])
        vq, vs = tquant.quantize_rows(tq[1])
        tier = {"kq": kq, "vq": vq, "k_scale": ks, "v_scale": vs,
                "qmask": torch.from_numpy(qmask)}
    before = dict(kernels.LAUNCHES)
    got = kpaged.paged_decode_stats_attention(
        torch.from_numpy(q), *tq, torch.from_numpy(st["phys"]),
        torch.from_numpy(st["logical"]), torch.from_numpy(lengths),
        scale=dh ** -0.5, quant=tier)
    assert kernels.LAUNCHES == before
    for s in range(n_sh):
        if quant:
            jt = {name: jnp.asarray(tier[name][s].numpy())
                  for name in ("kq", "vq", "k_scale", "v_scale")}
            jt["qmask"] = jnp.asarray(qmask[s])
        want = jpa.paged_gather_decode_stats(
            jnp.asarray(q.reshape(3, n_kv * r, dh)), jnp.asarray(k[s]),
            jnp.asarray(v[s]), jnp.asarray(st["phys"][s]),
            jnp.asarray(st["logical"][s]), jnp.asarray(lengths),
            n_kv=n_kv, scale=dh ** -0.5, quant=jt)
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g[s]), _np(w), **F32)
    assert float(got[1][2].abs().max()) == 0.0
    assert bool((got[0][2] == NEG_INF).all())
