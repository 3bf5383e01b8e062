"""Port parity: the Mixture-of-Experts family (``repro_torch.models.moe``,
the ``moe`` FFN of ``repro_torch.models.lm``, the olmoe_1b_7b and
grok_1_314b configs) against ``repro.models.moe`` and ``repro.models.lm``.

* ``moe.apply`` against the reference's local path (no mesh) for both
  smoke configs' MoE (8 experts as 16 virtual ones, tpw = 2) and a tpw = 1
  config (16 experts), in fp32 and bf16 on the same numpy input: the
  routing plan (``eidx``, ``slot``, ``keep``) exactly, ``y`` and ``aux``
  to 2e-5 in fp32 and 2e-2 in bf16 (scaled by magnitude). Cases: one
  chunk, t = 96 at chunk 64 (two chunks of 48), a prime t (chunks of one
  token), a skewed input that drops choices, dropless capacity, and a
  crafted top-k tie (ties go to the lower expert index, as in
  ``lax.top_k``). The reference's plan is its ``_gate`` and the slot
  arithmetic of its ``_dispatch_combine``, applied per chunk.
* Weights: the reference's ``lm.init`` through ``convert.to_torch``, and
  the port's own ``lm.init`` (same tree; the expert weights' std is
  sqrt(1/V), the reference's fan-in from the virtual-expert axis).
* The whole smoke models in fp32: ``lm.prefill`` and ``lm.forward`` (in
  ``test_torch_configs.py``) and the dense-cache ``lm.decode_step``.
* Served tokens equal the reference's paged engine's at the reference's
  capacity (1.25), fp32, STAR on, with chunked, batched varlen,
  auto-budget and whole-prompt prefill, through the scenarios' runner
  ``engine_core_scenarios._run_llm``; the gate is skewed so that choices
  drop, and the port's run is checked to drop. With drops a token's route
  depends on every row routed with it (padding, idle slots, the other
  requests in a varlen batch), so this holds the batch layout the MoE is
  fed.
* With dropless capacity the port's engines agree with each other (dense
  slot, spatial over 2 shards and a disaggregated pair against the paged
  engine), and the conformance scenarios' parity rule holds against the
  reference's dense oracle.
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

import engine_core_scenarios as scen  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.serving import LLM as JLLM  # noqa: E402
from repro.serving import EngineCfg as JEngineCfg  # noqa: E402
from repro.serving import PagedEngineCfg as JPagedEngineCfg  # noqa: E402
from repro.serving import PagedServingEngine as JPaged  # noqa: E402
from repro.serving import SchedulerCfg as JSchedulerCfg  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.serving import (LLM, DisaggRouter, EngineCfg,  # noqa: E402
                                 PagedEngineCfg, PagedServingEngine,
                                 SchedulerCfg)
from repro_torch.spatial import SpatialEngineCfg  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
ARCHS = ("olmoe_1b_7b", "grok_1_314b")
# the smoke configs' MoE (V = 16, tpw = 2) and a tpw = 1 one (E = 16 >=
# the reference's 16-way expert axis)
MOE_CFGS = {
    "olmoe": get_smoke_config("olmoe_1b_7b").moe,
    "grok": get_smoke_config("grok_1_314b").moe,
    "tpw1": jmoe.MoECfg(d_model=32, d_ff=24, n_experts=16, top_k=4,
                        token_chunk=64),
}
TRUNC_STD = 0.8796256610342398   # std of N(0, 1) truncated to [-2, 2]


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


def _moe(name, dtype, **kw):
    """(jax cfg, jax params, torch cfg, torch params) of one MoE layer."""
    jcfg = dataclasses.replace(MOE_CFGS[name], dtype=getattr(jnp, dtype),
                               **kw)
    jp = jmoe.init(jax.random.PRNGKey(3), jcfg)
    return (jcfg, jp, convert.moe_cfg_from_reference(jcfg),
            convert.to_torch(jax.tree.map(np.asarray, jp)))


def _ref_plan(x, p, cfg):
    """The reference's routing plan of tokens x [t, H] (its
    ``_dispatch_combine`` at ep = 1, per chunk): ``_gate``'s eidx, then
    each flat choice's slot and keep (src/repro/models/moe.py:119-141)."""
    t = x.shape[0]
    chunk = min(cfg.token_chunk, t)
    while t % chunk:
        chunk -= 1
    v = p["w1"].shape[0]
    tpw = v // cfg.n_experts
    kc = cfg.top_k * tpw
    eidx, slot, keep = [], [], []
    for c in range(t // chunk):
        xc = x[c * chunk:(c + 1) * chunk]
        cap = int(chunk * cfg.top_k * tpw * cfg.capacity_factor / v + 1)
        cap = max(8, -(-cap // 8) * 8)
        _, e, _ = jmoe._gate(xc, p["wg"], cfg)
        vflat = (e[..., None] * tpw + jnp.arange(tpw)).reshape(-1)
        onehot = jax.nn.one_hot(vflat, v, dtype=jnp.int32)
        pos = ((jnp.cumsum(onehot, axis=0) - 1) * onehot).sum(axis=-1)
        eidx.append(np.asarray(e))
        keep.append(np.asarray(pos < cap))
        slot.append(np.asarray(jnp.where(pos < cap, pos, cap)))
    return {"eidx": np.stack(eidx), "slot": np.stack(slot),
            "keep": np.stack(keep), "kc": kc}


def _port_plan(x, p, cfg):
    t, h = x.shape
    chunk = tmoe.chunking(t, cfg)
    v = p["w1"].shape[0]
    return tmoe.route(x.reshape(-1, chunk, h), p["wg"], cfg, v,
                      tmoe.capacity(chunk, cfg, v))


def _input(name, t, case, jp, seed=1):
    d = MOE_CFGS[name].d_model
    x = np.random.RandomState(seed).randn(t, d).astype(np.float32)
    if case == "skewed":
        # every token leans towards expert 0: its virtual experts overflow
        wg0 = np.asarray(jp["wg"])[:, 0]
        x += 3.0 * wg0 / np.linalg.norm(wg0)
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case,t", [
    ("one_chunk", 64), ("two_chunks", 96), ("prime", 97), ("skewed", 64),
    ("dropless", 96)])
@pytest.mark.parametrize("name", list(MOE_CFGS))
def test_moe_apply_matches_reference(name, case, t, dtype):
    """Routing exactly, y and aux within tolerance; the skewed case drops
    in the reference and the dropless one (capacity_factor = E / top_k, so
    cap > t) drops nothing."""
    kw = {}
    if case == "dropless":
        cfg = MOE_CFGS[name]
        kw["capacity_factor"] = cfg.n_experts / cfg.top_k
    jcfg, jp, tcfg, tp = _moe(name, dtype, **kw)
    x = _input(name, t, case, jp)
    jx = jnp.asarray(x).astype(jcfg.dtype)
    tx = convert.array_to_torch(np.asarray(jx))
    want_y, want_aux = jmoe.apply(jp, jcfg, jx[None])
    got_y, got_aux = tmoe.apply(tp, tcfg, tx[None])
    assert got_y.dtype == convert.torch_dtype(want_y.dtype)
    _close(got_y, want_y, dtype, "y")
    _close(got_aux, want_aux, dtype, "aux")
    want = _ref_plan(jx, jp, jcfg)
    got = _port_plan(tx, tp, tcfg)
    n_chunks = {"two_chunks": 2, "prime": t, "dropless": 2}.get(case, 1)
    assert got["keep"].shape == (n_chunks, t // n_chunks * want["kc"])
    np.testing.assert_array_equal(got["eidx"].numpy(), want["eidx"])
    np.testing.assert_array_equal(got["slot"].numpy(), want["slot"])
    np.testing.assert_array_equal(got["keep"].numpy(), want["keep"])
    if case == "skewed":
        assert not want["keep"].all()
    if case in ("dropless", "prime"):
        assert want["keep"].all()


def test_chunking_and_capacity():
    """The reference's chunk and capacity arithmetic: t = 96 at chunk 64
    runs two chunks of 48, a prime t chunks of 1, and capacity is rounded
    up to 8, at least 8."""
    cfg = convert.moe_cfg_from_reference(MOE_CFGS["olmoe"])
    assert tmoe.chunking(96, cfg) == 48
    assert tmoe.chunking(97, cfg) == 1
    assert tmoe.chunking(40, cfg) == 40
    assert tmoe.capacity(1, cfg, 16) == 8
    # int(48 * 2 * 2 * 1.25 / 16 + 1) = 16
    assert tmoe.capacity(48, cfg, 16) == 16
    assert tmoe.capacity(64, cfg, 16) == 24     # int(21) -> 24
    assert cfg.virtual(16) == (16, 2)
    assert convert.moe_cfg_from_reference(MOE_CFGS["tpw1"]).virtual(16) \
        == (16, 1)


@pytest.mark.parametrize("name", ["olmoe", "tpw1"])
def test_gate_tie_goes_to_the_lower_expert(name):
    """Three experts with equal, largest gate logits (exact sums: the
    inputs are small integers and eighths), more than top_k of them: the
    lower indices win, in order, as ``lax.top_k`` orders them."""
    jcfg, jp, tcfg, tp = _moe(name, "float32")
    d, e = jcfg.d_model, jcfg.n_experts
    rng = np.random.RandomState(0)
    wg = rng.randint(-4, 5, size=(d, e)).astype(np.float32) / 8
    tied = [1 + 2 * i for i in range(jcfg.top_k + 1)]
    wg[:, tied] = 2.0 * np.abs(wg[:, [0]]) + 0.5
    x = rng.randint(1, 4, size=(16, d)).astype(np.float32)
    jp = dict(jp, wg=jnp.asarray(wg))
    tp = dict(tp, wg=torch.from_numpy(wg))
    want = _ref_plan(jnp.asarray(x), jp, jcfg)
    got = _port_plan(torch.from_numpy(x), tp, tcfg)
    eidx = got["eidx"].numpy()
    np.testing.assert_array_equal(eidx, want["eidx"])
    assert (eidx[..., :jcfg.top_k] == tied[:jcfg.top_k]).all()
    np.testing.assert_array_equal(got["slot"].numpy(), want["slot"])
    want_y, _ = jmoe.apply(jp, jcfg, jnp.asarray(x)[None])
    got_y, _ = tmoe.apply(tp, tcfg, torch.from_numpy(x)[None])
    _close(got_y, want_y, "float32", "y at a tie")


# -- weights -----------------------------------------------------------------

def _paths(tree):
    return [tuple(k.key for k in p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("arch", ARCHS)
def test_weights_match_the_reference_tree(arch):
    """The reference's ``lm.init`` through the converter, bit for bit and
    with the layer axis leading; the port's ``lm.init`` draws the same
    tree (keys, shapes, dtypes), the expert weights with std sqrt(1/V)
    (the reference's fan-in is the virtual-expert axis) and the gate with
    std sqrt(1/d)."""
    jcfg = get_smoke_config(arch)
    jp = jlm.init(jax.random.PRNGKey(0), jcfg)
    tp = convert.to_torch(jax.tree.map(np.asarray, jp))
    want = {tuple(p): np.asarray(leaf)
            for p, leaf in zip(_paths(jp), jax.tree.leaves(jp))}
    conv = dict(tree_items(tp))
    assert set(conv) == set(want)
    for path, leaf in want.items():
        got = convert.tensor_to_numpy(conv[path])
        assert got.dtype == leaf.dtype and got.shape == leaf.shape, path
        np.testing.assert_array_equal(got.view(np.uint8),
                                      leaf.view(np.uint8), err_msg=str(path))
    tcfg = tconfigs.get_smoke_config(arch)
    own = dict(tree_items(tlm.init(tcfg, torch.Generator().manual_seed(0),
                                   "cpu")))
    assert {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in own.items()} == \
        {p: (a.shape, a.dtype.name) for p, a in want.items()}
    v, _ = tcfg.moe.virtual(tmoe.EP_HINT)
    ffn = ("blocks", "b0", "ffn")
    assert own[ffn + ("w1",)].shape[:2] == (jcfg.n_layers, v)
    for name, fan_in in (("w1", v), ("w2", v), ("w3", v),
                         ("wg", jcfg.d_model)):
        w = own[ffn + (name,)].float()
        std = TRUNC_STD / np.sqrt(fan_in)
        assert abs(float(w.std()) / std - 1) < 0.05, name
        assert float(w.abs().max()) <= 2 / np.sqrt(fan_in) + 1e-6, name


# -- the whole model ---------------------------------------------------------

def _fp32(arch, star=True):
    jcfg = get_smoke_config(arch)
    return dataclasses.replace(
        jcfg, dtype=jnp.float32, star=jcfg.star if star else None,
        moe=dataclasses.replace(jcfg.moe, dtype=jnp.float32))


def _models(jcfg, seed=3, skew=1.0):
    """Reference weights and their conversion; ``skew`` scales the gate's
    first two columns so that routing concentrates and choices drop."""
    jp = jlm.init(jax.random.PRNGKey(seed), jcfg)
    if skew != 1.0:
        ffn = jp["blocks"]["b0"]["ffn"]
        wg = np.asarray(ffn["wg"]).copy()
        wg[..., :2] *= skew
        ffn["wg"] = jnp.asarray(wg)
    return (jcfg, jp, convert.model_cfg_from_reference(jcfg),
            convert.to_torch(jax.tree.map(np.asarray, jp)))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches(arch):
    """``lm.prefill(cache_len=)``'s dense cache, then two
    ``lm.decode_step`` ticks (two tokens through the MoE each), against
    the reference's, in fp32."""
    jcfg, jp, tcfg, tp = _models(_fp32(arch))
    toks = np.random.RandomState(6).randint(
        2, jcfg.vocab, size=(2, 32)).astype(np.int32)
    _, jcache = jlm.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                            cache_len=64)
    _, tcache = tlm.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                            cache_len=64)
    nxt = np.array([[7], [11]], np.int32)
    for tick in range(2):
        want, jcache = jlm.decode_step(jp, jcfg, jnp.asarray(nxt), jcache)
        got, tcache = tlm.decode_step(tp, tcfg, torch.from_numpy(nxt),
                                      tcache)
        _close(got, want, "float32", f"tick {tick} logits")
        nxt = np.asarray(jnp.argmax(want[:, :jcfg.vocab], -1)
                         ).astype(np.int32)[:, None]


# -- serving -----------------------------------------------------------------

SCHEDULES = {"sequential": dict(chunk_pages=1),
             "batched": dict(chunk_pages=1, prefill_tokens=48),
             "auto_budget": dict(chunk_pages=1, prefill_tokens="auto"),
             "whole_prompt": dict(chunk_pages=None)}


def _paged_cfg(cls):
    return cls(max_batch=2, page_size=16, n_pages=32, hot_pages=4,
               eos_id=-1)


class _DropTally:
    """Counts the choices ``moe.route`` drops while installed."""

    def __init__(self, monkeypatch):
        self.dropped = self.choices = 0
        real = tmoe.route

        def counted(*args, **kw):
            plan = real(*args, **kw)
            self.dropped += int((~plan["keep"]).sum())
            self.choices += plan["keep"].numel()
            return plan
        monkeypatch.setattr(tmoe, "route", counted)


@pytest.mark.parametrize("sched", list(SCHEDULES))
@pytest.mark.parametrize("arch", ARCHS)
def test_served_tokens_match_reference_paged_engine(arch, sched,
                                                    monkeypatch):
    """At the reference's capacity (1.25), STAR on, fp32, with the gate
    skewed so that choices drop: the port's paged engine gives the JAX
    paged engine's tokens on the mixed-length prompts, and its run
    dropped choices."""
    jcfg, jp, tcfg, tp = _models(_fp32(arch), seed=1, skew=8.0)
    prompts = scen._prompts(jcfg, scen.MIXED_LENGTHS)
    want = scen._run_llm(JLLM(JPaged(jcfg, jp, _paged_cfg(JPagedEngineCfg),
                                     JSchedulerCfg(**SCHEDULES[sched]))),
                         prompts, max_tokens=8)
    tally = _DropTally(monkeypatch)
    got = scen._run_llm(LLM(PagedServingEngine(
        tcfg, tp, _paged_cfg(PagedEngineCfg),
        SchedulerCfg(**SCHEDULES[sched]))), prompts, max_tokens=8)
    assert got == want
    assert tally.dropped > 0


def _dropless(arch):
    jcfg = _fp32(arch, star=False)
    return dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=jcfg.moe.n_experts / jcfg.moe.top_k))


def test_dense_engine_prime_prompt_bounds_the_buffer(monkeypatch):
    """A prime prompt longer than ``token_chunk`` through the dense slot
    engine, which prefills the raw prompt length: its 67 chunks of one
    token (cap 8 each) run in groups whose expert buffers stay within two
    full chunks' slots (6 chunks a group, 12 groups a layer), and the
    tokens equal the JAX ``ServingEngine``'s, in fp32."""
    jcfg, jp, tcfg, tp = _models(_fp32("olmoe_1b_7b", star=False))
    v, _ = tcfg.moe.virtual(tmoe.EP_HINT)
    budget = 2 * tmoe.capacity(tcfg.moe.token_chunk, tcfg.moe, v)
    assert budget == 48
    slots = []
    real = tmoe.expert_ffn

    def ffn(buf, params, cfg):
        slots.append(buf.shape[1])
        return real(buf, params, cfg)
    monkeypatch.setattr(tmoe, "expert_ffn", ffn)
    prompt = scen._prompts(jcfg, (67,))[0]
    want = JLLM(JServingEngine(jcfg, jp, JEngineCfg(max_batch=2, max_len=96,
                                                    eos_id=-1)))
    got = LLM.from_config(tcfg, backend="dense", params=tp, device="cpu",
                          engine_cfg=EngineCfg(max_batch=2, max_len=96,
                                               eos_id=-1))
    for llm in (want, got):
        llm.submit(prompt, max_tokens=4, rid=0)
    assert got.run_until_done() == want.run_until_done()
    assert max(slots) == budget
    prefill = slots[:2 * 12]
    assert prefill == [48] * 11 + [8] + [48] * 11 + [8]


@pytest.fixture(scope="module")
def dropless():
    return _models(_dropless("olmoe_1b_7b"), seed=2)


def test_port_engines_agree_dropless(dropless):
    """Dropless capacity, ``star=None``, fp32: the dense slot engine, the
    spatial engine over 2 shards and a disaggregated pair give the paged
    engine's tokens (nothing drops, so no token depends on its batch)."""
    _, _, tcfg, tp = dropless
    prompts = scen._prompts(tcfg, scen.MIXED_LENGTHS)

    def run(llm):
        return scen._run_llm(llm, prompts, max_tokens=6)
    want = run(LLM(PagedServingEngine(tcfg, tp, _paged_cfg(PagedEngineCfg),
                                      SchedulerCfg(chunk_pages=1,
                                                   prefill_tokens=48))))
    dense = LLM.from_config(tcfg, backend="dense", params=tp, device="cpu",
                            engine_cfg=EngineCfg(max_batch=2, max_len=64,
                                                 eos_id=-1))
    assert run(dense) == want
    spatial = LLM.from_config(tcfg, backend="spatial", params=tp,
                              device="cpu", engine_cfg=SpatialEngineCfg(
                                  n_shards=2, max_batch=2, eos_id=-1))
    assert run(spatial) == want
    pair = DisaggRouter.from_config(
        tcfg, params=tp, device="cpu",
        prefill_engine_cfg=PagedEngineCfg(n_pages=64, eos_id=-1),
        decode_engine_cfg=PagedEngineCfg(n_pages=64, eos_id=-1))
    assert run(pair) == want
    assert pair.transfer.n_transfers == len(prompts)


@pytest.mark.parametrize("scenario", [
    scen.scenario_parity_sequential, scen.scenario_parity_batched,
    scen.scenario_parity_auto_budget], ids=lambda s: s.__name__)
def test_conformance_parity_dropless(dropless, scenario):
    """The conformance scenarios' parity rule on olmoe smoke, dropless:
    the port's paged engine, through the torch factory, gives the
    reference's dense oracle's tokens."""
    jcfg, jp, tcfg, tp = dropless

    def make_llm(*, max_batch, pages, hot, scfg, recent=2):
        return LLM(PagedServingEngine(tcfg, tp, PagedEngineCfg(
            max_batch=max_batch, page_size=16, n_pages=pages,
            hot_pages=hot, recent_pages=recent, eos_id=-1),
            SchedulerCfg(**dataclasses.asdict(scfg))))
    scenario(make_llm, jcfg, jp, scen.BACKEND_PARAMS["paged"])


def test_registry_and_entry_points_serve_moe():
    """Both MoE archs resolve in the port's registry and serve through
    ``LLM.from_config`` on the CPU."""
    assert {"olmoe_1b_7b", "grok_1_314b"} <= set(tconfigs.ARCHS)
    for arch in ARCHS:
        llm = LLM.from_config(tconfigs.get_smoke_config(arch), device="cpu",
                              generator=torch.Generator().manual_seed(3),
                              engine_cfg=PagedEngineCfg(
                                  max_batch=2, n_pages=16, hot_pages=4,
                                  eos_id=-1))
        h = llm.submit(np.arange(20, dtype=np.int32), max_tokens=4)
        assert len(h.result()) == 4
