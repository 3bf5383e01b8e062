"""Port parity: prefill/decode disaggregation (``repro_torch.serving.
disagg``, ``kvcache.wire``, ``serving.faults``) held against the reference.

Twins of ``tests/test_disagg.py`` with torch factories and the reference's
weights through the converter: the wire contract, export/adopt round trips
(fp and int8 tiers), the router's parity with one instance
(``disagg_scenarios.scenario_disagg_parity``), observability, host
staging, COW-shared prefixes, chaos at the ``transfer`` seam
(``scenario_disagg_chaos``), quarantine, cancel/deadline and
``from_config``. The scenario functions import ``FaultPlan`` from
``repro.serving`` inside their bodies; the tests point that name at the
port's class for their duration (``monkeypatch``), so the scenarios run
unedited.

Across the packages: a payload exported mid-decode by one package's paged
engine is adopted by the other's, in both directions and both tiers, and
the adopting package serves the rest token for token as an undisturbed
run of its own. The spatial prefill instance is held in
test_torch_spatial_engine.py.
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

import disagg_scenarios as dscen  # noqa: E402
import engine_core_scenarios as scen  # noqa: E402
import repro.serving as jserving  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.kvcache import quant as tquant  # noqa: E402
from repro_torch.kvcache.wire import (describe, payload_bytes,  # noqa: E402
                                      validate_payload)
from repro_torch.serving import (LLM, DisaggRouter, FaultPlan,  # noqa: E402
                                 FaultyBackend, PagedEngineCfg,
                                 PagedServingEngine, Request, SchedulerCfg)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402


def _convert(jcfg, seed):
    jparams = jlm.init(jax.random.PRNGKey(seed), jcfg)
    tparams = convert.to_torch(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, convert.model_cfg_from_reference(jcfg), tparams


@pytest.fixture(scope="module")
def smoke_lm():
    """The reference's disagg setting (olmo smoke, ``star=None``, bf16)
    and its weights in both packages."""
    return _convert(dataclasses.replace(get_smoke_config("olmo_1b"),
                                        star=None), 1)


@pytest.fixture
def port_faults(monkeypatch):
    """The scenario functions' ``from repro.serving import FaultPlan`` (and
    ``FaultyBackend``) resolve to the port's classes."""
    monkeypatch.setattr(jserving, "FaultPlan", FaultPlan)
    monkeypatch.setattr(jserving, "FaultyBackend", FaultyBackend)


def _paged(tcfg, tparams, *, max_batch=2, pages=32, hot=4, scfg=None):
    return PagedServingEngine(
        tcfg, tparams,
        PagedEngineCfg(max_batch=max_batch, page_size=16, n_pages=pages,
                       hot_pages=hot, eos_id=-1),
        scfg or SchedulerCfg(chunk_pages=1))


def _jpaged(jcfg, jparams, *, scfg):
    return jserving.PagedServingEngine(
        jcfg, jparams,
        jserving.PagedEngineCfg(max_batch=2, page_size=16, n_pages=32,
                                hot_pages=4, eos_id=-1), scfg)


def _router_factory(tcfg, tparams):
    def make_router(*, fault_plan=None, staging="device",
                    transfer_retries=2, tel=None, decode_scfg=None):
        pre = _paged(tcfg, tparams, max_batch=2, pages=32,
                     scfg=SchedulerCfg(**PREFILL_SCFG))
        dec = _paged(tcfg, tparams, max_batch=4, pages=64,
                     scfg=decode_scfg or SchedulerCfg(chunk_pages=1))
        return DisaggRouter(pre, dec, telemetry=tel,
                            fault_plan=fault_plan, staging=staging,
                            transfer_retries=transfer_retries)
    return make_router


PREFILL_SCFG = dict(chunk_pages=1, prefill_tokens=48)


def _single_factory(tcfg, tparams):
    """The parity reference: the router's decode instance's shapes, with
    its prefill instance's prefill form (the batched varlen prefill). In
    bf16 the port's batched and per-chunk prefills give K/V rows a
    rounding step apart (ROADMAP §3), so only a single instance that
    prefills as the pair does isolates the hop."""
    return lambda: LLM(_paged(tcfg, tparams, max_batch=4, pages=64,
                              scfg=SchedulerCfg(**PREFILL_SCFG)))


def _drain(engine, max_steps=500):
    for _ in range(max_steps):
        engine.step()
        if not (engine.queue or engine.active):
            return
    raise AssertionError("engine never drained")


# ------------------------------------------------------------- wire format

def _fake_payload(n_park=2, n_kept=0, kind="decode", page=4):
    rows = {"k": np.zeros((2, n_park, page, 1, 3), np.float32),
            "scale": np.zeros((2, n_park), np.float32)} \
        if n_park else None
    p = {"rows": rows, "park": list(range(n_park)),
         "kept": [(n_park + i, 7 + i) for i in range(n_kept)],
         "n_pages": n_park + n_kept, "lookup_toks": None, "kind": kind}
    if kind == "decode":
        p.update(length=9, last_token=3, budget=5)
    else:
        p.update(prompt=np.arange(9), toks=np.arange(9), spans=[],
                 chunk=0, sharing=None, suppress_first=False)
    return p


def test_wire_validate_contract():
    validate_payload(_fake_payload(), page_size=4)
    validate_payload(_fake_payload(kind="prefill"), page_size=4)
    validate_payload(_fake_payload(n_kept=1), page_size=4)

    with pytest.raises(ValueError, match="missing keys"):
        p = _fake_payload()
        del p["n_pages"]
        validate_payload(p)
    with pytest.raises(ValueError, match="missing keys"):
        p = _fake_payload()
        del p["budget"]
        validate_payload(p)
    with pytest.raises(ValueError, match="kind"):
        validate_payload(_fake_payload(kind="weird"))
    with pytest.raises(ValueError, match="covers"):
        p = _fake_payload()
        p["n_pages"] = 3
        validate_payload(p)
    with pytest.raises(ValueError, match="overlap"):
        p = _fake_payload(n_park=2)
        p["kept"] = [(1, 7)]
        p["n_pages"] = 2
        validate_payload(p)
    with pytest.raises(ValueError, match="page axis"):
        p = _fake_payload()
        p["park"] = [0]
        p["n_pages"] = 1
        validate_payload(p)
    with pytest.raises(ValueError, match="page width"):
        validate_payload(_fake_payload(page=5), page_size=4)
    with pytest.raises(ValueError, match="scores"):
        p = _fake_payload()
        p["scores"] = [1.0]
        validate_payload(p)
    with pytest.raises(ValueError, match="do not travel"):
        validate_payload(_fake_payload(n_kept=1), transfer=True)
    assert payload_bytes(_fake_payload()) == 2 * 2 * 4 * 3 * 4 + 2 * 2 * 4
    assert payload_bytes({"rows": None}) == 0
    assert describe(_fake_payload(n_kept=1)) == {
        "kind": "decode", "n_pages": 3, "parked": 2, "kept": 1,
        "bytes": payload_bytes(_fake_payload()), "scored": False}


# --------------------------------------------------- export/adopt round-trip

def _tier_scfg(cls, tier):
    return cls(chunk_pages=1,
               decode_hot_width=2 if tier == "int8" else None,
               kv_quant="int8" if tier == "int8" else None)


PROMPT = (np.arange(40, dtype=np.int32) * 3)


@pytest.mark.parametrize("tier", ["fp", "int8"])
def test_wire_roundtrip(smoke_lm, tier):
    """Export mid-decode, validate the payload, adopt on a fresh instance:
    the resumed run is token-exact with an undisturbed one of the same
    config; the int8 tier's parked scales restore the quant flags."""
    _, _, tcfg, tparams = smoke_lm
    prompt = PROMPT % tcfg.vocab
    ref = LLM(_paged(tcfg, tparams, scfg=_tier_scfg(SchedulerCfg, tier)))
    want = ref.submit(prompt, max_tokens=16, rid=0).result()

    src = LLM(_paged(tcfg, tparams, scfg=_tier_scfg(SchedulerCfg, tier)))
    h = src.submit(prompt, max_tokens=16, rid=0)
    while len(h.tokens) < 4:
        src.tick()
    req, payload = src.engine.export_request(0)
    validate_payload(payload, page_size=16, transfer=True)
    assert payload["kind"] == "decode" and payload["kept"] == []
    assert len(payload["scores"]) == len(payload["park"])
    assert payload["register_prefix"] is True
    assert all(isinstance(x, np.ndarray) for x in tree_leaves(
        payload["rows"]))
    scale = tquant.find_scale(payload["rows"])
    if tier == "int8":
        assert scale is not None and float(np.max(scale)) > 0.0, \
            "int8 payload lost its parked scales"
    else:
        assert scale is None
    assert src.engine.stats()["pool"].live == 0
    assert not src.engine.active and not src.engine.queue

    dst = _paged(tcfg, tparams, scfg=_tier_scfg(SchedulerCfg, tier))
    dst.adopt(req, payload)
    if tier == "int8":
        restored = []
        real = dst.backend._restore_quant_flags
        dst.backend._restore_quant_flags = lambda rows, ups: (
            real(rows, ups), restored.append(dst.pool.quant.count()))
    _drain(dst)
    assert req.out == want, f"round-trip lost parity:\n{req.out}\n{want}"
    if tier == "int8":
        assert restored and restored[0] > 0, "quant flags not restored"
    assert dst.stats()["pool"].live == 0


def test_adopt_recompute_replay():
    """Adopt with no payload replays prompt + emitted tokens through
    chunked prefill: exact under greedy decode. In fp32: in bf16 the
    replay's chunked prefill rounds apart from incremental decode (the
    reference's own bf16 twin in tests/test_disagg.py parts at token 9, no
    1-step tie), while in fp32 the two compute the same function."""
    _, _, tcfg, tparams = _convert(dataclasses.replace(
        get_smoke_config("olmo_1b"), star=None, dtype=jnp.float32), 1)
    prompt = np.arange(24, dtype=np.int32) % tcfg.vocab
    want = LLM(_paged(tcfg, tparams)).submit(prompt, max_tokens=10,
                                             rid=0).result()
    src = LLM(_paged(tcfg, tparams))
    h = src.submit(prompt, max_tokens=10, rid=0)
    while len(h.tokens) < 3:
        src.tick()
    req, _payload = src.engine.export_request(0)
    emitted = list(req.out)
    dst = _paged(tcfg, tparams)
    dst.adopt(req)                           # payload lost: recompute
    _drain(dst)
    assert req.out[:len(emitted)] == emitted, "replay rewrote history"
    assert req.out == want


# -------------------------------------------------- across the two packages

def _jax_wire(payload):
    """The port's wire rows for the reference: bf16 travels as int16 bits
    in the port (numpy has no bfloat16), as ml_dtypes bfloat16 in JAX."""
    bf16 = np.dtype(jnp.bfloat16)
    return dict(payload, rows=tree_map(
        lambda x: x.view(bf16) if x.dtype == np.int16 else x,
        payload["rows"]))


def _as(cls, req):
    return cls(**{f.name: getattr(req, f.name)
                  for f in dataclasses.fields(req)})


@pytest.fixture(scope="module")
def smoke_lm_f32():
    return _convert(dataclasses.replace(get_smoke_config("olmo_1b"),
                                        star=None, dtype=jnp.float32), 1)


@pytest.mark.parametrize("tier", ["fp", "int8"])
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_wire_roundtrip_across_packages(smoke_lm_f32, direction, tier):
    """A payload exported mid-decode by one package's paged engine is
    adopted by the other's: the adopting package's tokens equal an
    undisturbed run of its own, and the int8 tier's scales restore its
    quant flags. In fp32: in bf16 the two packages' K/V rows after the
    same prefill and decode differ by a rounding step in about a third of
    their elements (their matmuls sum in other orders, ROADMAP §3), so the
    adopting package continues from rows a step away from its own, and a
    greedy argmax near a tie may part (one direction did, at the first
    token after the hop)."""
    jcfg, jparams, tcfg, tparams = smoke_lm_f32
    prompt = PROMPT % tcfg.vocab
    jscfg, tscfg = (_tier_scfg(jserving.SchedulerCfg, tier),
                    _tier_scfg(SchedulerCfg, tier))
    if direction == "jax_to_torch":
        src = jserving.LLM(_jpaged(jcfg, jparams, scfg=jscfg))
        dst = _paged(tcfg, tparams, scfg=tscfg)
        ref = LLM(_paged(tcfg, tparams, scfg=_tier_scfg(SchedulerCfg, tier)))
        wire, req_cls = (lambda p: p), Request
    else:
        src = LLM(_paged(tcfg, tparams, scfg=tscfg))
        dst = _jpaged(jcfg, jparams, scfg=jscfg)
        ref = jserving.LLM(_jpaged(jcfg, jparams,
                                   scfg=_tier_scfg(jserving.SchedulerCfg,
                                                   tier)))
        wire, req_cls = _jax_wire, jserving.Request
    want = ref.submit(prompt, max_tokens=16, rid=0).result()
    h = src.submit(prompt, max_tokens=16, rid=0)
    while len(h.tokens) < 4:
        src.tick()
    sreq, payload = src.engine.export_request(0)
    if tier == "int8":
        assert float(np.max(np.asarray(tquant.find_scale(
            payload["rows"])))) > 0.0
    req = _as(req_cls, sreq)
    dst.adopt(req, wire(payload))
    _drain(dst)
    assert req.out == want, f"{direction} lost parity:\n{req.out}\n{want}"
    if tier == "int8":
        assert dst.backend.page_accounting()["quantize_events"] > 0
    assert dst.stats()["pool"].live == 0


# ---------------------------------------------------------------- the router

def test_disagg_parity(smoke_lm):
    _, _, tcfg, tparams = smoke_lm
    msg = dscen.scenario_disagg_parity(
        _router_factory(tcfg, tparams), _single_factory(tcfg, tparams), tcfg)
    assert msg.startswith("disagg-parity")


def test_disagg_int8_decode_parity(smoke_lm):
    """The int8 cold tier and sparse decode on both instances: tokens equal
    one instance of the same shapes and forms, pages quantized on the
    prefill side cross the fabric with their scales, and the decode side
    quantizes too. The prefill instance carries the decode tuning because
    it decodes the first token after prefill in the same tick, before the
    hop (as the reference's router does)."""
    _, _, tcfg, tparams = smoke_lm
    tier = dict(decode_hot_width=2, kv_quant="int8")
    prompts = dscen.prompts_for(tcfg, (33, 40, 57))
    make = lambda **kw: _paged(tcfg, tparams, max_batch=4, pages=64,  # noqa
                               scfg=SchedulerCfg(**kw, **tier))
    single = LLM(make(**PREFILL_SCFG))
    handles = [single.submit(p, max_tokens=12, rid=i)
               for i, p in enumerate(prompts)]
    single.run_until_done()
    want = {h.rid: h.tokens for h in handles}
    router = DisaggRouter(make(**PREFILL_SCFG), make(chunk_pages=1))
    staged_q = []
    real = router.transfer._stage_rows
    router.transfer._stage_rows = lambda p: (
        staged_q.append(float(np.max(tquant.find_scale(p["rows"])))),
        real(p))[1]
    got = {h.rid: h.tokens for h in dscen.run_router(router, prompts)}
    assert got == want
    assert router.transfer.n_transfers == 3
    assert max(staged_q) > 0.0, "no quantized page crossed the fabric"
    assert router.prefill.stats()["kv_quant"]["quantize_events"] > 0
    assert router.engine.stats()["kv_quant"]["quantize_events"] > 0
    dscen.assert_drained(router)


def _tier_engine(tcfg, tparams, tier, *, pages=64, **scfg):
    """A paged instance at decode hot width 2, with the int8 tier or
    without it."""
    quant = {"kv_quant": "int8"} if tier == "int8" else {}
    return _paged(tcfg, tparams, max_batch=4, pages=pages,
                  scfg=SchedulerCfg(decode_hot_width=2, **quant, **scfg))


@pytest.mark.parametrize("pre_tier,dec_tier", [("fp", "int8"),
                                               ("int8", "fp")])
def test_disagg_across_tiers(smoke_lm, pre_tier, dec_tier):
    """A prefill instance without the int8 tier feeds a decode instance
    with it, and the reverse. Every hop lands (3 transfers, no fault, no
    decode-side recompute): an fp payload's pages arrive with zero codes
    and scales and read as fp, an int8 payload's tier leaves are dropped
    beside the fp rows they mirror. No page is read from the tier before
    it leaves a window, so the tokens equal one instance of the decode
    side's tier that prefills as the pair does."""
    _, _, tcfg, tparams = smoke_lm
    prompts = dscen.prompts_for(tcfg, (33, 40, 57))
    single = LLM(_tier_engine(tcfg, tparams, dec_tier, **PREFILL_SCFG))
    handles = [single.submit(p, max_tokens=12, rid=i)
               for i, p in enumerate(prompts)]
    single.run_until_done()
    router = DisaggRouter(
        _tier_engine(tcfg, tparams, pre_tier, **PREFILL_SCFG),
        _tier_engine(tcfg, tparams, dec_tier, chunk_pages=1))
    got = {h.rid: h.tokens for h in dscen.run_router(router, prompts)}
    assert got == {h.rid: h.tokens for h in handles}
    tr = router.transfer.stats()
    assert (tr["n_transfers"], tr["n_faults"], tr["n_recompute"]) == \
        (3, 0, 0)
    st = router.engine.sched.stats
    assert (st.faults, st.recomputes) == (0, 0)
    for eng, tier in ((router.prefill, pre_tier), (router.engine, dec_tier)):
        if tier == "int8":
            assert eng.stats()["kv_quant"]["quantize_events"] > 0
    dscen.assert_drained(router)


def test_disagg_recycled_pages_carry_no_stale_scale(smoke_lm):
    """Requests served one after another through a prefill instance of 20
    pages reuse pages that an earlier request's first decode quantized.
    A reused page's flag clears but its scale stays on the device, so the
    payload sends 0 for every page whose flag is clear; otherwise the
    decode side would mark the page quantized and read the last owner's
    codes. The tokens equal one instance with room for every request."""
    _, _, tcfg, tparams = smoke_lm
    prompts = dscen.prompts_for(tcfg, (100, 90, 110, 95, 105, 99))
    single = LLM(_tier_engine(tcfg, tparams, "int8", **PREFILL_SCFG))
    router = DisaggRouter(
        _tier_engine(tcfg, tparams, "int8", pages=20, **PREFILL_SCFG),
        _tier_engine(tcfg, tparams, "int8", chunk_pages=1))
    got, want = [], []
    for rid, prompt in enumerate(prompts):
        want.append(single.submit(prompt, max_tokens=8, rid=rid))
        single.run_until_done()
        got += dscen.run_router(router, [prompt], max_tokens=8, rid0=rid)
    assert [h.tokens for h in got] == [h.tokens for h in want]
    assert router.prefill.stats()["kv_quant"]["quantize_events"] \
        > router.prefill.backend.pool.n_pages
    dscen.assert_drained(router)


def test_disagg_observability(smoke_lm, tmp_path):
    """With live telemetry the handoff is visible end to end: transfer
    byte counters, recorder transfer_out/transfer_in events, timeline
    epochs, and the debug bundle's transfer + prefill-side artifacts."""
    _, _, tcfg, tparams = smoke_lm
    tel = tobs.Telemetry()
    router = _router_factory(tcfg, tparams)(tel=tel)
    handles = dscen.run_router(router, dscen.prompts_for(tcfg)[:3])
    snap = tel.metrics.snapshot()
    assert any("kv_transfer_bytes" in k for k in snap), list(snap)
    kinds = {e["kind"] for e in tel.recorder.events()}
    assert {"transfer_out", "transfer_in"} <= kinds, kinds
    ep = [k for k, _ in handles[0].timeline.epochs()]
    assert "transfer_out" in ep and "transfer_in" in ep, ep
    assert ep.index("transfer_out") < ep.index("transfer_in")
    m = router.metrics()
    assert m["requests"] == 3 and m["ttft_p50_ms"] is not None
    assert m["engine"]["transfer"]["n_transfers"] == 3
    out = router.debug_bundle(str(tmp_path / "bundle"))
    names = {p.name for p in (tmp_path / "bundle").iterdir()}
    assert out == str(tmp_path / "bundle")
    assert {"transfer.json", "accounting_prefill.json", "accounting.json",
            "recorder.jsonl"} <= names, names


def test_disagg_host_staging_parity(smoke_lm):
    """Host staging (deep-copied leaves, a serialisation boundary) lands
    the same tokens as device staging, and shares no buffer with the
    exporter's rows."""
    _, _, tcfg, tparams = smoke_lm
    prompts = dscen.prompts_for(tcfg)[:3]
    make = _router_factory(tcfg, tparams)
    dev = {h.rid: h.tokens for h in dscen.run_router(make(), prompts)}
    router = make(staging="host")
    staged = []
    real = router.transfer._stage_rows

    def spy(payload):
        out = real(payload)
        staged.append((payload["rows"], out["rows"]))
        return out
    router.transfer._stage_rows = spy
    host = {h.rid: h.tokens for h in dscen.run_router(router, prompts)}
    assert dev == host
    assert staged and all(
        not np.shares_memory(a, b)
        for src, dst in staged
        for a, b in zip(tree_leaves(src), tree_leaves(dst)))


def test_disagg_cow_shared_prefix(smoke_lm):
    """Identical prompts cross the fabric once each, and the second
    import COW-shares the first's prefix pages on the decode pool."""
    _, _, tcfg, tparams = smoke_lm
    router = _router_factory(tcfg, tparams)()
    prompt = PROMPT % tcfg.vocab
    h0 = router.submit(prompt, max_tokens=12, rid=0)
    h1 = router.submit(prompt, max_tokens=12, rid=1)
    shared_seen = steps = 0
    while router.has_work() and steps < 4000:
        router.tick()
        shared_seen = max(shared_seen,
                          router.engine.backend.page_accounting()["shared"])
        steps += 1
    assert h0.done and h1.done
    assert h0.tokens == h1.tokens and len(h0.tokens) == 12
    assert router.transfer.n_transfers == 2
    assert shared_seen > 0, \
        "identical prefixes never COW-shared on the decode pool"
    dscen.assert_drained(router)


def test_disagg_transfer_chaos(smoke_lm, port_faults):
    jcfg, jparams, tcfg, tparams = smoke_lm

    def tie(prompt, got, want):
        return scen._greedy_tie(jcfg, jparams, prompt, got, want)

    msg = dscen.scenario_disagg_chaos(
        _router_factory(tcfg, tparams), _single_factory(tcfg, tparams),
        tcfg, greedy_tie=tie)
    assert msg.startswith("disagg-chaos")


def test_disagg_transfer_quarantine(smoke_lm):
    """Past the retry budget a transfer-faulted request is quarantined
    FAILED on the decode side; co-resident requests are undisturbed and
    neither pool leaks."""
    _, _, tcfg, tparams = smoke_lm
    plan = FaultPlan(schedule={"transfer": {0}})
    router = _router_factory(tcfg, tparams)(fault_plan=plan,
                                            transfer_retries=0)
    handles = [router.submit(p, max_tokens=10, rid=i)
               for i, p in enumerate(dscen.prompts_for(tcfg)[:3])]
    dscen.drive_checked_disagg(router)
    outcomes = sorted(h.outcome for h in handles)
    assert outcomes.count("failed") == 1, outcomes
    assert outcomes.count("done") == 2, outcomes
    assert plan.fired(("transfer",)) == 1
    dscen.assert_drained(router)


def test_disagg_cancel_and_deadline(smoke_lm):
    """cancel() works wherever the request is (still prefilling, or
    decoding on the far instance), and a zero deadline expires without
    crossing the fabric; no pages leak on either side."""
    _, _, tcfg, tparams = smoke_lm
    router = _router_factory(tcfg, tparams)()
    h0 = router.submit((np.arange(40, dtype=np.int32) * 5) % tcfg.vocab,
                       max_tokens=16, rid=0)
    h1 = router.submit(np.arange(8, dtype=np.int32), max_tokens=16, rid=1)
    h2 = router.submit(np.arange(6, dtype=np.int32), max_tokens=16, rid=2,
                       deadline_ms=0.0)
    router.tick()
    assert h0.cancel(), "cancel on the prefill side failed"
    while not h1.tokens and router.has_work():
        router.tick()
    assert h1.cancel(), "cancel on the decode side failed"
    assert not h1.cancel(), "double-cancel must return False"
    dscen.drive_checked_disagg(router)
    assert h0.outcome == "cancelled"
    assert h1.outcome == "cancelled"
    assert h2.outcome == "expired" and h2.tokens == []
    dscen.assert_drained(router)


def test_disagg_from_config(smoke_lm):
    """The one-call constructor builds a working pair around shared params
    on the device asked for, and a spatial-prefill pair that serves."""
    _, _, tcfg, tparams = smoke_lm
    router = DisaggRouter.from_config(tcfg, params=tparams, device="cpu")
    assert router.prefill.backend.params is router.engine.backend.params
    assert router.prefill.tel is router.engine.tel is router.tel
    h = router.submit(np.arange(10, dtype=np.int32), max_tokens=6)
    dscen.drive_checked_disagg(router)
    assert h.outcome == "done" and len(h.tokens) == 6
    assert router.transfer.n_transfers == 1
    dscen.assert_drained(router)
    from repro_torch.spatial import SpatialServingEngine
    router = DisaggRouter.from_config(tcfg, params=tparams, device="cpu",
                                      prefill_backend="spatial", shards=2)
    assert isinstance(router.prefill, SpatialServingEngine)
    assert router.prefill.topo.n_shards == 2
    assert isinstance(router.engine, PagedServingEngine)
    h = router.submit(np.arange(40, dtype=np.int32), max_tokens=6)
    dscen.drive_checked_disagg(router)
    assert h.outcome == "done" and len(h.tokens) == 6
    assert router.transfer.n_transfers == 1
    dscen.assert_drained(router)
    with pytest.raises(ValueError, match="unknown disagg backend"):
        DisaggRouter.from_config(tcfg, params=tparams, device="cpu",
                                 prefill_backend="dense")


def test_disagg_int8_tier_read_matches_reference():
    """The served int8 read path end to end, against the reference: the
    JAX pair and the port's pair, same weights and configs (both
    instances decode at hot width 4 with the int8 tier), serve a long
    request and, once its first hop has landed, one on a page-aligned
    prefix of it. The second request COW-shares the first's prefix pages,
    which the first request's decode quantized, and its window selects
    some of them: gathered slots read the int8 tier on both instances,
    and the tokens equal the reference's. In fp32, where the two packages
    compute the same function (a bf16 rounding step apart, a greedy
    argmax near a tie may part, ROADMAP §3)."""
    jcfg, jparams, tcfg, tparams = _convert(dataclasses.replace(
        get_smoke_config("olmo_1b"), star=None, dtype=jnp.float32), 2)
    prompt = (np.arange(160, dtype=np.int32) * 7 + 3) % tcfg.vocab

    def serve(router_cls, engine_cls, pcfg_cls, scfg_cls, cfg, params):
        def inst():
            return engine_cls(cfg, params, pcfg_cls(
                max_batch=2, page_size=16, n_pages=48, hot_pages=16,
                eos_id=-1), scfg_cls(chunk_pages=1, decode_hot_width=4,
                                     kv_quant="int8"))
        router = router_cls(inst(), inst())
        h0 = router.submit(prompt, max_tokens=12, rid=0)
        while not router.transfer.n_transfers:
            router.tick()
        h1 = router.submit(prompt[:80], max_tokens=12, rid=1)
        router.run_until_done()
        return [h0.tokens, h1.tokens], router

    want, _ = serve(jserving.DisaggRouter, jserving.PagedServingEngine,
                    jserving.PagedEngineCfg, jserving.SchedulerCfg, jcfg,
                    jparams)
    reads = {"slots": 0}

    class Counted(PagedServingEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            real = self.backend._page_state

            def counted(*args):
                ps = real(*args)
                if "qmask" in ps:    # absent: no slot marked
                    reads["slots"] += int((ps["qmask"]
                                           & (ps["logical"] >= 0)).sum())
                return ps
            self.backend._page_state = counted

    got, router = serve(DisaggRouter, Counted, PagedEngineCfg, SchedulerCfg,
                        tcfg, tparams)
    assert got == want
    assert reads["slots"] > 0, "no gathered slot read the int8 tier"
    assert router.transfer.n_transfers == 2
    assert router.engine.backend.pool.stats().shared_hits > 0
