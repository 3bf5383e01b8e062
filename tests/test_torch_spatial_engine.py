"""Port parity: the spatial (sequence-sharded) serving engine
(``repro_torch.spatial.SpatialServingEngine``) held to the criteria the
reference's own spatial tests assert, in process.

The reference runs those tests as shard_map programs on fake XLA devices
in subprocesses (tests/spatial_progs/), and under JAX 0.9.0 its decode
step faults (ROADMAP §3), so they are red. The port has neither
shard_map nor ``lax.cond``; it is held instead to their criteria,
against the port's paged engine and the JAX paged engine:

* ``engine_prog.py``: mixed-length token parity, a prompt longer than
  one shard's pool, cross-shard prefix sharing (fp32, ``star=None``);
* ``decode_sparse_prog.py``: unbounded width equals the dense oracle;
  bounded per-shard width keeps the first token and an agreement floor,
  with the skip telemetry populated; the int8 tier at minimal width
  leaves the tokens as they were while pages quantize;
* ``conformance_prog.py``: ``engine_core_scenarios.run_all`` and
  ``run_chaos`` with a torch spatial ``LLM`` factory at 2 and 4 shards
  (bf16, the reference's setting; the drivers unedited);
* ``smoke_spatial_prog.py --trace``: shard-tagged trace events;
* ``disagg_prog.py``: spatial prefill into paged decode (fp32).
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
from repro_torch.serving import (LLM, DisaggRouter, EngineCfg,  # noqa: E402
                                 PagedEngineCfg, PagedServingEngine,
                                 Request, SchedulerCfg, ServingEngine)
from repro_torch.spatial import (SpatialEngineCfg,  # noqa: E402
                                 SpatialServingEngine)

MIXED = (5, 8, 17, 33, 40)


def _convert(jcfg, seed=1):
    jparams = jlm.init(jax.random.PRNGKey(seed), jcfg)
    tparams = convert.to_torch(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, convert.model_cfg_from_reference(jcfg), tparams


@pytest.fixture(scope="module")
def fp32_lm():
    """engine_prog's model (olmo smoke, ``star=None``) in fp32, where the
    spatial merge and the one-pool gather compute one function."""
    return _convert(dataclasses.replace(get_smoke_config("olmo_1b"),
                                        star=None, dtype=jnp.float32))


@pytest.fixture(scope="module")
def bf16_lm():
    """conformance_prog's model (olmo smoke, ``star=None``, bf16)."""
    return _convert(dataclasses.replace(get_smoke_config("olmo_1b"),
                                        star=None))


def _reqs(cfg, lengths, max_tokens=5):
    return [Request(rid=i, prompt=(np.arange(n, dtype=np.int32) * 7 + i)
                    % cfg.vocab, max_tokens=max_tokens)
            for i, n in enumerate(lengths)]


def _spatial(tcfg, tparams, n_sh, *, max_batch=2, pages=32, hot=4,
             recent=2, scfg=None):
    return SpatialServingEngine(tcfg, tparams, SpatialEngineCfg(
        n_shards=n_sh, max_batch=max_batch, page_size=16,
        n_pages_local=pages, hot_pages_local=hot, recent_pages=recent,
        eos_id=-1), scfg or SchedulerCfg(chunk_pages=1))


@pytest.fixture(scope="module")
def paged_tokens(fp32_lm):
    """engine_prog's criterion 1 reference: the port's paged engine's
    tokens on the mixed-length batch, which equal the JAX paged
    engine's."""
    jcfg, jparams, tcfg, tparams = fp32_lm
    pcfg = dict(max_batch=2, page_size=16, n_pages=32, hot_pages=4,
                recent_pages=2, eos_id=-1)
    want = jserving.PagedServingEngine(
        jcfg, jparams, jserving.PagedEngineCfg(**pcfg),
        jserving.SchedulerCfg(chunk_pages=1)).run(
            [jserving.Request(rid=r.rid, prompt=r.prompt, max_tokens=5)
             for r in _reqs(jcfg, MIXED)])
    got = PagedServingEngine(tcfg, tparams, PagedEngineCfg(**pcfg),
                             SchedulerCfg(chunk_pages=1)).run(
                                 _reqs(tcfg, MIXED))
    assert got == want
    return got


@pytest.mark.parametrize("n_sh", [2, 4])
def test_spatial_engine_matches_paged_engine(fp32_lm, paged_tokens, n_sh):
    """engine_prog criterion 1: the mixed-length batch under chunked
    prefill gives the paged engines' tokens, with one decode shape."""
    _, _, tcfg, tparams = fp32_lm
    sp = _spatial(tcfg, tparams, n_sh)
    assert sp.run(_reqs(tcfg, MIXED)) == paged_tokens
    st = sp.stats()
    assert st["decode_compiles"] == 1 and st["n_shards"] == n_sh
    assert st["pools"]["live"] == 0


@pytest.mark.parametrize("n_sh", [2, 4])
def test_spatial_engine_serves_beyond_one_shard_pool(fp32_lm, n_sh):
    """engine_prog criterion 2: a 150-token prompt (10 pages) overflows
    one 8-page pool, so the paged engine of that pool refuses it; the
    spatial engine stripes it over the shards and serves it."""
    _, _, tcfg, tparams = fp32_lm
    long_prompt = (np.arange(150, dtype=np.int32) * 3 + 11) % tcfg.vocab
    small = PagedServingEngine(tcfg, tparams, PagedEngineCfg(
        max_batch=2, page_size=16, n_pages=8, hot_pages=12, eos_id=-1),
        SchedulerCfg(chunk_pages=2))
    with pytest.raises(ValueError, match="pool holds"):
        small.submit(Request(rid=0, prompt=long_prompt, max_tokens=4))
    sp = _spatial(tcfg, tparams, n_sh, pages=8, hot=12,
                  scfg=SchedulerCfg(chunk_pages=2))
    done = sp.run([Request(rid=0, prompt=long_prompt, max_tokens=4)])
    assert len(done[0]) == 4 and all(0 <= t < tcfg.vocab for t in done[0])
    big = PagedServingEngine(tcfg, tparams, PagedEngineCfg(
        max_batch=2, page_size=16, n_pages=8 * n_sh, hot_pages=12,
        eos_id=-1), SchedulerCfg(chunk_pages=2))
    assert big.run([Request(rid=0, prompt=long_prompt, max_tokens=4)]) \
        == done


@pytest.mark.parametrize("n_sh", [2, 4])
def test_spatial_engine_shares_prefixes_across_shards(fp32_lm, n_sh):
    """engine_prog criterion 3: prompts on a shared 2-page prefix hit the
    prefix index of each page's owner shard."""
    _, _, tcfg, tparams = fp32_lm
    sp = _spatial(tcfg, tparams, n_sh)
    shared = np.arange(32, dtype=np.int32)
    reqs = [Request(rid=i, prompt=np.concatenate(
        [shared, np.full((4 + i,), 100 + i, np.int32)]), max_tokens=4)
        for i in range(2)]
    sp.run(reqs)
    per = sp.stats()["pools"]["per_shard"]
    assert sum(p.shared_hits for p in per) >= 2
    assert all(p.shared_hits >= 1 for p in per[:2])


# -- decode sparsity (decode_sparse_prog) -------------------------------------

def _agreement(got, want):
    fr = []
    for rid in want:
        n = 0
        for x, y in zip(got[rid], want[rid]):
            if x != y:
                break
            n += 1
        fr.append(n / max(len(want[rid]), 1))
    return sum(fr) / len(fr)


@pytest.mark.parametrize("n_sh", [2])    # as the reference runs it
def test_spatial_decode_sparsity(fp32_lm, n_sh):
    """decode_sparse_prog's criteria: unbounded width equals the dense
    oracle; bounded per-shard width keeps every first token and greedy
    agreement at or above the reference's floor (0.5), one decode shape,
    and populates the skip telemetry (pages considered and skipped, and
    per-shard skip counts on the host); the int8 tier at that width gives the same
    tokens while cold pages quantize."""
    _, _, tcfg, tparams = fp32_lm
    prompts = [(np.arange(n, dtype=np.int32) * 7 + i) % tcfg.vocab
               for i, n in enumerate((5, 21, 40, 64))]

    def run(llm):
        handles = [llm.submit(p, max_tokens=24, rid=i)
                   for i, p in enumerate(prompts)]
        done = llm.run_until_done(max_steps=10_000)
        assert all(h.done for h in handles)
        return done

    def spatial(width=None, kv_quant=None, tel=None):
        return LLM(_spatial(tcfg, tparams, n_sh, pages=24, hot=8,
                            scfg=SchedulerCfg(chunk_pages=1,
                                              decode_hot_width=width,
                                              kv_quant=kv_quant)),
                   telemetry=tel)

    want = run(LLM(ServingEngine(tcfg, tparams, EngineCfg(
        max_batch=2, max_len=128, eos_id=-1))))
    llm = spatial()
    assert run(llm) == want
    assert llm.stats()["decode_compiles"] == 1

    tel = tobs.Telemetry()
    llm = spatial(width=2, tel=tel)
    got = run(llm)
    assert all(got[rid][0] == want[rid][0] for rid in want)
    assert _agreement(got, want) >= 0.5
    st = llm.stats()
    assert st["decode_compiles"] == 1 and st["hot_width"] == 2
    spars = llm.engine.backend.decode_sparsity
    assert spars is not None and spars["pages_hot"] <= spars["pages_total"]
    assert len(st["shard_skips"]) == n_sh and st["decode_steps"] > 0
    prom = tel.metrics.render_prometheus()
    assert "engine_decode_pages_skipped_total" in prom

    llm = spatial(width=2, kv_quant="int8")
    assert run(llm) == got
    kq = llm.stats()["kv_quant"]
    assert kq["quantize_events"] > 0
    assert kq["bytes_per_page_int8"] < kq["bytes_per_page_fp"]


def test_spatial_shard_skips_when_a_shard_holds_nothing_hot(fp32_lm):
    """A bounded width leaves some shard with no hot page for the whole
    batch (a one-page prompt lives on shard 0 only): the host counts the
    skip for that shard, and K1's stats form (the plain version here)
    gives it the neutral state, so the tokens equal the paged engine's."""
    _, _, tcfg, tparams = fp32_lm
    prompt = np.arange(10, dtype=np.int32) + 3
    sp = _spatial(tcfg, tparams, 4, scfg=SchedulerCfg(chunk_pages=1,
                                                      decode_hot_width=2))
    done = sp.run([Request(rid=0, prompt=prompt, max_tokens=4)])
    st = sp.stats()
    assert st["shard_skips"][1:] == [st["decode_steps"]] * 3
    assert st["shard_skips"][0] == 0
    want = PagedServingEngine(tcfg, tparams, PagedEngineCfg(
        max_batch=2, page_size=16, n_pages=32, hot_pages=4, eos_id=-1),
        SchedulerCfg(chunk_pages=1)).run(
            [Request(rid=0, prompt=prompt, max_tokens=4)])
    assert done == want


# -- the backend-conformance scenario drivers, unedited ----------------------

def _port_scfg(scfg) -> SchedulerCfg:
    return SchedulerCfg(**dataclasses.asdict(scfg))


def _spatial_factory(tcfg, tparams, n_sh):
    def make_llm(*, max_batch, pages, hot, scfg, recent=2):
        return LLM(_spatial(tcfg, tparams, n_sh, max_batch=max_batch,
                            pages=pages, hot=hot, recent=recent,
                            scfg=_port_scfg(scfg)))
    return make_llm


@pytest.mark.parametrize("n_sh", [2, 4])
def test_spatial_port_conformance(bf16_lm, n_sh):
    """``engine_core_scenarios.run_all`` with a torch spatial factory: the
    in-process twin of the reference's red
    ``test_spatial_backend_conformance[n]``."""
    jcfg, jparams, tcfg, tparams = bf16_lm
    log = []
    scen.run_all(_spatial_factory(tcfg, tparams, n_sh), jcfg, jparams,
                 scen.BACKEND_PARAMS[f"spatial{n_sh}"], log=log.append)
    assert len(log) == len(scen.SCENARIOS)


@pytest.mark.parametrize("n_sh", [2, 4])
def test_spatial_port_chaos(bf16_lm, n_sh, monkeypatch):
    """``run_chaos`` with a torch spatial factory (the scenarios' FaultPlan,
    FaultyBackend and Telemetry resolve to the port's): the in-process
    twin of the reference's red ``test_spatial_backend_chaos``."""
    import repro.obs as jobs

    from repro_torch.serving import FaultPlan, FaultyBackend
    monkeypatch.setattr(jserving, "FaultPlan", FaultPlan)
    monkeypatch.setattr(jserving, "FaultyBackend", FaultyBackend)
    monkeypatch.setattr(jobs, "Telemetry", tobs.Telemetry)
    jcfg, jparams, tcfg, tparams = bf16_lm
    log = []
    scen.run_chaos(_spatial_factory(tcfg, tparams, n_sh), jcfg, jparams,
                   scen.BACKEND_PARAMS[f"spatial{n_sh}"], log=log.append)
    assert len(log) == len(scen.CHAOS_SCENARIOS)
    assert all(line.endswith("OK") for line in log), log


# -- trace, disaggregation -----------------------------------------------------

def test_spatial_trace_carries_shard_tags(bf16_lm, tmp_path):
    """The twin of ``test_spatial_trace_shard_tags``: a traced 2-shard run
    with the batched prefill exports a loadable trace with events tagged
    for both shards and its ticks in order."""
    _, _, tcfg, tparams = bf16_lm
    tel = tobs.Telemetry({"backend": "spatial", "n_shards": 2})
    llm = LLM(_spatial(tcfg, tparams, 2, pages=24, scfg=SchedulerCfg(
        chunk_pages=1, prefill_tokens=48)), telemetry=tel)
    for i, n in enumerate((6, 18, 35)):
        llm.submit((np.arange(n, dtype=np.int32) * 5 + i) % tcfg.vocab,
                   max_tokens=4, rid=i)
    done = llm.run_until_done(max_steps=20_000)
    assert all(len(v) == 4 for v in done.values())
    path = str(tmp_path / "spatial_trace.json")
    tel.tracer.export_chrome(path)
    events = tobs.load_trace(path)
    shards = {(e.get("args") or {}).get("shard") for e in events}
    assert {0, 1} <= shards, shards
    ticks = [e["ts"] for e in events if e.get("name") == "tick"]
    assert ticks and ticks == sorted(ticks)


def test_spatial_audit_reports_per_shard(fp32_lm):
    """The DLZS audit probe over sharded pools: masses normalised over all
    shards (recall 1 with every page hot), a per-shard row each, and the
    live pool left as it was."""
    _, _, tcfg, tparams = fp32_lm
    tel = tobs.Telemetry()
    llm = LLM(_spatial(tcfg, tparams, 2, hot=8), telemetry=tel)
    llm.engine.auditor = tobs.DlzsAuditor(tobs.AuditCfg(every_ticks=2))
    prompts = [(np.arange(n, dtype=np.int32) * 7 + i) % tcfg.vocab
               for i, n in enumerate((40, 57))]
    hs = [llm.submit(p, max_tokens=12, rid=i) for i, p in enumerate(prompts)]
    llm.run_until_done()
    rep = llm.engine.auditor.reports
    assert llm.engine.auditor.runs >= 2 and rep
    for r in rep:
        assert len(r["per_shard"]) == 2
        assert r["recall_min"] == pytest.approx(1.0, abs=1e-5)
    want = PagedServingEngine(tcfg, tparams, PagedEngineCfg(
        max_batch=2, page_size=16, n_pages=32, hot_pages=8, eos_id=-1),
        SchedulerCfg(chunk_pages=1)).run(
            [Request(rid=i, prompt=p, max_tokens=12)
             for i, p in enumerate(prompts)])
    assert {h.rid: h.tokens for h in hs} == want


def test_spatial_prefill_into_paged_decode(fp32_lm, monkeypatch):
    """The twin of ``test_spatial_to_paged_disagg``: a 2-shard spatial
    prefill instance hands off into a paged decode instance over the
    flat-payload wire; the pair is token-equal to one paged instance of
    the decode tuning (``scenario_disagg_parity``) and to one spatial
    instance of the same tuning, and survives lost hops
    (``scenario_disagg_chaos``). fp32."""
    from repro_torch.serving import FaultPlan
    monkeypatch.setattr(jserving, "FaultPlan", FaultPlan)
    jcfg, jparams, tcfg, tparams = fp32_lm

    def decode_inst():
        return PagedServingEngine(tcfg, tparams, PagedEngineCfg(
            max_batch=4, page_size=16, n_pages=64, hot_pages=4,
            eos_id=-1), SchedulerCfg(chunk_pages=1))

    def make_router(*, fault_plan=None, staging="device",
                    transfer_retries=2, tel=None):
        pre = _spatial(tcfg, tparams, 2, scfg=SchedulerCfg(
            chunk_pages=1, prefill_tokens=48))
        return DisaggRouter(pre, decode_inst(), telemetry=tel,
                            fault_plan=fault_plan, staging=staging,
                            transfer_retries=transfer_retries)

    dscen.scenario_disagg_parity(make_router, lambda: LLM(decode_inst()),
                                 tcfg)
    single = LLM(_spatial(tcfg, tparams, 2, max_batch=4, pages=64))
    prompts = dscen.prompts_for(tcfg)
    hs = [single.submit(p, max_tokens=12, rid=i)
          for i, p in enumerate(prompts)]
    single.run_until_done()
    pair = {h.rid: h.tokens for h in dscen.run_router(make_router(),
                                                      prompts)}
    assert pair == {h.rid: h.tokens for h in hs}
    dscen.scenario_disagg_chaos(
        make_router, lambda: LLM(decode_inst()), tcfg,
        greedy_tie=lambda p, got, want: scen._greedy_tie(
            jcfg, jparams, p, got, want))


def test_chip_smoke_spatial_phases_rehearse_on_cpu(monkeypatch):
    """chip_smoke.py's phase 2 stats-form check (plain against plain here,
    both lanes, an empty shard) and phase 13 at smoke size on the CPU: the
    one-shard-pool paged engine refuses the longest prompt, the spatial
    engine serves every prompt with each token the dense argmax or a bf16
    tie, the bounded run gathers fewer pages than are resident and the
    lone request leaves shards skipped. The launch checks, which the CPU
    cannot meet, are recorded instead of run; their expectations are
    held."""
    import pathlib

    from repro_torch.configs import get_smoke_config as tsmoke
    monkeypatch.syspath_prepend(str(pathlib.Path(__file__).parents[1]))
    import chip_smoke as cs
    held = []
    for name in ("require_spatial_launches", "require_k4"):
        monkeypatch.setattr(cs, name, lambda summary, tag, name=name:
                            held.append((name, tag, summary)))
    for lane in (False, True):
        out = cs.check_paged_stats("cpu", "rehearsal", 4, b=3, g=2, r=2,
                                   d=64, page=16, w=3, p=8,
                                   kv_len=(150, 17, 1), seed=5, timed=False,
                                   quant=lane, empty_shard=1)
        assert out["violations"] == 0 and out["states_empty"] > 0
        if lane:
            assert out["all_false_bit_equal_fp"]
            assert out["violations_fp_form"] > 0 \
                and out["violations_other_page_scale"] > 0
    # the int8 lane's bound counts marked rows at 1 byte plus page scales
    q, k, v, phys, logical, kvl = cs.sharded_inputs(4, 3, 2, 2, 64, 16, 3, 8,
                                                    (150, 17, 1), 5, "cpu")
    fp_bytes, fp_ops = cs.stats_work(q, k, logical, kvl)
    none = torch.zeros_like(phys, dtype=torch.bool)
    assert cs.stats_work(q, k, logical, kvl, none) == (
        fp_bytes + phys.numel(), fp_ops)
    assert cs.stats_work(q, k, logical, kvl, ~none)[0] < fp_bytes
    gen = torch.Generator().manual_seed(0)
    sp = cs.check_spatial(tsmoke("olmo_1b"), "cpu", gen,
                          lengths=(64, 96, 128), max_tokens=4, n_shards=4,
                          pages_local=8, hot_width=1)
    served, bounded = sp["served"], sp["bounded"]
    assert "pool holds" in served["one_pool_refused"]
    assert served["pages_needed_longest"] == 9
    assert served["requests"] == 3 and served["tokens"] == 12
    ex = served["exactness"]
    assert ex["tokens_checked"] == 12 and ex["exact"] + ex["bf16_ties"] == 12
    assert served["expected_stats_launches"] == served["decode_ticks"] * 2
    assert served["k1_stats_launches"] == served["k1_normalised_launches"] \
        == 0
    assert bounded["pages_gathered_per_tick"] < \
        bounded["pages_resident_per_tick"]
    assert bounded["lone_request"]["requests"] == 1
    assert sum(bounded["shard_skips"]) > 0
    assert {n for n, _, _ in held} == {"require_spatial_launches",
                                       "require_k4"}
