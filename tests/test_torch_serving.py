"""Port parity: the paged serving stack (``repro_torch.serving``) through
the ``LLM`` front door, held against the reference.

* ``engine_core_scenarios.SCENARIOS`` run unchanged with a torch
  ``make_llm`` factory: the JAX ``SchedulerCfg`` each scenario builds is
  turned into the port's through ``dataclasses.asdict``, the weights come
  from ``repro.models.lm.init`` through the converter, and parity is
  judged against the JAX dense oracle (``_dense_oracle``) token for token;
  ``scenario_decode_sparse_pressure`` runs the int8 cold tier.
* The chaos scenarios (``engine_core_scenarios.run_chaos``) with the same
  factory and the port's ``FaultPlan``/``FaultyBackend``.
* Bounded DLZS sparse decode (``decode_hot_width``) against the JAX paged
  engine on the same weights, token for token.
* The entry points: ``backend="spatial"`` serves; every architecture
  resolves and the paged engine refuses an encoder-decoder model, as the
  reference's does; without a GPU nothing falls back to the CPU.
* Import purity: neither ``repro_torch`` nor ``chip_smoke.py`` pulls in
  ``jax`` or ``repro``, and ``chip_smoke.py`` fails without a card.
"""

import dataclasses
import pathlib
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# Smoke shapes run as fast on one thread, and the other test workers
# keep the remaining cores.
torch.set_num_threads(1)

import engine_core_scenarios as scen  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import LLM as JLLM  # noqa: E402
from repro.serving import PagedEngineCfg as JPagedEngineCfg  # noqa: E402
from repro.serving import PagedServingEngine as JPaged  # noqa: E402
from repro.serving import SchedulerCfg as JSchedulerCfg  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import get_smoke_config as tsmoke  # noqa: E402
from repro_torch.serving import (LLM, PagedEngineCfg,  # noqa: E402
                                 PagedServingEngine, SchedulerCfg)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke_lm():
    """The reference's parity setting (olmo smoke, ``star=None``, bf16)
    and its weights in both packages."""
    jcfg = dataclasses.replace(get_smoke_config("olmo_1b"), star=None)
    jparams = jlm.init(jax.random.PRNGKey(1), jcfg)
    tparams = convert.to_torch(jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, convert.model_cfg_from_reference(jcfg), tparams


def _port_scfg(scfg) -> SchedulerCfg:
    return SchedulerCfg(**dataclasses.asdict(scfg))


def _torch_factory(tcfg, tparams):
    def make_llm(*, max_batch, pages, hot, scfg, recent=2):
        return LLM(PagedServingEngine(tcfg, tparams, PagedEngineCfg(
            max_batch=max_batch, page_size=16, n_pages=pages,
            hot_pages=hot, recent_pages=recent, eos_id=-1),
            _port_scfg(scfg)))
    return make_llm


@pytest.mark.parametrize("scenario", scen.SCENARIOS,
                         ids=lambda s: s.__name__)
def test_paged_port_conformance(smoke_lm, scenario):
    jcfg, jparams, tcfg, tparams = smoke_lm
    bp = scen.BACKEND_PARAMS["paged"]
    scenario(_torch_factory(tcfg, tparams), jcfg, jparams, bp)


def test_paged_port_chaos(smoke_lm, monkeypatch):
    """``run_chaos`` (fault storms at every backend seam, a seeded storm,
    cancellation and deadlines) with the torch factory: the scenarios'
    ``from repro.serving import FaultPlan, FaultyBackend`` resolve to the
    port's classes, and their telemetry (``from repro import obs``) to the
    port's ``Telemetry``, for this test's duration."""
    import repro.obs as jobs
    import repro.serving as jserving

    from repro_torch import obs as tobs
    from repro_torch.serving import FaultPlan, FaultyBackend
    monkeypatch.setattr(jserving, "FaultPlan", FaultPlan)
    monkeypatch.setattr(jserving, "FaultyBackend", FaultyBackend)
    monkeypatch.setattr(jobs, "Telemetry", tobs.Telemetry)
    jcfg, jparams, tcfg, tparams = smoke_lm
    log = []
    scen.run_chaos(_torch_factory(tcfg, tparams), jcfg, jparams,
                   scen.BACKEND_PARAMS["paged"], log=log.append)
    assert len(log) == len(scen.CHAOS_SCENARIOS)
    assert all(line.endswith("OK") for line in log), log


def test_sparse_decode_matches_reference_engine(smoke_lm):
    """Bounded sphere-rule decode (``decode_hot_width`` below the live
    page count, so DLZS page scores and the SADS sphere run every tick):
    the port's tokens equal the JAX paged engine's on the same weights."""
    jcfg, jparams, tcfg, tparams = smoke_lm
    prompts = scen._prompts(jcfg, (40, 57, 33))

    def pcfg(cls):
        return cls(max_batch=2, page_size=16, n_pages=32, hot_pages=4,
                   eos_id=-1)

    def scfg(cls):
        return cls(chunk_pages=1, prefill_tokens=48, decode_hot_width=2)

    want = scen._run_llm(JLLM(JPaged(jcfg, jparams, pcfg(JPagedEngineCfg),
                                     scfg(JSchedulerCfg))),
                         prompts, max_tokens=24)
    llm = LLM(PagedServingEngine(tcfg, tparams, pcfg(PagedEngineCfg),
                                 scfg(SchedulerCfg)))
    got = scen._run_llm(llm, prompts, max_tokens=24)
    assert got == want
    st = llm.stats()
    assert st["hot_width"] == 2 and st["decode_compiles"] == 1


def test_whole_prompt_prefill_matches_reference_engine():
    """``SchedulerCfg(chunk_pages=None)``: each prompt is prefilled whole
    by ``lm.prefill`` at its bucketed width, STAR on, so the port runs the
    K2 -> SADS -> K3 glue (one q-chunk at 64 tokens, a scan at 128); its
    tokens equal the JAX paged engine's on the same weights. In fp32: in
    bf16 a one-step rounding difference between the packages can flip a
    near-tied tile selection in a later layer (ROADMAP §3)."""
    import jax.numpy as jnp
    jcfg = dataclasses.replace(get_smoke_config("olmo_1b"),
                               dtype=jnp.float32)
    assert jcfg.star is not None
    jparams = jlm.init(jax.random.PRNGKey(2), jcfg)
    tparams = convert.to_torch(jax.tree.map(np.asarray, jparams))
    tcfg = convert.model_cfg_from_reference(jcfg)
    prompts = scen._prompts(jcfg, (40, 57, 33, 70))

    def pcfg(cls):
        return cls(max_batch=2, page_size=16, n_pages=32, hot_pages=8,
                   eos_id=-1)

    want = scen._run_llm(JLLM(JPaged(jcfg, jparams, pcfg(JPagedEngineCfg),
                                     JSchedulerCfg(chunk_pages=None))),
                         prompts, max_tokens=12)
    got = scen._run_llm(LLM(PagedServingEngine(
        tcfg, tparams, pcfg(PagedEngineCfg), SchedulerCfg(chunk_pages=None))),
        prompts, max_tokens=12)
    assert got == want


def _drive_checked(llm, conservation_error, reconcile_refs):
    """Tick to idle, holding page conservation and the refcount watchdog
    after every tick (as ``engine_core_scenarios._drive_checked`` does)."""
    eng = llm.engine
    for _ in range(4000):
        if not llm.has_work():
            return
        llm.tick()
        assert conservation_error(eng.accounting_snapshot()) == 0
        wd = reconcile_refs(eng._expected_refs(), eng.backend.pool_refs())
        assert wd.ok, wd.describe()
    raise AssertionError("run never drained")


def test_telemetry_audit_matches_reference(smoke_lm):
    """Telemetry on, the DLZS audit sampling every other tick under
    bounded sparse decode and pool pressure: the audit probe (a decode
    pass that must leave the live pool as it found it) changes no token,
    its recall reports match the reference's, and page conservation and
    the refcount watchdog hold at every tick. In fp32: in bf16 the
    reference's own logits hold exact ties (prompt 45 here) that the
    port's summation order splits one bf16 step apart."""
    import jax.numpy as jnp

    from repro import obs as jobs
    from repro_torch import obs as tobs
    jcfg = dataclasses.replace(smoke_lm[0], dtype=jnp.float32)
    jparams = jlm.init(jax.random.PRNGKey(1), jcfg)
    tparams = convert.to_torch(jax.tree.map(np.asarray, jparams))
    tcfg = convert.model_cfg_from_reference(jcfg)
    prompts = scen._prompts(jcfg, (24, 40, 33, 45))
    runs = {}
    for name, obs, mk in (
            ("jax", jobs, lambda p, s: JLLM(JPaged(jcfg, jparams, p, s),
                                            telemetry=jobs.Telemetry())),
            ("torch", tobs, lambda p, s: LLM(PagedServingEngine(
                tcfg, tparams, p, s), telemetry=tobs.Telemetry()))):
        pkg = JPagedEngineCfg if name == "jax" else PagedEngineCfg
        sch = JSchedulerCfg if name == "jax" else SchedulerCfg
        llm = mk(pkg(max_batch=4, page_size=16, n_pages=10, hot_pages=4,
                     eos_id=-1),
                 sch(chunk_pages=1, prefill_tokens=64, swap=True,
                     decode_hot_width=2))
        llm.engine.auditor = obs.DlzsAuditor(obs.AuditCfg(every_ticks=2))
        handles = [llm.submit(p, max_tokens=16, rid=i)
                   for i, p in enumerate(prompts)]
        _drive_checked(llm, obs.conservation_error, obs.reconcile_refs)
        runs[name] = ([h.tokens for h in handles], llm)
    (want, jllm), (got, tllm) = runs["jax"], runs["torch"]
    assert got == want
    assert tllm.stats()["sched"].preemptions > 0, "pool pressure never hit"
    ja, ta = jllm.engine.auditor, tllm.engine.auditor
    assert ta.runs == ja.runs >= 3
    for j, t in zip(ja.reports, ta.reports):
        assert (t["slot"], t["pages_resident"], t["pages_hot"]) == \
            (j["slot"], j["pages_resident"], j["pages_hot"])
        assert t["recall_min"] == pytest.approx(j["recall_min"], abs=1e-4)


def test_sampled_decode_follows_its_generator(smoke_lm):
    """Non-greedy decode draws on the engine's torch.Generator: the same
    seed gives the same tokens, another seed other tokens, and every
    token lies in the vocabulary. (JAX's PRNG stream cannot be
    reproduced, so the reference's tokens are not the yardstick.)"""
    _, _, tcfg, tparams = smoke_lm
    prompts = scen._prompts(tcfg, (20, 35))

    def sample(seed):
        eng = PagedServingEngine(
            tcfg, tparams, PagedEngineCfg(max_batch=2, n_pages=16,
                                          hot_pages=4, eos_id=-1,
                                          greedy=False, temperature=2.0),
            SchedulerCfg(chunk_pages=1),
            generator=torch.Generator().manual_seed(seed))
        return scen._run_llm(LLM(eng), prompts, max_tokens=12)

    a, b, c = sample(1), sample(1), sample(2)
    assert a == b and a != c
    assert all(0 <= t < tcfg.vocab for v in a.values() for t in v)


def test_from_config_serves_on_cpu_when_asked():
    cfg = tsmoke("olmo_1b")
    llm = LLM.from_config(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(3),
                          engine_cfg=PagedEngineCfg(max_batch=2, n_pages=16,
                                                    hot_pages=4, eos_id=-1))
    h = llm.submit(np.arange(20, dtype=np.int32), max_tokens=4)
    assert len(h.result()) == 4
    assert llm.engine.backend.device.type == "cpu"


@pytest.mark.parametrize("arch,match", [
    ("seamless_m4t_large_v2", "causal decoder-only"),
])
def test_unported_options_raise(arch, match):
    """Every model family is ported now (the spatial backend, the MoE and
    SSM blocks and the cross-attention block were this test's cases
    before); what the paged engine still refuses is what the reference's
    refuses: an encoder-decoder model (tests/test_torch_encdec.py holds
    the other engines' refusals)."""
    with pytest.raises(ValueError, match=match):
        LLM.from_config(tsmoke(arch), device="cpu")


def test_from_config_serves_the_spatial_backend():
    """``backend="spatial"`` builds the sequence-sharded engine over
    ``shards`` shards on the device asked for and serves; a config with
    STAR on is refused, as the reference refuses it."""
    from repro_torch.spatial import SpatialServingEngine
    cfg = dataclasses.replace(tsmoke("olmo_1b"), star=None)
    llm = LLM.from_config(cfg, backend="spatial", shards=2, device="cpu",
                          generator=torch.Generator().manual_seed(3))
    assert isinstance(llm.engine, SpatialServingEngine)
    assert llm.engine.topo.n_shards == 2
    assert llm.engine.backend.device.type == "cpu"
    hs = [llm.submit(np.arange(n, dtype=np.int32), max_tokens=4)
          for n in (20, 70)]
    llm.run_until_done()
    assert [len(h.tokens) for h in hs] == [4, 4]
    assert llm.stats()["pools"]["live"] == 0
    with pytest.raises(ValueError, match="dense-attention"):
        LLM.from_config(tsmoke("olmo_1b"), backend="spatial", device="cpu")


def test_from_config_serves_the_dense_backend():
    """``backend="dense"`` builds the dense slot oracle on the device asked
    for; its tick traces a span, and a one-token request finishes at its
    prefill."""
    from repro_torch import obs as tobs
    from repro_torch.serving import EngineCfg, ServingEngine
    tel = tobs.Telemetry()
    llm = LLM.from_config(tsmoke("chatglm3_6b"), backend="dense",
                          device="cpu", telemetry=tel,
                          generator=torch.Generator().manual_seed(3),
                          engine_cfg=EngineCfg(max_batch=2, max_len=64,
                                               eos_id=-1))
    assert isinstance(llm.engine, ServingEngine)
    assert llm.engine.device.type == "cpu"
    hs = [llm.submit(np.arange(16, dtype=np.int32), max_tokens=n)
          for n in (4, 1, 3)]
    llm.run_until_done()
    assert [len(h.tokens) for h in hs] == [4, 1, 3]
    assert all(h.outcome == "done" for h in hs)
    assert llm.metrics()["requests"] == 3
    assert any(e.get("name") == "tick" for e in tel.tracer.events)


def test_from_config_serves_the_int8_tier():
    """``SchedulerCfg(kv_quant="int8")`` serves (cold pages quantize under
    a bounded hot width); an unknown tier is refused."""
    cfg = tsmoke("olmo_1b")
    pcfg = PagedEngineCfg(max_batch=2, n_pages=16, hot_pages=4, eos_id=-1)
    llm = LLM.from_config(cfg, device="cpu", engine_cfg=pcfg,
                          sched_cfg=SchedulerCfg(chunk_pages=1,
                                                 decode_hot_width=2,
                                                 kv_quant="int8"))
    h = llm.submit(np.arange(50, dtype=np.int32), max_tokens=6)
    assert len(h.result()) == 6
    assert llm.stats()["kv_quant"]["quantize_events"] > 0
    with pytest.raises(ValueError, match="kv_quant"):
        LLM.from_config(cfg, device="cpu", engine_cfg=pcfg,
                        sched_cfg=SchedulerCfg(kv_quant="fp8"))


def test_registry_names_unported_archs():
    """Every architecture resolves; an unknown name raises."""
    assert get_config("olmo_1b").d_model == 2048
    assert get_config("internvl2_26b").embeds_input
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt2")


def test_no_gpu_means_no_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLM.from_config(tsmoke("olmo_1b"))


_PURITY = """
import pkgutil, sys
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    __import__(m.name)
new = ("repro_torch.kvcache.quant", "repro_torch.kvcache.wire",
       "repro_torch.serving.faults", "repro_torch.serving.disagg.transfer",
       "repro_torch.serving.disagg.router", "repro_torch.spatial.engine",
       "repro_torch.core.dr_attention", "repro_torch.core.mrca")
assert all(n in sys.modules for n in new), new
import chip_smoke
sys.path.insert(0, {tools!r})
import torch_profile_prefill, torch_star_drift, torch_decode_forms
import torch_k1_int8, torch_served_logits, torch_grad_norms
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes"))
assert not bad, bad
print("PURE", len([n for n in sys.modules if n.startswith("repro_torch")]))
"""


def test_port_imports_neither_jax_nor_reference():
    out = subprocess.run(
        [sys.executable, "-c",
         _PURITY.format(src=str(ROOT / "src"), root=str(ROOT),
                        tools=str(ROOT / "tools"))],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "PURE" in out.stdout


def test_chip_smoke_phases_rehearse_on_cpu(monkeypatch):
    """The on-card script's phases, run on the CPU at smoke size: every
    request is served, every token is the dense argmax (or a bf16 tie),
    the sparse pass gathers fewer pages than are resident, the prefill
    kernels' checks and the fused-STAR comparison run their control flow,
    the whole-prompt prefill serves with first tokens equal to a STAR
    forward's, and no kernel launches off the card."""
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke as cs
    cfg = tsmoke("olmo_1b")
    gen = torch.Generator().manual_seed(0)
    params = cs.lm.init(cfg, gen, "cpu")
    prompts = cs.make_prompts(cfg, (40, 57, 33, 70), seed=0)
    llm = cs.main_path_llm(cfg, params, n_pages=64, hot_pages=8,
                           past_pages=8, device="cpu", generator=gen)
    run = cs.serve(llm, prompts, 6)
    summary = cs.served_summary(run, cfg.n_layers)
    assert summary["requests"] == 4 and summary["tokens"] == 24
    assert summary["decode_ticks"] > 0 and summary["k1_launches"] == 0
    exact = cs.check_exact(params, cfg, prompts, run["done"])
    assert exact["tokens_checked"] == 24 and exact["exact"] >= 22
    sparse = cs.main_path_llm(cfg, params, n_pages=64, hot_pages=8,
                              past_pages=8, device="cpu", generator=gen,
                              hot_width=2)
    sp = cs.served_summary(cs.serve(sparse, prompts, 4), cfg.n_layers)
    assert sp["pages_gathered_per_tick"] < sp["pages_resident_per_tick"]
    with pytest.raises(SystemExit, match="expected ticks x layers"):
        cs.require_launches(sp, "cpu")
    assert exact["forwards"] == 4 and exact["k4_launches"] == 0
    # phase 6's checks (plain against plain here), phase 7 at T=128: the
    # smoke tiles of 16 with 4-tile chunks, so scanq scans
    cs.check_dlzs("cpu", None, bh=2, t=256, block=128, causal=True, seed=0,
                  timed=False)
    cs.check_sufa("cpu", None, bh=2, t=256, block=128, strict=False, seed=1,
                  timed=False)
    # the mma.sync forms' tiles; K3's count of computed pairs (its bound)
    assert cs.check_dlzs("cpu", None, bh=2, t=64, block=16, causal=True,
                         seed=0, timed=False)["form"] == "mma_sync"
    k3 = cs.check_sufa("cpu", None, bh=2, t=64, block=16, strict=True,
                       seed=1, timed=False, d=64)
    assert k3["form"] == "mma_sync" and 0 < k3["distinct_tiles"] <= 8
    every = torch.tensor([[[0, 1], [0, 1]]])
    assert cs.selected_pairs(every, torch.ones_like(every, dtype=torch.bool),
                             t=32, s=32, block=16) == \
        cs.visible_pairs(32, 32, True)
    cs.check_flash("cpu", None, bh=2, t=200, causal=True, seed=2,
                   timed=False)
    cs.check_flash("cpu", None, bh=2, t=1, causal=True, seed=2, timed=False,
                   d=64)
    # phase 2's K1 check: two calls bit-equal, the split plan reported
    k1 = cs.check_paged_kernel("cpu", "rehearsal", b=2, g=2, r=2, d=64,
                               page=16, w=6, p=16, kv_len=(90, 17), seed=5,
                               timed=False)
    assert k1["n_split"] == 6 and k1["violations"] == 0
    # phase 1's ptxas report names each instantiation
    log = ("ptxas info    : Function properties for _ZN48_GLOBAL__N__8c22_15"
           "_paged_decode_cu_fed0b86b19paged_scores_kernelILi64ELi1ELb1EEEvP"
           "K13__nv_bfloat16\n    16 bytes stack frame, 12 bytes spill stores"
           ", 12 bytes spill loads\n")
    assert cs.ptxas_report(log) == [(
        "paged_scores_kernel<64,1,1>",
        "16 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads")]
    fused = cs.check_fused_star(params, cfg, seed=3, t=128, timed=False)
    assert fused["selection_agreement_min"] == 1.0
    assert len(fused["layers"]) == cfg.n_layers
    # phase 7's edge distance: keep-th 3.0 against 2.96875 (2 bf16 steps)
    bmax = torch.tensor([[[4.0, 3.0, 2.96875, cs.sads.NEG_INF]]])
    assert cs.edge_gap_steps(bmax, 2, 5.0).tolist() == [[2.0]]
    # phase 4's second oracle computes K4's function in the plain form
    q, k, v = torch.randn(3, 4, 40, 16).bfloat16()
    torch.testing.assert_close(
        cs.plain_flash(q, k, v, causal=True, scale=0.25).float(),
        cs.ops.flash(q, k, v, causal=True, scale=0.25).float(),
        atol=2e-2, rtol=2e-2)
    assert len(exact["inexact"]) == 24 - exact["exact"]
    whole_prompts = cs.make_prompts(cfg, (40, 70, 33), seed=4)
    wllm, wrun, whole = cs.serve_whole_prompt(cfg, params, whole_prompts, 4,
                                              device="cpu", generator=gen)
    assert whole["requests"] == 3 and whole["prefill_calls"] == 4
    assert whole["prefill_widths"][1:] == [64, 128, 64]
    first = cs.check_first_tokens(params, cfg, whole_prompts, wrun["done"],
                                  wllm.engine.backend.pcfg.bucket_pow2)
    assert first["first_tokens_checked"] == 3 and first["exact"] == 3
    with pytest.raises(SystemExit, match="expected prefill calls x layers"):
        cs.require_prefill_launches(whole, "cpu")
    # the smoke config's STAR tiles of 16 take the mma.sync forms
    assert whole["expected_wgmma_launches"] == 0
    # phase 2's int8 case: half the slots marked, all-False = the fp form
    k1q = cs.check_paged_int8("cpu", "rehearsal", b=2, g=2, r=2, d=64,
                              page=16, w=6, p=16, kv_len=(90, 17), seed=5,
                              timed=False)
    assert k1q["all_false_bit_equal_fp"] and 0 < k1q["slots_marked"] < 8
    assert k1q["violations_fp_form"] > 0 \
        and k1q["violations_other_page_scale"] > 0
    q, k, v, phys, logical, kvl = cs.paged_inputs(2, 2, 1, 64, 16, 6, 16,
                                                  (90, 17), 5, "cpu")
    bytes_, _ = cs.int8_work(q, k, phys, logical, kvl,
                             torch.zeros_like(phys, dtype=torch.bool))
    assert bytes_ == cs.paged_work(q, k, phys, kvl)[0] + phys.numel()
    # phase 9: the pair equals one instance token for token, the int8
    # tier is quantized and read, a lost hop recovers by recompute
    disagg = cs.check_disagg(cfg, params, whole_prompts, 8, device="cpu",
                             generator=gen, n_pages=64, hot_pages=8,
                             hot_width=4,
                             tier_prompt=cs.make_prompts(cfg, (160,), 5)[0])
    pair, read = disagg["pair"], disagg["tier_read"]
    assert disagg["tokens_equal_single"] and pair["transfers"] == 3
    assert pair["quantize_events_decode_side"] > 0
    assert pair["prefill_calls"] == 3 and pair["k1_launches"] == 0
    assert disagg["faulted"]["transfer_faults"] == 1
    assert read["transfers"] == 2 and read["int8_slots_read_prefill_side"] \
        + read["int8_slots_read_decode_side"] > 0
    assert disagg["tier_read_tokens_equal_single"]
    assert 0 < read["expected_k1_int8_launches"] \
        < read["expected_k1_launches"]
    assert pair["expected_k1_int8_launches"] == 0
    with pytest.raises(SystemExit, match="expected decode ticks x layers"):
        cs.require_disagg_launches(pair, "cpu")


def test_chip_smoke_model_phases_rehearse_on_cpu(monkeypatch):
    """Phases 10-12 on the CPU at smoke size: ChatGLM3's smoke config
    served with STAR (first tokens equal a STAR forward's), in the
    exact-parity setting and through the dense engine (every token the
    dense argmax or a bf16 tie), and the depth-cut configs, star_paper
    also with K3's element mask. The launch checks, which the CPU cannot
    meet, are recorded instead of run; their expectations are held."""
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke as cs
    held = []
    for name in ("require_launches", "require_prefill_launches",
                 "require_k4", "require_dense_launches"):
        monkeypatch.setattr(cs, name, lambda summary, tag, name=name:
                            held.append((name, tag, summary)))
    gen = torch.Generator().manual_seed(0)
    glm = cs.check_chatglm(tsmoke("chatglm3_6b"), "cpu", gen,
                           lengths=(32, 64, 48), max_tokens=4)
    assert glm["star"]["first_tokens_checked"] == 3
    assert glm["star"]["exact"] + glm["star"]["bf16_ties"] == 3
    assert glm["fused"]["selection_agreement_min"] == 1.0
    assert glm["fused"]["T"] == 64 and glm["fused"]["layers_checked"] == [0]
    for run in (glm["exact"], glm["dense"]):
        assert run["tokens_checked"] == 12
        assert run["exact"] + run["bf16_ties"] == 12
    assert glm["star"]["expected_prefill_launches"] == \
        glm["star"]["prefill_calls"] * 2 > 0
    assert glm["exact"]["expected_prefill_launches"] == 0
    assert glm["exact"]["expected_flash_launches"] == \
        glm["exact"]["prefill_calls"] * 2
    assert glm["dense"]["expected_flash_launches"] == 3 * 2
    assert glm["dense"]["decode_ticks"] > 0
    cut = cs.check_cut_config("star_paper", tsmoke("star_paper"), "cpu",
                              gen, layers=2, prompt_len=128, max_tokens=3,
                              elementwise_too=True)
    elem = cut["star_elementwise"]
    assert elem["expected_sufa_elementwise_launches"] == \
        elem["prefill_calls"] * 2 and elem["expected_sufa_wgmma_launches"] \
        == 0 and elem["tokens"] == 3 and elem["exact"] == 1
    sc2 = cs.check_cut_config("starcoder2_15b", tsmoke("starcoder2_15b"),
                              "cpu", gen, layers=1, prompt_len=64,
                              max_tokens=3)["star"]
    assert sc2["expected_launches"] == sc2["decode_ticks"] > 0
    assert {name for name, _, _ in held} == {
        "require_launches", "require_prefill_launches", "require_k4",
        "require_dense_launches"}
    # phase 6's element-mask case (plain against plain here)
    k3 = cs.check_sufa("cpu", None, bh=2, t=256, block=128, strict=True,
                       seed=1, timed=False, elementwise=True)
    assert k3["form"] == "wgmma" and 0 <= k3["sphere_dropped_share"] < 1
    assert k3["mask_elements_differ_default_gemm_share"] == 0.0
    # phase 6's cases at phases 10-12's 32 heads
    k3 = cs.check_sufa("cpu", None, bh=32, t=256, block=128, strict=False,
                       seed=2, timed=False, elementwise=True)
    assert k3["BH"] == 32 and k3["form"] == "wgmma"


def test_chip_smoke_moe_phases_rehearse_on_cpu(monkeypatch):
    """Phases 14-15 on the CPU at smoke size: OLMoE's smoke config served
    with STAR at the reference's capacity (first tokens equal a STAR
    forward's; the dropped share read per prefill), dropless with
    ``star=None`` through the paged and the dense engines (every token the
    dense argmax or a bf16 tie; nothing dropped), the chunked main path,
    and the MoE-share profile's control flow (no device time here); then
    Grok's smoke config at one layer. The launch checks, which the CPU
    cannot meet, are recorded instead of run."""
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke as cs
    held = []
    for name in ("require_launches", "require_prefill_launches",
                 "require_k4", "require_dense_launches"):
        monkeypatch.setattr(cs, name, lambda summary, tag, name=name:
                            held.append((name, tag, summary)))
    gen = torch.Generator().manual_seed(0)
    cfg = tsmoke("olmoe_1b_7b")
    olmoe = cs.check_olmoe(cfg, "cpu", gen, lengths=(32, 64, 48),
                           max_tokens=4, main_lengths=(40, 57, 33, 70),
                           main_tokens=4, n_pages_main=64, hot_main=8)
    star, exact = olmoe["star"], olmoe["exact"]
    assert star["first_tokens_checked"] == 3
    assert star["exact"] + star["bf16_ties"] == 3
    # the pool probe (one page) and the three prompts, bucketed
    assert star["prefill_tokens"] == [16, 32, 64, 64]
    assert len(star["dropped_share_per_prefill"]) == 4
    assert exact["dropped_share_per_prefill"] == [0.0] * 4
    assert exact["decode_choices_dropped"] == 0
    for run in (exact, olmoe["dense"]):
        assert run["tokens_checked"] == 12
        assert run["exact"] + run["bf16_ties"] == 12
    main = olmoe["main"]
    assert main["requests"] == 4 and main["tokens"] == 16
    assert main["decode_choices"] > 0 and main["prefill_tokens"]
    shares = olmoe["shares"]
    assert shares["prefill"]["tokens"] == 64
    assert shares["decode"]["moe_share"] is None
    # 2 layers x (w1, w2, w3) of 16 virtual experts [64, 16]
    assert shares["decode"]["expert_weight_bytes"] == 2 * 3 * 16 * 64 * 16 * 2
    with pytest.raises(SystemExit, match="dropped at dropless"):
        cs.require_dropless(star, "cpu")
    grok = cs.check_grok(tsmoke("grok_1_314b"), "cpu", gen, layers=1,
                         prompt_len=64, max_tokens=3)
    assert grok["star"]["first_tokens_checked"] == 1
    assert grok["exact"]["tokens_checked"] == 3
    assert grok["star"]["expected_launches"] == grok["star"]["decode_ticks"]
    assert {name for name, _, _ in held} == {
        "require_launches", "require_prefill_launches", "require_k4",
        "require_dense_launches"}
    # phase 2's K1 check at Grok's group (plain against plain here)
    k1 = cs.check_paged_kernel("cpu", "rehearsal_r6", b=1, g=8, r=6, d=128,
                               page=16, w=9, p=16, kv_len=(130,), seed=9,
                               timed=False)
    assert k1["violations"] == 0 and k1["shape"] == [1, 8, 6, 128]


def test_chip_smoke_recurrent_phases_rehearse_on_cpu(monkeypatch):
    """Phases 16-17 on the CPU at smoke size: Jamba's smoke config cut to
    its first 5 blocks, as the card cuts the published one, through the
    dense engine with STAR (first tokens equal a STAR forward's) and
    dropless (every token by the MoE rule, nothing dropped), the paged
    engine's refusal and the prefill split's control flow; xLSTM's smoke
    config with every token the plain forward's argmax or a bf16 tie and
    the sLSTM loop's share of a prefill. The launch checks, which the CPU
    cannot meet, are recorded instead of run; their expectations are
    held; xLSTM's, no kernel at all, runs on the CPU too."""
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke as cs
    real_dense_check = cs.require_dense_launches
    held = []
    for name in ("require_k4", "require_dense_launches"):
        monkeypatch.setattr(cs, name, lambda summary, tag, name=name:
                            held.append((name, tag, summary)))
    gen = torch.Generator().manual_seed(0)
    jamba = cs.check_jamba(tsmoke("jamba_1_5_large_398b"), "cpu", gen,
                           lengths=(32, 64, 48), max_tokens=4)
    star, exact = jamba["star"], jamba["exact"]
    assert jamba["tiles"]["sufa"]["BH"] == 4
    assert star["first_tokens_checked"] == 3 and star["exact"] == 3
    # one attention layer of five: K2 = K3 = prefill calls, no K4
    assert star["prefill_calls"] == 3
    assert star["expected_prefill_launches"] == 3
    assert star["expected_flash_launches"] == 0
    assert exact["expected_flash_launches"] == 3
    assert exact["expected_prefill_launches"] == 0
    assert star["prefill_tokens"] == [32, 64, 48]
    assert exact["dropped_share_per_prefill"] == [0.0] * 3
    assert exact["tokens_checked"] == 12 and exact["rule"] == "moe"
    assert exact["exact"] + exact["bf16_ties"] == 12
    # three forwards a request run K4 at the attention layer: K4's, the
    # hybrid one and K4's one page longer (the recurrent blocks' rounding)
    assert exact["expected_k4_launches"] == 3 * 3
    assert all(r >= 0 for r in exact["routing_forced"]["rounding"])
    assert len(exact["routing_forced"]["max_gap"]) == 2
    assert jamba["split"]["star"]["split"] is None
    with pytest.raises(SystemExit, match="expected prefill calls x layers"):
        real_dense_check(star, "cpu")
    xl = cs.check_xlstm(tsmoke("xlstm_125m"), "cpu", gen, lengths=(17, 40),
                        max_tokens=4)
    run, low = xl["served"]["fp32"], xl["served"]["bf16"]
    assert run["tokens_checked"] == 8 and run["exact"] + run["bf16_ties"] \
        == 8
    assert run["expected_k4_launches"] == 0
    assert low["tokens_checked"] == 8 and low["exact_fp32_forward"] >= 6
    assert len(low["spread_steps"]) == 2
    for r in (run, low):
        assert r["expected_flash_launches"] == 0 and not any(
            r["launches"].values())
        real_dense_check(r, "cpu")
    assert 0 < xl["prefill"]["slstm_scan_share"] < 1
    assert {name for name, _, _ in held} == {"require_k4",
                                             "require_dense_launches"}


def test_chip_smoke_family_phases_rehearse_on_cpu(monkeypatch):
    """Phases 18-19 on the CPU at smoke size: InternVL2's smoke config
    served through the paged engine with STAR (first tokens equal a STAR
    forward's) and with ``star=None`` (every token the dense argmax or a
    bf16 tie), then one prefill from patch embeddings and two decode
    steps; SeamlessM4T's smoke config through ``lm.prefill`` and
    ``lm.decode_step`` over two frame counts, with STAR (first tokens) and
    with ``star=None`` (every token by phase 4's rule, the frames in each
    oracle forward). The launch checks, which the CPU cannot meet, are
    recorded instead of run; their expectations are held. Then phase 6's
    new forms (plain against plain here)."""
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke as cs
    real_counts = cs.require_counts
    held = []
    for name in ("require_launches", "require_prefill_launches",
                 "require_k4", "require_counts", "require_dense_launches"):
        monkeypatch.setattr(cs, name, lambda summary, tag, name=name:
                            held.append((name, tag, summary)))
    gen = torch.Generator().manual_seed(0)
    ivl = cs.check_internvl2(tsmoke("internvl2_26b"), "cpu", gen,
                             lengths=(32, 64, 48), max_tokens=4,
                             embeds_len=64, steps=2)
    assert ivl["star"]["first_tokens_checked"] == 3
    assert ivl["star"]["expected_prefill_launches"] == \
        ivl["star"]["prefill_calls"] * 2 > 0
    assert ivl["star"]["expected_launches"] == \
        ivl["star"]["decode_ticks"] * 2 > 0
    exact = ivl["exact"]
    assert exact["tokens_checked"] == 12
    assert exact["exact"] + exact["bf16_ties"] == 12
    assert exact["served_ties"] == 0
    assert exact["expected_k4_launches"] == 3 * 2
    # the same run with K1's plain version (on the CPU both are the plain
    # version, so the tokens agree)
    plain = ivl["plain_k1"]
    assert plain["tokens_checked"] == 12 and plain["k1_launches"] == 0
    assert plain["tokens_equal_k1"] == 12
    assert plain["first_difference"] == [None] * 3
    dense = ivl["dense"]
    assert dense["tokens_checked"] == 12 and dense["decode_ticks"] > 0
    assert dense["expected_flash_launches"] == 3 * 2
    assert 0 <= dense["tokens_equal_paged"] <= 12
    emb = ivl["embeds"]
    assert emb["tokens"] == 64 and len(emb["tokens_out"]) == 3
    assert emb["first_token_exact"] + emb["first_token_bf16_tie"] == 1
    assert emb["expected_launches"] == {"dlzs_block": 2, "sufa": 2,
                                        "flash": 0, "paged_decode": 0}
    sm = cs.check_seamless(tsmoke("seamless_m4t_large_v2"), "cpu", gen,
                           frames=(64, 32), prompt_len=32, steps=3)
    star, dense = sm["star"], sm["exact"]
    assert star["frames"] == [64, 32] and star["decode_steps"] == 2 * 3
    assert star["first_tokens_checked"] == 4 and star["tokens"] == 4 * 4
    # 2 prefills x (2 encoder + 2 decoder self-attention layers) of K2/K3,
    # 2 x 2 cross-attention layers of K4, the encoder's and the cross
    # launches non-causal
    assert star["expected_launches"] == {
        "dlzs_block": 8, "sufa": 8, "flash": 4, "dlzs_block/noncausal": 4,
        "sufa/noncausal": 4, "flash/noncausal": 4, "paged_decode": 0}
    assert dense["expected_launches"] == {
        "dlzs_block": 0, "sufa": 0, "flash": 12, "flash/noncausal": 8,
        "paged_decode": 0}
    assert dense["tokens_checked"] == 16
    assert dense["exact"] + dense["bf16_ties"] == 16
    assert dense["expected_k4_launches"] == 4 * 6
    assert {name for name, _, _ in held} == {
        "require_launches", "require_prefill_launches", "require_k4",
        "require_counts", "require_dense_launches"}
    with pytest.raises(SystemExit, match="launches"):
        real_counts(star, "cpu")
    # phase 6's new forms: non-causal K2 and K3 at d 64, K4 non-causal at
    # T != S (a ragged S too), K1 at InternVL2's group
    k2 = cs.check_dlzs("cpu", None, bh=2, t=256, block=128, causal=False,
                       seed=1, timed=False, d=64)
    assert k2["d"] == 64 and not k2["causal"]
    k3 = cs.check_sufa("cpu", None, bh=2, t=256, block=128, strict=False,
                       seed=2, timed=False, d=64, causal=False)
    assert not k3["causal"] and k3["violations"] == 0
    k4 = cs.check_flash("cpu", None, bh=2, t=32, s=100, causal=False,
                        seed=3, timed=False, d=64)
    assert (k4["T"], k4["S"]) == (32, 100)
    k1 = cs.check_paged_kernel("cpu", "rehearsal_internvl2", b=3, g=8, r=6,
                               d=128, page=16, w=9, p=32,
                               kv_len=(40, 130, 77), seed=10, timed=False)
    assert k1["violations"] == 0


@pytest.mark.parametrize("gaps,served,held", [
    ((1, 3), None, "tie"),       # 1 step below K4's top: a tie
    ((2, 1), None, "tie"),       # 2 below K4's, 1 below the plain top
    ((2, 2), None, None),        # phase 4's rule alone refuses it
    ((2, 2), 1, "served"),       # the served logits put K4's top 1 below
    ((2, 2), 2, None),           # ... 2 below
    ((3, 3), 0, None),           # 3 below K4's top: no witness helps
])
def test_chip_smoke_phase4_rule_and_served_witness(monkeypatch, gaps,
                                                   served, held):
    """``chip_smoke.check_exact`` on crafted logits (top 1.0, so one bf16
    step is 1/128): the second served token ``gaps`` steps below the top
    of the K4 forward and of the plain form's. Phase 4's rule: a tie
    within 1 step of K4's top, or 2 where the plain form puts it within
    1. With ``served_logits`` (phase 18's paged runs) a token 2 below
    K4's top is a tie also where the served logits put K4's top within 1
    step of their own; anything further fails, and the first token (the
    prefill's, no recorded row) is never witnessed."""
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke as cs
    cfg = tsmoke("internvl2_26b")
    real = cs.ops.flash

    def logits(gap):
        x = torch.full((cfg.vocab,), -4.0)
        x[0] = 1.0
        x[2] = 1.0 - gap / 128
        return x

    def forward(params, c, batch):
        gap = gaps[0 if cs.ops.flash is real else 1]
        rows = batch["tokens"].shape[1]
        return logits(gap).expand(1, rows, cfg.vocab).clone()
    monkeypatch.setattr(cs.lm, "forward", forward)
    params = {"embed": torch.zeros(1)}
    prompt = np.arange(4, dtype=np.int32)
    rows = None
    if served is not None:
        # the served path's own logits: token 2 on top, K4's top (token
        # 0) ``served`` steps below
        row = torch.full((cfg.vocab,), -4.0)
        row[2], row[0] = 1.0, 1.0 - served / 128
        rows = [torch.stack([torch.full((cfg.vocab,), float("nan")), row])]
    done = [[0, 2]]
    if held is None:
        with pytest.raises(SystemExit, match="beyond a bf16 tie"):
            cs.check_exact(params, cfg, [prompt], done, served_logits=rows)
        return
    out = cs.check_exact(params, cfg, [prompt], done, served_logits=rows)
    assert out["tokens_checked"] == 2 and out["exact"] == 1
    assert out["bf16_ties"] == (held == "tie")
    assert out.get("served_ties", 0) == (held == "served")
    if held == "served":   # no recorded row (the prefill's token): no tie
        with pytest.raises(SystemExit, match="beyond a bf16 tie"):
            cs.check_exact(params, cfg, [prompt], [[2, 2]],
                           served_logits=rows)


def test_served_logits_tool_rehearses_on_cpu(monkeypatch):
    """``tools/torch_served_logits.py`` at InternVL2's smoke config on the
    CPU, where K1's wrapper is its plain version: both runs serve the
    same tokens with the same logits, and the served logits equal the
    hybrid forward's on every decoded row (the CPU rounds no GEMM by its
    shape)."""
    monkeypatch.syspath_prepend(str(ROOT / "tools"))
    import torch_served_logits as tool
    rows = tool.compare(tsmoke("internvl2_26b"), torch.device("cpu"),
                        (32, 64, 48), 4)
    assert rows[0]["tokens_equal"] == 12
    assert rows[0]["tokens_k1"] == rows[0]["tokens_plain_k1"]
    for row in rows[1:]:
        assert len(row["gap_k4"]) == len(row["served_vs_k4"]) == 4
        assert np.isnan(row["served_vs_k4"][0])   # the prefill's row
        assert row["k1_vs_plain_k1"][1:] == [0.0] * 3
        assert row["served_vs_hybrid"][1:] == [0.0] * 3


def test_chip_smoke_moe_token_rule(monkeypatch):
    """``chip_smoke.moe_token_rule`` on crafted logits (top 1.0, so one
    bf16 step is 1/128): phase 4's rule with the forward that rounds as
    served in K4's place. A token 40 steps below its top (80 below K4's)
    fails; 1 step below is a tie; 2 below is a tie only where a pure form
    puts it within 1 of its own top; 3 below fails although both pure
    forms' argmax is the token. The pure forms' disagreement is read on
    the row where both agree with the served token (margins of 3 and 5
    steps over the plain runner-up: 2)."""
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke as cs
    assert (cs.TIE_STEPS, cs.PLAIN_TIE_STEPS) == (1, 2)
    step = 1 / 128

    def logits(gap, runner=None):
        """Token 2 served ``gap`` steps below token 0 (above it where
        negative); or, with ``runner``, token 0 served and token 1 the
        runner-up ``runner`` steps below."""
        x = torch.full((8,), -4.0)
        x[0] = 1.0
        if runner is not None:
            x[1] = 1.0 - runner * step
        elif gap < 0:
            x[0], x[2] = 1.0 + gap * step, 1.0
        else:
            x[2] = 1.0 - gap * step
        return x
    rows = [  # (hybrid, K4, plain) gaps
        ((None, 4), (None, 3), (None, 5)), (40, 80, 40), (1, 6, 5),
        (2, 6, 1), (2, 4, 3), (3, -1, -1)]
    hybrid, k4, plain = (torch.stack([
        logits(r[j]) if not isinstance(r[j], tuple) else logits(*r[j])
        for r in rows]) for j in range(3))
    served = torch.tensor([0, 2, 2, 2, 2, 2])
    rule = cs.moe_token_rule(hybrid, k4, plain, served)
    assert rule["exact"].tolist() == [True] + [False] * 5
    assert rule["tie"].tolist() == [False, False, True, True, False, False]
    assert rule["steps"].tolist() == [0.0, 40.0, 1.0, 2.0, 2.0, 3.0]
    assert rule["pure_forms_disagree_steps"] == 2.0


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card():
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
