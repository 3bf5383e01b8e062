"""The example scripts of the PyTorch port (``examples/torch_*.py``), the
port's ``serving/scenarios.py`` and ``tools/torch_trace_summary.py``, run
on the CPU.

Each twin draws its inputs from numpy or a seeded ``torch.Generator``, so
its numbers differ from the JAX script's; each is held against the
reference's functions on the twin's own inputs (weights converted with
``repro_torch.convert``): the quickstart's error at 2e-5, the served
tokens of the two serving twins equal to the JAX paged engine's in fp32
(at 2 layers for star_paper), the first training loss within 1e-3 of the
reference's ``lm.loss_fn``, the ring's output at 2e-5 of the reference's
dense attention and the MRCA numbers equal.
"""

import dataclasses
import importlib.util
import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import engine_core_scenarios as scen  # noqa: E402
from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.core import mrca as jmrca  # noqa: E402
from repro.core import opcount as jop  # noqa: E402
from repro.data import SyntheticLM  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import LLM as JLLM  # noqa: E402
from repro.serving import PagedEngineCfg as JPagedEngineCfg  # noqa: E402
from repro.serving import SchedulerCfg as JSchedulerCfg  # noqa: E402
from repro.serving import scenarios as jscen  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.configs import get_smoke_config as tsmoke  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serving import (LLM, PagedEngineCfg,  # noqa: E402
                                 PagedServingEngine, SchedulerCfg)
from repro_torch.serving import scenarios as tscen  # noqa: E402

jstar = importlib.import_module("repro.core.star_attention")
REPO = pathlib.Path(__file__).resolve().parents[1]


def _load(path: str):
    spec = importlib.util.spec_from_file_location(
        pathlib.Path(path).stem, REPO / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_params(tparams):
    return jax.tree.map(jnp.asarray, convert.to_numpy(tparams))


# -- serving/scenarios.py -------------------------------------------------------

def test_scenarios_equal_to_the_reference():
    for kw in (dict(n=4, length=33), dict(n=2, length=7, seed=11)):
        for a, b in zip(tscen.uniform_prompts(512, **kw),
                        jscen.uniform_prompts(512, **kw)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype == np.int32
    kw = dict(long_tokens=500, long_max_tokens=16, n_short=5,
              short_tokens=24, short_max_tokens=16, seed=3)
    got, want = tscen.longctx_mix(512, **kw), jscen.longctx_mix(512, **kw)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        np.testing.assert_array_equal(g["prompt"], w["prompt"])
        assert (g["max_tokens"], g["sla"]) == (w["max_tokens"], w["sla"])
    assert tscen.SLA_CYCLE == jscen.SLA_CYCLE


# -- the example twins ----------------------------------------------------------

def test_quickstart_twin():
    qs = _load("examples/torch_quickstart.py")
    out = qs.main(["--device", "cpu"])
    q, k, v = (jnp.asarray(x) for x in qs.inputs())
    cfg = jstar.STARConfig(**dataclasses.asdict(qs.CFG))
    ref = jstar.dense_attention(q, k, v, causal=False)
    star = jstar.star_attention(q, k, v, cfg, causal=False)
    err = float(jnp.linalg.norm(star - ref) / jnp.linalg.norm(ref))
    assert out["rel_err"] == pytest.approx(err, abs=2e-5)
    assert out["tiles_kept"] == cfg.keep_blocks(qs.S)
    assert out["lz_bytes_ratio"] == 0.25
    fa = jop.fa2_ops(qs.T, qs.S, qs.D, 128).equivalent_adds
    st = jop.star_total_ops(qs.T, qs.S, qs.D, block_kv=128, k_ratio=0.2,
                            n_segments=qs.S // 128, rho=0.4,
                            strict=False).equivalent_adds
    assert (out["fa2_equivalent_adds"], out["star_equivalent_adds"],
            out["reduction"]) == (fa, st, 1 - st / fa)


def test_serve_star_twin_tokens_equal_the_reference_engine():
    """star_paper's smoke config cut to 2 layers, in fp32, 4 requests on
    the shared system page: every request served, the tokens and the
    pool's numbers equal the JAX paged engine's on the same weights and
    prompts."""
    ss = _load("examples/torch_serve_star.py")
    tcfg = ss.model_cfg(2, "float32")
    out = ss.main(["--device", "cpu"], cfg=tcfg, requests=4)
    assert out["requests"] == 4 and out["shared_hits"] > 0
    tparams = tlm.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    jcfg = dataclasses.replace(jsmoke("star_paper"), n_layers=2,
                               dtype=jnp.float32)
    ecfg, scfg = ss.engine_cfgs(tcfg)
    llm = JLLM.from_config(
        jcfg, backend="paged", params=_jax_params(tparams),
        engine_cfg=JPagedEngineCfg(**dataclasses.asdict(ecfg)),
        sched_cfg=JSchedulerCfg(**dataclasses.asdict(scfg)))
    handles = [llm.submit(p, max_tokens=16) for p in ss.prompts(tcfg, 4)]
    llm.run_until_done()
    assert out["outputs"] == [h.tokens for h in handles]
    pool = llm.stats()["pool"]
    assert (out["peak_live"], out["shared_hits"], out["evictions"]) == (
        pool.peak_live, pool.shared_hits, pool.evictions)


def test_train_star_lm_twin(tmp_path):
    """--tiny, 12 steps of 4 x 64: the loss falls, and the first loss is
    the reference's ``lm.loss_fn`` on the same weights and batch (1e-3)."""
    tr = _load("examples/torch_train_star_lm.py")
    out = tr.main(["--device", "cpu", "--tiny", "--steps", "12", "--seq",
                   "64", "--batch", "4", "--ckpt", str(tmp_path / "ck")])
    assert out["last_loss"] < out["first_loss"]
    assert [s for s, _ in out["history"]] == [0, 9]
    jcfg = dataclasses.replace(jsmoke("star_paper"), d_model=128,
                               n_layers=2, n_heads=4, n_kv=4, d_ff=256)
    assert out["n_params"] == sum(x.size for x in jax.tree.leaves(
        jax.eval_shape(lambda: jlm.init(jax.random.PRNGKey(0), jcfg))))
    tparams = tr.init_params(tr.model_cfg(tiny=True), "cpu")
    batch = {k: jnp.asarray(v) for k, v in SyntheticLM(
        vocab=jcfg.vocab, seq=64, global_batch=4).batch(0).items()}
    loss, _ = jlm.loss_fn(_jax_params(tparams), jcfg, batch)
    assert out["first_loss"] == pytest.approx(float(loss), abs=1e-3)


def test_spatial_longctx_twin_tokens_equal_the_reference_engine():
    """One pool refuses the 500-token prompt with the reference's message;
    the 4-shard spatial engine serves the mix with the tokens of a JAX
    paged engine large enough to hold it (fp32, STAR off: both exact)."""
    sl = _load("examples/torch_spatial_longctx.py")
    tcfg = sl.model_cfg("float32")
    out = sl.main(["--device", "cpu"], cfg=tcfg)
    tparams = tlm.init(tcfg, torch.Generator().manual_seed(0), "cpu")
    jcfg = dataclasses.replace(jsmoke("olmo_1b"), star=None, head_dim=64,
                               dtype=jnp.float32)
    jparams = _jax_params(tparams)
    mix = jscen.longctx_mix(jcfg.vocab, long_tokens=500, long_max_tokens=16,
                            n_short=3, short_tokens=24, short_max_tokens=16)
    single = JLLM.from_config(jcfg, backend="paged", params=jparams,
                              engine_cfg=JPagedEngineCfg(**dataclasses.asdict(
                                  sl.single_pool_cfg())))
    with pytest.raises(ValueError) as refused:
        single.submit(mix[0]["prompt"], max_tokens=16)
    assert out["refused"] == str(refused.value)
    big = JLLM.from_config(
        jcfg, backend="paged", params=jparams,
        engine_cfg=JPagedEngineCfg(max_batch=4, page_size=sl.PAGE,
                                   n_pages=64, hot_pages=48, eos_id=-1),
        sched_cfg=JSchedulerCfg(chunk_pages=2))
    handles = [big.submit(**r) for r in mix]
    big.run_until_done()
    assert out["outputs"] == [h.tokens for h in handles]
    assert out["requests"] == 4 and len(out["outputs"][0]) == 16


def test_spatial_ring_demo_twin():
    rd = _load("examples/torch_spatial_ring_demo.py")
    out = rd.main(["--device", "cpu"])
    q, k, v = rd.inputs()
    ref = np.asarray(jstar.dense_attention(*map(jnp.asarray, (q, k, v)),
                                           causal=True))
    got = rd.dr_attention(*map(torch.from_numpy, (q, k, v)),
                          n_shards=rd.N, causal=True).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    assert out["max_abs_err"] <= 2e-5
    sim = jmrca.simulate(rd.N)
    assert (out["max_chunks_stored"], out["link_conflicts"]) == (
        sim.max_chunks_stored, sim.link_conflicts) and sim.link_conflicts == 0
    assert out["mrca_latency_ns"] == jmrca.schedule_cost(
        jmrca.mrca_schedule(rd.N))["latency_ns"]
    assert out["naive_ring_latency_ns"] == jmrca.schedule_cost(
        jmrca.naive_ring_schedule(rd.N))["latency_ns"]


_PURITY = """
import importlib.util, pathlib, sys
for path in sys.argv[1:]:
    spec = importlib.util.spec_from_file_location(pathlib.Path(path).stem,
                                                  path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes"))
assert not bad, bad
print("PURE")
"""


def test_twins_import_neither_jax_nor_reference():
    files = sorted(str(p) for p in (REPO / "examples").glob("torch_*.py"))
    files.append(str(REPO / "tools" / "torch_trace_summary.py"))
    assert len(files) == 6
    out = subprocess.run([sys.executable, "-c", _PURITY, *files],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "PURE" in out.stdout


def test_twins_refuse_a_missing_gpu():
    """No twin falls back to the CPU: without ``--device cpu`` they ask
    for the GPU, and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    for path in ("examples/torch_quickstart.py",
                 "examples/torch_spatial_ring_demo.py"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _load(path).main([])


# -- tools/torch_trace_summary.py -----------------------------------------------

def test_torch_trace_summary_tool(tmp_path, capsys):
    """``test_obs.test_trace_summary_tool``'s criteria over the port's
    tracer."""
    tool = _load("tools/torch_trace_summary.py")
    tr = tobs.Tracer()
    with tr.span("tick"):
        with tr.span("phase.decode"):
            pass
    path = str(tmp_path / "t.jsonl")
    tr.export_jsonl(path)
    assert tool.main([path]) == 0
    out = capsys.readouterr().out
    assert "1 ticks" in out and "decode" in out
    assert tool.main([]) == 2


def test_torch_trace_summary_accounting(tmp_path, capsys):
    """``test_obs_accounting.test_debug_bundle_and_accounting_table``'s
    table criteria over a debug bundle of the port's paged engine driven
    through the reference's preempt/swap pressure scenario."""
    tool = _load("tools/torch_trace_summary.py")
    cfg = dataclasses.replace(tsmoke("olmo_1b"), star=None)
    params = tlm.init(cfg, torch.Generator().manual_seed(1), "cpu")
    llm = LLM(PagedServingEngine(cfg, params, PagedEngineCfg(
        max_batch=4, page_size=16,
        n_pages=scen.BACKEND_PARAMS["paged"]["pressure_pages"], hot_pages=4,
        recent_pages=2, eos_id=-1), SchedulerCfg(
        chunk_pages=1, prefill_tokens=64, swap=True)),
        telemetry=tobs.Telemetry({"backend": "paged"}))
    for i, p in enumerate(scen._prompts(cfg, scen.PRESSURE_LENGTHS)):
        llm.submit(p, max_tokens=20, rid=i)
    llm.run_until_done()
    out = llm.debug_bundle(str(tmp_path / "bundle"))
    acct = json.loads((pathlib.Path(out) / "accounting.json").read_text())
    assert tobs.conservation_error(acct) == 0
    assert tool.main(["--accounting", out]) == 0
    table = capsys.readouterr().out
    assert "pages by state" in table
    assert "conservation err : 0" in table
    assert "swap traffic" in table and "out:" in table
    assert tool.main(["--accounting"]) == 2
