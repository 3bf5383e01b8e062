"""Port parity: the dense slot engine (``repro_torch.serving.engine``) and
the dense-cache decode it runs, against ``repro.serving.engine`` and
``repro.models``.

* ``core.star_attention.star_decode``, ``attention.apply_decode`` (grouped
  GQA over the dense cache, written in place) and ``lm.decode_step``
  against their JAX twins on the same numpy inputs: 2e-5 in fp32, 2e-2
  scaled by magnitude in bf16.
* The engine's greedy tokens equal the JAX ``ServingEngine``'s at smoke
  size in fp32, with and without STAR, through the ``LLM`` front door.
* The port's paged ``LLM`` equals the port's own dense oracle on the
  conformance prompts (``engine_core_scenarios``), as the reference's
  conformance suite holds its paged engine to its dense one.
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

import engine_core_scenarios as scen  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import LLM as JLLM  # noqa: E402
from repro.serving import EngineCfg as JEngineCfg  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
tstar = importlib.import_module("repro_torch.core.star_attention")
from repro_torch.models import attention as tattention  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serving import (LLM, EngineCfg, PagedEngineCfg,  # noqa: E402
                                 PagedServingEngine, SchedulerCfg,
                                 ServingEngine)
from repro_torch.tree import tree_items  # noqa: E402

jstar = importlib.import_module("repro.core.star_attention")

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


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


def _both(arrays, dtype):
    """numpy fp32 arrays -> (jax, torch) in ``dtype``."""
    j = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))
         for a in arrays]
    return j, t


def _models(arch, dtype, star, seed=3):
    jcfg = get_smoke_config(arch)
    jcfg = dataclasses.replace(jcfg, dtype=getattr(jnp, dtype),
                               star=jcfg.star if star else None)
    jp = jlm.init(jax.random.PRNGKey(seed), jcfg)
    return (jcfg, jp, convert.model_cfg_from_reference(jcfg),
            convert.to_torch(jax.tree.map(np.asarray, jp)))


# -- the dense-cache decode ----------------------------------------------

@pytest.mark.parametrize("lz", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_star_decode_matches(dtype, lz):
    """Element-level STAR decode of a GQA group (two query heads sharing
    one cache) at three lengths, predicting from K or from its LZ codes."""
    rng = np.random.RandomState(4)
    s, d = 64, 16
    q = rng.randn(3, 2, d).astype(np.float32)
    k = rng.randn(3, s, d).astype(np.float32)
    v = rng.randn(3, s, d).astype(np.float32)
    k[:, 5] *= 4.0
    length = np.array([64, 37, 1], np.int32)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), dtype)
    cfg = dict(top_k_ratio=0.25, block_kv=16, radius=5.0)
    jdlzs = importlib.import_module("repro.core.dlzs")
    one = lambda qv, kv, vv, ln: jstar.star_decode(  # noqa: E731
        qv, kv, vv, jstar.STARConfig(**cfg), length=ln,
        k_lz=jdlzs.lz_pack(kv) if lz else None)
    f = jax.vmap(jax.vmap(one, in_axes=(0, None, None, None)))
    want = f(jq, jk, jv, jnp.asarray(length))
    from repro_torch.core import dlzs as tdlzs
    got = tstar.star_decode(
        tq, tk[:, None], tv[:, None], tstar.STARConfig(**cfg),
        length=torch.from_numpy(length)[:, None],
        k_lz=tdlzs.lz_pack(tk)[:, None] if lz else None)
    _close(got, want, dtype, "star_decode")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attn", ["dense", "star"])
def test_apply_decode_matches(attn, dtype):
    """One-token decode against the dense cache at ChatGLM3's smoke GQA
    (4 heads over 2 KV heads, QKV bias): the output and the cache rows
    written in place, a slot at the cache's end included (its write
    clamps, as ``dynamic_update_slice`` clamps)."""
    jcfg, jp, tcfg, tp = _models("chatglm3_6b", dtype, attn == "star")
    jacfg = jcfg.attn_cfg("decode")
    tacfg = tcfg.attn_cfg()
    rng = np.random.RandomState(5)
    b, s_max = 3, 64
    x = rng.randn(b, 1, jcfg.d_model).astype(np.float32)
    kc = rng.randn(b, s_max, jcfg.n_kv, jcfg.dh).astype(np.float32)
    vc = rng.randn(b, s_max, jcfg.n_kv, jcfg.dh).astype(np.float32)
    lengths = np.array([20, 63, 64], np.int32)
    (jx, jk, jv), (tx, tk, tv) = _both((x, kc, vc), dtype)
    from repro.core import dlzs as jdlzs
    from repro_torch.core import dlzs as tdlzs
    jcache = {"k": jk, "v": jv, "k_lz": jdlzs.lz_pack(jk)}
    tcache = {"k": tk, "v": tv, "k_lz": tdlzs.lz_pack(tk)}
    jlayer = jax.tree.map(lambda a: a[0], jp["blocks"]["b0"]["core"])
    tlayer = {name: leaf[0] for name, leaf in
              tp["blocks"]["b0"]["core"].items()}
    want_y, want_cache = jattention.apply_decode(
        jlayer, jacfg, jx, jcache, jnp.asarray(lengths))
    got_y, got_cache = tattention.apply_decode(
        tlayer, tacfg, tx, tcache, torch.from_numpy(lengths))
    _close(got_y, want_y, dtype, "decode output")
    assert got_cache["k"] is tk
    for name in ("k", "v"):
        _close(got_cache[name], want_cache[name], dtype, name)
    np.testing.assert_array_equal(got_cache["k_lz"].numpy(),
                                  tdlzs.lz_pack(got_cache["k"]).numpy())


@pytest.mark.parametrize("star", [False, True])
@pytest.mark.parametrize("arch", ["olmo_1b", "chatglm3_6b"])
def test_decode_step_matches(arch, star):
    """``lm.prefill(cache_len=)``'s padded dense cache, then two
    ``lm.decode_step`` ticks, against the reference's, in fp32."""
    jcfg, jp, tcfg, tp = _models(arch, "float32", star)
    toks = np.random.RandomState(6).randint(
        2, jcfg.vocab, size=(2, 32)).astype(np.int32)
    _, jcache = jlm.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                            cache_len=64)
    _, tcache = tlm.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                            cache_len=64)
    nxt = np.array([[7], [11]], np.int32)
    for tick in range(2):
        want_logits, jcache = jlm.decode_step(jp, jcfg, jnp.asarray(nxt),
                                              jcache)
        got_logits, tcache = tlm.decode_step(tp, tcfg, torch.from_numpy(nxt),
                                             tcache)
        _close(got_logits, want_logits, "float32", f"tick {tick} logits")
        np.testing.assert_array_equal(tcache["lengths"].numpy(),
                                      np.asarray(jcache["lengths"]))
        nxt = np.asarray(jnp.argmax(want_logits[:, :jcfg.vocab], -1)
                         ).astype(np.int32)[:, None]
    want = dict(tree_items(jax.tree.map(np.asarray, jcache["layers"])))
    for path, leaf in tree_items(tcache["layers"]):
        if path[-1] != "k_lz":
            _close(leaf, want[path], "float32", f"cache {path}")


# -- the engine ----------------------------------------------------------

@pytest.mark.parametrize("star", [False, True])
@pytest.mark.parametrize("arch", ["olmo_1b", "chatglm3_6b"])
def test_dense_engine_matches_reference(arch, star):
    """Greedy tokens of the dense ``LLM`` equal the JAX ``ServingEngine``'s
    at smoke size in fp32, more prompts than slots (slots are reused), a
    request of one token, and with STAR its element-level decode (prompts
    of whole STAR tiles, which both prefills need)."""
    jcfg, jp, tcfg, tp = _models(arch, "float32", star)
    lengths = (16, 32, 48, 16) if star else (5, 8, 17, 33)
    prompts = scen._prompts(jcfg, lengths)
    want = JLLM(JServingEngine(jcfg, jp, JEngineCfg(max_batch=2, max_len=64,
                                                    eos_id=-1)))
    got = LLM.from_config(tcfg, backend="dense", params=tp, device="cpu",
                          engine_cfg=EngineCfg(max_batch=2, max_len=64,
                                               eos_id=-1))
    assert isinstance(got.engine, ServingEngine)
    for llm in (want, got):
        for i, p in enumerate(prompts):
            llm.submit(p, max_tokens=1 if i == 3 else 6, rid=i)
    assert got.run_until_done() == want.run_until_done()


def _port_dense_oracle(tcfg, tparams, prompts, max_tokens=5):
    dense = LLM(ServingEngine(tcfg, tparams,
                              EngineCfg(max_batch=2, max_len=64, eos_id=-1)))
    return scen._run_llm(dense, prompts, max_tokens)


@pytest.mark.parametrize("scfg", [
    dict(chunk_pages=1), dict(chunk_pages=1, prefill_tokens=48),
    dict(chunk_pages=None)], ids=["sequential", "batched", "whole_prompt"])
@pytest.mark.parametrize("arch", ["olmo_1b", "chatglm3_6b"])
def test_paged_matches_port_dense_oracle(arch, scfg):
    """The conformance scenarios' parity rule with the port's own oracle:
    the paged engine (chunked, batched varlen and whole-prompt prefill) and
    the dense slot engine give the same tokens on the mixed-length
    prompts, bf16 with ``star=None`` (the reference's parity setting)."""
    _, _, tcfg, tp = _models(arch, "bfloat16", False, seed=1)
    prompts = scen._prompts(tcfg, scen.MIXED_LENGTHS)
    want = _port_dense_oracle(tcfg, tp, prompts)
    llm = LLM(PagedServingEngine(tcfg, tp, PagedEngineCfg(
        max_batch=2, page_size=16, n_pages=32, hot_pages=4, eos_id=-1),
        SchedulerCfg(**scfg)))
    assert scen._run_llm(llm, prompts) == want


def test_dense_engine_lifecycle():
    """Cancel a queued and an in-flight request, expire one on its
    deadline, and quarantine one whose prefill faults past its retries;
    the others finish, and sampled decode draws from the generator."""
    from repro_torch.serving import FaultPlan
    tcfg = dataclasses.replace(
        importlib.import_module("repro_torch.configs.chatglm3_6b")
        .smoke_config(), star=None)
    llm = LLM.from_config(tcfg, backend="dense", device="cpu",
                          generator=torch.Generator().manual_seed(2),
                          engine_cfg=EngineCfg(max_batch=2, max_len=64,
                                               eos_id=-1))
    hs = [llm.submit(np.arange(10 + i, dtype=np.int32), max_tokens=8)
          for i in range(4)]
    expired = llm.submit(np.arange(5, dtype=np.int32), max_tokens=8,
                         deadline_ms=0.0)
    llm.tick()                       # admits 0 and 1, decodes once
    assert hs[0].cancel() and hs[3].cancel()
    llm.engine.fault_plan = FaultPlan(schedule={"dense_prefill": {0, 1, 2}})
    llm.run_until_done()
    assert [h.outcome for h in hs] == ["cancelled", "done", "failed",
                                       "cancelled"]
    assert expired.outcome == "expired"
    assert len(hs[1].tokens) == 8 and len(hs[0].tokens) == 2
    sampled = LLM.from_config(tcfg, backend="dense", device="cpu",
                              generator=torch.Generator().manual_seed(2),
                              engine_cfg=EngineCfg(max_batch=2, max_len=64,
                                                   eos_id=-1, greedy=False))
    toks = sampled.submit(np.arange(12, dtype=np.int32), max_tokens=6)
    assert len(toks.result()) == 6
    assert all(0 <= t < tcfg.vocab for t in toks.tokens)
