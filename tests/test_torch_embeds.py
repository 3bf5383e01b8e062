"""Port parity: the embeddings-frontend family (InternVL2-26B) in
``repro_torch`` against ``repro.models`` and ``repro.serving`` at smoke
size.

InternVL2 is a causal GQA decoder whose ViT frontend is a stub: a batch
may carry precomputed patch embeddings (``batch["embeds"]``) in place of
tokens. Held: the configs (``embeds_input`` survives the converter), the
port's own init against the reference's tree, ``lm.prefill`` from
``embeds`` and from ``tokens`` (logits and caches) followed by three
``decode_step``s, the port's ``forward`` from ``embeds``, and the greedy
tokens the port's paged (chunked and whole-prompt prefill) and dense
engines serve, against the JAX engines' on the same weights, in fp32
with STAR on, on page-multiple prompts (the reference's whole-prompt
STAR prefill takes whole tiles).

Weights come from ``repro.models.lm.init`` with every norm scale redrawn
(numpy); inputs are drawn with numpy from fixed seeds in the shapes of
``tests/test_models_smoke.py::_batch`` (embeddings [2, 64, H] rounded to
bf16). Tolerances as tests/test_torch_encdec.py: 2e-5 in fp32, 2e-2 in
bf16 scaled by magnitude; STAR through the whole model in fp32 and over
one layer in bf16.
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
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import LLM as JLLM  # noqa: E402
from repro.serving import EngineCfg as JEngineCfg  # noqa: E402
from repro.serving import PagedEngineCfg as JPagedEngineCfg  # noqa: E402
from repro.serving import SchedulerCfg as JSchedulerCfg  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serving import (LLM, EngineCfg, PagedEngineCfg,  # noqa: E402
                                 SchedulerCfg)
from repro_torch.tree import tree_items  # noqa: E402
from test_torch_encdec import (_close, _compare_cache, _frames,  # noqa: E402
                               _paths, _redraw_affine, _tokens)

ARCH = "internvl2_26b"
VARIANTS = [("float32", "star", None), ("float32", "dense", None),
            ("bfloat16", "dense", None), ("bfloat16", "star", 1)]
IDS = [f"{d}-{a}-{n or 'all'}" for d, a, n in VARIANTS]
B, S = 2, 64
CACHE_LEN = 80
PROMPTS = (32, 64, 48)      # page multiples (page 16)
# prefill inputs: patch embeddings in every variant, tokens in fp32 (the
# token path is the served decoder's, which test_torch_model.py holds in
# bf16)
SOURCES = [(v, s) for v in VARIANTS for s in ("embeds", "tokens")
           if s == "embeds" or v[0] == "float32"]


@pytest.fixture(scope="module")
def models():
    """(jax cfg, jax params, torch cfg, torch params) per variant."""
    out = {}
    for dtype, attn, layers in VARIANTS:
        jcfg = jget_smoke(ARCH)
        jcfg = dataclasses.replace(
            jcfg, dtype=getattr(jnp, dtype),
            star=jcfg.star if attn == "star" else None,
            n_layers=layers or jcfg.n_layers)
        jp = _redraw_affine(jlm.init(jax.random.PRNGKey(5), jcfg), 6)
        tp = convert.to_torch(jax.tree.map(np.asarray, jp))
        out[dtype, attn, layers] = (
            jcfg, jp, convert.model_cfg_from_reference(jcfg), tp)
    return out


def _batches(jcfg, source, seed):
    if source == "embeds":
        j, t = _frames((B, S, jcfg.d_model), seed)
        return {"embeds": j}, {"embeds": t}
    toks = _tokens(jcfg, (B, S), seed)
    return {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}


def test_configs_resolve_field_for_field():
    """Published and smoke configs equal the reference's, converted;
    ``embeds_input`` survives the converter."""
    for get_t, get_j in ((tconfigs.get_config, jget_config),
                         (tconfigs.get_smoke_config, jget_smoke)):
        tcfg = convert.model_cfg_from_reference(get_j(ARCH))
        assert get_t(ARCH) == tcfg
        assert tcfg.embeds_input and tcfg.enc_layers == 0
    cfg = tconfigs.get_config(ARCH)
    assert (cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.n_kv, cfg.dh) == \
        (6144, 48, 48, 8, 128)


def test_port_init_matches_reference_tree():
    jcfg = jget_smoke(ARCH)
    shapes = jax.eval_shape(lambda: jlm.init(jax.random.PRNGKey(0), jcfg))
    tp = tlm.init(tconfigs.get_smoke_config(ARCH),
                  torch.Generator().manual_seed(0), "cpu")
    want = {tuple(p): (s.shape, np.dtype(s.dtype).name)
            for p, s in zip(_paths(shapes), jax.tree.leaves(shapes))}
    got = {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for p, t in tree_items(tp)}
    assert got == want


@pytest.mark.parametrize("variant,source", SOURCES,
                         ids=[f"{IDS[VARIANTS.index(v)]}-{s}"
                              for v, s in SOURCES])
def test_prefill_then_decode_matches(models, variant, source):
    """``lm.prefill`` from patch embeddings or from tokens: logits and
    caches; then three ``decode_step``s (decode always reads tokens)."""
    jcfg, jp, tcfg, tp = models[variant]
    dtype = variant[0]
    jb, tb = _batches(jcfg, source, 60)
    want_logits, want_cache = jlm.prefill(jp, jcfg, jb, cache_len=CACHE_LEN)
    got_logits, got_cache = tlm.prefill(tp, tcfg, tb, cache_len=CACHE_LEN)
    _close(got_logits, want_logits, dtype, "prefill logits")
    _compare_cache(got_cache["layers"], want_cache["layers"], dtype,
                   "prefill cache")
    for i, toks in enumerate(_tokens(jcfg, (3, B, 1), 61)):
        want_logits, want_cache = jlm.decode_step(
            jp, jcfg, jnp.asarray(toks), want_cache)
        got_logits, got_cache = tlm.decode_step(
            tp, tcfg, torch.from_numpy(toks), got_cache)
        _close(got_logits, want_logits, dtype, f"decode step {i}")
    _compare_cache(got_cache["layers"], want_cache["layers"], dtype,
                   "cache after decode")


def test_embeds_of_tokens_equal_tokens(models):
    """A batch of the embedding table's rows prefills as its tokens do."""
    _, _, tcfg, tp = models[VARIANTS[0]]
    toks = torch.from_numpy(_tokens(tcfg, (B, 32), 62))
    want, _ = tlm.prefill(tp, tcfg, {"tokens": toks})
    got, _ = tlm.prefill(tp, tcfg, {"embeds": tp["embed"][toks.long()]})
    assert torch.equal(got, want)


@pytest.mark.parametrize("variant", VARIANTS[:2], ids=IDS[:2])
def test_forward_from_embeds_matches_prefill_logits(models, variant):
    jcfg, jp, tcfg, tp = models[variant]
    jb, tb = _batches(jcfg, "embeds", 63)
    got = tlm.forward(tp, tcfg, tb)
    for j in (S - 1, 30):
        want, _ = jlm.prefill(jp, jcfg, jb,
                              last_index=jnp.full((B,), j, jnp.int32))
        _close(got[:, j], want, variant[0], f"position {j}")


@pytest.mark.parametrize("engine", ["paged", "paged-whole", "dense"])
def test_served_tokens_match_reference_engines(models, engine):
    """Greedy tokens of the port's engine equal the JAX engine's, fp32,
    STAR on: the paged engine with chunked prefill and with whole-prompt
    prefill (``lm.prefill``'s STAR path), and the dense slot engine."""
    jcfg, jp, tcfg, tp = models[VARIANTS[0]]
    prompts = scen._prompts(jcfg, PROMPTS)
    if engine == "dense":
        kw = dict(max_batch=2, max_len=96, eos_id=-1)
        want = JLLM.from_config(jcfg, backend="dense", params=jp,
                                engine_cfg=JEngineCfg(**kw))
        got = LLM.from_config(tcfg, backend="dense", params=tp, device="cpu",
                              engine_cfg=EngineCfg(**kw))
    else:
        kw = dict(max_batch=2, page_size=16, n_pages=32, hot_pages=8,
                  eos_id=-1)
        sched = dict(chunk_pages=None) if engine == "paged-whole" else {}
        want = JLLM.from_config(jcfg, backend="paged", params=jp,
                                engine_cfg=JPagedEngineCfg(**kw),
                                sched_cfg=JSchedulerCfg(**sched))
        got = LLM.from_config(tcfg, backend="paged", params=tp, device="cpu",
                              engine_cfg=PagedEngineCfg(**kw),
                              sched_cfg=SchedulerCfg(**sched))
    assert scen._run_llm(got, prompts, max_tokens=8) == \
        scen._run_llm(want, prompts, max_tokens=8)
