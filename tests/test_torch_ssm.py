"""Port parity: the SSD core and the Mamba block (``repro_torch.models.ssm``)
and the hybrid Jamba model built on them, against ``repro.models.ssm`` and
``repro.models.lm`` at smoke size.

* ``chunked_linear_attention`` with and without an incoming state, at a
  chunk equal to S and one below it, per-head and head-shared (Mamba's
  ``expand``-ed B and C) read/write vectors: against the reference, and
  against S applications of the port's ``linear_attention_step`` (an
  independent check of the chunked form).
* Mamba ``apply`` and two ``apply_decode`` steps at S = 64 (two chunks),
  17 (prime: chunk 17) and 2 (fewer rows than the conv's window).
* Jamba smoke (``star`` on and off): ``lm.prefill``, two ``decode_step``
  ticks and ``lm.forward``; greedy tokens of the port's dense engine
  against the JAX dense ``ServingEngine``; the port's init against the
  reference's tree and each leaf's spread.

Tolerances: 2e-5 x max(1, |ref|max) in fp32, 2e-2 x max(1, |ref|max) in
bf16.
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
from repro.models import ssm as jssm  # noqa: E402
from repro.serving import LLM as JLLM  # noqa: E402
from repro.serving import EngineCfg as JEngineCfg  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_smoke_config as tsmoke  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.serving import LLM, EngineCfg  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def close(got, want, dtype, what):
    """|got - want| <= tol x max(1, |want|max), elementwise; also rtol."""
    want = _np32(want)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np32(got), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())),
                               err_msg=what)


def close_trees(got, want, dtype, what):
    want = dict(tree_items(jax.tree.map(np.asarray, want)))
    got = dict(tree_items(got))
    assert set(got) == set(want), what
    for path, leaf in got.items():
        assert str(leaf.dtype).replace("torch.", "") == \
            np.dtype(want[path].dtype).name, (what, path)
        assert tuple(leaf.shape) == want[path].shape, (what, path)
        if path[-1] != "k_lz":
            close(leaf, want[path], dtype, f"{what} {path}")


def in_dtype(jcfg, dtype):
    """A reference config with its model, MoE and Mamba dtypes set."""
    jdt = getattr(jnp, dtype)
    return dataclasses.replace(
        jcfg, dtype=jdt,
        moe=jcfg.moe and dataclasses.replace(jcfg.moe, dtype=jdt),
        mamba=jcfg.mamba and dataclasses.replace(jcfg.mamba, dtype=jdt))


def models(arch, dtype, star, seed=3, n_layers=None):
    """(jax cfg, jax params, torch cfg, torch params) at smoke size; with
    ``n_layers`` below the smoke pattern's length, its first blocks."""
    jcfg = get_smoke_config(arch)
    kw = {} if n_layers is None else {"n_layers": n_layers,
                                      "pattern": jcfg.pattern[:n_layers]}
    jcfg = dataclasses.replace(in_dtype(jcfg, dtype),
                               star=jcfg.star if star else None, **kw)
    jp = jlm.init(jax.random.PRNGKey(seed), jcfg)
    return (jcfg, jp, convert.model_cfg_from_reference(jcfg),
            convert.to_torch(jax.tree.map(np.asarray, jp)))


def both(arrays, dtype):
    """numpy fp32 arrays -> (jax, torch) in ``dtype``."""
    j = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))
         for a in arrays]
    return j, t


def layer0(jtree, ttree):
    """Layer 0's slice of a stacked block's leaves in both packages."""
    return (jax.tree.map(lambda a: a[0], jtree),
            {k: v[0] for k, v in ttree.items()})


def model_params_and_cache_match(arch, dtype, star, seq_len, max_len,
                                 n_layers=None):
    """``lm.prefill(cache_len=)`` at a ragged last index, two
    ``decode_step`` ticks and ``lm.forward``, each against the reference:
    logits and every cache leaf."""
    jcfg, jp, tcfg, tp = models(arch, dtype, star, n_layers=n_layers)
    rng = np.random.RandomState(7)
    toks = rng.randint(2, jcfg.vocab, size=(2, seq_len)).astype(np.int32)
    want, jcache = jlm.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                               cache_len=max_len)
    got, tcache = tlm.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)},
                              cache_len=max_len)
    close(got, want, dtype, "prefill logits")
    close_trees(tcache["layers"], jcache["layers"], dtype, "prefill cache")
    fwd = tlm.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    close(fwd[:, -1], want, dtype, "forward logits")
    nxt = np.array([[7], [11]], np.int32)
    for tick in range(2):
        want, jcache = jlm.decode_step(jp, jcfg, jnp.asarray(nxt), jcache)
        got, tcache = tlm.decode_step(tp, tcfg, torch.from_numpy(nxt),
                                      tcache)
        close(got, want, dtype, f"tick {tick} logits")
        np.testing.assert_array_equal(tcache["lengths"].numpy(),
                                      np.asarray(jcache["lengths"]))
        nxt = np.asarray(jnp.argmax(want[:, :jcfg.vocab], -1)
                         ).astype(np.int32)[:, None]
    close_trees(tcache["layers"], jcache["layers"], dtype, "decoded cache")


def engine_tokens_match(arch, dtype, star, lengths, n_layers=None):
    """Greedy tokens of the port's dense ``LLM`` against the JAX
    ``ServingEngine``'s: equal in fp32; in bf16 each request's first
    divergence must be an argmax tie of the reference
    (``engine_core_scenarios._greedy_tie``)."""
    jcfg, jp, tcfg, tp = models(arch, dtype, star, n_layers=n_layers)
    prompts = scen._prompts(jcfg, lengths)
    want = JLLM(JServingEngine(jcfg, jp, JEngineCfg(max_batch=2, max_len=64,
                                                    eos_id=-1)))
    got = LLM.from_config(tcfg, backend="dense", params=tp, device="cpu",
                          engine_cfg=EngineCfg(max_batch=2, max_len=64,
                                               eos_id=-1))
    for llm in (want, got):
        for i, p in enumerate(prompts):
            llm.submit(p, max_tokens=1 if i == len(prompts) - 1 else 6,
                       rid=i)
    want, got = want.run_until_done(), got.run_until_done()
    assert set(got) == set(want)
    for rid, toks in got.items():
        if dtype == "float32" or toks == want[rid]:
            assert toks == want[rid], rid
        else:
            assert len(toks) == len(want[rid])
            assert scen._greedy_tie(jcfg, jp, prompts[rid], toks,
                                    want[rid]), (rid, toks, want[rid])


def init_matches_reference(arch):
    """The port's own init builds the reference's tree (keys, shapes,
    dtypes); every leaf the reference draws at random has a spread within
    sampling tolerance of the reference's own draw (five standard errors
    of the two estimates), and every constant leaf equals the
    reference's."""
    jcfg = get_smoke_config(arch)
    jp = jlm.init(jax.random.PRNGKey(0), jcfg)
    tp = tlm.init(tsmoke(arch), torch.Generator().manual_seed(0), "cpu")
    want = dict(tree_items(jax.tree.map(np.asarray, jp)))
    got = dict(tree_items(tp))
    assert {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in got.items()} == \
        {p: (a.shape, np.dtype(a.dtype).name) for p, a in want.items()}
    for path, a in want.items():
        a = a.astype(np.float32)
        b = got[path].float().numpy()
        if a.std() == 0:
            np.testing.assert_array_equal(b, a, err_msg=str(path))
            continue
        spread = 5 * np.sqrt(1 / (2 * a.size) + 1 / (2 * b.size))
        assert abs(b.std() / a.std() - 1) < spread, \
            (path, float(b.std()), float(a.std()))


# -- the SSD core --------------------------------------------------------

@pytest.mark.parametrize("shared", [False, True], ids=["per_head", "shared"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("chunk,decay", [(64, 1.0), (16, 1.0), (64, 5.0)],
                         ids=["64", "16", "64-steep"])
def test_chunked_linear_attention(chunk, decay, with_h0, shared):
    """The chunked form at S = 64 against the reference and against S
    single steps, fp32. ``shared``: c and b one vector per step expanded
    to every head (a view), as Mamba passes them. ``64-steep``: log decays
    of -5 and below, so that within the chunk exp(L_t - L_s) above the
    diagonal overflows to inf (as at Jamba's width over 256-step chunks);
    it must weigh 0, not NaN."""
    rng = np.random.RandomState(chunk + 2 * with_h0 + shared)
    b, s, h, n, p = 2, 64, 3, 8, 5
    c = rng.randn(b, s, 1 if shared else h, n).astype(np.float32)
    w = rng.randn(b, s, 1 if shared else h, n).astype(np.float32)
    if shared:
        c, w = (np.broadcast_to(a, (b, s, h, n)) for a in (c, w))
    x = rng.randn(b, s, h, p).astype(np.float32)
    log_a = (-np.abs(rng.randn(b, s, h)) * decay
             - (decay - 1.0)).astype(np.float32)
    h0 = rng.randn(b, h, n, p).astype(np.float32) if with_h0 else None
    want_y, want_h = jssm.chunked_linear_attention(
        *(jnp.asarray(a) for a in (c, w, x, log_a)), chunk=chunk,
        h0=None if h0 is None else jnp.asarray(h0))
    tc, tw = (torch.from_numpy(np.ascontiguousarray(a[:, :, :1] if shared
                                                    else a))
              for a in (c, w))
    if shared:
        tc, tw = (t.expand(b, s, h, n) for t in (tc, tw))
    tx, tla = torch.from_numpy(x), torch.from_numpy(log_a)
    th0 = None if h0 is None else torch.from_numpy(h0)
    got_y, got_h = tssm.chunked_linear_attention(tc, tw, tx, tla,
                                                 chunk=chunk, h0=th0)
    close(got_y, want_y, "float32", "y")
    close(got_h, want_h, "float32", "h_final")
    state = torch.zeros((b, h, n, p)) if th0 is None else th0
    steps = []
    for t in range(s):
        y, state = tssm.linear_attention_step(tc[:, t], tw[:, t], tx[:, t],
                                              tla[:, t], state)
        steps.append(y)
    close(got_y, torch.stack(steps, 1), "float32", "y vs steps")
    close(got_h, state, "float32", "h_final vs steps")


def test_chunk_rule_and_ragged_length_raise():
    assert [tssm.chunk_len(s, 32) for s in (64, 17, 2, 96, 97)] == \
        [32, 17, 2, 32, 1]
    x = torch.zeros((1, 10, 1, 2))
    with pytest.raises(ValueError, match="not divisible"):
        tssm.chunked_linear_attention(x, x, x, x[..., 0], chunk=4)


# -- the Mamba block -----------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [64, 17, 2])
def test_mamba_apply_and_decode(s, dtype):
    """``apply`` with its cache, then two ``apply_decode`` steps from it,
    on layer 0 of the Jamba smoke config's first block."""
    jcfg, jp, tcfg, tp = models("jamba_1_5_large_398b", dtype, False)
    jparams, tparams = layer0(jp["blocks"]["b0"]["core"],
                              tp["blocks"]["b0"]["core"])
    rng = np.random.RandomState(s)
    x = rng.randn(2, s + 2, jcfg.d_model).astype(np.float32)
    (jx,), (tx,) = both((x,), dtype)
    want, jcache = jssm.apply(jparams, jcfg.mamba, jx[:, :s],
                              make_cache=True)
    got, tcache = tssm.apply(tparams, tcfg.mamba, tx[:, :s],
                             make_cache=True)
    close(got, want, dtype, "apply")
    close_trees(tcache, jcache, dtype, "apply cache")
    for t in range(s, s + 2):
        want, jcache = jssm.apply_decode(jparams, jcfg.mamba,
                                         jx[:, t:t + 1], jcache)
        got, tcache = tssm.apply_decode(tparams, tcfg.mamba,
                                        tx[:, t:t + 1], tcache)
        close(got, want, dtype, f"decode at {t}")
        close_trees(tcache, jcache, dtype, f"decode cache at {t}")


# -- the Jamba model -----------------------------------------------------

@pytest.mark.parametrize("dtype,star,layers", [
    ("float32", True, None), ("float32", False, None),
    ("bfloat16", False, 2)], ids=["fp32-star", "fp32-dense", "bf16-dense"])
def test_jamba_prefill_decode_forward(dtype, star, layers):
    """Jamba smoke (Mamba + attention blocks, dense and MoE FFNs): fp32 at
    full depth, with and without STAR; bf16 over its first two layers
    (Mamba + dense, Mamba + MoE): two bf16 implementations sum in other
    orders, and an MoE amplifies the step (tests/test_torch_configs.py)."""
    model_params_and_cache_match("jamba_1_5_large_398b", dtype, star,
                                 seq_len=48, max_len=64, n_layers=layers)


@pytest.mark.parametrize("dtype,star,layers", [
    ("float32", False, None), ("float32", True, None),
    ("bfloat16", False, 2)], ids=["fp32-dense", "fp32-star", "bf16-dense"])
def test_jamba_dense_engine_tokens(dtype, star, layers):
    """More prompts than slots (slots and their state slabs reused), a
    request of one token; with STAR, prompts of whole STAR tiles. bf16
    over the first two layers, as the model test: through all eight the
    two packages' bf16 logits lie as far apart (0.06 at |x| 2.6) as each
    lies from the fp32 forward (0.085 and 0.083), and a first token two
    bf16 steps below the top is no argmax tie."""
    engine_tokens_match("jamba_1_5_large_398b", dtype, star,
                        (16, 32, 48) if star else (5, 17, 32),
                        n_layers=layers)


def test_jamba_init_matches_reference():
    init_matches_reference("jamba_1_5_large_398b")
