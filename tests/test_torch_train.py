"""Port parity for training: K4's gradient and ``lm.loss_fn``.

The same numpy-seeded inputs go through the reference and the port
(weights from ``repro.models.lm.init`` through ``repro_torch.convert``):

* K4's backward in plain form (``kernels.ref.flash_bwd_ref``), autograd
  through ``flash_ref`` and through the differentiable wrapper
  (``kernels.flash.flash_attention``, which takes the plain forms on the
  CPU) against ``jax.grad`` of the reference's train-mode attention,
  ``repro.models.attention._dense_chunked``: causal and not, a ragged
  T = S, T < S (not causal: the reference's mask has no S - T offset);
  2e-5 in fp32.
* ``lm.loss_fn``: loss and metrics at 2e-5 and every gradient leaf at
  2e-5 x max(1, the leaf's largest magnitude), fp32, against
  ``jax.value_and_grad(repro.models.lm.loss_fn)``, on the smoke configs
  of olmo_1b, chatglm3_6b (GQA, biases, half RoPE), olmoe_1b_7b (the
  MoE aux loss) and jamba_1_5_large_398b; olmo_1b's bf16 loss at 2e-2.

``test_torch_train_smoke.py`` holds every smoke config's training step,
the remat policies, gradient accumulation and the launcher.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import get_smoke_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import flash as kflash  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.tree import sorted_items, tree_leaves  # noqa: E402

jax.config.update("jax_enable_x64", False)
# the module, not the function ``repro.models`` exports under its name
jattention = importlib.import_module("repro.models.attention")

F32 = dict(rtol=2e-5, atol=2e-5)
PARITY_ARCHS = ["olmo_1b", "chatglm3_6b", "olmoe_1b_7b",
                "jamba_1_5_large_398b"]


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


# -- K4's gradient ------------------------------------------------------------

@pytest.mark.parametrize("t,s,causal", [
    (64, 64, True), (64, 64, False), (37, 37, True), (16, 48, False)])
def test_flash_grads_match_reference_dense_attention(t, s, causal):
    """dQ, dK, dV of K4's function, three ways in the port, against
    ``jax.grad`` of ``_dense_chunked`` in fp32."""
    rng = np.random.default_rng(t * 100 + s + causal)
    bh, d = 3, 16
    q, k, v = _normal(rng, (bh, t, d)), _normal(rng, (bh, s, d)), \
        _normal(rng, (bh, s, d))
    k[:, : s // 4] *= 3.0
    do = _normal(rng, (bh, t, d))
    scale = d ** -0.5

    def heads(x):                         # [BH, T, d] -> [1, T, BH, d]
        return jnp.asarray(np.moveaxis(x, 0, 1)[None])

    def f(qj, kj, vj):
        o = jattention._dense_chunked(qj, kj, vj, causal=causal,
                                      q_chunk=16, scale=scale)
        return jnp.sum(o * heads(do))
    want = [np.moveaxis(np.asarray(g)[0], 1, 0) for g in jax.grad(
        f, argnums=(0, 1, 2))(heads(q), heads(k), heads(v))]

    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = kref.flash_ref(tq, tk, tv, causal=causal, scale=scale,
                            return_lse=True)
    plain = kref.flash_bwd_ref(tq, tk, tv, o, lse, tdo, causal=causal,
                               scale=scale)
    autograd = {}
    for name, fn in (("flash_ref", kref.flash_ref),
                     ("wrapper", kflash.flash_attention)):
        leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
        out = fn(*leaves, causal=causal, scale=scale)
        autograd[name] = torch.autograd.grad(out, leaves, tdo)
    for got in (plain, autograd["flash_ref"], autograd["wrapper"]):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, **F32)


def test_flash_wrapper_backward_is_the_plain_backward():
    """On the CPU the differentiable wrapper's backward is
    ``flash_bwd_ref`` on the forward's own o and lse, bit for bit; a
    causal row of T > S with no visible key has lse = +inf and no
    gradient."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(_normal(rng, (2, n, 16)))
               for n in (40, 24, 24))
    do = torch.from_numpy(_normal(rng, (2, 40, 16)))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(kflash.flash_attention(*leaves, causal=True),
                              leaves, do)
    o, lse = kflash.flash_attention(q, k, v, causal=True, return_lse=True)
    assert torch.isinf(lse[:, :16]).all() and torch.isfinite(lse[:, 16:]).all()
    want = kref.flash_bwd_ref(q, k, v, o, lse, do, causal=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert float(got[0][:, :16].abs().max()) == 0.0


# -- lm.loss_fn ---------------------------------------------------------------

def _batch(cfg, rng, b=2, s=64):
    """numpy batch: tokens (or embeds / encoder frames) and labels."""
    out = {}
    if cfg.enc_layers:
        out["enc_embeds"] = _normal(rng, (b, s, cfg.d_model))
    if cfg.embeds_input:
        out["embeds"] = _normal(rng, (b, s, cfg.d_model))
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    out["labels"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return out


def _models(arch, dtype=jnp.float32, seed=3):
    """(jax cfg, jax params, torch cfg, torch params) in ``dtype``, the
    MoE and Mamba sub-configs' too."""
    jcfg = get_smoke_config(arch)
    subs = {name: dataclasses.replace(getattr(jcfg, name), dtype=dtype)
            for name in ("moe", "mamba") if getattr(jcfg, name) is not None}
    jcfg = dataclasses.replace(jcfg, dtype=dtype, **subs)
    jp = jlm.init(jax.random.PRNGKey(seed), jcfg)
    tcfg = convert.model_cfg_from_reference(jcfg)
    tp = convert.to_torch(jax.tree.map(np.asarray, jp))
    return jcfg, jp, tcfg, tp


def _jax_value_and_grad(jcfg, jp, batch):
    return jax.value_and_grad(jlm.loss_fn, has_aux=True)(
        jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})


def _torch_batch(batch, dtype=torch.float32):
    return {k: (torch.from_numpy(v).to(dtype) if v.dtype == np.float32
                else torch.from_numpy(v)) for k, v in batch.items()}


@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_loss_and_grads_match_reference(arch):
    jcfg, jp, tcfg, tp = _models(arch)
    batch = _batch(jcfg, np.random.default_rng(11))
    (jloss, jmetrics), jgrads = _jax_value_and_grad(jcfg, jp, batch)
    (loss, metrics), grads = steps.value_and_grad(tp, tcfg,
                                                  _torch_batch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), **F32)
    assert set(metrics) == set(jmetrics) == {"ce", "aux", "zloss",
                                             "tokens"}
    for name in metrics:
        np.testing.assert_allclose(float(metrics[name]),
                                   float(jmetrics[name]), **F32)
    if arch in ("olmoe_1b_7b", "jamba_1_5_large_398b"):
        assert float(metrics["aux"]) > 0
    want = dict(sorted_items(jax.tree.map(np.asarray, jgrads)))
    got = dict(sorted_items(grads))
    assert set(got) == set(want)
    for path, w in want.items():
        atol = 2e-5 * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got[path].numpy(), w, rtol=2e-5,
                                   atol=atol, err_msg=str(path))


def test_bf16_loss_matches_reference():
    jcfg, jp, tcfg, tp = _models("olmo_1b", dtype=jnp.bfloat16)
    batch = _batch(jcfg, np.random.default_rng(12))
    (jloss, _), _ = _jax_value_and_grad(jcfg, jp, batch)
    (loss, _), grads = steps.value_and_grad(tp, tcfg, _torch_batch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-2)
    assert all(g.dtype == torch.bfloat16 for g in tree_leaves(grads))


def test_loss_chunking_and_ignored_labels_match_reference():
    """A sequence the CE chunk does not divide (the largest divisor rule:
    S = 60 at chunk 64 runs chunks of 30) and negative labels, which
    count in no metric."""
    jcfg, jp, tcfg, tp = _models("olmo_1b")
    batch = _batch(jcfg, np.random.default_rng(13), s=60)
    batch["labels"][0, :7] = -1
    (jloss, jm), _ = _jax_value_and_grad(jcfg, jp, batch)
    (loss, m), _ = steps.value_and_grad(tp, tcfg, _torch_batch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), **F32)
    assert float(m["tokens"]) == float(jm["tokens"]) == 2 * 60 - 7
