"""Port parity for STAR in training (``ModelCfg.star_train``):
``lm.loss_fn`` through the STAR prefill (K2 -> SADS -> K3 and K3's
backward; ``test_torch_sufa_bwd.py`` holds K3's gradient itself).

The same numpy-seeded inputs go through the reference and the port
(weights from ``repro.models.lm.init`` through ``repro_torch.convert``):
loss at 2e-5 and every gradient leaf at 2e-5 x max(1, the leaf's largest
magnitude), fp32, against ``jax.value_and_grad(repro.models.lm.loss_fn)``
with ``star_train``, on olmo_1b's smoke config (strict, with the element
mask, the fast path through ``use_scan``, and prefix groups) and
chatglm3_6b's (GQA); olmo_1b's bf16 loss at 2e-2. Then the remat
policies bit-equal and the selection outside autograd.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import get_smoke_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.tree import sorted_items, tree_leaves  # noqa: E402
from test_torch_train import (F32, _batch, _jax_value_and_grad,  # noqa: E402
                              _torch_batch)

jax.config.update("jax_enable_x64", False)

# (arch, STARConfig changes, sequence length)
VARIANTS = {
    "olmo_1b": ("olmo_1b", {}, 64),
    "olmo_1b_elementwise": ("olmo_1b", {"elementwise": True}, 64),
    "olmo_1b_fast_scan": ("olmo_1b", {"use_scan": True, "strict": False}, 64),
    "chatglm3_6b": ("chatglm3_6b", {}, 64),
    "starcoder2_15b": ("starcoder2_15b", {}, 64),
    "star_paper": ("star_paper", {}, 256),
    "olmo_1b_prefix_groups": ("olmo_1b", {"prefix_groups": 2,
                                          "chunk_tiles": 2}, 128),
}


def _star_models(arch, star=None, dtype=jnp.float32, seed=3):
    """(jax cfg, jax params, torch cfg, torch params) with ``star_train``
    and the smoke STAR config changed by ``star``."""
    jcfg = get_smoke_config(arch)
    jcfg = dataclasses.replace(
        jcfg, dtype=dtype, star_train=True,
        star=dataclasses.replace(jcfg.star, **(star or {})))
    jp = jlm.init(jax.random.PRNGKey(seed), jcfg)
    tcfg = convert.model_cfg_from_reference(jcfg)
    tp = convert.to_torch(jax.tree.map(np.asarray, jp))
    return jcfg, jp, tcfg, tp


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_star_train_loss_and_grads_match_reference(variant):
    arch, star, s = VARIANTS[variant]
    jcfg, jp, tcfg, tp = _star_models(arch, star)
    assert tcfg.star_train and tcfg.star == convert.STARConfig(
        **dataclasses.asdict(jcfg.star))
    batch = _batch(jcfg, np.random.default_rng(21), s=s)
    (jloss, _), jgrads = _jax_value_and_grad(jcfg, jp, batch)
    (loss, _), grads = steps.value_and_grad(tp, tcfg, _torch_batch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), **F32)
    want = dict(sorted_items(jax.tree.map(np.asarray, jgrads)))
    got = dict(sorted_items(grads))
    assert set(got) == set(want)
    for path, w in want.items():
        atol = 2e-5 * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got[path].numpy(), w, rtol=2e-5,
                                   atol=atol, err_msg=str(path))


def test_star_train_bf16_loss_matches_reference():
    jcfg, jp, tcfg, tp = _star_models("olmo_1b", dtype=jnp.bfloat16)
    batch = _batch(jcfg, np.random.default_rng(22))
    (jloss, _), _ = _jax_value_and_grad(jcfg, jp, batch)
    (loss, _), grads = steps.value_and_grad(tp, tcfg, _torch_batch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-2)
    assert all(g.dtype == torch.bfloat16 for g in tree_leaves(grads))


def test_star_train_remat_policies_give_equal_grads():
    """``remat`` none, full and dots through the STAR prefill: the same
    loss and gradients, bit for bit (the selection of the recompute is
    the forward's)."""
    _, _, tcfg, tp = _star_models("olmo_1b")
    batch = _torch_batch(_batch(tcfg, np.random.default_rng(23)))
    runs = [steps.value_and_grad(tp, dataclasses.replace(tcfg, remat=r),
                                 batch) for r in ("none", "full", "dots")]
    for (loss, _), grads in runs[1:]:
        assert torch.equal(loss, runs[0][0][0])
        for a, b in zip(tree_leaves(grads), tree_leaves(runs[0][1])):
            assert torch.equal(a, b)


def test_star_selection_never_requires_grad(monkeypatch):
    """In a training step K2 reads detached q and k and the tile ids and
    validity carry no gradient, while K3 gets q, k, v that do."""
    _, _, tcfg, tp = _star_models("olmo_1b")
    seen = []
    real_k2, real_select, real_k3 = (tops.dlzs_block_scores,
                                     tops.select_tiles, tops.sufa_attention)

    def k2(q, k, **kw):
        seen.append(("k2", q.requires_grad or k.requires_grad))
        return real_k2(q, k, **kw)

    def select(raw, keep, **kw):
        idx, valid = real_select(raw, keep, **kw)
        seen.append(("select", raw.requires_grad or idx.requires_grad
                     or valid.requires_grad))
        return idx, valid

    def k3(q, k, v, idx, valid, **kw):
        seen.append(("k3", q.requires_grad and k.requires_grad
                     and v.requires_grad))
        return real_k3(q, k, v, idx, valid, **kw)
    monkeypatch.setattr(tops, "dlzs_block_scores", k2)
    monkeypatch.setattr(tops, "select_tiles", select)
    monkeypatch.setattr(tops, "sufa_attention", k3)
    batch = _torch_batch(_batch(tcfg, np.random.default_rng(24)))
    (loss, _), grads = steps.value_and_grad(tp, tcfg, batch)
    assert np.isfinite(float(loss))
    assert {name for name, _ in seen} == {"k2", "select", "k3"}
    assert all(flag == (name == "k3") for name, flag in seen)
