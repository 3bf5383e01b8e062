"""Training at head_dim 192 (Nemotron-4-340B: 96 heads of 192 over 8 KV
heads), and the memory forms that let its published width train on one
card, on the CPU against the JAX package.

* K4's and K3's plain backwards at d 192 (``kernels.ref.flash_bwd_ref``,
  ``kernels.sufa.sufa_bwd_ref`` and autograd through the differentiable
  wrappers, which take them on the CPU) against ``jax.grad`` of the
  reference's ``_dense_chunked`` and ``core.sufa.sufa_gathered``: causal
  and not, with the element mask; fp32 at 2e-5.
* A 2-layer model with Nemotron's pattern at head_dim 192 and GQA group
  12 (``test_torch_head_dims.py``'s model): ``lm.loss_fn``'s loss and
  every gradient leaf, dense and with ``star_train``, and three training
  steps with Nemotron's Adafactor and ``train_accum`` 8, against the
  reference's ``loss_fn`` and jitted train step.
* One gradient tree (``launch.steps.accumulate_grad``): each leaf's
  gradient added into the sum as the backward produces it gives the bits
  of adding each microbatch's whole tree, on OLMo-1B's and Grok-1's smoke
  configs with ``train_accum`` 4, in bf16 and fp32, and bf16 summed in
  fp32.
* Adafactor's row-block update of a factored leaf that is one [a, b]
  block above ``ROW_BLOCK_ELEMENTS`` (lowered here), a 2-D leaf and a
  stacked one, against the reference at 2e-5 (its column means are summed
  in another order: not bits).
* ``chip_smoke.py``'s phase 25 rehearsed at smoke size.

The CUDA backwards at d 192 are held against these plain versions on the
card in ``tests/test_torch_cuda.py``.
"""

import dataclasses
import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.core.sads import BlockSelection  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adafactor as jadafactor  # noqa: E402
from repro_torch import convert, kernels  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels import flash as kflash  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels import sufa as ksufa  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.optim import adafactor  # noqa: E402
from repro_torch.tree import sorted_items, tree_items, tree_map  # noqa: E402
from test_torch_sufa_bwd import (_elem_case, _jax_elem_mask,  # noqa: E402
                                 _jax_sufa_grads, _sufa_case)
from test_torch_train import (F32, _batch, _jax_value_and_grad,  # noqa: E402
                              _models, _torch_batch)

jax.config.update("jax_enable_x64", False)
jattention = importlib.import_module("repro.models.attention")
jsufa = importlib.import_module("repro.core.sufa")
ROOT = pathlib.Path(__file__).resolve().parents[1]

D = 192


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


# -- the backwards at d 192 ----------------------------------------------------

@pytest.mark.parametrize("t,s,causal", [(64, 64, True), (32, 64, False)])
def test_flash_grads_at_d192_match_reference(t, s, causal):
    """dQ, dK, dV of K4's function at d 192: ``flash_bwd_ref`` on the
    plain forward's o and lse, and autograd through the differentiable
    wrapper, against ``jax.grad`` of ``_dense_chunked`` in fp32."""
    rng = np.random.default_rng(t + s + causal)
    bh = 2
    q, k, v = _normal(rng, (bh, t, D)), _normal(rng, (bh, s, D)), \
        _normal(rng, (bh, s, D))
    do = _normal(rng, (bh, t, D))
    scale = D ** -0.5

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
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    kernels.reset_launches()
    wrapped = torch.autograd.grad(
        kflash.flash_attention(*leaves, causal=causal), leaves, tdo)
    assert not any(kernels.LAUNCHES.values())
    for got in (plain, wrapped):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, **F32)


@pytest.mark.parametrize("t,s,causal,edges", [(64, 64, True, True),
                                              (64, 64, False, True)])
def test_sufa_grads_at_d192_match_reference(t, s, causal, edges):
    """K3's plain gradient at d 192 (``sufa_bwd_ref``, and ``_Sufa`` on
    the CPU) on a selection with an invalid slot, a q-tile with none
    valid and a key tile no q-tile chose, against ``jax.grad`` of the
    reference's ``sufa_gathered``, fp32 at 2e-5."""
    block = 16
    q, k, v, idx, valid, do = _sufa_case(t, s, causal, edges, d=D)
    scale = D ** -0.5
    kw = dict(block_q=block, block_kv=block, causal=causal, scale=scale)
    o, lse = ksufa.sufa_reference(q, k, v, idx, valid, strict=True,
                                  return_lse=True, **kw)
    plain = ksufa.sufa_bwd_ref(q, k, v, idx, valid, o, lse, do, **kw)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    wrapped = torch.autograd.grad(
        ksufa.sufa_attention(*leaves, idx, valid, **kw), leaves, do)
    _, _, mask = ksufa.gather_selected(k, v, idx, valid, t=t, block_q=block,
                                       block_kv=block, causal=causal)
    want = _jax_sufa_grads(q, k, v, idx, valid, mask, do, block=block,
                           scale=scale, scan=False, strict=True)
    for got in (plain, wrapped):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, **F32)
    assert float(plain[1][0, -block:].abs().max()) == 0.0
    assert float(plain[0][1, :block].abs().max()) == 0.0


def test_sufa_elementwise_grads_at_d192_match_reference():
    """``_Sufa`` with the element mask at d 192 (its forward's keep bits
    handed to its backward), tiles 16 x 16, causal: the mask is
    ``core.star_attention``'s for the same selection and the gradient
    ``jax.grad`` of ``sufa_gathered`` under it, fp32 at 2e-5."""
    block = 16
    q, k, v, idx, valid, do = _elem_case(block, block, True, d=D)
    t = q.shape[1]
    scale = D ** -0.5
    kw = dict(block_q=block, block_kv=block, causal=True, elementwise=True,
              radius=1.0)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(
        ksufa.sufa_attention(*leaves, idx, valid, **kw), leaves, do)
    _, bits = ksufa.sufa_attention(q, k, v, idx, valid, return_keep=True,
                                   **kw)
    mask = _jax_elem_mask(q, k, idx, valid, block_q=block, block_kv=block,
                          causal=True, scale=scale, radius=1.0)
    _, _, visible = ksufa.gather_selected(k, v, idx, valid, t=t,
                                          block_q=block, block_kv=block,
                                          causal=True)
    kept = ksufa.unpack_keep_bits(bits, block).numpy()
    assert np.array_equal(mask & visible.numpy(), kept)
    assert 0 < kept.sum() < int(visible.sum())
    ids = jnp.asarray(idx.numpy().astype(np.int32))
    ok = jnp.asarray(valid.numpy())

    def one(qh, kh, vh, ih, oh, mh):
        sel = BlockSelection(ih, oh, jnp.zeros(ih.shape, jnp.float32))
        return jsufa.sufa_gathered(qh, kh, vh, sel, scale=scale,
                                   block_q=block, block_kv=block,
                                   elem_mask=mh)

    def f(qj, kj, vj):
        return jnp.sum(jax.vmap(one)(qj, kj, vj, ids, ok, jnp.asarray(mask))
                       * jnp.asarray(do.numpy()))
    want = jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)


def test_flash_bwd_split_names_are_kernels_of_the_source(monkeypatch):
    """Every name of ``chip_smoke.BWD_KERNELS`` and ``BWD_KERNELS_D192``
    (the splits phases 20a and 25a read from a profiler trace) is
    ``<name>_kernel`` of exactly one ``__global__`` of
    ``csrc/flash_bwd.cu``: the head_dim-192 key-tile pass is a kernel of
    its own, and a renamed kernel would leave a split reading 0
    launches."""
    import re
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke as cs
    cu = (ROOT / "src/repro_torch/csrc/flash_bwd.cu").read_text()
    kernels_ = set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\(",
        cu))
    assert kernels_ == {"bwd_prep_kernel", "bwd_kv_kernel",
                        "bwd_kv192_kernel"}
    for part in cs.BWD_KERNELS + cs.BWD_KERNELS_D192:
        assert [k for k in kernels_ if f"{part}_kernel" in k] \
            == [f"{part}_kernel"]


# -- a model at head_dim 192 ---------------------------------------------------

@pytest.fixture(scope="module")
def nemotron_192():
    """Nemotron's smoke config at head_dim 192 and group 12 (24 heads
    over 2 KV heads, d_model 64), fp32, in both packages; the weights
    from ``repro.models.lm.init`` through the converter."""
    jcfg = dataclasses.replace(jget_smoke("nemotron_4_340b"), n_heads=24,
                               n_kv=2, head_dim=D, dtype=jnp.float32)
    assert (jcfg.dh, jcfg.n_heads // jcfg.n_kv) == (D, 12)
    jp = jlm.init(jax.random.PRNGKey(7), jcfg)
    tp = convert.to_torch(jax.tree.map(np.asarray, jp))
    return jcfg, jp, tp


def _leaves_close(got, want, tol=2e-5):
    want = dict(sorted_items(jax.tree.map(np.asarray, want)))
    got = dict(sorted_items(got))
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(
            got[path].numpy(), w, rtol=tol,
            atol=tol * max(1.0, float(np.abs(w).max())), err_msg=str(path))


@pytest.mark.parametrize("star_train", [False, True])
def test_loss_and_grads_at_d192_match_reference(nemotron_192, star_train):
    """``lm.loss_fn`` of the 192-head model, dense (K4's plain gradient)
    and with ``star_train`` (K2 -> SADS -> K3 and K3's plain gradient):
    loss at 2e-5 and every gradient leaf at 2e-5 x max(1, the leaf's
    largest magnitude), fp32, against ``jax.value_and_grad`` of the
    reference's."""
    jcfg, jp, tp = nemotron_192
    jcfg = dataclasses.replace(jcfg, star_train=star_train)
    tcfg = convert.model_cfg_from_reference(jcfg)
    assert tcfg.star_train == star_train and tcfg.dh == D
    batch = _batch(jcfg, np.random.default_rng(31), s=64)
    (jloss, _), jgrads = _jax_value_and_grad(jcfg, jp, batch)
    (loss, _), grads = steps.value_and_grad(tp, tcfg, _torch_batch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), **F32)
    _leaves_close(grads, jgrads)


def test_adafactor_accumulated_steps_at_d192_match_reference(nemotron_192):
    """Three steps of the 192-head model with Nemotron's own training
    fields (``optimizer="adafactor", train_accum=8``, dense) from the
    same weights on the same ``SyntheticLM`` batches (8 rows of 32
    tokens) as the reference's jitted ``make_train_step``: each loss at
    2e-5, the parameters and both Adafactor factors after step 3 at 2e-5
    x max(1, |x|), the step count exact. The port sums the microbatches
    into one gradient tree (``accumulate_grad``; fp32 model, fp32 sum)."""
    jcfg, jp, tp = nemotron_192
    jcfg = dataclasses.replace(jcfg, optimizer="adafactor", train_accum=8,
                               accum_dtype=jnp.float32)
    tcfg = convert.model_cfg_from_reference(jcfg)
    assert tcfg.accum_dtype == tcfg.dtype == torch.float32
    tp = tree_map(lambda x: x.clone(), tp)
    kw = dict(lr=1e-3, warmup=2, total_steps=50)
    jstep = jax.jit(jsteps.make_train_step(jcfg, **kw))
    tstep = steps.make_train_step(tcfg, **kw)
    _, jinit, _, _ = jsteps.make_optimizer(jcfg)
    _, tinit, _ = steps.make_optimizer(tcfg)
    jopt, topt = jinit(jp), tinit(tp)
    ds = SyntheticLM(vocab=tcfg.vocab, seq=32, global_batch=8)
    for i in range(3):
        b = ds.batch(i)
        jp, jopt, jm = jstep(jp, jopt, {k: jnp.asarray(v)
                                        for k, v in b.items()})
        tp, topt, tm = tstep(tp, topt, {k: torch.from_numpy(v)
                                        for k, v in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   **F32, err_msg=f"step {i}")
    assert int(topt["step"]) == int(jopt["step"]) == 3
    _leaves_close(tp, jp)
    _leaves_close(topt["slots"], jopt["slots"])


# -- one gradient tree ---------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32",
                                   "bfloat16:float32"])
@pytest.mark.parametrize("arch", ["olmo_1b", "grok_1_314b"])
def test_one_tree_accumulation_gives_the_tree_sums_bits(monkeypatch, arch,
                                                        dtype):
    """With ``train_accum`` 4 and the sum in the parameters' dtype (every
    registered config's) or, after a colon, another, the training step's
    sum (``accumulate_grad``: each leaf's gradient added as the backward
    produces it), its losses and the step's result are the bits of the
    form that adds each microbatch's whole gradient tree
    (``a.add_(g.to(accum_dtype))``, onto zeros first)."""
    dtype, _, accum = dtype.partition(":")
    accum = accum or dtype
    _, _, tcfg, tp = _models(arch, dtype=getattr(jnp, dtype))
    dtype, accum = getattr(torch, dtype), getattr(torch, accum)
    assert tcfg.dtype == dtype
    tcfg = dataclasses.replace(tcfg, train_accum=4, accum_dtype=accum)
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(
        vocab=tcfg.vocab, seq=32, global_batch=8).batch(0).items()}

    def zeros():
        return tree_map(lambda p: torch.zeros(p.shape, dtype=accum), tp)
    tree_sum, leaf_sum = zeros(), zeros()
    for mb in steps._microbatches(batch, 4):
        (loss, metrics), g = steps.value_and_grad(tp, tcfg, mb)
        for (_, a), (_, b) in zip(tree_items(tree_sum), tree_items(g)):
            a.add_(b.to(accum))
        got_loss, got_metrics = steps.accumulate_grad(tp, tcfg, mb, leaf_sum)
        assert torch.equal(got_loss, loss)
        assert all(torch.equal(got_metrics[k], metrics[k]) for k in metrics)
    for (path, a), (_, b) in zip(tree_items(tree_sum), tree_items(leaf_sum)):
        assert torch.equal(a, b), path
    assert any(bool(a.any()) for _, a in tree_items(leaf_sum))

    def whole_tree(params, cfg, mb, acc):
        (loss, metrics), g = steps.value_and_grad(params, cfg, mb)
        for (_, a), (_, b) in zip(tree_items(acc), tree_items(g)):
            a.add_(b.to(cfg.accum_dtype))
        return loss, metrics
    runs = []
    for form in (steps.accumulate_grad, whole_tree):
        monkeypatch.setattr(steps, "accumulate_grad", form)
        p = tree_map(lambda x: x.clone(), tp)
        opt = steps.make_optimizer(tcfg)[1](p)
        p, opt, m = steps.make_train_step(tcfg, lr=1e-3, warmup=2)(
            p, opt, batch)
        runs.append((p, m))
    (p1, m1), (p2, m2) = runs
    assert torch.equal(m1["loss"], m2["loss"])
    assert torch.equal(m1["grad_norm"], m2["grad_norm"])
    for (path, a), (_, b) in zip(tree_items(p1), tree_items(p2)):
        assert torch.equal(a, b), path


# -- Adafactor in row blocks ---------------------------------------------------

@pytest.mark.parametrize("shape,threshold", [
    ((300, 160), 2000), ((1, 210, 144), 2000), ((1, 1, 130, 136), 2000),
    ((2, 2048, 4097), 1 << 22)])
def test_adafactor_row_blocks_match_reference(monkeypatch, shape,
                                              threshold):
    """A factored leaf that is one [a, b] block above the lowered
    threshold: a 2-D leaf (which the reference updates whole), stacked
    leaves of one slice (the reference updates them whole), one with a
    unit block axis, and a leaf of two slices above the reference's own
    2^24 (which it updates a slice at a time). With the row block lowered
    too, the port updates each block in row blocks (row means and column
    sums, then the update's sum of squares, then the update); three steps
    agree with the reference at 2e-5 in params and both factors."""
    rng = np.random.default_rng(sum(shape))
    p = {"w": rng.standard_normal(shape).astype(np.float32),
         "b": rng.standard_normal((7,)).astype(np.float32)}
    rows = np.linspace(0.1, 30.0, shape[-2])[:, None]
    gs = [{"w": (rng.standard_normal(shape) * rows).astype(np.float32),
           "b": rng.standard_normal((7,)).astype(np.float32)}
          for _ in range(3)]
    monkeypatch.setattr(adafactor, "SLICE_ELEMENTS", threshold)
    monkeypatch.setattr(adafactor, "ROW_BLOCK_ELEMENTS", threshold)
    calls = []
    real = adafactor._update_blocked

    def update_rows(slot, p_, *args):
        calls.append(tuple(p_.shape))
        return real(slot, p_, *args)
    monkeypatch.setattr(adafactor, "_update_blocked", update_rows)
    jcfg = jadafactor.AdafactorConfig(lr=1e-2, weight_decay=0.01)
    tcfg = adafactor.AdafactorConfig(lr=1e-2, weight_decay=0.01)
    jp = tree_map(jnp.asarray, p)
    tp = convert.to_torch(p)
    jstate, tstate = jadafactor.adafactor_init(jp, jcfg), \
        adafactor.adafactor_init(tp, tcfg)
    for g in gs:
        jp, jstate, _ = jadafactor.adafactor_update(
            jp, tree_map(jnp.asarray, g), jstate, jcfg)
        tp, tstate, _ = adafactor.adafactor_update(
            tp, convert.to_torch(g), tstate, tcfg)
    piece = shape[1:] if len(shape) > 2 else shape
    assert calls == [piece] * (3 * (shape[0] if len(shape) > 2 else 1))
    for key in ("w", "b"):
        np.testing.assert_allclose(tp[key].numpy(), np.asarray(jp[key]),
                                   **F32)
    for key in ("r", "c"):
        np.testing.assert_allclose(
            tstate["slots"]["w"][key].numpy(),
            np.asarray(jstate["slots"]["w"][key]), **F32)


# -- chip_smoke.py's phase 25, rehearsed ---------------------------------------

def test_chip_smoke_nemotron_training_phase_rehearses_on_cpu(monkeypatch,
                                                              tmp_path):
    """Phase 25 on the CPU at smoke size (the plain versions run, so every
    kernel count stays 0 and the launch checks expect 0): 25a's backward
    checks at d 192 (K4; K3 in its wgmma tiling with and without the
    element mask, the edges, a key tile every q-tile chose, tiles of 64
    and 16), 25b's layer gradient dense and with ``star_train`` (the
    kernel run is the bf16 plain run here), and 25c's training runs of
    Nemotron's smoke config at head_dim 192 and group 12 with its
    Adafactor and ``train_accum`` 8, dense and with ``star_train``: the
    loss falls by 0.1, the state's reckoning keeps one gradient tree."""
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs import get_smoke_config as tsmoke
    monkeypatch.setattr(cs, "BUILD_DIR", tmp_path)
    cfg = dataclasses.replace(tsmoke("nemotron_4_340b"), n_heads=24, n_kv=2,
                              head_dim=D, optimizer="adafactor",
                              train_accum=8)
    gen = torch.Generator().manual_seed(0)
    out = cs.check_nemotron_training(cfg, "cpu", gen, layers=1, steps=8,
                                     seq=32, batch=8, lr=1e-2,
                                     kernels_kw=dict(bh=2, t=1024))
    k = out["kernels"]
    assert k["flash_bwd"]["d"] == D and k["flash_bwd"]["two_calls_bit_equal"]
    assert k["sufa_bwd"]["form"] == "wgmma" and k["sufa_bwd"]["keep"] == 2
    assert k["sufa_bwd_elementwise"]["elementwise"]
    assert k["sufa_bwd_edges"]["unchosen_dk_dv_zero"]
    assert k["sufa_bwd_edges"]["empty_q_tile_dq_zero"]
    assert k["sufa_bwd_all_choosers"]["key_tile_0_choosers"] == 1024 // 128
    assert k["sufa_bwd_tiles64"]["form"] == "mma_sync"
    assert k["sufa_bwd_tiles16"]["block_q"] == 16
    for name in ("dense", "star"):
        layer = out["layer"][name]
        assert layer["head_dim"] == D and "x" in layer["leaves"]
        assert not any(layer["launches"].values())
        run = out[name]
        assert run["loss"][-1] < run["loss"][0] - 0.1
        assert run["train_accum"] == 8 and run["optimizer"] == "adafactor"
        assert run["state_gb"]["grads_form"] == "one leaf beside the sum"
        assert not any(run["launches"].values())
    assert out["layer"]["star"]["star_calls"] == 1
    assert out["star"]["star_train"] and not out["dense"]["star_train"]
